"""Linear algebra ops (counterpart of `paddle_tpu/tensor/linalg.py`).

Ported: the products (matmul, mm, bmm, dot, vecdot, mv, inner products
of `multi_dot`), transposes, `norm`, `dist`, `cdist`, `cross` and the
decompositions and solves that torch.linalg computes directly. The rest
of the reference's list (`lstsq`, `lu`, `lu_unpack`,
`householder_product`, `ormqr`, `histogram*`, `bincount`, `cov`,
`corrcoef`, `matrix_exp`, `cholesky_solve`, `triangular_solve`, the
low-rank SVDs) waits for ROADMAP item 13b."""
from __future__ import annotations

import math

import torch

from .._core.tensor import apply

__all__ = [
    "matmul", "mm", "bmm", "dot", "t", "transpose", "norm", "dist", "cross",
    "cholesky", "inv", "qr", "svd", "eigh", "eigvals", "eigvalsh", "solve",
    "matrix_power", "matrix_rank", "pinv", "slogdet", "det", "mv",
    "multi_dot", "vecdot", "svdvals", "cdist", "matrix_transpose",
]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def fn(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return apply(fn, x, y)


def mm(input, mat2, name=None):
    return apply(torch.matmul, input, mat2)


def bmm(x, y, name=None):
    return apply(torch.matmul, x, y)


def dot(x, y, name=None):
    return apply(lambda a, b: torch.sum(a * b, -1), x, y)


def vecdot(x, y, axis=-1, name=None):
    return apply(lambda a, b: torch.sum(a * b, axis), x, y)


def mv(x, vec, name=None):
    return apply(torch.matmul, x, vec)


def t(input, name=None):
    return apply(lambda a: a if a.dim() < 2 else a.transpose(0, 1), input)


def transpose(x, perm, name=None):
    return apply(lambda a: a.permute(tuple(int(p) for p in perm)), x)


def matrix_transpose(x, name=None):
    return apply(lambda a: a.transpose(-1, -2), x)


def _pnorm(a, pp, dims, keepdim):
    if pp in (math.inf, float("inf")):
        return torch.amax(a.abs(), dims, keepdim)
    if pp in (-math.inf, float("-inf")):
        return torch.amin(a.abs(), dims, keepdim)
    if pp == 0:
        return torch.sum((a != 0).to(a.dtype), dims, keepdim)
    if pp == 1:
        return torch.sum(a.abs(), dims, keepdim)
    if pp in (2, "fro"):
        return torch.sqrt(torch.sum(torch.square(a.abs()), dims, keepdim))
    return torch.pow(torch.sum(torch.pow(a.abs(), pp), dims, keepdim),
                     1.0 / pp)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    def fn(a):
        ax = axis
        if isinstance(ax, (list, tuple)):
            ax = tuple(int(v) for v in ax)
        pp = p
        if pp is None:
            pp = "fro" if (ax is None or isinstance(ax, tuple)) and \
                a.dim() >= 2 else 2
        if ax is None:
            r = _pnorm(a.reshape(-1), pp, (0,), False)
            return r.reshape((1,) * a.dim()) if keepdim else r
        dims = ax if isinstance(ax, tuple) else (ax,)
        if pp == "nuc":
            return torch.linalg.matrix_norm(a, "nuc", dims, keepdim)
        return _pnorm(a, pp, dims, keepdim)
    return apply(fn, x)


def dist(x, y, p=2, name=None):
    return apply(lambda a, b: _pnorm((a - b).reshape(-1), p, (0,), False),
                 x, y)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    def fn(a, b):
        diff = (a[..., :, None, :] - b[..., None, :, :]).abs()
        return _pnorm(diff, p, (-1,), False)
    return apply(fn, x, y)


def cross(x, y, axis=9, name=None):
    def fn(a, b):
        ax = axis
        if ax == 9:  # paddle default: the first axis of size 3
            ax = next(i for i, s in enumerate(a.shape) if s == 3)
        return torch.linalg.cross(a, b, dim=ax)
    return apply(fn, x, y)


def cholesky(x, upper=False, name=None):
    return apply(lambda a: torch.linalg.cholesky(a, upper=upper), x)


def inv(x, name=None):
    return apply(torch.linalg.inv, x)


def qr(x, mode="reduced", name=None):
    return apply(lambda a: tuple(torch.linalg.qr(a, mode)), x, multi=True)


def svd(x, full_matrices=False, name=None):
    return apply(lambda a: tuple(torch.linalg.svd(a, full_matrices)), x,
                 multi=True)


def svdvals(x, name=None):
    return apply(torch.linalg.svdvals, x)


def eigvals(x, name=None):
    return apply(torch.linalg.eigvals, x)


def eigh(x, UPLO="L", name=None):
    return apply(lambda a: tuple(torch.linalg.eigh(a, UPLO)), x, multi=True)


def eigvalsh(x, UPLO="L", name=None):
    return apply(lambda a: torch.linalg.eigvalsh(a, UPLO), x)


def solve(x, y, name=None):
    return apply(torch.linalg.solve, x, y)


def matrix_power(x, n, name=None):
    return apply(lambda a: torch.linalg.matrix_power(a, int(n)), x)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return apply(lambda a: torch.linalg.matrix_rank(
        a, rtol=tol, hermitian=hermitian), x)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply(lambda a: torch.linalg.pinv(a, rtol=rcond,
                                             hermitian=hermitian), x)


def det(x, name=None):
    return apply(torch.linalg.det, x)


def slogdet(x, name=None):
    return apply(lambda a: torch.stack(tuple(torch.linalg.slogdet(a))), x)


def multi_dot(x, name=None):
    return apply(lambda *xs: torch.linalg.multi_dot(xs), *x)
