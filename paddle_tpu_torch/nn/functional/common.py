"""Common functionals (counterpart of `paddle_tpu/nn/functional/common.py`):
linear, dropout, pad, interpolate, embedding and the like, each a torch
function on Tensors. Dropout draws its keep mask from the ported key
stream, bit-equal to the reference's `jax.random.bernoulli`."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ... import _prng
from ..._core import dtypes as _dt
from ..._core.state import prng
from ..._core.tensor import Tensor, apply, unwrap

__all__ = [
    "linear", "bilinear", "dropout", "dropout2d", "dropout3d",
    "alpha_dropout", "feature_alpha_dropout", "pad", "zeropad2d",
    "cosine_similarity", "pairwise_distance", "interpolate", "upsample",
    "one_hot", "embedding", "label_smooth", "unfold", "fold",
    "class_center_sample",
]


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b, W stored (in, out)."""
    if bias is not None:
        return apply(lambda a, w, b: torch.matmul(a, w) + b, x, weight, bias)
    return apply(torch.matmul, x, weight)


def bilinear(x1, x2, weight, bias=None, name=None):
    def fn(a, b, w, bb=None):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        return out + bb if bb is not None else out
    if bias is not None:
        return apply(fn, x1, x2, weight, bias)
    return apply(fn, x1, x2, weight)


def _keep_mask(key, p, shape, device):
    return _prng.bernoulli(key, 1.0 - p, shape, device=device)


def _dropout_impl(x, p, training, mode, broadcast_dims=None):
    if not training or p == 0.0:
        return x.clone() if isinstance(x, Tensor) else x
    if p == 1.0:
        return apply(torch.zeros_like, x)
    key = prng.next_key()

    def fn(a):
        shape = list(a.shape)
        for d in broadcast_dims or ():
            shape[d] = 1
        keep = _keep_mask(key, p, tuple(shape), a.device)
        zero = torch.zeros((), dtype=a.dtype, device=a.device)
        if mode == "upscale_in_train":
            return torch.where(keep, a / (1.0 - p), zero)
        return torch.where(keep, a, zero)
    return apply(fn, x)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    bdims = None
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        bdims = [d for d in range(x.ndim)
                 if d not in [a % x.ndim for a in axes]]
    return _dropout_impl(x, float(p), training, mode, bdims)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    bdims = [2, 3] if data_format == "NCHW" else [1, 2]
    return _dropout_impl(x, float(p), training, "upscale_in_train", bdims)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    bdims = [2, 3, 4] if data_format == "NCDHW" else [1, 2, 3]
    return _dropout_impl(x, float(p), training, "upscale_in_train", bdims)


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x.clone()
    key = prng.next_key()

    def fn(a):
        alpha = 1.6732632423543772
        scale = 1.0507009873554805
        alpha_p = -alpha * scale
        keep = _keep_mask(key, p, tuple(a.shape), a.device)
        q = 1.0 - p
        a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
        b_coef = -a_coef * alpha_p * p
        return a_coef * torch.where(keep, a, torch.tensor(
            alpha_p, dtype=a.dtype, device=a.device)) + b_coef
    return apply(fn, x)


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    return alpha_dropout(x, p, training)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",
        pad_from_left_axis=True, name=None):
    pad_list = [int(unwrap(p)) for p in (pad.tolist() if isinstance(
        pad, Tensor) else pad)] if not isinstance(pad, int) else [int(pad)]

    def fn(a):
        nd = a.dim()
        if len(pad_list) == 2 * nd:
            if pad_from_left_axis:
                widths = [(pad_list[2 * i], pad_list[2 * i + 1])
                          for i in range(nd)]
            else:
                widths = [(pad_list[2 * (nd - 1 - i)],
                           pad_list[2 * (nd - 1 - i) + 1])
                          for i in range(nd)]
        else:
            # paddle convention: the last k spatial dims per data_format
            k = len(pad_list) // 2
            widths = [(0, 0)] * nd
            spatial = list(range(1, 1 + k)) if \
                (data_format.endswith("C") and nd >= 3) else \
                list(range(nd - k, nd))
            for j, d in enumerate(spatial):
                widths[d] = (pad_list[2 * j], pad_list[2 * j + 1])
        if mode == "constant":
            flat = [w for pair in reversed(widths) for w in pair]
            return TF.pad(a, flat, "constant", value)
        tmode = {"reflect": "reflect", "replicate": "replicate",
                 "circular": "circular"}[mode]
        # torch pads the trailing dims of a batched tensor: move the
        # padded dims last, pad, move them back
        dims = [d for d, w in enumerate(widths) if w != (0, 0)]
        rest = [d for d in range(nd) if d not in dims]
        perm = rest + dims
        moved = a.permute(perm)
        lead = moved.shape[:len(rest)]
        moved = moved.reshape((1, -1) + tuple(moved.shape[len(rest):]))
        flat = [w for d in reversed(dims) for w in widths[d]]
        out = TF.pad(moved, flat, tmode)
        out = out.reshape(tuple(lead) + tuple(out.shape[2:]))
        return out.permute(tuple(np.argsort(perm)))
    return apply(fn, x)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format, pad_from_left_axis=False)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    def fn(a, b):
        num = torch.sum(a * b, axis)
        d1 = torch.sqrt(torch.sum(a * a, axis))
        d2 = torch.sqrt(torch.sum(b * b, axis))
        return num / torch.clamp_min(d1 * d2, eps)
    return apply(fn, x1, x2)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    def fn(a, b):
        d = a - b + epsilon
        return torch.pow(torch.sum(torch.pow(torch.abs(d), p), -1,
                                   keepdim=keepdim), 1.0 / p)
    return apply(fn, x, y)


def one_hot(x, num_classes, name=None):
    return apply(lambda a: TF.one_hot(a.long(), int(num_classes)).to(
        _dt.get_default_dtype()), x)


def embedding(x, weight, padding_idx=None, max_norm=None, norm_type=2.0,
              sparse=False, scale_grad_by_freq=False, name=None):
    def fn(idx, w):
        if max_norm is not None:
            norms = torch.linalg.vector_norm(w, norm_type, -1, keepdim=True)
            w = w * torch.clamp(max_norm / (norms + 1e-7), max=1.0)
        out = w[idx.long()]
        if padding_idx is not None and padding_idx >= 0:
            mask = (idx == padding_idx)[..., None]
            out = torch.where(mask, torch.zeros((), dtype=out.dtype,
                                                device=out.device), out)
        return out
    return apply(fn, x, weight)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    def fn(lab, pd=None):
        k = lab.shape[-1]
        uni = pd if pd is not None else torch.full(
            (k,), 1.0 / k, dtype=lab.dtype, device=lab.device)
        return (1.0 - epsilon) * lab + epsilon * uni
    if prior_dist is not None:
        return apply(fn, label, prior_dist)
    return apply(fn, label)


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col, NCHW in and (N, C*kh*kw, L) out; paddings (top, left) or
    (top, left, bottom, right)."""
    k, s, d = _pair(kernel_sizes), _pair(strides), _pair(dilations)
    p = _pair(paddings)
    p = p * 2 if len(p) == 2 else p

    def fn(a):
        a_p = TF.pad(a, (p[1], p[3], p[0], p[2]))
        return TF.unfold(a_p, k, dilation=d, padding=0, stride=s)
    return apply(fn, x)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    return apply(lambda a: TF.fold(a, _pair(output_sizes), _pair(
        kernel_sizes), dilation=_pair(dilations), padding=_pair(paddings),
        stride=_pair(strides)), x)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format=None,
                name=None):
    """Resize the spatial dims as the reference's `jax.image.resize`
    does: half-pixel centres, and antialiased when a linear or cubic
    resize shrinks a dim."""
    if data_format is None:
        data_format = {3: "NCW", 4: "NCHW", 5: "NCDHW"}[x.ndim]
    channel_last = data_format[-1] == "C"
    nsp = x.ndim - 2
    if size is not None:
        if isinstance(size, Tensor):
            size = size.tolist()
        out_sp = [int(unwrap(s)) for s in (size if isinstance(
            size, (list, tuple)) else [size])]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else \
            [scale_factor] * nsp
        in_sp = x.shape[1:-1] if channel_last else x.shape[2:]
        out_sp = [int(s * float(unwrap(f))) for s, f in zip(in_sp, sf)]
    tmode = {"nearest": "nearest-exact", "bilinear": "bilinear",
             "linear": "linear", "trilinear": "trilinear",
             "bicubic": "bicubic", "area": "bilinear"}[mode]

    def fn(a):
        if channel_last:
            a = a.movedim(-1, 1)
        in_sp_ = a.shape[2:]
        if tmode == "nearest-exact":
            out = TF.interpolate(a, size=out_sp, mode=tmode)
        elif align_corners:
            out = TF.interpolate(a, size=out_sp, mode=tmode,
                                 align_corners=True)
        else:
            shrink = any(o < i for o, i in zip(out_sp, in_sp_))
            out = TF.interpolate(a, size=out_sp, mode=tmode,
                                 align_corners=False,
                                 antialias=shrink and nsp == 2)
        return out.movedim(1, -1) if channel_last else out
    return apply(fn, x)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format=None, name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def class_center_sample(label, num_classes, num_samples, group=None):
    lab = unwrap(label).cpu().numpy()
    pos = np.unique(lab)
    if len(pos) >= num_samples:
        sampled = pos[:num_samples]
    else:
        rest = np.setdiff1d(np.arange(num_classes), pos)
        sampled = np.concatenate([pos, rest[: num_samples - len(pos)]])
    remap = -np.ones(num_classes, dtype=np.int64)
    remap[sampled] = np.arange(len(sampled))
    dev = unwrap(label).device
    return (Tensor(torch.from_numpy(remap[lab]).to(dev)),
            Tensor(torch.from_numpy(sampled.astype(np.int64)).to(dev)))
