"""Tensor-parallel layers (counterpart of `paddle_tpu/parallel/tp.py`;
Paddle's fleet/layers/mpu/mp_layers.py).

The JAX package's layers only annotate their weights and let GSPMD
insert the collectives. Here a layer computes with the block of its
weight this rank holds (the Trainer, or any placement, cuts each
parameter by its `dist_spec`) and places Megatron's collectives by
hand, on the group of the axis its spec names
(`distributed/collective.py`):

  * `ColumnParallelLinear`: the input enters through `copy_to_group`
    (its gradient summed over the axis); with `gather_output` the
    output's last dim is all-gathered (`gather_from_group`).
  * `RowParallelLinear`: the input is split first unless
    `input_is_parallel`; the output goes through `reduce_from_group`
    and the replicated bias is added once, after the sum.
  * `VocabParallelEmbedding`: the rank's rows of the vocabulary looked
    up, the others masked, summed over the axis
    (`vocab_parallel_embedding`, shared with `models/llama_spmd.py`).
  * `ParallelCrossEntropy`: the vocabulary-parallel log-sum-exp over
    the rank's columns of the logits (`vocab_parallel_nll`, shared with
    the functional Llama's head).

A layer whose weight is whole (no mesh, or an axis of one rank) is its
plain counterpart. `mark_sequence_parallel` is a sharding constraint in
the JAX package, which changes no value: here it returns its input.
"""
from __future__ import annotations

import torch

from .._core.tensor import apply
from ..distributed import collective as C
from ..nn import functional as F
from ..nn.initializer import Normal, XavierUniform
from ..nn.layer.layers import Layer
from .mesh import P, get_mesh, spec_axes

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "mark_sequence_parallel", "annotate_module_tp", "split_group",
           "vocab_parallel_embedding", "vocab_parallel_nll"]


def split_group(param, dim, full):
    """The group of the mesh axis along which `param` (a Parameter or
    tensor with a `dist_spec`) holds only its block of dim `dim`, whose
    whole size is `full`; None when the rank holds the whole dim."""
    shape = param.shape
    local = shape[dim]
    if local == full:
        return None
    spec = getattr(param, "dist_spec", None)
    axes = spec_axes(tuple(spec)[dim]) if spec is not None and \
        dim < len(spec) else ()
    mesh = get_mesh()
    if len(axes) != 1 or mesh is None or axes[0] not in mesh.shape:
        raise ValueError(
            f"a weight holds {local} of the {full} entries of dim {dim} "
            f"but its dist_spec {spec!r} names no axis of the mesh {mesh}")
    g = mesh.group(axes[0])
    if local * g.nranks != full:
        raise ValueError(f"dim {dim} ({full}) does not divide over "
                         f"{axes[0]}={g.nranks}")
    return g


def vocab_parallel_embedding(ids, weight, group):
    """The lookup of `ids` (whole-vocabulary ids) in this rank's block of
    rows `weight`: rows it does not own give zeros, and the sum over the
    group gives every rank the whole lookup."""
    lo = group.rank * weight.shape[0]
    local = ids.long() - lo
    own = (local >= 0) & (local < weight.shape[0])
    h = torch.nn.functional.embedding(torch.where(own, local, 0), weight)
    return C.reduce_from_group(torch.where(own[..., None], h, 0), group)


def vocab_parallel_nll(logits, labels, group):
    """Per-token -log softmax(logits)[label] where `logits` holds this
    rank's block of vocabulary columns (fp32) and `labels` whole-
    vocabulary ids: the row max and the sum of exponentials reduced over
    the group, the target logit taken from the rank that owns it. The
    logits are never gathered; the result is the same on every rank."""
    lo = group.rank * logits.shape[-1]
    m = C.all_reduce(logits.detach().amax(-1), C.ReduceOp.MAX, group)
    sumexp = C.reduce_from_group(torch.exp(logits - m[..., None]).sum(-1),
                                 group)
    lse = torch.log(sumexp) + m
    local = labels.long() - lo
    own = (local >= 0) & (local < logits.shape[-1])
    picked = torch.gather(logits, -1,
                          torch.where(own, local, 0)[..., None])[..., 0]
    picked = C.reduce_from_group(torch.where(own, picked, 0.0), group)
    return lse - picked


def column_linear(x, weight, bias, group, gather_output):
    """x @ weight + bias with `weight` (and `bias`) this rank's block of
    output columns (raw tensors)."""
    x = C.copy_to_group(x, group)
    out = x @ weight
    if bias is not None:
        out = out + bias
    return C.gather_from_group(out, group, -1) if gather_output else out


def row_linear(x, weight, bias, group, input_is_parallel):
    """x @ weight + bias with `weight` this rank's block of input rows;
    the bias (replicated) added once, after the sum."""
    if not input_is_parallel:
        x = C.scatter_to_group(x, group, -1)
    out = C.reduce_from_group(x @ weight, group)
    return out if bias is None else out + bias


class ColumnParallelLinear(Layer):
    """Weight (in, out) split over tp on the out axis."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, tp_axis="tp"):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        self.tp_axis = tp_axis
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierUniform())
        self.weight.dist_spec = P(None, tp_axis)
        self.weight.is_distributed = True
        if has_bias:
            self.bias = self.create_parameter([out_features], is_bias=True)
            self.bias.dist_spec = P(tp_axis)
            self.bias.is_distributed = True
        else:
            self.bias = None

    def forward(self, x):
        g = split_group(self.weight, 1, self.out_features)
        if g is None:
            return F.linear(x, self.weight, self.bias)
        args = [x, self.weight] + ([self.bias] if self.bias is not None
                                   else [])
        return apply(lambda xr, w, b=None: column_linear(
            xr, w, b, g, self.gather_output), *args)


class RowParallelLinear(Layer):
    """Weight (in, out) split over tp on the in axis; the partial
    products summed over the axis (Megatron's all-reduce)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 tp_axis="tp"):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.tp_axis = tp_axis
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierUniform())
        self.weight.dist_spec = P(tp_axis, None)
        self.weight.is_distributed = True
        if has_bias:
            self.bias = self.create_parameter([out_features], is_bias=True)
            self.bias.dist_spec = P()
        else:
            self.bias = None

    def forward(self, x):
        g = split_group(self.weight, 0, self.in_features)
        if g is None:
            return F.linear(x, self.weight, self.bias)
        args = [x, self.weight] + ([self.bias] if self.bias is not None
                                   else [])
        return apply(lambda xr, w, b=None: row_linear(
            xr, w, b, g, self.input_is_parallel), *args)


class VocabParallelEmbedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, tp_axis="tp"):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 0.02))
        self.weight.dist_spec = P(tp_axis, None)
        self.weight.is_distributed = True

    def forward(self, x):
        g = split_group(self.weight, 0, self.num_embeddings)
        if g is None:
            return F.embedding(x, self.weight)
        return apply(lambda ids, w: vocab_parallel_embedding(ids, w, g), x,
                     self.weight)


class ParallelCrossEntropy(Layer):
    """Per-token softmax cross-entropy (reduction "none", fp32) of
    vocabulary-parallel logits: under a tp axis of more than one rank
    `input` is this rank's block of vocabulary columns (as a
    `ColumnParallelLinear(gather_output=False)` head gives it) and the
    reductions run over the axis; labels equal to `ignore_index` give
    0."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100,
                 tp_axis="tp"):
        super().__init__()
        self.ignore_index = ignore_index
        self.tp_axis = tp_axis

    def forward(self, input, label):
        mesh = get_mesh()
        if mesh is None or mesh.shape.get(self.tp_axis, 1) == 1:
            return F.cross_entropy(input, label, reduction="none",
                                   ignore_index=self.ignore_index)
        g = mesh.group(self.tp_axis)

        def fn(logits, lab):
            lab = lab.long()
            if lab.dim() == logits.dim():
                lab = lab.squeeze(-1)
            valid = lab != self.ignore_index
            nll = vocab_parallel_nll(logits.float(),
                                     torch.where(valid, lab, 0), g)
            return torch.where(valid, nll, 0.0)
        return apply(fn, input, label)


def mark_sequence_parallel(x, sp_axis="tp", seq_dim=1):
    """Megatron-SP's marking of the activations' sequence dim. The JAX
    package constrains the sharding (the values stay whole); the port's
    layers run sequence-replicated, so the values pass through as they
    are."""
    return x


def annotate_module_tp(model, rules, tp_axis="tp"):
    """Apply {param-name-glob: PartitionSpec} rules to a Layer tree
    (auto-TP; reference: fleet.meta_parallel tensor_parallel mappings).
    A placed `nn.Linear` or `nn.Embedding` so annotated runs the
    collectives its split needs (`nn.layer.common`)."""
    import fnmatch
    for name, p in model.named_parameters():
        for pattern, spec in rules.items():
            if fnmatch.fnmatch(name, pattern):
                p.dist_spec = spec if isinstance(spec, P) else P(*spec)
                p.is_distributed = True
                break
    return model
