"""Common layers (counterpart of `paddle_tpu/nn/layer/common.py`)."""
from __future__ import annotations

import torch

from ..._core.tensor import apply
from .. import functional as F
from ..initializer import Normal, XavierUniform
from .layers import Layer, ParamAttr


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, input):
        return input


class Linear(Layer):
    """Weight stored (in_features, out_features): y = x @ W + b."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None,
                 name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr,
            default_initializer=XavierUniform())
        self.bias = self.create_parameter(
            shape=[out_features], attr=bias_attr, is_bias=True)

    def forward(self, input):
        if self.weight.shape != [self._in_features, self._out_features]:
            return self._split_forward(input)
        return F.linear(input, self.weight, self.bias)

    def _split_forward(self, input):
        """The weight placed as a block of one dim (by a tp `dist_spec`):
        the collectives that give the whole product (a column split
        gathers the output, a row split sums it)."""
        from ...parallel import tp
        args = [input, self.weight] + ([self.bias] if self.bias is not None
                                       else [])
        g = tp.split_group(self.weight, 1, self._out_features)
        if g is not None:
            # a bias split with the columns is added before the gather,
            # a whole one after it
            split_bias = self.bias is not None and \
                self.bias.shape[0] != self._out_features

            def column(x, w, b=None):
                out = tp.column_linear(x, w, b if split_bias else None, g,
                                       True)
                return out + b if b is not None and not split_bias else out
            return apply(column, *args)
        g = tp.split_group(self.weight, 0, self._in_features)
        return apply(lambda x, w, b=None: tp.row_linear(x, w, b, g, False),
                     *args)

    def extra_repr(self):
        return f"in={self._in_features}, out={self._out_features}"


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            shape=[out_features, in1_features, in2_features], attr=weight_attr,
            default_initializer=XavierUniform())
        self.bias = self.create_parameter(shape=[1, out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, input):
        return F.dropout(input, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, input):
        return F.dropout2d(input, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, input):
        return F.dropout3d(input, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, input):
        return F.alpha_dropout(input, p=self.p, training=self.training)


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, input):
        return F.feature_alpha_dropout(input, p=self.p, training=self.training)


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False,
                 weight_attr=None, name=None, max_norm=None, norm_type=2.0,
                 scale_grad_by_freq=False):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx if padding_idx is None or padding_idx >= 0 \
            else num_embeddings + padding_idx
        self._max_norm = max_norm
        self._norm_type = norm_type
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0))
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight._value[self._padding_idx] = 0.0

    def forward(self, x):
        if self.weight.shape[0] != self._num_embeddings:
            # rows placed over a tp axis (a vocabulary-parallel dist_spec)
            from ...parallel import tp
            g = tp.split_group(self.weight, 0, self._num_embeddings)
            return apply(lambda ids, w: tp.vocab_parallel_embedding(
                ids, w, g), x, self.weight)
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           max_norm=self._max_norm, norm_type=self._norm_type)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, input):
        from ...tensor.manipulation import flatten
        return flatten(input, self.start_axis, self.stop_axis)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = shape

    def forward(self, input):
        from ...tensor.manipulation import unflatten
        return unflatten(input, self.axis, self.shape)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format=None, name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode, self.data_format)


class UpsamplingNearest2D(Layer):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, "nearest",
                             data_format=self.data_format)


class UpsamplingBilinear2D(Layer):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, "bilinear",
                             align_corners=True, data_format=self.data_format)


class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format,
                     pad_from_left_axis=False)


class Pad2D(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format,
                     pad_from_left_axis=False)


class Pad3D(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCDHW",
                 name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format,
                     pad_from_left_axis=False)


class ZeroPad2D(Layer):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__()
        self.padding = padding
        self.data_format = data_format

    def forward(self, x):
        return F.zeropad2d(x, self.padding, self.data_format)


ZeroPad1D = Pad1D
ZeroPad3D = Pad3D


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, input):
        return F.unfold(input, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, input):
        return F.fold(input, self.output_sizes, self.kernel_sizes, self.strides,
                      self.paddings, self.dilations)
