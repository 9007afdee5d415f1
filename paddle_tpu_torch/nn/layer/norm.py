"""Norm layers (counterpart of `paddle_tpu/nn/layer/norm.py`). SyncBatchNorm
and SpectralNorm wait for ROADMAP item 13b."""
from __future__ import annotations

import torch

from ..._core.state import torch_device
from ..._core.tensor import Tensor
from .. import functional as F
from ..initializer import Constant
from .layers import Layer


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None,
                 name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        # reference contract (functional/norm.py trainable_statistics):
        # None = batch stats in train, moving stats in eval; explicit
        # False = mini-batch statistics ALWAYS, eval included. Pass it
        # through untouched — F.batch_norm implements exactly that
        # split, and collapsing False into None silently changed eval
        # numerics for users who asked for trainable statistics.
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            shape=[num_features], attr=weight_attr,
            default_initializer=Constant(1.0)) if weight_attr is not False else None
        self.bias = self.create_parameter(
            shape=[num_features], attr=bias_attr, is_bias=True) \
            if bias_attr is not False else None
        dev = torch_device()
        self.register_buffer("_mean", Tensor(torch.zeros(
            [num_features], dtype=torch.float32, device=dev)))
        self.register_buffer("_variance", Tensor(torch.ones(
            [num_features], dtype=torch.float32, device=dev)))

    def forward(self, input):
        return F.batch_norm(input, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)


class BatchNorm(_BatchNormBase):
    """Legacy paddle.nn.BatchNorm (act arg)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None, do_model_average_for_mean_and_var=True,
                 use_global_stats=None, trainable_statistics=False):
        super().__init__(num_channels, momentum, epsilon, param_attr, bias_attr,
                         data_layout, use_global_stats)
        self._act = act

    def forward(self, input):
        out = super().forward(input)
        if self._act == "relu":
            return F.relu(out)
        if self._act:
            return getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCL", use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         "NCL" if data_format in ("NCL", "NC") else "NLC",
                         use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCDHW", use_global_stats=None,
                 name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         data_format, use_global_stats)


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._normalized_shape = [normalized_shape] if isinstance(
            normalized_shape, int) else list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            shape=self._normalized_shape, attr=weight_attr,
            default_initializer=Constant(1.0)) if weight_attr is not False else None
        self.bias = self.create_parameter(
            shape=self._normalized_shape, attr=bias_attr, is_bias=True) \
            if bias_attr is not False else None

    def forward(self, input):
        return F.layer_norm(input, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)


class RMSNorm(Layer):
    """TPU-first RMSNorm (Llama family; reference: incubate fused_rms_norm)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            shape=[hidden_size], attr=weight_attr,
            default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            shape=[num_channels], attr=weight_attr,
            default_initializer=Constant(1.0)) if weight_attr is not False else None
        self.bias = self.create_parameter(
            shape=[num_channels], attr=bias_attr, is_bias=True) \
            if bias_attr is not False else None

    def forward(self, input):
        return F.group_norm(input, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self._epsilon = epsilon
        self._data_format = data_format
        if weight_attr is not False:
            self.weight = self.create_parameter(
                shape=[num_features], attr=weight_attr,
                default_initializer=Constant(1.0))
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(shape=[num_features], attr=bias_attr,
                                              is_bias=True)
        else:
            self.bias = None

    def forward(self, input):
        return F.instance_norm(input, weight=self.weight, bias=self.bias,
                               eps=self._epsilon, data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, input):
        return F.local_response_norm(input, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)
