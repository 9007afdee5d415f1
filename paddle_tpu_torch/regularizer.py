"""Weight-decay regularizers (counterpart of `paddle_tpu/regularizer.py`)."""
from __future__ import annotations

import torch


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff


class L2Decay(WeightDecayRegularizer):
    """grad += coeff * param (applied in the optimizer's update)."""

    def __call__(self, param_raw, grad_raw):
        return grad_raw + self._coeff * param_raw


class L1Decay(WeightDecayRegularizer):
    def __call__(self, param_raw, grad_raw):
        return grad_raw + self._coeff * torch.sign(param_raw)
