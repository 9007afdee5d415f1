"""Layers (counterpart of `paddle_tpu/nn/layer`)."""
