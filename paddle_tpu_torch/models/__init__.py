"""Llama configuration, stacked parameters, the serving step and
engine, and the pretrain step (counterpart of `paddle_tpu/models`)."""
