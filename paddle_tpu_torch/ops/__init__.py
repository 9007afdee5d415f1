"""Tensor ops of the serving and training steps (counterpart of
`paddle_tpu/ops`)."""
