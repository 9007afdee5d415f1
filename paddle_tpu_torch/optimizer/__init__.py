"""paddle_tpu_torch.optimizer (counterpart of `paddle_tpu/optimizer`)."""
from .optimizer import Optimizer  # noqa: F401
from .rules import (  # noqa: F401
    SGD, Momentum, Adam, AdamW, Adamax, Adagrad, Adadelta, RMSProp, Lamb,
    NAdam, RAdam, ASGD, Rprop, Lion, LBFGS, LarsMomentum,
)
from . import lr  # noqa: F401
