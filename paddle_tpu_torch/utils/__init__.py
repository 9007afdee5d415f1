"""Host-side utilities (counterpart of `paddle_tpu/utils`): the span
ring that `observability.trace_context` emits into."""
from . import trace  # noqa: F401
