"""Runtime observability (counterpart of `paddle_tpu/observability`):

  * `compile_telemetry` — a registry the step functions and the nvcc
    builds report to: first-seen shape signatures per step function
    (`track_jit`), kernel builds with their seconds and cache hits,
    `pt_compile_*` on `/metrics`;
  * `trace_context`    — contextvar-propagated trace ids and parent /
    child spans, emitted into `utils.trace`'s ring;
  * `logging`          — structured JSON log lines with per-event rate
    limiting; every event also lands in the flight recorder;
  * `flight_recorder`  — a bounded ring of recent structured events,
    dumped on SIGTERM or at `/debug/flightrecorder`;
  * `chrome_trace`     — chrome://tracing export of the recorded spans;
  * `device_telemetry` — per-step FLOPs and bytes from an analytic count
    on each step function's shapes, MFU and roofline gauges against the
    card's peak row (`h100`), and a device-memory accountant on
    `torch.cuda.memory_stats` (`pt_mfu`, `pt_device_*`);
  * `pulse`            — ring-buffer time series of the metrics
    snapshots, `/debug/pulse`, and anomaly capture bundles;
  * `fleet_obs`        — the fleet's observability: NTP-style clock-skew
    estimation per worker, cross-host span stitching into one
    skew-corrected chrome trace, merged flight-ring dumps and fleet
    capture bundles;
  * `health`           — the training-health counters `/metrics`
    renders (`pt_train_*`), fed by the parallel Trainer's
    `health_stats` / `TrainingHealthMonitor`; `traced_check` and
    `nan_blame` come with `amp/` (ROADMAP.md Queue 1 item 13b).

Importing this package needs the standard library only (torch is
imported inside the functions that read tensors or the card).
"""
from __future__ import annotations

from . import (  # noqa: F401
    chrome_trace, compile_telemetry, device_telemetry, fleet_obs,
    flight_recorder, health, pulse, trace_context,
)
from . import logging as logging  # noqa: F401,PLC0414 — shadows stdlib by design
from .chrome_trace import chrome_trace_doc  # noqa: F401
from .compile_telemetry import (  # noqa: F401
    CompileRegistry, signature_of, track_jit, tracked,
)
from .device_telemetry import (  # noqa: F401
    ACCOUNTANT, COSTS, CostRegistry, MemoryAccountant, device_peaks,
)
from .flight_recorder import FlightRecorder, RECORDER  # noqa: F401
from .health import HEALTH, TrainingHealthMonitor, health_stats  # noqa: F401
from .logging import StructuredLogger, get_logger  # noqa: F401
from .pulse import PulsePlane, PulseRing, PulseSampler  # noqa: F401
from .trace_context import (  # noqa: F401
    Span, bind, current_trace_id, new_trace_id, span,
)

__all__ = [
    "chrome_trace", "compile_telemetry", "device_telemetry",
    "fleet_obs", "flight_recorder", "health", "pulse", "trace_context",
    "logging",
    "PulsePlane", "PulseRing", "PulseSampler",
    "CompileRegistry", "tracked", "track_jit", "signature_of",
    "CostRegistry", "COSTS", "MemoryAccountant", "ACCOUNTANT",
    "device_peaks",
    "TrainingHealthMonitor", "HEALTH", "health_stats",
    "FlightRecorder", "RECORDER",
    "StructuredLogger", "get_logger",
    "Span", "bind", "span", "new_trace_id", "current_trace_id",
    "chrome_trace_doc",
]
