"""The environment knobs the serving runtime and observability read
(counterpart of `paddle_tpu/_env.py`, carried over for the names the
port reads: the same names, defaults and accessor semantics).

  * `env_str`    missing -> default, else the raw string.
  * `env_int` / `env_float`
                 missing OR empty/whitespace -> default.
  * `env_bool`   missing -> default; set -> False iff the stripped
                 value is "" or "0", True otherwise.

Every accessor takes `env=` (any mapping) so tests can inject an
environment without touching `os.environ`. A name must be declared
below; a family (a name with ``*``, e.g. ``PT_SLO_*_TTFT_S``) resolves
its members with the default the call site supplies.
"""
from __future__ import annotations

import fnmatch
import os
import tempfile

__all__ = ["env_str", "env_int", "env_float", "env_bool"]

_UNSET = object()
_REGISTRY = {}      # name -> default


def declare(name, default):
    """Register one knob (a PT_* or PADDLE_TPU_* name)."""
    if not (name.startswith("PT_") or name.startswith("PADDLE_TPU_")):
        raise ValueError(
            f"env knob {name!r}: must start with PT_ or PADDLE_TPU_")
    if name in _REGISTRY:
        raise ValueError(f"env knob {name!r} declared twice")
    _REGISTRY[name] = default


def _resolve(name, default):
    if name in _REGISTRY:
        return _REGISTRY[name] if default is _UNSET else default
    if not any("*" in pat and fnmatch.fnmatchcase(name, pat)
               for pat in _REGISTRY):
        raise KeyError(
            f"env knob {name!r} is not declared in paddle_tpu_torch/_env.py")
    if default is _UNSET:
        raise KeyError(
            f"env knob {name!r} belongs to a family: the call site must "
            "supply the per-member default")
    return default


def env_str(name, default=_UNSET, env=None):
    default = _resolve(name, default)
    src = os.environ if env is None else env
    v = src.get(name)
    return default if v is None else v


def env_int(name, default=_UNSET, env=None):
    default = _resolve(name, default)
    src = os.environ if env is None else env
    v = src.get(name)
    if v is None or not str(v).strip():
        return default
    return int(str(v).strip())


def env_float(name, default=_UNSET, env=None):
    default = _resolve(name, default)
    src = os.environ if env is None else env
    v = src.get(name)
    if v is None or not str(v).strip():
        return default
    return float(str(v).strip())


def env_bool(name, default=_UNSET, env=None):
    default = _resolve(name, default)
    src = os.environ if env is None else env
    v = src.get(name)
    if v is None:
        return bool(default)
    return str(v).strip() not in ("", "0")


# -- serving -----------------------------------------------------------
declare("PT_SERVE_PIPELINE", False)     # scheduler pump one step deep
declare("PT_SERVE_TIMELINE", True)      # per-request timeline + SLOs
declare("PT_SERVE_PULSE", True)         # pulse plane, /debug/pulse
declare("PT_SERVE_TIMING", False)       # timing block in responses
declare("PT_FAULTS", "")                # FaultPlan spec
declare("PT_ANOMALY_FLOOR_S", 0.05)     # slow-step threshold floor
# -- SLO targets (per class; defaults INTERACTIVE 1.0 / 0.1, BATCH 10 / 1)
declare("PT_SLO_*_TTFT_S", None)
declare("PT_SLO_*_TPOT_S", None)
# -- pulse plane -----------------------------------------------------------
declare("PT_PULSE_DEPTH", 240)          # ring samples per signal
declare("PT_PULSE_INTERVAL_S", 1.0)     # sampler tick
declare("PT_PULSE_SLO_BURST", 3)        # violations a tick to capture
declare("PT_CAPTURE_DIR", "")           # capture bundles (empty: off)
declare("PT_CAPTURE_MAX", 8)
declare("PT_CAPTURE_MIN_S", 30.0)
# -- fleet plane -----------------------------------------------------------
declare("PT_FLEET_HB_S", 0.5)           # worker heartbeat interval
declare("PT_FLEET_HB_MISS_S", 3.0)      # stall that declares a worker dead
declare("PT_FLEET_CALL_TIMEOUT_S", 30.0)  # control-plane call timeout
declare("PT_FLEET_RETRIES", 2)          # idempotent-call retries
declare("PT_FLEET_FETCH_TIMEOUT_S", 1.0)  # per-page fetch-on-miss budget
declare("PT_FLEET_FETCH_MAX", 8)        # pages fetched per tier match
declare("PT_FLEET_SPILL_QUEUE", 128)    # spill queue bound (full: drop)
declare("PT_FLEET_CLOCK_ALPHA", 0.2)    # clock-offset EWMA factor
declare("PT_FLEET_OBS_POLL_S", 1.0)     # router-side obs poll interval
declare("PT_FLEET_CAPTURE_DIR", "")     # fleet capture bundles (empty: off)
declare("PT_FLEET_CAPTURE_MAX", 8)
declare("PT_FLEET_CAPTURE_MIN_S", 30.0)
# -- distributed -----------------------------------------------------------
declare("PT_RPC_BIND", "127.0.0.1")     # interface the rpc/bulk servers bind
declare("PT_RPC_TIMEOUT_S", None)       # default rpc_sync timeout (unset: wait)
declare("PT_RPC_THREADS", 8)            # threads per rpc agent pool
# -- observability ---------------------------------------------------------
declare("PADDLE_TPU_FLIGHT", True)
declare("PADDLE_TPU_FLIGHT_EVENTS", 4096)
# the reference writes dumps to /tmp; the port to the temp directory
# (TMPDIR where set)
declare("PADDLE_TPU_FLIGHT_DIR", tempfile.gettempdir())
declare("PADDLE_TPU_LOG", False)
declare("PADDLE_TPU_LOG_FILE", "")
declare("PADDLE_TPU_TRACE", False)
declare("PADDLE_TPU_DEVICE_COST", "1")
declare("PADDLE_TPU_PEAK_FLOPS", None)
declare("PADDLE_TPU_PEAK_BW", None)
declare("PADDLE_TPU_RETRACE_WARN", 8)
