"""Training-health counters (counterpart of the host half of
`paddle_tpu/observability/health.py`): `HEALTH`, the module-global
counters and gauges that `/metrics` renders as `pt_train_*` /
`pt_amp_found_inf_total`, and `/healthz` returns as `pt_health`.

The reference feeds these counters from a training loop: its
`health_stats` and `TrainingHealthMonitor` are called by the trainer
(ROADMAP.md, Queue 1 item 12), `traced_check` by `amp.debugging` and
`nan_blame` walks `nn` sublayers (item 13). They are ported with those
callers; until then the counters keep their initial values. Importing
this module needs the standard library only.
"""
from __future__ import annotations

import math
import threading

__all__ = ["HEALTH", "HealthCounters", "snapshot", "render_prometheus",
           "reset"]


class HealthCounters:
    def __init__(self):
        self._lock = threading.Lock()
        self.nonfinite_steps = 0       # observations with any bad value
        self.nonfinite_values = 0      # total bad elements seen
        self.found_inf_steps = 0       # GradScaler skipped steps
        self.last_loss = None
        self.last_grad_norm = None
        self.last_update_ratio = None
        self.last_blame = None

    def snapshot(self):
        with self._lock:
            return {
                "nonfinite_steps": self.nonfinite_steps,
                "nonfinite_values": self.nonfinite_values,
                "found_inf_steps": self.found_inf_steps,
                "last_loss": self.last_loss,
                "last_grad_norm": self.last_grad_norm,
                "last_update_ratio": self.last_update_ratio,
                "last_blame": self.last_blame,
            }

    def render_prometheus(self):
        s = self.snapshot()
        out = [
            "# HELP pt_train_nonfinite_total Train-health observations "
            "that contained non-finite values (loss/grads/checks).",
            "# TYPE pt_train_nonfinite_total counter",
            f"pt_train_nonfinite_total {s['nonfinite_steps']}",
            "# TYPE pt_train_nonfinite_values_total counter",
            f"pt_train_nonfinite_values_total {s['nonfinite_values']}",
            "# HELP pt_amp_found_inf_total GradScaler steps skipped for "
            "inf/nan grads (dynamic loss scaling backed off).",
            "# TYPE pt_amp_found_inf_total counter",
            f"pt_amp_found_inf_total {s['found_inf_steps']}",
        ]
        for key, metric in (("last_loss", "pt_train_loss"),
                            ("last_grad_norm", "pt_train_grad_norm"),
                            ("last_update_ratio",
                             "pt_train_update_ratio")):
            v = s[key]
            if v is not None and math.isfinite(v):
                out.append(f"# TYPE {metric} gauge")
                out.append(f"{metric} {v:.6g}")
        return "\n".join(out) + "\n"

    def reset(self):
        with self._lock:
            self.nonfinite_steps = 0
            self.nonfinite_values = 0
            self.found_inf_steps = 0
            self.last_loss = None
            self.last_grad_norm = None
            self.last_update_ratio = None
            self.last_blame = None


HEALTH = HealthCounters()


def snapshot():
    return HEALTH.snapshot()


def render_prometheus():
    return HEALTH.render_prometheus()


def reset():
    HEALTH.reset()
