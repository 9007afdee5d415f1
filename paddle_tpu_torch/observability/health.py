"""Training-health monitoring (counterpart of
`paddle_tpu/observability/health.py`).

  * the step-side reductions (`nonfinite_count`, `health_stats`): a few
    fp32 / int scalars on the step's device, computed inside the
    train step (the parallel `Trainer` calls `health_stats` when given
    a monitor), so that observing them costs one batched transfer, not
    a sync per tensor. On a rank mesh the caller passes `reduce`, which
    sums per-leaf partials over the axes that split each leaf (counting
    a replicated leaf once), so the norms are the whole tensors';
  * `nonfinite_report`: per-leaf non-finite counts, one transfer;
  * `TrainingHealthMonitor`: the host half, one `observe()` a step:
    the transfer, the `pt_train_*` gauges, and on a non-finite step the
    counter, the flight recorder and the structured log (and, with
    abort=True, FloatingPointError);
  * `HEALTH`: the module-global counters and gauges that `/metrics`
    renders as `pt_train_*` / `pt_amp_found_inf_total` and `/healthz`
    returns as `pt_health`.

`traced_check` (called by `amp.debugging`) and `nan_blame` (hooks `nn`
sublayers) come with `amp/` (ROADMAP.md Queue 1 item 13b). Importing
this module needs the standard library only (torch inside the
functions).
"""
from __future__ import annotations

import math
import threading

__all__ = ["HEALTH", "HealthCounters", "TrainingHealthMonitor",
           "nonfinite_count", "health_stats", "nonfinite_report",
           "note_host_loss", "snapshot", "render_prometheus", "reset"]


def _float_leaves(tree):
    """Floating-point torch tensors of a dict / list / tuple tree,
    Tensors unwrapped, in the tree's order."""
    import torch
    out = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            t = t._value if hasattr(t, "_value") else t
            if torch.is_tensor(t) and t.is_floating_point():
                out.append(t)
    walk(tree)
    return out


def _total(parts, reduce):
    return reduce(parts) if reduce is not None else sum(parts[1:], parts[0])


def nonfinite_count(tree, reduce=None):
    """Count of non-finite elements over every floating leaf: one int
    scalar on the leaves' device. `reduce(per_leaf)` sums per-leaf
    counts over the ranks that split them (default: a plain sum)."""
    import torch
    leaves = _float_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.int32)
    parts = [(~torch.isfinite(l)).sum().float() for l in leaves]
    return _total(parts, reduce).round().to(torch.int32)


def _sumsq(leaves, reduce):
    return _total([(l.float() ** 2).sum() for l in leaves], reduce)


def health_stats(loss, grads=None, params=None, new_params=None,
                 reduce=None):
    """The per-step health vector, computed in the step:

      loss          the step loss as fp32
      nonfinite     non-finite element count over loss + grads
      grad_norm     global L2 norm of the gradients
      update_ratio  ||new_params - params|| / ||params||

    Returns a dict of 0-dim tensors on the step's device, for
    TrainingHealthMonitor.observe (one batched transfer). `reduce`
    (see `nonfinite_count`) applies to the gradient and parameter
    leaves, which must then come in the order it expects."""
    import torch
    lv = loss._value if hasattr(loss, "_value") else loss
    lv = torch.as_tensor(lv).detach().float().reshape(())
    stats = {"loss": lv, "nonfinite": (~torch.isfinite(lv)).to(torch.int32)}
    if grads is not None:
        gleaves = [g.detach() for g in _float_leaves(grads)]
        stats["nonfinite"] = stats["nonfinite"].to(lv.device) + \
            nonfinite_count(gleaves, reduce).to(lv.device)
        stats["grad_norm"] = torch.sqrt(_sumsq(gleaves, reduce))
    if params is not None and new_params is not None:
        pleaves = [p.detach() for p in _float_leaves(params)]
        nleaves = [p.detach() for p in _float_leaves(new_params)]
        diff = [n.float() - p.float() for p, n in zip(pleaves, nleaves)]
        stats["update_ratio"] = torch.sqrt(_sumsq(diff, reduce)) / \
            torch.sqrt(_sumsq(pleaves, reduce) + 1e-12)
    return stats


def nonfinite_report(tree, names=None):
    """Per-leaf non-finite counts with one batched transfer:
    [(index_or_name, count), ...] for the offending leaves only."""
    import torch
    leaves = _float_leaves(tree)
    if not leaves:
        return []
    counts = torch.stack([(~torch.isfinite(l)).sum().cpu()
                          for l in leaves]).tolist()
    return [(names[i] if names else i, int(c))
            for i, c in enumerate(counts) if int(c)]


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

    def note_nonfinite(self, count, where="train", source="monitor",
                       **fields):
        with self._lock:
            self.nonfinite_steps += 1
            self.nonfinite_values += int(count)
        from . import flight_recorder as _fr
        from .logging import get_logger
        _fr.record("health", event="nonfinite", where=where,
                   source=source, count=int(count), **fields)
        get_logger("health").event(
            "health.nonfinite", level="warning", where=where,
            source=source, count=int(count), **fields)

    def note_found_inf(self, scale):
        with self._lock:
            self.found_inf_steps += 1
            self.nonfinite_steps += 1
        from . import flight_recorder as _fr
        from .logging import get_logger
        _fr.record("health", event="amp.found_inf", scale=float(scale))
        get_logger("health").event(
            "health.amp_found_inf", level="warning", scale=float(scale))

    def note_gauges(self, loss=None, grad_norm=None, update_ratio=None):
        with self._lock:
            if loss is not None:
                self.last_loss = float(loss)
            if grad_norm is not None:
                self.last_grad_norm = float(grad_norm)
            if update_ratio is not None:
                self.last_update_ratio = float(update_ratio)

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


def note_host_loss(value, where="train"):
    """Eager-loop hook: `value` is already a host float. Counts a
    non-finite loss."""
    try:
        v = float(value)
    except (TypeError, ValueError):
        return
    HEALTH.note_gauges(loss=v)
    if not math.isfinite(v):
        HEALTH.note_nonfinite(1, where=where, source="host_loss")


class TrainingHealthMonitor:
    """Host half of the per-step health check:

        monitor = TrainingHealthMonitor()
        # in the step:        stats = health_stats(loss, grads, params,
        #                                          new_params)
        # after it (host):    monitor.observe(stats, step=i)

    `observe` moves the scalars to the host in one transfer; a
    non-finite step bumps `pt_train_nonfinite_total`, lands in the
    flight recorder and (abort=True) raises FloatingPointError."""

    def __init__(self, name="train", abort=False, counters=None):
        self.name = name
        self.abort = abort
        self.counters = counters or HEALTH
        self.last = None

    stats = staticmethod(health_stats)

    def observe(self, stats, step=None):
        import torch
        keys = list(stats)
        if keys and torch.is_tensor(stats[keys[0]]):
            dev = stats[keys[0]].device
            host = torch.stack([torch.as_tensor(stats[k]).to(
                dev, torch.float64).reshape(()) for k in keys]).cpu()
            vals = dict(zip(keys, host.tolist()))      # one transfer
        else:
            vals = {k: float(v) for k, v in stats.items()}
        loss = float(vals.get("loss", 0.0))
        nonfinite = int(vals.get("nonfinite", 0))
        rec = {"loss": loss, "nonfinite": nonfinite, "step": step}
        for k in ("grad_norm", "update_ratio"):
            if vals.get(k) is not None:
                rec[k] = float(vals[k])
        self.last = rec
        self.counters.note_gauges(loss=loss, grad_norm=rec.get("grad_norm"),
                                  update_ratio=rec.get("update_ratio"))
        if nonfinite > 0 or not math.isfinite(loss):
            self.counters.note_nonfinite(
                max(nonfinite, 1), where=self.name, source="monitor",
                step=step, loss=loss)
            if self.abort:
                raise FloatingPointError(
                    f"health[{self.name}]: step {step} produced "
                    f"{nonfinite} non-finite values (loss={loss})")
        return rec


def snapshot():
    return HEALTH.snapshot()


def render_prometheus():
    return HEALTH.render_prometheus()


def reset():
    HEALTH.reset()
