"""Device telemetry (counterpart of
`paddle_tpu/observability/device_telemetry.py`). Two halves:

  * **CostRegistry** — the reference reads each compiled step's FLOPs
    and bytes from XLA's cost analysis; the port has no compiler to ask,
    so each tracked step function's cost comes from an analytic count on
    its shapes (`_analysis_of`): 2 x matmul parameters x rows for the
    layers, 2 x hidden x vocab x the rows the head computes, the weights
    read once and the new K/V written. Attention is counted as the
    kernels count it (4 x query heads x head dim x key columns a layer,
    as `chip_smoke.py`'s `_bound` and `_verify_bound` do). The shapes
    are padded (a ragged buffer of 256 rows may carry 8 live tokens),
    so before each call the engine passes the work its live tokens need
    (`COSTS.hint(rows, head_rows, cols, kv_tokens)`, host values it
    already holds), and that, not the padding, is what is counted.
    Costs are counted for steps on the card only: on the CPU no step is
    captured, `note_step` measures nothing, and `pt_mfu` / `pt_mfu_peak`
    are absent (never 0). `note_step()` turns (FLOPs, step seconds) into
    an MFU gauge against the card's peak row below (`h100`: 989e12 bf16
    dense FLOP/s, 3.35e12 B/s, the data sheet), plus roofline
    arithmetic intensity. A card with no row has no MFU.

  * **MemoryAccountant** — `torch.cuda.memory_stats()` on every visible
    card (absent on the CPU): bytes in use, peak and limit, the live
    allocations, and their split by allocator pool. Exposed as
    `pt_device_*` gauges and `device.memory` flight records.

Disable the cost half with PADDLE_TPU_DEVICE_COST=0. Importing this
module needs the standard library only (torch inside functions).
"""
from __future__ import annotations

import threading
import time

from .._env import env_float, env_str

__all__ = [
    "PEAK_SPECS", "device_generation", "device_peaks",
    "CostRegistry", "COSTS", "MemoryAccountant", "ACCOUNTANT",
    "note_step", "snapshot", "render_prometheus", "reset",
]

# Per-device peak dense-bf16 FLOP/s and memory bandwidth (bytes/s): the
# roofline denominators. `h100` is the SXM card (data sheet); the cpu
# row is deliberately generous so a CPU figure stays a fraction.
PEAK_SPECS = {
    "h100": (989e12, 3.35e12),
    "cpu": (1e12, 1e11),
}

# device names (as `torch.cuda.get_device_name` gives them) of each
# card row: the PCIe and NVL H100s have other peaks and no row
_CARD_ROWS = {"NVIDIA H100 80GB HBM3": "h100"}

_COST_ENABLED = env_str("PADDLE_TPU_DEVICE_COST") != "0"


def device_generation(name=None):
    """The PEAK_SPECS row of a device name as `torch.cuda.get_device_name`
    gives it (card 0's when None): "cpu" without a CUDA device, None for
    a card that has no row."""
    if name is None:
        import torch
        if not torch.cuda.is_available():
            return "cpu"
        name = torch.cuda.get_device_name(0)
    return _CARD_ROWS.get(name)


def device_peaks():
    """(peak_flops_per_s, peak_bytes_per_s) for ONE card: MFU here is
    the single-card convention. PADDLE_TPU_PEAK_FLOPS /
    PADDLE_TPU_PEAK_BW override numerically; a card with no row and no
    override has (None, None), and no MFU."""
    flops, bw = PEAK_SPECS.get(device_generation(), (None, None))
    flops = env_float("PADDLE_TPU_PEAK_FLOPS", flops)
    bw = env_float("PADDLE_TPU_PEAK_BW", bw)
    return flops, bw


def _on_card(tree):
    """True when any tensor in the (nested) arguments lives on a CUDA
    device."""
    if isinstance(tree, dict):
        return any(_on_card(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_on_card(v) for v in tree)
    dev = getattr(tree, "device", None)
    return getattr(dev, "type", None) == "cuda"


def _analysis_of(name, fn, args, kwargs):
    """The analytic cost of one call of serving step `name` at these
    shapes: ({"flops", "bytes accessed"}, memory dict), plus the unit
    costs a `hint` multiplies (`_Units`). Raises for a function it has
    no count for."""
    import inspect

    b = inspect.signature(getattr(fn, "__wrapped__", fn)).bind(
        *args, **(kwargs or {}))
    a = b.arguments
    params, c = a["params"], a["config"]
    lw = params["layers"]
    L = int(lw["wq"].shape[0])
    H, V = (int(x) for x in params["lm_head"].shape)
    qh, kvh = c.num_attention_heads, c.num_key_value_heads
    d = c.hidden_size // qh
    mat = L * sum(int(t[0].numel()) for t in lw.values() if t.dim() == 3)
    weight_bytes = sum(int(t.numel()) * t.element_size()
                       for t in [*lw.values(), params["lm_head"],
                                 params["final_norm"]])
    kv_elem = a["k_pool"].element_size() if "k_pool" in a else \
        params["embed"].element_size()
    if "k_pool" in a and a.get("k_scale") is not None:
        kv_elem += 4 / d                 # fp32 per-token scale, per elem
    need = a.get("need_rows")
    if name == "serving.unified_step":
        rows = int(a["tokens"].shape[0])
        head = rows if need is None else int(need.shape[0])
    elif name == "serving.decode_step":
        rows = head = int(a["tokens"].shape[0])
    elif name == "serving.verify_step":
        rows = int(a["tokens"].numel())
        head = rows if need is None else int(need.shape[0])
    elif name == "serving.prefill":
        rows, head = int(a["input_ids"].numel()), 1
    elif name == "serving.prefill_varlen":
        rows = int(a["input_ids"].numel())
        head = int(a["cu_seqlens"].shape[0]) - 1
    else:
        raise KeyError(f"device_telemetry: no cost count for {name!r}")
    u = _Units(row_flops=2.0 * mat, head_flops=2.0 * H * V,
               col_flops=4.0 * qh * d * L,       # QK^T and PV, a layer
               tok_bytes=float(L * kvh * d * 2 * kv_elem),  # a token's K, V
               weight_bytes=float(weight_bytes))
    # a bucketed prefill: causal over its bucket, its own K/V read once
    cols, kv = (rows * (rows + 1) // 2, rows) if name == "serving.prefill" \
        else (0, 0)
    flops, byts = u.cost(rows, head, cols, kv)
    mem = {"argument_bytes": int(weight_bytes), "output_bytes": 0,
           "temp_bytes": 0, "generated_code_bytes": 0}
    return {"flops": flops, "bytes accessed": byts}, mem, u


class _Units:
    """What one row, one logit row, one attention key column and one
    K/V token cost in a step function: a call's FLOPs are rows x
    `row_flops` + logit rows x `head_flops` + key columns x `col_flops`;
    its bytes the weights once, plus each row's new K/V written and
    each cached token's read."""

    __slots__ = ("row_flops", "head_flops", "col_flops", "tok_bytes",
                 "weight_bytes")

    def __init__(self, row_flops, head_flops, col_flops, tok_bytes,
                 weight_bytes):
        self.row_flops = row_flops
        self.head_flops = head_flops
        self.col_flops = col_flops
        self.tok_bytes = tok_bytes
        self.weight_bytes = weight_bytes

    def cost(self, rows, head_rows, cols, kv_tokens):
        """(FLOPs, bytes) of a call with these counts."""
        return (self.row_flops * rows + self.head_flops * head_rows
                + self.col_flops * cols,
                self.weight_bytes + self.tok_bytes * (rows + kv_tokens))


class _FnCost:
    __slots__ = ("name", "flops", "bytes_accessed", "argument_bytes",
                 "output_bytes", "temp_bytes", "code_bytes",
                 "flops_issued", "bytes_issued", "calls", "captures",
                 "capture_failures")

    def __init__(self, name):
        self.name = name
        # latest-signature static analysis (what one call costs)
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.argument_bytes = 0
        self.output_bytes = 0
        self.temp_bytes = 0
        self.code_bytes = 0
        # issued counters (what all calls cost so far)
        self.flops_issued = 0.0
        self.bytes_issued = 0.0
        self.calls = 0
        self.captures = 0
        self.capture_failures = 0

    def snap(self):
        hbm = self.argument_bytes + self.output_bytes + self.temp_bytes
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "arithmetic_intensity": (self.flops / self.bytes_accessed
                                     if self.bytes_accessed else None),
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "generated_code_bytes": self.code_bytes,
            "hbm_bytes": hbm,
            "flops_issued": self.flops_issued,
            "bytes_issued": self.bytes_issued,
            "calls": self.calls,
            "captures": self.captures,
            "capture_failures": self.capture_failures,
        }


class CostRegistry:
    """Per-step-function analytic cost + issued-FLOPs window
    accounting. `capture()` is called by compile_telemetry's tracked
    wrapper on every first-seen signature, `note_executed()` on every
    call, `hint()` by the engine before a call whose attention depends
    on its positions, `note_step()` by whoever owns a step clock (the
    serving pump)."""

    def __init__(self, enabled=None):
        self._lock = threading.Lock()
        # (name, signature) -> (flops, bytes, _Units)
        self._by_sig = {}
        # (rows, head_rows, cols, kv_tokens) of the next call
        self._hint = None
        self._fns = {}             # name -> _FnCost
        self.enabled = _COST_ENABLED if enabled is None else enabled
        # step-window state (note_step deltas) + MFU gauges
        self._win_flops = 0.0
        self._win_bytes = 0.0
        self.last_mfu = 0.0
        self.peak_mfu = 0.0
        self.last_step_flops = 0.0
        self.last_step_bytes = 0.0
        self.last_intensity = 0.0
        self.steps_measured = 0

    # -- capture (first-seen signature) -------------------------------
    def capture(self, name, signature, fn, args, kwargs=None):
        """Record the analytic cost of one call of step function `name`
        at this signature's shapes. Steps on the CPU are not counted.
        Raises for a step on the card that has no count: a missing
        count is a bug, not a figure of 0."""
        if not self.enabled or not _on_card((args, kwargs)):
            return None
        key = (name, signature)
        with self._lock:
            st = self._fns.get(name)
            if st is None:
                st = self._fns[name] = _FnCost(name)
            if key in self._by_sig:
                return None        # e.g. two registries sharing a fn
        cost, mem, units = _analysis_of(name, fn, args, kwargs)
        flops = float(cost["flops"])
        byts = float(cost["bytes accessed"])
        entry = dict(mem, flops=flops, bytes_accessed=byts)
        with self._lock:
            self._by_sig[key] = (flops, byts, units)
            st.captures += 1
            st.flops = flops
            st.bytes_accessed = byts
            st.argument_bytes = entry["argument_bytes"]
            st.output_bytes = entry["output_bytes"]
            st.temp_bytes = entry["temp_bytes"]
            st.code_bytes = entry["generated_code_bytes"]
        from . import flight_recorder as _fr
        _fr.record("device.cost", fn=name, **entry)
        return entry

    # -- accounting (every call) --------------------------------------
    def hint(self, rows, head_rows, cols, kv_tokens):
        """The work of the next step call, which its padded shapes do
        not fix: the `rows` it computes for live tokens, the `head_rows`
        whose logits it reads, `cols` attention key columns summed over
        its rows (a row at position p attends p + 1) and `kv_tokens`
        cached tokens it reads. Consumed by the next `note_executed`,
        which counts these in place of the shapes' rows."""
        with self._lock:
            self._hint = (int(rows), int(head_rows), int(cols),
                          int(kv_tokens))

    def note_executed(self, name, signature):
        """Add one call's FLOPs/bytes to the issued counters: the hinted
        work where the engine gave it, else the shapes' count."""
        with self._lock:
            ent = self._by_sig.get((name, signature))
            hint, self._hint = self._hint, None
            st = self._fns.get(name)
            if st is not None:
                st.calls += 1
            if ent is None:
                return
            flops, byts, units = ent
            if hint is not None:
                flops, byts = units.cost(*hint)
            if st is not None:
                st.flops_issued += flops
                st.bytes_issued += byts
            self._win_flops += flops
            self._win_bytes += byts

    def issued_totals(self):
        """Cumulative issued FLOPs/bytes, total + per function — the
        raw counters bench/hapi compute their own windows from."""
        with self._lock:
            per_fn = {n: {"flops": s.flops_issued,
                          "bytes": s.bytes_issued}
                      for n, s in self._fns.items()}
            return {
                "flops": sum(v["flops"] for v in per_fn.values()),
                "bytes": sum(v["bytes"] for v in per_fn.values()),
                "per_fn": per_fn,
            }

    # -- MFU / roofline (per step) ------------------------------------
    def note_step(self, elapsed_s):
        """Close one step window: everything issued since the previous
        call ran in `elapsed_s` wall seconds (the caller's clock must
        bracket a synced device step — the serving pump's does). Sets
        the pt_mfu / intensity gauges; returns the step's numbers."""
        with self._lock:
            flops, byts = self._win_flops, self._win_bytes
            self._win_flops = 0.0
            self._win_bytes = 0.0
        peak_flops, _ = device_peaks()
        if elapsed_s <= 0 or flops <= 0 or peak_flops is None:
            return None
        mfu = flops / (elapsed_s * peak_flops)
        with self._lock:
            self.last_mfu = mfu
            self.peak_mfu = max(self.peak_mfu, mfu)
            self.last_step_flops = flops
            self.last_step_bytes = byts
            self.last_intensity = flops / byts if byts else 0.0
            self.steps_measured += 1
        return {"mfu": mfu, "flops": flops, "bytes": byts,
                "step_s": elapsed_s,
                "arithmetic_intensity": self.last_intensity}

    def mfu_over(self, flops, elapsed_s):
        """MFU of an arbitrary (flops, seconds) window — bench/hapi."""
        peak_flops = device_peaks()[0]
        if elapsed_s <= 0 or peak_flops is None:
            return 0.0
        return flops / (elapsed_s * peak_flops)

    # -- exposition ----------------------------------------------------
    def snapshot(self):
        peak_flops, peak_bw = device_peaks()
        with self._lock:
            fns = {n: s.snap() for n, s in self._fns.items()}
            out = {
                "device_generation": device_generation(),
                "peak_flops_per_s": peak_flops,
                "peak_hbm_bytes_per_s": peak_bw,
                "roofline_ridge_flops_per_byte":
                    peak_flops / peak_bw if peak_flops and peak_bw
                    else None,
                "mfu": self.last_mfu,
                "mfu_peak": self.peak_mfu,
                "step_flops": self.last_step_flops,
                "step_bytes": self.last_step_bytes,
                "step_arithmetic_intensity": self.last_intensity,
                "steps_measured": self.steps_measured,
                "functions": fns,
            }
        return out

    def render_prometheus(self):
        peak_flops, peak_bw = device_peaks()
        with self._lock:
            rows = sorted(self._fns.values(), key=lambda s: s.name)
            fn_rows = [(s.name, s.flops, s.bytes_accessed,
                        s.argument_bytes + s.output_bytes + s.temp_bytes,
                        s.flops_issued) for s in rows]
            mfu, mfu_peak = self.last_mfu, self.peak_mfu
            sflops, sbytes = self.last_step_flops, self.last_step_bytes
            inten = self.last_intensity
            measured = self.steps_measured
        # no measured step (the CPU, or nothing served yet): the MFU
        # gauges are absent, never 0
        out = [
            "# HELP pt_mfu Model FLOPs utilization of the last measured "
            "step (analytic FLOPs / step seconds / the card's peak).",
            "# TYPE pt_mfu gauge",
            f"pt_mfu {mfu:.6g}",
            "# TYPE pt_mfu_peak gauge",
            f"pt_mfu_peak {mfu_peak:.6g}",
        ] if measured else []
        out += [
            "# HELP pt_step_flops analytic FLOPs issued in the last "
            "measured step.",
            "# TYPE pt_step_flops gauge",
            f"pt_step_flops {sflops:.6g}",
            "# TYPE pt_step_bytes gauge",
            f"pt_step_bytes {sbytes:.6g}",
            "# HELP pt_roofline_intensity FLOPs per HBM byte of the "
            "last measured step (compare against pt_roofline_ridge).",
            "# TYPE pt_roofline_intensity gauge",
            f"pt_roofline_intensity {inten:.6g}",
        ]
        # a card with no peak row: the peak gauges are absent
        if peak_flops and peak_bw:
            out += [
                "# HELP pt_roofline_ridge Device ridge point: peak FLOPs "
                "/ peak HBM bandwidth; intensity below this is "
                "memory-bound.",
                "# TYPE pt_roofline_ridge gauge",
                f"pt_roofline_ridge {peak_flops / peak_bw:.6g}",
                "# TYPE pt_peak_flops_per_s gauge",
                f"pt_peak_flops_per_s {peak_flops:.6g}",
                "# TYPE pt_peak_hbm_bytes_per_s gauge",
                f"pt_peak_hbm_bytes_per_s {peak_bw:.6g}",
            ]
        out.append("# HELP pt_fn_flops analytic FLOPs of one call of "
                   "this step function (latest signature, hint aside).")
        out.append("# TYPE pt_fn_flops gauge")
        for name, flops, byts, hbm, issued in fn_rows:
            out.append(f'pt_fn_flops{{fn="{name}"}} {flops:.6g}')
        out.append("# TYPE pt_fn_bytes_accessed gauge")
        for name, flops, byts, hbm, issued in fn_rows:
            out.append(f'pt_fn_bytes_accessed{{fn="{name}"}} {byts:.6g}')
        out.append("# HELP pt_fn_hbm_bytes weight bytes this step "
                   "function reads.")
        out.append("# TYPE pt_fn_hbm_bytes gauge")
        for name, flops, byts, hbm, issued in fn_rows:
            out.append(f'pt_fn_hbm_bytes{{fn="{name}"}} {hbm}')
        out.append("# TYPE pt_fn_flops_issued_total counter")
        for name, flops, byts, hbm, issued in fn_rows:
            out.append(
                f'pt_fn_flops_issued_total{{fn="{name}"}} {issued:.6g}')
        return "\n".join(out) + "\n"

    def reset(self):
        with self._lock:
            self._by_sig.clear()
            self._fns.clear()
            self._hint = None
            self._win_flops = self._win_bytes = 0.0
            self.last_mfu = self.peak_mfu = 0.0
            self.last_step_flops = self.last_step_bytes = 0.0
            self.last_intensity = 0.0
            self.steps_measured = 0


class MemoryAccountant:
    """Device-memory snapshots from the CUDA caching allocator
    (`torch.cuda.memory_stats()` per visible card; absent on the CPU):
    bytes in use, peak and limit, the live allocations and their split
    by allocator pool (large / small). Polls are rate-limited
    (`min_interval_s`) unless forced — scrapes force."""

    def __init__(self, min_interval_s=1.0, top_buckets=8):
        self._lock = threading.Lock()
        self.min_interval_s = float(min_interval_s)
        self.top_buckets = int(top_buckets)
        self._last = None
        self._last_t = 0.0
        self.live_peak_bytes = 0
        self.in_use_peak_bytes = 0

    def poll(self, force=False, record=True):
        """Take (or reuse) a snapshot; returns the snapshot dict."""
        now = time.monotonic()
        with self._lock:
            if (not force and self._last is not None
                    and now - self._last_t < self.min_interval_s):
                return self._last
        snap = self._take()
        with self._lock:
            self._last = snap
            self._last_t = now
            self.live_peak_bytes = max(self.live_peak_bytes,
                                       snap["live_bytes"])
            self.in_use_peak_bytes = max(self.in_use_peak_bytes,
                                         snap.get("bytes_in_use") or 0)
            snap["live_peak_bytes"] = self.live_peak_bytes
            if snap.get("bytes_in_use") is not None:
                snap["peak_bytes_in_use"] = max(
                    snap.get("peak_bytes_in_use") or 0,
                    self.in_use_peak_bytes)
        if record:
            from . import flight_recorder as _fr
            _fr.record("device.memory",
                       live_bytes=snap["live_bytes"],
                       live_arrays=snap["live_arrays"],
                       live_peak_bytes=snap["live_peak_bytes"],
                       bytes_in_use=snap.get("bytes_in_use"),
                       bytes_limit=snap.get("bytes_limit"))
        return snap

    def _take(self):
        snap = {"ts": time.time(), "live_bytes": 0, "live_arrays": 0,
                "by_bucket": [], "devices": [], "bytes_in_use": None,
                "peak_bytes_in_use": None, "bytes_limit": None}
        import torch
        # a process that never touched the card has nothing to report
        # (and asking would create a CUDA context)
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return snap
        in_use = peak = limit = count = 0
        buckets = {}
        for i in range(torch.cuda.device_count()):
            st = torch.cuda.memory_stats(i)
            cur = int(st.get("allocated_bytes.all.current", 0))
            top = int(st.get("allocated_bytes.all.peak", 0))
            lim = int(torch.cuda.get_device_properties(i).total_memory)
            in_use += cur
            peak += top
            limit += lim
            count += int(st.get("allocation.all.current", 0))
            for pool in ("large_pool", "small_pool"):
                nb = int(st.get(f"allocated_bytes.{pool}.current", 0))
                n = int(st.get(f"allocation.{pool}.current", 0))
                b = buckets.get(pool)
                buckets[pool] = (b[0] + nb, b[1] + n) if b else (nb, n)
            snap["devices"].append(
                {"id": i, "platform": "gpu", "bytes_in_use": cur,
                 "peak_bytes_in_use": top, "bytes_limit": lim})
        snap["bytes_in_use"] = in_use
        snap["peak_bytes_in_use"] = peak
        snap["bytes_limit"] = limit
        snap["live_bytes"] = in_use
        snap["live_arrays"] = count
        snap["by_bucket"] = [
            {"bucket": k, "bytes": v[0], "count": v[1]}
            for k, v in sorted(buckets.items(),
                               key=lambda kv: -kv[1][0])[:self.top_buckets]]
        return snap

    def snapshot(self):
        """Last poll (taking one if none exists yet)."""
        with self._lock:
            last = self._last
        return last if last is not None else self.poll(force=True)

    def render_prometheus(self, force_poll=True):
        snap = self.poll(force=force_poll) if force_poll \
            else self.snapshot()
        out = [
            "# HELP pt_device_live_bytes Bytes held by live tensors on "
            "the cards (the caching allocator's allocated bytes).",
            "# TYPE pt_device_live_bytes gauge",
            f"pt_device_live_bytes {snap['live_bytes']}",
            "# TYPE pt_device_live_arrays gauge",
            f"pt_device_live_arrays {snap['live_arrays']}",
            "# HELP pt_device_live_peak_bytes High-water mark of "
            "pt_device_live_bytes across polls.",
            "# TYPE pt_device_live_peak_bytes gauge",
            f"pt_device_live_peak_bytes {snap['live_peak_bytes']}",
        ]
        if snap.get("bytes_in_use") is not None:
            out += [
                "# HELP pt_device_bytes_in_use Allocator bytes in use "
                "(sum over the cards; absent on the CPU).",
                "# TYPE pt_device_bytes_in_use gauge",
                f"pt_device_bytes_in_use {snap['bytes_in_use']}",
                "# TYPE pt_device_peak_bytes_in_use gauge",
                f"pt_device_peak_bytes_in_use {snap['peak_bytes_in_use']}",
                "# TYPE pt_device_bytes_limit gauge",
                f"pt_device_bytes_limit {snap['bytes_limit']}",
            ]
        for b in snap["by_bucket"]:
            out.append(
                f'pt_device_live_bucket_bytes{{bucket="{b["bucket"]}"}} '
                f'{b["bytes"]}')
        return "\n".join(out) + "\n"

    def reset(self):
        with self._lock:
            self._last = None
            self._last_t = 0.0
            self.live_peak_bytes = 0
            self.in_use_peak_bytes = 0


COSTS = CostRegistry()
ACCOUNTANT = MemoryAccountant()


def note_step(elapsed_s):
    """Module-level shorthand: the serving pump's per-step MFU hook."""
    return COSTS.note_step(elapsed_s)


def snapshot():
    return {"cost": COSTS.snapshot(), "memory": ACCOUNTANT.snapshot()}


def render_prometheus():
    """Everything this module knows, Prometheus text — appended to the
    serving `/metrics` next to the compile exposition."""
    return COSTS.render_prometheus() + ACCOUNTANT.render_prometheus()


def reset():
    COSTS.reset()
    ACCOUNTANT.reset()
