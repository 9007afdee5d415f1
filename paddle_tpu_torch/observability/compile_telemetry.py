"""Compile telemetry (counterpart of
`paddle_tpu/observability/compile_telemetry.py`).

The port runs no jit: what it compiles is its CUDA kernels, built by
nvcc at first use (`kernels/_build.py`). Each build reports here
(`note_build`) under the function name `nvcc:<source>`: a build that
ran nvcc is a compile with its wall seconds, a library loaded from the
on-disk build cache is a cache hit. `pt_compile_total`,
`pt_compile_seconds_total` and `pt_compile_cache_hits_total` therefore
count nvcc builds, under the reference's metric names and `snapshot()`
keys.

`track_jit` keeps its name: it wraps the serving step functions as the
reference wraps its jitted ones and counts each one's calls and
first-seen arg-shape signatures (`distinct_signatures`), which is what
a recompile would key on. It times no compile, because none happens,
so a step function's `compiles` stay 0. A function whose distinct
signatures reach `warn_after` warns once through the structured log and
the flight recorder (a shape that churns per call). Each call also
feeds the device telemetry's analytic FLOP / byte count for MFU
(`device_telemetry.COSTS`).
"""
from __future__ import annotations

import functools
import threading

from .._env import env_int

__all__ = ["CompileRegistry", "REGISTRY", "tracked", "track_jit",
           "signature_of", "set_context", "snapshot", "note_build",
           "render_prometheus", "reset"]

DEFAULT_WARN_AFTER = env_int("PADDLE_TPU_RETRACE_WARN")


def _flatten(x, leaves):
    """Flatten nested dicts / lists / tuples into `leaves`; returns the
    structure string (dict keys sorted, as a pytree registry does)."""
    if isinstance(x, dict):
        keys = sorted(x, key=str)
        return "{" + ",".join(f"{k}:{_flatten(x[k], leaves)}"
                              for k in keys) + "}"
    if isinstance(x, (list, tuple)):
        inner = ",".join(_flatten(v, leaves) for v in x)
        return f"[{inner}]" if isinstance(x, list) else f"({inner})"
    leaves.append(x)
    return "*"


def signature_of(args, kwargs=None):
    """Hashable arg-shape signature: tensors and arrays (anything with
    shape and dtype) become 'shape:dtype', a plain int 'int'; everything
    else contributes its repr. Nested dicts, lists and tuples are flattened, their
    structure the first element."""
    leaves = []
    tree = _flatten((args, kwargs or {}), leaves)

    def leaf_sig(x):
        shape = getattr(x, "shape", None)
        dtype = getattr(x, "dtype", None)
        if shape is not None and dtype is not None:
            return f"{tuple(shape)}:{dtype}"
        if isinstance(x, int) and not isinstance(x, bool):
            # a plain int is a value the step reads (a prompt length),
            # where the reference passes a 0-d array
            return "int"
        r = repr(x)
        return r if len(r) <= 80 else r[:77] + "..."
    return (tree,) + tuple(leaf_sig(l) for l in leaves)


class _FnStats:
    __slots__ = ("name", "calls", "compiles", "compile_seconds",
                 "signatures", "last_signature", "warned")

    def __init__(self, name):
        self.name = name
        self.calls = 0
        self.compiles = 0
        self.compile_seconds = 0.0
        self.signatures = {}       # sig -> call count
        self.last_signature = None
        self.warned = False

    def snap(self):
        return {
            "calls": self.calls,
            "compiles": self.compiles,
            "retraces": max(self.compiles - 1, 0),
            "compile_seconds": self.compile_seconds,
            "distinct_signatures": len(self.signatures),
            "last_signature": list(self.last_signature or ()),
        }


class CompileRegistry:
    def __init__(self, warn_after=DEFAULT_WARN_AFTER, warn_hook=None):
        self._lock = threading.Lock()
        self._fns = {}
        self._context = None
        self.warn_after = warn_after
        # warn_hook(name, stats_dict) — default: structured log event +
        # flight-recorder entry (set at call time so tests can swap it)
        self.warn_hook = warn_hook
        # kernel libraries loaded from the on-disk build cache
        # (`kernels/_build.py`: an unchanged source is not rebuilt)
        self.cache_hits = 0

    def set_context(self, **tags):
        """One-shot annotation consumed by the NEXT reported call: when
        that call turns out to be a compile, the tags ride its flight
        "compile" record. The bucketed serving entry points tag the
        power-of-two bucket they chose (`bucket=...`) so a retrace
        storm names the bucket that caused it."""
        with self._lock:
            self._context = tags or None

    # -- reporting -----------------------------------------------------
    def note_build(self, name, seconds, cache_hit):
        """Record one kernel build of `csrc/<name>.cu`: nvcc ran
        (`cache_hit` False; a compile of `seconds`) or its library came
        from the on-disk build cache. Returns True for a compile."""
        label = f"nvcc:{name}"
        with self._lock:
            st = self._fns.get(label)
            if st is None:
                st = self._fns[label] = _FnStats(label)
            st.calls += 1
            if cache_hit:
                self.cache_hits += 1
            else:
                st.compiles += 1
                st.compile_seconds += seconds
            retrace = st.compiles > 1
            n = st.compiles
        from . import flight_recorder as _fr
        _fr.record("compile", fn=label, retrace=retrace and not cache_hit,
                   n_compiles=n, elapsed_s=seconds, cache_hit=cache_hit,
                   signature=[])
        return not cache_hit

    def note_call(self, name, signature, elapsed_s=None):
        """Record one call of a tracked step function; returns True when
        its signature was never seen for this function (what a jit
        would recompile for; nothing compiles here)."""
        with self._lock:
            st = self._fns.get(name)
            if st is None:
                st = self._fns[name] = _FnStats(name)
            st.calls += 1
            st.last_signature = signature
            context, self._context = self._context, None
            first = signature not in st.signatures
            st.signatures[signature] = st.signatures.get(signature, 0) + 1
            if first:
                warn = (not st.warned and
                        len(st.signatures) >= self.warn_after)
                if warn:
                    st.warned = True
                snap = st.snap()
        if not first:
            return False
        from . import flight_recorder as _fr
        _fr.record("signature", fn=name,
                   n_signatures=snap["distinct_signatures"],
                   signature=list(signature)[:8], **(context or {}))
        if warn:
            self._warn(name, snap)
        return True

    def _warn(self, name, snap):
        hook = self.warn_hook
        if hook is not None:
            hook(name, snap)
            return
        from . import logging as _log
        _log.get_logger("compile").event(
            "compile.retrace_storm", level="warning", fn=name,
            compiles=snap["compiles"],
            distinct_signatures=snap["distinct_signatures"],
            compile_seconds=snap["compile_seconds"],
            hint=("the same function keeps seeing new argument shapes; "
                  "bucket the shape or hoist the static argument"))

    # -- wrapping ------------------------------------------------------
    def tracked(self, name=None):
        """Decorator: report every call of the wrapped step function to
        this registry under `name`, and its analytic cost to the device
        telemetry's MFU window."""
        def deco(fn):
            label = name or getattr(fn, "__name__", repr(fn))

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                sig = signature_of(args, kwargs)
                out = fn(*args, **kwargs)
                first = self.note_call(label, sig)
                # device cost accounting: a first-seen signature gets
                # its analytic FLOP / byte count, and every call adds
                # its known FLOPs to the MFU window
                from . import device_telemetry as _dt
                if first:
                    _dt.COSTS.capture(label, sig, fn, args, kwargs)
                _dt.COSTS.note_executed(label, sig)
                return out
            wrapper.__wrapped__ = fn
            wrapper._pt_compile_name = label
            return wrapper
        return deco

    # -- exposition ----------------------------------------------------
    def totals(self):
        with self._lock:
            return {
                "compiles": sum(s.compiles for s in self._fns.values()),
                "retraces": sum(max(s.compiles - 1, 0)
                                for s in self._fns.values()),
                "compile_seconds": sum(s.compile_seconds
                                       for s in self._fns.values()),
                "functions": len(self._fns),
                "cache_hits": self.cache_hits,
            }

    def snapshot(self):
        with self._lock:
            return {name: st.snap() for name, st in self._fns.items()}

    def render_prometheus(self):
        t = self.totals()
        out = [
            "# HELP pt_compile_total kernel builds that ran nvcc.",
            "# TYPE pt_compile_total counter",
            f"pt_compile_total {t['compiles']}",
            "# HELP pt_compile_retraces_total builds beyond each "
            "kernel source's first.",
            "# TYPE pt_compile_retraces_total counter",
            f"pt_compile_retraces_total {t['retraces']}",
            "# HELP pt_compile_seconds_total wall seconds paid in "
            "nvcc builds.",
            "# TYPE pt_compile_seconds_total counter",
            f"pt_compile_seconds_total {t['compile_seconds']:.6f}",
            "# HELP pt_compile_cache_hits_total kernel libraries "
            "loaded from the on-disk build cache.",
            "# TYPE pt_compile_cache_hits_total counter",
            f"pt_compile_cache_hits_total {t['cache_hits']}",
        ]
        with self._lock:
            stats = sorted(self._fns.values(), key=lambda s: s.name)
            rows = [(s.name, s.compiles, max(s.compiles - 1, 0),
                     s.compile_seconds) for s in stats]
        out.append("# TYPE pt_compile_fn_total counter")
        for name, compiles, retraces, secs in rows:
            out.append(f'pt_compile_fn_total{{fn="{name}"}} {compiles}')
        out.append("# TYPE pt_compile_fn_retraces_total counter")
        for name, compiles, retraces, secs in rows:
            out.append(
                f'pt_compile_fn_retraces_total{{fn="{name}"}} {retraces}')
        out.append("# TYPE pt_compile_fn_seconds_total counter")
        for name, compiles, retraces, secs in rows:
            out.append(
                f'pt_compile_fn_seconds_total{{fn="{name}"}} {secs:.6f}')
        return "\n".join(out) + "\n"

    def reset(self):
        with self._lock:
            self._fns.clear()
            self.cache_hits = 0


REGISTRY = CompileRegistry()


def tracked(name=None, registry=None):
    """Module-level decorator bound to the global registry."""
    return (registry or REGISTRY).tracked(name)


# step functions read better as: prefill = track_jit("serving.prefill")(prefill)
track_jit = tracked


def set_context(**tags):
    """Tag the global registry's next reported call (see
    CompileRegistry.set_context)."""
    REGISTRY.set_context(**tags)


def note_build(name, seconds, cache_hit):
    """Report one kernel build to the global registry (see
    CompileRegistry.note_build)."""
    return REGISTRY.note_build(name, seconds, cache_hit)


def snapshot():
    return REGISTRY.snapshot()


def render_prometheus():
    return REGISTRY.render_prometheus()


def reset():
    REGISTRY.reset()
