"""The port's observability copies held to the JAX package's on the same
inputs: the flight recorder, structured logging, trace context and the
span ring, the chrome-trace export, timelines and the anomaly sentinel,
the pulse sampler and the health counters give the reference's output
(host arithmetic exactly, with times and ids set aside). The compile and
device telemetry render the reference's metric families; the card's
peak row is picked from its device name, and a step's FLOPs are those
of its live rows, not of its padded shapes."""
import io
import json

import jax.numpy as jnp
import pytest
import torch

import paddle_tpu.observability as JO
import paddle_tpu.serving.timeline as JT
import paddle_tpu.utils.trace as JR
import paddle_tpu_torch.observability as PO
import paddle_tpu_torch.serving.timeline as PT
import paddle_tpu_torch.utils.trace as PR

STACKS = {"jax": (JO, JT, JR), "torch": (PO, PT, PR)}
VOLATILE = {"ts", "dumped_at", "pid", "seq", "t_start", "dur_s",
            "trace_id", "span_id", "parent_id"}


def _strip(x):
    """A JSON value with its times and ids taken out."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _recorder_script(O):
    rec = O.flight_recorder.FlightRecorder(capacity=4, enabled=True)
    for i in range(6):
        rec.record("engine.admit", rids=[str(i)], resumed=0,
                   free_pages=10 - i)
    rec.record("kvcache.hit", rid="7", cached_tokens=16, pages=2)
    snap = rec.snapshot(reason="test")
    snap.pop("compile")             # the telemetry rollups, tested below
    off = O.flight_recorder.FlightRecorder(capacity=4, enabled=False)
    return _strip(snap), off.record("x") is None, \
        [e["kind"] for e in rec.events(kind="kvcache.hit")]


def test_flight_recorder_matches():
    ref, got = (_recorder_script(STACKS[s][0]) for s in ("jax", "torch"))
    assert got == ref
    assert got[0]["dropped"] == 3 and len(got[0]["events"]) == 4


def test_flight_recorder_dump_and_stacks(tmp_path):
    path = PO.flight_recorder.FlightRecorder(capacity=2, enabled=True).dump(
        str(tmp_path / "ring.json"), reason="test")
    doc = json.loads(open(path).read())
    ref = json.loads(open(JO.flight_recorder.FlightRecorder(
        capacity=2, enabled=True).dump(str(tmp_path / "ref.json"))).read())
    assert sorted(doc) == sorted(ref) and doc["reason"] == "test"
    assert "--- thread" in PO.flight_recorder.thread_stacks()


def _log_script(O):
    stream = io.StringIO()
    rec = O.flight_recorder.FlightRecorder(capacity=64, enabled=True)
    log = O.logging.StructuredLogger("serving", stream=stream,
                                     rate_per_s=1e-9, burst=3, recorder=rec)
    sent = [log.event("step.slow", level="warning", step=i) for i in range(5)]
    sent.append(log.event("other", n=1))
    lines = [_strip(json.loads(x)) for x in stream.getvalue().splitlines()]
    return sent, lines, _strip(rec.events())


def test_structured_logging_matches():
    ref, got = (_log_script(STACKS[s][0]) for s in ("jax", "torch"))
    assert got == ref
    assert got[0] == [True, True, True, False, False, True]


def _trace_script(O, R):
    tc = O.trace_context
    R.clear()
    R.enable()
    try:
        with tc.bind("tr-1"):
            with tc.span("outer", args={"n": 1}) as outer:
                with tc.span("inner"):
                    pass
                tc.record_span_event("phase", 0.5, args={"k": "v"})
        evs = R.events()
    finally:
        R.disable()
        R.clear()
    ids = {e.span_id: e.name for e in evs}
    shape = [(e.name, e.trace_id, ids.get(e.parent_id), e.args)
             for e in evs]
    return shape, outer is not None


def test_trace_context_and_span_ring_match():
    ref, got = (_trace_script(STACKS[s][0], STACKS[s][2])
                for s in ("jax", "torch"))
    assert got == ref
    assert got[0][0] == ("inner", "tr-1", "outer", None)


def test_chrome_trace_matches():
    spans = [{"name": "a", "t_start": 1.0, "dur_s": 0.5, "trace_id": "t1",
              "span_id": "s1"},
             {"name": "b", "t_start": 1.2, "dur_s": 0.1, "trace_id": "t1",
              "span_id": "s2", "parent_id": "s1", "args": {"x": 1}},
             {"name": "c", "t_start": 0.5, "dur_s": 2.0}]
    assert PO.chrome_trace.chrome_trace_doc(spans, pid=3) == \
        JO.chrome_trace.chrome_trace_doc(spans, pid=3)


def _timeline_script(T, monkeypatch):
    clock = iter(float(i) * 0.25 for i in range(100))
    monkeypatch.setattr(T, "_mono", lambda: next(clock))
    tl = T.Timeline()
    for mark in ("submit", "admit", "first_token", "preempted", "resumed",
                 "spill", "restore", "end"):
        tl.mark(mark)
    tl.count("prefill")
    tl.count("decode", 3)
    back = T.Timeline.from_dict(tl.to_dict())
    verdicts = [T.judge_slo(T.resolve_slo(None, p), ttft, tpot,
                            tl.phases())
                for p, ttft, tpot in (("high", 0.5, 0.05),
                                      ("high", 2.0, 0.5),
                                      ("low", 20.0, 0.01))]
    sent = T.StepAnomalySentinel(warmup=5, floor_s=0.01)
    for i in range(40):
        sent.note(0.02 + 0.001 * (i % 3), 1, 2)
    sent.note(0.5, 0, 4)
    return (tl.to_dict(), back.to_dict(), tl.phases(), tl.ttft(),
            tl.tpot(4), verdicts, T.slo_targets("batch"), sent.scan())


def test_timeline_and_sentinel_match(monkeypatch):
    ref, got = (_timeline_script(STACKS[s][1], monkeypatch)
                for s in ("jax", "torch"))
    assert got == ref
    assert len(got[-1]) == 1 and got[-1][0]["step_s"] == 0.5


def _pulse_script(O):
    P = O.pulse
    s = P.PulseSampler(depth=4)
    buckets = {"0.01": 0, "0.1": 0, "+Inf": 0}
    for i in range(6):
        buckets = {k: v + i for k, v in buckets.items()}
        snap = {"pt_serving_queue_depth": {"type": "gauge", "value": i},
                "pt_tokens": {"type": "counter", "value": 10.0 * i},
                "pt_goodput_tokens": {"type": "counter", "value": 8.0 * i},
                "pt_serving_ttft_seconds": {"type": "histogram",
                                            "buckets": dict(buckets),
                                            "count": 3 * i, "sum": 0.1 * i}}
        s.sample(snap, t=100.0 + i)
    ring = P.PulseRing(3)
    for i in range(5):
        ring.append(float(i), i * 1.5)
    return s.series(now=106.0), s.series(window=2.5, now=106.0,
                                         signals=["pt_tokens"]), \
        ring.window(), ring.window(since=2.5), ring.last(), len(ring)


def test_pulse_sampler_matches():
    ref, got = (_pulse_script(STACKS[s][0]) for s in ("jax", "torch"))
    assert got == ref
    assert set(got[0]) >= {"goodput_ratio", "pt_tokens:rate",
                           "pt_serving_ttft_seconds:p99"}


@pytest.mark.parametrize("gauges", [False, True],
                         ids=["initial", "gauges-set"])
def test_health_counters_and_render_match(gauges):
    out = []
    for O in (JO, PO):
        h = O.health.HealthCounters()
        if gauges:
            h.nonfinite_steps, h.nonfinite_values = 2, 5
            h.last_loss, h.last_grad_norm = 2.5, 0.75
        out.append((h.snapshot(), h.render_prometheus()))
    assert out[0] == out[1]
    assert PO.health.render_prometheus() == \
        PO.health.HealthCounters().render_prometheus()


def _families(text):
    types, rows = set(), set()
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            types.add(tuple(line.split()[2:4]))
        elif line and not line.startswith("#"):
            name, _, _ = line.partition(" ")
            base, _, labels = name.partition("{")
            rows.add((base, tuple(sorted(
                p.split("=")[0] for p in labels.rstrip("}").split(",")
                if p))))
    return types, rows


def test_compile_telemetry_names_and_builds():
    ref = JO.compile_telemetry.CompileRegistry(warn_after=2,
                                               warn_hook=lambda n, s: None)

    @ref.tracked("serving.step")
    def jstep(x):
        return x
    for n in (2, 2, 3):
        jstep(jnp.zeros((n,)))
    warned = []
    reg = PO.compile_telemetry.CompileRegistry(
        warn_after=2, warn_hook=lambda n, s: warned.append(n))

    @reg.tracked("serving.step")
    def tstep(x, length):
        return x
    for n in (2, 2, 3):
        tstep(torch.zeros((n,)), n)           # a plain int: not a signature
    assert reg.note_build("paged_attention", 1.5, cache_hit=False)
    assert not reg.note_build("paged_attention", 0.01, cache_hit=True)
    assert _families(reg.render_prometheus()) == \
        _families(ref.render_prometheus())
    assert sorted(reg.snapshot()["serving.step"]) == \
        sorted(ref.snapshot()["serving.step"])
    assert sorted(reg.totals()) == sorted(ref.totals())
    st = reg.snapshot()["serving.step"]
    assert (st["calls"], st["compiles"], st["distinct_signatures"]) == \
        (3, 0, 2)
    assert warned == ["serving.step"]
    t = reg.totals()
    assert (t["compiles"], t["compile_seconds"], t["cache_hits"]) == \
        (1, 1.5, 1)


def test_device_telemetry_names_peaks_and_costs(monkeypatch):
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.models.llama_serving import unified_step
    from paddle_tpu_torch.models.llama_spmd import init_params
    dt = PO.device_telemetry
    assert dt.PEAK_SPECS["h100"] == (989e12, 3.35e12)
    reg = dt.CostRegistry(enabled=True)
    # on the CPU nothing is costed and the MFU gauges are absent
    cfg = LlamaConfig.tiny(vocab=64, hidden=32, layers=2, heads=4,
                           kv_heads=2, ffn=64)
    p = init_params(cfg, seed=0, device="cpu")
    pool = torch.zeros((2, 2, 5, 8, 8))
    T = 16
    args = (p, pool, pool, torch.zeros((2, 2), dtype=torch.int32),
            torch.zeros((T,), dtype=torch.int32),
            torch.zeros((T,), dtype=torch.int32),
            torch.zeros((T,), dtype=torch.int32), cfg, 8)
    assert reg.capture("serving.unified_step", ("s",), unified_step,
                       args) is None
    assert reg.note_step(0.01) is None
    assert "pt_mfu " not in reg.render_prometheus()
    # as on the card: the analytic count, then a hinted step
    monkeypatch.setattr(dt, "_on_card", lambda tree: True)
    entry = reg.capture("serving.unified_step", ("s",), unified_step, args)
    mat = 2 * (32 * (32 + 2 * 16) + 32 * 32 + 3 * 32 * 64)
    assert entry["flops"] == 2.0 * mat * T + 2.0 * 32 * 64 * T
    # a step that feeds 5 of the buffer's 16 rows and reads 2 logit rows
    # counts those, not the padding
    reg.hint(rows=5, head_rows=2, cols=100, kv_tokens=40)
    reg.note_executed("serving.unified_step", ("s",))
    step = reg.note_step(0.01)
    assert step["flops"] == 2.0 * mat * 5 + 2.0 * 32 * 64 * 2 + \
        4.0 * 4 * 8 * 2 * 100
    assert step["flops"] < entry["flops"]
    ref = JO.device_telemetry.CostRegistry(enabled=True)
    ref.last_mfu = 0.5
    assert _families(reg.render_prometheus())[0] == \
        _families(ref.render_prometheus())[0]
    mem = dt.MemoryAccountant().poll(force=True, record=False)
    assert sorted(mem) == sorted(JO.device_telemetry.MemoryAccountant()
                                 .poll(force=True, record=False))
    assert mem["bytes_in_use"] is None          # no card here


@pytest.mark.parametrize("name,row", [
    ("NVIDIA H100 80GB HBM3", "h100"),      # the SXM card of the row
    ("NVIDIA H100 PCIe", None),              # other peaks: no row
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_device_generation_from_the_device_name(name, row, monkeypatch):
    dt = PO.device_telemetry
    assert dt.device_generation(name) == row
    # a card with no row has no peaks and no MFU
    monkeypatch.setattr(dt, "device_generation", lambda n=None: row)
    reg = dt.CostRegistry(enabled=True)
    reg._win_flops = 1e9
    if row is None:
        assert dt.device_peaks() == (None, None)
        assert reg.note_step(0.01) is None
        assert "pt_peak_flops_per_s" not in reg.render_prometheus()
    else:
        assert dt.device_peaks() == dt.PEAK_SPECS[row]
        assert reg.note_step(0.01)["mfu"] == 1e9 / (0.01 * 989e12)


# -- fleet observability (fleet_obs) ---------------------------------------
FLEET_SECTIONS = [
    {"label": "router", "offset_s": 0.0, "spans": [
        {"name": "fleet.submit", "t_start": 100.0, "dur_s": 0.25,
         "trace_id": "tr-a", "span_id": "s1", "args": {"worker": "w0"}},
        {"name": "router.idle", "t_start": 100.5, "dur_s": 0.125}]},
    {"label": "fr0@host0", "offset_s": 0.375, "spans": [
        {"name": "wire.stream", "t_start": 100.5, "dur_s": 0.5,
         "trace_id": "tr-a", "span_id": "s2", "parent_id": "s1"},
        {"name": "wire.handoff", "t_start": 101.0, "dur_s": 0.25,
         "trace_id": "tr-b"}]},
    {"label": "fr1@host1", "offset_s": None, "spans": [
        {"name": "engine.step", "t_start": 100.25, "dur_s": 0.0625,
         "trace_id": "tr-b"}]},
]


def _flight_sections():
    return [{"label": lbl, "offset_s": off, "uncertainty_s": unc,
             "host": f"h{i}", "replica_id": f"fr{i}",
             "flight": {"pid": 10 + i, "dropped": i, "events": [
                 {"kind": "fleet.spill", "ts": 50.0 + j * 0.5 - i,
                  "owner": "fr1"} for j in range(3)]},
             "pulse": {"enabled": i == 0}, "requests": [{"rid": str(i)}]}
            for i, (lbl, off, unc) in enumerate(
                (("router", 0.0, 0.0), ("fr0@host0", 0.25, 0.125),
                 ("fr1@host1", -1.5, None)))]


@pytest.mark.parametrize("alpha", [None, 0.5])
def test_clock_skew_estimator_matches(alpha):
    samples = [("w0", 10.0, 10.75, 10.5, 0.125), ("w0", 11.0, 11.5, 11.25,
                                                   0.0),
               ("w1", 20.0, 19.0, 20.5, 0.25), ("w0", 12.0, 12.9, 12.2, 0.05)]
    out = {}
    for name, O in (("jax", JO), ("torch", PO)):
        est = O.fleet_obs.ClockSkewEstimator(alpha=alpha)
        seen = [est.sample(*s) for s in samples]
        out[name] = (est.alpha, seen, est.snapshot(), est.offset("w0"),
                     est.uncertainty("w1"), est.offset("never"),
                     est.rebase("w1", 30.0))
    assert out["torch"] == out["jax"]


def test_stitch_fleet_trace_matches():
    docs = [O.fleet_obs.stitch_fleet_trace(FLEET_SECTIONS)
            for O in (JO, PO)]
    assert docs[1] == docs[0]
    assert {e["ph"] for e in docs[1]["traceEvents"]} == {"M", "X", "s", "f"}


def test_merge_flight_sections_matches():
    docs = [O.fleet_obs.merge_flight_sections(_flight_sections())
            for O in (JO, PO)]
    for d in docs:
        assert isinstance(d.pop("merged_at"), float)
    assert docs[1] == docs[0]
    # skew-corrected: fr0's clock runs 0.25 s ahead, fr1's 1.5 s behind
    assert [e["ts_fleet"] for e in docs[1]["events"]][:3] == \
        [48.75, 49.25, 49.5]


def test_write_fleet_bundle_matches(tmp_path):
    meta = {"trigger": "slo_burst", "worker": "w0", "trace_ids": ["tr-a"]}
    trees = {}
    for name, O in (("jax", JO), ("torch", PO)):
        path = O.fleet_obs.write_fleet_bundle(str(tmp_path / name), "b0",
                                              meta, _flight_sections())
        root = tmp_path / name / "b0"
        assert path == str(root)
        trees[name] = {str(p.relative_to(root)): json.loads(p.read_text())
                       for p in sorted(root.rglob("*.json"))}
    assert trees["torch"] == trees["jax"]
    assert "fr0@host0/flight.json" in trees["torch"]
