"""What the spawned ranks of the parallel tests run (imported by the
ranks, so it imports neither jax nor paddle_tpu).

Every function here is `fn(rank, world, data)` for
`paddle_tpu_torch.distributed.launch.spawn`: `data` holds numpy inputs
made by the test, the result numpy arrays the test holds to the JAX
package."""
import numpy as np
import torch

from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.models import llama_spmd as T
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.parallel import pp as PP
from paddle_tpu_torch.parallel.mesh import P, create_mesh
from paddle_tpu_torch.parallel.ring import ring_attention
from paddle_tpu_torch.parallel.ulysses import ulysses_attention


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


# ------------------------------------------------------------ launching
def boom(rank, world):
    if rank == 1:
        raise ValueError("rank one says no")
    return rank


def sleeper(rank, world):
    import time
    time.sleep(60)


# ------------------------------------------------------------ collectives
def collectives(rank, world, data):
    """Each collective on this rank's block of data["x"] (dim 0 split
    over the ranks), forward and, for the differentiable ones, the
    gradient of sum(out * w), on data["device"] (default the CPU)."""
    mesh = create_mesh({"i": world})
    return _np(_collectives_on(rank, world, data, mesh.group("i"),
                               data.get("device", "cpu")))


def _collectives_on(rank, world, data, g, dev):
    t = lambda a, grad=False: _t(a).to(dev).requires_grad_(grad)  # noqa: E731
    x = t(data["x"]).chunk(world)[rank].contiguous()
    w = t(data["w"]).chunk(world)[rank].contiguous()
    out = {"backend": C.get_backend(g)}
    out["all_reduce_sum"] = C.all_reduce(x.clone(), group=g)
    out["all_reduce_max"] = C.all_reduce(x.clone(), C.ReduceOp.MAX, g)
    out["all_reduce_avg"] = C.all_reduce(x.clone(), C.ReduceOp.AVG, g)
    out["all_gather"] = C.all_gather(None, x, group=g)
    out["all_gather_list"] = torch.stack(C.all_gather([], x, group=g))
    out["all_gather_cat"] = C.all_gather_cat(x, g, dim=1)
    out["reduce_scatter"] = C.reduce_scatter(x.clone(), group=g)
    rs = torch.empty_like(x.chunk(world)[0])
    out["reduce_scatter_list"] = C.reduce_scatter(
        rs, list(x.chunk(world)), group=g)
    out["broadcast"] = C.broadcast(x.clone(), src=world - 1, group=g)
    out["alltoall_single"] = C.alltoall_single(x, group=g)
    out["alltoall_list"] = torch.stack(C.alltoall(list(x.chunk(world)),
                                                  group=g))
    ring = [(i, (i + 1) % world) for i in range(world)]
    out["ppermute_ring"] = C.p2p_ppermute(x, ring, g)
    out["ppermute_one"] = C.p2p_ppermute(x, [(0, world - 1)], g)
    buf = torch.zeros_like(x)
    if rank == 0:
        C.send(x, dst=1, group=g)
    elif rank == 1:
        C.recv(buf, src=0, group=g)
    out["recv"] = buf
    C.barrier(g)
    # the differentiable ones: gradients of sum(out * w)
    x0 = t(data["x0"], grad=True)            # replicated input
    (out["copy_to_group_grad"],) = torch.autograd.grad(
        (C.copy_to_group(x0, g) * w).sum(), x0)
    xs = x.clone().requires_grad_()
    y = C.reduce_from_group(xs, g)
    out["reduce_from_group"] = y
    (out["reduce_from_group_grad"],) = torch.autograd.grad(
        (y * t(data["w0"])).sum(), xs)
    x3 = t(data["x3"]).chunk(world)[rank].contiguous().requires_grad_()
    w3 = t(data["w3"]).chunk(world)[rank]
    y = C.all_to_all(x3, g, 1, 0)
    out["all_to_all"] = y
    (out["all_to_all_grad"],) = torch.autograd.grad((y * w3).sum(), x3)
    xs = x.clone().requires_grad_()
    y = C.ppermute(xs, ring, g)
    out["ppermute"] = y
    (out["ppermute_grad"],) = torch.autograd.grad((y * w).sum(), xs)
    out["devices"] = sorted({str(v.device) for v in out.values()
                             if torch.is_tensor(v)})
    C.reset_counters()
    C.all_reduce(torch.ones(1000, device=dev), group=g)
    out["counters"] = C.counters()
    return out


def card_collectives(rank, world, data):
    """The collectives on CUDA tensors (staged through the host over
    gloo) and on CPU tensors, from one rank a process on one card."""
    from paddle_tpu_torch.distributed.launch import rank_device
    dev = torch.device(rank_device("cuda"))
    torch.cuda.set_device(dev)
    g = create_mesh({"i": world}).group("i")
    return {str(where): _np(_collectives_on(rank, world, data, g, where))
            for where in ("cpu", dev)}


def card_train(rank, world, data):
    """Two steps of make_train_step on the card per layout of data
    ["layouts"] (full trees gathered), and the single-rank card step
    from the same weights; the flash kernels' launches of each."""
    import paddle_tpu_torch.ops.flash_attention as fa
    from paddle_tpu_torch.distributed.launch import rank_device
    dev = torch.device(rank_device("cuda"))
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _config(data["dims"])
    batch = tuple(torch.from_numpy(a).to(dev) for a in data["batch"])

    def run(mesh, kw):
        full = T.init_params(cfg, seed=0, device=dev)
        vpp = _placed_vpp(kw)
        params = full if mesh is None else T.place_params(full, cfg, mesh,
                                                          vpp=vpp)
        opt = T.init_opt_state(params)
        mkw = dict(kw, mesh=mesh) if mesh is not None else {}
        _, grads = T.loss_and_grads(params, batch, cfg, remat=True, **mkw)
        step = T.make_train_step(cfg, lr=data["lr"], device=dev, **mkw)
        fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
        losses = [float(step(params, opt, i, batch)[2]) for i in range(2)]
        launches = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
        if mesh is not None:
            grads = T.gather_params(grads, cfg, mesh, vpp=vpp)
            params = T.gather_params(params, cfg, mesh, vpp=vpp)
        return {"losses": losses, "grads": _np(_cpu(grads)),
                "params": _np(_cpu(params)), "launches": launches,
                "device": str(T._leaves(params)[0].device)}

    out = {"single": run(None, {})}
    for name, (axes, kw) in data["layouts"].items():
        kw = dict(kw)
        if "batch_spec" in kw:
            kw["batch_spec"] = P(*kw["batch_spec"])
        out[name] = run(create_mesh(axes), kw)
    return out


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


# ------------------------------------------------------------ attention
def sequence_parallel(rank, world, data):
    """Ring and Ulysses attention on this rank's block of the sequence:
    outputs and the gradients of sum(out * w) for q, k and v."""
    out = {}
    mesh = create_mesh({"sp": world})
    cases = (("ring", ring_attention, "kv"), ("ulysses", ulysses_attention, "kv"),
             ("ulysses_gqa", ulysses_attention, "kv_gqa"))
    for impl, fn, kv in cases:
        for causal in (True, False):
            qkv = [_t(a).chunk(world, 2)[rank].contiguous().requires_grad_()
                   for a in (data["q"], *data[kv])]
            w = _t(data["w"]).chunk(world, 2)[rank]
            kw = {"q_chunk": data["q_chunk"]} if impl == "ring" else {}
            o = fn(*qkv, mesh, "sp", causal=causal, **kw)
            grads = torch.autograd.grad((o * w).sum(), qkv)
            out[(impl, causal)] = _np([o] + list(grads))
    return out


# ------------------------------------------------------------ pipelines
def toy_layer(lp, h, extra):
    """The pipelines' test layer: h <- tanh(h @ w + b) * extra."""
    return torch.tanh(h @ lp["w"] + lp["b"]) * extra


def toy_head(hp, h, tgt):
    """(loss_sum, weight): the squared error of h @ hp["w"] against the
    targets, summed over rows whose target is not -1 (a weight a row)."""
    keep = (tgt[..., 0] >= 0).float()
    err = ((h @ hp["w"] - tgt) ** 2).sum(-1)
    return (err * keep).sum(), keep.sum()


def pipelines(rank, world, data):
    """pipeline_apply (forward and the gradients of sum(out * w)),
    pipeline_train_1f1b and pipeline_train_interleaved over a pp axis of
    all the ranks, on the toy layer and head."""
    mesh = create_mesh({"pp": world})
    S, L = world, data["w"].shape[0]
    stacked = {"w": _t(data["w"]), "b": _t(data["b"])}
    extra = _t(data["extra"])
    x, tgt = _t(data["x"]), _t(data["tgt"])
    head = {"w": _t(data["head_w"])}
    out = {}
    local = {k: v.chunk(S)[rank].clone().requires_grad_()
             for k, v in stacked.items()}
    xg = x.clone().requires_grad_()
    y = PP.pipeline_apply(local, xg, toy_layer, mesh, "pp",
                          data["n_micro"], extra)
    gs = torch.autograd.grad((y * _t(data["wy"])).sum(),
                             [xg, local["b"], local["w"]])
    out["apply"] = _np([y] + list(gs))
    local = {k: v.chunk(S)[rank] for k, v in stacked.items()}
    out["1f1b"] = _np(PP.pipeline_train_1f1b(
        local, x, tgt, toy_layer, toy_head, head, mesh, "pp",
        data["n_micro"], extra))
    v = data["vpp"]
    chunks = {k: a[rank] for k, a in
              PP.group_virtual_stages(stacked, S, v).items()}
    out["interleave"] = _np(PP.pipeline_train_interleaved(
        chunks, x, tgt, toy_layer, toy_head, head, mesh, "pp",
        data["n_micro"], v, extra))
    out["L"] = L
    return out


# ------------------------------------------------------------ train step
def _config(dims):
    return LlamaConfig.tiny(**dims)


def _placed_vpp(kw):
    """place_params' vpp for a layout's step options: the step's chunks
    under the interleaved schedule."""
    return kw.get("vpp", 2) if kw.get("schedule") == "interleave" else None


def _run_layout(case, params_np, opt_np, batch, steps, lr):
    """`steps` steps of make_train_step on one layout, from the JAX
    package's weights: (losses, step-1 grads, params, opt state), full
    trees gathered from every rank's shard."""
    cfg = _config(case["dims"])
    mesh = create_mesh(case["axes"])
    kw = dict(case["kw"])
    if "batch_spec" in kw:
        kw["batch_spec"] = P(*kw["batch_spec"])
    vpp = _placed_vpp(kw)
    params = T.place_params(T.params_from_jax(params_np, "cpu"), cfg, mesh,
                            vpp=vpp)
    opt = T.place_params(T.params_from_jax(opt_np, "cpu"), cfg, mesh,
                         vpp=vpp)
    bt = tuple(torch.from_numpy(a) for a in batch)
    _, grads = T.loss_and_grads(params, bt, cfg, remat=True, mesh=mesh,
                                **kw)
    step = T.make_train_step(cfg, mesh, lr=lr, device="cpu", **kw)
    losses = [float(step(params, opt, i, batch)[2]) for i in range(steps)]
    return {"losses": losses,
            "grads": _np(T.gather_params(grads, cfg, mesh, vpp=vpp)),
            "params": _np(T.gather_params(params, cfg, mesh, vpp=vpp)),
            "opt": _np(T.gather_params(opt, cfg, mesh, vpp=vpp))}


def _refusal(case, params_np, batch):
    """The exception a layout raises on its first step: (class, text)."""
    cfg = _config(case["dims"])
    mesh = create_mesh(case["axes"])
    kw = dict(case["kw"])
    if "batch_spec" in kw:
        kw["batch_spec"] = P(*kw["batch_spec"])
    try:
        step = T.make_train_step(cfg, mesh, device="cpu", **kw)
        params = T.place_params(T.params_from_jax(params_np, "cpu"), cfg,
                                mesh, vpp=_placed_vpp(kw))
        step(params, T.init_opt_state(params), 0, batch)
    except Exception as e:        # the test holds the class and the words
        return type(e).__name__, str(e)
    return None


def train_layouts(rank, world, data):
    """Every case of data["cases"] for this world: layouts run `steps`
    steps, refusals report their exception. Rank 0's results count (the
    trees are gathered on every rank)."""
    out = {}
    for name, case in data["cases"].items():
        params, opt = data["params"][case["params"]], data["opt"][
            case["params"]]
        batch = data["batches"][case["batch"]]
        if case.get("refusal"):
            out[name] = _refusal(case, params, batch)
        else:
            out[name] = _run_layout(case, params, opt, batch, data["steps"],
                                    data["lr"])
    return out if rank == 0 else None


# ------------------------------------------------------------ tp serving
def _tp_requests(specs):
    from paddle_tpu_torch.models.llama_serving import Request
    return [Request(**s) for s in specs]


def _tp_engine(data, mesh, kw):
    from paddle_tpu_torch.models.llama_serving import ServingEngine
    params = T.params_from_jax(data["params"], "cpu")
    return ServingEngine(params, _config(data["dims"]), mesh=mesh,
                         device="cpu", **kw)


def _tp_case(data, mesh, case):
    """One engine of a tp serving case: its request batches, each
    submitted and run to the end in turn; what the test holds."""
    eng = _tp_engine(data, mesh, case["engine"])
    C.reset_counters()
    for batch in case["batches"]:
        for r in _tp_requests(batch):
            eng.submit(r)
        eng.run(max_steps=500)
    pc = eng.prefix_cache
    return {"out": {r.rid: list(r.output) for r in eng.finished},
            "lp": {r.rid: list(r.logprobs) for r in eng.finished},
            "order": [r.rid for r in eng.finished],
            "conserved": eng.pool.conserved(drained=True),
            "pool_shape": tuple(eng.k_pool.shape),
            "preemptions": eng.preemptions,
            "spec_accepted": eng.spec_accepted,
            "prefix_hits": None if pc is None else pc.hits,
            "cached": {r.rid: r.cached_tokens for r in eng.finished},
            "calls": C.calls}


def _tp_refusal(data, mesh, flag):
    """The exception a tp engine raises at submit for a handoff."""
    from paddle_tpu_torch.models.llama_serving import Request
    eng = _tp_engine(data, mesh, {})
    req = Request("h", [1, 2, 3], max_new_tokens=2)
    if flag == "export":
        req._handoff_export = True
    else:
        req._kv_import = object()
    try:
        eng.submit(req)
    except Exception as e:        # the test holds the class and the words
        return type(e).__name__, str(e)
    return None


def _tp_steps(data, mesh):
    """One decode_step and one verify_step (sampling on) of the full
    model (tp 1) and of this rank's shard (tp 2), from the same pools:
    logits, records and the pools' updated K/V, this rank's heads."""
    from paddle_tpu_torch.models import llama_serving as S
    cfg = _config(data["dims"])
    full = T.params_from_jax(data["params"], "cpu")
    shard = T.place_params(full, cfg, mesh, pp=False)
    par = S._TPPlan(mesh, cfg)
    u = {k: _t(v) for k, v in data["steps"].items()}
    tp, me = mesh.shape["tp"], mesh.coord("tp")

    def pools(quant):
        k, v = u["k_pool"].clone(), u["v_pool"].clone()
        ks = vs = None
        if quant:
            (k, ks), (v, vs) = S.quantize_kv(k), S.quantize_kv(v)
        return [k, v, ks, vs]

    def mine(t):
        return None if t is None else t.chunk(tp, 1)[me]

    sample = {"temp": u["temp"], "top_k": u["top_k"], "top_p": u["top_p"],
              "key": u["key"], "eos": u["eos"], "remaining": u["remaining"]}
    out = {}
    for quant in (False, True):
        got = {}
        for name, params, p, kw in (
                ("tp1", full, pools(quant), {}),
                ("tp2", shard, [mine(t) for t in pools(quant)],
                 {"par": par})):
            dec = S.decode_step(params, p[0], p[1], u["page_table"],
                                u["lengths"], u["tokens"], u["active"], cfg,
                                data["page_size"], k_scale=p[2],
                                v_scale=p[3], sample=sample, **kw)
            ver = S.verify_step(params, p[0], p[1], u["page_table"],
                                u["lengths"], u["chunk"], u["n_tok"],
                                u["active"], cfg, data["page_size"],
                                k_scale=p[2], v_scale=p[3],
                                sample={k: sample[k] for k in
                                        ("temp", "top_k", "top_p", "key")},
                                **kw)
            if name == "tp1":
                p = [mine(t) for t in p]
            got[name] = _np({"decode": [dec[0], *dec[1]],
                             "verify": [ver[0], *ver[1]],
                             "pools": [t for t in p if t is not None]})
        out["int8" if quant else "float"] = got
    return out


def serve_tp_cases(rank, world, data):
    """The tp serving tests' port side on one rank of a tp mesh of every
    rank: each case of data["cases"] on its engine, the handoff
    refusals and the step functions at tp 2 against tp 1."""
    mesh = create_mesh({"tp": world})
    out = {name: _tp_case(data, mesh, case)
           for name, case in data["cases"].items()}
    out["refusals"] = {f: _tp_refusal(data, mesh, f)
                       for f in ("export", "import")}
    out["steps"] = _tp_steps(data, mesh)
    cfg = _config(data["dims"])
    drawn = T.init_params(cfg, seed=3, device="cpu", mesh=mesh)
    placed = T.place_params(T.init_params(cfg, seed=3, device="cpu"), cfg,
                            mesh)
    out["init_shards"] = [bool(torch.equal(a, b)) and a.shape == b.shape
                          for a, b in zip(T._leaves(drawn),
                                          T._leaves(placed))]
    return out


def tp_engine(rank, world, data):
    """`launch.serve`'s build: a tp engine over every rank, or with
    data["unsharded"], each rank's own engine from weights drawn with
    its rank as the seed (whose tokens differ)."""
    mesh = create_mesh({"tp": world})
    if not data.get("unsharded"):
        return _tp_engine(data, mesh, data["engine"])
    from paddle_tpu_torch.models.llama_serving import ServingEngine
    cfg = _config(data["dims"])
    return ServingEngine(T.init_params(cfg, seed=rank, device="cpu"), cfg,
                         device="cpu", **data["engine"])


def card_tp_serve(rank, world, data):
    """The card's tp serving test on one rank: per pool, the single-rank
    engine (the weights on the card) and a tp engine over every rank
    (the same bf16 weights given on the CPU: each rank copies its shard
    to the card), greedy, synchronous; then the tp engine again,
    teacher-forced along the single-rank streams (`StepLogits`), so that
    each of its rows is drawn from the context the single-rank row was,
    every rank alike. Returns each free run's tokens, the tp run's
    launches, whether the forced run emitted the single-rank streams,
    and each forced row where the tp engine's own pick is not the
    single-rank token: (request, token index, the tp pick's lead over
    the single-rank token in the tp logits, the single-rank token's
    lead in its own logits, the top logit)."""
    import paddle_tpu_torch.ops.paged_attention as pa
    from paddle_tpu_torch.distributed.launch import rank_device
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    from paddle_tpu_torch.models.serving_capture import StepLogits
    dev = torch.device(rank_device("cuda"))
    torch.cuda.set_device(dev)
    cfg = _config(data["dims"])
    full = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    on_card = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                   if isinstance(v, dict) else v.to(dev))
               for k, v in full.items()}
    mesh = create_mesh({"tp": world})
    prompts = {int(k): v for k, v in data["prompts"].items()}
    out = {}
    for cache in (None, "int8"):
        def run(m, force=None, launches=None):
            eng = ServingEngine(full if m is not None else on_card, cfg,
                                mesh=m, cache_dtype=cache, device=dev,
                                **data["engine"])
            for rid, p in prompts.items():
                eng.submit(Request(rid, p, max_new_tokens=data["new_tokens"]))
            pa.launches_decode = pa.launches_decode_int8 = 0
            drawn = StepLogits(eng, force=force)
            try:
                done = eng.run()
            finally:
                drawn.close()
            if launches is not None:
                launches.update(
                    decode=pa.launches_decode, int8=pa.launches_decode_int8,
                    steps=eng.device_steps, heads=int(eng.k_pool.shape[1]),
                    conserved=eng.pool.conserved(drained=True))
            return {r.rid: list(r.output) for r in done}, drawn
        single, one = run(None)
        launches = {}
        tp, _ = run(mesh, launches=launches)
        forced, two = run(mesh, force=single)
        parts = []
        for rid, want in single.items():
            for j, b in enumerate(want):
                lt, ls = two.row(rid, j), one.row(rid, j)
                a = int(torch.argmax(lt))
                if a != b:
                    parts.append((rid, j, float(lt[a] - lt[b]),
                                  float(ls[b] - ls[a]), float(ls.max())))
        out["int8" if cache else "bf16"] = {
            "single": single, "tp": tp, "forced_ok": forced == single,
            "parts": parts, "launches": launches}
    return out


# ------------------------------------------------ the Paddle layer surface
def _paddle_cpu():
    import paddle_tpu_torch as paddle
    paddle.set_device("cpu")
    return paddle


def _wrap(a, grad=False):
    """A Tensor of `a` on the surface's device."""
    from paddle_tpu_torch._core.state import torch_device
    from paddle_tpu_torch._core.tensor import Tensor
    return Tensor(torch.from_numpy(np.array(a)).to(torch_device()),
                  stop_gradient=not grad)


def _gathered(layer, mesh):
    """{name: the whole gradient} of every parameter of a placed layer
    (each rank's block gathered by its dist_spec)."""
    from paddle_tpu_torch.parallel.mesh import gather
    out = {}
    for n, p in layer.named_parameters():
        spec = p.dist_spec if p.dist_spec is not None else P()
        g = p.grad._value if p.grad is not None else torch.zeros_like(
            p._value)
        out[n] = gather(g.contiguous(), spec, mesh).cpu().numpy()
    return out


def _tp_layer(case):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.parallel import tp as TPL
    kind, kw = case["kind"], dict(case["kw"])
    if kind == "annotated":
        model = nn.Sequential(nn.Linear(*kw["dims"][:2]),
                              nn.Linear(*kw["dims"][1:]))
        return TPL.annotate_module_tp(model, {k: P(*v) for k, v in
                                              case["rules"].items()})
    return getattr(TPL, kind)(*case["args"], **kw)


def _tp_layer_case(case, mesh):
    """Forward and the gradients of sum(out * w) of one tp layer placed
    on `mesh` (its whole output gathered)."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.parallel import place_layer
    layer = _tp_layer(case)
    layer.set_state_dict(case["sd"])
    place_layer(layer, mesh)
    g = mesh.group("tp")
    x = case["x"]
    if case["kind"] == "ParallelCrossEntropy":
        xt = _wrap(np.array_split(x, g.nranks, -1)[g.rank], grad=True)
        out = layer(xt, _wrap(case["label"]))
    else:
        if case["kw"].get("input_is_parallel"):
            x = np.array_split(x, g.nranks, -1)[g.rank]
        xt = _wrap(x, grad=x.dtype.kind == "f")
        out = layer(xt)
    local = out._value
    whole = local if not case.get("split_out") else C.all_gather_cat(
        local.detach().contiguous(), g, local.dim() - 1)
    w = torch.from_numpy(case["w"]).to(local.device)
    if case.get("split_out"):
        w = w.chunk(g.nranks, -1)[g.rank]
    (local * w).sum().backward()
    res = {"out": whole.detach().cpu().numpy(),
           "grads": _gathered(layer, mesh)}
    if xt.grad is not None:
        gx = xt.grad._value
        if case["kind"] == "ParallelCrossEntropy" or case["kw"].get(
                "input_is_parallel"):
            gx = C.all_gather_cat(gx.contiguous(), g, gx.dim() - 1)
        res["x_grad"] = gx.cpu().numpy()
    return res


def _moe_case(case, mesh):
    from paddle_tpu_torch.parallel import MoELayer, place_layer
    layer = MoELayer(*case["args"], **case["kw"])
    layer.set_state_dict(case["sd"])
    place_layer(layer, mesh)
    xt = _wrap(case["x"], grad=True)
    out = layer(xt)
    loss = (out._value * torch.from_numpy(case["w"])).sum() + \
        layer.aux_loss._value * case["aux_weight"]
    loss.backward()
    return {"out": out._value.detach().numpy(),
            "aux": float(layer.aux_loss._value),
            "dropped": int(layer.dropped._value),
            "grads": _gathered(layer, mesh), "x_grad": xt.grad.numpy()}


def _pp_case(case, mesh):
    """PipelineLayer staged over the mesh's pp axis and sequential (no
    mesh), from the same weights: outputs, the input's gradient and each
    rank's own staged layers' gradients."""
    import warnings
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.parallel import LayerDesc, PipelineLayer
    descs = [LayerDesc(getattr(nn, cls), *args) for cls, args in
             case["descs"]]
    res = {}
    for label, m in (("staged", mesh), ("sequential", None)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pl = PipelineLayer(descs, num_stages=case["stages"], mesh=m,
                               n_micro=case.get("n_micro"),
                               recompute_interval=case.get("recompute", 0))
        for layer, sd in zip(pl.built, case["sds"]):
            layer.set_state_dict(sd)
        xt = _wrap(case["x"], grad=True)
        out = pl(xt)
        (out._value * torch.from_numpy(case["w"])).sum().backward()
        grads = [{n: (p.grad._value.clone() if p.grad is not None
                      else torch.zeros_like(p._value))
                  for n, p in layer.named_parameters()} for layer in pl.built]
        # a staged layer's gradient lives on the rank that ran it
        staged = {i for a, b in (pl._segments if m is not None else ())
                  for i in range(a, b)}
        for i, grad in enumerate(grads):
            for t in grad.values():
                if i in staged:
                    C.all_reduce(t, group=mesh.group("pp"))
        res[label] = {"out": out._value.detach().numpy(),
                      "x_grad": xt.grad.numpy(),
                      "grads": [{n: t.numpy() for n, t in gr.items()}
                                for gr in grads],
                      "segments": pl._segments, "staged": pl._will_stage(),
                      "warnings": [str(w.message) for w in caught]}
    return res


def layer_cases(rank, world, data):
    """The tp layers (mesh {"tp": world}), MoELayer ({"ep": world}) and
    PipelineLayer ({"pp": world}) cases of `data`; rank 0's results."""
    _paddle_cpu()
    out = {}
    for name, case in data.get("tp", {}).items():
        out[name] = _tp_layer_case(case, create_mesh({"tp": world}))
    for name, case in data.get("moe", {}).items():
        out[name] = _moe_case(case, create_mesh({"ep": world}))
    for name, case in data.get("pp", {}).items():
        out[name] = _pp_case(case, create_mesh({"pp": world}))
    return out if rank == 0 else None


# ----------------------------------------------------------- the Trainer
def _tiny_llama(dims, sd):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    model = LlamaForCausalLM(LlamaConfig.tiny(**dims))
    model.set_state_dict(sd)
    return model


def _mlp(dims, sd):
    from paddle_tpu_torch import nn
    model = nn.Sequential(nn.Linear(dims[0], dims[1]), nn.Tanh(),
                          nn.Linear(dims[1], dims[2]))
    model.set_state_dict(sd)
    return model


def llama_loss(model, batch):
    return model(batch[0], labels=batch[1])[0]


def mlp_loss(model, batch):
    import paddle_tpu_torch as paddle
    return paddle.nn.functional.cross_entropy(model(batch[0]), batch[1])


def _optimizer(paddle, spec, params):
    kind, kw = spec
    lr = kw.pop("lr")
    if isinstance(lr, dict):
        lr = paddle.optimizer.lr.StepDecay(**lr)
    return getattr(paddle.optimizer, kind)(lr, parameters=params, **kw)


def trainer_case(case, mesh):
    """`steps` Trainer steps of one case from the JAX package's weights:
    losses, the lrs, the parameters after the steps (whole, gathered
    from every rank, the model's names), the health records."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import DataParallel
    from paddle_tpu_torch.distributed import group_sharded_parallel
    from paddle_tpu_torch.observability.health import TrainingHealthMonitor
    from paddle_tpu_torch.parallel import Trainer
    from paddle_tpu_torch.parallel.mesh import gather
    model = (_tiny_llama if case["model"] == "llama" else _mlp)(
        case["dims"], case["sd"])
    opt = _optimizer(paddle, (case["opt"][0], dict(case["opt"][1])),
                     model.parameters())
    loss_fn = llama_loss if case["model"] == "llama" else mlp_loss
    if case.get("wrap"):
        model = DataParallel(model)
    if case.get("level"):
        model, opt = group_sharded_parallel(model, opt, case["level"])
    if case.get("eager"):
        return _eager_case(paddle, case, model, mesh)
    monitor = TrainingHealthMonitor() if case.get("health") else None
    bs = case.get("batch_spec")
    tr = Trainer(model, opt, loss_fn, mesh=mesh,
                 batch_spec=None if bs is None else tuple(
                     P(*s) for s in bs),
                 sharding_stage=case.get("stage", 0),
                 grad_clip_norm=case.get("clip"), health_monitor=monitor)
    losses, lrs, health = [], [], []
    for _ in range(case["steps"]):
        lrs.append(opt.get_lr())
        losses.append(float(tr.step(case["batch"])))
        if monitor is not None:
            health.append(dict(monitor.last))
    tr.sync_model()
    params = {}
    for n, p in model.named_parameters():
        v = p._value.detach()
        if mesh is not None:
            spec = p.dist_spec if p.dist_spec is not None else P()
            v = gather(v.contiguous(), spec, mesh)
        params[n.replace("_layers.", "")] = v.numpy()
    return {"losses": losses, "lrs": lrs, "params": params,
            "health": health,
            "state_specs": {n: {k: list(map(str, s)) for k, s in d.items()}
                            for n, d in tr.state_specs.items()},
            "slot_shapes": {n: {k: list(v.shape) for k, v in d.items()}
                            for n, d in tr.opt_state.items()}}


def _eager_case(paddle, case, model, mesh):
    """An eager loop (backward, the optimizer's step with its own
    global-norm clip) on a layer placed on `mesh`: the clip and the
    rule's norms take the placed parameters' blocks over their axes."""
    from paddle_tpu_torch.parallel import place_layer
    from paddle_tpu_torch.parallel.mesh import gather
    kind, kw = case["opt"][0], dict(case["opt"][1])
    lr = kw.pop("lr")
    place_layer(model, mesh)
    opt = getattr(paddle.optimizer, kind)(
        lr, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(case["clip"]), **kw)
    x, y = (paddle.to_tensor(a) for a in case["batch"])
    losses = []
    for _ in range(case["steps"]):
        loss = llama_loss(model, (x, y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    params = {n: gather(p._value.detach().contiguous(),
                        p.dist_spec if p.dist_spec is not None else P(),
                        mesh).numpy()
              for n, p in model.named_parameters()}
    return {"losses": losses, "params": params}


def _refusal_case(case):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.parallel import Trainer
    try:
        mesh = create_mesh(case["axes"])
        model = _tiny_llama(case["dims"], case["sd"])
        opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
        Trainer(model, opt, llama_loss, mesh=mesh).step(case["batch"])
    except Exception as e:        # the test holds the class and the words
        return type(e).__name__, str(e)
    return None


def trainer_cases(rank, world, data):
    """Every Trainer case of `data` for this world (each on its own
    mesh; refusals report their exception); rank 0's results."""
    _paddle_cpu()
    out = {}
    for name, case in data["cases"].items():
        if case.get("refusal"):
            out[name] = _refusal_case(case)
        else:
            out[name] = trainer_case(case, create_mesh(case["axes"]))
    return out if rank == 0 else None


# ------------------------------------------------------------- fleet
def fleet_cases(rank, world, data):
    """fleet.init under each strategy of `data` (every rank's view of
    the topology, gathered), and DataParallel's eager gradient average
    against rank 0's whole-batch gradient."""
    import torch.distributed as dist
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import DataParallel, fleet
    _paddle_cpu()
    out = {}
    for name, hc in data["strategies"].items():
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs.update(hc)
        try:
            fleet.init(is_collective=True, strategy=strategy)
        except ValueError as e:
            out[name] = ("ValueError", str(e))
            continue
        hcg = fleet.get_hybrid_communicate_group()
        mine = {"mesh": dict(fleet.fleet.get_mesh().shape),
                "dp": (hcg.get_data_parallel_world_size(),
                       hcg.get_data_parallel_rank(),
                       hcg.get_data_parallel_group().ranks),
                "mp": (hcg.get_model_parallel_world_size(),
                       hcg.get_model_parallel_rank(),
                       hcg.get_model_parallel_group().ranks),
                "pp": (hcg.get_pipe_parallel_world_size(),
                       hcg.get_stage_id(),
                       hcg.get_pipe_parallel_group().ranks),
                "rank": fleet.worker_index(), "world": fleet.worker_num()}
        every = [None] * world
        dist.all_gather_object(every, mine)
        out[name] = every
    # DataParallel in an eager loop: the averaged gradients of each
    # rank's half of the batch are the whole batch's
    dp = data["data_parallel"]
    create_mesh({"dp": world})
    model = _mlp(dp["dims"], dp["sd"])
    x, y = (np.array_split(a, world)[rank] for a in dp["batch"])
    wrapped = DataParallel(model)
    loss = mlp_loss(wrapped, (paddle.to_tensor(x), paddle.to_tensor(y)))
    loss.backward()
    wrapped.apply_collective_grads()
    out["data_parallel"] = {n: p.grad.numpy()
                            for n, p in model.named_parameters()}
    return out if rank == 0 else None


def card_layer_parallel(rank, world, data):
    """On the card (ranks sharing it over gloo): the tp layers of
    data["tp"] placed on {"tp": world}, and the tiny Layer-tree Llama's
    Trainer on tp `world` and on one rank (no mesh) from the same
    weights; each with the flash kernels' launches."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.ops.flash_attention as fa
    from paddle_tpu_torch.distributed.launch import rank_device
    from paddle_tpu_torch.parallel import Trainer
    from paddle_tpu_torch.parallel.mesh import gather
    dev = torch.device(rank_device("cuda"))
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    paddle.set_device(f"gpu:{dev.index}")
    out = {name: _tp_layer_case(case, create_mesh({"tp": world}))
           for name, case in data["tp"].items()}
    import paddle_tpu_torch.distributed.env as env
    for label, axes in (("single", None), ("tp", {"tp": world})):
        env.set_global_mesh(None)       # Trainer(mesh=None) reads it
        mesh = create_mesh(axes) if axes else None
        model = _tiny_llama(data["dims"], data["sd"])
        opt = paddle.optimizer.AdamW(data["lr"],
                                     parameters=model.parameters())
        tr = Trainer(model, opt, llama_loss, mesh=mesh, grad_clip_norm=1.0)
        fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
        losses = [float(tr.step(data["batch"])) for _ in range(data["steps"])]
        params = {}
        for n, p in model.named_parameters():
            v = p._value.detach()
            if mesh is not None:
                v = gather(v.contiguous(), p.dist_spec or P(), mesh)
            params[n] = v.cpu().numpy()
        out[label] = {"losses": losses, "params": params,
                      "device": str(tr.params[n].device),
                      "launches": (fa.launches_fwd, fa.launches_dq,
                                   fa.launches_dkv)}
    return out
