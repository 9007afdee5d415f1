"""Pipeline parallelism, the functional half (counterpart of
`paddle_tpu/parallel/pp.py`).

Each rank of the `pp` axis holds one stage: a contiguous run of the
stacked layers (or, interleaved, `vpp` chunks of them). Activations move
forward and gradients backward between neighbouring stages through
point-to-point transfers on the axis's group, one hop a tick:

  * `pipeline_apply`: GPipe forward, differentiable. The ticks' ring
    transfers are the differentiable `ppermute`, so autograd runs the
    backward pipeline; an idle stage passes its input through and still
    joins every tick's transfer.
  * `pipeline_train_1f1b`: one-forward-one-backward (PipeDream flush).
    Each microbatch's stage input is stashed with its stage output's
    graph; its backward is `torch.autograd.grad` of that output against
    the gradient received from the next stage, so at most about 2 S
    microbatches are in flight.
  * `pipeline_train_interleaved`: the same over `vpp` chunks a stage,
    driven by the static tables of `build_interleaved_schedule` (a copy
    of the JAX package's: the tables are equal).

The Paddle layer surface: `LayerDesc`, `SharedLayerDesc` and
`PipelineLayer`, which stages every maximal run of same-signature layers
of a LayerDesc list over the pp ranks through `pipeline_apply`."""
from __future__ import annotations

import numpy as np
import torch

from ..distributed import collective as C


def stack_layer_params(layer_params_list):
    """[{name: tensor} per layer] -> {name: tensor stacked on dim 0}."""
    keys = layer_params_list[0].keys()
    return {k: torch.stack([lp[k] for lp in layer_params_list]) for k in keys}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def group_stages(stacked, n_stages):
    """{name: (L, ...)} -> {name: (n_stages, L/n_stages, ...)}."""
    def regroup(a):
        L = a.shape[0]
        assert L % n_stages == 0, f"layers {L} not divisible by pp={n_stages}"
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])
    return _tree_map(regroup, stacked)


def group_virtual_stages(stacked, n_stages, vpp):
    """{name: (L, ...)} -> {name: (n_stages, vpp, L/(S*v), ...)}: virtual
    stage j = c*S + r (chunk c of rank r) owns the j-th contiguous run
    of layers, so rank r holds chunks r, r+S, ..., r+(v-1)S."""
    Sv = n_stages * vpp
    perm = torch.as_tensor(np.arange(vpp)[None, :] * n_stages
                           + np.arange(n_stages)[:, None])

    def regroup(a):
        L = a.shape[0]
        assert L % Sv == 0, \
            f"layers {L} not divisible by pp*vpp={n_stages}*{vpp}"
        return a.reshape(Sv, L // Sv, *a.shape[1:])[perm.to(a.device)]
    return _tree_map(regroup, stacked)


def ungroup_virtual_stages(grouped, n_stages, vpp):
    """Inverse of group_virtual_stages: (S, v, Lc, ...) -> (L, ...)."""
    inv = torch.as_tensor(np.argsort(
        (np.arange(vpp)[None, :] * n_stages
         + np.arange(n_stages)[:, None]).reshape(-1)))

    def flatten(a):
        flat = a.reshape(n_stages * vpp, *a.shape[2:])[inv.to(a.device)]
        return flat.reshape(n_stages * vpp * a.shape[2], *a.shape[3:])
    return _tree_map(flatten, grouped)


def _names(tree):
    return sorted(tree)


def stage_forward(stage_params, h, layer_fn, extra):
    """Run the layers of one stage ({name: (n_layers, ...)}) over h."""
    names = _names(stage_params)
    for slices in zip(*(torch.unbind(stage_params[n]) for n in names)):
        h = layer_fn(dict(zip(names, slices)), h, extra)
    return h


def pipeline_apply(stage_params, x, layer_fn, mesh, pp_axis="pp",
                   n_micro=None, extra=None):
    """Differentiable GPipe forward over the `pp_axis` of the rank mesh.

    stage_params: this rank's stage, leaves (layers_per_stage, ...).
    x: (B, ...) entering stage 0, the same on every rank of the axis.
    layer_fn(layer_params, h, extra) -> h: one layer. Returns the last
    stage's output (B, ...) on every rank of the axis.

    Stage s runs microbatch t - s at tick t and passes its input through
    on the other ticks; every rank joins every tick's transfer, and every
    rank's backward walks the whole tick chain (stage 0 ties the ring's
    arrivals into its inputs, the others tie x), so the transfers'
    backward ppermutes run in the same order everywhere. x's gradient is
    summed over the axis, the output's passed through: both replicated,
    as in the JAX package."""
    group = mesh.group(pp_axis)
    S, idx = group.nranks, group.rank
    B = x.shape[0]
    M = n_micro or S
    assert B % M == 0, f"batch {B} not divisible by n_micro {M}"
    xm = C.copy_to_group(x, group).reshape(M, B // M, *x.shape[1:])
    ring = [(i, (i + 1) % S) for i in range(S)]
    buf = torch.zeros_like(xm[0])
    T = M + S - 1
    ys = []
    for t in range(T):
        if idx == 0:
            inp = C.tie(xm[min(t, M - 1)], buf)
        elif t == 0:
            inp = C.tie(buf, xm)
        else:
            inp = buf
        y = (stage_forward(stage_params, inp, layer_fn, extra)
             if 0 <= t - idx < M else inp)
        if t >= S - 1:
            ys.append(y)
        if t < T - 1:
            buf = C.ppermute(y, ring, group)
    outs = torch.stack(ys)
    if idx != S - 1:
        outs = outs * 0.0          # keeps this rank's chain in its graph
    out = C.reduce_from_group(outs, group)
    return out.reshape(B, *out.shape[2:])


def _leaf(t):
    return t.detach().requires_grad_()


def _head_vjp(head_fn, head_leaves, head_names, y, tgt):
    """The head's loss sum, weight, fp32 parameter gradients and the
    gradient of y, seeded with d(loss_sum) = 1 (the global 1/sum of the
    weights is applied once, in the epilogue)."""
    hp = [_leaf(t) for t in head_leaves]
    yy = _leaf(y)
    with torch.enable_grad():
        loss_m, w_m = head_fn(dict(zip(head_names, hp)), yy, tgt)
        grads = torch.autograd.grad(loss_m, hp + [yy])
    return (loss_m.detach().float(), torch.as_tensor(w_m).detach().float(),
            [g.float() for g in grads[:-1]], grads[-1].to(y.dtype))


def _hop(group, fwd, bwd):
    """One tick's transfers: `fwd` to the next rank, `bwd` to the
    previous one; returns what arrived from each side."""
    S, s = group.nranks, group.rank
    if S == 1:
        return fwd, bwd
    f_in, b_in = torch.empty_like(fwd), torch.empty_like(bwd)
    C.exchange([(fwd, (s + 1) % S), (bwd, (s - 1) % S)],
               [(f_in, (s - 1) % S), (b_in, (s + 1) % S)], group)
    return f_in, b_in


def _epilogue(group, gparams, ghead, dx, losses, wts, total_weight):
    """Losses and weights from the last stage, dx from stage 0, every
    gradient scaled by 1 / (the total weight: the summed weights, or
    `total_weight` when the ranks hold parts of the batch)."""
    S, r = group.nranks, group.rank
    zero_unless = lambda t, keep: t if keep else torch.zeros_like(t)  # noqa: E731
    losses = C.all_reduce(zero_unless(losses, r == S - 1), group=group)
    wts = C.all_reduce(zero_unless(wts, r == S - 1), group=group)
    total = wts.sum() if total_weight is None else torch.as_tensor(
        total_weight, dtype=torch.float32, device=wts.device)
    total = torch.clamp_min(total, 1e-9)
    inv_w = 1.0 / total
    C.all_reduce_coalesced(ghead, group)
    for g in gparams + ghead:
        g.mul_(inv_w)
    dx = C.all_reduce(zero_unless(dx, r == 0), group=group) * inv_w
    return losses.sum() / total, gparams, ghead, dx


def pipeline_train_1f1b(stage_params, x, targets, layer_fn, head_fn,
                        head_params, mesh, pp_axis="pp", n_micro=None,
                        extra=None, total_weight=None):
    """One-forward-one-backward pipeline TRAIN pass over `pp_axis`.

    Stage s forwards microbatch m at tick m + s and backwards it at tick
    m + 2S - 2 - s; the last stage runs the head (`head_fn(head_params,
    h, targets_mb) -> (loss_sum, weight)`) on its output at once and
    seeds that tick's backward with the head's gradient. Each tick ends
    with one transfer forward (the activation) and one backward (the
    gradient); M + 2S - 2 ticks in all.

    stage_params: this rank's stage, leaves (layers_per_stage, ...); x:
    (B, ...) entering stage 0 and targets (B, ...), the same on every
    rank of the axis; head_params: a flat dict, the same everywhere.
    total_weight: the weight every gradient is divided by (default: the
    summed weights of this batch; a rank holding part of a data-parallel
    batch passes the global sum).

    Returns (loss, stage_grads, head_grads, dx): loss = sum of loss_sum
    / the total weight; stage_grads like stage_params, head_grads like
    head_params (fp32, the same on every rank), dx = dLoss/dx (B, ...)."""
    group = mesh.group(pp_axis)
    S, s = group.nranks, group.rank
    B = x.shape[0]
    M = n_micro or S
    assert B % M == 0, f"batch {B} not divisible by n_micro {M}"
    xm = x.reshape(M, B // M, *x.shape[1:])
    tm = targets.reshape(M, B // M, *targets.shape[1:])
    names = _names(stage_params)
    leaves = [_leaf(stage_params[n]) for n in names]
    tree = dict(zip(names, leaves))
    head_names = _names(head_params)
    head_leaves = [head_params[n] for n in head_names]
    gparams = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
    ghead = [torch.zeros_like(t, dtype=torch.float32) for t in head_leaves]
    dx = torch.zeros_like(xm)
    losses = torch.zeros(M, dtype=torch.float32, device=x.device)
    wts = torch.zeros(M, dtype=torch.float32, device=x.device)
    stash = {}
    fwd_buf = torch.zeros_like(xm[0])
    bwd_buf = torch.zeros_like(xm[0])
    gy = None
    for t in range(M + 2 * S - 2):
        mf = t - s
        send = torch.zeros_like(xm[0])
        if 0 <= mf < M:
            inp = _leaf(xm[mf] if s == 0 else fwd_buf)
            with torch.enable_grad():
                y = stage_forward(tree, inp, layer_fn, extra)
            stash[mf] = (inp, y)
            send = y.detach()
            if s == S - 1:
                loss_m, w_m, ghp, gy = _head_vjp(head_fn, head_leaves,
                                                 head_names, send, tm[mf])
                for acc, g in zip(ghead, ghp):
                    acc.add_(g)
                losses[mf], wts[mf] = loss_m, w_m
        mb = t - (2 * S - 2 - s)
        gh = torch.zeros_like(xm[0])
        if 0 <= mb < M:
            inp_b, y_b = stash.pop(mb)
            gin = gy if s == S - 1 else bwd_buf
            grads = torch.autograd.grad(y_b, [inp_b] + leaves, gin)
            gh = grads[0].to(xm.dtype)
            for acc, g in zip(gparams, grads[1:]):
                acc.add_(g.float())
            if s == 0:
                dx[mb] = gh
        fwd_buf, bwd_buf = _hop(group, send, gh)
    loss, gparams, ghead, dx = _epilogue(group, gparams, ghead, dx, losses,
                                         wts, total_weight)
    return (loss, dict(zip(names, gparams)), dict(zip(head_names, ghead)),
            dx.reshape(B, *dx.shape[2:]))


def build_interleaved_schedule(n_micro, n_stages, vpp):
    """Static lockstep slot tables for interleaved (virtual-stage) 1F1B.

    Greedy list scheduling under the lockstep constraints — per tick
    each rank runs at most one chunk-forward and one chunk-backward,
    and activations/gradients hop exactly one rank per tick (ppermute)
    with arrival the next tick. Forward priority is deepest-virtual-
    stage-first (drives the first microbatches to the head ASAP);
    backward is FIFO by microbatch. The resulting wall-clock matches
    Megatron's interleaved 1F1B: fill/drain cost (S-1)/v stage-units
    (reference pipeline_parallel.py:1309, :1359-1367).

    Returns a dict of int32 numpy tables, each (T, S):
      f_c/f_m:   chunk/microbatch of the forward slot (-1 = idle)
      b_c/b_m:   same for the backward slot
      rf_c/rf_m: chunk/mb of the activation arriving at tick start
                 (produced by rank r-1 last tick) to stash (-1 = none)
      rb_c/rb_m: same for the arriving gradient (from rank r+1)
    plus scalars T, in_cap, g_cap (stash depths, collision-free mod-cap
    indexing proven against the schedule itself).
    """
    M, S, v = n_micro, n_stages, vpp
    Sv = S * v
    INF = 1 << 30
    avail_f = {(j, m): (0 if j == 0 else INF)
               for j in range(Sv) for m in range(M)}
    avail_b = {(j, m): INF for j in range(Sv) for m in range(M)}
    done_f, done_b = set(), set()
    slots = {r: [] for r in range(S)}
    arrive_f = {}   # (j, m) -> tick its input lands in the stash
    arrive_g = {}   # (j, m) -> tick its upstream grad lands
    bwd_at = {}
    t = 0
    while len(done_b) < Sv * M:
        assert t < 4 * (M + 2 * Sv), "interleave scheduler wedged"
        produced = []
        for r in range(S):
            js = [c * S + r for c in range(v)]
            cand_f = [(j, m) for j in js for m in range(M)
                      if (j, m) not in done_f and avail_f[(j, m)] <= t]
            f_op = min(cand_f, key=lambda jm: (-jm[0], jm[1])) \
                if cand_f else None
            cand_b = [(j, m) for j in js for m in range(M)
                      if (j, m) not in done_b and avail_b[(j, m)] <= t]
            if f_op and f_op[0] == Sv - 1:
                cand_b.append(f_op)  # head seeds its own bwd this tick
            b_op = min(cand_b, key=lambda jm: (jm[1], -jm[0])) \
                if cand_b else None
            slots[r].append((f_op, b_op))
            produced.append((r, f_op, b_op))
        for r, f_op, b_op in produced:
            if f_op:
                done_f.add(f_op)
                j, m = f_op
                if j + 1 < Sv:
                    avail_f[(j + 1, m)] = t + 1
                    arrive_f[(j + 1, m)] = t + 1
                else:
                    avail_b[(j, m)] = min(avail_b[(j, m)], t)
                    arrive_g[(j, m)] = t  # head gy written same tick
            if b_op:
                done_b.add(b_op)
                bwd_at[b_op] = t
                j, m = b_op
                if j - 1 >= 0:
                    avail_b[(j - 1, m)] = t + 1
                    arrive_g[(j - 1, m)] = t + 1
        t += 1
    T = t

    tabs = {k: np.full((T, S), -1, np.int32)
            for k in ("f_c", "f_m", "b_c", "b_m",
                      "rf_c", "rf_m", "rb_c", "rb_m")}
    for r in range(S):
        for t_, (f_op, b_op) in enumerate(slots[r]):
            if f_op:
                tabs["f_c"][t_, r] = f_op[0] // S
                tabs["f_m"][t_, r] = f_op[1]
            if b_op:
                tabs["b_c"][t_, r] = b_op[0] // S
                tabs["b_m"][t_, r] = b_op[1]
    # receive tables: what rank r must stash at the START of tick t is
    # whatever its ring neighbour produced at t-1
    for r in range(S):
        p = (r - 1) % S
        for t_ in range(1, T):
            fp, _ = slots[p][t_ - 1]
            if fp and fp[0] + 1 < Sv and (fp[0] + 1) % S == r:
                tabs["rf_c"][t_, r] = (fp[0] + 1) // S
                tabs["rf_m"][t_, r] = fp[1]
        p = (r + 1) % S
        for t_ in range(1, T):
            _, bp = slots[p][t_ - 1]
            if bp and bp[0] - 1 >= 0 and (bp[0] - 1) % S == r:
                tabs["rb_c"][t_, r] = (bp[0] - 1) // S
                tabs["rb_m"][t_, r] = bp[1]

    def min_cap(arrive, release):
        """Smallest cap with no mod-cap collision: for every pair of
        same-chunk ops m < m', m' must not land on m's slot while m is
        live (live = [arrive, release])."""
        for cap in range(1, M + 1):
            ok = True
            for (j, m), a in arrive.items():
                rel = release.get((j, m), a)
                m2 = m + cap
                while ok and (j, m2) in arrive:
                    if arrive[(j, m2)] <= rel:
                        ok = False
                    m2 += cap
                if not ok:
                    break
            if ok:
                return cap
        return M

    # forward-input stash entries live from arrival until the chunk's
    # backward consumes them for recompute; grad entries from arrival
    # until the backward runs
    in_cap = min_cap(arrive_f, bwd_at)
    g_cap = min_cap(arrive_g, bwd_at)
    return dict(tabs, T=T, in_cap=max(in_cap, 1), g_cap=max(g_cap, 1))


def pipeline_train_interleaved(stage_params, x, targets, layer_fn, head_fn,
                               head_params, mesh, pp_axis="pp", n_micro=None,
                               vpp=2, extra=None, total_weight=None):
    """Interleaved virtual-stage 1F1B TRAIN pass (Megatron's vpp): rank r
    owns chunks r, r+S, ..., r+(vpp-1)S of the model, so the fill and
    drain cost (S-1)/vpp stage-units instead of S-1. Each tick follows
    `build_interleaved_schedule`'s row for this rank: stash what arrived,
    one chunk forward, one chunk backward, then the two transfers.

    Args as `pipeline_train_1f1b`, except stage_params' leaves are this
    rank's chunks, (vpp, layers_per_chunk, ...) (`group_virtual_stages`'
    row r), and n_micro defaults to S * vpp. Returns (loss, stage_grads,
    head_grads, dx), stage_grads in stage_params' layout."""
    group = mesh.group(pp_axis)
    S, r = group.nranks, group.rank
    v = vpp
    B = x.shape[0]
    M = n_micro or S * v
    assert B % M == 0, f"batch {B} not divisible by n_micro {M}"
    sched = build_interleaved_schedule(M, S, v)
    xm = x.reshape(M, B // M, *x.shape[1:])
    tm = targets.reshape(M, B // M, *targets.shape[1:])
    names = _names(stage_params)
    chunks = [[_leaf(stage_params[n][c]) for n in names] for c in range(v)]
    head_names = _names(head_params)
    head_leaves = [head_params[n] for n in head_names]
    gparams = [torch.zeros_like(stage_params[n], dtype=torch.float32)
               for n in names]
    ghead = [torch.zeros_like(t, dtype=torch.float32) for t in head_leaves]
    dx = torch.zeros_like(xm)
    losses = torch.zeros(M, dtype=torch.float32, device=x.device)
    wts = torch.zeros(M, dtype=torch.float32, device=x.device)
    arrived, graphs, g_stash = {}, {}, {}
    fwd_in = torch.zeros_like(xm[0])
    bwd_in = torch.zeros_like(xm[0])
    keys = ("f_c", "f_m", "b_c", "b_m", "rf_c", "rf_m", "rb_c", "rb_m")
    for t in range(sched["T"]):
        f_c, f_m, b_c, b_m, rf_c, rf_m, rb_c, rb_m = (
            int(sched[k][t, r]) for k in keys)
        # 0. stash what the ring delivered at the end of the last tick
        if rf_c >= 0:
            arrived[(rf_c, rf_m)] = fwd_in
        if rb_c >= 0:
            g_stash[(rb_c, rb_m)] = bwd_in
        # 1. forward sub-tick
        send = torch.zeros_like(xm[0])
        if f_c >= 0:
            inp = _leaf(xm[f_m] if (r == 0 and f_c == 0)
                        else arrived.pop((f_c, f_m)))
            with torch.enable_grad():
                y = stage_forward(dict(zip(names, chunks[f_c])), inp,
                                  layer_fn, extra)
            graphs[(f_c, f_m)] = (inp, y)
            send = y.detach()
            if r == S - 1 and f_c == v - 1:     # the head's virtual stage
                loss_m, w_m, ghp, gy = _head_vjp(head_fn, head_leaves,
                                                 head_names, send, tm[f_m])
                for acc, g in zip(ghead, ghp):
                    acc.add_(g)
                losses[f_m], wts[f_m] = loss_m, w_m
                g_stash[(v - 1, f_m)] = gy
        # 2. backward sub-tick
        gh = torch.zeros_like(xm[0])
        if b_c >= 0:
            inp_b, y_b = graphs.pop((b_c, b_m))
            grads = torch.autograd.grad(y_b, [inp_b] + chunks[b_c],
                                        g_stash.pop((b_c, b_m)))
            gh = grads[0].to(xm.dtype)
            for acc, g in zip(gparams, grads[1:]):
                acc[b_c].add_(g.float())
            if r == 0 and b_c == 0:
                dx[b_m] = gh
        # 3. the ring hops, on every rank every tick
        fwd_in, bwd_in = _hop(group, send, gh)
    loss, gparams, ghead, dx = _epilogue(group, gparams, ghead, dx, losses,
                                         wts, total_weight)
    return (loss, dict(zip(names, gparams)), dict(zip(head_names, ghead)),
            dx.reshape(B, *dx.shape[2:]))


def pipeline_bubble_fraction(n_micro, n_stages, schedule="1f1b", vpp=1):
    """Wall-clock idle fraction of the pipeline (idle sub-ticks cost
    nothing, so the canonical formulas hold):

      gpipe / 1f1b:  (S-1) / (M + S-1)
      interleave:    ((S-1)/v) / (M + (S-1)/v)"""
    M, S = n_micro, n_stages
    if schedule == "interleave":
        assert vpp > 1, ("interleave bubble needs the vpp actually used "
                         "(vpp=1 would silently report the plain 1F1B "
                         "bubble)")
        fill = (S - 1) / vpp
    else:
        fill = S - 1
    return fill / (M + fill)


class LayerDesc:
    """reference: fleet.meta_parallel LayerDesc."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build(self):
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, *args, forward_func=None,
                 shared_weight_attr=None, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.key = key


class PipelineLayer:
    """API-parity container (reference: fleet.meta_parallel.PipelineLayer):
    splits a LayerDesc list into pp stages.

    With a mesh whose pp axis has `num_stages` ranks, forward() runs
    stage-parallel: every maximal run of layers of one class and the
    same parameter shapes (no buffers) long enough to fill the stages
    is trimmed to a multiple of num_stages, and each rank runs its
    contiguous block of it through `pipeline_apply` (GPipe, `n_micro`
    microbatches), the activations moving between the stages; the
    layers between runs run on every rank. The result reaches every
    rank. Every rank builds every layer (from the same draws), and a
    staged layer's gradients land on the rank that runs it. Without a
    mesh, or when nothing can be staged, forward is sequential.

    seg_method: "uniform" (default) stages every eligible run;
    "layer:ClassName" only runs of that class. recompute_interval > 0
    runs each staged layer under `torch.utils.checkpoint`
    (non-reentrant): its activations are recomputed in the backward.
    """

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0, mesh=None,
                 pp_axis="pp", n_micro=None, **kwargs):
        import warnings
        self.descs = layers
        self.num_stages = num_stages or 1
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.pp_axis = pp_axis
        self.n_micro = n_micro
        self.seg_method = seg_method
        self.recompute_interval = int(recompute_interval)
        if not (seg_method == "uniform"
                or str(seg_method).startswith("layer:")):
            raise ValueError(
                f"seg_method={seg_method!r} unsupported: use 'uniform' "
                "or 'layer:ClassName'")
        self.built = [d.build() if isinstance(d, LayerDesc) else d
                      for d in layers]
        self._segments = (self._find_stageable_segments()
                          if self.num_stages > 1 else [])
        if self.num_stages > 1 and self.mesh is not None:
            mesh_pp = self.mesh.shape.get(self.pp_axis, 1)
            if not self._segments:
                warnings.warn(
                    f"PipelineLayer(num_stages={self.num_stages}): no "
                    f"homogeneous run of >= {self.num_stages} stackable "
                    "layers found — forward() will run SEQUENTIALLY "
                    "(replicated), not pipelined. Stage-parallel "
                    "execution needs same-class layers with identical "
                    f"param shapes (seg_method={seg_method!r}).",
                    stacklevel=2)
            elif mesh_pp != self.num_stages:
                warnings.warn(
                    f"PipelineLayer(num_stages={self.num_stages}): mesh "
                    f"'{self.pp_axis}' axis has {mesh_pp} devices — "
                    "forward() will run SEQUENTIALLY (replicated), not "
                    "pipelined. Make num_stages match the mesh's pp "
                    "axis.", stacklevel=2)
        if self.recompute_interval > 0 and not self._will_stage():
            warnings.warn(
                f"PipelineLayer: recompute_interval="
                f"{self.recompute_interval} only applies on the staged "
                "pipeline path; this construction runs sequentially "
                "(no mesh / mesh-axis mismatch / nothing stackable), so "
                "NO activation recompute will happen.", stacklevel=2)

    def _will_stage(self):
        """True iff forward() will take the stage-parallel path."""
        return bool(
            self._segments and self.mesh is not None
            and self.mesh.shape.get(self.pp_axis, 1) == self.num_stages)

    def _layer_sig(self, layer):
        if not hasattr(layer, "functional_state"):
            return None
        p, b = layer.functional_state()
        # a layer with buffers is not stackable: every stacked layer
        # would run with the template's buffers
        if b:
            return None
        sig = (type(layer), tuple(sorted((n, tuple(a.shape), str(a.dtype))
                                         for n, a in p.items())))
        if str(self.seg_method).startswith("layer:"):
            want = str(self.seg_method)[len("layer:"):]
            if type(layer).__name__ != want:
                return None
        return sig

    def _find_stageable_segments(self):
        """All maximal runs of same-signature layers, each trimmed to
        the largest multiple of num_stages (leftover tail layers run
        sequentially); empty when nothing can fill every stage."""
        sigs = [self._layer_sig(layer) for layer in self.built]
        segments = []
        i, n = 0, len(sigs)
        while i < n:
            if sigs[i] is None:
                i += 1
                continue
            j = i
            while j < n and sigs[j] == sigs[i]:
                j += 1
            count = (j - i) // self.num_stages * self.num_stages
            if count >= self.num_stages and count >= 2:
                segments.append((i, i + count))
            i = j
        return segments

    def _staged(self, seg, x):
        """This rank's block of the segment through pipeline_apply."""
        from torch.utils.checkpoint import checkpoint
        start, end = seg
        per = (end - start) // self.num_stages
        r = self.mesh.coord(self.pp_axis)
        mine = self.built[start + r * per:start + (r + 1) * per]
        template = mine[0]
        stage = stack_layer_params([layer.functional_state()[0]
                                    for layer in mine])

        def layer_fn(lp, h, extra):
            return template.functional_call(lp, {}, h)
        if self.recompute_interval > 0:
            plain = layer_fn

            def layer_fn(lp, h, extra):
                return checkpoint(plain, lp, h, extra, use_reentrant=False)
        return pipeline_apply(stage, x, layer_fn, self.mesh, self.pp_axis,
                              self.n_micro)

    def _staged_forward(self, x):
        from .._core.tensor import Tensor, unwrap
        pos = 0
        for start, end in self._segments:
            for layer in self.built[pos:start]:
                x = layer(x)
            x = Tensor(self._staged((start, end), unwrap(x)))
            pos = end
        for layer in self.built[pos:]:
            x = layer(x)
        return x

    def forward(self, x):
        if self._will_stage():
            return self._staged_forward(x)
        for layer in self.built:
            x = layer(x)
        return x

    def __call__(self, x):
        return self.forward(x)
