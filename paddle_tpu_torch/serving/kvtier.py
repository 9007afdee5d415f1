"""KV-cache tiering: a bounded host-RAM spill tier under the device
prefix cache (counterpart of `paddle_tpu/serving/kvtier.py`).

The device-side `PrefixCache` (serving/kvcache.py) parks refcount-0
pages in an LRU and discards them when allocation needs the page back,
so a multi-turn conversation that returns after a busy burst would
prefill its whole history again. `HostTier` turns the discard into a
demotion:

  * **spill**: the prefix cache's eviction hook hands the page's KV to a
    background copy thread, which indexes the landed page under the
    SAME chained block hash as the device cache, so lookup falls
    through device -> host;
  * **restore**: admission's longest-prefix walk continues into the tier
    where the device match ends; hits are scattered back into fresh
    device pages and the request prefills only the still-cold suffix;
  * **quantized storage**: with `quantize` on, tier pages are int8
    with per-token fp32 scales. The tier stores pages as it is given
    them: the engine encodes them on the device before the copy
    (`quantize_kv`; an int8 pool's pages and scales go as they are), so
    they hold what its own int8 pool would hold. `_quantize_host` and
    `_dequantize_host` are the plain host twins of that arithmetic, bit
    for bit the reference's and the card's;
  * **one ledger**: the preemption offload stash (`stash_put` /
    `stash_take`) lives here too, pinned outside the drop policy, so all
    host-resident KV is accounted against one `tier_bytes` budget.

Budget pressure drops the DEEPEST spilled block first (ties: oldest):
dropping a leaf never orphans descendants, and surviving roots keep
serving partial-prefix hits.

The hazard that changes with the framework: the JAX tier may hold a
device slice of an evicted page while the allocator hands the page out
again, because jax arrays are functional. The port's pools are updated
in place, so the engine snapshots the page BEFORE its spill hook
returns, on its own stream: a CPU clone, or on the card an asynchronous
copy into pinned host memory followed by a CUDA event. What reaches
`spill_async` and `export_pages` is therefore host memory, and `ready`
is that event; the copy thread waits on it and never reads a CUDA
tensor. Payloads are CPU tensors (a bf16 pool's pages stay
`torch.bfloat16`: numpy has no bfloat16), counted by `.nbytes` as the
reference counts its numpy arrays. A landed page stays in the pinned
memory its snapshot was copied into, so a restore copies it to the card
once, asynchronously, with no host copy on the way; the tier's pages
take at most `tier_bytes` of pinned memory.
"""
from __future__ import annotations

import queue
import threading
from collections import OrderedDict

import torch

from ..observability import flight_recorder as _flight
from . import kvcache as _kvc

__all__ = ["HostTier"]


class _ExportJob:
    """One KV handoff export riding the tier's copy thread: the caller
    (the engine's pump) blocks on `done` while the worker waits for the
    snapshot. The result, or the failure, belongs to the waiting caller,
    not to the copy-error count: a failed export leaves that one request
    to decode locally."""

    __slots__ = ("k", "v", "ks", "vs", "ready", "rids", "payload", "error",
                 "done")

    def __init__(self, k, v, ks, vs, ready, rids):
        self.k = k
        self.v = v
        self.ks = ks
        self.vs = vs
        self.ready = ready
        self.rids = rids
        self.payload = None
        self.error = None
        self.done = threading.Event()


def _quantize_host(x):
    """The plain host twin of the int8 tier encoding, which the engine
    computes on the device with `ops.paged_attention.quantize_kv`
    (absmax/127 per token over the head dim, floored scale), widened to
    fp32 first; torch.round rounds half to even as np.round does, so a
    page quantized here dequantizes to the values an int8 pool would
    hold. Takes a CPU tensor or a numpy array; returns (int8, fp32
    scale)."""
    xf = torch.as_tensor(x).to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_host(q, scale):
    return torch.as_tensor(q).to(torch.float32) * torch.as_tensor(scale)


def _nbytes(payload):
    return sum(int(a.nbytes) for a in payload.values() if a is not None)


def _wait(ready):
    """Block until the snapshot behind `ready` (a CUDA event, or None
    for a CPU clone) is in host memory."""
    if ready is not None:
        ready.synchronize()


class HostTier:
    """Bounded host-RAM KV tier: spilled prefix pages + the preemption
    offload stash, one bytes ledger. `quantize` names the encoding its
    callers give it: int8 pages with fp32 scales, or else a float pool's
    pages as they are (an int8 pool's always go with their scales).

    Thread model: the engine's pump thread calls `match`/`note_lookup`/
    `stash_*`; the tier's own copy worker inserts landed spills. All
    shared state (`_entries`, `_stash`, the ledger and counters) is
    guarded by `self._lock`; the wait for a snapshot runs outside the
    lock on the worker thread.

    Fleet hooks (`serving/fleet.py`, the global prefix cache): with
    `on_drop` set, budget-evicted entries go to it after the lock is
    released (peer-originated entries excepted: they never re-spill);
    with `fetch_missing` set, a `match` that ends short asks it, also
    outside the lock, for the chain's next blocks and inserts what it
    returns. Both are None by default, and then a drop is final and a
    short match stays short."""

    def __init__(self, page_size, tier_bytes=0, quantize=True):
        self.page_size = int(page_size)
        self.tier_bytes = int(tier_bytes)
        if self.tier_bytes < 0:
            raise ValueError(f"tier_bytes={tier_bytes}: want >= 0")
        self.quantize = bool(quantize)
        self._lock = threading.Lock()
        # chained hash -> entry dict(parent, block, depth, payload,
        # nbytes); iteration order is recency (move_to_end on touch)
        self._entries = OrderedDict()
        self._stash = {}             # key -> (payload, nbytes, pages)
        self._bytes = 0              # spill entries + stash, together
        self.lookups = 0
        self.hits = 0
        self.spills = 0
        self.restores = 0            # pages restored host -> device
        self.drops = 0
        self.copy_errors = 0         # spill copies that failed (page lost)
        self.tokens_reused = 0
        self._q = None
        self._worker = None
        # the engine's FaultPlan (serving/faults.py), fired on the copy
        # thread at `tier_spill` and `handoff_export`
        self.faults = None
        # fleet hooks (serving/fleet.py). `on_drop(entries)` receives
        # budget-evicted (key, entry) pairs after the lock is released
        # (it enqueues spills to the owning peer: a network call under
        # self._lock would stall the pump). `fetch_missing(parent,
        # block_idx, tokens)` runs at the end of a short `match`, also
        # outside the lock, and returns extra chain-order payloads
        # fetched from peers. Both None: a single host's behaviour.
        self.on_drop = None
        self.fetch_missing = None

    @property
    def enabled(self):
        """Spill side on? (The stash works regardless: preemption
        offload must not depend on the spill budget.)"""
        return self.tier_bytes > 0

    # -- spill (pump thread enqueues; worker thread lands) ---------------
    def spill_async(self, parent, block, depth, k, v, ks=None, vs=None,
                    ready=None):
        """Queue one evicted page for demotion. `k`/`v` (and the int8
        scales `ks`/`vs`) are host snapshots of the page (L, KVH, page,
        D) in the tier's encoding, complete once `ready` has fired; the
        worker waits for them and indexes the landed page."""
        if not self.enabled:
            return False
        if self._worker is None:
            self._start_worker()
        self._q.put((parent, block, depth, k, v, ks, vs, ready))
        return True

    def _start_worker(self):
        self._q = queue.Queue()
        self._worker = threading.Thread(target=self._copy_loop,
                                        name="pt-kvtier-copy",
                                        daemon=True)
        self._worker.start()

    def _copy_loop(self):
        # one bad page costs ONE page: an exception anywhere in the
        # wait/index path drops that page (a later lookup is a
        # miss), counts a copy error, and keeps the thread alive for
        # every later spill
        while True:
            item = self._q.get()
            if isinstance(item, _ExportJob):
                try:
                    item.payload = self._export(item)
                except Exception as e:  # noqa: BLE001 — the caller raises it
                    item.error = e
                finally:
                    item.done.set()
                    self._q.task_done()
                continue
            try:
                self._land(*item)
            except Exception as e:  # noqa: BLE001 — a failed spill is a miss
                with self._lock:
                    self.copy_errors += 1
                _flight.record("kvtier.error", error=repr(e))
            finally:
                self._q.task_done()

    def _land(self, parent, block, depth, k, v, ks, vs, ready):
        _wait(ready)
        if self.faults is not None:
            # chaos drills of the copy path: raise -> the page is dropped
            # and counted; corrupt -> a seeded byte flip lands in the
            # stored page
            k = self.faults.fire("tier_spill", k)
        payload = {"k": k, "v": v, "ks": ks, "vs": vs}
        nb = _nbytes(payload)
        key = _kvc.block_hash(parent, block)
        with self._lock:
            if key in self._entries:
                # re-spill of a block already held (or a colliding
                # foreign chain): the stored entry wins
                self._entries.move_to_end(key)
                return
            self._entries[key] = {"parent": parent, "block": block,
                                  "depth": int(depth), "payload": payload,
                                  "nbytes": nb}
            self._bytes += nb
            self.spills += 1
            dropped = self._shrink_locked()
            held, pages = self._bytes, len(self._entries)
        _flight.record("kvtier.spill", depth=int(depth), bytes=nb,
                       tier_bytes=held, tier_pages=pages)
        self._notify_drops(dropped)

    # -- handoff export (the pump blocks on the copy thread's wait) -----
    def export_pages(self, k, v, ks=None, vs=None, ready=None, rids=None,
                     timeout=30.0):
        """A request's KV pages for a prefill -> decode handoff. `k`/`v`
        (and the scales) are host snapshots (L, KVH, pages, page, D) in
        the tier's encoding, complete once `ready` has fired; the wait
        runs on the copy thread, behind the spills queued before it.

        Synchronous for the caller: returns the host payload dict
        {k, v, ks, vs}, or raises whatever the copy path raised (an
        armed `handoff_export` fault, for the request ids `rids`,
        included)."""
        if self._worker is None:
            self._start_worker()
        job = _ExportJob(k, v, ks, vs, ready, rids)
        self._q.put(job)
        if not job.done.wait(timeout):
            raise TimeoutError(
                f"kvtier: handoff export did not land within {timeout}s")
        if job.error is not None:
            raise job.error
        return job.payload

    def _export(self, job):
        """Worker half of `export_pages`: the wait. Nothing is indexed or
        counted: the payload belongs to the destination."""
        _wait(job.ready)
        k = job.k
        if self.faults is not None:
            # raise -> the engine keeps the request for local decode;
            # corrupt -> a byte flip lands in the shipped payload
            k = self.faults.fire("handoff_export", k, rids=job.rids)
        return {"k": k, "v": job.v, "ks": job.ks, "vs": job.vs}

    def _shrink_locked(self):
        """Drop spilled entries until the ledger fits `tier_bytes`,
        deepest block first (ties: oldest), so a drop never orphans
        descendants and surviving roots keep matching. The pinned stash
        is never dropped; it still counts, so heavy preemption pressure
        shrinks the spill side. Returns the dropped (key, entry) pairs,
        for the fleet's `on_drop` outside the lock."""
        dropped = []
        while self._bytes > self.tier_bytes and self._entries:
            victim, depth = None, -1
            for key, e in self._entries.items():  # oldest-first scan
                if e["depth"] > depth:
                    victim, depth = key, e["depth"]
            e = self._entries.pop(victim)
            self._bytes -= e["nbytes"]
            self.drops += 1
            dropped.append((victim, e))
        return dropped

    def _notify_drops(self, dropped):
        """Feed budget-evicted entries to the fleet hook, lock already
        released. Fleet-originated entries (a peer spilled them here)
        never re-spill: two budget-pressured hosts would otherwise pass
        the same page back and forth forever."""
        hook = self.on_drop
        if hook is None or not dropped:
            return
        local = [(k, e) for k, e in dropped if not e.get("fleet")]
        if local:
            hook(local)

    def flush(self, timeout=None):
        """Block until every queued spill has landed (tests and
        benchmarks; serving never needs it: a page still in flight is a
        miss). `timeout` bounds the wait in seconds."""
        if self._q is None:
            return True
        if timeout is None:
            self._q.join()
            return True
        landed = threading.Event()
        t = threading.Thread(target=lambda: (self._q.join(), landed.set()),
                             daemon=True)
        t.start()
        return landed.wait(timeout)

    # -- fleet page exchange (serving/fleet.py) ---------------------------
    def insert(self, parent, block, depth, payload, fleet=False):
        """Index a host-resident page payload directly (no snapshot to
        wait for): the landing half of a fleet page transfer, a page a
        peer shipped to its owner or a fetch-on-miss pulled back.
        `fleet=True` marks the entry peer-originated, so budget pressure
        drops it without spilling it again. Returns False when the tier
        is off or the key is already held."""
        if not self.enabled:
            return False
        block = tuple(int(t) for t in block)
        nb = _nbytes(payload)
        key = _kvc.block_hash(parent, block)
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return False
            e = {"parent": parent, "block": block, "depth": int(depth),
                 "payload": payload, "nbytes": nb}
            if fleet:
                e["fleet"] = True
            self._entries[key] = e
            self._bytes += nb
            dropped = self._shrink_locked()
        self._notify_drops(dropped)
        return True

    def peek(self, key):
        """One spilled entry by chained hash (what a peer's
        fetch-on-miss asks this tier for), touching its recency:
        {parent, block, depth, payload}, or None."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            self._entries.move_to_end(key)
            return {"parent": e["parent"], "block": e["block"],
                    "depth": e["depth"], "payload": e["payload"]}

    # -- lookup / restore accounting (pump thread) -----------------------
    def match(self, tokens, skip_tokens):
        """Continue the device cache's longest-prefix walk into the tier:
        re-derive the chained hashes of the device-matched blocks, then
        match tier entries block by block with raw (parent, block)
        verification, so a hash collision is a miss, never wrong KV.
        Capped one token short of len(tokens), as the device match.
        Returns the matched entries' payloads in chain order.

        With a fleet `fetch_missing` hook attached, a walk that ends
        short of the cap continues through the hook (lock released: the
        fetch is a network round trip), and the chain-order payloads the
        owning peer returns extend the match."""
        ps = self.page_size
        limit = (len(tokens) - 1) // ps
        skip = int(skip_tokens) // ps
        parent = _kvc._SEED
        out = []
        b = 0
        with self._lock:
            if not self._entries and self.fetch_missing is None:
                return out
            for b in range(limit):
                block = tuple(int(t) for t in tokens[b * ps:(b + 1) * ps])
                h = _kvc.block_hash(parent, block)
                if b >= skip:
                    e = self._entries.get(h)
                    if e is None or e["parent"] != parent \
                            or e["block"] != block:
                        break
                    out.append(e["payload"])
                    self._entries.move_to_end(h)
                parent = h
            else:
                b = limit
        hook = self.fetch_missing
        if hook is not None and skip <= b < limit:
            out.extend(hook(parent, b, tokens))
        return out

    def note_lookup(self, restored_pages):
        """Admission probed the tier; `restored_pages` pages made it back
        to the device (0 = miss)."""
        with self._lock:
            self.lookups += 1
            if restored_pages > 0:
                self.hits += 1
                self.restores += restored_pages
                self.tokens_reused += restored_pages * self.page_size

    # -- preemption offload stash (pinned; same ledger) ------------------
    def stash_put(self, key, payload, pages):
        """Park a preempted request's host KV verbatim (a resume must be
        exact) under the shared ledger. Pinned: never dropped; spilled
        prefix pages make room instead."""
        nb = _nbytes(payload)
        with self._lock:
            if key in self._stash:
                raise RuntimeError(f"kvtier: stash key {key!r} already "
                                   "held (double preemption?)")
            self._stash[key] = (payload, nb, int(pages))
            self._bytes += nb
            dropped = self._shrink_locked() if self.enabled else []
        self._notify_drops(dropped)

    def stash_take(self, key):
        with self._lock:
            payload, nb, _ = self._stash.pop(key)
            self._bytes -= nb
        return payload

    def stash_discard(self, key):
        with self._lock:
            item = self._stash.pop(key, None)
            if item is not None:
                self._bytes -= item[1]

    # -- introspection ---------------------------------------------------
    @property
    def host_bytes(self):
        with self._lock:
            return self._bytes

    @property
    def pages(self):
        """Host-resident KV pages: spilled prefix pages + stash pages."""
        with self._lock:
            return len(self._entries) + sum(p for _, _, p
                                            in self._stash.values())

    @property
    def hit_rate(self):
        with self._lock:
            return self.hits / self.lookups if self.lookups else 0.0

    def stats(self):
        with self._lock:
            stash_pages = sum(p for _, _, p in self._stash.values())
            return {"enabled": self.enabled,
                    "tier_bytes": self.tier_bytes,
                    "host_bytes": self._bytes,
                    "pages": len(self._entries) + stash_pages,
                    "spilled_pages": len(self._entries),
                    "stash_entries": len(self._stash),
                    "stash_pages": stash_pages,
                    "quantized": self.quantize,
                    "lookups": self.lookups, "hits": self.hits,
                    "hit_rate": (self.hits / self.lookups
                                 if self.lookups else 0.0),
                    "spills": self.spills, "restores": self.restores,
                    "drops": self.drops,
                    "copy_errors": self.copy_errors,
                    "tokens_reused": self.tokens_reused}
