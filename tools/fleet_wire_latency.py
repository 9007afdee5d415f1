#!/usr/bin/env python3
"""Time the fleet bulk channel's framing over loopback TCP.

The fleet plane (`paddle_tpu_torch/serving/fleet.py`) moves a prefix
page and a KV handoff with `serving/wire.py`'s frames, one connection
each: a JSON request, a JSON head, then k, v, ks and vs, each a JSON
array header, an 8-byte length and the bytes. This script replays that
exchange between two threads of one process on 127.0.0.1, with the
payloads of Llama-3-8B's int8 encoding (32 layers, 8 KV heads, head dim
128, page 16: 1,081,344 bytes a page), for

  * `page`: one page, as `FleetPages.serve_page` / `_fetch_page` move it;
  * `handoff`: `--handoff-pages` pages (41 is the median request of
    chip_smoke.py's fleet phase (a)), as `_serve_handoff` /
    `_fetch_handoff` move one;

each with the sockets as the fleet opens them and with TCP_NODELAY set
on both ends (the fleet does not set it). Each case prints one JSON line
with the median and the 95th percentile of `--reps` transfers and the
rate; the host's name comes first. Host sockets only: no card is used.

    python3 tools/fleet_wire_latency.py [--reps 30] [--handoff-pages 41]
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PAGE = {"L": 32, "KVH": 8, "T": 16, "D": 128}


def _payload(pages):
    import torch
    shape = (PAGE["L"], PAGE["KVH"], pages, PAGE["T"], PAGE["D"])
    k = torch.ones(shape, dtype=torch.int8)
    s = torch.ones(shape[:-1] + (1,), dtype=torch.float32)
    return [k, k.clone(), s, s.clone()]


def _case(pages, reps, nodelay):
    """Median and p95 seconds of `reps` exchanges of `pages` pages."""
    from paddle_tpu_torch.serving import wire
    parts = _payload(pages)
    srv = socket.create_server(("127.0.0.1", 0))
    addr = srv.getsockname()

    def serve():
        for _ in range(reps):
            conn, _ = srv.accept()
            with conn:
                if nodelay:
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                wire.recv_json(conn)
                wire.send_json(conn, {"ok": True})
                for a in parts:
                    wire.send_array(conn, a)
    t = threading.Thread(target=serve, daemon=True)
    t.start()
    times = []
    try:
        for _ in range(reps):
            t0 = time.perf_counter()
            with socket.create_connection(addr, timeout=60) as s:
                if nodelay:
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                wire.send_json(s, {"op": "page_get", "key": 0})
                wire.recv_json(s)
                for _ in parts:
                    wire.recv_array(s)
            times.append(time.perf_counter() - t0)
    finally:
        t.join(60)
        srv.close()
    times.sort()
    nbytes = sum(int(a.nbytes) for a in parts)
    med = statistics.median(times)
    return {"pages": pages, "bytes": nbytes, "tcp_nodelay": nodelay,
            "reps": reps, "median_s": med,
            "p95_s": times[min(reps - 1, int(0.95 * reps))],
            "gb_s": nbytes / med / 1e9}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--handoff-pages", type=int, default=41)
    args = ap.parse_args(argv)
    print(json.dumps({"host": socket.gethostname(),
                      "cpus": os.cpu_count()}), flush=True)
    for name, pages in (("page", 1), ("handoff", args.handoff_pages)):
        for nodelay in (False, True):
            row = _case(pages, args.reps, nodelay)
            print(json.dumps({"case": name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
