"""Start the ranks of a parallel run (counterpart of
`paddle_tpu/distributed/launch.py`'s role).

The JAX package starts one process a host; here a rank is a process, so
the launcher starts one per rank, each with the rank environment that
`env.init_parallel_env` reads (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`PT_DIST_INIT`: a `file://` store in a fresh directory, and
`PT_DIST_BACKEND`). Every run has a deadline: a rank that fails stops
the others and its traceback is raised in the caller; at the deadline
every rank is killed.

    python -m paddle_tpu_torch.distributed.launch --nproc 2 \\
        --backend nccl train.py --steps 10

The backend is always the caller's (`--backend`, or spawn's `backend`):
"nccl" for one card a rank, "gloo" for CPU ranks or ranks that share a
card. Ranks compute on the card unless the caller asks for the CPU
(`--device cpu`, `device="cpu"`); without a card that request raises.

From Python, `spawn(fn, world, backend, device, deadline_s, args)` runs
`fn(rank, world, *args)` (a module-level function) on every rank after
the rendezvous and returns the ranks' results, in rank order;
`serve(build, requests, world, backend, ...)` drives a tensor-parallel
serving engine that way, every rank in lockstep on the same requests."""
from __future__ import annotations

import argparse
import importlib
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback


def _check_device(device):
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ranks on device='cuda' need a CUDA card, and this machine "
                "has none; pass device='cpu' (--device cpu) to run them on "
                "the CPU")


def rank_device(device=None):
    """The device this rank computes on (None: the launcher's
    `PT_SPAWN_DEVICE`, else "cuda"): "cpu", or for "cuda" the card
    `rank % device_count` (every rank shares card 0 on a one-card
    machine); "cuda" without a card raises."""
    device = device or os.environ.get("PT_SPAWN_DEVICE") or "cuda"
    _check_device(device)
    if device == "cpu":
        return device
    import torch
    return f"cuda:{int(os.environ.get('RANK', 0)) % torch.cuda.device_count()}"


def _check_backend(backend):
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: name 'nccl' (one card a "
                         "rank) or 'gloo' (CPU ranks, or ranks sharing a "
                         "card)")


def _rank_env(base, rank, world, backend, store, device, threads):
    env = dict(base)
    # the ranks import this package from where this process found it
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               PT_DIST_INIT=f"file://{store}", PT_DIST_BACKEND=backend,
               PT_SPAWN_DEVICE=device)
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
        env["PT_SPAWN_THREADS"] = str(threads)
    return env


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                p.kill()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass


def _tail(path, n=4000):
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def _watch(procs, deadline_s, describe, logs=lambda: ""):
    """Wait for every process; on a failure or at the deadline kill the
    rest and raise."""
    t_end = time.monotonic() + deadline_s
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                time.sleep(0.5)          # let the failure's peers land too
                codes = [p.poll() for p in procs]
                _kill(procs)
                raise RuntimeError(describe(
                    {r: c for r, c in enumerate(codes)
                     if c not in (None, 0)}))
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > t_end:
                _kill(procs)
                raise TimeoutError(
                    f"ranks still running after the {deadline_s} s deadline "
                    f"(exit codes {codes}); every rank was killed{logs()}")
            time.sleep(0.05)
    except BaseException:
        _kill(procs)
        raise


def spawn(fn, world, backend, device="cuda", deadline_s=300.0,
          args=(), threads=None, env=None, store_dir=None):
    """Run fn(rank, world, *args) on `world` new processes joined over
    `backend` ("gloo" or "nccl"; never chosen here) through a `file://`
    store, each computing on `rank_device(device)` ("cuda" raises here
    on a machine without a card); returns [result of
    rank 0, ...]. `fn` must be importable by its module and name (the
    ranks import it; this process's sys.path is theirs); args and
    results are pickled. threads sets each rank's
    torch.set_num_threads. The store, the job and the ranks' output live
    in a new directory (under `store_dir` when given), removed at the
    end. A rank that raises, exits or is killed stops the others and
    raises RuntimeError here with its traceback and output; past
    `deadline_s` seconds every rank is killed and TimeoutError raised."""
    _check_backend(backend)
    _check_device(device)
    module, name, sys_path = _reference(fn)
    tmp = tempfile.mkdtemp(prefix="pt_spawn_", dir=store_dir)
    try:
        with open(os.path.join(tmp, "job.pkl"), "wb") as f:
            pickle.dump({"module": module, "name": name,
                         "sys_path": sys_path, "args": tuple(args)}, f)
        store = os.path.join(tmp, "store")
        base = dict(os.environ if env is None else env)
        procs = []
        for rank in range(world):
            log = open(os.path.join(tmp, f"rank{rank}.log"), "wb")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
                 "--rank-worker", tmp],
                env=_rank_env(base, rank, world, backend, store, device,
                              threads),
                stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True, cwd=os.getcwd()))
            log.close()

        def describe(failed):
            # the first traceback written is the cause; the ranks that
            # failed after it lost their peer
            def written(r):
                try:
                    return os.stat(os.path.join(tmp, f"error{r}.txt")
                                   ).st_mtime_ns
                except OSError:
                    return float("inf")
            rank = min(failed, key=lambda r: (written(r), r))
            tb = _tail(os.path.join(tmp, f"error{rank}.txt"))
            out = _tail(os.path.join(tmp, f"rank{rank}.log"))
            return (f"rank {rank} of {world} failed (exit code "
                    f"{failed[rank]}):\n{tb or out}")

        def logs():
            return "".join(
                f"\n--- rank {r} output:\n"
                + _tail(os.path.join(tmp, f"rank{r}.log"), 1500)
                for r in range(world))
        _watch(procs, deadline_s, describe, logs)
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"result{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _reference(fn):
    """(module, qualified name, sys.path) by which a rank imports the
    module-level function `fn`. A function of the script that is running
    is imported by the script's file name."""
    module, sys_path = fn.__module__, list(sys.path)
    if module == "__main__":
        path = os.path.abspath(sys.modules["__main__"].__file__)
        module = os.path.splitext(os.path.basename(path))[0]
        sys_path.insert(0, os.path.dirname(path))
    return module, fn.__qualname__, sys_path


def _resolve(module, name, sys_path):
    sys.path[:0] = [p for p in sys_path if p not in sys.path]
    fn = importlib.import_module(module)
    for part in name.split("."):
        fn = getattr(fn, part)
    return fn


def serve(build, requests, world, backend, device="cuda", deadline_s=300.0,
          args=(), pipelined=False, threads=None, env=None, store_dir=None):
    """Drive a tensor-parallel serving engine in `world` spawned ranks, in
    lockstep: each rank builds its engine by `build(rank, world, *args)`
    (a module-level function, imported by the ranks as spawn's `fn` is,
    that returns a `ServingEngine` over a rank mesh), submits `requests`
    (`Request`s not yet submitted) in order and runs it to the end
    (`run`, or `run_pipelined`). Returns rank 0's finished requests.

    Every rank must finish the same requests with the same tokens, as
    the ranks' host state (admission, pages, preemption) follows the
    tokens they all draw from the same gathered logits: ranks that
    differ raise RuntimeError naming the first request that parts. A
    rank that fails stops the others, and at the deadline every rank is
    killed (TimeoutError), as under `spawn`."""
    done = spawn(_serve_rank, world, backend, device, deadline_s,
                 args=(_reference(build), list(requests), tuple(args),
                       pipelined), threads=threads, env=env,
                 store_dir=store_dir)
    want = [(r.rid, list(r.output)) for r in done[0]]
    for rank, reqs in enumerate(done[1:], 1):
        got = [(r.rid, list(r.output)) for r in reqs]
        if got != want:
            i = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), min(len(got), len(want)))
            raise RuntimeError(
                f"serve: rank {rank} finished other tokens than rank 0 "
                f"(first difference at finished request {i}: "
                f"{got[i:i + 1]} against {want[i:i + 1]}); the ranks "
                "left lockstep")
    return done[0]


def _serve_rank(rank, world, build, requests, args, pipelined):
    """One rank of `serve`: its engine, the requests, the run."""
    eng = _resolve(*build)(rank, world, *args)
    for r in requests:
        eng.submit(r)
    return eng.run_pipelined() if pipelined else eng.run()


def _rank_worker(tmp):
    """A spawned rank: join the group, run the job, write its result."""
    rank = int(os.environ["RANK"])
    try:
        with open(os.path.join(tmp, "job.pkl"), "rb") as f:
            job = pickle.load(f)
        import torch
        if os.environ.get("PT_SPAWN_THREADS"):
            torch.set_num_threads(int(os.environ["PT_SPAWN_THREADS"]))
        from . import env
        env.init_parallel_env()
        fn = _resolve(job["module"], job["name"], job["sys_path"])
        out = fn(rank, int(os.environ["WORLD_SIZE"]), *job["args"])
        with open(os.path.join(tmp, f"result{rank}.pkl.part"), "wb") as f:
            pickle.dump(out, f)
        os.replace(os.path.join(tmp, f"result{rank}.pkl.part"),
                   os.path.join(tmp, f"result{rank}.pkl"))
        import torch.distributed as dist
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
        return 0
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.stdout.flush()
        sys.stderr.flush()
        # no interpreter teardown: a process group whose peers are gone
        # can hold the exit for seconds
        os._exit(1)


def launch(script_argv, nproc, backend, deadline_s, init_method=None,
           device="cuda"):
    """Run `python script_argv...` as `nproc` ranks; returns 0, or raises
    as `spawn` does."""
    _check_backend(backend)
    _check_device(device)
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="pt_launch_")
        init_method = f"file://{os.path.join(tmp, 'store')}"
    try:
        procs = []
        for rank in range(nproc):
            env = _rank_env(os.environ, rank, nproc, backend, "", device,
                            None)
            env["PT_DIST_INIT"] = init_method
            procs.append(subprocess.Popen([sys.executable] + script_argv,
                                          env=env, start_new_session=True))
        _watch(procs, deadline_s,
               lambda failed: f"ranks exited with codes {failed}")
        return 0
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank-worker"]:
        return _rank_worker(argv[1])
    p = argparse.ArgumentParser(prog="paddle_tpu_torch.distributed.launch")
    p.add_argument("--nproc", type=int, required=True)
    p.add_argument("--backend", required=True, choices=("gloo", "nccl"),
                   help="nccl: one card a rank; gloo: CPU ranks, or "
                   "ranks that share a card")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the ranks compute (cuda raises without a "
                   "card)")
    p.add_argument("--init_method", default=None)
    p.add_argument("--deadline", type=float, default=3600.0,
                   help="seconds before every rank is killed")
    p.add_argument("script", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if not args.script:
        p.error("no training script given")
    try:
        return launch(args.script, args.nproc, args.backend, args.deadline,
                      args.init_method, args.device)
    except (RuntimeError, TimeoutError, ValueError) as e:
        print(f"[launch] {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
