"""paddle.distributed.fleet.utils (counterpart of
`paddle_tpu/distributed/fleet/utils.py`; reference:
python/paddle/distributed/fleet/utils/{__init__,fs}.py).

`recompute` is the fleet-level activation-rematerialisation entry (the
implementation lives in fleet's __init__, over torch.utils.checkpoint).
`LocalFS` is the filesystem client the checkpoint/elastic tooling uses.
`HDFSClient` keeps the reference's configuration (construction
succeeds); its operations raise with guidance, RuntimeError where no
hadoop CLI is found and NotImplementedError where one is (no bindings
drive it). `DistributedInfer` belongs to the
fluid static-graph PS-inference flow; its job here is
inference (ROADMAP.md Queue 1 item 13b) and the parameter-server tier
(item 12c), so it raises NotImplementedError naming them.
"""
from __future__ import annotations

import os
import shutil

from . import recompute  # noqa: F401  (reference re-exports it here)

__all__ = ["LocalFS", "HDFSClient", "DistributedInfer", "recompute"]


class FSFileExistsError(RuntimeError):
    pass


class FSFileNotExistsError(RuntimeError):
    pass


class LocalFS:
    """reference fs.py:141 — local filesystem with the FS client
    interface (so checkpoint code can take any FS)."""

    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for f in os.listdir(fs_path):
            (dirs if os.path.isdir(os.path.join(fs_path, f))
             else files).append(f)
        return dirs, files

    def mkdirs(self, fs_path):
        assert not os.path.isfile(fs_path), f"{fs_path} is already a file"
        os.makedirs(fs_path, exist_ok=True)

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def delete(self, fs_path):
        if not self.is_exist(fs_path):
            return
        if os.path.isfile(fs_path):
            os.remove(fs_path)
        else:
            shutil.rmtree(fs_path)

    def need_upload_download(self):
        return False

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if exist_ok:
                return
            raise FSFileExistsError(fs_path)
        with open(fs_path, "a"):
            pass

    def mv(self, src_path, dst_path, overwrite=False, test_exists=False):
        if not self.is_exist(src_path):
            raise FSFileNotExistsError(src_path)
        if overwrite and self.is_exist(dst_path):
            self.delete(dst_path)
        if self.is_exist(dst_path):
            raise FSFileExistsError(dst_path)
        return self.rename(src_path, dst_path)

    def list_dirs(self, fs_path):
        if not self.is_exist(fs_path):
            return []
        return [f for f in os.listdir(fs_path)
                if os.path.isdir(os.path.join(fs_path, f))]


class HDFSClient:
    """reference fs.py HDFSClient — drives `hadoop fs` via the CLI.
    Constructed with config for parity; operations require the hadoop
    binary, and no bindings drive it."""

    def __init__(self, hadoop_home=None, configs=None,
                 time_out=5 * 60 * 1000, sleep_inter=1000):
        self.hadoop_home = hadoop_home
        self.configs = dict(configs or {})
        self.time_out = time_out
        self.sleep_inter = sleep_inter
        cand = (os.path.join(hadoop_home, "bin", "hadoop")
                if hadoop_home else "hadoop")
        self._bin = shutil.which(cand) or (
            cand if os.path.exists(cand) else None)

    def _unavailable(self, op):
        if self._bin is None:
            raise RuntimeError(
                f"HDFSClient.{op}: no hadoop CLI on this host. Point "
                "hadoop_home at a hadoop install, or use LocalFS / "
                "object storage for checkpoints.")
        raise NotImplementedError(
            f"HDFSClient.{op}: driving `hadoop fs` is not implemented in "
            "paddle_tpu_torch (checkpointing targets LocalFS / object "
            f"storage); found hadoop at {self._bin} but no shell "
            "bindings exist")

    # explicit stubs (not __getattr__ magic): hasattr()/getattr(...,
    # default) probes must behave normally, and a host WITH hadoop
    # gets honest guidance instead of a bare AttributeError
    def ls_dir(self, fs_path):
        self._unavailable("ls_dir")

    def is_file(self, fs_path):
        self._unavailable("is_file")

    def is_dir(self, fs_path):
        self._unavailable("is_dir")

    def is_exist(self, fs_path):
        self._unavailable("is_exist")

    def upload(self, local_path, fs_path):
        self._unavailable("upload")

    def upload_dir(self, local_dir, dest_dir):
        self._unavailable("upload_dir")

    def download(self, fs_path, local_path):
        self._unavailable("download")

    def mkdirs(self, fs_path):
        self._unavailable("mkdirs")

    def delete(self, fs_path):
        self._unavailable("delete")

    def rename(self, fs_src_path, fs_dst_path):
        self._unavailable("rename")

    def mv(self, src_path, dst_path, overwrite=False, test_exists=False):
        self._unavailable("mv")

    def touch(self, fs_path, exist_ok=True):
        self._unavailable("touch")

    def cat(self, fs_path=None):
        self._unavailable("cat")

    def list_dirs(self, fs_path):
        self._unavailable("list_dirs")

    def need_upload_download(self):
        return True


class DistributedInfer:
    """reference utils/__init__.py DistributedInfer — fluid static-graph
    PS inference orchestration."""

    def __init__(self, *a, **k):
        raise NotImplementedError(
            "DistributedInfer drives the fluid static-graph PS inference "
            "flow, which stands on the parameter-server runtime; it is not "
            "ported yet (ROADMAP.md, Queue 1 item 12c)")
