"""paddle_tpu_torch.distributed.fleet and its neighbours held to the JAX
package's.

  * `fleet.init` on real ranks (2 gloo ranks, spawned once,
    `tests/_torch_ranks.fleet_cases`): the mesh the degrees give (the JAX
    package's rules), and `HybridCommunicateGroup`'s answers: each
    rank's own coordinates and the ranks of its real groups (a named
    divergence: the JAX package's answer rank 0 and axis-name groups,
    ROADMAP.md Queue 3). Degrees asking for more ranks than the world
    has raise ValueError;
  * `DataParallel.apply_collective_grads`: the ranks' averaged gradients
    of their halves of a batch equal one process's of the whole, and
    JAX's, within 1e-6;
  * in one process: the pipeline schedule mapping and its refusal,
    `recompute` (the gradients of a plain call), `DistributedStrategy`,
    `CommunicateTopology`, `LocalFS`, `HDFSClient` without hadoop,
    `group_sharded_parallel`'s marks, and the parameter-server entry
    points, which raise NotImplementedError naming ROADMAP.md Queue 1
    item 12c."""
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import paddle_tpu as jp
import _torch_ranks as R
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu_torch.distributed import fleet, launch

DEADLINE_S = 120
MLP = (8, 16, 4)
STRATEGIES = {
    "mp2": {"mp_degree": 2},
    "dp2": {"dp_degree": 2},
    "default": {},
    "pp2": {"pp_degree": 2},
    "too_many": {"dp_degree": 2, "mp_degree": 2},
}


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch._core import state as tstate
    prev = tstate._device
    tstate.set_device("cpu")
    yield
    tstate._device = prev


def _mlp_sd():
    jp.seed(0)
    m = jp.nn.Sequential(jp.nn.Linear(MLP[0], MLP[1]), jp.nn.Tanh(),
                         jp.nn.Linear(MLP[1], MLP[2]))
    return m, {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _batch():
    rng = np.random.default_rng(2)
    return (rng.standard_normal((6, MLP[0])).astype(np.float32),
            rng.integers(0, MLP[2], (6,)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("store"))
    _, sd = _mlp_sd()
    data = {"strategies": STRATEGIES,
            "data_parallel": {"dims": MLP, "sd": sd, "batch": _batch()}}
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(launch.spawn, R.fleet_cases, 2, "gloo", "cpu",
                          DEADLINE_S, args=(data,), threads=1,
                          store_dir=store)
        return fut.result()[0]


def _jax_mesh_shape(hc, n=2):
    """The mesh JAX's fleet.init builds from `hc` over n of conftest's
    devices (the JAX package's global mesh and topology restored)."""
    import jax
    import paddle_tpu.distributed.env as jenv
    import paddle_tpu.distributed.fleet as mod
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs.update(hc)
    f = jfleet._Fleet()
    saved = (jax.device_count, mod.create_mesh, jenv._global_mesh,
             jenv._hybrid_topology)
    orig = mod.create_mesh
    jax.device_count = lambda: n
    mod.create_mesh = lambda axes: orig(axes, devices=jax.devices()[:n])
    try:
        f.init(strategy=strategy)
    finally:
        (jax.device_count, mod.create_mesh, jenv._global_mesh,
         jenv._hybrid_topology) = saved
    return dict(f.get_mesh().shape)


@pytest.mark.parametrize("name", ["mp2", "dp2", "default", "pp2"])
def test_fleet_init_mesh_matches_jax(ranks, name):
    every = ranks[name]
    assert [r["mesh"] for r in every] == [_jax_mesh_shape(
        STRATEGIES[name])] * 2
    assert [r["rank"] for r in every] == [0, 1]
    assert all(r["world"] == 2 for r in every)


@pytest.mark.parametrize("name", ["mp2", "dp2", "pp2"])
def test_hcg_reports_real_coordinates_and_groups(ranks, name):
    """Each rank's coordinate on the split axis is its own, its group
    holds both ranks; on an axis of one rank it is 0 in a group of
    itself."""
    axis = {"mp2": "mp", "dp2": "dp", "pp2": "pp"}[name]
    every = ranks[name]
    for r, view in enumerate(every):
        size, coord, group = view[axis]
        assert (size, coord, group) == (2, r, [0, 1])
        for other in {"dp", "mp", "pp"} - {axis}:
            assert view[other] == (1, 0, [r])


def test_fleet_init_refuses_more_ranks_than_the_world(ranks):
    cls, text = ranks["too_many"]
    assert cls == "ValueError" and "= 4 ranks and the world has 2" in text


def test_fleet_init_in_one_process_refuses_mp2():
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs["mp_degree"] = 2
    with pytest.raises(ValueError, match="the world has 1"):
        fleet._Fleet().init(strategy=strategy)


def test_data_parallel_averages_grads(ranks):
    """Two ranks' halves, averaged, are the whole batch's gradient (equal
    halves of equal weight), as one process and JAX compute it."""
    import paddle_tpu_torch as paddle
    jm, sd = _mlp_sd()
    x, y = _batch()
    jloss = jp.nn.functional.cross_entropy(jm(jp.to_tensor(x)),
                                           jp.to_tensor(y))
    jloss.backward()
    want = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    model = R._mlp(MLP, sd)
    R.mlp_loss(model, (paddle.to_tensor(x), paddle.to_tensor(y))).backward()
    one = {n: p.grad.numpy() for n, p in model.named_parameters()}
    for n in want:
        np.testing.assert_allclose(one[n], want[n], atol=1e-6, err_msg=n)
        np.testing.assert_allclose(ranks["data_parallel"][n], want[n],
                                   atol=1e-6, err_msg=n)


# ------------------------------------------------------ one process
SCHEDULES = [({"schedule_mode": "1F1B"}, {}),
             ({"schedule_mode": "F-then-B"}, {}),
             ({"schedule_mode": "interleave"}, {}),
             ({"schedule_mode": "1F1B"}, {"pp_configs":
                                          {"virtual_pp_degree": 2}}),
             ({}, {"virtual_pp_degree": 3}),
             ({"schedule_mode": "Eager1F1B"}, {})]


@pytest.mark.parametrize("pipe,hybrid", SCHEDULES)
def test_pipeline_schedule_mapping_matches_jax(pipe, hybrid):
    def run(mod):
        s = mod.DistributedStrategy()
        s.pipeline_configs = dict(pipe)
        s.hybrid_configs.update(hybrid)
        f = mod._Fleet()
        f._strategy = s
        try:
            return f.pipeline_schedule(), f.virtual_pp_degree()
        except ValueError as e:
            return "ValueError", str(e)
    assert run(fleet) == run(jfleet)


def test_distributed_strategy_fields_match_jax():
    assert vars(fleet.DistributedStrategy()) == \
        vars(jfleet.DistributedStrategy())


@pytest.mark.parametrize("rank", [0, 5, 11])
def test_communicate_topology_matches_jax(rank):
    names, dims = ("data", "pipe", "sharding", "sep", "model"), (2, 3, 1,
                                                                1, 2)
    a = fleet.CommunicateTopology(names, dims)
    b = jfleet.CommunicateTopology(names, dims)
    assert a.world_size() == b.world_size() == 12
    assert a.get_coord(rank) == b.get_coord(rank)
    assert a.get_rank(data=1, pipe=2, model=1) == \
        b.get_rank(data=1, pipe=2, model=1)
    assert a.get_dim("pipe") == b.get_dim("pipe")


def test_recompute_gives_the_plain_gradients_and_output():
    import paddle_tpu_torch as paddle
    jm, sd = _mlp_sd()
    x, _ = _batch()
    model = R._mlp(MLP, sd)
    plain = model(paddle.to_tensor(x))
    (plain ** 2).sum().backward()
    want = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    model.clear_gradients()
    xt = paddle.to_tensor(x, stop_gradient=False)
    out = fleet.recompute(model, xt)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-6)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n], rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    assert xt.grad is not None
    jout = jfleet.recompute(jm, jp.to_tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout.numpy()),
                               atol=1e-5)
    assert fleet.utils.recompute is fleet.recompute


def test_recompute_redraws_the_same_keys():
    """A dropout inside the recomputed function masks the same elements
    in the recompute as in the first run (the key stream's counter is
    set back for it)."""
    import paddle_tpu_torch as paddle
    paddle.seed(5)
    x = paddle.to_tensor(np.ones((64,), np.float32), stop_gradient=False)

    def fn(t):
        return paddle.nn.functional.dropout(t, 0.5, training=True) * t
    out = fleet.recompute(fn, x)
    out.sum().backward()
    kept = out.numpy() != 0
    # d(out)/dx = 2 * mask / (1 - p) where kept, 0 where dropped
    np.testing.assert_allclose(x.grad.numpy(), np.where(kept, 4.0, 0.0))


def test_local_fs_matches_jax(tmp_path):
    for mod, root in ((fleet, tmp_path / "port"), (jfleet, tmp_path / "jax")):
        fs = mod.utils.LocalFS()
        fs.mkdirs(str(root / "a" / "b"))
        fs.touch(str(root / "a" / "f.txt"))
        fs.mv(str(root / "a" / "f.txt"), str(root / "a" / "g.txt"))
        with pytest.raises(mod.utils.FSFileExistsError):
            fs.touch(str(root / "a" / "g.txt"), exist_ok=False)
        with pytest.raises(mod.utils.FSFileNotExistsError):
            fs.mv(str(root / "nope"), str(root / "x"))
    fp, fj = fleet.utils.LocalFS(), jfleet.utils.LocalFS()
    assert fp.ls_dir(str(tmp_path / "port" / "a")) == \
        fj.ls_dir(str(tmp_path / "jax" / "a")) == (["b"], ["g.txt"])
    assert fp.list_dirs(str(tmp_path / "port")) == ["a"]
    fp.delete(str(tmp_path / "port" / "a"))
    assert not fp.is_exist(str(tmp_path / "port" / "a"))
    assert fp.need_upload_download() is fj.need_upload_download() is False


def test_hdfs_client_without_hadoop_raises_runtime_error(tmp_path):
    c = fleet.utils.HDFSClient(hadoop_home=str(tmp_path), configs={"a": 1})
    assert c.configs == {"a": 1} and c.need_upload_download()
    with pytest.raises(RuntimeError, match="no hadoop CLI"):
        c.ls_dir("/x")


def test_group_sharded_parallel_marks_the_stage():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import (group_sharded_parallel,
                                              save_group_sharded_model)
    for level, stage in (("os", 1), ("os_g", 2), ("p_g_os", 3)):
        model = R._mlp(MLP, _mlp_sd()[1])
        opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
        m, o = group_sharded_parallel(model, opt, level)
        assert m._sharding_stage == o._sharding_stage == stage
    assert len(group_sharded_parallel(model, opt, "os", scaler=1)) == 3


def test_save_group_sharded_model(tmp_path):
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import save_group_sharded_model
    model = R._mlp(MLP, _mlp_sd()[1])
    opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
    out = str(tmp_path / "ckpt")
    save_group_sharded_model(model, out, opt)
    sd = torch.load(out + ".pdmodel.state")
    assert set(sd) == set(model.state_dict())
    assert os.path.exists(out + ".pdopt.state")


@pytest.mark.parametrize("call", ["init_server", "run_server",
                                  "init_worker", "server_role",
                                  "datagen", "distributed_infer"])
def test_parameter_server_entry_points_name_item_12c(call, monkeypatch):
    f = fleet._Fleet()
    run = {"init_server": f.init_server, "run_server": f.run_server,
           "init_worker": f.init_worker,
           "server_role": lambda: f.init(
               role_maker=fleet.UserDefinedRoleMaker(role="server")),
           "datagen": fleet.MultiSlotDataGenerator,
           "distributed_infer": fleet.utils.DistributedInfer}[call]
    with pytest.raises(NotImplementedError, match="item 12c"):
        run()


def test_role_makers_read_the_environment(monkeypatch):
    monkeypatch.setenv("PT_PS_ROLE", "PSERVER")
    assert fleet.PaddleCloudRoleMaker().is_server()
    assert not fleet.PaddleCloudRoleMaker(is_collective=True).is_server()
    monkeypatch.setenv("PT_PS_ROLE", "worker")
    assert fleet.PaddleCloudRoleMaker().is_worker()
    f = fleet._Fleet()
    assert f.is_worker() and not f.is_server()
    f.stop_worker()


def test_util_base_in_one_process():
    u = fleet.UtilBase()
    assert u.get_file_shard(["a", "b", "c"]) == ["a", "b", "c"]
    assert u.all_gather(3) == [3]
    assert u.all_reduce([1, 2]) == [1, 2]


@pytest.mark.parametrize("mode,hybrid,want", [
    ("1F1B", {}, ("1f1b", 2)),
    ("F-then-B", {}, ("gpipe", 2)),
    ("1F1B", {"pp_configs": {"virtual_pp_degree": 3}}, ("interleave", 3)),
    ("interleave", {}, "ValueError")])
def test_train_step_schedule_comes_from_the_fleet_strategy(
        monkeypatch, mode, hybrid, want):
    """make_train_step(schedule=None) takes the initialised strategy's
    schedule (and virtual degree), as the JAX step does."""
    from paddle_tpu_torch.models import llama_spmd as T
    s = fleet.DistributedStrategy()
    s.pipeline_configs = {"schedule_mode": mode}
    s.hybrid_configs.update(hybrid)
    monkeypatch.setattr(fleet.fleet, "_strategy", s)
    monkeypatch.setattr(fleet.fleet, "_is_initialized", True)
    if want == "ValueError":
        with pytest.raises(ValueError, match="virtual_pp_degree >= 2"):
            T._fleet_schedule(2)
    else:
        assert T._fleet_schedule(2) == want
    monkeypatch.setattr(fleet.fleet, "_is_initialized", False)
    assert T._fleet_schedule(2) == ("gpipe", 2)
