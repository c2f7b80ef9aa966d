"""The port's checkpoints (``paddle_tpu_torch/distributed/checkpoint``)
against the JAX package's:

* an async save writes the values of its call, though the caller
  updates its CPU tensors in place before the writer thread runs;
* a GradScaler's and a scheduler's state written by either package loads
  into fresh ones of both, which then go on alike;
* a checkpoint the JAX package wrote under a mesh of the 8 virtual CPU
  devices (a chunk per shard; bf16 as uint16 views) loads into the
  port's tensors, and one the port wrote loads into the JAX package's:
  arrays equal, bit for bit;
* ``CheckpointManager`` scenarios from ``tests/test_faults.py`` (commit
  and restore-latest, ``keep_last_n`` and its floor, crash before the
  commit and before the marker, torn and uncommitted directories,
  retries, async errors, the save interval, preemption), each driven
  through both packages with the same expectations;
* the eager loop's resume on the CPU (``tools/eager_train.resume``, the
  tiny Llama in bf16): losses and final state bit-identical to the
  unbroken run.
"""
import copy
import json
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed.engine import (ParallelConfig,
                                           shard_model_parameters)
from paddle_tpu.distributed.fleet.mp_layers import (ColumnParallelLinear,
                                                    RowParallelLinear)
from paddle_tpu.distributed.mesh import ProcessMesh
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.testing import faults as tfaults
from paddle_tpu_torch.tools import eager_train


# --------------------------------------------------------------------------
# the format across the packages
# --------------------------------------------------------------------------
def _jax_sharded_state():
    class MLP(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = ColumnParallelLinear(16, 32, gather_output=False)
            self.fc2 = RowParallelLinear(32, 16, input_is_parallel=True)

        def forward(self, x):
            return self.fc2(self.fc1(x))

    paddle.seed(0)
    m = MLP()
    mesh = ProcessMesh(np.arange(8).reshape(2, 4), dim_names=["dp", "mp"])
    shard_model_parameters(m, mesh, ParallelConfig(
        dp_axes=("dp",), sharding_stage=3, sharding_axis="dp"))
    return m


def test_port_loads_a_checkpoint_jax_wrote_under_a_mesh(tmp_path):
    m = _jax_sharded_state()
    sd = m.state_dict()
    assert len(sd["fc1.weight"]._data.addressable_shards) == 8
    bf = paddle.to_tensor(np.random.RandomState(1).randn(6, 4)
                          .astype(np.float32)).astype("bfloat16")
    state = {"model": sd, "extra": {"bf16": bf, "step": 7, "lr": 0.25,
                                    "mode": "min"}}
    p = str(tmp_path / "ck")
    jckpt.save_state_dict(state, p)
    meta = json.load(open(os.path.join(p, "metadata.json")))
    assert len(meta["tensors"]["model/fc1.weight"]["chunks"]) > 1
    assert meta["tensors"]["extra/bf16"]["dtype"] == "bfloat16"
    dst = {"model": {k: torch.zeros(tuple(v.shape)) for k, v in sd.items()},
           "extra": {"bf16": torch.zeros(6, 4, dtype=torch.bfloat16),
                     "step": 0, "lr": 0.0, "mode": "max"}}
    tckpt.load_state_dict(dst, p)
    for k, v in sd.items():
        np.testing.assert_array_equal(dst["model"][k].numpy(),
                                      np.asarray(v.numpy()), err_msg=k)
    want = np.asarray(bf._data).view(np.uint16)
    got = dst["extra"]["bf16"].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)
    assert dst["extra"]["step"] == 7 and dst["extra"]["lr"] == 0.25
    assert dst["extra"]["mode"] == "min"


def test_jax_loads_a_checkpoint_the_port_wrote(tmp_path):
    rng = np.random.RandomState(2)
    w = rng.randn(16, 32).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    src = {"model": {"w": torch.from_numpy(w),
                     "b": torch.from_numpy(b).to(torch.bfloat16)},
           "opt": {"step": 3, "LR_Scheduler": {"last_lr": 0.125,
                                               "mode": "min"}}}
    p = str(tmp_path / "ck")
    tckpt.save_state_dict(src, p)
    jdst = {"model": {"w": paddle.zeros([16, 32]),
                      "b": paddle.zeros([5]).astype("bfloat16")},
            "opt": {"step": 0, "LR_Scheduler": {"last_lr": 0.0,
                                                "mode": "max"}}}
    jckpt.load_state_dict(jdst, p)
    np.testing.assert_array_equal(np.asarray(jdst["model"]["w"].numpy()), w)
    np.testing.assert_array_equal(
        np.asarray(jdst["model"]["b"]._data).view(np.uint16),
        src["model"]["b"].view(torch.int16).numpy().view(np.uint16))
    assert jdst["opt"]["step"] == 3
    assert jdst["opt"]["LR_Scheduler"] == {"last_lr": 0.125, "mode": "min"}
    # and the port reads its own back, in place, on the tensors given
    w_dst = torch.zeros(16, 32)
    tdst = {"model": {"w": w_dst, "b": torch.zeros(5, dtype=torch.bfloat16)},
            "opt": {"step": 0, "LR_Scheduler": {"last_lr": 0.0,
                                                "mode": "max"}}}
    tckpt.load_state_dict(tdst, p)
    assert tdst["model"]["w"] is w_dst and torch.equal(w_dst,
                                                       src["model"]["w"])
    assert tdst["opt"] == src["opt"]


def test_jax_optimizer_state_dict_checkpoint_into_the_port(tmp_path):
    """A JAX TrainStep's model + AdamW state (moments, step) written by the
    JAX package, restored into a port Linear + AdamW: equal arrays."""
    paddle.seed(1)
    jm = jnn.Linear(8, 8)
    jopt = joptim.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    step = paddle.jit.TrainStep(jm, jnn.MSELoss(), jopt)
    step(paddle.randn([4, 8]), paddle.randn([4, 8]))
    p = str(tmp_path / "ck")
    jckpt.save_state_dict({"opt": jopt.state_dict()}, p)
    from paddle_tpu_torch.optimizer import AdamW

    tm = torch.nn.Linear(8, 8)
    topt = AdamW(learning_rate=1e-3, parameters=[tm.weight, tm.bias])
    topt.init_slots()
    st = {"opt": topt.state_dict()}
    tckpt.load_state_dict(st, p)
    topt.set_state_dict(st["opt"])
    assert topt._step_count == 1
    js = jopt.state_dict()
    for key in ("param_0.moment1", "param_1.moment2"):
        np.testing.assert_array_equal(st["opt"][key].numpy(),
                                      np.asarray(js[key].numpy()))


def _scaler_and_sched(amp_mod, lr_mod):
    sched = lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(0.1, T_max=8),
                                warmup_steps=2, start_lr=0.0, end_lr=0.1)
    return amp_mod.GradScaler(init_loss_scaling=2.0 ** 10,
                              incr_every_n_steps=2), sched


def _advance(scaler, sched, found_inf):
    for bad in found_inf:
        scaler._found_inf = bad
        scaler.update()
        sched.step()
    return {"scaler": scaler.state_dict(), "sched": sched.state_dict()}


def _f32(state):
    return {k: {kk: float(np.float32(v)) if type(v) is float else v
                for kk, v in d.items()} for k, d in state.items()}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_scaler_and_scheduler_state_round_trip(tmp_path, writer):
    """A GradScaler's and a warmed-up cosine scheduler's state, after
    good and bad updates, written by ``writer`` with ``save_state_dict``
    and loaded by both packages into a fresh pair. The port writes a
    Python float as float64 and reads it back exactly; the JAX package
    writes and reads floats as float32 (its arrays), so a float that
    passed through it is the float32 value in both packages. The
    restored scalers go on as the saved one does; the port's own round
    trip goes on exactly as the saved pair does, and the two packages'
    pairs restored from the JAX package's checkpoint go on alike."""
    mods = {"jax": (jamp, jlr), "torch": (tamp, tlr)}
    ckpt = {"jax": jckpt, "torch": tckpt}
    scaler, sched = _scaler_and_sched(*mods[writer])
    want = _advance(scaler, sched, [False, False, True, True, False])
    p = str(tmp_path / "ck")
    ckpt[writer].save_state_dict(copy.deepcopy(want), p)
    later = [True, False, False, False]
    cont = _advance(scaler, sched, later)
    went_on = {}
    for reader in ("jax", "torch"):
        s2, sc2 = _scaler_and_sched(*mods[reader])
        st = {"scaler": s2.state_dict(), "sched": sc2.state_dict()}
        assert st != want              # a fresh pair starts elsewhere
        ckpt[reader].load_state_dict(st, p)
        s2.load_state_dict(st["scaler"])
        sc2.set_state_dict(st["sched"])
        exact = writer == reader == "torch"
        assert {"scaler": s2.state_dict(), "sched": sc2.state_dict()} == (
            want if exact else _f32(want)), reader
        went_on[reader] = _advance(s2, sc2, later)
        assert went_on[reader]["scaler"] == cont["scaler"], reader
        if exact:
            assert went_on[reader] == cont
    if writer == "jax":
        assert went_on["torch"] == went_on["jax"]


def test_async_save_keeps_the_values_of_its_call(tmp_path, monkeypatch):
    """``CheckpointManager.save`` (async) of CPU tensors, a non-contiguous
    view, a numpy array and a list: the writer thread, held until the
    caller has changed each in place, writes the values of the call."""
    gate = threading.Event()
    write = tckpt.CheckpointManager._write_and_commit

    def held(self, *args):
        assert gate.wait(30)
        return write(self, *args)

    monkeypatch.setattr(tckpt.CheckpointManager, "_write_and_commit", held)
    w = torch.arange(8, dtype=torch.float32)
    b = torch.ones(3, dtype=torch.bfloat16)
    a = np.full(4, 2.0, np.float32)
    tags = ["a"]
    want = {"w": w.clone(), "t": w.view(2, 4).t().clone(), "b": b.clone(),
            "a": a.copy(), "tags": ["a"]}
    mgr = tckpt.CheckpointManager(str(tmp_path))
    assert mgr.save(1, {"w": w, "t": w.view(2, 4).t(), "b": b, "a": a,
                        "tags": tags})
    w.add_(100.0)
    b.add_(5.0)
    a += 7.0
    tags.append("b")
    gate.set()
    mgr.wait()
    dst = {"w": torch.zeros(8), "t": torch.zeros(4, 2),
           "b": torch.zeros(3, dtype=torch.bfloat16),
           "a": np.zeros(4, np.float32), "tags": []}
    assert mgr.restore(dst) == 1
    for k in ("w", "t", "b"):
        assert torch.equal(dst[k], want[k]), k
    np.testing.assert_array_equal(dst["a"], want["a"])
    assert dst["tags"] == want["tags"]


# --------------------------------------------------------------------------
# CheckpointManager scenarios, through both packages
# --------------------------------------------------------------------------
class _Pkg:
    def __init__(self, name):
        self.name = name
        self.ckpt = jckpt if name == "jax" else tckpt
        self.faults = jfaults if name == "jax" else tfaults
        self.Manager = self.ckpt.CheckpointManager

    def state(self, value=1.0):
        if self.name == "jax":
            return {"x": paddle.full([4], value)}
        return {"x": torch.full((4,), value)}

    @staticmethod
    def read(st):
        return np.asarray(st["x"].numpy())


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _Pkg(request.param)


def test_manager_commit_latest_restore(pkg, tmp_path):
    mgr = pkg.Manager(str(tmp_path), keep_last_n=5)
    assert mgr.latest_step() is None
    assert mgr.restore_or_initialize(pkg.state()) is None
    mgr.save(1, pkg.state(1.0), block=True)
    mgr.save(2, pkg.state(2.0), block=True)
    assert mgr.all_steps() == [1, 2]
    assert json.load(open(tmp_path / "step_2" / "COMMITTED"))["step"] == 2
    st = pkg.state(0.0)
    assert mgr.restore_or_initialize(st) == 2
    np.testing.assert_array_equal(pkg.read(st), np.full(4, 2.0, np.float32))


def test_manager_keep_last_n(pkg, tmp_path):
    mgr = pkg.Manager(str(tmp_path), keep_last_n=2)
    for s in (1, 2, 3):
        mgr.save(s, pkg.state(float(s)), block=True)
    assert mgr.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]
    floor = tmp_path / "floor"
    mgr0 = pkg.Manager(str(floor), keep_last_n=0)
    for s in (1, 2):
        mgr0.save(s, pkg.state(float(s)), block=True)
    assert mgr0.all_steps() == [2]


def test_crash_before_commit_keeps_the_old_checkpoint(pkg, tmp_path):
    p = str(tmp_path / "ck")
    pkg.ckpt.save_state_dict(pkg.state(1.0), p)
    files = sorted(os.listdir(p))
    with pkg.faults.injected("ckpt.before_commit:raise"):
        with pytest.raises(OSError):
            pkg.ckpt.save_state_dict(pkg.state(0.0), p)
    assert sorted(os.listdir(p)) == files
    with pkg.faults.injected("ckpt.data_written:raise"):
        with pytest.raises(OSError):
            pkg.ckpt.save_state_dict(pkg.state(0.0), p)
    st = pkg.state(5.0)
    pkg.ckpt.load_state_dict(st, p)
    np.testing.assert_array_equal(pkg.read(st), np.ones(4, np.float32))
    # a crash between the two commit renames: recovered on load
    os.rename(p, p + ".old")
    pkg.ckpt.load_state_dict(st, p)
    assert os.path.isdir(p) and not os.path.exists(p + ".old")


def test_manager_crash_before_marker_then_restore_latest(pkg, tmp_path):
    mgr = pkg.Manager(str(tmp_path), max_retries=0)
    mgr.save(1, pkg.state(1.0), block=True)
    mgr.save(1, pkg.state(1.5), block=True, force=True)
    with pkg.faults.injected("ckpt.before_marker:raise"):
        with pytest.raises(OSError):
            mgr.save(1, pkg.state(2.0), block=True, force=True)
    assert os.path.exists(tmp_path / "step_1.old" / "COMMITTED")
    mgr2 = pkg.Manager(str(tmp_path), max_retries=0)   # a restart
    st = pkg.state(0.0)
    assert mgr2.restore_or_initialize(st) == 1
    np.testing.assert_array_equal(pkg.read(st), np.full(4, 1.5, np.float32))
    mgr2.save(2, pkg.state(2.0), block=True)
    assert sorted(os.listdir(tmp_path)) == ["step_1", "step_2"]


def test_manager_skips_and_gcs_torn_directories(pkg, tmp_path):
    mgr = pkg.Manager(str(tmp_path), keep_last_n=3)
    mgr.save(5, pkg.state(5.0), block=True)
    torn = tmp_path / "step_7"
    torn.mkdir()
    (torn / "data_0.npz").write_bytes(b"half a npz")
    (tmp_path / "step_9.tmp").mkdir()
    st = pkg.state(0.0)
    assert mgr.restore_or_initialize(st) == 5
    np.testing.assert_array_equal(pkg.read(st), np.full(4, 5.0, np.float32))
    with pytest.raises(ValueError, match="COMMITTED"):
        mgr.restore(pkg.state(), step=7)
    mgr.save(8, pkg.state(8.0), block=True)
    assert sorted(os.listdir(tmp_path)) == ["step_5", "step_8"]


def test_manager_retries_and_async_errors(pkg, tmp_path):
    mgr = pkg.Manager(str(tmp_path), max_retries=3, backoff_base=0.01)
    with pkg.faults.injected("ckpt.data_written:raise*2") as inj:
        mgr.save(1, pkg.state(), block=True)
    assert inj.faults()[0].fired == 2
    with pkg.faults.injected("ckpt.data_written:raise"):
        with pytest.raises(OSError, match="after 4 attempts"):
            mgr.save(2, pkg.state(), block=True)
    assert mgr.latest_step() == 1
    amgr = pkg.Manager(str(tmp_path / "a"), max_retries=0)
    with pkg.faults.injected("ckpt.data_written:raise"):
        amgr.save(1, pkg.state())
        with pytest.raises(OSError):
            amgr.wait()
    assert amgr.save(2, pkg.state())      # async
    amgr.wait()
    assert amgr.latest_step() == 2


def test_manager_interval_and_preemption(pkg, tmp_path, monkeypatch):
    from paddle_tpu.distributed import watchdog as jwd
    from paddle_tpu_torch.distributed import watchdog as twd

    # a monitor of this test's own: the process-wide one stays untouched
    monkeypatch.setattr(jwd if pkg.name == "jax" else twd, "_preempt", None)
    mgr = pkg.Manager(str(tmp_path), save_interval_steps=3)
    assert not mgr.save(1, pkg.state())
    assert mgr.save(3, pkg.state(), block=True)
    mon = mgr.install_preemption_handler()
    try:
        assert not mgr.reached_preemption(4)
        mon.request()
        assert mgr.reached_preemption(4)
        assert mgr.save(4, pkg.state(4.0), block=True)  # off the schedule
    finally:
        mon.uninstall()
    assert mgr.all_steps() == [3, 4]


def test_manager_dedupe_links_identical_chunks(pkg, tmp_path):
    mgr = pkg.Manager(str(tmp_path), keep_last_n=2, dedupe_chunks=True)
    mgr.save(1, pkg.state(1.0), block=True)
    mgr.save(2, pkg.state(1.0), block=True)
    assert mgr.last_cas_hits == 1
    mgr.save(3, pkg.state(3.0), block=True)
    st = pkg.state(0.0)
    assert mgr.restore(st, step=2) == 2
    np.testing.assert_array_equal(pkg.read(st), np.ones(4, np.float32))
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step")) \
        == ["step_2", "step_3"]


# --------------------------------------------------------------------------
# the eager loop's resume
# --------------------------------------------------------------------------
def test_eager_resume_is_bit_identical_on_the_cpu(tmp_path):
    rep = eager_train.resume(LlamaConfig.tiny(dtype="bfloat16"), "cpu",
                             (2, 16), str(tmp_path / "ck"))
    assert rep["bit_identical_losses"] and rep["bit_identical_state"]
    assert rep["restored_step"] == 3 and rep["checkpoint_bytes"] > 0
    # the scheduler moved the lr, so the resumed steps depend on it
    assert len(set(rep["losses_unbroken"])) > 3
