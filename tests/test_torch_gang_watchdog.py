"""The gang half of the port's step watchdog (slice D4) against the JAX
package's ``paddle_tpu/distributed/watchdog.py``:

* fire, no fire and disabled, in both packages;
* the training hooks arm with the reference's tags: an eager collective
  ``all_reduce@ranks[0, 1]``, a step ``ParallelTrainStep#<n>`` (its
  first of new batch shapes with the COMPILE_ALLOWANCE factor), and
  nothing is left armed;
* the cross-rank abort: rank 1's watchdog fires on its collective's tag
  and exits 6, rank 0 reads the gang store's abort record and exits 7
  naming rank 1, both in under 20 s;
* an abort record left by an earlier incarnation of the gang is ignored,
  a changed one fires;
* a rank leaving through the abort leaves a poll interval and two
  monitor periods after the record was posted, never later (the port's
  linger, by design);
* a hung step and a gang relaunch through the port's launcher.
The workers are ``paddle_tpu_torch/testing/launch_workers.py``."""
import json
import os
import subprocess
import sys
import time
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "paddle_tpu_torch", "testing",
                      "launch_workers.py")


def _watchdogs():
    from paddle_tpu.distributed import watchdog as jwd
    from paddle_tpu_torch.distributed import watchdog as twd

    return {"jax": jwd, "port": twd}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_fires_on_a_hung_step(pkg):
    wdm = _watchdogs()[pkg]
    fired = []
    wd = wdm.StepWatchdog(timeout=0.5, on_timeout=fired.append)
    wd.arm("hung-step")
    deadline = time.time() + 5
    while not fired and time.time() < deadline:
        time.sleep(0.05)
    assert fired and fired[0][0][0] == "hung-step"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_fast_step_does_not_fire(pkg):
    fired = []
    wd = _watchdogs()[pkg].StepWatchdog(timeout=0.6,
                                        on_timeout=fired.append)
    eid = wd.arm("fast-step")
    if pkg == "jax":
        import jax
        import jax.numpy as jnp

        wd.attach(eid, jax.jit(lambda x: x + 1)(jnp.zeros(())))
    else:
        wd.attach(eid, None)   # a CPU step is done when it returns
    time.sleep(1.2)
    assert not fired and not wd.fired


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_disabled_is_a_noop(pkg):
    wd = _watchdogs()[pkg].StepWatchdog(timeout=0)
    wd.track(None, "x")
    assert not wd.fired and wd.arm("y") == 0 and not wd._entries


def test_the_hooks_arm_with_the_reference_tags():
    from paddle_tpu_torch.distributed.watchdog import COMPILE_ALLOWANCE
    from paddle_tpu_torch.testing import gang_ranks, gloo_ranks

    for tags, left in gloo_ranks.run(gang_ranks.watched_tags, 2,
                                     timeout_s=120):
        steps = [t for t in tags if t[0].startswith("ParallelTrainStep")]
        assert steps == [("ParallelTrainStep#1", COMPILE_ALLOWANCE),
                         ("ParallelTrainStep#2", 1.0)]
        assert ("all_reduce@ranks[0, 1]", 1.0) in tags
        assert left == 0


def test_cross_rank_abort(tmp_path):
    env = dict(os.environ)
    env.update({
        "PADDLE_STEP_TIMEOUT": "2",
        "PADDLE_STORE_DIR": str(tmp_path / "store"),
        "PADDLE_ABORT_POLL": "0.5",
        "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
    })
    procs = []
    for r in (0, 1):
        e = dict(env, PADDLE_TRAINER_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, "gang_abort"], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t0 = time.time()
    outs, codes = [], []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
        codes.append(p.returncode)
    elapsed = time.time() - t0
    assert codes[1] == 6, outs[1]
    assert "rank 1" in outs[1] and "all_reduce@ranks[0, 1]" in outs[1]
    assert codes[0] == 7, outs[0]
    assert "rank 1 aborted" in outs[0] and "all_reduce" in outs[0]
    assert elapsed < 20, elapsed


def test_a_stale_abort_record_is_ignored(tmp_path, monkeypatch):
    from paddle_tpu_torch.distributed import watchdog as wdm
    from paddle_tpu_torch.distributed.store import FileStore

    store = FileStore(str(tmp_path))
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    hits = []
    wd = wdm.StepWatchdog(timeout=1.0, on_remote_abort=hits.append)
    wd._store = store
    # a record of an earlier incarnation is there at the first look
    store.set(wdm.ABORT_KEY, json.dumps({"rank": 1, "tags": "x",
                                         "gen": "old"}))
    wd._check_remote_abort()   # the first poll records the baseline
    wd._check_remote_abort()   # unchanged: no fire
    assert not hits and not wd.fired
    store.set(wdm.ABORT_KEY, json.dumps(
        {"rank": 1, "tags": "all_reduce@ranks[0, 1]", "gen": "new"}))
    wd._check_remote_abort()
    assert hits and hits[0]["rank"] == 1 and wd.fired


@pytest.mark.parametrize("age,left", [(None, 1.0), (0.0, 1.0),
                                       (0.5, 0.5), (10.0, 0.0),
                                       (-100.0, 1.0)])
def test_a_rank_leaves_a_linger_after_the_post(monkeypatch, age, left):
    """``_leave(code, posted)`` sleeps until ``posted`` plus the linger (a
    poll and two monitor periods; the whole linger from now when this
    rank posts, ``posted`` None), at most the linger, then exits with
    ``code``: a peer that read the record late leaves at once."""
    import threading

    from paddle_tpu_torch.distributed import watchdog as wdm

    class Left(Exception):
        pass

    def exit_(code):
        raise Left(code)

    main, slept = threading.get_ident(), []
    sleep = time.sleep
    monkeypatch.setattr(wdm.atexit, "register", lambda *a: None)
    monkeypatch.setattr(wdm.os, "_exit", exit_)
    monkeypatch.setattr(wdm.time, "sleep", lambda s: slept.append(s)
                        if threading.get_ident() == main else sleep(s))
    wd = wdm.StepWatchdog(timeout=2.0)
    linger = wdm.ABORT_POLL_S + 2 * wd._period()
    posted = None if age is None else time.time() - age * linger
    with pytest.raises(Left) as got:
        wd._leave(7, posted)
    assert got.value.args == (7,)
    assert slept and abs(slept[0] - left * linger) < 0.05 * linger, (
        slept, left * linger)


def test_a_hang_and_a_gang_relaunch_through_the_launcher(tmp_path):
    from paddle_tpu_torch.distributed.launch import launch

    logs = tmp_path / "logs"
    args = types.SimpleNamespace(
        nproc_per_node=1, nnodes="1", node_rank=0, master=None,
        log_dir=str(logs), max_restart=1, restart_interval=0.2,
        training_script=WORKER, training_script_args=["hang_train"],
        stop_timeout=30.0)
    extra = {"PADDLE_STEP_TIMEOUT": "2",
             "PADDLE_STEP_COMPILE_ALLOWANCE": "3",
             "PADDLE_ABORT_POLL": "0.5",
             "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              "")}
    t0 = time.time()
    assert launch(args, extra_env=extra) == 0
    log0 = (logs / "workerlog.0").read_text()
    assert "[watchdog] rank 0: step(s) [TrainStep#0]" in log0
    assert "HANG_WORKER_DONE attempt=1" in log0
    assert "HANG_WORKER_DONE attempt=0" not in log0
    assert time.time() - t0 < 60
