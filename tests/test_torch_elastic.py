"""The port's elastic launcher (``paddle_tpu_torch.distributed.launch.
elastic``, slice D4) against the JAX package's: ``parse_nnodes`` and
``decide_world`` over a table of (current, lost, joins, min, max) equal
the reference's exactly; heartbeat membership; and a launched gang that
loses a member and re-forms at world 3, then takes a join request and
re-forms at world 4, with the registry in a directory (``FileStore``)
and in the launcher's own ``TCPStore``. The workers
(``paddle_tpu_torch/testing/launch_workers.py elastic``) prove each
world with a gloo all-reduce and carry a checkpointed step across the
attempts, as the reference's ``tests/mp_scripts/elastic_worker.py``."""
import glob
import itertools
import json
import os
import threading
import time
import types

import numpy as np
import pytest

from paddle_tpu.distributed.launch import elastic as jel
from paddle_tpu_torch.distributed.launch import elastic as tel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "paddle_tpu_torch", "testing",
                      "launch_workers.py")


def test_parse_nnodes_matches_the_reference():
    for spec in ("4", "2:4", 3, "1:1", "1:8"):
        assert tel.parse_nnodes(spec) == jel.parse_nnodes(spec)
    for bad in ("4:2", "0", "0:2"):
        for mod in (tel, jel):
            with pytest.raises(ValueError):
                mod.parse_nnodes(bad)


def test_decide_world_table_matches_the_reference(tmp_path):
    got = {}
    for name, mod in (("jax", jel), ("port", tel)):
        rows = []
        for cur, lost, joins, lo, hi in itertools.product(
                range(1, 6), range(0, 4), range(0, 3), (1, 2, 3), (3, 4, 6)):
            if lo > hi:
                continue
            mgr = mod.ElasticManager(str(tmp_path / name), lo, hi)
            rows.append(mgr.decide_world(
                cur, lost=lost, joins={f"n{i}" for i in range(joins)}))
        got[name] = rows
    assert got["port"] == got["jax"]
    assert None in got["port"] and len(set(got["port"])) > 3


def test_heartbeat_membership(tmp_path):
    d = str(tmp_path)
    mgr = tel.ElasticManager(d, 2, 4, hb_timeout=1.0)
    hb1 = tel.Heartbeat(d, "w0", interval=0.2).start()
    hb2 = tel.Heartbeat(d, "w1", interval=0.2).start()
    time.sleep(0.3)
    assert mgr.live_nodes() == {"w0", "w1"}
    hb2.stop()
    time.sleep(1.2)
    assert mgr.live_nodes() == {"w0"}
    assert mgr.decide_world(4, lost=1) == 3
    assert mgr.decide_world(2, lost=1) is None  # below min
    tel.request_join(d, "n9")
    assert mgr.decide_world(3) == 4
    assert mgr.decide_world(4) == 4  # capped at max
    mgr.clear_join_requests()
    assert mgr.decide_world(3) == 3
    hb1.stop()


@pytest.mark.parametrize("registry", ["file", "tcp"])
def test_scale_in_then_out(tmp_path, registry):
    from paddle_tpu_torch.distributed.launch import launch
    from paddle_tpu_torch.distributed.store import TCPStore

    out_dir = str(tmp_path / "out")
    os.makedirs(out_dir)
    if registry == "tcp":
        elastic_dir, stop = TCPStore.serve("127.0.0.1", 0)
    else:
        elastic_dir, stop = str(tmp_path / "elastic"), None
    args = types.SimpleNamespace(
        nproc_per_node=1, nnodes="2:4", node_rank=0, master=None,
        log_dir=str(tmp_path / "logs"), max_restart=5,
        restart_interval=0.2, training_script=WORKER,
        training_script_args=["elastic", out_dir],
        elastic_dir=elastic_dir, hb_timeout=15.0, stop_timeout=30.0)
    env = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            "")}

    def joiner():
        deadline = time.time() + 120
        while time.time() < deadline:
            if glob.glob(os.path.join(out_dir, "attempt1.rank0.json")):
                time.sleep(0.5)
                tel.request_join(elastic_dir, "newnode")
                return
            time.sleep(0.2)

    t = threading.Thread(target=joiner, daemon=True)
    t.start()
    try:
        rc = launch(args, extra_env=env)
    finally:
        t.join(timeout=5)
        if stop is not None:
            stop()
    assert rc == 0

    def worlds(attempt):
        return [json.load(open(f))["world"] for f in sorted(glob.glob(
            os.path.join(out_dir, f"attempt{attempt}.rank*.json")))]

    assert worlds(0) == [4, 4, 4, 4]
    assert worlds(1) == [3, 3, 3]
    assert worlds(2) == [4, 4, 4, 4]
    steps = [int(np.load(f)["step"]) for f in
             glob.glob(os.path.join(out_dir, "ckpt.rank*.npz"))]
    assert steps and all(s >= 6 for s in steps)
