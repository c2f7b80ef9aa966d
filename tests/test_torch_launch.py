"""The port's launcher, ``python -m paddle_tpu_torch.distributed.launch``
(slice D4), against the JAX package's ``paddle_tpu.distributed.launch``.

The workers are ``paddle_tpu_torch/testing/launch_workers.py``. Held
here, as the reference's ``tests/test_launch.py`` holds its launcher:

* the env protocol: one worker dumps what each launcher gave it; every
  key and value is the same but the ports, and the port adds
  ``PADDLE_LOCAL_SIZE`` (``--nproc_per_node``, by design: it places rank
  r on ``cuda:<local rank>``);
* a dead trainer ends the job with its code (7);
* ``--max_restart`` exhausted: the last code (9) and one "restarting";
* a restart relaunches the gang with ``PADDLE_RESTART_COUNT`` bumped;
* SIGTERM to the launcher: 0 when the workers exit within
  ``--stop_timeout``, 143 past it;
* a launched world's gloo ``all_reduce`` of rank + 1 over two ranks
  gives 3.0.
"""
import glob
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "paddle_tpu_torch", "testing",
                      "launch_workers.py")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    return env


def _launch(pkg, *args, timeout=120, **kw):
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.distributed.launch", *args],
        env=_env(), cwd=REPO, capture_output=True, text=True,
        timeout=timeout, **kw)


def _ports(v: str) -> str:
    return re.sub(r":\d+", ":<port>", v)


def test_env_protocol_matches_the_reference(tmp_path):
    nproc = 2
    got = {}
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        out = tmp_path / pkg
        out.mkdir()
        r = _launch(pkg, "--nproc_per_node", str(nproc), WORKER, "env",
                    str(out))
        assert r.returncode == 0, (pkg, r.stdout, r.stderr)
        got[pkg] = {}
        for f in sorted(out.glob("env.*.json")):
            env = json.loads(f.read_text())
            got[pkg][f.name] = {k: "<port>" if k == "MASTER_PORT"
                                else _ports(v) for k, v in env.items()}
    ref, port = got["paddle_tpu"], got["paddle_tpu_torch"]
    assert sorted(ref) == sorted(port) == [f"env.{r}.json"
                                            for r in range(nproc)]
    for name in ref:
        extra = {k: v for k, v in port[name].items() if k not in ref[name]}
        assert extra == {"PADDLE_LOCAL_SIZE": str(nproc)}, extra
        assert {k: port[name][k] for k in ref[name]} == ref[name]
        for key in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
                    "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT",
                    "PADDLE_LOCAL_RANK", "PADDLE_MASTER", "MASTER_ADDR",
                    "MASTER_PORT", "PADDLE_RESTART_COUNT"):
            assert key in port[name], key


def test_a_dead_trainer_ends_the_job_with_its_code():
    t0 = time.time()
    r = _launch("paddle_tpu_torch", "--nproc_per_node", "2", WORKER, "fail")
    assert r.returncode == 7, (r.returncode, r.stderr)
    assert time.time() - t0 < 60   # rank 0 was ended, not waited for
    assert "[launch] rank 1 exited rc=7" in r.stderr


def test_max_restart_exhausted():
    r = _launch("paddle_tpu_torch", "--nproc_per_node", "1",
                "--max_restart", "1", "--restart_interval", "0.1", WORKER,
                "exit9")
    assert r.returncode == 9
    assert r.stderr.count("restarting") == 1, r.stderr


def test_a_restart_bumps_the_restart_count(tmp_path):
    logs = tmp_path / "logs"
    r = _launch("paddle_tpu_torch", "--nproc_per_node", "2",
                "--max_restart", "2", "--restart_interval", "0.1",
                "--log_dir", str(logs), WORKER, "restart",
                str(tmp_path / "attempted"))
    text = "".join(f.read_text() for f in sorted(logs.glob("workerlog.*")))
    assert r.returncode == 0, (r.returncode, text, r.stderr)
    assert "RESTART_OK 0 count=1" in text and "RESTART_OK 1 count=1" in text
    assert r.stderr.count("restarting") == 1


@pytest.mark.parametrize("graceful,rc", [("1", 0), ("0", 143)])
def test_sigterm_is_forwarded_with_a_grace(tmp_path, graceful, rc):
    ready = tmp_path / "ready"
    ready.mkdir()
    p = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--stop_timeout", "1", WORKER, "sigterm",
         str(ready), graceful],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 60
        while len(glob.glob(str(ready / "ready.*"))) < 2:
            assert time.time() < deadline and p.poll() is None
            time.sleep(0.05)
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == rc, (p.returncode, out, err)
    assert "SIGTERM: forwarding" in err
    if rc == 0:
        assert out.count("SIGTERM_SAVED") == 2


def test_a_launched_world_all_reduces(tmp_path):
    logs = tmp_path / "logs"
    r = _launch("paddle_tpu_torch", "--nproc_per_node", "2", "--log_dir",
                str(logs), WORKER, "allreduce")
    text = "".join(f.read_text() for f in sorted(logs.glob("workerlog.*")))
    assert r.returncode == 0, (text, r.stderr)
    for rank in (0, 1):
        assert f"ALLREDUCE rank={rank} world=2 sum=3.0" in text, text
