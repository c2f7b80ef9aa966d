"""Worker scripts of the launcher, elastic and gang-watchdog tests, run
by a launcher (``python -m paddle_tpu_torch.distributed.launch ...
launch_workers.py <mode> [args]``) or started directly. The repository
root must be on ``PYTHONPATH``. Modes:

* ``env OUT``: dump the launcher's env protocol to ``OUT/env.<rank>.json``
  (imports nothing of either package, so both launchers run it);
* ``fail``: rank 1 exits 7, the others sleep (the launcher must end them);
* ``exit9``: exit 9;
* ``restart MARKER``: rank 0 exits 3 on the gang's first attempt, then
  checks ``PADDLE_RESTART_COUNT`` is 1;
* ``sigterm READY_DIR GRACEFUL``: touch ``READY_DIR/ready.<rank>`` and
  sleep; on SIGTERM exit 0 at once when ``GRACEFUL`` is 1, else ignore
  it;
* ``allreduce``: join the world and all-reduce ``rank + 1``;
* ``elastic OUT``: the elastic scale-in/out scenario (attempt 0 at world
  4 loses its last rank, attempt 1 at world 3 waits for a join request,
  attempt 2 at world 4 finishes), each attempt proving its world with a
  gloo all-reduce and carrying a checkpointed step;
* ``gang_abort``: rank 1 arms ``all_reduce@ranks[0, 1]`` on the default
  watchdog and never finishes it (it must exit 6); rank 0 only watches
  for a peer's abort (it must exit 7);
* ``hang_train``: a ``TrainStep`` whose forward hangs on the gang's
  first attempt (the watchdog must exit 6 and the launcher relaunch);
  the second attempt finishes.
"""
import json
import os
import signal
import sys
import time


def _rank() -> int:
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def env_dump(out: str):
    keys = [k for k in os.environ if k.startswith(("PADDLE_", "MASTER_"))]
    with open(os.path.join(out, f"env.{_rank()}.json"), "w") as f:
        json.dump({k: os.environ[k] for k in keys}, f)


def fail():
    if _rank() == 1:
        sys.exit(7)
    time.sleep(120)


def restart(marker: str):
    if _rank() == 0:
        if not os.path.exists(marker):
            open(marker, "w").write("x")
            sys.exit(3)
        assert os.environ["PADDLE_RESTART_COUNT"] == "1"
    print(f"RESTART_OK {_rank()} count="
          f"{os.environ['PADDLE_RESTART_COUNT']}", flush=True)


def sigterm(ready_dir: str, graceful: str):
    def handler(signum, frame):
        if graceful == "1":
            print(f"SIGTERM_SAVED {_rank()}", flush=True)
            sys.exit(0)

    signal.signal(signal.SIGTERM, handler)
    open(os.path.join(ready_dir, f"ready.{_rank()}"), "w").close()
    for _ in range(600):
        time.sleep(0.1)


def allreduce():
    import torch

    import paddle_tpu_torch.distributed as dist

    dist.init_parallel_env()
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    print(f"ALLREDUCE rank={dist.get_rank()} world={dist.get_world_size()} "
          f"sum={float(t[0])}", flush=True)
    dist.destroy_process_group()


def elastic(out_dir: str):
    import numpy as np
    import torch

    import paddle_tpu_torch.distributed as dist

    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    attempt = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
    t = torch.ones(2)
    dist.all_reduce(t)
    assert float(t[0]) == world, (t, world)
    with open(os.path.join(out_dir, f"attempt{attempt}.rank{rank}.json"),
              "w") as f:
        json.dump({"world": world, "attempt": attempt}, f)
    ckpt = os.path.join(out_dir, f"ckpt.rank{rank}.npz")
    if attempt == 0:
        np.savez(ckpt, step=3)
        if rank == world - 1:
            time.sleep(0.5)
            os._exit(1)
        time.sleep(30)   # the launcher ends the survivors
        os._exit(1)
    assert os.path.exists(ckpt), "checkpoint from previous attempt missing"
    step = int(np.load(ckpt)["step"])
    if attempt == 1:
        np.savez(ckpt, step=step + 3)
        time.sleep(30)   # the join request re-forms the gang meanwhile
        os._exit(1)
    np.savez(ckpt, step=step + 3)
    print(f"rank{rank} ELASTIC_OK world={world} step={step + 3}", flush=True)
    dist.destroy_process_group()


def gang_abort():
    from paddle_tpu_torch.distributed.watchdog import default_watchdog

    rank = _rank()
    wd = default_watchdog()
    print(f"rank {rank} up, watchdog enabled={wd.enabled}", flush=True)
    if rank == 1:
        wd.arm("all_reduce@ranks[0, 1]")
        time.sleep(60)
        print("RANK1_SHOULD_NOT_REACH_HERE", flush=True)
    else:
        wd.start_abort_watch()
        for _ in range(600):
            time.sleep(0.1)
        print("RANK0_SHOULD_NOT_REACH_HERE", flush=True)


def hang_train():
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import SGD

    paddle.set_device("cpu")
    attempt = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))

    class MaybeHang(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(4, 1)

        def forward(self, x):
            if attempt == 0:
                time.sleep(30)   # a hang inside the dispatch
            return self.fc(x)

    torch.manual_seed(0)
    m = MaybeHang()
    step = TrainStep(m, torch.nn.MSELoss(),
                     SGD(learning_rate=0.1, parameters=m.parameters()))
    loss = step(torch.randn(8, 4), torch.randn(8, 1))
    print("loss:", float(loss), flush=True)
    print(f"HANG_WORKER_DONE attempt={attempt}", flush=True)


MODES = {"env": env_dump, "fail": fail, "exit9": lambda: sys.exit(9),
         "restart": restart, "sigterm": sigterm, "allreduce": allreduce,
         "elastic": elastic, "gang_abort": gang_abort,
         "hang_train": hang_train}

if __name__ == "__main__":
    MODES[sys.argv[1]](*sys.argv[2:])
