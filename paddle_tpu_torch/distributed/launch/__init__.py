"""Distributed launcher (port of ``paddle_tpu/distributed/launch/``).

Reference: python/paddle/distributed/launch/ — __main__.py arg surface,
CollectiveController (controllers/collective.py:76-132 sets
PADDLE_TRAINER_ID/PADDLE_TRAINER_ENDPOINTS per process), master
rendezvous (controllers/master.py), and the process watcher
(controllers/watcher.py).

``python -m paddle_tpu_torch.distributed.launch --nproc_per_node N
script.py`` spawns N rank processes on this node with the reference's
env protocol; each joins the world in
:func:`~paddle_tpu_torch.distributed.env.init_parallel_env`
(``torch.distributed`` over ``PADDLE_MASTER``). The launcher also sets
``PADDLE_LOCAL_SIZE`` to ``--nproc_per_node``, which places rank r of a
node on ``cuda:<local rank>`` (the JAX package runs one process per
host and needs no such count). A rank inherits the launcher's
environment, ``PADDLE_TORCH_RANKS_SHARE_DEVICE`` included (every rank on
the first card over gloo, :mod:`paddle_tpu_torch.testing.tp_hooks`);
without it, N ranks need N visible cards.

One dead trainer terminates the gang; ``--max_restart`` relaunches it
whole (``PADDLE_RESTART_COUNT`` bumps); 130 and 143 (an interrupt, a
preemption) are never restarted. SIGTERM to the launcher is forwarded to
every rank, which gets ``--stop_timeout`` seconds for its final
checkpoint; past that the ranks are killed and the job reports 143.
``--nnodes min:max`` runs the elastic loop (:mod:`.elastic`): a lost
member re-forms the gang at world - 1, a join request at world + 1
(rc 75 means re-form).
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time

__all__ = ["launch", "main"]


def _free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def launch(args, extra_env=None):
    """Spawn worker processes and babysit them.

    Returns the first nonzero exit code (0 if all succeed). On any child
    failure the remaining children are terminated (reference watcher
    semantics: one dead trainer kills the job), and — when
    ``--max_restart`` allows — the whole gang is relaunched, the
    recovery loop of reference fleet/elastic/manager.py:124 (collective
    jobs restart as a unit because the rendezvous must re-form).

    Elastic mode (``--nnodes min:max``): membership is watched through
    the elastic store; a lost worker shrinks the next gang (down to min),
    a join request grows it (up to max). See launch/elastic.py."""
    from paddle_tpu_torch.distributed.launch.elastic import parse_nnodes

    lo, hi = parse_nnodes(getattr(args, "nnodes", 1))
    if lo != hi:
        return _launch_elastic(args, extra_env, lo, hi)
    restarts = getattr(args, "max_restart", 0)
    attempt = 0
    while True:
        rc, _ = _launch_once(args, extra_env, attempt)
        attempt += 1
        if rc == 0 or restarts <= 0:
            return rc
        if rc in (130, 143):
            # interrupt / SIGTERM preemption: a deliberate stop, never
            # restarted (the preempted host is going away)
            return rc
        restarts -= 1
        print(f"[launch] job failed (rc={rc}); restarting "
              f"({restarts} restarts left)", file=sys.stderr, flush=True)
        time.sleep(getattr(args, "restart_interval", 1.0))


def _launch_elastic(args, extra_env, min_n, max_n):
    """Elastic gang loop. On this controller, the elastic unit is a
    worker process (the reference's unit is a node running its own
    launcher; a single-host controller collapses node == worker). The
    world starts at max and re-forms on membership change:

      worker death  -> relaunch at world-1 (>= min, else job fails)
      join request  -> gang-restart at world+1 (<= max)

    Training scripts see PADDLE_RESTART_COUNT bump on every re-form and
    are expected to resume from their checkpoints."""
    import tempfile

    from paddle_tpu_torch.distributed.launch.elastic import ElasticManager

    store_dir = getattr(args, "elastic_dir", None)
    if store_dir is None:
        # default registry: a TCPStore served by THIS launcher process
        # (the management-job store — reference etcd, manager.py:124);
        # no shared filesystem needed and it survives gang restarts.
        # FileStore remains the fallback when --elastic_dir is given or
        # the server cannot bind.
        try:
            from paddle_tpu_torch.distributed.store import TCPStore

            store_dir, _stop = TCPStore.serve("127.0.0.1", 0)
        except Exception:
            store_dir = os.path.join(tempfile.gettempdir(),
                                     f"paddle_elastic_{os.getpid()}")
    mgr = ElasticManager(store_dir, min_n, max_n,
                         hb_timeout=getattr(args, "hb_timeout", 3.0))
    mgr.clear_join_requests()  # stale requests from a previous run
    world = max_n
    restarts = getattr(args, "max_restart", 10)
    attempt = 0
    while True:
        rc, lost = _launch_once(args, extra_env, attempt, world=world,
                                elastic=mgr)
        if rc == 0:
            return 0
        if rc in (130, 143):  # interrupt/preemption: a stop, not a
            return rc         # member failure — do not re-form
        attempt += 1
        joins = mgr.join_requests()
        new_world = mgr.decide_world(world, lost=lost, joins=joins)
        mgr.consume_join_requests(joins)
        if new_world is None:
            print(f"[launch] membership fell below min={min_n}; giving up",
                  file=sys.stderr, flush=True)
            return rc
        if restarts <= 0:
            return rc
        restarts -= 1
        print(f"[launch] re-forming gang at world={new_world} "
              f"(was {world}, rc={rc})", file=sys.stderr, flush=True)
        world = new_world
        time.sleep(getattr(args, "restart_interval", 0.5))


def _launch_once(args, extra_env=None, attempt=0, world=None,
                 elastic=None):
    """One gang run. Returns (rc, n_lost_workers)."""
    from paddle_tpu_torch.distributed.launch.elastic import parse_nnodes

    node_rank = args.node_rank
    if world is not None:
        # elastic mode: world workers on this controller, one per "node"
        n = world
        nnodes = 1
    else:
        n = args.nproc_per_node
        nnodes = parse_nnodes(args.nnodes)[0]
        world = n * nnodes
    if args.master:
        master = args.master
    elif nnodes > 1:
        raise SystemExit(
            "--master host:port is required when --nnodes > 1 (all nodes "
            "must rendezvous at one coordinator)")
    else:
        master = f"127.0.0.1:{_free_port()}"
    host = master.split(":")[0]
    base_port = int(master.split(":")[1])
    # worker data endpoints use THIS node's host and skip the coordinator
    # port (base_port); cross-node peer endpoints are exchanged through
    # the torch.distributed rendezvous at init, so the static endpoint
    # list is only advertised for single-node jobs (reference master.py
    # fetches it from the rendezvous KV in the multi-node case).
    local_host = "127.0.0.1" if nnodes == 1 else socket.gethostname()
    endpoints = ",".join(
        f"{host}:{base_port + 1 + i}" for i in range(world)) \
        if nnodes == 1 else ""

    procs = []
    log_dir = args.log_dir
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    script_args = list(getattr(args, "training_script_args", []) or [])
    cmd = [sys.executable, "-u", args.training_script] + script_args
    for local_rank in range(n):
        rank = node_rank * n + local_rank
        env = dict(os.environ)
        env.update(extra_env or {})
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_TRAINER_ENDPOINTS": endpoints,
            "PADDLE_CURRENT_ENDPOINT":
                f"{local_host}:{base_port + 1 + rank}",
            "PADDLE_LOCAL_RANK": str(local_rank),
            # the ranks of this node: rank r takes cuda:<local rank>
            "PADDLE_LOCAL_SIZE": str(n),
            "PADDLE_MASTER": master,
            "MASTER_ADDR": host,
            "MASTER_PORT": str(base_port),
            "PADDLE_RESTART_COUNT": str(attempt),
        })
        if elastic is not None:
            env["PADDLE_ELASTIC_DIR"] = elastic.dir
        out = None
        if log_dir:
            out = open(os.path.join(log_dir, f"workerlog.{rank}"),
                       "a" if attempt else "w")
        p = subprocess.Popen(cmd, env=env, stdout=out,
                             stderr=subprocess.STDOUT if out else None)
        p._log = out
        p._rank = rank
        procs.append(p)

    hbs = []
    if elastic is not None:
        from paddle_tpu_torch.distributed.launch.elastic import Heartbeat

        # controller publishes one heartbeat per live worker slot so
        # external observers (and tests) can watch membership
        hbs = [Heartbeat(elastic.dir, f"w{node_rank * n + i}",
                         payload={"pid": procs[i].pid}).start()
               for i in range(n)]

    # preemption wiring: SIGTERM to the launcher (the cloud's preemption
    # notice lands on the controller) is forwarded to every worker so
    # each takes its final synchronous checkpoint; workers that exit
    # clean within the grace window make the whole job exit 0, otherwise
    # they are killed and the job reports 143 (preempted) — which the
    # restart loops above deliberately do NOT relaunch.
    term = {"at": None}

    def _forward_term(signum, frame):
        if term["at"] is None:
            term["at"] = time.time()
            print("[launch] SIGTERM: forwarding to workers for a final "
                  "checkpoint", file=sys.stderr, flush=True)
            for q in procs:
                try:
                    q.send_signal(signal.SIGTERM)
                except OSError:
                    pass

    prev_term = None
    try:
        prev_term = signal.signal(signal.SIGTERM, _forward_term)
    except ValueError:
        pass  # not the main thread (tests drive launch() from threads)
    stop_grace = float(getattr(args, "stop_timeout", 30.0))

    rc = 0
    lost = 0
    try:
        while procs:
            for p in list(procs):
                r = p.poll()
                if r is None:
                    continue
                i = procs.index(p)
                procs.remove(p)
                if hbs:
                    hbs.pop(i).stop()
                if p._log:
                    p._log.close()
                if r != 0:
                    # which rank ended how, and when (the gang's abort
                    # latency is read from these lines)
                    print(f"[launch] rank {p._rank} exited rc={r} at "
                          f"{time.time():.3f}", file=sys.stderr, flush=True)
                    if term["at"] is not None:
                        # under preemption a nonzero exit means the
                        # worker missed its grace window, not an organic
                        # failure — report 143, don't gang-kill peers
                        # (they already have the signal)
                        rc = rc or 143
                    elif rc == 0:
                        # organic failure: a lost member. Later nonzero
                        # exits are collateral from the gang-kill below
                        # and must NOT shrink the next world.
                        lost += 1
                        rc = r
                        # one dead trainer kills the job (watcher.py role)
                        for q in procs:
                            q.terminate()
            if term["at"] is not None and procs and \
                    time.time() - term["at"] > stop_grace:
                for q in procs:
                    q.kill()
                rc = rc or 143
            if elastic is not None and rc == 0 and term["at"] is None \
                    and procs and elastic.join_requests() \
                    and n < elastic.max:
                # scale-out: admit the newcomer by re-forming the gang
                # (reference elastic manager force-restarts on member
                # change — a collective world cannot grow in place)
                rc = 75  # EX_TEMPFAIL: signals "re-form", not failure
                for q in procs:
                    q.terminate()
            time.sleep(0.1)
    except KeyboardInterrupt:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        rc = 130
    finally:
        for hb in hbs:
            hb.stop()
        if prev_term is not None:
            try:
                signal.signal(signal.SIGTERM, prev_term)
            except ValueError:
                pass
    return rc, lost


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="Launch a multi-process (multi-host) training job")
    ap.add_argument("--nproc_per_node", type=int, default=1,
                    help="rank processes on this node (one per card, or all on "
                         "the first card over gloo with "
                         "PADDLE_TORCH_RANKS_SHARE_DEVICE=1)")
    ap.add_argument("--nnodes", default="1",
                    help="node count, or an elastic range 'min:max' "
                         "(membership-watched scale-in/out)")
    ap.add_argument("--node_rank", type=int, default=0)
    ap.add_argument("--elastic_dir", default=None,
                    help="shared dir for the elastic membership store "
                         "(the etcd role); default: a temp dir")
    try:
        hb_default = float(os.environ.get(
            "PADDLE_ELASTIC_HB_TIMEOUT") or 3.0)
    except ValueError:
        hb_default = 3.0
    ap.add_argument("--hb_timeout", type=float, default=hb_default)
    ap.add_argument("--master", default=None,
                    help="coordinator endpoint host:port (default: "
                         "localhost with a free port — single node)")
    ap.add_argument("--log_dir", default=None)
    ap.add_argument("--max_restart", type=int, default=0,
                    help="relaunch the job up to N times after a failure "
                         "(elastic recovery)")
    ap.add_argument("--restart_interval", type=float, default=1.0)
    ap.add_argument("--stop_timeout", type=float, default=30.0,
                    help="grace seconds after a forwarded SIGTERM before "
                         "workers are killed (preemption final-save "
                         "window)")
    ap.add_argument("training_script")
    ap.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    return launch(args)
