"""The serving fleet at Llama-3-8B widths, shared by ``chip_smoke.py``
(phase 26, ``fleet``) and the card tests.

Every engine here takes phase 4's settings
(:data:`llama3_8b_serve.ENGINE`: block 16, 8 sequences, ``max_model_len``
2048, a 2048-token budget) with zero drain grace, and every run serves
phase 4's workload (:func:`llama3_8b_serve.workload`: 8 prompts of
142-891 tokens, 32 new tokens each, the last one sampled).

* :func:`f32_identity` — 2 of the 32 layers in f32, random weights from
  seed 0: one engine; a two-replica :class:`~paddle_tpu_torch.serving.
  fleet.FleetRouter` over :class:`InProcessReplica`\\ s of the one model;
  a prefill/decode pair with the KV shipped; a two-replica fleet whose
  first replica is drained after the first router step. Each fleet's
  tokens against the engine's, and each request's terminal outputs.
* :func:`disagg` — phase 4's model (bf16, full depth) behind a prefill
  and a decode replica, both warmed up: the client-visible TTFT and TPOT,
  each ship's export (gather) and import (scatter) host times, each
  replica's K1 launches, and the decode replica's first step after an
  import (its index arrays, for K1 at the fleet's shapes).
* :func:`workers` — two worker processes (``ReplicaSupervisor``, roles
  prefill and decode, each its own CUDA context) over 4 of the 32 layers
  in f32 (so every prompt's KV fits one 64 MiB frame), the KV shipped
  worker to worker over loopback TCP; the decode worker is SIGKILLed
  mid-run and the prefill worker finishes by recompute: tokens against
  one engine in this process.
* :func:`tp_worker` — one worker process whose spec sets
  ``tp_degree=2`` (``PARITY_LAYERS`` layers in f32; on one card its two
  ranks share it, ``PADDLE_TORCH_RANKS_SHARE_DEVICE``): its tokens
  against one engine, K1's launches on each rank, its start-up seconds,
  and, after a SIGKILL of the worker, how long its rank outlives it.

A ship on the wire is one frame of at most ``transport.MAX_FRAME`` (64
MiB); at full depth in bf16 one token's KV is 2 x 32 x 8 x 128 x 2 B =
128 KiB, so a request past 512 cached tokens cannot ship over a wire and
falls back to recompute (in process there is no frame).
:func:`frame_cap_tokens` computes the bound.

Run alone on the card (prints the results as JSON)::

    python -m paddle_tpu_torch.tools.llama3_8b_fleet
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import to_torch
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import EngineConfig, LLMEngine
from paddle_tpu_torch.serving.fleet import (
    FleetConfig, FleetRouter, InProcessReplica, ReplicaSupervisor,
    SupervisorConfig, WorkerSpec,
)
from paddle_tpu_torch.serving.fleet.transport import MAX_FRAME
from paddle_tpu_torch.tools import llama3_8b_serve

__all__ = ["ENGINE", "PARITY_LAYERS", "WORKER_LAYERS", "RANK_EXIT_S",
           "model", "worker_model", "parity_worker_model",
           "frame_cap_tokens", "ShipTimes", "FirstAfterImport",
           "f32_identity", "disagg", "workers", "tp_worker"]

ENGINE = dict(llama3_8b_serve.ENGINE, drain_grace_s=0.0)
PARITY_LAYERS = 2
WORKER_LAYERS = 4
# seconds within which a SIGKILLed tp worker's ranks must be gone
RANK_EXIT_S = 10.0


def model(device, dtype: str = "bfloat16",
          layers: Optional[int] = None) -> LlamaForCausalLM:
    """Llama-3-8B in ``dtype`` on ``device``, ``layers`` of its decoder
    layers (default: all), random weights from seed 0."""
    cfg = LlamaConfig.llama3_8b()
    cfg = dataclasses.replace(cfg, dtype=dtype, num_hidden_layers=(
        layers or cfg.num_hidden_layers))
    m = LlamaForCausalLM(cfg, device=device)
    return m.init_weights(torch.Generator(device=device).manual_seed(0))


def worker_model(spec: dict) -> LlamaForCausalLM:
    """The worker factory of :func:`workers` (``WorkerSpec(model=
    "paddle_tpu_torch.tools.llama3_8b_fleet:worker_model")``): the f32
    model of ``WORKER_LAYERS`` layers on the spec's device (the card
    unless it says ``"cpu"``)."""
    device = spec.get("device") or "cuda"
    m = model(torch.device(device), "float32", WORKER_LAYERS)
    m.eval()
    return m


def parity_worker_model(spec: dict) -> LlamaForCausalLM:
    """The worker factory of :func:`tp_worker`: the f32 model of
    ``PARITY_LAYERS`` layers on the spec's device (the card unless it
    says ``"cpu"``)."""
    device = spec.get("device") or "cuda"
    m = model(torch.device(device), "float32", PARITY_LAYERS)
    m.eval()
    return m


def frame_cap_tokens(cfg: LlamaConfig, dtype_bytes: int,
                     block_size: int = 16) -> int:
    """The most cached tokens whose KV ships in one frame (whole
    blocks)."""
    per_token = (2 * cfg.num_hidden_layers * cfg.num_key_value_heads
                 * (cfg.hidden_size // cfg.num_attention_heads)
                 * dtype_bytes)
    return (MAX_FRAME // (per_token * block_size)) * block_size


def _tokens_of(router: FleetRouter, rids) -> Dict[str, List[int]]:
    return {rid: list(router.get_request(rid).generated) for rid in rids}


def _drive(router: FleetRouter, work, clock: Optional[dict] = None,
           on_step=None, max_steps: int = 4000):
    """Queue ``work`` on ``router`` and step it to the end. Returns every
    output; ``clock`` collects each request's add and token times (host
    clock after the router step that returned the token)."""
    t_add = time.perf_counter()
    for rid, prompt, sp in work:
        router.add_request(rid, prompt, sp)
        if clock is not None:
            clock[rid] = [t_add]
    outs = []
    steps = 0
    while router.has_unfinished():
        got = router.step()
        now = time.perf_counter()
        outs.extend(got)
        if clock is not None:
            for o in got:
                if o.token is not None:
                    clock[o.request_id].append(now)
        steps += 1
        if on_step is not None:
            on_step(steps)
        assert steps < max_steps, "the fleet failed to converge"
    return outs


def _once(outs, rids) -> bool:
    """Every request ended in exactly one terminal output, and streamed
    each of its tokens once."""
    finals = [o.request_id for o in outs if o.finished]
    if sorted(finals) != sorted(rids):
        return False
    counts: Dict[str, int] = {}
    for o in outs:
        if o.token is not None:
            counts[o.request_id] = counts.get(o.request_id, 0) + 1
    last = {o.request_id: o for o in outs if o.finished}
    return all(counts.get(r, 0) == len(last[r].generated) for r in rids)


def _latencies(clock: dict) -> dict:
    ttft, tpot = [], []
    for t in clock.values():
        ttft.append(t[1] - t[0])
        if len(t) > 2:
            tpot.append((t[-1] - t[1]) / (len(t) - 2))
    return {"ttft_ms_p50": float(np.percentile(ttft, 50) * 1e3),
            "tpot_ms_p50": float(np.percentile(tpot, 50) * 1e3)}


def f32_identity(m: LlamaForCausalLM, tokens: Optional[dict] = None
                 ) -> dict:
    """The token identity of the three fleets over ``m`` (phase 26: f32,
    ``PARITY_LAYERS`` of the 32 layers) against one engine, whose tokens
    go into ``tokens`` when given."""
    from paddle_tpu_torch.testing import faults

    work = llama3_8b_serve.workload(m.config.vocab_size)
    rids = [rid for rid, _, _ in work]
    eng = LLMEngine(m, EngineConfig(**ENGINE))
    for rid, prompt, sp in work:
        eng.add_request(rid, prompt, sp)
    eng.run()
    want = {rid: list(eng.get_request(rid).generated) for rid in rids}
    if tokens is not None:
        tokens.update(want)
    del eng
    res = {}
    for name, roles, drain in (
            ("two_replicas", None, False),
            ("prefill_decode", {"p": "prefill", "d": "decode"}, False),
            ("drain", None, True)):
        ids = ("p", "d") if roles else ("a", "b")
        reps = [InProcessReplica(m, EngineConfig(**ENGINE), replica_id=r)
                for r in ids]
        router = FleetRouter(reps, FleetConfig(roles=roles))

        def on_step(step):
            if drain and step == 1:
                # the router drains replica "a" at its next step (the
                # SIGTERM path, minus the signal); zero grace
                faults.install(f"{faults.FLEET_DRAIN_REPLICA}:flag:a*1")
        try:
            outs = _drive(router, work, on_step=on_step)
        finally:
            faults.clear()
        got = _tokens_of(router, rids)
        snap = router.snapshot()
        res[name] = {
            "tokens_identical": sum(got[r] == want[r] for r in rids),
            "requests": len(rids), "finished_once": _once(outs, rids),
            "finish": snap["fleet_finish"],
            "handoffs": snap["fleet_handoffs"],
            "kv_ship_requests": snap["fleet_kv_ship_requests"],
            "tokens_recomputed": snap["fleet_tokens_recomputed"],
            "recompute_fallbacks": snap["fleet_recompute_fallbacks"],
            "drained": [r.replica_id for r in reps if r.is_draining],
            "finished_by_replica": {r.replica_id:
                                    r.engine.metrics.num_finished
                                    for r in reps}}
        del reps, router
    return res


class ShipTimes:
    """Wraps a replica engine's ``export_kv`` and ``import_kv``, and its
    swapper's ``gather`` and ``scatter`` inside them, to collect their
    host times (ms, each ending in a device synchronise): the export is
    the gather to the host plus the framing and checksum, the import the
    checks and checksum plus the scatter into the caches."""

    def __init__(self, eng: LLMEngine):
        self.ms: Dict[str, List[float]] = {"export_kv": [], "import_kv": [],
                                           "gather": [], "scatter": []}
        self.bytes: List[int] = []
        for obj, names in ((eng, ("export_kv", "import_kv")),
                           (eng._swapper, ("gather", "scatter"))):
            for name in names:
                setattr(obj, name, self._timed(eng, getattr(obj, name),
                                               name))

    def _timed(self, eng, inner, name):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)
            self.ms[name].append((time.perf_counter() - t0) * 1e3)
            if name == "export_kv" and out is not None:
                self.bytes.append(len(out[1]))
            return out
        return timed


class FirstAfterImport:
    """Keeps the index arrays ``(bt, cu, ctx, num_seqs)`` of the engine's
    first ragged step after its first ``import_kv``."""

    def __init__(self, eng: LLMEngine):
        self.first = None
        self._armed = False
        inner_import, inner_dispatch = eng.import_kv, eng._dispatch

        def imported(*a, **kw):
            out = inner_import(*a, **kw)
            self._armed = True
            return out

        def dispatch(reqs, key, arrays):
            if self._armed and self.first is None:
                self.first = tuple(np.array(a) for a in arrays[1:5])
            return inner_dispatch(reqs, key, arrays)

        eng.import_kv = imported
        eng._dispatch = dispatch


def disagg(m: LlamaForCausalLM, decode=None) -> dict:
    """Phase 4's model and workload behind a prefill and a decode
    replica; ``decode``: the decode replica's (model, tp_degree)
    (default ``m`` at one rank; at k > 1 its ranks share ``m``'s card,
    and each rank's K1 launches are counted). Returns the result, the
    replicas (the caller frees them) and the decode replica's first
    post-import step."""
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.testing import tp_hooks

    dec_model, dec_tp = decode or (m, 1)
    reps = [InProcessReplica(m, EngineConfig(**ENGINE), replica_id="prefill",
                             role="prefill")]
    with tp_hooks.ranks_share_one_device():
        reps.append(InProcessReplica(
            dec_model, EngineConfig(**ENGINE, tp_degree=dec_tp),
            replica_id="decode", role="decode"))
    for r in reps:
        llama3_8b_serve.warm_up(r.engine)
    pre, dec = (r.engine for r in reps)
    times = {"prefill": ShipTimes(pre), "decode": ShipTimes(dec)}
    first = FirstAfterImport(dec)
    router = FleetRouter(reps)
    work = llama3_8b_serve.workload(m.config.vocab_size)
    rids = [rid for rid, _, _ in work]
    snaps = {r.replica_id: r.engine._graphs.snapshot() for r in reps}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock: Dict[str, list] = {}
    for r in reps:
        if r.engine._tp is not None:
            r.engine._tp.report(reset=True)     # ranks 1.. from 0
    rpa.launches = 0                      # the main path starts here
    t0 = time.perf_counter()
    outs = _drive(router, work, clock=clock)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wrapped = rpa.launches                # the main path ends here
    windows = {r.replica_id: r.engine._graphs.since(snaps[r.replica_id])
               for r in reps}
    k1 = {name: w["executed_launches"].get("ragged_paged_attention", 0)
          for name, w in windows.items()}
    # per rank: rank 0's from its window, the workers' from their count
    ranks = {r.replica_id: r.engine._tp.report() for r in reps
             if r.engine._tp is not None}
    k1_by_rank = {name: [n] + [w["k1_launches"]
                               for w in ranks.get(name, ())]
                  for name, n in k1.items()}
    snap = router.snapshot()
    tokens = _tokens_of(router, rids)
    exports = times["prefill"].ms["export_kv"]
    imports = times["decode"].ms["import_kv"]
    gathers = times["prefill"].ms["gather"]
    scatters = times["decode"].ms["scatter"]
    cap = frame_cap_tokens(m.config, 2, ENGINE["block_size"])
    res = {
        "wall_s": wall, "finished_once": _once(outs, rids),
        "generated_tokens": sum(len(v) for v in tokens.values()),
        **_latencies(clock),
        "ships": snap["fleet_kv_ship_requests"],
        "ship_bytes": snap["fleet_kv_ship_bytes"],
        "ship_blocks": snap["fleet_kv_ship_blocks"],
        "tokens_recomputed": snap["fleet_tokens_recomputed"],
        "recompute_fallbacks": snap["fleet_recompute_fallbacks"],
        "ticket_outcomes": snap["fleet_ticket_outcomes"],
        "export_ms": exports, "import_ms": imports,
        "gather_ms": gathers, "scatter_ms": scatters,
        **{f"{name}_ms_p50": float(np.percentile(v, 50)) if v else None
           for name, v in (("export", exports), ("import", imports),
                           ("gather", gathers), ("scatter", scatters))},
        "export_bytes": times["prefill"].bytes,
        "frame_cap_tokens": cap,
        "prompts_past_frame_cap": sum(len(p) > cap for _, p, _ in work),
        "k1_launches": k1, "k1_launches_by_rank": k1_by_rank,
        "k1_wrapper_launches": wrapped,
        "decode_tp_degree": dec_tp,
        "captures": {n: w["captures"] for n, w in windows.items()},
        "replays": {n: sum(w["replays"].values())
                    for n, w in windows.items()},
        "steps": {r.replica_id: r.engine.metrics.engine_steps for r in reps},
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "worker_max_memory_allocated": {
            name: [w["max_memory_allocated"] for w in ws]
            for name, ws in ranks.items()},
        "tokens": tokens}
    return {"result": res, "replicas": reps, "router": router,
            "first_after_import": first}


def workers(m: LlamaForCausalLM,
            factory: str = "paddle_tpu_torch.tools.llama3_8b_fleet:"
                           "worker_model",
            env: Optional[dict] = None, kill_after_steps: int = 3) -> dict:
    """Two worker processes (prefill, decode) building their model with
    ``factory`` (phase 26: :func:`worker_model`) on ``m``'s device; the
    decode worker SIGKILLed ``kill_after_steps`` router steps into the
    second half of the workload. Tokens against one engine over ``m``
    (the same weights) in this process, which is freed before the
    workers start."""
    device = m.device
    cfg = m.config
    work = llama3_8b_serve.workload(m.config.vocab_size)
    rids = [rid for rid, _, _ in work]
    eng = LLMEngine(m, EngineConfig(**ENGINE))
    for rid, prompt, sp in work:
        eng.add_request(rid, prompt, sp)
    eng.run()
    want = {rid: list(eng.get_request(rid).generated) for rid in rids}
    del eng, m
    if device.type == "cuda":
        torch.cuda.empty_cache()
    store_dir = tempfile.mkdtemp(prefix="fleet_store_")
    sup = ReplicaSupervisor(
        WorkerSpec(model=factory, device=device.type,
                   engine=dict(ENGINE)),
        SupervisorConfig(store_dir=store_dir, spawn_timeout_s=300.0,
                         env=dict(env or {})))
    try:
        boot = []
        handles = []
        for role in ("prefill", "decode"):
            t0 = time.perf_counter()
            handles.append(sup.spawn(role=role))
            boot.append(time.perf_counter() - t0)
        router = FleetRouter(handles, FleetConfig(), registry=sup.registry)
        sup.router = router
        half = len(work) // 2
        outs = _drive(router, work[:half])
        snap = router.snapshot()
        peer = {"ships": snap["fleet_peer_ship_requests"],
                "bytes": snap["fleet_peer_ship_bytes"],
                "relay_bytes": snap["fleet_relay_bytes"],
                "ship_s": router.kv_ship_time_s,
                "tokens_recomputed": snap["fleet_tokens_recomputed"]}
        peer["mb_per_s"] = (peer["bytes"] / 2 ** 20 / peer["ship_s"]
                            if peer["ship_s"] > 0 else None)
        victim = handles[1]

        def on_step(step):
            if step == kill_after_steps:
                os.kill(victim.proc.pid, signal.SIGKILL)
        outs += _drive(router, work[half:], on_step=on_step)
        got = _tokens_of(router, rids)
        snap = router.snapshot()
        killed = victim.proc.wait(timeout=60) == -signal.SIGKILL
        res = {"layers": cfg.num_hidden_layers,
               "dtype": str(cfg.dtype),
               "boot_s": boot, "peer": peer,
               "tokens_identical": sum(got[r] == want[r] for r in rids),
               "requests": len(rids), "finished_once": _once(outs, rids),
               "victim_sigkilled": killed,
               "replicas_dead": snap["fleet_replicas_dead"],
               "handoffs": snap["fleet_handoffs"],
               "tickets_issued": snap["fleet_tickets_issued"],
               "ticket_outcomes": snap["fleet_ticket_outcomes"],
               "frame_cap_tokens": frame_cap_tokens(
                   cfg, torch.finfo(to_torch(cfg.dtype)).bits // 8,
                   ENGINE["block_size"]),
               "finish": snap["fleet_finish"]}
    finally:
        sup.shutdown()
        shutil.rmtree(store_dir, ignore_errors=True)
    procs = [h.proc for h in handles]
    res["workers_exited"] = all(p.poll() is not None for p in procs)
    return res


def _running(pid: int) -> bool:
    """Whether process ``pid`` runs (a zombie no one reaps counts as
    gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def tp_worker(want: Dict[str, List[int]], device) -> dict:
    """One worker process serving phase 4's workload at ``tp_degree=2``
    (:func:`parity_worker_model`; on the card both ranks on ``device``
    through ``PADDLE_TORCH_RANKS_SHARE_DEVICE``): its tokens against
    ``want`` (one engine's, :func:`f32_identity`), the K1 launches each
    rank made serving them, its start-up seconds; then a SIGKILL of the
    worker and the seconds until its rank is gone (at most
    :data:`RANK_EXIT_S`)."""
    from paddle_tpu_torch.testing import tp_hooks

    device = torch.device(device)
    work = llama3_8b_serve.workload(LlamaConfig.llama3_8b().vocab_size)
    rids = [rid for rid, _, _ in work]
    store_dir = tempfile.mkdtemp(prefix="fleet_store_")
    sup = ReplicaSupervisor(
        WorkerSpec(model="paddle_tpu_torch.tools.llama3_8b_fleet:"
                         "parity_worker_model", device=device.type,
                   engine=dict(ENGINE, tp_degree=2), peer=False),
        SupervisorConfig(store_dir=store_dir, spawn_timeout_s=300.0,
                         env={tp_hooks.ENV: "1"} if device.type == "cuda"
                         else {}))
    try:
        t0 = time.perf_counter()
        h = sup.spawn()
        boot_s = time.perf_counter() - t0
        before = h.tp_report()
        router = FleetRouter([h], FleetConfig(), registry=sup.registry)
        t0 = time.perf_counter()
        outs = _drive(router, work)
        serve_s = time.perf_counter() - t0
        got = _tokens_of(router, rids)
        after = h.tp_report()
        pids = after["pids"]
        alive_before = [_running(p) for p in pids]
        os.kill(h.proc.pid, signal.SIGKILL)
        t0 = time.perf_counter()
        while any(_running(p) for p in pids) and \
                time.perf_counter() - t0 < 3 * RANK_EXIT_S:
            time.sleep(0.05)
        gone_s = time.perf_counter() - t0
        res = {"layers": PARITY_LAYERS, "dtype": "float32", "tp_degree": 2,
               "boot_s": boot_s, "serve_s": serve_s,
               "tokens_identical": sum(got[r] == want[r] for r in rids),
               "requests": len(rids), "finished_once": _once(outs, rids),
               "k1_launches_per_rank": [
                   a["k1_launches"] - b["k1_launches"]
                   for a, b in zip(after["ranks"], before["ranks"])],
               "max_memory_allocated_per_rank": [
                   a["max_memory_allocated"] for a in after["ranks"]],
               "rank_pids": pids, "ranks_alive_before_kill": alive_before,
               "worker_sigkilled": h.proc.wait(timeout=60)
               == -signal.SIGKILL,
               "ranks_gone_s": gone_s,
               "ranks_alive_after": [p for p in pids if _running(p)]}
    finally:
        sup.shutdown()
        shutil.rmtree(store_dir, ignore_errors=True)
    return res


def _main():
    dev = torch.device("cuda", 0)
    out = {"f32_identity": f32_identity(model(dev, "float32",
                                              PARITY_LAYERS))}
    torch.cuda.empty_cache()
    out["workers"] = workers(model(dev, "float32", WORKER_LAYERS))
    print(json.dumps(out))


if __name__ == "__main__":
    _main()
