"""The port's worker-process fleet against the JAX package's engine.

Workers are real processes (``python -m
paddle_tpu_torch.serving.fleet.worker``, started by the port's
``ReplicaSupervisor``) serving on the CPU the tiny Llama whose weights
the JAX package draws at ``paddle.seed(0)``: the test writes that state
to an ``.npz`` and each worker loads it through
``paddle_tpu_torch.testing.fleet_models:npz_llama``
(``llama_state_from_jax``).

In tier-1 (three worker starts): a prefill and a decode worker serve
sampled requests with the KV shipped worker to worker over the peer data
plane, token-identical to the JAX package's single engine; the decode
worker is SIGKILLed mid-run, the prefill worker finishes its requests by
recompute with the same tokens, and the supervisor restarts the slot.

``tests/test_fleet_subprocess.py``'s four scenarios (supervised restart
after SIGKILL, SIGTERM drain, a SIGSTOPped worker found by its heartbeat
TTL, a 2 + 2 disaggregated fleet) run again on the port through
``test_torch_fleet.ported`` under ``slow``, as they are in the JAX
package: they start 2-5 workers each.
"""
import os
import signal
import tempfile
import time

import numpy as np
import pytest

import paddle_tpu as jpaddle
import test_fleet_subprocess
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import LLMEngine as JLLMEngine
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu_torch.serving import SamplingParams
from paddle_tpu_torch.serving.fleet import (
    FleetConfig, FleetRouter, ReplicaSupervisor, SupervisorConfig,
    WorkerSpec,
)
from paddle_tpu_torch.testing import fleet_models
from test_torch_fleet import (  # noqa: F401
    PortTinyLlama, _jax_tiny_state, _one_torch_thread, ported,
)

_FACTORY = "paddle_tpu_torch.testing.fleet_models:npz_llama"
_ENGINE = {"block_size": 4, "max_num_seqs": 8, "max_model_len": 64,
           "drain_grace_s": 0.0}


@pytest.fixture(scope="module")
def weights():
    """The JAX package's seed-0 tiny state as an ``.npz``."""
    d = tempfile.mkdtemp(prefix="fleet_weights_")
    path = os.path.join(d, "tiny.npz")
    np.savez(path, **_jax_tiny_state())
    yield path
    os.remove(path)
    os.rmdir(d)


def _spec(**kw):
    """A worker spec serving the carried weights on the CPU."""
    if kw.get("model", "tiny_llama") == "tiny_llama":
        kw["model"] = _FACTORY
    kw.setdefault("device", "cpu")
    return WorkerSpec(**kw)


def _sup_config(path):
    def make(**kw):
        # one intra-op thread a worker, as in the test process
        kw["env"] = dict(kw.get("env") or {}, OMP_NUM_THREADS="1",
                         **{fleet_models.WEIGHTS_ENV: path})
        return SupervisorConfig(**kw)
    return make


# ---------------------------------------------------------------------------
# the reference's four scenarios, on the port (slow)
# ---------------------------------------------------------------------------
_REF = ported(test_fleet_subprocess)
_REF["WorkerSpec"] = _spec


def _slow_scenario(name):
    fn = _REF[name]
    code = fn.__code__
    argnames = code.co_varnames[:code.co_argcount]

    def run(weights, tmp_path):
        _REF["SupervisorConfig"] = _sup_config(weights)
        kw = {"tmp_path": tmp_path, "tiny_model": PortTinyLlama()}
        fn(**{k: kw[k] for k in argnames})
    run.__name__ = name
    run.__doc__ = fn.__doc__
    return pytest.mark.slow(run)


for _name in ("test_sigkill_mid_decode_resume_and_supervised_restart",
              "test_sigterm_drain_hands_off_and_worker_exits_zero",
              "test_hung_worker_detected_by_heartbeat_ttl",
              "test_disagg_fleet_sigkill_and_drain_block_transfer"):
    globals()[_name] = _slow_scenario(_name)


# ---------------------------------------------------------------------------
# tier-1: a prefill / decode pair of workers with a peer KV ship
# ---------------------------------------------------------------------------
def _jax_reference(prompts, ids):
    jpaddle.seed(0)
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM

    jm = LlamaForCausalLM(LlamaConfig.tiny())
    jm.eval()
    eng = JLLMEngine(jm, JEngineConfig(**_ENGINE))
    sp = JSamplingParams(max_new_tokens=8, temperature=0.8, top_p=0.9)
    for rid, p in zip(ids, prompts):
        eng.add_request(rid, p, sampling=sp)
    while eng.has_unfinished():
        eng.step()
    return {rid: list(eng.get_request(rid).generated) for rid in ids}


def _drain(router, outs, max_steps=400):
    for _ in range(max_steps):
        if not router.has_unfinished():
            return outs
        outs.extend(router.step())
    raise AssertionError("router failed to converge")


def test_worker_pair_peer_ship_sigkill_and_restart(weights, tmp_path):
    rng = np.random.default_rng(31)
    prompts = [[int(t) for t in rng.integers(0, 256, size=5 + 3 * i)]
               for i in range(4)]
    ids = [f"w{i}" for i in range(4)]
    ref = _jax_reference(prompts, ids)
    sup = ReplicaSupervisor(
        _spec(engine=dict(_ENGINE)),
        _sup_config(weights)(store_dir=str(tmp_path / "store"),
                             restart_backoff_s=0.05))
    try:
        t0 = time.monotonic()
        handles = [sup.spawn(role="prefill"), sup.spawn(role="decode")]
        boot_s = time.monotonic() - t0
        assert all(h.peer_endpoint for h in handles)
        router = FleetRouter(handles, FleetConfig(), registry=sup.registry)
        sup.router = router
        sp = SamplingParams(max_new_tokens=8, temperature=0.8, top_p=0.9)
        outs = []
        for rid, p in zip(ids[:2], prompts[:2]):
            router.add_request(rid, p, sampling=sp)
        _drain(router, outs)
        snap = router.snapshot()
        # both shipped worker to worker: no payload through the router
        assert snap["fleet_peer_ship_requests"] == 2, snap
        assert snap["fleet_relay_bytes"] == 0
        assert snap["fleet_tokens_recomputed"] == 0
        assert router.num_tickets_issued == \
            sum(router.ticket_outcomes.values())
        # the decode worker dies mid-run: the prefill worker is the only
        # replica left and finishes by recompute
        for rid, p in zip(ids[2:], prompts[2:]):
            router.add_request(rid, p, sampling=sp)
        for _ in range(4):
            outs.extend(router.step())
        victim = handles[1]
        os.kill(victim.proc.pid, signal.SIGKILL)
        _drain(router, outs)
        final = {o.request_id: o for o in outs if o.finished}
        assert {r: list(final[r].generated) for r in ids} == ref
        assert all(final[r].finish_reason == "length" for r in ids)
        counts = {}
        for o in outs:
            if o.token is not None:
                counts[o.request_id] = counts.get(o.request_id, 0) + 1
        assert counts == {r: len(ref[r]) for r in ids}
        assert victim.proc.wait(timeout=10) == -signal.SIGKILL
        assert router.num_replicas_dead == 1
        # the supervisor restarts the slot with its role
        deadline = time.monotonic() + 60.0
        events = []
        while time.monotonic() < deadline:
            events += sup.poll()
            if any(e["event"] == "restarted" for e in events):
                break
            time.sleep(0.05)
        restarted = [e for e in events if e["event"] == "restarted"]
        assert restarted and restarted[0]["replica_id"] == "w1-g1"
        fresh = next(h for h in sup.handles()
                     if h.replica_id == "w1-g1")
        assert fresh.role == "decode" and fresh.alive
        assert boot_s < 60.0, boot_s
    finally:
        sup.shutdown()
