"""The port's auto-tuner (``paddle_tpu_torch.distributed.auto_tuner``,
slice D4) through the four scenarios of the reference's
``tests/test_auto_tuner.py``:

* the grid and the prune rules equal the JAX package's;
* ``tune`` returns a valid config, records every trial and times exactly
  the top K (on 4 gloo ranks of the CPU a trial; the reference runs 8
  virtual devices), best first;
* a tiny budget rejects every config by the analysis alone, with the
  reference's ``"analysis peak ..."`` reason;
* the recorder's file and best trial.

By design the port reckons a trial's per-rank peak from its layouts
(parameter, gradient and slot bytes of a rank; nothing runs) where the
JAX package reads XLA's compiled memory analysis; the reckoning is held
here against the layouts' arithmetic."""
import json

import numpy as np
import pytest

from paddle_tpu.distributed import auto_tuner as jat
from paddle_tpu_torch.distributed import auto_tuner as tat
from paddle_tpu_torch.testing.gang_ranks import (TINY_LLAMA,
                                                 tiny_llama_batch,
                                                 tiny_llama_builder)


def _jax_builder():
    import paddle_tpu as paddle
    from paddle_tpu import optimizer
    from paddle_tpu.models.llama import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)

    cfg = LlamaConfig(**TINY_LLAMA)
    paddle.seed(0)
    m = LlamaForCausalLM(cfg)
    opt = optimizer.AdamW(learning_rate=1e-3, parameters=m.parameters())
    return m, LlamaPretrainingCriterion(cfg), opt


def _jax_batch():
    import paddle_tpu as paddle

    return [paddle.to_tensor(b) for b in tiny_llama_batch()]


def test_candidates_and_prune_rules_match_the_reference():
    port = tat.AutoTuner(tiny_llama_builder, tiny_llama_batch(),
                         num_devices=8)
    ref = jat.AutoTuner(_jax_builder, _jax_batch(), num_devices=8)
    assert [c.name() for c in port.candidates()] == \
        [c.name() for c in ref.candidates()]
    assert all(c.dp * c.mp == 8 for c in port.candidates())
    probes = [tat.TrialConfig(dp=1, mp=8, sharding_stage=3),
              tat.TrialConfig(dp=4, mp=2),
              tat.TrialConfig(dp=3, mp=2),
              tat.TrialConfig(dp=16, mp=1),
              tat.TrialConfig(dp=2, mp=4, sharding_stage=2, remat=True),
              tat.TrialConfig(dp=8, mp=1, sharding_stage=3, remat=True)]
    for cfg in probes:
        jcfg = jat.TrialConfig(**cfg.__dict__)
        assert port.prune(cfg) == ref.prune(jcfg), cfg
    assert port.prune(probes[0]) is not None
    assert port.prune(probes[1]) is None


def test_tune_returns_a_valid_config_and_records():
    tuner = tat.AutoTuner(tiny_llama_builder, tiny_llama_batch(),
                          num_devices=4, mp_candidates=[2, 4],
                          sharding_stages=(0,), remat_options=(False,))
    best = tuner.tune(top_k=2, steps=1)
    assert best is not None and best.dp * best.mp == 4
    rows = tuner.recorder.summary()
    assert all(set(r) == {"config", "status", "reason", "peak_bytes",
                          "time_per_step"} for r in rows)
    ok_rows = [r for r in rows if r["status"] == "ok"]
    assert len(ok_rows) >= 2, rows
    assert all(r["peak_bytes"] > 0 for r in ok_rows)
    timed = [r for r in ok_rows if r["time_per_step"] is not None]
    assert len(timed) == 2   # exactly the top K ran
    assert rows[0]["time_per_step"] == min(t["time_per_step"]
                                           for t in timed)


def test_the_analysis_rejects_oom_configs():
    tuner = tat.AutoTuner(tiny_llama_builder, tiny_llama_batch(),
                          num_devices=4, mp_candidates=[2],
                          sharding_stages=(0,), remat_options=(False,),
                          memory_budget_bytes=1024)
    assert tuner.tune(top_k=1, steps=1) is None
    oom = [r for r in tuner.recorder.summary() if r["status"] == "oom"]
    assert oom and "analysis peak" in oom[0]["reason"]


def test_the_reckoned_peak_follows_the_layouts():
    tuner = tat.AutoTuner(tiny_llama_builder, tiny_llama_batch(),
                          num_devices=4)
    model, _, _ = tiny_llama_builder()
    n = sum(p.numel() for p in model.parameters())
    # dp 4: every rank holds every f32 parameter, its gradient and two
    # f32 moments
    assert tuner.analyze(tat.TrialConfig(dp=4, mp=1)).peak_bytes == 16 * n
    # ZeRO 1 slices the moments over dp (the 1-D norms divide by 4 too)
    z1 = tuner.analyze(tat.TrialConfig(dp=4, mp=1, sharding_stage=1))
    assert z1.peak_bytes == 8 * n + 8 * n // 4
    mp4 = tuner.analyze(tat.TrialConfig(dp=1, mp=4)).peak_bytes
    assert 16 * n // 4 < mp4 < 16 * n   # the norms stay whole


def test_recorder_save(tmp_path):
    rec = tat.Recorder()
    rec.add(tat.Trial(tat.TrialConfig(dp=8), status="ok", peak_bytes=10,
                      time_per_step=0.5))
    rec.add(tat.Trial(tat.TrialConfig(dp=4, mp=2), status="ok",
                      peak_bytes=9, time_per_step=0.2))
    p = tmp_path / "trials.json"
    rec.save(str(p))
    rows = json.loads(p.read_text())
    assert rows[0]["config"].startswith("dp4_mp2")
    assert rec.best().config.mp == 2
