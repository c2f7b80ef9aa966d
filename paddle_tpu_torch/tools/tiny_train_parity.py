"""Card-versus-CPU training parity on ``LlamaConfig.tiny``, shared by
``chip_smoke.py`` (phase ``train_parity``) and
``tests/test_torch_card.py``, so that both hold the port to one check.

Both sides run in f32 with TF32 off, from the same seed-0 weights and the
same ``np.random.RandomState(0)`` batch of (2, 24) ids and labels: three
``TrainStep`` steps of AdamW (lr 1e-3, clip 1.0, no decay on the norms).
The card side goes through the flash attention kernels, the CPU side
through their plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW

__all__ = ["LR", "STEPS", "run"]

LR = 1e-3
STEPS = 3


def run(device) -> dict:
    """Train on ``device`` and on the CPU, assert that they agree, and
    return the numbers. Raises ``AssertionError`` when they do not, or
    when the card side launched no flash kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.tiny()
    rng = np.random.RandomState(0)
    x = rng.randint(0, cfg.vocab_size, (2, 24)).astype(np.int64)
    y = rng.randint(0, cfg.vocab_size, (2, 24)).astype(np.int64)
    cpu_model = LlamaForCausalLM(cfg, device="cpu")
    cpu_model.init_weights(torch.Generator().manual_seed(0))
    card_model = LlamaForCausalLM(cfg, device=device)
    card_model.load_state_dict(cpu_model.state_dict())
    losses = []
    before = dict(fa.launches)
    for m in (card_model, cpu_model):
        opt = AdamW(LR, parameters=m.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0),
                    apply_decay_param_fun=lambda n: "norm" not in n)
        step = TrainStep(m, m.criterion(), opt)
        losses.append([float(step(x, y)) for _ in range(STEPS)])
    launches = {k: fa.launches[k] - before[k] for k in before}
    assert all(n > 0 for n in launches.values()), launches
    # f32 both sides: losses to float noise; Adam's first step moves a
    # weight by about lr * sign(g), so a near-zero grad whose sign
    # differs lands up to 2 lr per step apart: hold the worst weight to
    # that and all but 0.1% of them to 1e-5
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4, atol=1e-4)
    worst, off, n = 0.0, 0, 0
    card_state = card_model.state_dict()
    for k, t in cpu_model.state_dict().items():
        diff = (card_state[k].cpu() - t).abs()
        worst = max(worst, float(diff.max()))
        off += int((diff > 1e-5).sum())
        n += diff.numel()
    assert worst <= 2 * LR * STEPS and off / n < 1e-3, (worst, off, n)
    return {"model": "tiny", "dtype": "float32", "steps": STEPS,
            "losses_card": losses[0], "losses_cpu": losses[1],
            "max_param_diff": worst, "params_off_by_1e-5": off,
            "params": n, "kernel_launches": launches}
