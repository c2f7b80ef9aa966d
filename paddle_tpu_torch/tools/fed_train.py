"""The fed training loop on the card: ``chip_smoke.py`` phases 18-19.

    python -m paddle_tpu_torch.tools.fed_train

The configuration of phase ``train`` (:mod:`paddle_tpu_torch.tools.
gpt_1b_train`: bench.py's ``bench_gpt_1b``, the 0.95B Llama at full
width and depth, bf16, AdamW, microbatches of 4 x 2048) fed by the
port's input pipeline: a :class:`~paddle_tpu_torch.io.DataLoader` with 2
forked workers over the shared-memory queue and device prefetch 2 deep,
each loader batch a stack of ``K`` microbatches of seeded token ids,
into :meth:`~paddle_tpu_torch.jit.TrainStep.run_steps` ``(K, ...,
stacked=True)``: one warm dispatch (it captures the step's CUDA graph),
then measured ones. A second model from the same seed takes the same
microbatches through ``TrainStep.__call__``; losses, every parameter and
every slot must be bit-identical (:func:`first_difference`).

:func:`run` does it all and returns one dict; ``chip_smoke.py`` drives
the pieces itself, to set the kernel launch counts to 0 around the fed
half.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.io import DataLoader, Dataset
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.tools import gpt_1b_train

__all__ = ["K", "DISPATCHES", "WORKERS", "DEPTH", "TokenBatches", "build",
           "make_loader", "run_fed", "run_calls", "snapshot",
           "first_difference", "run"]

K = 4              # steps per run_steps dispatch
DISPATCHES = 4     # one warm dispatch (captures) + 3 measured
WORKERS = 2        # DataLoader worker processes
DEPTH = 2          # device prefetch depth


class TokenBatches(Dataset):
    """Item i: one microbatch ``(ids, labels)``, int32 (BATCH, SEQ),
    drawn from ``np.random.RandomState(seed + i)``: the same items
    whichever worker makes them."""

    def __init__(self, n: int, vocab: int, seed: int = 0):
        self.n, self.vocab, self.seed = n, vocab, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed + i)
        shape = (gpt_1b_train.BATCH, gpt_1b_train.SEQ)
        return (rng.randint(0, self.vocab, shape).astype(np.int32),
                rng.randint(0, self.vocab, shape).astype(np.int32))


def build(device):
    """(model, AdamW, TrainStep) as phase ``train`` builds them, from the
    same seed."""
    model, step, _, _ = gpt_1b_train.build(device)
    return model, step._opt, step


def make_loader(dataset, device) -> DataLoader:
    """Each batch a (K, BATCH, SEQ) stack of microbatches, on the card."""
    return DataLoader(dataset, batch_size=K, num_workers=WORKERS,
                      use_shared_memory=True, use_device_prefetch=True,
                      device_prefetch_depth=DEPTH, places=device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_fed(step: TrainStep, loader: DataLoader) -> dict:
    """Every loader batch through one ``run_steps(K, stacked=True)``:
    losses, and per dispatch the host's wait for the batch and the
    dispatch's wall time (synchronised)."""
    losses: List[float] = []
    wait_ms, dispatch_ms = [], []
    it = iter(loader)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        t1 = time.perf_counter()
        if batch is None:
            break
        ids, labels = batch
        out = step.run_steps(K, ids, labels, stacked=True)
        _sync(step._device)
        t2 = time.perf_counter()
        wait_ms.append((t1 - t0) * 1e3)
        dispatch_ms.append((t2 - t1) * 1e3)
        losses += out.tolist()
    return {"losses": losses, "wait_ms": wait_ms, "dispatch_ms": dispatch_ms}


def run_calls(step: TrainStep, dataset, device) -> dict:
    """Every microbatch through one ``__call__``: losses and step times
    (synchronised)."""
    losses, step_ms = [], []
    for i in range(len(dataset)):
        ids, labels = (torch.from_numpy(a).to(device) for a in dataset[i])
        _sync(device)
        t0 = time.perf_counter()
        loss = step(ids, labels)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return {"losses": losses, "step_ms": step_ms}


@torch.no_grad()
def snapshot(model, opt) -> Dict[str, torch.Tensor]:
    """Copies of every parameter and slot, by name."""
    out = {}
    for name, p in model.named_parameters():
        out[name] = p.detach().clone()
        for k, v in opt._slots[id(p)].items():
            out[f"{name}.{k}"] = v.detach().clone()
    return out


def first_difference(a: Dict[str, torch.Tensor],
                     b: Dict[str, torch.Tensor]) -> Optional[str]:
    """The first name whose tensors are not bit-identical, else None."""
    if a.keys() != b.keys():
        return f"keys differ: {sorted(a.keys() ^ b.keys())[:4]}"
    for name in a:
        x, y = (t.reshape(-1).view(torch.uint8) for t in (a[name], b[name]))
        if not torch.equal(x, y):
            return name
    return None


def run(device) -> dict:
    """Both halves; raises if the fed run is not bit-identical to the
    calls."""
    cfg = gpt_1b_train.config()
    data = TokenBatches(K * DISPATCHES, cfg.vocab_size)
    model, opt, step = build(device)
    loader = make_loader(data, device)
    fed = run_fed(step, loader)
    fed_state = snapshot(model, opt)
    stats = step.graph_stats()
    del model, opt, step, loader
    torch.cuda.empty_cache()
    model, opt, step = build(device)
    calls = run_calls(step, data, device)
    diff = first_difference(fed_state, snapshot(model, opt))
    if fed["losses"] != calls["losses"] or diff is not None:
        raise AssertionError(f"run_steps is not bit-identical to __call__: "
                             f"first differing tensor {diff}; losses "
                             f"{fed['losses']} vs {calls['losses']}")
    return {"fed": fed, "calls": calls, "graphs": stats}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("fed_train: no CUDA device")
    print(json.dumps(run(torch.device("cuda", 0))), flush=True)


if __name__ == "__main__":
    main()
