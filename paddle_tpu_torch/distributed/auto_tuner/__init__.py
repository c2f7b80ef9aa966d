"""Auto-config tuner: search (dp, mp, sharding, remat, accumulate) for a
model + device count (port of ``paddle_tpu/distributed/auto_tuner/``).

Reference: python/paddle/distributed/auto_tuner/ — ``search.py`` builds a
grid over (dp_degree, mp_degree, pp_degree, micro_batch_size, sharding
stage, recompute), ``prune.py`` drops invalid/ dominated points, and
``recorder.py`` sorts & persists trial results; each surviving candidate
is *launched as a trial job* and timed.

:class:`TrialConfig`, :class:`Trial`, :class:`Recorder` and the grid and
prune rules are the JAX package's. The JAX package reads each
candidate's per-device peak from XLA's compile-time memory analysis; an
eager PyTorch step has none, so :meth:`AutoTuner.analyze` reckons each
rank's peak without running anything, from the trial's layouts: the
bytes of this rank's parameter shards, their gradients and its
optimizer slots (the ZeRO slices at stages 1-2, the shards at stage 3),
activations left out. Only the top-K survivors run:
:meth:`AutoTuner.time_trial` starts ``num_devices`` ranks of a
:class:`~paddle_tpu_torch.distributed.ParallelTrainStep` through
``distributed.spawn``, each joining by ``init_parallel_env`` (gloo processes
on the CPU, or ranks sharing the card under
``PADDLE_TORCH_RANKS_SHARE_DEVICE``, else one card each) and times its
steps. ``model_builder`` must then be importable by the ranks (a
module-level function).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["TrialConfig", "Trial", "Recorder", "AutoTuner"]

# seconds one timed trial's world may take
TRIAL_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class TrialConfig:
    """One hybrid-parallel configuration (reference: the per-trial config
    dict emitted by auto_tuner/search.py)."""

    dp: int = 1
    mp: int = 1
    sharding_stage: int = 0  # 0/1/2/3 (ZeRO)
    remat: bool = False
    accumulate_steps: int = 1

    def axes(self):
        return {"dp": self.dp, "mp": self.mp}

    def name(self) -> str:
        return (f"dp{self.dp}_mp{self.mp}_zero{self.sharding_stage}"
                f"{'_remat' if self.remat else ''}"
                f"_acc{self.accumulate_steps}")


@dataclasses.dataclass
class Trial:
    config: TrialConfig
    status: str = "pending"  # pruned / oom / error / ok
    reason: str = ""
    peak_bytes: Optional[int] = None
    time_per_step: Optional[float] = None

    def row(self) -> Dict:
        return {"config": self.config.name(), "status": self.status,
                "reason": self.reason, "peak_bytes": self.peak_bytes,
                "time_per_step": self.time_per_step}


class Recorder:
    """Trial bookkeeping + persistence (reference recorder.py: store
    history, sort by metric, save csv)."""

    def __init__(self):
        self.trials: List[Trial] = []

    def add(self, trial: Trial):
        self.trials.append(trial)

    def sorted_trials(self) -> List[Trial]:
        done = [t for t in self.trials if t.status == "ok"
                and t.time_per_step is not None]
        rest = [t for t in self.trials if t not in done]
        return sorted(done, key=lambda t: t.time_per_step) + rest

    def best(self) -> Optional[Trial]:
        s = self.sorted_trials()
        return s[0] if s and s[0].status == "ok" else None

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump([t.row() for t in self.sorted_trials()], f, indent=1)

    def summary(self) -> List[Dict]:
        return [t.row() for t in self.sorted_trials()]


class AutoTuner:
    """Search + prune + analyze + time.

    ``model_builder() -> (model, loss_fn, optimizer)`` must build a fresh
    model (each trial's ranks build their own and cut it to their shards).
    """

    def __init__(self, model_builder: Callable, sample_batch: Sequence,
                 num_devices: Optional[int] = None,
                 memory_budget_bytes: Optional[int] = None,
                 mp_candidates: Optional[Sequence[int]] = None,
                 sharding_stages: Sequence[int] = (0, 2, 3),
                 remat_options: Sequence[bool] = (False, True),
                 accumulate_options: Sequence[int] = (1,)):
        """``num_devices`` defaults to the visible cards (1 without
        one)."""
        import torch

        self._build = model_builder
        self._batch = list(sample_batch)
        self._ndev = num_devices or max(1, torch.cuda.device_count())
        self._budget = memory_budget_bytes
        self._mp_candidates = mp_candidates
        self._sharding_stages = tuple(sharding_stages)
        self._remat_options = tuple(remat_options)
        self._accumulate_options = tuple(accumulate_options)
        self.recorder = Recorder()

    # -- search space (reference search.py grid) -------------------------
    def candidates(self) -> List[TrialConfig]:
        def divisors(n):
            return [d for d in range(1, n + 1) if n % d == 0]

        mps = self._mp_candidates or divisors(self._ndev)
        out = []
        for mp in mps:
            if self._ndev % mp:
                continue
            dp = self._ndev // mp
            for stage, remat, acc in itertools.product(
                    self._sharding_stages, self._remat_options,
                    self._accumulate_options):
                out.append(TrialConfig(dp=dp, mp=mp,
                                       sharding_stage=stage,
                                       remat=remat,
                                       accumulate_steps=acc))
        return out

    # -- static prune rules (reference prune.py) -------------------------
    def prune(self, cfg: TrialConfig) -> Optional[str]:
        batch0 = self._batch[0]
        bs = int(np.asarray(
            batch0._data if hasattr(batch0, "_data") else batch0
        ).shape[0])
        if cfg.dp * cfg.mp != self._ndev:
            return f"dp*mp={cfg.dp * cfg.mp} != devices={self._ndev}"
        if bs % cfg.dp:
            return f"batch {bs} not divisible by dp={cfg.dp}"
        if cfg.sharding_stage and cfg.dp == 1:
            return "sharding needs dp>1"
        if cfg.sharding_stage and cfg.remat and cfg.sharding_stage < 3:
            # dominated: remat+zero1/2 never beats remat+zero3 on memory
            # and never beats plain zero1/2 on time
            return "dominated (remat with zero<3)"
        return None

    # -- the reckoned per-rank peak -------------------------------------
    def analyze(self, cfg: TrialConfig) -> Trial:
        """Prune, then reckon the trial's per-rank peak from its layouts
        (parameter + gradient + slot bytes of the largest rank; nothing
        runs). Over the budget: ``oom`` with the reference's
        ``"analysis peak ..."`` reason."""
        trial = Trial(cfg)
        reason = self.prune(cfg)
        if reason is not None:
            trial.status, trial.reason = "pruned", reason
            return trial
        try:
            trial.peak_bytes = self._reckon(cfg)
        except Exception as e:  # an invalid config
            trial.status, trial.reason = "error", f"{type(e).__name__}: {e}"
            return trial
        if self._budget is not None and trial.peak_bytes > self._budget:
            trial.status = "oom"
            trial.reason = (f"analysis peak {trial.peak_bytes} > budget "
                            f"{self._budget}")
            return trial
        trial.status = "ok"
        return trial

    def _reckon(self, cfg: TrialConfig) -> int:
        import torch

        from paddle_tpu_torch.distributed.engine import (
            _named_params, _plan_for, _tensor,
        )
        from paddle_tpu_torch.distributed.mesh import ProcessMesh

        model, _loss, opt = self._build()
        mesh = ProcessMesh(np.arange(self._ndev).reshape(cfg.dp, cfg.mp),
                           dim_names=["dp", "mp"])
        pc = _config(cfg)
        axes = list(zip(mesh.dim_names, mesh.shape))
        total = 0
        for _, p in _named_params(model):
            t = _tensor(p)
            plan = _plan_for(p, mesh, pc)
            lay = plan.layout(mesh)
            local = lay.local_shape(plan.global_shape)
            nbytes = int(np.prod(local)) * t.element_size()
            total += 2 * nbytes  # the shard and its gradient
            slot_shape = local
            if cfg.sharding_stage in (1, 2) and plan.zero_dim is not None:
                from paddle_tpu_torch.distributed.redistribute import Layout

                dims = list(lay.dim_placements)
                dims[plan.zero_dim] = plan.zero_axis
                slot_shape = Layout(axes, dims).local_shape(
                    plan.global_shape)
            slots = opt._init_slots_mp(torch.empty(
                slot_shape, dtype=t.dtype, device="meta"))
            total += sum(v.numel() * v.element_size()
                         for v in slots.values())
        return int(total)

    # -- timing (only for top-K analysis survivors) ----------------------
    def time_trial(self, trial: Trial, steps: int = 3) -> Trial:
        """Run the trial on ``num_devices`` ranks started by
        :func:`~paddle_tpu_torch.distributed.spawn` (the launcher's env
        protocol; each joins through ``init_parallel_env``): one warm
        step, then ``steps`` timed ones; ``time_per_step`` is rank 0's
        mean."""
        import multiprocessing as mp
        import queue

        from paddle_tpu_torch.distributed.compat import spawn

        out = mp.get_context("spawn").Queue()
        procs = spawn(_time_rank, args=(out, self._build, self._batch,
                                        trial.config, steps),
                      nprocs=self._ndev, join=False, daemon=True)
        try:
            times = {}
            deadline = time.monotonic() + TRIAL_TIMEOUT_S
            while len(times) < self._ndev:
                try:
                    rank, err, t = out.get(
                        timeout=max(0.1, deadline - time.monotonic()))
                except queue.Empty:
                    raise TimeoutError(f"the trial's ranks did not finish "
                                       f"within {TRIAL_TIMEOUT_S}s")
                if err is not None:
                    raise RuntimeError(f"rank {rank} failed:\n{err}")
                times[rank] = t
            trial.time_per_step = times[0]
        except Exception as e:
            trial.status, trial.reason = "error", f"{type(e).__name__}: {e}"
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        return trial

    def tune(self, top_k: int = 3, steps: int = 3) -> Optional[TrialConfig]:
        """Full pipeline: grid -> prune -> analyze -> time top-K -> best
        config (or None).

        Timing candidates are ordered by an overhead prior, not by
        memory: among configs that fit, plain ones (no remat, lower ZeRO
        stage, less mp) are almost always faster than their
        memory-saving variants, so they must be in the timed set."""
        analyzed = []
        for cfg in self.candidates():
            t = self.analyze(cfg)
            self.recorder.add(t)
            if t.status == "ok":
                analyzed.append(t)
        analyzed.sort(key=lambda t: (t.config.remat,
                                     t.config.sharding_stage,
                                     t.config.mp,
                                     t.peak_bytes or 0))
        for t in analyzed[:top_k]:
            self.time_trial(t, steps=steps)
        best = self.recorder.best()
        return best.config if best else None


def _config(cfg: TrialConfig):
    from paddle_tpu_torch.distributed.engine import ParallelConfig

    return ParallelConfig(dp_axes=("dp",), sharding_stage=cfg.sharding_stage,
                          sharding_axis="dp", remat=cfg.remat)


def _time_rank(out, build, batch, cfg: TrialConfig, steps: int):
    """A timed trial's rank: join the world, build, cut to this rank's
    shards, one warm step, then ``steps`` timed ones (each read back, as
    the reference's ``float(loss.item())``); puts ``(rank, error, mean
    seconds a step)`` on ``out``."""
    import os
    import traceback

    import torch

    import paddle_tpu_torch.distributed as dist

    rank = None
    try:
        dist.init_parallel_env()
        rank, world = dist.get_rank(), dist.get_world_size()
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
        out.put((rank, None, _timed(world, build, batch, cfg, steps)))
    except BaseException:
        out.put((rank, traceback.format_exc(), None))
        raise
    dist.destroy_process_group()


def _timed(world: int, build, batch, cfg: TrialConfig, steps: int):
    import time as _time

    import torch

    from paddle_tpu_torch.distributed.engine import ParallelTrainStep
    from paddle_tpu_torch.distributed.env import current_device
    from paddle_tpu_torch.distributed.mesh import ProcessMesh

    dev = current_device()
    model, loss_fn, opt = build()
    model.to(dev)
    mesh = ProcessMesh(np.arange(world).reshape(cfg.dp, cfg.mp),
                       dim_names=["dp", "mp"])
    step = ParallelTrainStep(model, loss_fn, opt, mesh, _config(cfg))
    datas = [b._data if hasattr(b, "_data") else torch.as_tensor(
        np.asarray(b)) for b in batch]
    float(step(*datas))
    t0 = _time.perf_counter()
    for _ in range(steps):
        loss = step(*datas)
    float(loss)
    return (_time.perf_counter() - t0) / steps
