"""Throughput timer (a copy of the JAX package's ``profiler/timer.py``;
reference: python/paddle/profiler/timer.py — ``benchmark()`` singleton
with begin/step/end)."""
from __future__ import annotations

import time
from typing import Optional

__all__ = ["Benchmark", "benchmark"]


class Benchmark:
    def __init__(self):
        self.reset()

    def reset(self):
        self._t_begin = None
        self._t_last = None
        self._steps = 0
        self._samples = 0
        self._step_times = []

    def begin(self):
        self.reset()
        self._t_begin = self._t_last = time.perf_counter()

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        if self._t_last is not None:
            self._step_times.append(now - self._t_last)
        self._t_last = now
        self._steps += 1
        if num_samples:
            self._samples += num_samples

    def end(self):
        self._t_last = None

    # -- report -----------------------------------------------------------
    @property
    def steps(self):
        return self._steps

    def avg_step_time(self, skip: int = 1) -> float:
        """Mean seconds/step, skipping warmup steps (compile)."""
        ts = self._step_times[skip:] or self._step_times
        return sum(ts) / len(ts) if ts else 0.0

    def steps_per_second(self, skip: int = 1) -> float:
        st = self.avg_step_time(skip)
        return 1.0 / st if st else 0.0

    def ips(self, skip: int = 1) -> float:
        """Samples (instances) per second."""
        if not self._steps or not self._samples:
            return 0.0
        per_step = self._samples / self._steps
        return self.steps_per_second(skip) * per_step

    def report(self, skip: int = 1):
        return {"steps": self._steps,
                "avg_step_ms": self.avg_step_time(skip) * 1e3,
                "steps_per_sec": self.steps_per_second(skip),
                "ips": self.ips(skip)}


_benchmark = Benchmark()


def benchmark() -> Benchmark:
    return _benchmark
