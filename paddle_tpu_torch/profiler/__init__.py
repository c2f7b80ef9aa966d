"""Profiler: host scopes, the device trace, chrome export, throughput
and MFU (port of ``paddle_tpu/profiler/__init__.py``; reference:
python/paddle/profiler/profiler.py:346, scheduler states :79,
export_chrome_tracing :215).

The state machine, the scheduler and the result keys are the JAX
package's. The device side is ``torch.profiler`` (CUPTI on the card)
where the JAX package reads an xplane trace: a recording window runs a
``torch.profiler.profile`` and exports its chrome trace into
``trace_dir``, and the device events of that trace (``kernel``,
``gpu_memcpy``, ``gpu_memset``) feed :meth:`Profiler.device_summary`,
:meth:`Profiler.phase_summary` and :func:`device_phases`. With
``record_op_events`` a recording window holds one ``op::<name>`` host
event per Tensor API call (the op registry's ``_PROFILER_HOOK``, as the
JAX package sets it) and torch's own operators of raw torch code,
``aten::mm`` as ``op::mm``.

On the CPU there is no device trace: :func:`device_phases` and
:meth:`Profiler.phase_summary` return ``{}``, the JAX package's "no
device trace" result. :func:`device_peak_flops` knows the H100 SXM by
name (989 TFLOP/s dense bf16, its data sheet) and raises for any other
device, the CPU included.

The observability counters (pull model) are the JAX package's too:
providers are only invoked when :func:`counters` is called, never per
step.
"""
from __future__ import annotations

import functools
import glob
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

from paddle_tpu_torch.profiler.timer import Benchmark, benchmark  # noqa: F401

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "make_scheduler", "export_chrome_tracing", "load_profiler_result",
           "benchmark", "estimate_mfu", "device_phases", "device_peak_flops",
           "classify_phase", "register_counter_provider",
           "unregister_counter_provider", "counters"]


class ProfilerState:
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget:
    CPU = 0
    GPU = 1      # the CUDA device trace
    CUSTOM_DEVICE = 2
    TPU = 3      # taken for code written against the JAX package: the device


_DEVICE_TARGETS = (ProfilerTarget.GPU, ProfilerTarget.TPU)


# ---------------------------------------------------------------------------
# host event recorder
# ---------------------------------------------------------------------------
class _HostEventRecorder:
    def __init__(self):
        self.events: List[dict] = []
        self.active = False
        self._lock = threading.Lock()

    def start(self):
        self.events = []
        self.active = True

    def stop(self):
        self.active = False

    def add(self, name, ts_us, dur_us):
        if not self.active:
            return
        with self._lock:
            self.events.append({
                "name": name, "ph": "X", "ts": ts_us, "dur": dur_us,
                "pid": os.getpid(), "tid": threading.get_ident() % 100000,
            })


_recorder = _HostEventRecorder()


class RecordEvent:
    """User-facing host scope (reference profiler/event_tracing.h
    RecordEvent). Usable as context manager or decorator; records only
    while a Profiler is in a RECORD state."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._t0 = None

    def begin(self):
        self._t0 = time.perf_counter_ns()

    def end(self):
        if self._t0 is None:
            return
        t1 = time.perf_counter_ns()
        _recorder.add(self.name, self._t0 / 1e3, (t1 - self._t0) / 1e3)
        self._t0 = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with RecordEvent(self.name):
                return fn(*a, **k)

        return wrapped


# ---------------------------------------------------------------------------
# scheduler (reference profiler.py:79 — cycle through window states)
# ---------------------------------------------------------------------------
def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], int]:
    """Returns fn(step)->state cycling CLOSED*closed, READY*ready,
    RECORD*(record-1), RECORD_AND_RETURN, repeated ``repeat`` times
    (0 = forever), after ``skip_first`` skipped steps."""
    assert record > 0, "record window must be positive"
    span = closed + ready + record

    def fn(step: int) -> int:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * span:
            return ProfilerState.CLOSED
        pos = s % span
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos < span - 1:
            return ProfilerState.RECORD
        return ProfilerState.RECORD_AND_RETURN

    return fn


def _default_scheduler(step: int) -> int:
    return ProfilerState.RECORD  # record everything between start/stop


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """on_trace_ready handler writing the host events as chrome://tracing
    JSON (reference profiler.py:215)."""

    def handler(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"host_{os.getpid()}"
        path = os.path.join(dir_name, f"{name}_step{prof.step_num}.json")
        with open(path, "w") as f:
            json.dump({"traceEvents": prof.host_events}, f)
        prof.exported_paths.append(path)

    return handler


def load_profiler_result(path: str):
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the device trace: torch.profiler's chrome trace
# ---------------------------------------------------------------------------
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_COLLECTIVE = ("nccl", "all-reduce", "all-gather", "all-to-all",
               "reduce-scatter", "collective-permute", "collective-broadcast",
               "psum", "ppermute")
_COPY = ("memcpy", "memset", "copy", "infeed", "outfeed", "transfer",
         "h2d", "d2h")


def classify_phase(op_name: str) -> str:
    """A device event's name -> its phase: ``collective`` (NCCL kernels,
    and the JAX package's XLA collective names), ``copy`` (memcpy and
    memset, and copy kernels: device-to-device copies and casts) or
    ``compute`` (every other kernel)."""
    nm = op_name.lower()
    if any(t in nm for t in _COLLECTIVE):
        return "collective"
    if any(t in nm for t in _COPY):
        return "copy"
    return "compute"


def _read_trace(path: str) -> dict:
    """(device events as (name, ms), steps) of one chrome trace written by
    ``torch.profiler``: the ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
    events, and the host's ``ProfilerStep#`` annotations counted as
    steps."""
    with open(path) as f:
        trace = json.load(f)
    events, steps = [], 0
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        if e.get("cat") in _DEVICE_CATS:
            events.append((e.get("name", ""), float(e.get("dur", 0)) / 1e3))
        elif e.get("cat") == "user_annotation" and \
                str(e.get("name", "")).startswith("ProfilerStep#"):
            steps += 1      # the host's annotation, not its device mirror
    return {"events": events, "steps": steps}


def _latest_trace(trace_dir: str, min_mtime: Optional[float] = None):
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"),
                             recursive=True), key=os.path.getmtime)
    if min_mtime is not None:
        files = [f for f in files if os.path.getmtime(f) >= min_mtime]
    for f in reversed(files):
        try:
            return _read_trace(f)
        except Exception:
            # a run may still be writing its newest file: skip it
            continue
    return None


def _phases(trace: dict, print_table: bool = False) -> dict:
    """The JAX package's phase breakdown over a trace's device events;
    ``{}`` when it holds none."""
    if not trace or not trace["events"]:
        return {}
    phases = {"compute": 0.0, "collective": 0.0, "copy": 0.0}
    counts = {"compute": 0, "collective": 0, "copy": 0}
    for name, dur_ms in trace["events"]:
        ph = classify_phase(name)
        phases[ph] += dur_ms
        counts[ph] += 1
    total = sum(phases.values())
    out = {f"{k}_ms": round(v, 3) for k, v in phases.items()}
    out["total_device_ms"] = round(total, 3)
    out["steps_captured"] = trace["steps"]
    for k, c in counts.items():
        out[f"{k}_ops"] = c
    if total > 0:
        for k, v in phases.items():
            out[f"{k}_frac"] = round(v / total, 4)
    if print_table and total > 0:
        print(f"{'Phase':<14}{'Total(ms)':>12}{'Ops':>8}{'Fraction':>10}")
        print("-" * 44)
        for k, v in phases.items():
            print(f"{k:<14}{v:>12.3f}{counts[k]:>8}{v / total:>10.3f}")
    return out


# ---------------------------------------------------------------------------
# Profiler
# ---------------------------------------------------------------------------
class Profiler:
    """Reference profiler.py:346 contract: targets, scheduler windows,
    on_trace_ready, start/step/stop, summary. A recording window with
    ``ProfilerTarget.GPU`` (or ``TPU``) among the targets, on a machine
    with a CUDA device, traces the device through ``torch.profiler`` and
    writes its chrome trace into ``trace_dir`` (a new temporary
    directory by default)."""

    classify_phase = staticmethod(classify_phase)

    def __init__(self, *, targets=None, scheduler=None,
                 on_trace_ready=None, timer_only: bool = False,
                 record_op_events: bool = True,
                 trace_dir: Optional[str] = None):
        self.targets = list(targets) if targets else [ProfilerTarget.CPU]
        if scheduler is None:
            self._sched = _default_scheduler
        elif callable(scheduler):
            self._sched = scheduler
        else:  # (start, end) tuple like the reference accepts
            lo, hi = scheduler
            self._sched = make_scheduler(
                closed=max(lo, 0), ready=0, record=hi - lo, repeat=1)
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.record_op_events = record_op_events
        self.step_num = 0
        self.state = ProfilerState.CLOSED
        self.host_events: List[dict] = []
        self.exported_paths: List[str] = []
        self._trace_dir = trace_dir
        self._torch_prof = None
        self._device_tracing = False
        self._trace_path: Optional[str] = None   # this profiler's trace

    # -- state transitions ------------------------------------------------
    def _recording(self, state):
        return state in (ProfilerState.RECORD,
                         ProfilerState.RECORD_AND_RETURN)

    def _enter_record(self):
        if self.timer_only:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        _recorder.start()
        self._device_tracing = torch.cuda.is_available() and any(
            t in self.targets for t in _DEVICE_TARGETS)
        activities = [ProfilerActivity.CPU]
        if self._device_tracing:
            activities.append(ProfilerActivity.CUDA)
        if self._device_tracing or self.record_op_events:
            self._torch_prof = profile(activities=activities)
            self._torch_prof.start()
        if self.record_op_events:
            from paddle_tpu_torch.ops import registry as _registry

            _registry.set_profiler_hook(lambda name: RecordEvent(name))

    def _exit_record(self):
        if self.timer_only:
            return
        _recorder.stop()
        events = list(_recorder.events)
        if self.record_op_events:
            from paddle_tpu_torch.ops import registry as _registry

            _registry.set_profiler_hook(None)
        if self._torch_prof is not None:
            prof, self._torch_prof = self._torch_prof, None
            prof.stop()
            if self._trace_dir is None:
                self._trace_dir = tempfile.mkdtemp(prefix="ptt_trace_")
            os.makedirs(self._trace_dir, exist_ok=True)
            path = os.path.join(
                self._trace_dir,
                f"torch_{os.getpid()}_{id(self)}_{self.step_num}.json")
            prof.export_chrome_trace(path)
            if self.record_op_events:
                events += _host_ops(path)
            if self._device_tracing:
                self._trace_path = path
        self.host_events = events
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def start(self):
        self.state = self._sched(self.step_num)
        if self._recording(self.state):
            self._enter_record()
        benchmark().begin()
        return self

    def step(self, num_samples: Optional[int] = None):
        benchmark().step(num_samples)
        self.step_num += 1
        new = self._sched(self.step_num)
        if self._recording(new) and not self._recording(self.state):
            self._enter_record()
        elif self._recording(self.state) and not self._recording(new):
            self._exit_record()
        self.state = new

    def stop(self):
        if self._recording(self.state):
            self._exit_record()
        self.state = ProfilerState.CLOSED
        benchmark().end()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- reporting --------------------------------------------------------
    def export(self, path: str):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.host_events}, f)
        return path

    def summary(self, sorted_by="total", print_table: bool = True,
                pipeline_step=None):
        """Aggregate host events by name -> calls/total/avg/max ms; when
        a device trace was captured, append the per-phase breakdown
        (phase_summary); when a pipeline step is passed, report its
        schedule and bubble fraction."""
        agg: Dict[str, List[float]] = {}
        for e in self.host_events:
            agg.setdefault(e["name"], []).append(e["dur"] / 1e3)  # ms
        rows = [(k, len(v), sum(v), sum(v) / len(v), max(v))
                for k, v in agg.items()]
        rows.sort(key=lambda r: -r[2])
        if print_table:
            hdr = (f"{'Event':<44}{'Calls':>8}{'Total(ms)':>12}"
                   f"{'Avg(ms)':>10}{'Max(ms)':>10}")
            print(hdr)
            print("-" * len(hdr))
            for nm, c, tot, avg, mx in rows[:40]:
                print(f"{nm:<44}{c:>8}{tot:>12.3f}{avg:>10.3f}{mx:>10.3f}")
        out = {r[0]: {"calls": r[1], "total_ms": r[2], "avg_ms": r[3],
                      "max_ms": r[4]} for r in rows}
        phases = self.phase_summary(print_table=print_table)
        if phases:
            out["_device_phases"] = phases
        if pipeline_step is not None:
            sched = {
                "schedule": pipeline_step.schedule,
                "bubble_fraction": round(pipeline_step.bubble_fraction, 4),
                "stages": pipeline_step.S,
                "interleave_degree": pipeline_step.V,
                "n_microbatches": pipeline_step.M,
            }
            out["_pipeline_schedule"] = sched
            if print_table:
                print(f"pipeline: {sched['schedule']} S={sched['stages']}"
                      f" V={sched['interleave_degree']}"
                      f" M={sched['n_microbatches']}"
                      f" bubble={sched['bubble_fraction']}")
        return out

    def _load_trace(self):
        """The device trace THIS profiler captured, or None."""
        if self._trace_path is None:
            return None
        return _read_trace(self._trace_path)

    def device_summary(self, top: int = 40, print_table: bool = True):
        """Per-kernel DEVICE time table from the captured trace (the
        device half of the reference's profiler_statistic.py report)."""
        trace = self._load_trace()
        if trace is None:
            return {}
        agg: Dict[str, List[float]] = {}
        for name, dur_ms in trace["events"]:
            agg.setdefault(name, []).append(dur_ms)
        rows = [(k, len(v), sum(v), sum(v) / len(v)) for k, v in agg.items()]
        rows.sort(key=lambda r: -r[2])
        if print_table and rows:
            hdr = (f"{'Device op':<52}{'Calls':>8}{'Total(ms)':>12}"
                   f"{'Avg(ms)':>10}")
            print(hdr)
            print("-" * len(hdr))
            for nm, c, tot, avg in rows[:top]:
                print(f"{nm[:52]:<52}{c:>8}{tot:>12.3f}{avg:>10.3f}")
        return {r[0]: {"calls": r[1], "total_ms": r[2], "avg_ms": r[3]}
                for r in rows}

    def phase_summary(self, print_table: bool = True):
        """Per-phase DEVICE time from the captured trace — compute vs
        collective vs copy; fractions are of the device-busy time. ``{}``
        without a device trace."""
        return _phases(self._load_trace(), print_table=print_table)


def _host_ops(path: str) -> List[dict]:
    """torch's operators in a chrome trace as host events, ``aten::mm``
    named ``op::mm`` (the JAX package's op-event names)."""
    with open(path) as f:
        trace = json.load(f)
    out = []
    for e in trace.get("traceEvents", []):
        name = str(e.get("name", ""))
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            out.append({"name": "op::" + name.split("::")[-1], "ph": "X",
                        "ts": e.get("ts", 0), "dur": e.get("dur", 0),
                        "pid": e.get("pid", 0), "tid": e.get("tid", 0)})
    return out


def _sync():
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def device_phases(step_fn: Optional[Callable] = None, *, steps: int = 3,
                  warmup: int = 1, trace_dir: Optional[str] = None,
                  print_table: bool = False) -> dict:
    """Device-phase breakdown — compute vs collective vs copy — as a
    first-class metric (keys: ``{phase}_ms``, ``{phase}_ops``,
    ``{phase}_frac``, ``total_device_ms``, ``steps_captured``).

    * ``device_phases(fn, steps=3)`` — call ``fn()`` ``warmup`` times
      untraced, then ``steps`` times under a fresh device trace (each
      call inside a ``ProfilerStep#<i>`` annotation), wait for the card,
      and return the breakdown.
    * ``device_phases(trace_dir=...)`` — read the newest chrome trace
      already written under ``trace_dir`` (by a :class:`Profiler`, or by
      ``torch.profiler``'s ``export_chrome_trace``).

    Returns ``{}`` when no device trace can be had (the CPU)."""
    if step_fn is None:
        if trace_dir is None:
            raise ValueError(
                "device_phases needs a step_fn to profile or a trace_dir "
                "holding an existing trace")
        return _phases(_latest_trace(trace_dir), print_table=print_table)
    from torch.profiler import record_function

    for _ in range(max(0, warmup)):
        step_fn()
    _sync()
    own_dir = None
    if trace_dir is None:
        trace_dir = own_dir = tempfile.mkdtemp(prefix="ptt_phases_")
    prof = Profiler(targets=[ProfilerTarget.CPU, ProfilerTarget.GPU],
                    record_op_events=False, trace_dir=trace_dir)
    try:
        prof.start()
        try:
            for i in range(max(1, steps)):
                with record_function(f"ProfilerStep#{i}"):
                    step_fn()
            _sync()
        finally:
            prof.stop()
        return prof.phase_summary(print_table=print_table)
    finally:
        if own_dir is not None:
            shutil.rmtree(own_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# MFU
# ---------------------------------------------------------------------------
# peak dense bf16 FLOP/s by device name (lowercase substring; data sheets)
_PEAK_BF16_FLOPS = {
    "h100 80gb hbm3": 989e12,    # H100 SXM5
    "h100 sxm": 989e12,
}


def device_peak_flops(device=None) -> float:
    """The card's dense bf16 peak, known by its name; raises for a device
    it does not know, and without a CUDA device. It never guesses."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("device_peak_flops: no CUDA device (the CPU has "
                           "no peak here)")
    name = torch.cuda.get_device_name(device)
    kind = name.lower()
    for k, v in _PEAK_BF16_FLOPS.items():
        if k in kind:
            return v
    raise ValueError(f"device_peak_flops: no dense bf16 peak known for "
                     f"{name!r}; pass peak_flops= to estimate_mfu")


def estimate_mfu(flops_per_step: float, step_time_s: float,
                 peak_flops: Optional[float] = None) -> float:
    """Model FLOPs utilisation: achieved / peak."""
    peak = peak_flops or device_peak_flops()
    return flops_per_step / max(step_time_s, 1e-12) / peak


# ---------------------------------------------------------------------------
# observability counters (pull model)
# ---------------------------------------------------------------------------
_counter_providers: Dict[str, Callable] = {}
# registrations arrive from arbitrary threads (weakref.finalize callbacks
# fire on whichever thread drops the last reference); the lock covers the
# dict, not the providers — counters() calls those outside it
_prov_lock = threading.Lock()


def register_counter_provider(name: str, fn: Callable) -> None:
    """Register a zero-arg callable whose value appears in
    :func:`counters` under ``name``. A provider returning None (dead
    weakref) is dropped."""
    with _prov_lock:
        _counter_providers[name] = fn


def unregister_counter_provider(name: str) -> None:
    with _prov_lock:
        _counter_providers.pop(name, None)


def counters() -> Dict[str, float]:
    """Current values of every registered observability counter."""
    with _prov_lock:
        providers = list(_counter_providers.items())
    out = {}
    dead = []
    for name, fn in providers:
        try:
            v = fn()
        except Exception:
            continue
        if v is None:  # provider's subject was garbage-collected
            dead.append(name)
            continue
        out[name] = v
    if dead:
        with _prov_lock:
            for name in dead:
                _counter_providers.pop(name, None)
    return out
