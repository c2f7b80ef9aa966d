"""The port's profiler (``paddle_tpu_torch/profiler``, on torch.profiler)
against the JAX package's: the scenarios of ``tests/test_profiler.py``
that do not read an xplane trace. The scheduler's states and windows are
equal exactly; host scopes, op events, summaries, chrome export, the
throughput timer and MFU work as there. The phase classifier puts CUDA
kernel, memcpy, memset and NCCL names where ``device_phases`` needs them
(and the XLA names where the JAX package puts them); ``device_phases``
reads a torch.profiler chrome trace and returns ``{}`` on the CPU (the
JAX package's "no device trace"). ``device_peak_flops`` knows the H100
SXM and raises for any other device."""
import json
import os
import time
from unittest import mock

import numpy as np
import pytest
import torch

from paddle_tpu import profiler as jprof
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.profiler import (Profiler, ProfilerState,
                                       ProfilerTarget, RecordEvent,
                                       estimate_mfu, export_chrome_tracing,
                                       make_scheduler)


@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=2, repeat=1, skip_first=1),
    dict(closed=0, ready=0, record=1),
    dict(closed=2, ready=1, record=3, repeat=2),
    dict(closed=1, ready=2, record=2, repeat=0, skip_first=3)])
def test_scheduler_states_match_jax(kw):
    want = [jprof.make_scheduler(**kw)(i) for i in range(20)]
    assert [make_scheduler(**kw)(i) for i in range(20)] == want
    assert (ProfilerState.CLOSED, ProfilerState.READY, ProfilerState.RECORD,
            ProfilerState.RECORD_AND_RETURN) == (
        jprof.ProfilerState.CLOSED, jprof.ProfilerState.READY,
        jprof.ProfilerState.RECORD, jprof.ProfilerState.RECORD_AND_RETURN)


def test_scheduler_states():
    sched = make_scheduler(closed=1, ready=1, record=2, repeat=1,
                           skip_first=1)
    states = [sched(i) for i in range(6)]
    assert states == [ProfilerState.CLOSED, ProfilerState.CLOSED,
                      ProfilerState.READY, ProfilerState.RECORD,
                      ProfilerState.RECORD_AND_RETURN,
                      ProfilerState.CLOSED]


@pytest.mark.parametrize("window", [(1, 3), (0, 2), (2, 4)])
def test_recording_windows_match_jax(window):
    """A (start, end) scheduler opens and closes its window at the same
    steps in both packages (on_trace_ready fires at the close)."""
    fired = {}
    for name, mod in (("jax", jprof), ("port", tprof)):
        seen = []
        p = mod.Profiler(scheduler=window, timer_only=False,
                         on_trace_ready=lambda prof, s=seen: s.append(
                             prof.step_num))
        p.start()
        states = [p.state]
        for _ in range(5):
            p.step()
            states.append(p.state)
        p.stop()
        fired[name] = (seen, states)
    assert fired["port"] == fired["jax"]


def test_record_event_and_op_events():
    p = Profiler(targets=[ProfilerTarget.CPU]).start()
    x = torch.randn(8, 8)
    y = torch.matmul(x, x)
    with RecordEvent("user_scope"):
        _ = torch.add(y, y)

    @RecordEvent("decorated")
    def f():
        return y * 2

    f()
    p.stop()
    names = {e["name"] for e in p.host_events}
    assert {"op::matmul", "op::add", "user_scope", "decorated"} <= names
    for e in p.host_events:
        assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e)
    # recording stopped: no growth
    n = len(p.host_events)
    with RecordEvent("after"):
        _ = torch.matmul(x, x)
    assert len(p.host_events) == n


def test_scheduler_windows_and_chrome_export(tmp_path):
    handler = export_chrome_tracing(str(tmp_path))
    p = Profiler(scheduler=make_scheduler(closed=1, ready=0, record=2,
                                          repeat=1),
                 on_trace_ready=handler)
    p.start()
    x = torch.randn(4, 4)
    for _ in range(4):
        _ = torch.matmul(x, x)
        p.step()
    p.stop()
    assert p.exported_paths, "trace was never exported"
    trace = tprof.load_profiler_result(p.exported_paths[0])
    assert any(e["name"] == "op::matmul" for e in trace["traceEvents"])
    assert os.path.basename(p.exported_paths[0]).endswith("_step3.json")


def test_summary_aggregation():
    p = Profiler().start()
    x = torch.randn(8, 8)
    for _ in range(3):
        _ = torch.matmul(x, x)
    with RecordEvent("scope"):
        pass
    p.stop()
    stats = p.summary(print_table=False)
    assert stats["op::matmul"]["calls"] == 3
    assert stats["op::matmul"]["total_ms"] > 0
    assert set(stats["scope"]) == {"calls", "total_ms", "avg_ms", "max_ms"}
    assert "_device_phases" not in stats       # no device trace on the CPU


def test_summary_reports_pipeline_schedule():
    class FakeStep:
        schedule = "interleave"
        bubble_fraction = 0.1579
        S, V, M = 4, 2, 8

    outs = []
    for mod in (jprof, tprof):
        prof = mod.Profiler(targets=[mod.ProfilerTarget.CPU])
        prof.start()
        prof.stop()
        outs.append(prof.summary(print_table=False,
                                 pipeline_step=FakeStep())["_pipeline_schedule"])
    assert outs[0] == outs[1]
    assert outs[1]["bubble_fraction"] == 0.1579


def test_benchmark_timer():
    b = tprof.benchmark()
    b.begin()
    for _ in range(5):
        time.sleep(0.01)
        b.step(num_samples=32)
    b.end()
    rep = b.report()
    assert rep["steps"] == 5
    assert 5 < rep["avg_step_ms"] < 100
    assert rep["ips"] > 0
    assert set(rep) == set(jprof.benchmark().report())


def test_estimate_mfu():
    # 1 TFLOP in 10 ms at a 989 TFLOP/s peak
    mfu = estimate_mfu(1e12, 0.01, peak_flops=989e12)
    assert mfu == jprof.estimate_mfu(1e12, 0.01, peak_flops=989e12)
    assert abs(mfu - 1e12 / 0.01 / 989e12) < 1e-12


def test_device_peak_flops_knows_the_h100_and_nothing_else():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tprof.device_peak_flops()
        with pytest.raises(RuntimeError):
            estimate_mfu(1e12, 0.01)          # no silent default peak
    with mock.patch("torch.cuda.is_available", return_value=True):
        for name, want in (("NVIDIA H100 80GB HBM3", 989e12),
                           ("NVIDIA H100 SXM5 80GB", 989e12),
                           ("NVIDIA H100 PCIe", None),
                           ("NVIDIA A100-SXM4-80GB", None),
                           ("TPU v5 lite", None)):
            with mock.patch("torch.cuda.get_device_name",
                            return_value=name):
                if want is None:
                    with pytest.raises(ValueError, match="no dense bf16"):
                        tprof.device_peak_flops()
                else:
                    assert tprof.device_peak_flops() == want


@pytest.mark.parametrize("name,phase", [
    ("void flash_fwd_kernel_tc<128>(...)", "compute"),
    ("nvjet_tst_256x128_64x4_2x1_v_bz_coopB_TNN", "compute"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::AUnaryFunctor<float, float, float, "
     "at::native::MulFunctor<float> > >", "compute"),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)", "copy"),
    ("Memcpy HtoD (Pinned -> Device)", "copy"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("Memset (Device)", "copy"),
    ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage)",
     "collective"),
    ("ncclKernel_AllGather_RING_LL_Sum_int8_t", "collective")])
def test_phase_classifier_on_cuda_names(name, phase):
    assert tprof.classify_phase(name) == phase
    assert Profiler.classify_phase(name) == phase


@pytest.mark.parametrize("name", [
    "fusion.123", "dot_general.7", "all-reduce.1", "all-gather-start",
    "reduce-scatter.2", "collective-permute.5", "copy.4", "copy-start.1",
    "infeed"])
def test_phase_classifier_on_xla_names_matches_jax(name):
    assert tprof.classify_phase(name) == jprof.Profiler.classify_phase(name)


def _trace(tmp_path, events, name="t.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_device_phases_reads_a_torch_chrome_trace(tmp_path):
    """Kernel, memcpy and memset events of a torch.profiler chrome trace
    (their ``cat``), classified and summed; host ops and annotations are
    not device time; the host's ``ProfilerStep#`` annotations count the
    steps (not their device mirrors)."""
    ev = [
        {"ph": "X", "cat": "kernel", "name": "void flash_fwd_kernel_tc<128>",
         "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": "nvjet_tst_gemm", "dur": 1300.0},
        {"ph": "X", "cat": "gpu_memcpy",
         "name": "Memcpy HtoD (Pinned -> Device)", "dur": 250.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce",
         "dur": 200.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 999.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "dur": 5.0},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#0",
         "dur": 3000.0},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#1",
         "dur": 3000.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "ProfilerStep#1",
         "dur": 2900.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "dur": 7.0}]
    _trace(tmp_path, ev)
    got = tprof.device_phases(trace_dir=str(tmp_path))
    assert got == {
        "compute_ms": 1.5, "collective_ms": 0.2, "copy_ms": 0.3,
        "total_device_ms": 2.0, "steps_captured": 2, "compute_ops": 2,
        "collective_ops": 1, "copy_ops": 2, "compute_frac": 0.75,
        "collective_frac": 0.1, "copy_frac": 0.15}
    # the JAX package's keys
    assert set(got) == {f"{p}_{s}" for p in ("compute", "collective", "copy")
                        for s in ("ms", "ops", "frac")} | {
        "total_device_ms", "steps_captured"}


def test_device_phases_newest_trace_and_empty(tmp_path):
    _trace(tmp_path, [{"ph": "X", "cat": "kernel", "name": "k",
                       "dur": 1000.0}], "old.json")
    newer = _trace(tmp_path, [{"ph": "X", "cat": "gpu_memcpy",
                               "name": "Memcpy DtoH", "dur": 500.0}],
                   "new.json")
    os.utime(newer, (time.time() + 5, time.time() + 5))
    assert tprof.device_phases(trace_dir=str(tmp_path))["copy_frac"] == 1.0
    assert tprof.device_phases(trace_dir=str(tmp_path / "none")) == {}
    with pytest.raises(ValueError):
        tprof.device_phases()


def test_device_phases_is_empty_on_the_cpu(tmp_path):
    """By design: with no CUDA device there is no device trace, and
    device_phases returns {} (it does not bucket CPU ops), as the JAX
    package does without a device plane."""
    if torch.cuda.is_available():
        pytest.skip("the CPU's result")
    calls = []

    def step():
        calls.append(1)
        return torch.ones(64) * 2

    assert tprof.device_phases(step, steps=2, warmup=1) == {}
    assert len(calls) == 3
    prof = Profiler(targets=[ProfilerTarget.CPU, ProfilerTarget.GPU],
                    trace_dir=str(tmp_path))
    prof.start()
    step()
    prof.stop()
    assert prof.phase_summary(print_table=False) == {}
    assert prof.device_summary(print_table=False) == {}
    assert "_device_phases" not in prof.summary(print_table=False)


def test_counters_are_kept():
    class Subject:
        pass

    s = Subject()
    import weakref

    ref = weakref.ref(s)
    tprof.register_counter_provider(
        "test/x", lambda: None if ref() is None else 3)
    assert tprof.counters()["test/x"] == 3
    del s
    assert "test/x" not in tprof.counters()
    tprof.unregister_counter_provider("test/x")
    assert np.isfinite(len(tprof.counters()))


def test_tensor_api_ops_are_recorded_by_name():
    """A recording window holds ``op::<name>`` for each Tensor API call
    (the registry's hook, as the JAX package sets it), also in the JAX
    package; the hook is cleared when the window closes."""
    import paddle_tpu as jpaddle
    import paddle_tpu_torch as tpaddle
    from paddle_tpu_torch.core import place as tplace
    from paddle_tpu_torch.ops import registry as tregistry

    prev = (tplace._current_place, tplace._current_device)
    tpaddle.set_device("cpu")
    try:
        x = np.random.default_rng(0).standard_normal((4, 4)).astype(
            np.float32)
        seen = {}
        for P, prof in ((jpaddle, jprof), (tpaddle, tprof)):
            t = P.to_tensor(x)
            p = prof.Profiler(targets=[prof.ProfilerTarget.CPU]).start()
            P.nn.functional.softmax(P.matmul(t, t) + t)
            p.stop()
            seen[P.__name__] = {e["name"] for e in p.host_events
                                if e["name"] in ("op::matmul", "op::add",
                                                 "op::softmax")}
        assert seen["paddle_tpu_torch"] == seen["paddle_tpu"] == {
            "op::matmul", "op::add", "op::softmax"}
        assert tregistry._PROFILER_HOOK is None
    finally:
        tplace._current_place, tplace._current_device = prev
