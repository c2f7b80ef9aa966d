"""The Tensor of the port against the JAX package's: construction, dtype
and place rules, metadata, conversions, the bound methods, the magic and
reflected operators, in-place rebinding and its leaf error, indexing,
dtypes, places and flags. Values compare at rtol 1e-5, atol 1e-6 (f32).

By design (ROADMAP queue 3): the default place is the card and raises
without one (the JAX package falls back to the CPU); int64 stays int64
(the JAX package narrows it to int32).
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as P_ref
import paddle_tpu_torch as P_port
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.ops import registry as port_registry

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cpu():
    prev = (port_place._current_place, port_place._current_device)
    P_port.set_device("cpu")
    yield
    port_place._current_place, port_place._current_device = prev


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


def test_default_place_is_the_card_and_raises_without_one():
    prev = (port_place._current_place, port_place._current_device)
    port_place._current_place = port_place._current_device = None
    try:
        if torch.cuda.is_available():
            assert P_port.to_tensor([1.0]).place == P_port.CUDAPlace(0)
            assert P_port.get_device() == "gpu:0"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                P_port.to_tensor([1.0])
            with pytest.raises(RuntimeError):
                P_port.zeros([2])
            with pytest.raises(RuntimeError):
                P_port.set_device("gpu")
        t = P_port.to_tensor([1.0], place=P_port.CPUPlace())
        assert t.place == P_port.CPUPlace() and t.place.is_cpu_place()
        assert P_port.set_device("cpu") == P_port.CPUPlace()
        assert P_port.get_device() == "cpu:0"
        assert P_port.zeros([2]).place == P_port.CPUPlace()
    finally:
        port_place._current_place, port_place._current_device = prev


def test_the_port_runs_on_cuda_not_on_a_tpu(cpu):
    with pytest.raises(ValueError, match="CUDA"):
        P_port.TPUPlace()
    with pytest.raises(ValueError, match="CUDA"):
        P_port.set_device("tpu")
    assert P_port.CUDAPlace(1) == P_port.Place("gpu", 1)
    assert P_port.Place("cuda", 0) == P_port.CUDAPlace(0)
    assert P_port.is_compiled_with_tpu() is False
    assert isinstance(P_port.is_compiled_with_cuda(), bool)
    assert P_port.device_count() == (torch.cuda.device_count()
                                     if torch.cuda.is_available() else 0)


@pytest.mark.parametrize("data,ref_dtype,port_dtype", [
    ([1.0, 2.0], "float32", "float32"),
    (np.arange(4, dtype=np.float64), "float32", "float32"),
    (np.arange(4, dtype=np.int64), "int32", "int64"),
    (np.arange(4, dtype=np.int32), "int32", "int32"),
    ([1, 2], "int32", "int64"),
    ([True, False], "bool", "bool"),
    (np.arange(3, dtype=np.float16), "float16", "float16"),
    (np.array([1 + 2j], np.complex128), "complex64", "complex64"),
    (3.5, "float32", "float32"),
])
def test_input_dtypes(cpu, data, ref_dtype, port_dtype):
    """float64 narrows to float32 in both; int64 stays int64 in the port
    (by design), where the JAX package narrows it to int32."""
    r, p = P_ref.to_tensor(data), P_port.to_tensor(data)
    assert r.dtype.name == ref_dtype and p.dtype.name == port_dtype
    _close(p.numpy(), r.numpy())


def test_int64_past_int32_is_kept(cpu):
    big = np.array([2 ** 40, -2 ** 40], np.int64)
    with pytest.raises(OverflowError):
        P_ref.to_tensor(big)
    assert P_port.to_tensor(big).numpy().tolist() == big.tolist()


def test_explicit_dtypes_and_bf16_carry_across(cpu):
    x = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    r = P_ref.to_tensor(x, dtype="bfloat16")
    p = P_port.to_tensor(np.asarray(r._data))          # ml_dtypes bf16
    assert p.dtype == P_port.bfloat16
    assert np.array_equal(p.numpy(), r.numpy())
    p2 = P_port.to_tensor(r.numpy(), dtype="bfloat16")  # via its f32 numpy
    assert np.array_equal(p2.numpy(), r.numpy())
    for name in ("float16", "int32", "bool", "float32"):
        assert P_port.to_tensor(x, dtype=name).dtype.name == \
            P_ref.to_tensor(x, dtype=name).dtype.name


def test_to_tensor_copies_its_source(cpu):
    a = np.ones(3, np.float32)
    t = P_port.to_tensor(a)
    a[0] = 5
    src = torch.ones(3)
    u = P_port.to_tensor(src, stop_gradient=False)
    src[0] = 7
    assert t.numpy()[0] == 1 and u.numpy()[0] == 1 and u.is_leaf


def test_metadata(cpu):
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    r, p = P_ref.to_tensor(x), P_port.to_tensor(x)
    for attr in ("shape", "ndim", "dim", "size"):
        assert getattr(p, attr) == getattr(r, attr), attr
    assert p.dtype.name == r.dtype.name and p.dtype == "float32"
    assert p.stop_gradient and p.is_leaf and p.grad is None
    assert p.T.shape == r.T.shape and p.mT.shape == r.mT.shape
    _close(p.T.numpy(), r.T.numpy())
    _close(p.mT.numpy(), r.mT.numpy())
    assert p.name.startswith("tensor_") and not p.persistable
    assert p.place == P_port.CPUPlace() and not p.is_dist()


def test_conversions_and_bound_methods(cpu):
    x = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
    r, p = P_ref.to_tensor(x), P_port.to_tensor(x)
    _close(p.numpy(), r.numpy())
    assert p[0, 1].item() == pytest.approx(r[0, 1].item())
    _close(p.tolist(), r.tolist())
    _close(np.asarray(p), np.asarray(r))
    for dt in ("int32", "float16", "bool"):
        assert p.astype(dt).dtype.name == r.astype(dt).dtype.name
        _close(p.astype(dt).numpy(), r.astype(dt).numpy())
        assert p.cast(dt).dtype.name == dt
    assert p.to("float16").dtype == P_port.float16
    assert p.to("cpu").place == P_port.CPUPlace()
    assert p.cpu().place == P_port.CPUPlace()
    d = P_port.to_tensor(x, stop_gradient=False)
    assert d.detach().stop_gradient and not d.clone().stop_gradient
    _close(d.clone().numpy(), x)
    for name in ("sum", "mean", "max", "abs", "exp", "argmax", "t",
                 "flatten", "tanh", "cumsum"):
        _close(getattr(p, name)().numpy(), getattr(r, name)().numpy())
    _close(p.matmul(p.T).numpy(), r.matmul(r.T).numpy())
    _close(p.reshape([4, 3]).numpy(), r.reshape([4, 3]).numpy())


def test_value_setters(cpu):
    for P in (P_ref, P_port):
        t = P.to_tensor([1.0, 2.0, 3.0])
        t.set_value(np.array([4.0, 5.0, 6.0]))
        assert t.numpy().tolist() == [4.0, 5.0, 6.0]
        t.copy_(P.to_tensor([7, 8, 9]))
        assert t.numpy().tolist() == [7.0, 8.0, 9.0]
        assert t.dtype.name == "float32"
        t.fill_(2.5)
        assert t.numpy().tolist() == [2.5] * 3
        t.zero_()
        assert t.numpy().tolist() == [0.0] * 3
    w = P_port.to_tensor([1.0, 2.0], stop_gradient=False)
    w.set_value([3.0, 4.0])
    assert w.is_leaf and not w.stop_gradient and w._data.requires_grad


def test_python_protocol(cpu):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    r, p = P_ref.to_tensor(x), P_port.to_tensor(x)
    assert len(p) == len(r) == 2
    with pytest.raises(TypeError):
        len(P_port.to_tensor(1.0))
    assert bool(P_port.to_tensor(1.0)) and not bool(P_port.to_tensor(0.0))
    assert int(P_port.to_tensor(3)) == int(P_ref.to_tensor(3)) == 3
    assert float(p[1, 2]) == float(r[1, 2]) == 5.0
    assert [row.numpy().tolist() for row in p] == \
        [row.numpy().tolist() for row in r]
    assert hash(p) == id(p) and {p: 1}[p] == 1
    q = copy.deepcopy(P_port.to_tensor(x, stop_gradient=False))
    assert not q.stop_gradient and q.is_leaf
    _close(q.numpy(), x)
    assert f"{P_port.to_tensor(2.5):.2f}" == f"{P_ref.to_tensor(2.5):.2f}"
    assert "shape=[2, 3]" in repr(p)
    assert list(range(10))[P_port.to_tensor(4)] == 4


_BINARY = ["__add__", "__sub__", "__mul__", "__truediv__", "__floordiv__",
           "__mod__", "__pow__", "__matmul__", "__eq__", "__ne__", "__gt__",
           "__ge__", "__lt__", "__le__"]


@pytest.mark.parametrize("magic", _BINARY)
def test_magic_and_reflected_operators(cpu, magic):
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 2.0, (3, 3)).astype(np.float32)
    b = rng.uniform(0.5, 2.0, (3, 3)).astype(np.float32)
    ra, rb = P_ref.to_tensor(a), P_ref.to_tensor(b)
    pa, pb = P_port.to_tensor(a), P_port.to_tensor(b)
    _close(getattr(pa, magic)(pb).numpy(), getattr(ra, magic)(rb).numpy())
    if magic in ("__matmul__",) or magic.startswith(("__e", "__n", "__g",
                                                      "__l")):
        return
    refl = "__r" + magic[2:]
    for scalar in (2, 1.5):
        got = getattr(pa, refl)(scalar)
        want = getattr(ra, refl)(scalar)
        assert got.dtype.name == want.dtype.name
        _close(got.numpy(), want.numpy())


def test_unary_and_bitwise_magics(cpu):
    x = np.array([-1.5, 0.0, 2.0], np.float32)
    i = np.array([1, 6, 3], np.int32)
    for m in ("__neg__", "__abs__"):
        _close(getattr(P_port.to_tensor(x), m)().numpy(),
               getattr(P_ref.to_tensor(x), m)().numpy())
    for m in ("__and__", "__or__", "__xor__"):
        _close(getattr(P_port.to_tensor(i), m)(P_port.to_tensor(i[::-1]
                                                               .copy()))
               .numpy(),
               getattr(P_ref.to_tensor(i), m)(P_ref.to_tensor(i[::-1]
                                                              .copy()))
               .numpy())
    _close((~P_port.to_tensor(i)).numpy(), (~P_ref.to_tensor(i)).numpy())


def test_scalar_operand_dtypes(cpu):
    """jnp's weak typing: a Python scalar keeps the tensor's dtype where
    the kinds agree."""
    for data, scalar in (([1, 2], 2), ([1.0, 2.0], 2), ([1, 2], 2.5)):
        for dt in ("int32", "float32", "float16"):
            arr = np.asarray(data).astype(dt)
            if np.issubdtype(arr.dtype, np.integer) != isinstance(data[0],
                                                                 int):
                continue
            r = P_ref.to_tensor(arr) * scalar
            p = P_port.to_tensor(arr) * scalar
            assert p.dtype.name == r.dtype.name, (data, scalar, dt)


def test_inplace_rebinds_and_keeps_the_old_value_for_backward(cpu):
    for P in (P_ref, P_port):
        x = P.to_tensor([1.0, 2.0], stop_gradient=False)
        h = x * 3.0
        y = h * h
        h.add_(P.to_tensor([10.0, 10.0]))     # rebinds h; y keeps its input
        assert h.numpy().tolist() == [13.0, 16.0]
        (y.sum() + h.sum()).backward()
        _close(x.grad.numpy(), 18 * np.array([1.0, 2.0]) + 3)
    t = P_port.to_tensor([1.0, 4.0])
    t.sqrt_()
    t.scale_(2.0)
    assert t.numpy().tolist() == [2.0, 4.0]


def test_inplace_on_a_leaf_that_requires_grad_raises(cpu):
    for P in (P_ref, P_port):
        w = P.to_tensor([1.0, 2.0], stop_gradient=False)
        with pytest.raises(RuntimeError, match="leaf Tensor"):
            w.add_(P.to_tensor([1.0, 1.0]))
        with pytest.raises(RuntimeError, match="leaf Tensor"):
            w[0] = 5.0
        with P.no_grad():
            w.add_(P.to_tensor([1.0, 1.0]))
        assert w.numpy().tolist() == [2.0, 3.0] and not w.stop_gradient
        (w * w).sum().backward()
        assert w.grad.numpy().tolist() == [4.0, 6.0]


def test_stop_gradient_after_inplace(cpu):
    """``stop_gradient`` after an in-place op is ``out.stop_gradient and
    self.stop_gradient``."""
    for P in (P_ref, P_port):
        a = P.to_tensor([1.0])
        b = P.to_tensor([2.0], stop_gradient=False)
        a.add_(b)
        assert not a.stop_gradient
        c = P.to_tensor([1.0])
        c.add_(P.to_tensor([2.0]))
        assert c.stop_gradient


@pytest.mark.parametrize("index", [
    1, (slice(None), 2), (slice(1, None), slice(None, 2)),
    (Ellipsis, 0), (None, 1), (slice(None, None, -1),),
    ([0, 2],), (slice(None), [3, 1]),
])
def test_getitem_and_setitem(cpu, index):
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    r, p = P_ref.to_tensor(x), P_port.to_tensor(x)
    _close(p[index].numpy(), r[index].numpy())
    r2, p2 = P_ref.to_tensor(x), P_port.to_tensor(x)
    r2[index] = -1.0
    p2[index] = -1.0
    _close(p2.numpy(), r2.numpy())


def test_tensor_index_and_gradient_through_getitem(cpu):
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for P in (P_ref, P_port):
        t = P.to_tensor(x, stop_gradient=False)
        idx = P.to_tensor(np.array([2, 0]))
        (t[idx] * 2.0).sum().backward()
        _close(t.grad.numpy(), np.array([[2] * 4, [0] * 4, [2] * 4]))
        m = P.to_tensor(x > 5)
        assert t[m].shape == [6]


def test_dtype_module(cpu):
    from paddle_tpu.core import dtype as rd
    from paddle_tpu_torch.core import dtype as pd

    names = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16",
             "bfloat16", "float32", "float64", "complex64"]
    for n in names:
        assert pd.convert_dtype(n).name == rd.convert_dtype(n).name
        for q in ("is_floating_point", "is_integer", "is_complex"):
            assert getattr(pd, q)(n) == getattr(rd, q)(n), (q, n)
    for a in names:
        for b in names:
            assert pd.promote_types(a, b).name == \
                rd.promote_types(a, b).name, (a, b)
    assert pd.convert_dtype(float) is pd.float32
    assert pd.convert_dtype(int) is pd.int64
    assert pd.convert_dtype(np.dtype("float16")) is pd.float16
    assert pd.convert_dtype(torch.bfloat16) is pd.bfloat16
    assert pd.to_torch("fp32") is torch.float32
    with pytest.raises(ValueError):
        pd.convert_dtype("float8")
    pd.set_default_dtype("float16")
    try:
        assert pd.get_default_dtype() is pd.float16
        assert P_port.zeros([2]).dtype == P_port.float16
    finally:
        pd.set_default_dtype("float32")
    with pytest.raises(TypeError):
        pd.set_default_dtype("int32")


def test_flags_check_nan_inf(cpu):
    for P in (P_ref, P_port):
        P.set_flags({"FLAGS_check_nan_inf": True})
        try:
            assert P.get_flags("check_nan_inf") == {"check_nan_inf": True}
            with pytest.raises(FloatingPointError, match="log"):
                P.log(P.to_tensor([-1.0]))
        finally:
            P.set_flags({"check_nan_inf": False})
        assert P.log(P.to_tensor([-1.0])).numpy().size == 1
    # the core flags (the JAX package's other modules define more)
    assert set(P_port.get_flags()) == {
        "check_nan_inf", "eager_vjp", "use_bfloat16_default",
        "allocator_strategy", "log_level"} <= set(P_ref.get_flags())


def test_registry_rules(cpu):
    with pytest.raises(TypeError):
        P_port.add(P_port.to_tensor([1.0]), P_port.to_tensor([1.0]), z=1)
    with pytest.raises(RuntimeError, match="no emitter"):
        port_registry.build_registry([{"op": "no_such_op"}])
    assert P_port.add._opdef.tensor_args == ("x", "y")
    assert not hasattr(P_port, "flash_attention")
    assert set(P_port.nn.functional.__all__) >= {
        "relu", "cross_entropy", "flash_attention", "flash_attn_unpadded",
        "scaled_dot_product_attention", "rms_norm"}


def test_import_touches_no_card():
    import subprocess
    import sys

    code = ("import paddle_tpu_torch as p, torch\n"
            "print(torch.cuda.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_registry_losses_give_the_llama_criterion(cpu):
    """The registry's ``softmax_with_cross_entropy`` (mean over every
    position) and ``cross_entropy`` (f32 logits) give what the port's
    ``LlamaPretrainingCriterion`` gives, in f32 and from bf16 logits."""
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion

    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int64)
    labels[0, 1] = -100
    crit = LlamaPretrainingCriterion()
    for dt in ("float32", "bfloat16"):
        lt = P_port.to_tensor(logits, dtype=dt)
        want = crit(lt._data, torch.from_numpy(labels))
        got = P_port.nn.functional.softmax_with_cross_entropy(
            lt, P_port.to_tensor(labels)).mean()
        assert got.dtype == P_port.float32
        assert torch.equal(got._data, want), dt
        ce = P_port.nn.functional.cross_entropy(
            lt.astype("float32"), P_port.to_tensor(labels),
            reduction="sum") / float(labels.size)
        np.testing.assert_allclose(ce.numpy(), want.numpy(), rtol=1e-6)
