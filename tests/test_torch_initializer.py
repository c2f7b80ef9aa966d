"""The port's initializers (``paddle_tpu_torch/nn/initializer.py``)
against the JAX package's under one seed, each as its own case: shape
and dtype (f32 and bf16: drawn in f32, then cast), the values, and the
keys spent (one per random initializer, none otherwise). Bit-identical:
``Constant``, ``Uniform``, ``XavierUniform``, ``KaimingUniform``
(threefry bits through the uniform transform), ``Assign``, ``Dirac``,
``Bilinear``. Within rtol 1e-5 (atol 1e-5 of the scale): the normal ones
(the same uniforms through XLA's ``erf_inv`` polynomial, torch's
``log1p`` inside) and ``Orthogonal`` (LAPACK's QR against XLA's)."""
import math

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.nn import initializer as J
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.nn import initializer as T


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = (port_place._current_place, port_place._current_device)
    tpaddle.set_device("cpu")
    yield
    port_place._current_place, port_place._current_device = prev


_VALUE = np.arange(24, dtype=np.float32).reshape(4, 6) / 7.0

# (id, class name, args, kwargs, shape, exact, keys)
CASES = [
    ("Constant", "Constant", (0.25,), {}, [3, 4], True, 0),
    ("Uniform", "Uniform", (-0.3, 0.8), {}, [5, 7], True, 1),
    ("XavierUniform", "XavierUniform", (), {}, [64, 32], True, 1),
    ("XavierUniform_fans", "XavierUniform", (), {"fan_in": 10,
                                                 "fan_out": 30,
                                                 "gain": 2.0},
     [6, 5], True, 1),
    ("XavierUniform_conv", "XavierUniform", (), {}, [8, 4, 3, 3], True, 1),
    ("KaimingUniform", "KaimingUniform", (), {}, [16, 8, 3], True, 1),
    ("KaimingUniform_leaky", "KaimingUniform", (),
     {"negative_slope": 0.2, "nonlinearity": "leaky_relu"}, [20, 10],
     True, 1),
    ("KaimingUniform_fan_in", "KaimingUniform", (), {"fan_in": 50},
     [7], True, 1),
    ("Normal", "Normal", (0.5, 2.0), {}, [40, 30], False, 1),
    ("TruncatedNormal", "TruncatedNormal", (0.1, 0.02), {}, [50, 20],
     False, 1),
    ("TruncatedNormal_ab", "TruncatedNormal", (), {"a": -1.0, "b": 3.0},
     [300], False, 1),
    ("XavierNormal", "XavierNormal", (), {}, [32, 48], False, 1),
    ("KaimingNormal", "KaimingNormal", (), {"nonlinearity": "tanh"},
     [12, 6, 2, 2], False, 1),
    ("Orthogonal", "Orthogonal", (1.5,), {}, [6, 10], False, 1),
    ("Orthogonal_tall", "Orthogonal", (), {}, [12, 3, 2], False, 1),
    ("Assign", "Assign", (_VALUE,), {}, [4, 6], True, 0),
    ("Dirac", "Dirac", (), {"groups": 2}, [4, 3, 3, 3], True, 0),
    ("Bilinear", "Bilinear", (), {}, [3, 3, 4, 4], True, 0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_initializer_matches_reference(case, dtype):
    _, name, args, kw, shape, exact, keys = case
    jpaddle.seed(31)
    ref = np.asarray(getattr(J, name)(*args, **kw)(shape, dtype))
    tpaddle.seed(31)
    got = getattr(T, name)(*args, **kw)(shape, dtype)
    assert tpaddle.get_rng_state() == jpaddle.get_rng_state() == (31, keys)
    assert list(got.shape) == list(ref.shape) == list(shape)
    assert str(got.dtype) == "torch." + str(ref.dtype) == "torch." + dtype
    a, b = ref.astype(np.float32), got.float().numpy()
    if exact:
        np.testing.assert_array_equal(b, a)
    else:
        scale = float(np.abs(a).max())
        tol = 1e-5 if dtype == "float32" else 1e-2
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol * scale)


def test_calculate_gain_and_global_initializer():
    for nl in ("sigmoid", "linear", "conv2d", "tanh", "relu", "leaky_relu",
               "selu", "other"):
        assert T.calculate_gain(nl) == J.calculate_gain(nl), nl
    assert T.calculate_gain("leaky_relu", 0.3) == \
        J.calculate_gain("leaky_relu", 0.3) == math.sqrt(2 / 1.09)
    for mod in (T, J):
        mod.set_global_initializer(mod.Constant(1.0), mod.Constant(2.0))
        assert set(mod._GLOBAL_INITIALIZER) == {"weight", "bias"}
        mod.set_global_initializer(mod.Constant(3.0))
        assert set(mod._GLOBAL_INITIALIZER) == {"weight"}
        mod.set_global_initializer(None)
        assert mod._GLOBAL_INITIALIZER == {}
