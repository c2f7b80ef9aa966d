"""The cases of the op parity sweep (``tests/test_torch_ops_parity*.py``):
one or more per ported ``ops.yaml`` entry, each tagged with its manifest
section, and :func:`check_case`, which drives one through both packages.

Seeded numpy inputs go through ``paddle_tpu``'s registry op and
``paddle_tpu_torch``'s, as Tensors; the outputs must agree in value and
dtype, and for a ``diff: true`` op the gradient of a seeded cotangent
(``backward(out, c)`` in each package) must agree for every floating
input. Tolerances: rtol 1e-5, atol 1e-6 in f32, except the ops in
``_LOOSE`` (each with its reason).

Random ops: both packages are seeded with the case's seed before its
call (``paddle.seed``), so a drawing op must give the reference's draws:
``rand``, ``uniform``, ``randint``, ``randperm``, ``shuffle``,
``bernoulli`` and the ``dropout`` masks bit for bit (compared at the
tolerance like any op, their values being equal), the others
(``randn``, ``normal``, ``poisson``, ``exponential``, ``multinomial``,
``gumbel_softmax``) through the same uniforms with transcendentals that
may differ in the last bits, inside the same tolerance.

Dtypes: the port keeps int64 (by design, ROADMAP queue 3), so where the
JAX package gives int32 for an int64 input or for an index result, the
port's int64 is the match; everywhere else the dtypes are equal.

``qr``, ``svd``, ``eigh`` and ``lu`` are unique only up to signs and
permutations: their cases compare what the factors reconstruct and the
invariants, and take gradients through those.
"""
import zlib

import numpy as np
import pytest

import paddle_tpu as P_ref
import paddle_tpu.ops.pallas.flash_attention  # noqa: F401  (its op)
import paddle_tpu_torch as P_port
from paddle_tpu.ops import registry as ref_registry
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.ops import registry as port_registry

RTOL, ATOL = 1e-5, 1e-6
# ops that need more than rtol 1e-5 / atol 1e-6, and why
_LOOSE = {
    # LAPACK vs XLA:CPU's own decompositions and solvers: different
    # algorithms, so errors of order cond(A) * eps
    **{op: (1e-4, 1e-5) for op in (
        "cholesky", "qr", "svd", "eigh", "eigvalsh", "inverse", "pinv",
        "det", "slogdet", "solve", "triangular_solve", "lstsq", "lu",
        "cond", "matrix_power", "householder_product", "multi_dot",
        "corrcoef", "cov")},
    # convolutions, pools and resampling: different accumulation orders
    **{op: (1e-4, 1e-5) for op in (
        "conv1d", "conv2d", "conv3d", "conv2d_transpose", "interpolate",
        "unfold", "local_response_norm", "avg_pool1d", "avg_pool2d",
        "adaptive_avg_pool2d")},
    # special functions: torch's and XLA's series differ in the last bits
    **{op: (1e-4, 1e-5) for op in ("digamma", "lgamma", "erfinv")},
    # sums over a few hundred terms added in another order
    **{op: (1e-5, 1e-5) for op in (
        "logsumexp", "var", "std", "norm", "dist", "kron", "inner",
        "matmul", "bmm", "mv", "dot", "linear", "cumprod", "prod")},
}

# ops whose results are indices: jnp gives int32, the port int64
_INDEX = {"argmax", "argmin", "argsort", "topk", "nonzero", "unique",
          "searchsorted", "count_nonzero", "numel", "bincount",
          "tril_indices", "triu_indices", "matrix_rank", "arange",
          "lstsq", "sum", "cumsum", "nansum", "where", "randint",
          "randperm", "multinomial", "kthvalue", "mode",
          "unique_consecutive", "fractional_max_pool2d"}


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = (port_place._current_place, port_place._current_device)
    P_port.set_device("cpu")
    yield
    port_place._current_place, port_place._current_device = prev


class C:
    """One case: ``make(rng) -> (args, kwargs)``; numpy arrays among the
    args (and kwargs values) become Tensors, a :class:`Bf16` one a bf16
    Tensor. ``post(P, out)`` maps the outputs to what is compared (and
    differentiated), in package ``P``; ``tol`` overrides the op's
    (rtol, atol)."""

    def __init__(self, op, make, grad=True, post=None, name=None,
                 tol=None):
        self.op = op
        self.make = make
        self.grad = grad
        self.post = post
        self.id = name or op
        self.tol = tol


class Bf16:
    """An f32 array that goes in as a bf16 Tensor (both packages round
    it to nearest even)."""

    def __init__(self, array):
        self.array = array


# bf16 results of the two packages: one bf16 ulp apart at most where an
# f32 intermediate lands near a rounding boundary
BF16_TOL = (1e-2, 1e-2)


def f(rng, *shape, lo=None, hi=None):
    if lo is None:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def pos(rng, *shape):
    return f(rng, *shape, lo=0.5, hi=2.0)


def unit(rng, *shape):
    return f(rng, *shape, lo=-0.9, hi=0.9)


def ints(rng, lo, hi, *shape):
    return rng.integers(lo, hi, shape).astype(np.int64)


def spd(rng, n):
    a = f(rng, n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def A(*args, **kw):
    return lambda rng: (args, kw)


def X(fn, **kw):
    """args from a function of rng."""
    return lambda rng: (fn(rng), kw)

# ---------------------------------------------------------------------------
CASES = []
SECTION = None


def add(op, make, **kw):
    case = C(op, make, **kw)
    case.section = SECTION
    CASES.append(case)


# binary math
SECTION = "binary math"
for op in ("add", "subtract", "multiply", "maximum", "minimum", "fmax",
           "fmin", "atan2", "hypot", "logaddexp"):
    add(op, X(lambda r: [f(r, 3, 4), f(r, 4)]))
add("divide", X(lambda r: [f(r, 3, 4), pos(r, 3, 4)]))
add("add", X(lambda r: [ints(r, -5, 5, 3, 4), ints(r, -5, 5, 4)]),
    name="add_int64")
add("add", X(lambda r: [ints(r, -5, 5, 3).astype(np.int32), 2.5]),
    name="add_int32_pyfloat")
add("multiply", X(lambda r: [f(r, 3), 3]), name="multiply_scalar")
add("divide", X(lambda r: [ints(r, 1, 9, 4), ints(r, 1, 9, 4)]),
    name="divide_int")
add("floor_divide", X(lambda r: [f(r, 3, 4), pos(r, 3, 4)]))
add("floor_divide", X(lambda r: [ints(r, -9, 9, 6), ints(r, 1, 4, 6)]),
    name="floor_divide_int")
add("remainder", X(lambda r: [f(r, 3, 4) * 3, pos(r, 3, 4)]))
add("remainder", X(lambda r: [ints(r, -9, 9, 6), ints(r, 1, 4, 6)]),
    name="remainder_int")
add("elementwise_pow", X(lambda r: [pos(r, 3, 4), f(r, 3, 4)]))
add("pow", X(lambda r: [pos(r, 3, 4), f(r, 3, 4)]))
add("pow", X(lambda r: [f(r, 5), 3]), name="pow_int_exponent")
add("heaviside", X(lambda r: [np.array([-1.0, 0.0, 2.0, 0.0], np.float32),
                              f(r, 4)]))
add("gcd", X(lambda r: [ints(r, -20, 20, 6), ints(r, 1, 20, 6)]),
    grad=False)
add("lcm", X(lambda r: [ints(r, 1, 20, 6), ints(r, 1, 20, 6)]),
    grad=False)
add("inner", X(lambda r: [f(r, 2, 3), f(r, 4, 3)]))
add("outer", X(lambda r: [f(r, 3), f(r, 4)]))
add("kron", X(lambda r: [f(r, 2, 2), f(r, 3, 2)]))

# unary math
SECTION = "unary math"
for op in ("exp", "expm1", "abs", "neg", "sign", "floor", "ceil", "round",
           "trunc", "frac", "sin", "cos", "tan", "atan", "sinh", "cosh",
           "tanh", "asinh", "erf", "square", "isnan", "isinf", "isfinite",
           "angle", "conj", "real", "imag", "nan_to_num"):
    add(op, X(lambda r: [f(r, 3, 4) * 2]))
for op in ("log", "log2", "log10", "log1p", "sqrt", "rsqrt", "digamma",
           "lgamma", "reciprocal"):
    add(op, X(lambda r: [pos(r, 3, 4)]))
for op in ("asin", "acos", "atanh", "erfinv"):
    add(op, X(lambda r: [unit(r, 3, 4)]))
add("acosh", X(lambda r: [pos(r, 3, 4) + 1.0]))
add("logit", X(lambda r: [f(r, 3, 4, lo=0.05, hi=0.95)]))
add("logit", X(lambda r: [f(r, 3, 4, lo=0.0, hi=1.0)], eps=0.1),
    name="logit_eps")
add("clip", X(lambda r: [f(r, 3, 4)], min=-0.5, max=0.7))
add("scale", X(lambda r: [f(r, 3, 4)], scale=2.5, bias=1.0))
add("scale", X(lambda r: [f(r, 3, 4)], scale=2.5, bias=1.0,
               bias_after_scale=False), name="scale_bias_first")
add("lerp", X(lambda r: [f(r, 3, 4), f(r, 3, 4), f(r, 3, 4, lo=0, hi=1)]))
add("nan_to_num", X(lambda r: [np.array([np.nan, np.inf, -np.inf, 1.5],
                                        np.float32)]), grad=False,
    name="nan_to_num_nonfinite")
add("isnan", X(lambda r: [np.array([np.nan, 1.0, np.inf], np.float32)]),
    name="isnan_nan")
for op in ("angle", "conj", "real", "imag", "abs", "exp"):
    add(op, X(lambda r: [(f(r, 5) + 1j * f(r, 5)).astype(np.complex64)]),
        grad=False, name=op + "_complex")
add("trace", X(lambda r: [f(r, 4, 5)], offset=1))
add("trace", X(lambda r: [ints(r, 0, 9, 3, 3).astype(np.int32)]),
    name="trace_int32")
add("diagonal", X(lambda r: [f(r, 3, 4, 5)], offset=-1, axis1=1, axis2=2))

# reductions
SECTION = "reductions"
for op in ("sum", "mean", "max", "min", "amax", "amin", "prod", "logsumexp",
           "var", "std", "nanmean", "nansum"):
    add(op, X(lambda r: [f(r, 3, 4, 5)], axis=1))
    add(op, X(lambda r: [f(r, 3, 4)], axis=[0, 1], keepdim=True),
        name=op + "_all_keepdim")
add("sum", X(lambda r: [ints(r, 0, 9, 3, 4).astype(np.int32)], axis=0),
    name="sum_int32")
add("sum", X(lambda r: [ints(r, 0, 9, 3, 4)]), name="sum_int64")
add("sum", X(lambda r: [f(r, 3, 4)], dtype="float16"), grad=False,
    name="sum_dtype")
add("mean", X(lambda r: [ints(r, 0, 9, 3, 4).astype(np.int32)]),
    name="mean_int")
add("var", X(lambda r: [f(r, 6, 3)], axis=0, unbiased=False),
    name="var_biased")
add("prod", X(lambda r: [ints(r, 1, 4, 3, 4).astype(np.int32)], axis=1),
    name="prod_int32")
add("all", X(lambda r: [f(r, 3, 4) > 0], axis=1))
add("any", X(lambda r: [f(r, 3, 4) > 0]))
add("any", X(lambda r: [f(r, 3, 4) > 0], axis=[0, 1], keepdim=True),
    name="any_keepdim")
add("cumsum", X(lambda r: [f(r, 3, 4)], axis=1))
add("cumsum", X(lambda r: [f(r, 3, 4)]), name="cumsum_flat")
add("cumsum", X(lambda r: [ints(r, 0, 9, 6).astype(np.int32)]),
    name="cumsum_int32")
add("cumprod", X(lambda r: [pos(r, 3, 4)], dim=1))
add("cummax", X(lambda r: [f(r, 3, 6)], axis=1))
add("cummin", X(lambda r: [f(r, 3, 6)], axis=0))
add("argmax", X(lambda r: [f(r, 3, 4)], axis=1))
add("argmax", X(lambda r: [f(r, 3, 4)]), name="argmax_flat")
add("argmin", X(lambda r: [f(r, 3, 4)], axis=0, keepdim=True))
add("median", X(lambda r: [f(r, 4, 6)], axis=1))
add("median", X(lambda r: [f(r, 3, 5)]), name="median_flat_odd")
add("quantile", X(lambda r: [f(r, 4, 6)], q=0.3, axis=1))
add("quantile", X(lambda r: [f(r, 4, 6)], q=np.array([0.1, 0.75],
                                                      np.float32),
                  axis=0, keepdim=True), name="quantile_list_keepdim")
add("nanmean", X(lambda r: [np.where(f(r, 3, 4) > 1, np.nan,
                                     f(r, 3, 4)).astype(np.float32)],
                 axis=1), grad=False, name="nanmean_nan")
add("count_nonzero", X(lambda r: [ints(r, 0, 3, 3, 4)], axis=1,
                       keepdim=True))

# creation
SECTION = "creation"
add("zeros", A([2, 3]))
add("ones", A([2, 3], dtype="int32"))
add("full", A([2, 3], 1.5))
add("full", A([2], 7, dtype="int64"), name="full_int")
add("empty", A([2, 3]))
for op in ("zeros_like", "ones_like", "empty_like"):
    add(op, X(lambda r: [f(r, 2, 3)]))
add("full_like", X(lambda r: [f(r, 2, 3), 2.5]))
add("ones_like", X(lambda r: [f(r, 2, 3)], dtype="int32"),
    name="ones_like_dtype")
add("arange", A(5))
add("arange", A(0.5, 3.0, 0.5), name="arange_float")
add("arange", A(1, 10, 3, dtype="float32"), name="arange_dtype")
add("linspace", A(0.0, 1.0, 7))
add("logspace", A(0.0, 2.0, 5))
add("eye", A(3, 4))
add("diag", X(lambda r: [f(r, 4)], offset=1))
add("diag", X(lambda r: [f(r, 4, 4)]), name="diag_of_matrix")
add("diagflat", X(lambda r: [f(r, 2, 2)], offset=-1))
add("tril", X(lambda r: [f(r, 4, 5)], diagonal=1))
add("triu", X(lambda r: [f(r, 4, 5)], diagonal=-1))
add("assign", X(lambda r: [f(r, 3, 4)]))
add("meshgrid", X(lambda r: [[f(r, 3), f(r, 4)]]))
add("tril_indices", A(4, 5, 1))
add("triu_indices", A(4, 5, -1))
add("complex", X(lambda r: [f(r, 4), f(r, 4)]), grad=False)
add("polar", X(lambda r: [pos(r, 4), f(r, 4)]), grad=False)

# logic / compare
SECTION = "logic / compare"
for op in ("equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal"):
    add(op, X(lambda r: [ints(r, 0, 3, 3, 4), ints(r, 0, 3, 4)]))
    add(op, X(lambda r: [f(r, 3, 4), 0.1]), name=op + "_scalar")
for op in ("logical_and", "logical_or", "logical_xor"):
    add(op, X(lambda r: [f(r, 3, 4) > 0, f(r, 3, 4) > 0]))
add("logical_not", X(lambda r: [f(r, 3, 4) > 0]))
for op in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    add(op, X(lambda r: [ints(r, 0, 64, 5).astype(np.int32),
                         ints(r, 0, 64, 5).astype(np.int32)]))
add("bitwise_not", X(lambda r: [ints(r, -9, 9, 5).astype(np.int32)]))
add("bitwise_not", X(lambda r: [f(r, 5) > 0]), name="bitwise_not_bool")
add("where", X(lambda r: [f(r, 3, 4) > 0, f(r, 3, 4), f(r, 3, 4)]))
add("where", X(lambda r: [f(r, 3, 4) > 0, 1.0, 0.0]), name="where_scalars")
add("isclose", X(lambda r: [np.array([1.0, 1.0 + 1e-6, 2.0], np.float32),
                            np.array([1.0, 1.0, 2.1], np.float32)]))
add("allclose", X(lambda r: [np.array([1.0, 1.0 + 1e-6], np.float32),
                             np.array([1.0, 1.0], np.float32)]))
add("equal_all", X(lambda r: [ints(r, 0, 2, 4), ints(r, 0, 2, 4)]))

# manipulation
SECTION = "manipulation"
add("cast", X(lambda r: [f(r, 3, 4) * 4, "int32"]))
add("cast", X(lambda r: [f(r, 3, 4), "float16"]), name="cast_f16")
add("reshape", X(lambda r: [f(r, 3, 4), [2, -1]]))
add("flatten", X(lambda r: [f(r, 2, 3, 4)], start_axis=1))
add("squeeze", X(lambda r: [f(r, 1, 3, 1)], axis=[0, 2]))
add("squeeze", X(lambda r: [f(r, 1, 3, 1)]), name="squeeze_all")
add("unsqueeze", X(lambda r: [f(r, 3, 4)], axis=[0, -1]))
add("transpose", X(lambda r: [f(r, 2, 3, 4), [2, 0, 1]]))
add("moveaxis", X(lambda r: [f(r, 2, 3, 4), 0, 2]))
add("swapaxes", X(lambda r: [f(r, 2, 3, 4), 0, 2]))
add("concat", X(lambda r: [[f(r, 2, 3), f(r, 4, 3)]], axis=0))
add("stack", X(lambda r: [[f(r, 2, 3), f(r, 2, 3)]], axis=1))
add("split", X(lambda r: [f(r, 6, 4), 3]))
add("split", X(lambda r: [f(r, 6, 4), [1, -1, 2]], axis=0),
    name="split_sections")
add("chunk", X(lambda r: [f(r, 7, 4), 3]))
add("unbind", X(lambda r: [f(r, 3, 4)], axis=1))
add("tile", X(lambda r: [f(r, 2, 3), [2, 1, 2]]))
add("expand", X(lambda r: [f(r, 3, 1), [2, -1, 4]]))
add("expand_as", X(lambda r: [f(r, 3, 1), f(r, 3, 4)]))
add("broadcast_to", X(lambda r: [f(r, 1, 4), [3, 4]]))
add("broadcast_tensors", X(lambda r: [[f(r, 3, 1), f(r, 1, 4)]]))
add("gather", X(lambda r: [f(r, 5, 3), ints(r, 0, 5, 2, 4)], axis=0))
add("gather_nd", X(lambda r: [f(r, 4, 5, 2), ints(r, 0, 4, 3, 2)]))
add("scatter", X(lambda r: [f(r, 5, 3), np.array([3, 0], np.int64),
                            f(r, 2, 3)]))
add("scatter", X(lambda r: [f(r, 5, 3), np.array([3, 0, 3], np.int64),
                            f(r, 3, 3)], overwrite=False),
    name="scatter_add")
add("scatter_nd_add", X(lambda r: [f(r, 4, 3), np.array([[1], [3], [1]]),
                                   f(r, 3, 3)]))
add("index_select", X(lambda r: [f(r, 5, 3), ints(r, 0, 3, 4)], axis=1))
add("index_sample", X(lambda r: [f(r, 3, 5), ints(r, 0, 5, 3, 2)]))
add("index_add", X(lambda r: [f(r, 5, 3), np.array([0, 2, 2]), 0,
                              f(r, 3, 3)]))
add("index_put", X(lambda r: [f(r, 4, 5), (np.array([0, 3]),
                                           np.array([1, 4])), f(r, 2)]))
add("index_put", X(lambda r: [f(r, 4, 5), (np.array([0, 0]),
                                           np.array([1, 1])), f(r, 2)],
                   accumulate=True), name="index_put_accumulate")
add("take_along_axis", X(lambda r: [f(r, 3, 5), ints(r, 0, 5, 3, 2), 1]))
add("put_along_axis", X(lambda r: [f(r, 3, 5), np.array([[1], [0], [4]]),
                                   f(r, 3, 1), 1]))
add("put_along_axis", X(lambda r: [f(r, 3, 5), np.array([[1, 1], [0, 2],
                                                         [4, 3]]),
                                   f(r, 3, 2), 1], reduce="add"),
    name="put_along_axis_add")
add("put_along_axis", X(lambda r: [f(r, 3, 5), np.array([[1], [0], [4]]),
                                   f(r, 3, 1), 1], reduce="mul"),
    grad=False, name="put_along_axis_mul")   # jax: no scatter_mul vjp
add("masked_select", X(lambda r: [f(r, 3, 4), f(r, 3, 4) > 0]))
add("masked_fill", X(lambda r: [f(r, 3, 4), f(r, 3, 4) > 0, 0.5]))
add("masked_scatter", X(lambda r: [f(r, 3, 4), f(r, 3, 4) > 0,
                                   f(r, 12)]))
add("graph_send_recv", X(lambda r: [f(r, 5, 3), np.array([0, 1, 2, 4]),
                                    np.array([1, 1, 0, 3])]))
for red in ("mean", "max", "min"):
    add("graph_send_recv", X(lambda r: [f(r, 5, 3), np.array([0, 1, 2, 4]),
                                        np.array([1, 1, 0, 3])],
                             reduce_op=red), name="graph_send_recv_" + red)
add("graph_send_ue_recv", X(lambda r: [f(r, 5, 3), f(r, 4, 3),
                                       np.array([0, 1, 2, 4]),
                                       np.array([1, 1, 0, 3])],
                            message_op="mul", out_size=6))
add("graph_send_uv", X(lambda r: [f(r, 5, 3), f(r, 5, 3),
                                  np.array([0, 1, 2, 4]),
                                  np.array([1, 1, 0, 3])],
                       message_op="sub"))
add("flip", X(lambda r: [f(r, 3, 4), [0, 1]]))
add("rot90", X(lambda r: [f(r, 3, 4)], k=3))
add("roll", X(lambda r: [f(r, 3, 4), 2], axis=1))
add("roll", X(lambda r: [f(r, 3, 4), -3]), name="roll_flat")
add("repeat_interleave", X(lambda r: [f(r, 3, 2), 2], axis=0))
add("repeat_interleave", X(lambda r: [f(r, 3), np.array([1, 0, 2])],
                          axis=0),
    name="repeat_interleave_list")
add("pad", X(lambda r: [f(r, 2, 3, 4, 5), [1, 2, 0, 1]], value=0.5))
for mode in ("reflect", "replicate", "circular"):
    add("pad", X(lambda r: [f(r, 1, 2, 4, 5), [2, 1, 1, 3]], mode=mode),
        name="pad_" + mode)
add("topk", X(lambda r: [f(r, 3, 6), 2]))
add("topk", X(lambda r: [f(r, 6, 3), 2], axis=0, largest=False),
    name="topk_smallest")
add("sort", X(lambda r: [f(r, 3, 6)], axis=1, descending=True))
add("argsort", X(lambda r: [f(r, 3, 6)], axis=1, descending=True))
add("searchsorted", X(lambda r: [np.sort(f(r, 6)), f(r, 4)]))
add("searchsorted", X(lambda r: [np.array([1.0, 2.0, 2.0, 3.0], np.float32),
                                 np.array([2.0, 0.5, 3.0], np.float32)],
                      right=True), name="searchsorted_right")
add("nonzero", X(lambda r: [ints(r, 0, 2, 3, 4)]))
add("nonzero", X(lambda r: [ints(r, 0, 2, 5)], as_tuple=True),
    name="nonzero_tuple")
add("unique", X(lambda r: [ints(r, 0, 5, 10)], return_index=True,
                return_inverse=True, return_counts=True))
add("unique", X(lambda r: [ints(r, 0, 3, 6, 2)], return_inverse=True,
                axis=0), name="unique_axis")
add("one_hot", X(lambda r: [np.array([0, 2, 4, -1]), 4]))
add("numel", X(lambda r: [f(r, 3, 4)]))
add("shard_index", X(lambda r: [ints(r, 0, 20, 6), 20, 2, 1]))
add("getitem", X(lambda r: [f(r, 4, 5, 3), (slice(1, None), 2)]))
add("getitem", X(lambda r: [f(r, 4, 5), (slice(None, None, -2),
                                         slice(4, 0, -1))]),
    name="getitem_negative_steps")
add("getitem", X(lambda r: [f(r, 4, 5), (Ellipsis, None, [0, 3])]),
    name="getitem_ellipsis_list")
add("getitem", X(lambda r: [f(r, 4, 5), f(r, 4, 5) > 0]),
    name="getitem_mask")
add("setitem", X(lambda r: [f(r, 4, 5), f(r, 5), 2]))
add("setitem", X(lambda r: [f(r, 4, 5), 1.5, (slice(None, None, -2),)]),
    name="setitem_negative_step")
add("as_strided", X(lambda r: [f(r, 12), [3, 2], [2, 3]], offset=1))
add("diff", X(lambda r: [f(r, 3, 6)], n=2, axis=1))
add("bincount", X(lambda r: [ints(r, 0, 6, 20)], minlength=8))
add("bincount", X(lambda r: [ints(r, 0, 6, 20), pos(r, 20)]),
    grad=False, name="bincount_weights")
add("histogram", X(lambda r: [f(r, 50)], bins=7))
add("histogram", X(lambda r: [f(r, 50)], bins=4, min=-1, max=1),
    name="histogram_range")


# linalg
SECTION = "linalg"
def _recon_qr(P, out):
    q, r = out
    return [P.matmul(q, r), P.matmul(q, q.T), P.abs(P.diagonal(r))]


def _recon_svd(P, out):
    u, s, vh = out
    return [P.matmul(u * s.unsqueeze(0), vh), s]


def _recon_eigh(P, out):
    w, v = out
    return [P.matmul(v * w.unsqueeze(0), v.T), w]


def _recon_lu(P, out):
    lu, piv = out
    return [lu, piv]


add("matmul", X(lambda r: [f(r, 2, 3, 4), f(r, 4, 5)]))
add("matmul", X(lambda r: [f(r, 4, 3), f(r, 5, 4)], transpose_x=True,
                transpose_y=True), name="matmul_transposed")
add("matmul", X(lambda r: [f(r, 4), f(r, 4, 3)]), name="matmul_vec")
add("bmm", X(lambda r: [f(r, 2, 3, 4), f(r, 2, 4, 5)]))
add("dot", X(lambda r: [f(r, 3, 4), f(r, 3, 4)]))
add("mv", X(lambda r: [f(r, 3, 4), f(r, 4)]))
add("t", X(lambda r: [f(r, 3, 4)]))
add("norm", X(lambda r: [f(r, 3, 4)]))
add("norm", X(lambda r: [f(r, 3, 4)], p=1, axis=1), name="norm_p1")
add("norm", X(lambda r: [f(r, 3, 4)], p=3, axis=0, keepdim=True),
    name="norm_p3")
add("norm", X(lambda r: [f(r, 3, 4)], p=float("inf"), axis=1),
    name="norm_inf")
add("dist", X(lambda r: [f(r, 3, 4), f(r, 3, 4)], p=3))
add("cross", X(lambda r: [f(r, 4, 3), f(r, 4, 3)]))
add("cholesky", X(lambda r: [spd(r, 4)], upper=True))
add("qr", X(lambda r: [f(r, 5, 3)]), post=_recon_qr)
# the reference's svd and eigh return jnp's named tuples, which its
# engine's vjp cannot take a plain tuple cotangent for: no gradient to
# compare against (ROADMAP.md, Standing notes)
add("svd", X(lambda r: [f(r, 4, 3)]), post=_recon_svd, grad=False)
add("eigh", X(lambda r: [spd(r, 4)]), post=_recon_eigh, grad=False)
add("eigvalsh", X(lambda r: [spd(r, 4)]))
add("inverse", X(lambda r: [spd(r, 4)]))
add("pinv", X(lambda r: [f(r, 4, 3)]))
add("det", X(lambda r: [spd(r, 3)]))
add("slogdet", X(lambda r: [f(r, 3, 3)]))
add("matrix_rank", X(lambda r: [np.array([[1., 2.], [2., 4.]], np.float32)]))
add("matrix_power", X(lambda r: [f(r, 3, 3) / 2, 3]))
add("solve", X(lambda r: [spd(r, 4), f(r, 4, 2)]))
add("triangular_solve", X(lambda r: [np.triu(spd(r, 4)), f(r, 4, 2)]))
add("triangular_solve", X(lambda r: [np.triu(spd(r, 4)), f(r, 4, 2)],
                          transpose=True, unitriangular=True),
    name="triangular_solve_transposed")
add("lstsq", X(lambda r: [f(r, 6, 3), f(r, 6, 2)]))
add("lu", X(lambda r: [f(r, 4, 4)]), post=_recon_lu)
add("cond", X(lambda r: [spd(r, 3)]))
add("multi_dot", X(lambda r: [[f(r, 2, 3), f(r, 3, 4), f(r, 4, 2)]]))
add("householder_product", X(lambda r: [f(r, 4, 3), f(r, 3) / 2]))
add("corrcoef", X(lambda r: [f(r, 3, 6)]))
add("cov", X(lambda r: [f(r, 6, 3)], rowvar=False))

# activations
SECTION = "activations"
for op in ("relu", "relu6", "gelu", "sigmoid", "silu", "swish", "mish",
           "softplus", "softsign", "hardswish", "hardsigmoid", "hardtanh",
           "leaky_relu", "elu", "selu", "celu", "tanhshrink", "hardshrink",
           "softshrink", "thresholded_relu", "softmax", "log_softmax"):
    add(op, X(lambda r: [f(r, 3, 8) * 3]))
add("gelu", X(lambda r: [f(r, 3, 8)], approximate=True),
    name="gelu_tanh")
add("softplus", X(lambda r: [f(r, 3, 8) * 10], beta=2.0, threshold=5.0),
    name="softplus_threshold")
add("softmax", X(lambda r: [f(r, 3, 8)], axis=0), name="softmax_axis0")
add("prelu", X(lambda r: [f(r, 2, 3), f(r, 3)]))
add("glu", X(lambda r: [f(r, 3, 8)]))
add("gumbel_softmax", X(lambda r: [f(r, 3, 8)], temperature=0.5))
add("gumbel_softmax", X(lambda r: [f(r, 3, 8)], hard=True),
    name="gumbel_softmax_hard")

# nn: linear / embedding / conv / pool
SECTION = "nn: linear / embedding / conv / pool"
add("linear", X(lambda r: [f(r, 2, 3, 4), f(r, 4, 5), f(r, 5)]))
add("embedding", X(lambda r: [ints(r, 0, 6, 2, 3), f(r, 6, 4)]))
add("embedding", X(lambda r: [np.array([[0, 2, 2], [5, 0, 1]]), f(r, 6, 4)],
                   padding_idx=2), name="embedding_padding_idx")
add("conv2d", X(lambda r: [f(r, 2, 4, 7, 6), f(r, 6, 2, 3, 3), f(r, 6)],
                stride=[2, 1], padding=[1, 0, 2, 1], dilation=1, groups=2))
add("conv2d", X(lambda r: [f(r, 1, 3, 7, 7), f(r, 4, 3, 3, 3)], stride=2,
                padding="SAME"), name="conv2d_same")
add("conv1d", X(lambda r: [f(r, 2, 3, 9), f(r, 4, 3, 3), f(r, 4)],
                padding=2, dilation=2))
add("conv3d", X(lambda r: [f(r, 1, 2, 5, 5, 5), f(r, 3, 2, 2, 2, 2)],
                padding=1))
add("conv2d_transpose", X(lambda r: [f(r, 2, 4, 5, 5), f(r, 4, 3, 3, 3),
                                     f(r, 3)], stride=2, padding=1,
                          output_padding=1))
add("conv2d_transpose", X(lambda r: [f(r, 1, 4, 4, 4), f(r, 4, 1, 3, 3)],
                          stride=2, padding=[0, 1, 1, 0], groups=2),
    name="conv2d_transpose_groups")
add("max_pool2d", X(lambda r: [f(r, 2, 3, 7, 6), 3], stride=2, padding=1))
add("max_pool2d", X(lambda r: [f(r, 1, 2, 7, 7), 2], padding="SAME"),
    name="max_pool2d_same")
add("avg_pool2d", X(lambda r: [f(r, 2, 3, 7, 6), [3, 2]], stride=2,
                    padding=1))
add("avg_pool2d", X(lambda r: [f(r, 2, 3, 6, 6), 2], padding=1,
                    exclusive=False), name="avg_pool2d_inclusive")
add("max_pool1d", X(lambda r: [f(r, 2, 3, 9), 3], stride=2, padding=1))
add("avg_pool1d", X(lambda r: [f(r, 2, 3, 9), 3], stride=2, padding=1))
add("adaptive_avg_pool2d", X(lambda r: [f(r, 2, 3, 7, 6), [3, 4]]))
add("adaptive_max_pool2d", X(lambda r: [f(r, 2, 3, 7, 6), [3, 4]]))
add("adaptive_avg_pool2d", X(lambda r: [f(r, 2, 3, 8, 6), 2]),
    name="adaptive_avg_pool2d_divisible")
add("unfold", X(lambda r: [f(r, 2, 3, 6, 5), [2, 3]], strides=[2, 1],
                paddings=1, dilations=[1, 2]))
add("pixel_shuffle", X(lambda r: [f(r, 2, 8, 3, 3), 2]))
add("interpolate", X(lambda r: [f(r, 2, 3, 5, 4)], size=[8, 6],
                     mode="bilinear"))
add("interpolate", X(lambda r: [f(r, 2, 3, 8, 8)], size=[3, 5],
                     mode="bilinear"), name="interpolate_shrink")
add("interpolate", X(lambda r: [f(r, 2, 3, 5, 4)], scale_factor=2,
                     mode="nearest"), name="interpolate_nearest")
add("interpolate", X(lambda r: [f(r, 1, 2, 5, 4)], size=[7, 9],
                     mode="bicubic"), name="interpolate_bicubic")
add("interpolate", X(lambda r: [f(r, 1, 2, 5, 4)], size=[7, 9],
                     mode="bilinear", align_corners=True),
    name="interpolate_align_corners")

# normalization
SECTION = "nn: normalization"
add("batch_norm", X(lambda r: [f(r, 4, 3, 5), f(r, 3), pos(r, 3), f(r, 3),
                               f(r, 3)], training=True))
add("batch_norm", X(lambda r: [f(r, 4, 3, 2, 2), f(r, 3), pos(r, 3)]),
    name="batch_norm_eval")
add("layer_norm", X(lambda r: [f(r, 2, 3, 8), f(r, 8), f(r, 8)]))
add("layer_norm", X(lambda r: [f(r, 2, 3, 4)], normalized_shape=[3, 4]),
    name="layer_norm_2d")
add("rms_norm", X(lambda r: [f(r, 2, 3, 8), f(r, 8)]))
add("group_norm", X(lambda r: [f(r, 2, 6, 3, 2), 3, f(r, 6), f(r, 6)]))
add("instance_norm", X(lambda r: [f(r, 2, 3, 5, 4), f(r, 3), f(r, 3)]))
add("local_response_norm", X(lambda r: [f(r, 2, 6, 3, 3), 3]))
add("normalize", X(lambda r: [f(r, 3, 5)], p=3, axis=1))

# losses
SECTION = "losses"
add("cross_entropy", X(lambda r: [f(r, 6, 5), np.array([0, 4, 2, -100, 1,
                                                         3])]))
add("cross_entropy", X(lambda r: [f(r, 6, 5), ints(r, 0, 5, 6), pos(r, 5)],
                       label_smoothing=0.1), name="cross_entropy_weight")
add("cross_entropy", X(lambda r: [f(r, 4, 5), f(r, 4, 5, lo=0, hi=1)],
                       soft_label=True, reduction="sum"),
    name="cross_entropy_soft")
add("softmax_with_cross_entropy", X(lambda r: [f(r, 2, 3, 5),
                                               ints(r, 0, 5, 2, 3, 1)],
                                    return_softmax=True))
add("softmax_with_cross_entropy", X(lambda r: [f(r, 4, 5),
                                               np.array([1, -100, 4, 0])]),
    name="softmax_with_cross_entropy_ignore")
add("nll_loss", X(lambda r: [f(r, 5, 4), np.array([0, 3, -100, 1, 2]),
                             pos(r, 4)]))
add("binary_cross_entropy", X(lambda r: [f(r, 3, 4, lo=0.05, hi=0.95),
                                         f(r, 3, 4, lo=0, hi=1),
                                         pos(r, 3, 4)]))
add("binary_cross_entropy_with_logits", X(lambda r: [f(r, 3, 4),
                                                     f(r, 3, 4, lo=0, hi=1),
                                                     None, pos(r, 4)]))
for op in ("mse_loss", "l1_loss", "smooth_l1_loss", "hinge_loss"):
    add(op, X(lambda r: [f(r, 3, 4), f(r, 3, 4)]))
add("kl_div", X(lambda r: [f(r, 3, 4), f(r, 3, 4, lo=0.1, hi=1)],
                reduction="batchmean"))
add("margin_ranking_loss", X(lambda r: [f(r, 6), f(r, 6),
                                        np.sign(f(r, 6))], margin=0.1))
add("cosine_similarity", X(lambda r: [f(r, 3, 5), f(r, 3, 5)]))
add("cosine_embedding_loss", X(lambda r: [f(r, 4, 5), f(r, 4, 5),
                                          np.array([1, -1, 1, -1],
                                                   np.float32)],
                               margin=0.2))
add("sigmoid_focal_loss", X(lambda r: [f(r, 3, 4), f(r, 3, 4, lo=0, hi=1),
                                       np.array([5.0], np.float32)]))

# attention
SECTION = "attention"
add("scaled_dot_product_attention",
    X(lambda r: [f(r, 2, 5, 2, 8), f(r, 2, 5, 2, 8), f(r, 2, 5, 2, 8)],
      is_causal=True))
add("scaled_dot_product_attention",
    X(lambda r: [f(r, 2, 4, 2, 8), f(r, 2, 6, 2, 8), f(r, 2, 6, 2, 8),
                 f(r, 2, 2, 4, 6) > -0.5]), name="sdpa_bool_mask")
add("flash_attention", X(lambda r: [f(r, 1, 64, 2, 16), f(r, 1, 64, 2, 16),
                                    f(r, 1, 64, 2, 16)], causal=True))

# nn: dropout / sampling
SECTION = "nn: dropout / sampling"
add("dropout", X(lambda r: [f(r, 4, 6)], p=0.3))
add("dropout", X(lambda r: [f(r, 4, 6, 5)], p=0.5, axis=[0, 2]),
    name="dropout_axis")
add("dropout", X(lambda r: [f(r, 4, 6)], p=0.3, mode="downscale_in_infer"),
    name="dropout_downscale")
add("dropout", X(lambda r: [f(r, 4, 6)], p=0.3, training=False,
                 mode="downscale_in_infer"), name="dropout_infer")
add("dropout", X(lambda r: [Bf16(f(r, 4, 6))], p=0.2), tol=BF16_TOL,
    name="dropout_bf16")
add("bernoulli", X(lambda r: [f(r, 5, 7, lo=0.0, hi=1.0)]), grad=False)
add("multinomial", X(lambda r: [pos(r, 9)], num_samples=4))
add("multinomial", X(lambda r: [pos(r, 3, 9)], num_samples=2),
    name="multinomial_rows")
add("multinomial", X(lambda r: [pos(r, 9)], num_samples=6,
                     replacement=True), name="multinomial_replacement")

# random (its einsum and fft family draw nothing)
SECTION = "random"
add("rand", A([3, 4]))
add("rand", A([5, 6], dtype="bfloat16"), name="rand_bf16")
add("randn", A([40, 30]))
add("randint", A(-5, 20, [4, 6]))
add("randint", A(7, shape=[30]), name="randint_high_none")
add("uniform", A([3, 5], min=-0.3, max=2.0))
add("normal", A(1.0, 2.0, [4, 5]))
add("standard_normal", A([6, 4]))
add("randperm", A(20))
add("shuffle", X(lambda r: [f(r, 7)]))
add("shuffle", X(lambda r: [f(r, 6, 3)], axis=1), name="shuffle_axis1")
add("poisson", X(lambda r: [pos(r, 4, 5) * 4]))
add("poisson", X(lambda r: [f(r, 4, 5, lo=10.0, hi=60.0)]),
    name="poisson_rejection")
add("exponential", X(lambda r: [pos(r, 3, 4)], lam=2.0))
add("einsum", X(lambda r: [[f(r, 2, 3), f(r, 3, 4)], "ij,jk->ik"]))
add("einsum", X(lambda r: [[f(r, 2, 3, 3)], "bii->b"]),
    name="einsum_trace")
for op in ("fft", "ifft", "rfft", "ihfft"):
    add(op, X(lambda r: [f(r, 3, 8)]), grad=False)
add("irfft", X(lambda r: [f(r, 3, 5) + 1j * f(r, 3, 5)]), grad=False)
add("hfft", X(lambda r: [f(r, 3, 5) + 1j * f(r, 3, 5)], n=8), grad=False)
for op in ("fft2", "ifft2", "fftn", "ifftn", "rfft2", "rfftn"):
    add(op, X(lambda r: [f(r, 2, 4, 6)]), grad=False)
add("fft", X(lambda r: [f(r, 3, 8)], n=6, norm="ortho"), grad=False,
    name="fft_n_ortho")
for op in ("irfft2", "irfftn"):
    add(op, X(lambda r: [f(r, 2, 4, 4) + 1j * f(r, 2, 4, 4)]), grad=False)
add("fftshift", X(lambda r: [f(r, 4, 5)]))
add("ifftshift", X(lambda r: [f(r, 4, 5)], axes=[1]))

# bf16, the Llama path's dtype: the result dtypes must be the JAX
# package's (jnp's weak scalars, rms_norm and the loss computed in f32)
SECTION = "nn: normalization"
add("rms_norm", X(lambda r: [Bf16(f(r, 2, 3, 8)), Bf16(f(r, 8))]),
    tol=BF16_TOL, name="rms_norm_bf16")
SECTION = "losses"
add("softmax_with_cross_entropy",
    X(lambda r: [Bf16(f(r, 4, 7)), ints(r, 0, 7, 4, 1)]), tol=BF16_TOL,
    name="softmax_with_cross_entropy_bf16")
SECTION = "binary math"
add("multiply", X(lambda r: [Bf16(f(r, 3, 4)), 0.5]), tol=BF16_TOL,
    name="multiply_bf16_scalar")
add("add", X(lambda r: [Bf16(f(r, 3, 4)), f(r, 4)]), tol=BF16_TOL,
    name="add_bf16_f32")
SECTION = "linalg"
add("matmul", X(lambda r: [Bf16(f(r, 3, 16)), Bf16(f(r, 16, 5))]),
    tol=BF16_TOL, name="matmul_bf16")
SECTION = "activations"
add("silu", X(lambda r: [Bf16(f(r, 3, 8))]), tol=BF16_TOL,
    name="silu_bf16")
add("softmax", X(lambda r: [Bf16(f(r, 3, 8))]), tol=BF16_TOL,
    name="softmax_bf16")
SECTION = "nn: linear / embedding / conv / pool"
add("embedding", X(lambda r: [ints(r, 0, 6, 2, 3), Bf16(f(r, 6, 4))]),
    tol=BF16_TOL, name="embedding_bf16")

# the vision, long-tail and nn long tail sections: one table, shared with
# the card's check (chip_smoke.py phase 24), in
# paddle_tpu_torch/tools/long_tail_cases.py
from paddle_tpu_torch.tools import long_tail_cases as _lt  # noqa: E402

VISION, LONG_TAIL, NN_TAIL = _lt.VISION, _lt.LONG_TAIL, _lt.NN_TAIL
for _c in _lt.CASES:
    SECTION = _c.section
    add(_c.op, _c.make, grad=_c.grad, post=_c.post, name=_c.id, tol=_c.tol)


def _to(P, v, diff):
    if isinstance(v, Bf16):
        return P.to_tensor(v.array, dtype="bfloat16", stop_gradient=not diff)
    if isinstance(v, np.ndarray):
        sg = not (diff and v.dtype == np.float32)
        return P.to_tensor(v, stop_gradient=sg)
    if isinstance(v, list) and v and all(isinstance(a, np.ndarray)
                                         for a in v):
        return [_to(P, a, diff) for a in v]
    if isinstance(v, tuple) and v and all(isinstance(a, np.ndarray)
                                          for a in v):
        return tuple(P.to_tensor(a) for a in v)
    return v


def _leaves(args, kwargs):
    out = []
    for v in list(args) + list(kwargs.values()):
        if isinstance(v, (list, tuple)):
            out += [a for a in v if hasattr(a, "_data")]
        elif hasattr(v, "_data"):
            out.append(v)
    return out


def _run(P, registry, case, args, kwargs):
    diff = case.grad and registry.OPS[case.op].diff
    targs = [_to(P, a, diff) for a in args]
    tkw = {k: _to(P, v, diff) for k, v in kwargs.items()}
    out = registry.API[case.op](*targs, **tkw)
    outs = list(out) if isinstance(out, tuple) else [out]
    if case.post is not None:
        outs = case.post(P, outs)
    return outs, _leaves(targs, tkw), diff


def _np(t):
    return np.asarray(t.numpy())


def _check_dtype(case, ref_t, port_t, int64_inputs):
    rd, pd = ref_t.dtype.name, port_t.dtype.name
    if rd == pd:
        return
    assert rd == "int32" and pd == "int64" and (
        case.op in _INDEX or int64_inputs), (case.id, rd, pd)


def check_case(case):
    """One case through both packages: outputs (value, dtype, shape), then
    the gradients of a seeded cotangent for a differentiable op."""
    seed = zlib.crc32(case.id.encode())
    args_r, kw_r = case.make(np.random.default_rng(seed))
    args_p, kw_p = case.make(np.random.default_rng(seed))
    P_ref.seed(seed)
    outs_r, leaves_r, diff = _run(P_ref, ref_registry, case, args_r, kw_r)
    P_port.seed(seed)
    outs_p, leaves_p, _ = _run(P_port, port_registry, case, args_p, kw_p)
    assert P_ref.get_rng_state() == P_port.get_rng_state(), case.id
    int64_inputs = any((isinstance(a, np.ndarray) and a.dtype == np.int64)
                       or (isinstance(a, str) and a == "int64")
                       for a in list(args_r) + list(kw_r.values()))
    rtol, atol = case.tol or _LOOSE.get(case.op, (RTOL, ATOL))
    assert len(outs_r) == len(outs_p), case.id
    for r, p in zip(outs_r, outs_p):
        _check_dtype(case, r, p, int64_inputs)
        assert r.shape == p.shape, (case.id, r.shape, p.shape)
        np.testing.assert_allclose(_np(p), _np(r), rtol=rtol, atol=atol,
                                   err_msg=case.id)
    if not diff:
        return
    float_outs = [i for i, o in enumerate(outs_r)
                  if o.dtype.name == "float32" and not o.stop_gradient]
    if not float_outs or not leaves_r:
        return
    rng = np.random.default_rng(seed + 1)
    cots = [rng.standard_normal(outs_r[i].shape).astype(np.float32)
            for i in float_outs]
    for P, outs in ((P_ref, outs_r), (P_port, outs_p)):
        P.autograd.backward([outs[i] for i in float_outs],
                            [P.to_tensor(c) for c in cots])
    for lr, lp in zip(leaves_r, leaves_p):
        if lr.stop_gradient:
            continue
        gr = np.zeros(lr.shape, np.float32) if lr.grad is None \
            else _np(lr.grad)
        gp = np.zeros(lp.shape, np.float32) if lp.grad is None \
            else _np(lp.grad)
        np.testing.assert_allclose(gp, gr, rtol=max(rtol, 1e-5),
                                   atol=max(atol, 1e-5),
                                   err_msg=case.id + " grad")


def cases(*sections):
    """The cases of the given manifest sections, and their ids."""
    picked = [c for c in CASES if c.section in sections]
    return dict(argvalues=picked, ids=[c.id for c in picked])
