"""paddle.linalg (port of ``paddle_tpu/linalg.py``): the linalg registry
ops under their namespace, with the reference's aliases. ``eig`` raises
here as it does there (``paddle.eig``, the top-level one, computes it)."""
from paddle_tpu_torch.ops.registry import API as _ops

_NAMES = [
    "cholesky", "cond", "det", "eigh", "eigvalsh", "inverse", "lstsq",
    "lu", "matrix_power", "matrix_rank", "norm", "pinv", "qr",
    "slogdet", "solve", "svd", "triangular_solve",
]

for _n in _NAMES:
    if _n in _ops:
        globals()[_n] = _ops[_n]

inv = _ops["inverse"]
matmul = _ops["matmul"]


def eig(x, name=None):
    """Refused, as in the JAX package's namespace: use ``paddle.eig``."""
    raise NotImplementedError(
        "paddle.linalg.eig (nonsymmetric) has no TPU kernel; use "
        "paddle.linalg.eigh for symmetric/Hermitian matrices, or "
        "numpy.linalg.eig on x.numpy() for host-side decomposition")


def _missing(name):
    def fn(*a, **k):
        raise NotImplementedError(
            f"paddle.linalg.{name} is not implemented in the TPU build")

    fn.__name__ = name
    return fn


multi_dot = _ops.get("multi_dot") or _missing("multi_dot")
cholesky_solve = _ops.get("cholesky_solve") or _missing("cholesky_solve")
householder_product = _ops.get("householder_product") or \
    _missing("householder_product")

__all__ = [n for n in _NAMES if n in _ops] + ["inv", "matmul", "eig"]
