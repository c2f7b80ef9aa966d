"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors the JAX package's layout (``paddle_tpu/serving/
engine.py`` -> ``paddle_tpu_torch/serving/engine.py``) and imports
``torch`` and numpy only. Ported so far: the eager Tensor API (``Tensor``,
``to_tensor``, places, dtypes, flags, the op registry built from
``ops/ops.yaml``, every op of its sections as ``paddle_tpu_torch.<op>``,
and autograd on torch's engine: ``backward``, ``grad``, ``PyLayer``);
the global generator (``seed``, ``get_rng_state``) with the random ops;
the layer API (``nn.Layer``, its layers and initializers, ``ParamAttr``,
``save`` / ``load``), the whole of ``nn`` (recurrent, transformer and
long-tail layers, the CTC and RNN-T losses), ``signal``, ``fft`` and
``linalg``;
serving a Llama decoder through the ragged engine step (the ragged paged
attention kernel written by hand in CUDA for Hopper,
``csrc/ragged_paged_attention.cu``); and training it through
``jit.TrainStep`` or an eager loop with the optimizers, LR schedulers,
AMP and checkpoints (the flash attention kernels,
``csrc/flash_attention.cu``, which the Tensor API's ``flash_attention``
runs too); the high-level API (``Model``, ``metric``, ``summary``,
``flops``), the fused ops and layers of ``incubate`` and the BERT family
(``models.bert``).

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``, ``set_device("cpu")``, ``place=CPUPlace()``); with no
GPU and no such request they raise. Importing the package touches no
card and builds no kernel.
"""
__version__ = "0.1.0"

from paddle_tpu_torch.core.tensor import Tensor, is_tensor, to_tensor  # noqa: F401,E402
from paddle_tpu_torch.core.dtype import (  # noqa: F401,E402
    DType, dtype, bool_ as bool8, uint8, int8, int16, int32, int64,
    float16, bfloat16, float32, float64, complex64, complex128,
    get_default_dtype, set_default_dtype,
)
from paddle_tpu_torch.core.place import (  # noqa: F401,E402
    CPUPlace, CUDAPlace, CustomPlace, Place, TPUPlace, device_count,
    get_all_devices, get_device, is_compiled_with_cuda,
    is_compiled_with_tpu, set_device,
)
from paddle_tpu_torch.core.flags import get_flags, set_flags  # noqa: F401,E402
from paddle_tpu_torch.core.generator import (  # noqa: F401,E402
    Generator, get_rng_state, seed, set_rng_state,
)

# op surface: every registry op becomes a paddle_tpu_torch.<op> function
# (flash_attention lives in nn.functional, as in the JAX package)
from paddle_tpu_torch import ops  # noqa: F401,E402
from paddle_tpu_torch.ops.registry import API as _OPS_API  # noqa: E402

globals().update({k: v for k, v in _OPS_API.items()
                  if k != "flash_attention"})

from paddle_tpu_torch.autograd import (  # noqa: F401,E402
    enable_grad, grad, no_grad, set_grad_enabled,
)
from paddle_tpu_torch import autograd  # noqa: F401,E402
from paddle_tpu_torch import nn  # noqa: F401,E402
from paddle_tpu_torch import amp  # noqa: F401,E402
from paddle_tpu_torch import optimizer  # noqa: F401,E402
from paddle_tpu_torch import jit  # noqa: F401,E402
from paddle_tpu_torch import framework  # noqa: F401,E402
from paddle_tpu_torch.framework.io_utils import load, save  # noqa: F401,E402
from paddle_tpu_torch.framework.param_attr import ParamAttr  # noqa: F401,E402
from paddle_tpu_torch import metric  # noqa: F401,E402
from paddle_tpu_torch import hapi  # noqa: F401,E402
from paddle_tpu_torch.hapi import Model, flops, summary  # noqa: F401,E402
from paddle_tpu_torch import incubate  # noqa: F401,E402

# the fft MODULE shadows the registry's 1-D fft op at the top level
# (paddle.fft is a namespace; paddle.fft.fft the op), as in the JAX package
import paddle_tpu_torch.fft  # noqa: F401,E402
import sys as _sys  # noqa: E402

fft = _sys.modules["paddle_tpu_torch.fft"]
import paddle_tpu_torch.signal  # noqa: F401,E402
from paddle_tpu_torch import linalg  # noqa: F401,E402


def einsum(equation, *operands):
    """paddle.einsum(equation, *operands): the registry op takes the
    operand list first, the public API leads with the equation."""
    return _OPS_API["einsum"](list(operands), equation)


def randn_like(x, dtype=None):
    return _OPS_API["randn"](x.shape, dtype=dtype or x.dtype)


def get_cuda_rng_state():
    """The device RNG states, one per card: here the global generator's
    ``(seed, counter)`` (one stream per process), as in the JAX package."""
    from paddle_tpu_torch.core.generator import default_generator

    return [default_generator.get_state()]


def set_cuda_rng_state(state_list):
    from paddle_tpu_torch.core.generator import default_generator

    default_generator.set_state(state_list[0])


# namespace completion: in-place variants, aliases, dtype predicates, the
# random fills; then the Tensor methods bound from module functions
from paddle_tpu_torch import compat_extra as _compat_extra  # noqa: E402

globals().update(_compat_extra.EXPORTS)
_compat_extra._bind_tensor_methods()
