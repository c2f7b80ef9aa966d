"""paddle.fft (port of ``paddle_tpu/fft.py``): the spectral registry ops
under their namespace, with ``fftfreq`` and ``rfftfreq``."""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops.registry import API as _API

__all__ = ["fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
           "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
           "hfft", "ihfft", "fftfreq", "rfftfreq", "fftshift", "ifftshift"]

fft = _API["fft"]
ifft = _API["ifft"]
fft2 = _API["fft2"]
ifft2 = _API["ifft2"]
fftn = _API["fftn"]
ifftn = _API["ifftn"]
rfft = _API["rfft"]
irfft = _API["irfft"]
rfft2 = _API["rfft2"]
irfft2 = _API["irfft2"]
rfftn = _API["rfftn"]
irfftn = _API["irfftn"]
hfft = _API["hfft"]
ihfft = _API["ihfft"]
fftshift = _API["fftshift"]
ifftshift = _API["ifftshift"]


def fftfreq(n, d=1.0, dtype="float32"):
    return Tensor(np.fft.fftfreq(int(n), d=float(d)), dtype=dtype)


def rfftfreq(n, d=1.0, dtype="float32"):
    return Tensor(np.fft.rfftfreq(int(n), d=float(d)), dtype=dtype)
