"""Einsum and spectral (FFT) emitters (port of
``paddle_tpu/ops/spectral.py``): ``torch.einsum`` and ``torch.fft``, which
take the same equations, lengths, axes and norms as their jnp
counterparts. None of them draws a random number; they sit in the
manifest's ``random`` section as they do in the JAX package."""
from __future__ import annotations

import torch

from paddle_tpu_torch.ops.registry import register_emitter as op


@op
def einsum(operands, equation):
    """paddle.einsum's semantics: explicit and implicit output, ``...``
    broadcasting, repeated labels (diagonals and sums)."""
    return torch.einsum(equation.replace(" ", ""), *operands)


def _norm(norm):
    return None if norm in (None, "backward") else norm


def _dims(axes):
    return None if axes is None else tuple(axes)


@op
def fft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.fft(x, n=n, dim=axis, norm=_norm(norm))


@op
def ifft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.ifft(x, n=n, dim=axis, norm=_norm(norm))


@op
def fft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.fft2(x, s=s, dim=tuple(axes), norm=_norm(norm))


@op
def ifft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.ifft2(x, s=s, dim=tuple(axes), norm=_norm(norm))


@op
def fftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.fftn(x, s=s, dim=_dims(axes), norm=_norm(norm))


@op
def ifftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.ifftn(x, s=s, dim=_dims(axes), norm=_norm(norm))


@op
def rfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.rfft(x, n=n, dim=axis, norm=_norm(norm))


@op
def irfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.irfft(x, n=n, dim=axis, norm=_norm(norm))


@op
def rfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.rfft2(x, s=s, dim=tuple(axes), norm=_norm(norm))


@op
def irfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.irfft2(x, s=s, dim=tuple(axes), norm=_norm(norm))


@op
def rfftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.rfftn(x, s=s, dim=_dims(axes), norm=_norm(norm))


@op
def irfftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.irfftn(x, s=s, dim=_dims(axes), norm=_norm(norm))


@op
def hfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.hfft(x, n=n, dim=axis, norm=_norm(norm))


@op
def ihfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.ihfft(x, n=n, dim=axis, norm=_norm(norm))


@op
def fftshift(x, axes=None):
    return torch.fft.fftshift(x, dim=_dims(axes))


@op
def ifftshift(x, axes=None):
    return torch.fft.ifftshift(x, dim=_dims(axes))
