"""paddle.signal: the short-time Fourier transform and its inverse (port
of ``paddle_tpu/signal.py``). Framing is one strided gather, the FFT is
``torch.fft``, and the inverse's overlap-add is one ``index_add`` with the
squared window's envelope dividing it."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from paddle_tpu_torch.core.tensor import Tensor

__all__ = ["stft", "istft"]


def _data(x):
    return x._data if isinstance(x, Tensor) else torch.as_tensor(x)


def _t(d):
    return Tensor._from_data(d, stop_gradient=not d.requires_grad)


def _window(window, win_length, n_fft, dtype, device):
    if window is None:
        win = torch.ones((win_length,), dtype=dtype, device=device)
    else:
        win = _data(window).to(dtype)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        win = tF.pad(win, (pad, n_fft - win_length - pad))
    return win


def _frame_index(n_frames, frame_length, hop_length, device):
    return (torch.arange(n_frames, device=device)[:, None] * hop_length
            + torch.arange(frame_length, device=device)[None, :])


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False,
         onesided=True, name=None) -> Tensor:
    """(..., T) -> complex (..., n_fft // 2 + 1 or n_fft, n_frames)."""
    xd = _data(x)
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    win = _window(window, win_length, n_fft, xd.dtype, xd.device)
    if center:
        pad = n_fft // 2
        lead = xd.shape[:-1]
        xd = tF.pad(xd.reshape(-1, 1, xd.shape[-1]), (pad, pad),
                    mode=pad_mode).reshape(*lead, -1)
    n = 1 + (xd.shape[-1] - n_fft) // hop_length
    frames = xd[..., _frame_index(n, n_fft, hop_length, xd.device)] * win
    spec = torch.fft.rfft(frames, dim=-1) if onesided \
        else torch.fft.fft(frames, dim=-1)
    if normalized:
        spec = spec / (n_fft ** 0.5)
    return _t(spec.transpose(-1, -2))


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None) -> Tensor:
    """The inverse STFT: window-envelope-normalized overlap-add."""
    xd = _data(x)
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    win = _window(window, win_length, n_fft, torch.float32, xd.device)
    spec = xd.transpose(-1, -2)                       # (..., n_frames, freq)
    if normalized:
        spec = spec * (n_fft ** 0.5)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) if onesided \
        else torch.fft.ifft(spec, dim=-1)
    if not return_complex and frames.is_complex():
        frames = frames.real
    frames = frames * win
    n_frames = frames.shape[-2]
    t = n_fft + hop_length * (n_frames - 1)
    lead = frames.shape[:-2]
    idx = _frame_index(n_frames, n_fft, hop_length, xd.device).reshape(-1)
    out = torch.zeros(lead + (t,), dtype=frames.dtype, device=xd.device)
    out = out.index_add(-1, idx, frames.reshape(lead + (-1,)))
    env = torch.zeros((t,), dtype=torch.float32, device=xd.device)
    env = env.index_add(0, idx, (win * win).repeat(n_frames))
    out = out / torch.clamp(env, min=1e-11)
    if center:
        out = out[..., n_fft // 2: t - n_fft // 2]
    if length is not None:
        cur = out.shape[-1]
        out = out[..., :length] if cur >= length \
            else tF.pad(out, (0, length - cur))
    return _t(out)
