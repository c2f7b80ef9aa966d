"""ctypes wrapper over the native shared-memory blocking queue (port of
``paddle_tpu/io/shm_queue.py``).

Reference capability: the C++ LoDTensorBlockingQueue feeding the trainer
from reader processes (paddle/fluid/operators/reader/). Batches cross
the worker -> trainer boundary as one memcpy each way: every array is
written as its raw bytes behind a small header (a dtype tag and the
shape), not pickled through an ``mp.Queue``.

The library (``paddle_tpu_torch/csrc/shm_queue.cpp``) is built with
``g++`` at first use into ``paddle_tpu_torch/_build/``
(:mod:`paddle_tpu_torch.ops._build`).

The wire format carries numpy arrays, CPU torch tensors of any dtype
(bfloat16 included: torch knows it), Python scalars, strings, None and
nested tuples, lists and dicts. A numpy array of an extended dtype (such
as ml_dtypes' ``bfloat16``, recognised by its dtype's name) is carried
as its bytes and its dtype's name; the reader finds the dtype in the
``ml_dtypes`` module its process has already loaded, and this module
never imports it.
"""
from __future__ import annotations

import ctypes
import mmap
import queue
import struct
import sys
import threading

import numpy as np
import torch

__all__ = ["ShmQueue", "native_available"]

_LIB = None
_LIB_ERR = None
_LOCK = threading.Lock()


def _library():
    global _LIB, _LIB_ERR
    with _LOCK:
        if _LIB is None and _LIB_ERR is None:
            try:
                from paddle_tpu_torch.ops import _build

                lib = _build.load("shm_queue")
                u64, vp = ctypes.c_uint64, ctypes.c_void_p
                for fn, res, args in (
                        ("shm_queue_init", u64, [vp, u64]),
                        ("shm_queue_push", ctypes.c_int, [vp, vp, u64]),
                        ("shm_queue_next_size", ctypes.c_int64, [vp]),
                        ("shm_queue_pop", ctypes.c_int64, [vp, vp, u64]),
                        ("shm_queue_close", None, [vp]),
                        ("shm_queue_next_size_timed", ctypes.c_int64,
                         [vp, ctypes.c_int64])):
                    getattr(lib, fn).restype = res
                    getattr(lib, fn).argtypes = args
                _LIB = lib
            except Exception as e:   # no compiler, no pthread
                _LIB_ERR = e
    return _LIB


def native_available() -> bool:
    return _library() is not None


# -- the wire format ---------------------------------------------------------
def _header(tag: bytes, name: str, shape) -> bytes:
    nb = name.encode()
    return (tag + struct.pack("<I", len(nb)) + nb
            + struct.pack(f"<I{len(shape)}q", len(shape), *shape))


def _pack_into(obj, buf: bytearray):
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "cpu":
            raise TypeError(f"shm transport carries CPU tensors, got one "
                            f"on {obj.device}")
        t = obj.detach().contiguous()
        buf += _header(b"P", str(t.dtype).split(".")[-1], t.shape)
        buf += t.reshape(-1).view(torch.uint8).numpy().tobytes()
    elif isinstance(obj, np.ndarray):
        a = np.asarray(obj, order="C")
        dt = a.dtype
        if dt.kind == "V" and dt.names is None:
            # an extended float (bfloat16, fp8): carried by its name
            buf += _header(b"X", dt.name, a.shape)
        elif dt.kind in "biufcSU":
            buf += _header(b"A", dt.str, a.shape)
        else:
            raise TypeError(f"shm transport cannot carry dtype {dt}")
        buf += a.reshape(-1).view(np.uint8).tobytes()
    elif isinstance(obj, (tuple, list)):
        buf += (b"T" if isinstance(obj, tuple) else b"L") + \
            struct.pack("<I", len(obj))
        for v in obj:
            _pack_into(v, buf)
    elif isinstance(obj, dict):
        buf += b"D" + struct.pack("<I", len(obj))
        for k, v in obj.items():
            kb = str(k).encode()
            buf += struct.pack("<I", len(kb)) + kb
            _pack_into(v, buf)
    elif isinstance(obj, str):
        sb = obj.encode()
        buf += b"S" + struct.pack("<I", len(sb)) + sb
    elif obj is None:
        buf += b"N"
    elif isinstance(obj, (bool, np.bool_)):
        buf += b"B" + (b"\x01" if obj else b"\x00")
    elif isinstance(obj, (int, np.integer)):
        buf += b"I" + struct.pack("<q", int(obj))
    elif isinstance(obj, (float, np.floating)):
        buf += b"F" + struct.pack("<d", float(obj))
    else:
        raise TypeError(
            f"shm transport supports numpy arrays, CPU tensors, scalars "
            f"and nested list-tuple-dict, got {type(obj)}")


def _pack_tree(obj) -> bytearray:
    buf = bytearray()
    _pack_into(obj, buf)
    return buf


def _extended_dtype(name: str) -> np.dtype:
    mod = sys.modules.get("ml_dtypes")
    if mod is None or not hasattr(mod, name):
        raise TypeError(
            f"shm record holds a numpy {name} array, but this process has "
            f"not loaded the module that defines {name} (ml_dtypes)")
    return np.dtype(getattr(mod, name))


class _Reader:
    def __init__(self, buf: bytearray):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = memoryview(self.buf)[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def text(self) -> str:
        return bytes(self.take(self.u32())).decode()

    def array_head(self):
        name = self.text()
        nd = self.u32()
        shape = struct.unpack(f"<{nd}q", self.take(8 * nd))
        return name, shape


def _unpack(r: _Reader):
    tag = bytes(r.take(1))
    if tag in (b"A", b"X"):
        name, shape = r.array_head()
        dt = np.dtype(name) if tag == b"A" else _extended_dtype(name)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        arr = np.frombuffer(r.buf, dtype=np.uint8, count=n * dt.itemsize,
                            offset=r.pos)
        r.pos += n * dt.itemsize
        return arr.view(dt).reshape(shape)
    if tag == b"P":
        name, shape = r.array_head()
        dt = getattr(torch, name)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = n * torch.empty((), dtype=dt).element_size()
        raw = torch.frombuffer(r.buf, dtype=torch.uint8, count=nbytes,
                               offset=r.pos) if nbytes else \
            torch.empty((0,), dtype=torch.uint8)
        r.pos += nbytes
        return raw.view(dt).reshape(shape)
    if tag in (b"T", b"L"):
        items = [_unpack(r) for _ in range(r.u32())]
        return tuple(items) if tag == b"T" else items
    if tag == b"D":
        out = {}
        for _ in range(r.u32()):
            k = r.text()
            out[k] = _unpack(r)
        return out
    if tag == b"S":
        return r.text()
    if tag == b"N":
        return None
    if tag == b"B":
        return bytes(r.take(1)) == b"\x01"
    if tag == b"I":
        return struct.unpack("<q", r.take(8))[0]
    if tag == b"F":
        return struct.unpack("<d", r.take(8))[0]
    raise ValueError(f"corrupt shm record (tag {tag!r})")


def _unpack_tree(buf: bytearray):
    return _unpack(_Reader(buf))


class ShmQueue:
    """Process-shared blocking queue over one anonymous mmap segment.

    Create BEFORE forking workers; the children inherit the mapping.
    :meth:`put` / :meth:`get` move structured batches; :meth:`close`
    wakes blocked readers and writers."""

    def __init__(self, capacity_bytes: int = 64 << 20):
        lib = _library()
        if lib is None:
            raise RuntimeError(f"native shm queue unavailable: {_LIB_ERR}")
        self._lib = lib
        self._mm = mmap.mmap(-1, capacity_bytes)   # anonymous, shared
        self._addr = ctypes.addressof(ctypes.c_char.from_buffer(self._mm))
        cap = lib.shm_queue_init(self._addr, capacity_bytes)
        if cap == 0:
            raise RuntimeError("shm_queue_init failed")
        self.capacity = int(cap)

    def put(self, obj) -> None:
        data = _pack_tree(obj)
        n = len(data)
        ptr = (ctypes.c_char * max(n, 1)).from_buffer(data) if n else None
        rc = self._lib.shm_queue_push(self._addr, ptr, n)
        if rc == -2:
            raise ValueError(f"record of {n} bytes exceeds queue capacity "
                             f"{self.capacity}; raise capacity_bytes")
        if rc == -1:
            raise RuntimeError("shm queue closed")

    def get(self, timeout: float = None):
        if timeout is None:
            n = self._lib.shm_queue_next_size(self._addr)
        else:
            n = self._lib.shm_queue_next_size_timed(self._addr,
                                                    int(timeout * 1000))
            if n == -3:
                raise queue.Empty
        if n < 0:
            raise EOFError("shm queue closed and drained")
        buf = bytearray(int(n))
        ptr = (ctypes.c_char * max(int(n), 1)).from_buffer(buf) if n else None
        got = self._lib.shm_queue_pop(self._addr, ptr, int(n))
        if got < 0:
            raise EOFError("shm queue closed and drained")
        return _unpack_tree(buf)

    def close(self) -> None:
        self._lib.shm_queue_close(self._addr)
