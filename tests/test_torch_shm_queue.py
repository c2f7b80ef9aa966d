"""The port's native shared-memory queue (``paddle_tpu_torch/csrc/
shm_queue.cpp``, built with g++ into ``paddle_tpu_torch/_build/``): the
seven scenarios of ``tests/test_shm_queue.py``, and a writer killed
mid-record many times over. bf16 crosses as a CPU
torch tensor with no ml_dtypes anywhere, and an ml_dtypes bf16 numpy
array as its bits and its dtype's name; a record the JAX package's queue
carries comes out of the port's with the same values."""
import multiprocessing as mp
import os
import queue
import signal
import time

import numpy as np
import pytest
import torch

from paddle_tpu.io.shm_queue import ShmQueue as JShmQueue
from paddle_tpu_torch.io.shm_queue import ShmQueue, native_available


def test_native_queue_builds_into_the_port():
    from paddle_tpu_torch.ops import _build

    assert native_available()
    path = _build.library_path("shm_queue")
    assert os.path.dirname(path) == _build.BUILD_DIR and os.path.exists(path)


def test_roundtrip_structured():
    rec = ("ok", 7, [np.arange(12, dtype=np.float32).reshape(3, 4),
                     {"y": np.int64(3), "name": "batch", "flag": True,
                      "none": None}])
    got = []
    for q in (ShmQueue(4 << 20), JShmQueue(4 << 20)):
        q.put(rec)
        got.append(q.get())
    for kind, bid, payload in got:
        assert (kind, bid) == ("ok", 7)
        np.testing.assert_array_equal(
            payload[0], np.arange(12, dtype=np.float32).reshape(3, 4))
        assert payload[0].dtype == np.float32 and payload[0].flags.writeable
        assert payload[1]["y"] == 3 and payload[1]["name"] == "batch"
        assert payload[1]["flag"] is True and payload[1]["none"] is None
    # the port's record equals the JAX package's
    np.testing.assert_array_equal(got[0][2][0], got[1][2][0])
    assert got[0][2][1] == got[1][2][1]


def test_cross_process_fifo_and_close():
    q = ShmQueue(8 << 20)

    def child(q):
        for i in range(20):
            q.put((i, np.full((64,), i, np.float32)))
        q.close()

    p = mp.get_context("fork").Process(target=child, args=(q,))
    p.start()
    seen = []
    while True:
        try:
            i, arr = q.get()
        except EOFError:
            break
        assert arr[0] == i
        seen.append(i)
    p.join()
    assert seen == list(range(20))


def test_blocking_backpressure():
    """A full ring blocks the writer until the reader drains it."""
    q = ShmQueue(256 << 10)  # small ring

    def child(q):
        for i in range(32):
            q.put((i, np.zeros(4096, np.float32)))  # 16KB each, > ring
        q.close()

    p = mp.get_context("fork").Process(target=child, args=(q,))
    p.start()
    got = 0
    while True:
        try:
            q.get()
            got += 1
        except EOFError:
            break
    p.join()
    assert got == 32


def test_timed_get_raises_empty():
    q = ShmQueue(1 << 20)
    t0 = time.time()
    with pytest.raises(queue.Empty):
        q.get(timeout=0.2)
    assert 0.1 < time.time() - t0 < 2.0


def test_record_too_large_rejected():
    q = ShmQueue(64 << 10)
    with pytest.raises(ValueError, match="capacity"):
        q.put(np.zeros(1 << 20, np.float32))


def test_dead_writer_does_not_deadlock_reader():
    """SIGKILL a writer mid-stream: the robust mutex recovers and the
    reader unblocks with EOF or short data instead of hanging."""
    q = ShmQueue(512 << 10)

    def child(q):
        i = 0
        while True:
            q.put((i, np.zeros(8192, np.float32)))  # 32KB, ring fills
            i += 1

    p = mp.get_context("fork").Process(target=child, args=(q,))
    p.start()
    q.get()  # at least one record arrives
    os.kill(p.pid, signal.SIGKILL)
    p.join()
    t0 = time.time()
    while time.time() - t0 < 30:
        try:
            q.get(timeout=0.5)
        except queue.Empty:
            q.close()  # what DataLoader's liveness loop does
        except EOFError:
            break
    else:
        pytest.fail("reader did not unblock after writer death")


def test_dead_writer_never_hands_over_a_torn_record():
    """A writer SIGKILLed while it holds the lock may have written part of
    a record. The port's queue drops the ring when it recovers the lock
    (the reader sees EOF); the JAX package's keeps the bytes, and its
    reader can unpack a torn record (a ValueError) under load. 20 kills
    at random points: every read is a whole record, Empty or EOF."""
    def child(q):
        i = 0
        while True:
            q.put((i, np.full(8192, i, np.float32)))
            i += 1

    for _ in range(20):
        q = ShmQueue(512 << 10)
        p = mp.get_context("fork").Process(target=child, args=(q,))
        p.start()
        q.get()
        os.kill(p.pid, signal.SIGKILL)
        p.join()
        t0 = time.time()
        while time.time() - t0 < 30:
            try:
                i, arr = q.get(timeout=0.05)
                assert arr.shape == (8192,) and (arr == i).all()
            except queue.Empty:
                q.close()
            except EOFError:
                break
        else:
            pytest.fail("reader did not unblock after writer death")


def test_roundtrip_bf16_without_ml_dtypes():
    """A CPU bf16 tensor crosses as its bits with torch's dtype tag; an
    ml_dtypes bf16 numpy array as its bits and its dtype's name. Both
    come back dtype- and bit-exact, beside an int64 leaf."""
    import ml_dtypes

    q = ShmQueue(1 << 20)
    t = (torch.arange(24, dtype=torch.float32) / 7).to(
        torch.bfloat16).reshape(4, 6)
    arr = (np.arange(24, dtype=np.float32) / 7).astype(
        ml_dtypes.bfloat16).reshape(4, 6)
    q.put(("ok", 0, [t, arr, np.arange(4, dtype=np.int64)]))
    _, _, payload = q.get()
    assert payload[0].dtype == torch.bfloat16
    assert torch.equal(payload[0].view(torch.int16), t.view(torch.int16))
    assert payload[1].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(payload[1].view(np.uint16),
                                  arr.view(np.uint16))
    # the tensor and the numpy array hold the same bits
    np.testing.assert_array_equal(payload[0].view(torch.int16).numpy(),
                                  payload[1].view(np.int16))
    np.testing.assert_array_equal(payload[2], np.arange(4))
