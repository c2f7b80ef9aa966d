"""The port's datasets, samplers and ``DataLoader`` against the JAX
package's ``paddle_tpu.io``.

Every scenario runs through both packages after the same
``np.random.seed``: the samplers draw from numpy's global RNG in both, so
the index order, and the batches, must be equal exactly. The loader
scenarios mirror the ``DataLoader`` cases of ``tests/test_ops.py`` and
``tests/test_device_prefetch.py``: in-process (buffered or not), forked
workers (0, 2, 3; the native shared-memory queue and the ``mp.Queue``),
iterable datasets with ``get_worker_info`` and ``worker_init_fn``,
worker errors, and the buffered reader's ``prefetch_factor`` capacity.
The port's batches land on ``places="cpu"`` here."""
import queue as _q
from unittest import mock

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu_torch.io as tio


def _both(fn, seed=0):
    """fn(module) run for the JAX package and the port after the same
    np.random.seed."""
    out = []
    for mod in (jio, tio):
        np.random.seed(seed)
        out.append(fn(mod))
    return out


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        assert x.device.type == "cpu"
        return x.numpy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return x


def _assert_equal(a, b):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


# --------------------------------------------------------------------------
# samplers
# --------------------------------------------------------------------------
_SAMPLERS = {
    "sequence": lambda m: m.SequenceSampler(_Range(11)),
    "random": lambda m: m.RandomSampler(_Range(11)),
    "random_num_samples": lambda m: m.RandomSampler(_Range(11),
                                                    num_samples=5),
    "random_replacement": lambda m: m.RandomSampler(
        _Range(11), replacement=True, num_samples=17),
    "weighted": lambda m: m.WeightedRandomSampler(
        [0.1, 2.0, 0.5, 1.0, 3.0, 0.2], 9),
    "weighted_no_replacement": lambda m: m.WeightedRandomSampler(
        [0.1, 2.0, 0.5, 1.0, 3.0, 0.2], 4, replacement=False),
    "subset_random": lambda m: m.SubsetRandomSampler([3, 5, 8, 13, 21]),
    "batch": lambda m: m.BatchSampler(_Range(11), batch_size=4),
    "batch_shuffle": lambda m: m.BatchSampler(_Range(11), shuffle=True,
                                              batch_size=4),
    "batch_drop_last": lambda m: m.BatchSampler(
        _Range(11), shuffle=True, batch_size=4, drop_last=True),
    "batch_of_sampler": lambda m: m.BatchSampler(
        sampler=m.RandomSampler(_Range(9)), batch_size=2),
}


@pytest.mark.parametrize("name", sorted(_SAMPLERS))
def test_sampler_order_matches_jax(name):
    def draw(m):
        s = _SAMPLERS[name](m)
        return [list(s), list(s), len(s)]   # two epochs: two draws

    jax_side, port_side = _both(draw, seed=3)
    assert port_side == jax_side


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_distributed_batch_sampler_matches_jax(shuffle, drop_last):
    """Every rank's batches, epoch 0 and after set_epoch(3) (the epoch
    seeds the shuffle), and len."""
    def draw(m):
        out = []
        for rank in range(3):
            s = m.DistributedBatchSampler(_Range(20), batch_size=3,
                                          num_replicas=3, rank=rank,
                                          shuffle=shuffle,
                                          drop_last=drop_last)
            e0 = list(s)
            s.set_epoch(3)
            out.append([e0, list(s), len(s), s.num_samples, s.total_size])
        return out

    jax_side, port_side = _both(draw)
    assert port_side == jax_side


def test_distributed_batch_sampler_reads_the_launcher_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    js = jio.DistributedBatchSampler(_Range(10), batch_size=2)
    ts = tio.DistributedBatchSampler(_Range(10), batch_size=2)
    assert (ts.nranks, ts.local_rank) == (js.nranks, js.local_rank) == (4, 2)
    assert list(ts) == list(js)


@pytest.mark.parametrize("lengths", [[0.6, 0.4], [3, 7], [0.5, 0.3, 0.2]])
def test_random_split_matches_jax(lengths):
    def split(m):
        return [list(s.indices) for s in m.random_split(_Range(10),
                                                        lengths)]

    jax_side, port_side = _both(split, seed=5)
    assert port_side == jax_side


def test_datasets_match_jax():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    b = np.arange(6, dtype=np.int64)

    def items(m):
        td = m.TensorDataset([a, b])
        cat = m.ConcatDataset([td, m.Subset(td, [5, 0, 3])])
        comp = m.ComposeDataset([td, m.Subset(td, [1, 2, 3, 4, 5, 0])])

        class It(m.IterableDataset):
            def __init__(self, lo, hi):
                self.lo, self.hi = lo, hi

            def __iter__(self):
                return iter(range(self.lo, self.hi))

        chain = m.ChainDataset([It(0, 3), It(10, 12)])
        return [_np([td[i] for i in range(len(td))]),
                _np([cat[i] for i in range(len(cat))]), _np(cat[-1]),
                _np([comp[i] for i in range(len(comp))]), [v for v in chain],
                len(cat), len(comp)]

    jax_side, port_side = _both(items)
    _assert_equal(port_side, jax_side)
    for m in (jio, tio):
        with pytest.raises(ValueError, match="same"):
            m.ComposeDataset([m.TensorDataset([a]),
                              m.TensorDataset([b[:3]])])
        with pytest.raises(RuntimeError):
            len(m.IterableDataset())


# --------------------------------------------------------------------------
# the loader
# --------------------------------------------------------------------------
class _Squares:
    """Samples (x, y, {"z"}) of numpy arrays and a scalar, defined for
    both packages (each subclasses its own Dataset)."""

    def __len__(self):
        return 37

    def __getitem__(self, i):
        return (np.asarray([i * i, -i], np.float32), np.int64(i),
                {"z": np.full((2, 2), i, np.int32)})


def _loader(m, **kw):
    ds = type("Squares", (_Squares, m.Dataset), {})()
    if m is tio:
        kw["places"] = "cpu"
    return m.DataLoader(ds, **kw)


@pytest.mark.parametrize("kw", [
    dict(batch_size=5), dict(batch_size=5, shuffle=True),
    dict(batch_size=5, shuffle=True, drop_last=True),
    dict(batch_size=5, use_buffer_reader=False),
    dict(batch_size=5, num_workers=2, shuffle=True),
    dict(batch_size=5, num_workers=3),
    dict(batch_size=4, num_workers=2, use_shared_memory=False),
    dict(batch_size=5, num_workers=2, shuffle=True,
         use_device_prefetch=True),
    dict(batch_size=5, shuffle=True, use_device_prefetch=True)],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_dataloader_batches_equal_jax(kw):
    def batches(m):
        dl = _loader(m, **kw)
        return [_np(b) for b in dl], len(dl)

    (jb, jn), (tb, tn) = _both(batches, seed=11)
    assert jn == tn == len(jb)
    _assert_equal(tb, jb)


def test_dataloader_lands_on_places():
    dl = _loader(tio, batch_size=5)
    x, y, z = next(iter(dl))
    assert x.device.type == y.device.type == z["z"].device.type == "cpu"
    assert (x.dtype, y.dtype, z["z"].dtype) == (torch.float32, torch.int64,
                                               torch.int32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tio.DataLoader(type("S", (_Squares, tio.Dataset), {})())


def test_dataloader_workers_use_the_shared_memory_queue():
    from paddle_tpu_torch.io.shm_queue import native_available

    dl = _loader(tio, batch_size=5, num_workers=2)
    assert len(list(dl)) == 8
    assert dl.transport == ("ShmQueue" if native_available() else "mp.Queue")


class _Stream:
    def __iter__(self):
        info = self._info()
        assert info is not None and info.num_workers == 2
        # each worker emits its own shard, from the value its init set
        for i in range(info.id, 8, info.num_workers):
            yield np.asarray([i + _INIT.get("offset", 0)], np.int64)


_INIT = {}


def _init(wid):
    _INIT["offset"] = 100


def test_iterable_workers_info_and_init_match_jax():
    def batches(m):
        ds = type("Stream", (_Stream, m.IterableDataset),
                  {"_info": staticmethod(m.get_worker_info)})()
        kw = {"places": "cpu"} if m is tio else {}
        dl = m.DataLoader(ds, batch_size=1, num_workers=2,
                          worker_init_fn=_init, **kw)
        return sorted(int(_np(b).ravel()[0]) for b in dl)

    jax_side, port_side = _both(batches)
    assert port_side == jax_side == list(range(100, 108))
    assert tio.get_worker_info() is None      # only inside a worker


@pytest.mark.parametrize("shm", [True, False])
def test_worker_error_propagates(shm):
    def run(m):
        class Bad(m.Dataset):
            def __len__(self):
                return 4

            def __getitem__(self, i):
                if i == 2:
                    raise ValueError("poison item")
                return np.asarray([i], np.float32)

        kw = {"places": "cpu"} if m is tio else {}
        with pytest.raises(RuntimeError, match="poison item"):
            list(m.DataLoader(Bad(), batch_size=2, num_workers=2,
                              use_shared_memory=shm, **kw))
        return True

    assert _both(run) == [True, True]


def test_worker_refuses_a_cuda_sample():
    from paddle_tpu_torch.io import _collate_np

    cpu = [torch.ones(2), torch.zeros(2)]
    assert torch.equal(_collate_np(cpu), torch.stack(cpu))
    meta = torch.ones(2, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        _collate_np([meta, meta])


def test_prefetch_factor_queue_capacity():
    """The buffered reader's queue holds prefetch_factor batches (one
    in-process producer), in both packages; prefetch_factor 0 raises."""
    for m, target in ((jio, "paddle_tpu.io.queue.Queue"),
                      (tio, "paddle_tpu_torch.io.queue.Queue")):
        captured = {}
        real_queue = _q.Queue

        def spy(maxsize=0):
            captured.setdefault("maxsize", maxsize)
            return real_queue(maxsize=maxsize)

        dl = _loader(m, batch_size=4, prefetch_factor=5)
        with mock.patch(target, side_effect=spy):
            list(dl)
        assert captured["maxsize"] == 5
        with pytest.raises(ValueError):
            _loader(m, batch_size=4, prefetch_factor=0)


def test_custom_collate_in_process_and_in_workers():
    """A custom collate's output as it is in process (the reference's
    route), and through the workers to the loader's device."""
    def collate(batch):
        return {"n": len(batch), "x": np.stack([b[0] for b in batch])}

    for workers in (0, 2):
        def batches(m):
            return [_np(b) for b in _loader(m, batch_size=8,
                                            collate_fn=collate,
                                            num_workers=workers)]

        jax_side, port_side = _both(batches)
        _assert_equal(port_side, jax_side)
