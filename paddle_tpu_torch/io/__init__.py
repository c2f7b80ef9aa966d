"""Data loading (port of ``paddle_tpu/io/__init__.py``; reference:
python/paddle/io/).

The datasets and samplers are copies of the JAX package's: they draw from
numpy's global RNG, so one ``np.random.seed`` gives both packages the
same order. :class:`DataLoader` batches on the host in numpy and has the
JAX package's three routes:

* in-process, through one background thread and a queue of
  ``prefetch_factor`` batches (the buffered reader);
* ``num_workers > 0``: forked worker processes fetch and collate to
  numpy (or CPU tensors) and ship batches through the native
  shared-memory queue (``io/shm_queue.py``; an ``mp.Queue`` where it
  cannot be built), reordered by batch index in the parent. A worker
  touches neither CUDA nor torch's CPU thread pools: it runs with one
  torch thread, and the parent turns each batch into tensors;
* ``use_device_prefetch=True``: the batches stay numpy until
  :class:`~paddle_tpu_torch.io.prefetch.DevicePrefetcher` stages each one
  ``device_prefetch_depth`` batches ahead, one host-to-device copy per
  dtype.

A batch's tensors land on ``resolve_device(places)``: the CUDA card by
default, the CPU with ``places="cpu"`` (the JAX package takes ``places``
and ignores it). ``transport`` names the queue the last multi-process
iteration used (``"ShmQueue"`` or ``"mp.Queue"``), ``prefetcher`` the
last device-prefetch iteration's :class:`DevicePrefetcher` (its
``transfers`` and ``batches``).
"""
from __future__ import annotations

import itertools
import os
import queue
import threading

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ConcatDataset",
           "ChainDataset", "ComposeDataset", "SubsetRandomSampler", "Subset",
           "random_split", "DataLoader", "BatchSampler", "Sampler",
           "SequenceSampler", "RandomSampler", "DistributedBatchSampler",
           "WeightedRandomSampler", "get_worker_info", "default_collate_fn",
           "DevicePrefetcher", "prefetch_to_device"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not indexable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = list(itertools.accumulate(len(d) for d in self.datasets))

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        for i, c in enumerate(self.cum):
            if idx < c:
                prev = self.cum[i - 1] if i else 0
                return self.datasets[i][idx - prev]
        raise IndexError(idx)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    n = len(dataset)
    if abs(sum(lengths) - 1.0) < 1e-6 and all(
            isinstance(x, float) for x in lengths):
        lengths = [int(x * n) for x in lengths]
        lengths[-1] = n - sum(lengths[:-1])
    perm = np.random.permutation(n)
    out, off = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[off:off + ln].tolist()))
        off += ln
    return out


class ComposeDataset(Dataset):
    """Field-wise composition: sample i = concatenated fields of every
    child dataset's sample i (reference io/dataset.py ComposeDataset)."""

    def __init__(self, datasets):
        self._ds = list(datasets)
        if not self._ds:
            raise ValueError("ComposeDataset needs at least one dataset")
        lens = {len(d) for d in self._ds}
        if len(lens) > 1:
            raise ValueError(
                f"lengths of datasets should be same, got {sorted(lens)}"
                " (reference ComposeDataset contract)")

    def __len__(self):
        return len(self._ds[0])

    def __getitem__(self, idx):
        out = []
        for d in self._ds:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


# ---------------------------------------------------------------------------
# samplers (reference: python/paddle/io/dataloader/sampler.py, batch_sampler.py)
# ---------------------------------------------------------------------------
class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """Random permutation over a fixed index subset (reference
    io/sampler.py SubsetRandomSampler)."""

    def __init__(self, indices):
        self.indices = list(indices)
        if not self.indices:
            raise ValueError("indices cannot be empty")

    def __iter__(self):
        order = np.random.permutation(len(self.indices))
        return iter([self.indices[i] for i in order])

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _world():
    """(world size, rank): ``torch.distributed``'s once it is initialised,
    else the launcher's ``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINER_ID``
    (as the JAX package's ``distributed.env`` reads them), else (1, 0)."""
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return torch.distributed.get_world_size(), torch.distributed.get_rank()
    return (int(os.environ.get("PADDLE_TRAINERS_NUM", 1)),
            int(os.environ.get("PADDLE_TRAINER_ID", 0)))


class DistributedBatchSampler(BatchSampler):
    """Shards indices across data-parallel ranks (reference:
    python/paddle/io/dataloader/dist_batch_sampler.py)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        world, my_rank = _world()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else my_rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        n = len(dataset)
        self.num_samples = int(np.ceil(n / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: (self.total_size - len(indices))]
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


# ---------------------------------------------------------------------------
# collate + loader
# ---------------------------------------------------------------------------
def _collate_np(batch):
    """Host collate: numpy leaves stack to numpy, CPU tensor leaves to a
    CPU tensor. Used inside worker processes, which must not touch the
    card (a forked child must not drive the parent's CUDA context)."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return type(sample)(_collate_np([b[i] for b in batch])
                            for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: _collate_np([b[k] for b in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        if any(s.device.type != "cpu" for s in batch):
            raise RuntimeError(
                "dataset __getitem__ returned a CUDA tensor inside a "
                "DataLoader worker process; return numpy arrays (or CPU "
                "tensors, or python scalars) when num_workers > 0 — a "
                "forked worker must not drive the parent's CUDA context")
        return torch.stack(list(batch))
    return np.stack([np.asarray(s) for s in batch])


def _tree_to_host(x):
    """Tree -> host leaves, dtype-preserving: a tensor on the card comes
    to the CPU as a tensor (numpy has no bfloat16), numpy stays numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu() if x.device.type != "cpu" else x
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _tree_to_host(v) for k, v in x.items()}
    return x


def _tree_to_tensor(x, device):
    """numpy arrays and tensors -> tensors on ``device`` (other leaves
    pass through)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.asarray(x, order="C")).to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_to_tensor(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _tree_to_tensor(v, device) for k, v in x.items()}
    return x


def _worker_loop(wid, nw, dataset, indexed_batches, batch_size, drop_last,
                 collate_fn, worker_init_fn, result_q):
    """Body of one DataLoader worker process (reference worker.py
    _worker_loop): fetch, collate on the host, ship (batch_id, data)."""
    global _worker_info
    try:
        torch.set_num_threads(1)
        _worker_info = _WorkerInfo(id=wid, num_workers=nw, dataset=dataset)
        if worker_init_fn is not None:
            worker_init_fn(wid)
        collate = _collate_np if collate_fn is default_collate_fn \
            else (lambda b: _tree_to_host(collate_fn(b)))
        if indexed_batches is None:
            # iterable dataset: this worker consumes its own iterator
            batch = []
            bid = wid
            for item in dataset:
                batch.append(item)
                if len(batch) == batch_size:
                    result_q.put(("ok", (bid, collate(batch))))
                    bid += nw
                    batch = []
            if batch and not drop_last:
                result_q.put(("ok", (bid, collate(batch))))
        else:
            for bid, idxs in indexed_batches:
                result_q.put(
                    ("ok", (bid, collate([dataset[i] for i in idxs]))))
        result_q.put(("end", wid))
    except BaseException:
        import traceback

        result_q.put(("err", traceback.format_exc()))


def default_collate_fn(batch):
    """Stack a batch of samples into CPU tensors (nested tuples, lists
    and dicts keep their structure). :class:`DataLoader` moves them to
    its device."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn([b[i] for b in batch])
                            for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        return torch.stack(list(batch))
    return torch.from_numpy(np.stack([np.asarray(s) for s in batch]))


class _WorkerInfo:
    def __init__(self, id=0, num_workers=1, dataset=None):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    return _worker_info


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_device_prefetch=False,
                 device_prefetch_depth=2, prefetch_mesh=None,
                 prefetch_placements=None):
        if prefetch_factor < 1:
            raise ValueError(
                f"prefetch_factor must be >= 1, got {prefetch_factor}")
        if prefetch_mesh is not None or prefetch_placements is not None:
            raise NotImplementedError(
                "DataLoader(prefetch_mesh=, prefetch_placements=) is not "
                "ported yet; mesh placement comes with slice D")
        self.dataset = dataset
        self.device = resolve_device(places)
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory = use_shared_memory
        self.use_device_prefetch = use_device_prefetch
        self.device_prefetch_depth = device_prefetch_depth
        self.worker_init_fn = worker_init_fn
        self.transport = None
        self.prefetcher = None
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _raw_iter(self, collate):
        if self._iterable_mode:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield collate(batch)
                    batch = []
            if batch and not self.drop_last:
                yield collate(batch)
        else:
            for idx_batch in self.batch_sampler:
                yield collate([self.dataset[i] for i in idx_batch])

    def _host_collate(self):
        """The collate of the host routes: the default collates to numpy
        (or CPU tensors); a custom one's output comes to the host."""
        if self.collate_fn is default_collate_fn:
            return lambda b: _collate_np(  # noqa: E731
                [_tree_to_host(s) for s in b])
        return lambda b: _tree_to_host(self.collate_fn(b))  # noqa: E731

    def _device_iter(self):
        """In-process batches as the reference's DataLoader gives them:
        the default collate's tensors on the loader's device, a custom
        collate's output as it is."""
        if self.collate_fn is not default_collate_fn:
            yield from self._raw_iter(self.collate_fn)
            return
        for b in self._raw_iter(self._host_collate()):
            yield _tree_to_tensor(b, self.device)

    def __iter__(self):
        from paddle_tpu_torch.io.prefetch import DevicePrefetcher

        if self.use_device_prefetch:
            if self.num_workers > 0:
                # fork the worker processes from the CONSUMING thread,
                # before the prefetcher's copy thread starts: a child
                # forked while another thread holds a CUDA or allocator
                # lock would inherit it held
                end = object()
                src = self._multiprocess_iter(to_tensor=False)
                first = next(src, end)
                batches = (itertools.chain([first], src)
                           if first is not end else iter(()))
            else:
                batches = self._raw_iter(self._host_collate())
            self.prefetcher = DevicePrefetcher(
                batches, depth=self.device_prefetch_depth, device=self.device)
            yield from self.prefetcher
            return
        if self.num_workers > 0:
            yield from self._multiprocess_iter()
            return
        if not self.use_buffer_reader:
            yield from self._device_iter()
            return
        # background prefetch thread (buffered-reader role); capacity is
        # per-worker depth (reference prefetch_factor semantics) — this
        # path always has exactly one in-process producer
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_factor)
        sentinel = object()
        err = []

        def worker():
            try:
                for item in self._device_iter():
                    q.put(item)
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        if err:
            raise err[0]

    # -- multiprocess workers (reference dataloader/worker.py) ------------
    def _multiprocess_iter(self, to_tensor=True):
        """num_workers > 0: forked worker processes fetch and collate
        batches on the host; the parent reorders results by batch index,
        so the order is deterministic, then makes tensors on the loader's
        device (``to_tensor=False`` keeps the host batch: the
        device-prefetch source)."""
        import multiprocessing as mp

        if to_tensor:
            def materialize(x):
                return _tree_to_tensor(x, self.device)
        else:
            def materialize(x):
                return x

        ctx = mp.get_context("fork")
        dataset = self.dataset
        if isinstance(dataset, TensorDataset):
            # tensors on the card come to the host in the PARENT: the
            # forked child must not drive the inherited CUDA context
            dataset = TensorDataset([_tree_to_host(t)
                                     for t in dataset.tensors])
        if not self._iterable_mode:
            batches = list(self.batch_sampler)
            n_batches = len(batches)
        nw = self.num_workers
        # transport: the native shared-memory ring buffer when it builds
        # and use_shared_memory, else an mp.Queue (pickle)
        result_q = None
        if self.use_shared_memory:
            try:
                from paddle_tpu_torch.io.shm_queue import ShmQueue

                result_q = ShmQueue()
                self.transport = "ShmQueue"
            except Exception:
                result_q = None
        if result_q is None:
            # per-worker prefetch depth (reference prefetch_factor
            # semantics): a full queue backpressures the workers
            result_q = ctx.Queue(maxsize=self.prefetch_factor * max(1, nw))
            self.transport = "mp.Queue"
        workers = []

        def _get():
            # liveness-aware get: a worker killed by the OS (OOM/segv)
            # never posts 'end', so a bare blocking get would hang the job
            while True:
                try:
                    return result_q.get(timeout=1.0)
                except queue.Empty:
                    for p in workers:
                        if p.exitcode not in (None, 0):
                            raise RuntimeError(
                                f"DataLoader worker died with exit code "
                                f"{p.exitcode} (killed by the OS?)")
                except EOFError:
                    # shm transport: closed by a recovered dead writer
                    raise RuntimeError(
                        "DataLoader shm queue closed unexpectedly (a "
                        "worker died mid-record?)")
        try:
            for wid in range(nw):
                if self._iterable_mode:
                    wargs = (wid, nw, dataset, None, self.batch_size,
                             self.drop_last, self.collate_fn,
                             self.worker_init_fn, result_q)
                else:
                    my = batches[wid::nw]
                    my_ids = list(range(wid, n_batches, nw))
                    wargs = (wid, nw, dataset, list(zip(my_ids, my)),
                             None, None, self.collate_fn,
                             self.worker_init_fn, result_q)
                p = ctx.Process(target=_worker_loop, args=wargs,
                                daemon=True)
                p.start()
                workers.append(p)
            done = 0
            if self._iterable_mode:
                while done < nw:
                    kind, payload = _get()
                    if kind == "err":
                        raise RuntimeError(
                            f"DataLoader worker failed:\n{payload}")
                    if kind == "end":
                        done += 1
                        continue
                    yield materialize(payload[1])
            else:
                pending = {}
                nxt = 0
                while nxt < n_batches:
                    if nxt in pending:
                        yield materialize(pending.pop(nxt))
                        nxt += 1
                        continue
                    kind, payload = _get()
                    if kind == "err":
                        raise RuntimeError(
                            f"DataLoader worker failed:\n{payload}")
                    if kind == "end":
                        done += 1
                        if done == nw and nxt < n_batches and \
                                nxt not in pending:
                            missing = [i for i in range(nxt, n_batches)
                                       if i not in pending]
                            if missing:
                                raise RuntimeError(
                                    f"workers exited with batches "
                                    f"{missing[:4]}... missing")
                        continue
                    pending[payload[0]] = payload[1]
        finally:
            for p in workers:
                if p.is_alive():
                    p.terminate()
            for p in workers:
                p.join(timeout=5)


from paddle_tpu_torch.io.prefetch import (  # noqa: E402
    DevicePrefetcher, prefetch_to_device,
)
