"""The port's ``DevicePrefetcher`` against the JAX package's: the non-mesh
scenarios of ``tests/test_device_prefetch.py`` on the CPU
(``device="cpu"``; the card's pinned copies on a side stream are held in
``tests/test_torch_card.py``). The same batches go through both; the
values that come out are equal exactly. The port keeps int64 as int64
(the JAX package canonicalises it to int32) and refuses ``mesh=``."""
import numpy as np
import pytest
import torch

from paddle_tpu.io import prefetch_to_device as jprefetch
from paddle_tpu_torch.io import (DataLoader, Dataset, DevicePrefetcher,
                                 prefetch_to_device)

CPU = torch.device("cpu")


def _batches(n=6, batch=4):
    rng = np.random.default_rng(0)
    return [
        (np.full((batch, 3), i, np.float32),
         rng.normal(size=(batch, 2)).astype(np.float32),
         np.full((batch,), i, np.int64))
        for i in range(n)
    ]


def _values(tree):
    """A prefetched tree as numpy leaves (either package)."""
    if isinstance(tree, (list, tuple)):
        return [_values(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _values(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if hasattr(tree, "_data"):
        return np.asarray(tree._data)
    return tree


def _assert_same(a, b):
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_ordering_and_values_match_jax():
    data = _batches()
    out = list(prefetch_to_device(data, depth=2, device="cpu"))
    ref = list(jprefetch(data, depth=2))
    assert len(out) == len(ref) == len(data)
    for i, (x, z, y) in enumerate(out):
        assert all(isinstance(t, torch.Tensor) and t.device == CPU
                   for t in (x, z, y))
        assert float(x[0, 0]) == i and int(y[0]) == i
        np.testing.assert_array_equal(z.numpy(), data[i][1])
        assert y.dtype == torch.int64          # JAX: int32 (no x64)
    _assert_same(_values(out), _values(ref))


def test_lands_on_the_requested_device():
    pf = prefetch_to_device(_batches(2), depth=1, device="cpu")
    assert pf._device == CPU
    for x, z, y in pf:
        assert x.device == z.device == y.device == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DevicePrefetcher(_batches(1))      # the card by default


def test_exhaustion_and_reiteration():
    pf = prefetch_to_device(_batches(4), depth=2, device="cpu")
    assert len(list(pf)) == 4
    assert len(list(pf)) == 4  # a list source supports a second epoch
    assert len(pf) == 4


def test_producer_exception_propagates():
    def gen():
        yield _batches(1)[0]
        raise RuntimeError("producer exploded")

    it = iter(DevicePrefetcher(gen(), depth=2, device="cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="producer exploded"):
        for _ in it:
            pass


def test_early_break_shuts_down_producer():
    pf = prefetch_to_device(_batches(50), depth=2, device="cpu")
    for i, b in enumerate(pf):
        if i == 2:
            break
    # a second full pass still works (fresh producer thread)
    assert len(list(pf)) == 50


def test_coalescing_matches_direct_transfer():
    """A mixed-dtype tree goes through one staged copy per dtype; the
    values equal a per-leaf copy's (coalesce=False, one copy per leaf)
    and the JAX package's."""
    rng = np.random.default_rng(1)
    batch = {
        "a": rng.normal(size=(5, 7)).astype(np.float32),
        "b": rng.normal(size=(3,)).astype(np.float32),
        "nested": [rng.integers(0, 9, (2, 2)).astype(np.int32),
                   rng.integers(0, 9, (4,)).astype(np.int32)],
        "scalar": np.float32(2.5),
    }
    packed = prefetch_to_device([batch], depth=1, device="cpu")
    direct = prefetch_to_device([batch], depth=1, device="cpu",
                                coalesce=False)
    (out,), (per_leaf,) = list(packed), list(direct)
    assert (packed.transfers, direct.transfers) == (2, 5)
    (ref,) = list(jprefetch([batch], depth=1))
    _assert_same(_values(out), _values(per_leaf))
    _assert_same(_values(out), _values(ref))
    assert float(out["scalar"]) == 2.5 and out["scalar"].dim() == 0
    # the leaves are views into the one buffer of their dtype
    assert out["a"].untyped_storage().data_ptr() == \
        out["b"].untyped_storage().data_ptr()


def test_non_array_leaves_pass_through():
    """String/object metadata in a batch passes through untouched, as on
    the plain loader path."""
    data = [(np.ones((4, 2), np.float32), ["a.jpg", "b.jpg"], 7)]
    (got,) = list(prefetch_to_device(data, depth=1, device="cpu"))
    (ref,) = list(jprefetch(data, depth=1))
    x, names, n = got
    assert isinstance(x, torch.Tensor)
    assert names == ["a.jpg", "b.jpg"] == ref[1]
    assert n == 7 == ref[2] and isinstance(n, int)


def test_bf16_numpy_leaf_lands_as_bf16():
    """An ml_dtypes bf16 array (known by its dtype's name) lands as a
    torch bf16 tensor with the same bits, as the JAX package keeps it
    bf16."""
    import ml_dtypes

    x = (np.arange(12, dtype=np.float32) / 3).astype(
        ml_dtypes.bfloat16).reshape(3, 4)
    (got,) = list(prefetch_to_device([(x,)], depth=1, device="cpu"))
    (ref,) = list(jprefetch([(x,)], depth=1))
    assert got[0].dtype == torch.bfloat16
    assert "bfloat16" in str(ref[0].dtype)
    np.testing.assert_array_equal(got[0].view(torch.int16).numpy(),
                                  x.view(np.int16))


def test_mesh_is_refused():
    with pytest.raises(NotImplementedError, match="slice D"):
        DevicePrefetcher(_batches(1), mesh=object(), placements=[0],
                         device="cpu")
    with pytest.raises(NotImplementedError, match="slice D"):
        DataLoader(_NumpyDataset(), prefetch_mesh=object(), places="cpu")


class _NumpyDataset(Dataset):
    def __init__(self, n=12):
        self.n = n

    def __getitem__(self, i):
        return (np.full((3,), i, np.float32),
                np.asarray(i, np.int64))

    def __len__(self):
        return self.n


def test_dataloader_use_device_prefetch():
    dl = DataLoader(_NumpyDataset(), batch_size=4, use_device_prefetch=True,
                    places="cpu")
    seen = []
    for x, y in dl:
        assert isinstance(x, torch.Tensor) and x.device == CPU
        seen.extend(y.tolist())
    assert seen == list(range(12))
    # two dtypes a batch: two staged copies a batch
    assert (dl.prefetcher.batches, dl.prefetcher.transfers) == (3, 6)


def test_dataloader_prefetch_custom_collate_keeps_bf16():
    """The staging path keeps a bf16 collate's dtype (no widening)."""
    from paddle_tpu_torch.io import default_collate_fn

    def collate(batch):
        x, y = default_collate_fn(batch)
        return x.to(torch.bfloat16), y

    for workers in (0, 2):
        dl = DataLoader(_NumpyDataset(), batch_size=4, collate_fn=collate,
                        use_device_prefetch=True, num_workers=workers,
                        places="cpu")
        x, y = next(iter(dl))
        assert x.dtype == torch.bfloat16 and y.dtype == torch.int64
        assert x[:, 0].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_dataloader_device_prefetch_tensor_dataset():
    """In-process datasets may hold tensors; the staging path takes them
    as they are."""
    from paddle_tpu_torch.io import TensorDataset

    xs = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    ys = torch.arange(8, dtype=torch.int64)
    dl = DataLoader(TensorDataset([xs, ys]), batch_size=4,
                    use_device_prefetch=True, places="cpu")
    got = [y for _, y in dl]
    assert torch.equal(torch.cat(got), ys)


def test_dataloader_device_prefetch_with_workers():
    dl = DataLoader(_NumpyDataset(), batch_size=4, num_workers=2,
                    use_shared_memory=False, use_device_prefetch=True,
                    places="cpu")
    seen = []
    for x, y in dl:
        seen.extend(y.tolist())
    assert seen == list(range(12))
    assert dl.transport == "mp.Queue"
