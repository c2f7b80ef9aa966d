"""The port's layout algebra and ``redistribute``
(``paddle_tpu_torch/distributed/redistribute.py``) against the JAX
package's.

Every test of ``tests/test_redistribute.py`` runs twice: as it is (the
reference) and with its module globals (``Layout``, the oracle, the
pricing, the stats, its helpers) bound to the port; its assertions are
the checks. Its one device-path test calls ``jax.jit``, so the port's
side restates it over the port's ``redistribute`` on one process. Then
random layout pairs through both oracles (shards bit-equal, bytes priced
equally), and the port's collective path on 2 and 4 spawned gloo
processes, each rank's shard bit-equal to the oracle's and its stats the
reference's for the same pairs.
"""
import importlib
import random
import types

import numpy as np
import pytest
import torch

import test_redistribute
from paddle_tpu_torch.distributed import redistribute as trd
from paddle_tpu_torch.testing import gloo_ranks

# the JAX package's distributed/__init__ exports the function under the
# module's name
jrd = importlib.import_module("paddle_tpu.distributed.redistribute")

_PORT = {name: getattr(trd, name) for name in (
    "Layout", "get_stats", "redistribute_host", "reset_stats",
    "transfer_bytes")}
_TESTS = sorted(name for name, fn in vars(test_redistribute).items()
                if name.startswith("test_")
                and isinstance(fn, types.FunctionType))


def _port_module(mod):
    """``mod``'s namespace with the port's names, and its functions
    rebound to it."""
    g = dict(mod.__dict__)
    g.update(_PORT)
    for name, obj in mod.__dict__.items():
        if isinstance(obj, types.FunctionType) and \
                obj.__module__ == mod.__name__:
            g[name] = types.FunctionType(obj.__code__, g, name,
                                         obj.__defaults__, obj.__closure__)
    return g


_PORT_NS = _port_module(test_redistribute)


def test_the_reference_tests_are_all_driven():
    assert len(_TESTS) == 8, _TESTS


@pytest.mark.parametrize("side", ["reference", "port"])
@pytest.mark.parametrize("name", _TESTS)
def test_reference_case(name, side):
    if side == "reference":
        getattr(test_redistribute, name)()
    elif name == "test_device_path_single_device_identity":
        # the port's device path on one process: the identity, priced
        lt = trd.Layout.replicated(2)
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        trd.reset_stats()
        y = trd.redistribute(torch.from_numpy(x), lt, lt)
        np.testing.assert_array_equal(y.numpy(), x)
        assert trd.get_stats() == {"num_redistributes": 1,
                                   "bytes_moved": 0, "bytes_total": 48}
    else:
        _PORT_NS[name]()


def _pairs(seed, n, sizes, world=None):
    """``n`` random (src, dst, shape) of the reference test's generator;
    with ``world``, pairs whose common mesh is exactly ``world``."""
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        ndim = rng.choice([1, 2, 3])
        a = test_redistribute._random_layout(rng, ndim, rng.choice(sizes))
        b = test_redistribute._random_layout(rng, ndim, rng.choice(sizes))
        if world is not None and max(a.size, b.size) != world:
            continue
        out.append((a, b, test_redistribute._shape_for([a, b], rng, ndim)))
    return out


def _port_layout(lt):
    return trd.Layout.from_meta(lt.to_meta())


def test_oracles_agree_and_price_alike():
    """64 random pairs over meshes of 1-8 devices: the port's layouts
    slice like the reference's, its oracle returns the same shards bit
    for bit, and both price every transfer and count the same stats."""
    jrd.reset_stats()
    trd.reset_stats()
    for k, (a, b, shape) in enumerate(_pairs(11, 64, [1, 2, 4, 8])):
        ta, tb = _port_layout(a), _port_layout(b)
        assert ta == trd.Layout(a.mesh_axes, a.dim_placements)
        for i in range(a.size):
            assert ta.shard_slices(shape, i) == a.shard_slices(shape, i)
        x = np.random.RandomState(k).randn(*shape).astype(np.float32)
        want = jrd.redistribute_host(a.shards(x), a, b)
        got = trd.redistribute_host(ta.shards(x), ta, tb)
        assert len(got) == len(want) == b.size
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for itemsize in (2, 4):
            assert trd.transfer_bytes(ta, tb, shape, itemsize) == \
                jrd.transfer_bytes(a, b, shape, itemsize)
    assert trd.get_stats() == jrd.get_stats()
    assert trd.get_stats()["num_redistributes"] == 64


def test_redistribute_refuses_a_group_of_the_wrong_size():
    """On one process a layout pair whose common mesh has 2 devices
    cannot run: the collective path raises, it does not slice quietly."""
    src = trd.Layout.tp_sharded(2, 0, 2)
    dst = trd.Layout.tp_sharded(2, 1, 2)
    with pytest.raises(ValueError, match="group of 2"):
        trd.redistribute(torch.zeros(2, 4), src, dst)


@pytest.mark.parametrize("world,n_pairs", [(2, 6), (4, 8)])
def test_collective_path_on_gloo_processes(world, n_pairs):
    """``world`` spawned gloo processes run ``redistribute`` on random
    layout pairs whose common mesh is ``world`` (cross-degree pairs
    included): every rank's ``dst`` shard is bit-equal to the oracle's,
    and every rank's stats are the reference oracle's over the same
    pairs."""
    sizes = [s for s in (1, 2, 4) if world % s == 0]
    pairs = _pairs(100 + world, n_pairs, sizes, world=world)
    cases = [(a.to_meta(), b.to_meta(), shape, k)
             for k, (a, b, shape) in enumerate(pairs)]
    res = gloo_ranks.run(gloo_ranks.redistribute_cases, world, cases)
    jrd.reset_stats()
    for k, (a, b, shape) in enumerate(pairs):
        x = np.random.RandomState(k).randn(*shape).astype(np.float32)
        want = jrd.redistribute_host(a.shards(x), a, b)
        for rank, r in enumerate(res):
            np.testing.assert_array_equal(
                r["shards"][k], want[rank // (world // b.size)],
                err_msg=f"pair {k} rank {rank}")
    for r in res:
        assert r["stats"] == jrd.get_stats()
    assert any(a.size != b.size for a, b, _ in pairs)
