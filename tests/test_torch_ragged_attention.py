"""The port's ragged paged attention against the JAX package's.

The same inputs, made from a numpy seed, go through the JAX
``ragged_paged_attention`` (the Pallas kernel in interpret mode, and its
jnp reference) and the port's CPU path (the plain PyTorch version that
the CUDA kernel is held against on the card). One mixed batch holds
decode rows, a prefill chunk that starts mid-context, a padding slot,
-1 block-table entries and padding rows past ``cu[num_seqs]``, at small
widths with GQA rep 2."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from paddle_tpu.ops.pallas import ragged_paged_attention as jrpa
from paddle_tpu_torch.ops import ragged_paged_attention as trpa

# f32 on both sides; the two differ only in summation order (and the
# Pallas kernel's online softmax), a few ulps of values of order 1
ATOL = RTOL = 2e-5


def _mixed_batch(seed=0, h=4, kh=2, d=16, bs=4, nb=40, s_slots=5, mb=8):
    """Slots: 0 decode (ctx 9), 1 prefill chunk of 6 starting at
    position 7 (ctx 13), 2 decode at a block boundary (ctx 8), 3 fresh
    prefill of 5 (ctx 5), 4 padding (num_seqs = 4). Tables hold distinct
    blocks and -1 past each slot's context. T = 13 live rows + 3
    padding rows."""
    rng = np.random.default_rng(seed)
    nq = [1, 6, 1, 5]
    ctx_live = [9, 13, 8, 5]
    ns = len(nq)
    cu = np.zeros((s_slots + 1,), np.int32)
    cu[1:ns + 1] = np.cumsum(nq)
    cu[ns + 1:] = cu[ns]
    t_total = int(cu[ns]) + 3
    ctx = np.zeros((s_slots,), np.int32)
    ctx[:ns] = ctx_live
    bt = np.full((s_slots, mb), -1, np.int32)
    perm = rng.permutation(nb)
    k = 0
    for i, c in enumerate(ctx_live):
        need = -(-c // bs)
        bt[i, :need] = perm[k:k + need]
        k += need
    f = np.float32
    return dict(
        q=rng.standard_normal((t_total, h, d)).astype(f),
        k_new=rng.standard_normal((t_total, kh, d)).astype(f),
        v_new=rng.standard_normal((t_total, kh, d)).astype(f),
        key_cache=rng.standard_normal((nb, bs, kh, d)).astype(f),
        value_cache=rng.standard_normal((nb, bs, kh, d)).astype(f),
        block_tables=bt, cu_seqlens=cu, context_lens=ctx,
        num_seqs=np.int32(ns))


def _ref_load(ref, idx):
    return ref[idx]


def _ref_store(ref, idx, val):
    ref[idx] = val


def _run_jax(b, impl, monkeypatch):
    # the TPU kernel is written against pl.load/pl.store, which newer jax
    # releases dropped for plain ref indexing: give it that spelling back
    # for the interpret run (the JAX package itself is left as it is)
    monkeypatch.setattr(pl, "load", _ref_load, raising=False)
    monkeypatch.setattr(pl, "store", _ref_store, raising=False)
    out, kc, vc = jrpa.ragged_paged_attention(
        *(jnp.asarray(b[k]) for k in (
            "q", "k_new", "v_new", "key_cache", "value_cache",
            "block_tables", "cu_seqlens", "context_lens", "num_seqs")),
        impl=impl)
    return np.asarray(out), np.asarray(kc), np.asarray(vc)


def _run_torch(b):
    args = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    args["key_cache"] = args["key_cache"].clone()
    args["value_cache"] = args["value_cache"].clone()
    out, kc, vc = trpa.ragged_paged_attention(**args)
    return out.numpy(), kc.numpy(), vc.numpy()


@pytest.fixture(scope="module")
def batch():
    return _mixed_batch()


@pytest.fixture(scope="module")
def port_result(batch):
    return _run_torch(batch)


@pytest.mark.parametrize("impl", ["interpret", "ref"])
def test_plain_matches_jax(batch, port_result, impl, monkeypatch):
    out_j, kc_j, vc_j = _run_jax(batch, impl, monkeypatch)
    out_t, kc_t, vc_t = port_result
    np.testing.assert_allclose(out_t, out_j, rtol=RTOL, atol=ATOL)
    # the cache scatter is a copy: exactly equal
    np.testing.assert_array_equal(kc_t, kc_j)
    np.testing.assert_array_equal(vc_t, vc_j)


def test_padding_rows_are_exact_zero(batch, port_result):
    out_t = port_result[0]
    live = int(batch["cu_seqlens"][int(batch["num_seqs"])])
    assert out_t.shape[0] > live
    assert np.all(out_t[live:] == 0.0)
    assert np.all(np.isfinite(out_t[:live]))


def test_cache_write_leaves_other_slots_alone(batch, port_result):
    """Only the live rows' slots change; padding rows and -1 table
    entries write nowhere."""
    kc0, kc_t = batch["key_cache"], port_result[1]
    changed = np.argwhere(np.any(kc0 != kc_t, axis=(2, 3)))
    live = int(batch["cu_seqlens"][int(batch["num_seqs"])])
    assert len(changed) == live


def test_write_kv_drops_minus_one_entries():
    """A row whose block-table entry is -1 is dropped, not routed into
    block 0, even when it is the first row of the stream."""
    kc = torch.zeros((4, 2, 1, 2))
    new = torch.arange(1.0, 7.0).reshape(3, 1, 2)
    bt = torch.tensor([[-1, 3], [1, -1]], dtype=torch.int32)
    seg = torch.tensor([0, 0, 1])
    pos = torch.tensor([0, 2, 1])          # slot 0 block 0 is -1
    trpa._write_kv(kc, new, bt, seg, pos)
    assert torch.equal(kc[0], torch.zeros(2, 1, 2))
    assert torch.equal(kc[3, 0, 0], new[1, 0])
    assert torch.equal(kc[1, 1, 0], new[2, 0])
    assert int((kc != 0).any(-1).sum()) == 2
