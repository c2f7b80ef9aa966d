"""Card-only checks of the port (``gpu`` marker). They skip without a
CUDA device; on the card run them with

    python -m pytest --noconftest -q tests/test_torch_card.py

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine does not have and this file does not use). The ragged attention
kernels are held against their plain version on small mixed batches and
on decode batches that split each slot's cache range (bf16), and the
tiny engine's greedy tokens on the card against the CPU's; the flash
attention kernels (forward, dQ, dK/dV) against their plain versions over
head dims, dtypes, Sq != Sk and ragged tails, and three tiny training
steps on the card against the CPU. A bf16 call launches the tensor-core
kernels only (the libraries count launches by route). The threefry
stream and the speculative sampler give the CPU's bits and tokens on the
card, and the tiny speculative engine serves the CPU's tokens and keys.
The resilience paths: a host swap restores the spilled bytes bit for bit
with the caches where they were, a capture with the step watchdog armed
is neither invalidated nor falsely fired, the bucketed step's replay
equals its eager step, and the tiny swap, drain, bucketed and generate
runs serve the CPU's tokens. The eager loop (scheduler, scaler, AdamW or
Momentum) trains on the card as on the CPU, a checkpoint resume on the
card is bit-exact, and the bf16 flash check (F4) holds on 16 seeded
draws at two shapes. The eager Tensor API's Llama matches the module
path in f32 and bf16 and trains on the tensor cores, double grad on the
card matches the CPU, and so does ``flash_attn_unpadded``. The layer
API's Llama trains on the card as on the CPU with the same dropout masks,
a dropout mask and a seeded ``nn.Linear`` drawn on the card equal the
CPU's bit for bit, ``paddle.save``/``paddle.load`` round trips on the
card, and its bf16 steps run K2-K4 on the tensor cores. Its
``jit.TrainStep`` replays a captured step bit-identically to ``__call__``
with and without dropout (the device RNG chain). The ragged kernel reads
a tiered engine's second pool (the host tier's mirror) as its plain
version does and as one pool holding the same pages does, drops a write
to a virtual entry, and a tiny tiered engine over a small device pool
serves the untiered engine's and the CPU's tokens. The long tail: every
case of the vision, long-tail and nn long tail sections, and the heavy
ops at a reduced published size, give the CPU's values and gradients on
the card; ``flash_attn_qkvpacked`` is ``F.flash_attention`` on the
slices bit for bit through K2-K4, the varlen wrapper is
``flash_attn_unpadded``, and the DeepSpeech2-widths GRU + CTC model
gives the CPU's loss and gradients. Slice D3: the ring attention's
chunked K2-K4 path holds the plain recurrence (f32) and ``flash_check``
chunk by chunk (bf16), four context-parallel ranks and an
expert-parallel pair on the card match one rank. Slice D4: two ranks
started by the port's launcher on the card hang, restart as a gang and
resume bit-identically to an unbroken run. The rest of slice D: a pp 2
pipeline checkpoint round trip is bit-identical, the pp 2 pipeline with
Lamb matches one rank, and a masked context-parallel call at sp 2
matches the one-rank dense model. Slice E2a and the high-level API: the
small BERT's forward and one ``Model.fit`` batch, and
``masked_multihead_attention`` / ``fused_multi_head_attention``, give
the CPU's numbers on the card, and the masked-LM decoder stays the word
embedding across ``Model.save`` / ``Model.load``."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.testing import flash_check


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _batch(dev, dtype, h, kh, d, bs, seed=0, nb=64, s_slots=6, mb=16):
    rng = np.random.default_rng(seed)
    live = [(1, 9), (6, 13), (1, 8), (5, 5), (1, 61)]
    ns = len(live)
    cu = np.zeros((s_slots + 1,), np.int32)
    cu[1:ns + 1] = np.cumsum([n for n, _ in live])
    cu[ns + 1:] = cu[ns]
    ctx = np.zeros((s_slots,), np.int32)
    ctx[:ns] = [c for _, c in live]
    bt = np.full((s_slots, mb), -1, np.int32)
    perm = rng.permutation(nb)
    k = 0
    for i, (_, c) in enumerate(live):
        need = -(-c // bs)
        bt[i, :need] = perm[k:k + need]
        k += need
    t_total = int(cu[ns]) + 5

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    return dict(q=randn(t_total, h, d), k_new=randn(t_total, kh, d),
                v_new=randn(t_total, kh, d), key_cache=randn(nb, bs, kh, d),
                value_cache=randn(nb, bs, kh, d),
                block_tables=torch.from_numpy(bt).to(dev),
                cu_seqlens=torch.from_numpy(cu).to(dev),
                context_lens=torch.from_numpy(ctx).to(dev),
                num_seqs=torch.tensor([ns], dtype=torch.int32, device=dev))


def _route_delta(before):
    now = rpa.route_launches()
    return {k: now[k] - before[k] for k in now}


def _check_ragged(b, rtol, atol, nsplit=None):
    """One call of the kernels on batch ``b`` against the plain version
    (bf16: its ``round_to`` form in the kernel's splits): caches, padding
    rows, values, and the routes the call took."""
    q, dtype = b["q"], b["q"].dtype
    s_slots = b["block_tables"].shape[0]
    kc_ref = b["key_cache"].clone()
    vc_ref = b["value_cache"].clone()
    before, routes = rpa.launches, rpa.route_launches()
    out, kc, vc = rpa.ragged_paged_attention(**b)
    assert rpa.launches == before + 1
    seg, pos, _ = rpa._token_layout(out.shape[0], s_slots, b["cu_seqlens"],
                                    b["context_lens"], b["num_seqs"])
    rpa._write_kv(kc_ref, b["k_new"], b["block_tables"], seg, pos)
    rpa._write_kv(vc_ref, b["v_new"], b["block_tables"], seg, pos)
    split, n = rpa.kernel_split(q, kc, b["block_tables"])
    ref = rpa._ragged_attend_ref(
        q, kc_ref, vc_ref, b["block_tables"], b["cu_seqlens"],
        b["context_lens"], b["num_seqs"], q.shape[-1] ** -0.5,
        out_dtype=torch.float32,
        round_to=dtype if dtype == torch.bfloat16 else None, split=split)
    torch.cuda.synchronize()
    live = int(b["cu_seqlens"][int(b["num_seqs"][0])])
    assert torch.equal(kc, kc_ref) and torch.equal(vc, vc_ref)
    assert torch.all(out[live:] == 0)
    torch.testing.assert_close(out[:live].float(), ref[:live], rtol=rtol,
                               atol=atol)
    tc = dtype == torch.bfloat16
    assert _route_delta(routes) == {"fma": int(not tc),
                                    "tensor_cores": int(tc),
                                    "combine": int(tc and n > 1)}
    if nsplit is not None:
        assert n == nsplit
    return n


# f32: summation order only. bf16: the kernel rounds P to bf16 before its
# P V products, per chunk of 64 positions and per split (as the TPU kernel
# rounds it per page), and rounds its output to bf16 (at most half a
# relative step of 2^-8, covered by rtol); against a plain version that
# keeps P in f32 the P rounding alone exceeds atol at short contexts (up
# to 2x the limit in a CPU emulation of the kernel), so the plain version
# rounds at the same places (`round_to`; held against the Pallas kernel in
# bf16 by tests/test_torch_ragged_attention.py) and the tolerance stays
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-4, 1e-4),
                                             (torch.bfloat16, 1e-2, 1e-3)])
@pytest.mark.parametrize("h,kh,d,bs", [(4, 2, 16, 4), (32, 8, 128, 16),
                                       (8, 8, 64, 8), (32, 4, 64, 32)])
def test_kernel_matches_plain(card, dtype, rtol, atol, h, kh, d, bs):
    _check_ragged(_batch(card, dtype, h, kh, d, bs), rtol, atol)


def _decode_batch(dev, h, kh, d, bs, s_slots, seed=0):
    """One decode row per live slot, contexts of 1 to 4600 positions
    (several past 4096), -1 table entries past each context, two padding
    slots and padding rows past cu[num_seqs]."""
    rng = np.random.default_rng(seed)
    ns = s_slots - 2
    ctx_cycle = [4100, 1, 4096, 700, 4600, 64, 129, 2048, 17]
    ctx = np.zeros((s_slots,), np.int32)
    ctx[:ns] = [ctx_cycle[i % len(ctx_cycle)] for i in range(ns)]
    cu = np.zeros((s_slots + 1,), np.int32)
    cu[1:ns + 1] = np.arange(1, ns + 1)
    cu[ns + 1:] = ns
    mb = -(-4608 // bs)
    need = [-(-int(c) // bs) for c in ctx[:ns]]
    nb = sum(need) + 4
    bt = np.full((s_slots, mb), -1, np.int32)
    perm = rng.permutation(nb)
    k = 0
    for i, n in enumerate(need):
        bt[i, :n] = perm[k:k + n]
        k += n
    t_total = ns + 3
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    return dict(q=randn(t_total, h, d), k_new=randn(t_total, kh, d),
                v_new=randn(t_total, kh, d), key_cache=randn(nb, bs, kh, d),
                value_cache=randn(nb, bs, kh, d),
                block_tables=torch.from_numpy(bt).to(dev),
                cu_seqlens=torch.from_numpy(cu).to(dev),
                context_lens=torch.from_numpy(ctx).to(dev),
                num_seqs=torch.tensor([ns], dtype=torch.int32, device=dev))


# decode batches with more slots than SMs / KH (the grid still has too few
# CTAs to fill the card, so each slot's cache range is split and the
# combine kernel merges the splits), GQA groups 1, 4 and 8
@pytest.mark.gpu
@pytest.mark.parametrize("h,kh,d,bs,s_slots", [(8, 8, 128, 16, 24),
                                               (32, 8, 128, 16, 24),
                                               (32, 4, 64, 32, 40)])
def test_kernel_splits_decode_batch(card, h, kh, d, bs, s_slots):
    n = _check_ragged(_decode_batch(card, h, kh, d, bs, s_slots), 1e-2, 1e-3)
    assert n > 1


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(card):
    b = _batch(card, torch.float16, 4, 2, 16, 4)
    with pytest.raises(ValueError, match="dtype"):
        rpa.ragged_paged_attention(**b)
    # bf16 runs only on the tensor cores, which take these head dims
    before = rpa.route_launches()
    b = _batch(card, torch.bfloat16, 4, 2, 48, 4)
    with pytest.raises(ValueError, match="head_dim"):
        rpa.ragged_paged_attention(**b)
    assert rpa.route_launches() == before


@pytest.mark.gpu
def test_tiny_engine_card_matches_cpu(card):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (EngineConfig, LLMEngine,
                                          SamplingParams)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.tiny()
    cpu_model = LlamaForCausalLM(cfg, device="cpu")
    cpu_model.init_weights(torch.Generator().manual_seed(0))
    card_model = LlamaForCausalLM(cfg)
    card_model.load_state_dict(cpu_model.state_dict())
    prompts = [list(range(1, 1 + n)) for n in (3, 11, 27)]
    ecfg = dict(block_size=4, max_num_seqs=4, max_model_len=64,
                max_batched_tokens=16)
    sp = SamplingParams(max_new_tokens=6)
    a = LLMEngine(card_model, EngineConfig(**ecfg)).generate(prompts, sp)
    b = LLMEngine(cpu_model, EngineConfig(**ecfg)).generate(prompts, sp)
    assert a == b


# --------------------------------------------------------------------------
# flash attention kernels
# --------------------------------------------------------------------------
def _flash_inputs(dev, dtype, b, sq, sk, h, d, seed):
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    return (randn(b, sq, h, d), randn(b, sk, h, d), randn(b, sk, h, d),
            randn(b, sq, h, d))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("b,sq,sk,h,causal", [
    (2, 128, 128, 2, True),      # whole tiles
    (1, 100, 100, 3, True),      # ragged tail tile
    (2, 70, 150, 2, True),       # Sq < Sk, bottom-right causal
    (1, 150, 70, 2, True),       # Sq > Sk: rows that see no key
    (2, 90, 130, 2, False),      # not causal, ragged both ways
    (1, 192, 192, 2, True),      # a multiple of 64, not of 128
    (1, 1024, 1024, 4, True),    # cycles the two-stage TMA ring
])
def test_flash_kernels_match_plain(card, dtype, d, b, sq, sk, h, causal):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _flash_inputs(card, dtype, b, sq, sk, h, d, seed=d + sq)
    scale = d ** -0.5
    before, routes = dict(fa.launches), fa.route_launches()
    o, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
    delta = fa._delta(o, do)
    dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    assert all(fa.launches[n] == before[n] + 1 for n in before)
    # bf16: every kernel on the tensor cores; f32: every one on FMAs
    tc = dtype == torch.bfloat16
    now = fa.route_launches()
    for n in before:
        assert now[n]["tensor_cores"] - routes[n]["tensor_cores"] == int(tc)
        assert now[n]["fma"] - routes[n]["fma"] == int(not tc)
    # element-wise at flash_check.TOL; in bf16 plus the one-ulp effect of
    # the P and dS entries near a bf16 rounding boundary (F4's check)
    flash_check.check(q, k, v, do, {"o": o, "lse": lse, "dq": dq, "dk": dk,
                                    "dv": dv}, scale, causal)
    if causal and sq > sk:
        blind = sq - sk             # rows 0 .. blind-1 see no key
        assert torch.all(o[:, :blind] == 0) and torch.all(dq[:, :blind] == 0)
        assert torch.all(lse.view(b, h, sq)[:, :, :blind] == float("-inf"))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 2048, 32, 64), (4, 2048, 16, 128)])
def test_flash_check_holds_on_16_draws(card, shape):
    """F4: 16 seeded bf16 draws at each shape of the failures it was
    found on pass the check (``tools/flash_check_draws.py``'s loop)."""
    from paddle_tpu_torch.tools import flash_check_draws

    res = flash_check_draws.run(shape, 16, seed=2)
    failed = [r["failure"] for r in res["reports"] if not r["passed"]]
    assert not failed, failed[:2]
    assert res["summary"]["passed"] == 16


@pytest.mark.gpu
def test_flash_autograd_on_card_matches_cpu(card):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _flash_inputs("cpu", torch.float32, 2, 96, 96, 2, 32, 5)
    outs = []
    for dev in ("cpu", card):
        xs = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        o = fa.flash_attention_data(*xs, causal=True)
        o.backward(do.to(dev))
        outs.append([o.detach().cpu()] + [x.grad.cpu() for x in xs])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [48, 256])
def test_flash_kernel_refuses_head_dim(card, d):
    q, k, v, _ = _flash_inputs(card, torch.bfloat16, 1, 16, 16, 2, d, 0)
    before = dict(fa.launches)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_data(q, k, v, causal=True)
    assert fa.launches == before


@pytest.mark.gpu
def test_bf16_calls_never_take_the_fma_route(card):
    """A bf16 call through the entry points (autograd flash attention,
    the ragged op) launches tensor-core kernels only."""
    flash0, ragged0 = fa.route_launches(), rpa.route_launches()
    q, k, v, do = _flash_inputs(card, torch.bfloat16, 1, 256, 256, 2, 128, 9)
    xs = [x.requires_grad_() for x in (q, k, v)]
    fa.flash_attention_data(*xs, causal=True).backward(do)
    rpa.ragged_paged_attention(**_batch(card, torch.bfloat16, 32, 8, 128, 16))
    torch.cuda.synchronize()
    flash1, ragged1 = fa.route_launches(), rpa.route_launches()
    for n in flash0:
        assert flash1[n]["fma"] == flash0[n]["fma"]
        assert flash1[n]["tensor_cores"] == flash0[n]["tensor_cores"] + 1
    assert ragged1["fma"] == ragged0["fma"]
    assert ragged1["tensor_cores"] == ragged0["tensor_cores"] + 1


@pytest.mark.gpu
def test_tiny_train_card_matches_cpu(card):
    from paddle_tpu_torch.tools import tiny_train_parity

    # asserts the losses, the parameters and the kernel launches itself
    tiny_train_parity.run(card)


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["adamw", "momentum"])
def test_tiny_eager_loop_card_matches_cpu(card, rule):
    """An eager AdamW (or Momentum) + scheduler + scaler loop on the card
    equals the CPU's at phase 8's tolerances, with equal lrs and scaler
    states (``tiny_train_parity.run_eager`` asserts them)."""
    from paddle_tpu_torch.tools import tiny_train_parity

    res = tiny_train_parity.run_eager(card, rule)
    assert res["lrs"][0] != res["lrs"][-1]


@pytest.mark.gpu
def test_checkpoint_resume_on_card_is_bit_exact(card, tmp_path):
    """Save and restore through CheckpointManager on the card: the resumed
    run's losses and final state equal the unbroken run's bit for bit,
    and every restored tensor is on the card."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.tools import eager_train

    rep = eager_train.resume(LlamaConfig.tiny(dtype="bfloat16"), card,
                             (2, 16), str(tmp_path / "ck"))
    assert rep["bit_identical_losses"] and rep["bit_identical_state"]
    assert rep["state_on_device"]


# --------------------------------------------------------------------------
# threefry, the speculative sampler and the speculative engine
# --------------------------------------------------------------------------
@pytest.mark.gpu
def test_threefry_card_matches_cpu(card):
    from paddle_tpu_torch.ops import threefry

    keys = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2 ** 32, (16, 2), dtype=np.int64))
    for fn in (lambda k: threefry.split(k, 3),
               lambda k: threefry.random_bits(k, (5, 77)),
               lambda k: threefry.uniform(k, (300,)).view(torch.int32)):
        assert torch.equal(fn(keys.to(card)).cpu(), fn(keys))


@pytest.mark.gpu
def test_sample_or_verify_card_matches_cpu(card):
    """S = 6, R = 5, V = 128256 (Llama-3's vocabulary), n_draft 0-4,
    greedy, sampled, top-k and top-p rows: emit counts and keys are
    bit-identical, tokens identical (f32 probabilities differ by ulps,
    which moves a token only at an exact near-tie)."""
    from paddle_tpu_torch.ops.sampling import sample_or_verify

    rng = np.random.default_rng(3)
    s, r, v = 6, 5, 128256
    logits = (3.0 * rng.standard_normal((s, r, v))).astype(np.float32)
    am = logits.argmax(-1)
    nd = np.array([0, 1, 2, 3, 4, 4], np.int32)
    draft = np.zeros((s, r - 1), np.int32)
    for i in range(s):
        for j in range(r - 1):
            draft[i, j] = am[i, min(r - 1 - nd[i] + j, r - 1)] \
                if j % 2 == 0 else rng.integers(0, v)
    keys = rng.integers(0, 2 ** 32, (s, 2), dtype=np.int64)
    temp = np.array([0.0, 0.8, 1.0, 0.0, 1.2, 0.6], np.float32)
    top_k = np.array([0, 50, 0, 0, 5, 0], np.int32)
    top_p = np.array([1.0, 0.9, 0.95, 1.0, 1.0, 0.8], np.float32)
    args = [torch.from_numpy(x) for x in (logits, draft, nd, keys, temp,
                                          top_k, top_p)]
    cpu = sample_or_verify(*args)
    gpu = [x.cpu() for x in sample_or_verify(*(a.to(card) for a in args))]
    assert torch.equal(gpu[1], cpu[1]) and torch.equal(gpu[2], cpu[2])
    for i in range(s):
        assert torch.equal(gpu[0][i, :int(cpu[1][i])],
                           cpu[0][i, :int(cpu[1][i])])


@pytest.mark.gpu
def test_tiny_spec_engine_card_matches_cpu(card):
    from paddle_tpu_torch.tools import tiny_spec_parity

    res = tiny_spec_parity.run(card)
    assert res["cpu_identical"]


# --------------------------------------------------------------------------
# the serving step as captured CUDA graphs
# --------------------------------------------------------------------------
def _graph_engine(card, dtype, **kw):
    """The tiny model in ``dtype`` behind an engine on the card (block 4,
    4 sequences, a 16-token budget: buckets 8 and 16), with a recorder of
    the first step's arrays at each bucket (``eng.first_arrays``)."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import EngineConfig, LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=dtype), device=card)
    model.init_weights(torch.Generator(device=card).manual_seed(0))
    eng = LLMEngine(model, EngineConfig(
        block_size=4, max_num_seqs=4, max_model_len=64,
        max_batched_tokens=16, **kw))
    eng.first_arrays = {}
    dispatch = eng._dispatch

    def recording(reqs, key, arrays):
        eng.first_arrays.setdefault(key, [a.copy() for a in arrays])
        return dispatch(reqs, key, arrays)

    eng._dispatch = recording
    return eng


def _graph_workload(eng):
    from paddle_tpu_torch.serving import SamplingParams

    for i, n in enumerate((13, 3, 9, 14)):
        eng.add_request(f"g{i}", list(range(1 + i, 1 + i + n)),
                        SamplingParams(max_new_tokens=6,
                                       temperature=0.8 if i == 1 else 0.0,
                                       seed=i))
    eng.run()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_replay_matches_eager_step(card, dtype):
    """At two buckets (8 and 16), a replay of the bucket's graph and an
    eager ``_device_step`` on the same input buffers give bit-identical
    packed rows and cache bytes: the same shapes and the same kernels."""
    from paddle_tpu_torch.tools.step_checks import replay_matches_eager

    eng = _graph_engine(card, dtype)
    _graph_workload(eng)
    assert {k[1] for k in eng.first_arrays} == {8, 16}
    for key, arrays in eng.first_arrays.items():
        res = replay_matches_eager(eng, key, arrays)
        assert all(res.values()), (key, res)


@pytest.mark.gpu
def test_graph_counts_launches_and_addresses(card):
    """One capture per bucket stepped, one replay per model step; K1
    runs once per layer per replay (on the tensor cores, in bf16) and its
    wrapper counts only the warm-ups and the captures; the caches, the
    weights and the rope tables keep their addresses."""
    eng = _graph_engine(card, "bfloat16")
    model = eng.model
    held = {"kcs": eng._kcs, "vcs": eng._vcs,
            **dict(model.named_parameters()), **dict(model.named_buffers())}
    addr = {k: t.data_ptr() for k, t in held.items()}
    before = rpa.launches
    _graph_workload(eng)
    torch.cuda.synchronize()
    g = eng._graphs.since()
    layers = model.config.num_hidden_layers
    assert set(eng._graphs.keys) == eng._seen_shapes == set(eng.first_arrays)
    n_keys = len(eng._seen_shapes)
    assert g["captures"] == len(g["captured_launches"]) == n_keys
    assert sum(g["replays"].values()) == eng.metrics.engine_steps
    for name, captured in g["captured_launches"].items():
        assert captured["ragged_paged_attention"] == layers, name
        assert captured["ragged_paged_attention/tensor_cores"] == layers
        assert "ragged_paged_attention/fma" not in captured
    assert rpa.launches - before == 2 * layers * n_keys
    assert g["replayed_launches"]["ragged_paged_attention"] == \
        layers * eng.metrics.engine_steps
    assert g["executed_launches"]["ragged_paged_attention"] == layers * (
        eng.metrics.engine_steps + n_keys)
    assert {k: t.data_ptr() for k, t in held.items()} == addr
    assert eng._kcs is held["kcs"] and eng._vcs is held["vcs"]


@pytest.mark.gpu
def test_draft_propose_on_graphs_matches_eager(card):
    """The draft's k chained forwards, replayed from the bucket's graph,
    propose what the eager forwards propose; the second call replays."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving.spec import SpecDecoder

    model = LlamaForCausalLM(LlamaConfig.tiny(dtype="bfloat16"), device=card)
    model.init_weights(torch.Generator(device=card).manual_seed(1))
    spec = SpecDecoder(model, 3)
    lists = [list(range(1, 1 + n)) for n in (5, 13, 1)]
    got = spec.propose(lists)
    again = spec.propose(lists)
    ids = np.zeros((4, 16), np.int64)
    lens = np.ones((4,), np.int64)
    for i, t in enumerate(lists):
        ids[i, :len(t)] = t
        lens[i] = len(t)
    with torch.no_grad():
        eager = spec._forwards(torch.from_numpy(ids).to(card),
                               torch.from_numpy(lens).to(card))
    want = eager.cpu().numpy()[:3]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(again, want)
    g = spec.graphs.since()
    assert spec.graphs.keys == [("draft", 4, 16)]
    assert g["replays"] == {"4x16": 2}
    assert g["captured_launches"]["4x16"][
        "flash_attention_fwd"] == 3 * model.config.num_hidden_layers


@pytest.mark.gpu
def test_capture_runs_with_the_collector_off(card):
    """A dead graph (or any object in a reference cycle that holds one)
    freed by the garbage collector inside a capture would free memory
    there and invalidate the capture. ``StepGraphs`` collects before it
    captures and keeps the collector off while it does: the captured
    call sees garbage made before it collected and the collector
    disabled, and the collector is on again after."""
    import gc
    import weakref

    from paddle_tpu_torch.jit.trace import StepGraphs

    class Cycle:
        pass

    dead = Cycle()
    dead.me = dead
    ref = weakref.ref(dead)
    del dead
    seen = []

    def step(x):
        seen.append((gc.isenabled(), ref() is None))
        return x * 2

    graphs = StepGraphs(card)
    out = graphs.run(("k",), step, [np.arange(4, dtype=np.float32)])
    assert len(seen) == 2 and seen[1] == (False, True), seen
    assert gc.isenabled()
    np.testing.assert_array_equal(graphs.fetch(out), np.arange(4) * 2.0)


# --------------------------------------------------------------------------
# one-card resilience: host swap, the watchdog, the bucketed step
# --------------------------------------------------------------------------
def _tiny_card_engine(card, dtype="bfloat16", **kw):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import EngineConfig, LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=dtype), device=card)
    model.init_weights(torch.Generator(device=card).manual_seed(0))
    kw.setdefault("block_size", 4)
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("max_model_len", 32)
    return LLMEngine(model, EngineConfig(**kw))


def _swap_workload(eng):
    from paddle_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(15)
    return eng.generate([list(map(int, rng.integers(0, 256, size=n)))
                         for n in (6, 8, 5, 7)],
                        SamplingParams(max_new_tokens=8))


@pytest.mark.gpu
def test_swap_round_trip_is_bit_exact_in_place(card):
    """On a cache too small for the batch: every block restored from the
    pinned host pool holds the spilled bytes bit for bit, the caches
    keep their addresses (the captured graphs hold them), and the tokens
    equal the recompute run's."""
    from paddle_tpu_torch.tools.step_checks import SwapCheck

    eng = _tiny_card_engine(card, num_blocks=10, swap_mode="host")
    assert eng._host_k.is_pinned() and eng._host_v.is_pinned()
    held = {"kcs": eng._kcs, "vcs": eng._vcs}
    addr = {k: t.data_ptr() for k, t in held.items()}
    check = SwapCheck(eng)
    tokens = _swap_workload(eng)
    check.close()
    torch.cuda.synchronize()
    assert eng.scheduler.num_swap_outs > 0
    assert check.restored == eng.scheduler.num_swap_ins \
        == eng.scheduler.num_swap_outs
    assert not check.mismatches, check.mismatches
    assert {k: t.data_ptr() for k, t in held.items()} == addr
    assert eng._kcs is held["kcs"] and eng._vcs is held["vcs"]
    assert eng.block_manager.num_free_host_blocks == eng.cfg.num_host_blocks
    recompute = _tiny_card_engine(card, num_blocks=10)
    assert _swap_workload(recompute) == tokens


@pytest.mark.gpu
def test_capture_with_the_watchdog_armed(card):
    """A whole workload with ``step_timeout_s`` set, every bucket captured
    fresh while the watchdog's threads wait on earlier steps' events:
    no false alarm, no invalidated capture (each bucket's replay equals
    its eager step), and the tokens equal an unwatched engine's."""
    from paddle_tpu_torch.tools.step_checks import replay_matches_eager

    eng = _graph_engine(card, "bfloat16", step_timeout_s=2.0)
    plain = _graph_engine(card, "bfloat16")
    _graph_workload(eng)
    _graph_workload(plain)
    assert eng._watchdog._prober is not None and not eng._watchdog.fired
    assert set(eng._graphs.keys) == eng._seen_shapes
    assert len(eng._seen_shapes) >= 2
    for rid in ("g0", "g1", "g2", "g3"):
        assert eng.get_request(rid).generated == \
            plain.get_request(rid).generated
    for key, arrays in eng.first_arrays.items():
        res = replay_matches_eager(eng, key, arrays)
        assert all(res.values()), (key, res)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bucketed_replay_matches_eager_step(card, dtype):
    """The bucketed path (``ragged=False``): one graph per ``(kind, B,
    S)`` key, its replay bit-identical to an eager ``_device_step`` on
    the same buffers at a prefill and a decode key; no K1 launch."""
    from paddle_tpu_torch.serving import SamplingParams
    from paddle_tpu_torch.tools.step_checks import replay_matches_eager

    eng = _tiny_card_engine(card, dtype, ragged=False, max_model_len=64,
                            max_batched_tokens=32)
    first = {}
    dispatch = eng._dispatch

    def recording(reqs, key, arrays):
        first.setdefault(key, [a.copy() for a in arrays])
        return dispatch(reqs, key, arrays)

    eng._dispatch = recording
    before = rpa.launches
    for i, n in enumerate((13, 3, 9, 14)):
        eng.add_request(f"p{i}", list(range(1 + i, 1 + i + n)),
                        SamplingParams(max_new_tokens=6))
    eng.run()
    assert rpa.launches == before
    assert set(eng._graphs.keys) == eng._seen_shapes == set(first)
    assert {k[0] for k in first} == {"prefill", "decode"}
    for key, arrays in first.items():
        res = replay_matches_eager(eng, key, arrays)
        assert all(res.values()), (key, res)


@pytest.mark.gpu
def test_tiny_resilience_card_matches_cpu(card):
    from paddle_tpu_torch.tools import tiny_resilience_parity

    res = tiny_resilience_parity.run(card)
    assert res["cpu_identical"]


# --------------------------------------------------------------------------
# the fed training loop: run_steps on graphs, the prefetcher, the workers
# --------------------------------------------------------------------------
def _tiny_trainer(card, donate=True, scaled=False):
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig.tiny(dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device=card)
    model.init_weights(torch.Generator(device=card).manual_seed(0))
    opt = AdamW(1e-3, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    # a first scale of 2**126 overflows the scaled loss: the first steps
    # are skipped until the schedule has halved it enough
    scaler = GradScaler(init_loss_scaling=2.0 ** 126, incr_every_n_steps=2,
                        decr_every_n_nan_or_inf=1) if scaled else None
    return model, opt, TrainStep(model, model.criterion(), opt,
                                 donate=donate, scaler=scaler,
                                 skip_nonfinite=scaled)


def _tiny_stack(card, k, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randint(0, 256, (k, 2, 32))).to(card)
            for _ in range(2)]


def _same_state(a, b):
    (ma, oa), (mb, ob) = a, b
    for (name, pa), pb in zip(ma.named_parameters(), mb.parameters()):
        assert torch.equal(pa.view(torch.int16), pb.view(torch.int16)), name
        for key, va in oa._slots[id(pa)].items():
            vb = ob._slots[id(pb)][key]
            assert torch.equal(va.view(torch.uint8) if va.dim() else va,
                               vb.view(torch.uint8) if vb.dim() else vb), \
                (name, key)


@pytest.mark.gpu
@pytest.mark.parametrize("donate", [True, False])
def test_run_steps_replay_is_bitwise_the_eager_step(card, donate):
    """Two dispatches of run_steps(4, stacked) (the first captures the
    step's CUDA graph after an eager warm-up step; then 7 replays)
    against 8 __call__s from the same weights: losses, every parameter
    and every slot bit-identical, with a loss scale that overflows the
    first steps (skipped by the scaler and the guard in both, the scale
    halving through the device schedule); donate=False hands back new
    tensors and leaves what was taken before alone."""
    ids, labels = _tiny_stack(card, 8)
    ma, oa, sa = _tiny_trainer(card, donate, scaled=True)
    mb, ob, sb = _tiny_trainer(card, True, scaled=True)
    p0 = next(ma.parameters())
    taken = p0.detach()
    before = taken.clone()
    got = torch.cat([sa.run_steps(4, ids[:4], labels[:4], stacked=True),
                     sa.run_steps(4, ids[4:], labels[4:], stacked=True)])
    want = torch.stack([sb(ids[i], labels[i]) for i in range(8)])
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got, want)
    _same_state((ma, oa), (mb, ob))
    assert oa._step_count == ob._step_count == 8
    assert sa.skipped_steps == sb.skipped_steps >= 1
    assert torch.equal(sa._scaler_state, sb._scaler_state)
    assert sa._scaler._scale == sb._scaler._scale
    stats = sa.graph_stats()
    assert stats["captures"] == 1 and list(stats["replays"].values()) == [7]
    assert torch.equal(taken, before) == (not donate)


@pytest.mark.gpu
def test_run_steps_captures_the_flash_backward(card):
    """K2, K3 and K4 (the backward runs on autograd's thread) land in the
    captured graph: each counted once per layer by the capture, on the
    tensor cores, and by the wrappers only at the warm-up and the
    capture; the replays run captured x replays."""
    model, _, step = _tiny_trainer(card)
    layers = model.config.num_hidden_layers
    ids, labels = _tiny_stack(card, 4, seed=1)
    before = dict(fa.launches)
    step.run_steps(4, ids, labels, stacked=True)
    step.run_steps(4, ids, labels, stacked=True)
    torch.cuda.synchronize()
    (captured,) = step.graph_stats()["captured_launches"].values()
    executed = step.graph_stats()["executed_launches"]
    for name in fa.launches:
        assert captured[name] == layers, captured
        assert captured[f"{name}/tensor_cores"] == layers, captured
        assert f"{name}/fma" not in captured, captured
        assert fa.launches[name] - before[name] == 2 * layers
        assert executed[name] == layers * 8, executed


@pytest.mark.gpu
def test_run_steps_sees_a_rebound_state_between_dispatches(card):
    """A restore that binds new tensors (an optimizer set_state_dict, a
    user's p.data =) between dispatches is copied into the graph's
    buffers: the next replay trains the restored values, as __call__s
    would."""
    ids, labels = _tiny_stack(card, 4, seed=2)
    ma, oa, sa = _tiny_trainer(card)
    mb, ob, sb = _tiny_trainer(card)
    sa.run_steps(2, ids[:2], labels[:2], stacked=True)
    for i in range(2):
        sb(ids[i], labels[i])
    state = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in ob.state_dict().items()}
    oa.set_state_dict(state)
    with torch.no_grad():
        for pa, pb in zip(ma.parameters(), mb.parameters()):
            pa.data = pb.detach().clone()
    got = sa.run_steps(2, ids[2:], labels[2:], stacked=True)
    want = torch.stack([sb(ids[i], labels[i]) for i in (2, 3)])
    assert torch.equal(got, want)
    _same_state((ma, oa), (mb, ob))


@pytest.mark.gpu
def test_prefetcher_lands_on_the_card_one_copy_per_dtype(card):
    """Pinned host buffers, one host-to-device copy per dtype per batch
    on the copy thread's stream; the leaves are views of that copy on
    the card, equal to the host batch; the staged memory survives the
    consumer's use on its own stream."""
    from paddle_tpu_torch.io import prefetch_to_device

    rng = np.random.default_rng(0)
    data = [(rng.normal(size=(64, 33)).astype(np.float32),
             rng.integers(0, 9, (64,)).astype(np.int64),
             rng.normal(size=(5,)).astype(np.float32), "meta")
            for _ in range(6)]
    pf = prefetch_to_device(data, depth=2)
    assert pf._device.type == "cuda"
    outs = []
    for x, y, z, meta in pf:
        assert x.device.type == y.device.type == z.device.type == "cuda"
        assert meta == "meta"
        outs.append((x * 2).sum() + y.sum() + z.sum())  # consumer's stream
    torch.cuda.synchronize()
    assert (pf.batches, pf.transfers) == (6, 12)
    for (x, y, z, _), got in zip(data, outs):
        want = (torch.from_numpy(x) * 2).sum() + y.sum() + \
            torch.from_numpy(z).sum()
        assert abs(float(got) - float(want)) < 1e-3 * (1 + abs(float(want)))


@pytest.mark.gpu
def test_forked_shm_worker_after_cuda_is_up(card):
    """The loader forks its workers from a process whose CUDA context is
    up; the workers collate on the host through the shared-memory queue
    and the parent lands the batches on the card, equal to the
    in-process loader's."""
    from paddle_tpu_torch.io import DataLoader, Dataset

    torch.ones(1, device=card).sum().item()     # CUDA is up

    class Items(Dataset):
        def __len__(self):
            return 23

        def __getitem__(self, i):
            return np.full((3,), i, np.float32), np.int64(i)

    single = [(x.cpu(), y.cpu()) for x, y in
              DataLoader(Items(), batch_size=4, places=card)]
    for prefetch in (False, True):
        dl = DataLoader(Items(), batch_size=4, num_workers=2,
                        use_device_prefetch=prefetch, places=card)
        multi = list(dl)
        assert dl.transport == "ShmQueue"
        assert len(multi) == len(single) == 6
        for (xs, ys), (xm, ym) in zip(single, multi):
            assert xm.device.type == "cuda"
            assert torch.equal(xs, xm.cpu()) and torch.equal(ys, ym.cpu())


# -- the eager Tensor API (chip_smoke phase 20, smaller) ---------------------
@pytest.fixture
def card_place(card):
    from paddle_tpu_torch.core import place

    prev = (place._current_place, place._current_device)
    place.set_device("gpu")
    yield card
    place._current_place, place._current_device = prev


def _small_llama(dtype):
    from paddle_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=512, hidden_size=256,
                       intermediate_size=512, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2,
                       max_position_embeddings=256, dtype=dtype)


@pytest.mark.gpu
def test_tensor_api_step_matches_the_module_path_f32(card_place):
    """f32 (TF32 off): one forward and backward of the Tensor API's Llama
    against the module path from the same weights: loss within rtol
    1e-5, every gradient within relative L2 1e-4 (FMA kernels)."""
    from paddle_tpu_torch.tools import tensor_api_train as T

    cfg = _small_llama("float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = T.build(cfg, card_place)
    params = T.tensor_params(model)
    ids, labels = T.batch(cfg, 2, 256, card_place)
    routes = fa.route_launches()
    c = T.compare_step0(model, params, ids, labels)
    assert abs(c["loss_tensor_api"] - c["loss_module"]) <= \
        1e-5 * abs(c["loss_module"]), c
    assert c["grad_rel_l2_max"] <= 1e-4, c
    now = fa.route_launches()
    assert all(now[k]["fma"] > routes[k]["fma"] for k in now), now


@pytest.mark.gpu
def test_tensor_api_trains_bf16_on_the_tensor_cores(card_place):
    """bf16: step 0 against the module path (loss within 1e-3 nats, every
    gradient's cosine similarity >= 0.9999), then 3 AdamW steps over the
    Tensor parameters: finite falling losses, K2-K4 once per layer a step
    on the tensor cores."""
    from paddle_tpu_torch.tools import tensor_api_train as T

    cfg = _small_llama("bfloat16")
    model = T.build(cfg, card_place)
    params = T.tensor_params(model)
    ids, labels = T.batch(cfg, 2, 256, card_place)
    c = T.compare_step0(model, params, ids, labels)
    assert abs(c["loss_tensor_api"] - c["loss_module"]) <= 1e-3, c
    assert c["grad_cosine_min"] >= 0.9999, c
    routes = fa.route_launches()
    run = T.train_tensor_api(model, params, ids, labels, 3, lr=1e-3)
    assert np.all(np.isfinite(run["losses"])), run
    assert run["losses"][-1] < run["losses"][0], run
    now = fa.route_launches()
    for k in now:
        assert now[k]["tensor_cores"] - routes[k]["tensor_cores"] == 6, now
        assert now[k]["fma"] == routes[k]["fma"], now


@pytest.mark.gpu
def test_double_grad_on_the_card_matches_the_cpu(card_place):
    """``paddle.grad(create_graph=True)`` twice through tanh(matmul(x, w))
    in f32 (TF32 off): the card's first and second gradients against the
    CPU's at rtol 1e-5 (atol 1e-5 of the largest value)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import tensor_api_train as T

    torch.backends.cuda.matmul.allow_tf32 = False
    got = T.double_grad(paddle.CUDAPlace(0), shape=(64, 128))
    want = T.double_grad(paddle.CPUPlace(), shape=(64, 128))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.gpu
def test_flash_attn_unpadded_on_the_card_matches_the_cpu(card_place):
    """Packed sequences of 37-300 tokens, 8 query and 2 KV heads of 128,
    bf16 causal on the card against the same call in f32 on the CPU (on
    the bf16-rounded inputs), at ``flash_check.TOL[bfloat16]``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import tensor_api_train as T

    q, k, v, cu = T.unpadded_case([300, 37, 129, 64], 8, 2, 128)
    got = T.unpadded(q, k, v, cu, paddle.CUDAPlace(0), "bfloat16")
    rounded = [paddle.to_tensor(a, dtype="bfloat16").astype(
        "float32").numpy() for a in (q, k, v)]
    want = T.unpadded(*rounded, cu, paddle.CPUPlace(), "float32")
    np.testing.assert_allclose(got, want,
                               **flash_check.TOL[torch.bfloat16])


def _small_layer_llama(dtype, dropout=0.0):
    from paddle_tpu_torch.tools import layer_api_train as L

    return L.from_llama_config(_small_llama(dtype), dropout=dropout)


def _layer_train(place, cfg, ids, labels, state, rng_state, steps):
    """The layer API's Llama on ``place`` ("gpu"/"cpu"): ``state`` loaded,
    ``rng_state`` set, ``steps`` AdamW steps; its losses and dropout masks
    (as numpy)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import layer_api_train as L

    paddle.set_device(place)
    model = L.build(paddle, cfg)
    model.set_state_dict(state)
    masks = L.masks_of(paddle, model)
    paddle.set_rng_state(rng_state)
    run = L.train(paddle, model, paddle.to_tensor(ids),
                  paddle.to_tensor(labels), steps, lr=1e-3)
    return run["losses"], masks


@pytest.mark.gpu
def test_layer_api_step_on_the_card_matches_the_cpu(card_place):
    """f32 (TF32 off), dropout 0.1: the layer API's Llama from the same
    weights and generator state, three AdamW steps on the card (the flash
    kernels) and on the CPU (their plain versions): the same dropout
    masks bit for bit, losses within rtol 1e-5."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import layer_api_train as L

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _small_layer_llama("float32", dropout=0.1)
    paddle.seed(3)
    state = {k: v.numpy() for k, v in L.build(paddle, cfg).state_dict(
        ).items()}
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (2, 256))
    labels = rng.randint(0, cfg.vocab_size, (2, 256))
    got, got_masks = _layer_train("gpu", cfg, ids, labels, state, (7, 0), 3)
    want, want_masks = _layer_train("cpu", cfg, ids, labels, state, (7, 0),
                                    3)
    paddle.set_device("gpu")
    assert len(got_masks) == len(want_masks) == 3 * (2 * 2 + 1)
    assert all(np.array_equal(a, b) for a, b in zip(got_masks, want_masks))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.gpu
def test_dropout_mask_and_seeded_linear_on_the_card_equal_the_cpu(
        card_place):
    """From one generator state a dropout mask (4 x 256 x 256, p 0.1) and,
    after ``paddle.seed(0)``, an ``nn.Linear(256, 512)``'s weights: the
    card's equal the CPU's bit for bit (threefry is integer arithmetic;
    the uniform transform is exact)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import layer_api_train as L

    card = L.mask_draw(paddle, (4, 256, 256), 0.1, "gpu:0", (5, 9))
    host = L.mask_draw(paddle, (4, 256, 256), 0.1, "cpu", (5, 9))
    assert torch.equal(card.cpu(), host)
    assert 0.88 < float(host.float().mean()) < 0.92
    wc, bc = L.seeded_linear(paddle, 256, 512)
    paddle.set_device("cpu")
    try:
        wh, bh = L.seeded_linear(paddle, 256, 512)
    finally:
        paddle.set_device("gpu")
    assert wc._data.is_cuda and torch.equal(wc._data.cpu(), wh._data)
    assert torch.equal(bc._data.cpu(), bh._data)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_load_round_trips_on_the_card(card_place, tmp_path, dtype):
    """``paddle.save`` of a card model's ``state_dict`` and ``paddle.load``
    into a fresh one: every entry bit-identical, on the card, in its
    dtype; the next step's loss bit-identical to the unbroken model's."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import layer_api_train as L

    cfg = _small_layer_llama(dtype)
    paddle.seed(1)
    model = L.build(paddle, cfg)
    path = str(tmp_path / "m.pdparams")
    paddle.save(model.state_dict(), path)
    loaded = paddle.load(path)
    for k, v in model.state_dict().items():
        assert loaded[k]._data.is_cuda and loaded[k].dtype == v.dtype
        assert torch.equal(loaded[k]._data, v._data), k
    rng = np.random.RandomState(1)
    ids = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (2, 128)))
    labels = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (2, 128)))
    run = L.train(paddle, model, ids, labels, 1)
    res = L.save_load_resume(paddle, model, cfg, ids, labels, run["opt"],
                             path=str(tmp_path / "r.pdparams"))
    assert res["bit_identical"] and not res["missing"], res


@pytest.mark.gpu
def test_layer_api_bf16_runs_k2_k4_on_the_tensor_cores(card_place):
    """bf16: three AdamW steps of the layer API's Llama launch K2, K3 and
    K4 once per layer a step, all on the tensor cores, and no plain
    version; the losses are finite and fall."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import layer_api_train as L

    cfg = _small_layer_llama("bfloat16")
    paddle.seed(2)
    model = L.build(paddle, cfg)
    rng = np.random.RandomState(2)
    ids = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (2, 256)))
    labels = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (2, 256)))
    routes = fa.route_launches()
    before = dict(fa.launches)
    run = L.train(paddle, model, ids, labels, 3, lr=1e-3)
    assert np.all(np.isfinite(run["losses"])), run
    assert run["losses"][-1] < run["losses"][0], run
    now = fa.route_launches()
    for k in now:
        assert now[k]["tensor_cores"] - routes[k]["tensor_cores"] == 6, now
        assert now[k]["fma"] == routes[k]["fma"], now
    assert all(fa.launches[k] - before[k] == 6 for k in before)


# ---------------------------------------------------------------------------
# the device RNG chain under run_steps; the ragged kernel's second pool
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_layer_trainstep_replay_is_bitwise_the_eager_step(card, dropout):
    """A tiny layer-API Llama (bf16) behind ``jit.TrainStep``: 2
    dispatches of run_steps(2) (capture, then replays) against 4
    ``__call__``s from the same weights and generator state: losses,
    parameters, the dropout masks and the chains bit-identical; one
    generator key per TrainStep and none per step; one capture."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import place as _place
    from paddle_tpu_torch.tools import layer_api_train as L

    saved = (_place._current_place, _place._current_device)
    paddle.set_device("gpu")
    try:
        cfg = L.LayerLlamaConfig(
            vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dropout=dropout, dtype="bfloat16")
        rng = np.random.RandomState(0)
        ids = paddle.to_tensor(rng.randint(0, 256, (2, 64)))
        labels = paddle.to_tensor(rng.randint(0, 256, (2, 64)))
        res = L.replay_against_calls(paddle, cfg, ids, labels, 2, rounds=2,
                                     sync=torch.cuda.synchronize)
    finally:
        _place._current_place, _place._current_device = saved
    assert res["losses_bit_identical"], res
    assert res["params_bit_identical"] and res["chains_equal"]
    assert res["masks_bit_identical"] in ((None,) if dropout == 0
                                          else (True,))
    assert res["generator_keys"] == {"call": (1, 0), "replay": (1, 0)}
    stats = res["graph_stats"]
    assert stats["captures"] == 1 and list(stats["replays"].values()) == [3]


def _mirror_batch(card, dtype, seed=0, nhb=24, h=32, kh=8):
    """``_batch`` (bs 16, GQA ``h``/``kh``, D 128) with each live slot's
    blocks below its first written block moved to a second pool: the
    entries become virtual (``nb + slot``) and the device copies are
    zeroed."""
    b = _batch(card, dtype, h, kh, 128, 16, seed=seed)
    nb = b["key_cache"].shape[0]
    hk = torch.zeros((nhb,) + tuple(b["key_cache"].shape[1:]), dtype=dtype,
                     device=card)
    hv = torch.zeros_like(hk)
    bt = b["block_tables"].cpu().numpy()
    cu = b["cu_seqlens"].cpu().numpy()
    ctx = b["context_lens"].cpu().numpy()
    slot = 0
    for i in range(int(b["num_seqs"][0])):
        first = (ctx[i] - (cu[i + 1] - cu[i])) // 16
        for j in range(first):
            e = int(bt[i, j])
            hk[slot], hv[slot] = b["key_cache"][e], b["value_cache"][e]
            b["key_cache"][e] = 0
            b["value_cache"][e] = 0
            bt[i, j] = nb + slot
            slot += 1
    assert slot > 0
    b["block_tables"] = torch.from_numpy(bt).to(card)
    return b, hk, hv


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_reads_the_second_pool(card, dtype):
    """Virtual entries inside the causal range read the mirror: against
    the plain version with the mirror (bf16: its ``round_to`` form in the
    kernel's splits) at ``flash_check.TOL``, and bit for bit against the
    kernel on one pool holding the same pages (the split does not depend
    on the pools)."""
    b, hk, hv = _mirror_batch(card, dtype)
    q, nb = b["q"], b["key_cache"].shape[0]
    scale = q.shape[-1] ** -0.5
    out, kc, vc = rpa.ragged_paged_attention(
        **b, scale=scale, host_key_cache=hk, host_value_cache=hv)
    idx = (b["block_tables"], b["cu_seqlens"], b["context_lens"],
           b["num_seqs"])
    split, _ = rpa.kernel_split(q, kc, b["block_tables"])
    tc = dtype == torch.bfloat16
    ref = rpa._ragged_attend_ref(q, kc, vc, *idx, scale,
                                 out_dtype=torch.float32,
                                 round_to=dtype if tc else None,
                                 split=split, hkc=hk, hvc=hv)
    one = rpa._ragged_attend_cuda(q, torch.cat([kc, hk]),
                                  torch.cat([vc, hv]), *idx, scale)
    torch.cuda.synchronize()
    live = int(b["cu_seqlens"][int(b["num_seqs"][0])])
    assert torch.all(out[live:] == 0)
    torch.testing.assert_close(out[:live].float(), ref[:live],
                               **flash_check.TOL[dtype])
    assert torch.equal(out, one)
    assert (b["block_tables"] >= nb).sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_reads_the_second_pool_at_rank_heads(card, dtype):
    """K1 with the host tier's mirror at a ``tp_degree=2`` rank's heads of
    Llama-3-8B (16 query, 4 kv, D 128): against the plain version with
    the mirror at ``flash_check.TOL`` (bf16: its ``round_to`` form in the
    kernel's splits), and bit for bit against one pool holding the same
    pages."""
    b, hk, hv = _mirror_batch(card, dtype, seed=3, h=16, kh=4)
    q, nb = b["q"], b["key_cache"].shape[0]
    assert q.shape[1] == 16 and b["key_cache"].shape[2] == 4
    scale = q.shape[-1] ** -0.5
    before = rpa.launches
    out, kc, vc = rpa.ragged_paged_attention(
        **b, scale=scale, host_key_cache=hk, host_value_cache=hv)
    assert rpa.launches == before + 1
    idx = (b["block_tables"], b["cu_seqlens"], b["context_lens"],
           b["num_seqs"])
    split, _ = rpa.kernel_split(q, kc, b["block_tables"])
    tc = dtype == torch.bfloat16
    ref = rpa._ragged_attend_ref(q, kc, vc, *idx, scale,
                                 out_dtype=torch.float32,
                                 round_to=dtype if tc else None,
                                 split=split, hkc=hk, hvc=hv)
    one = rpa._ragged_attend_cuda(q, torch.cat([kc, hk]),
                                  torch.cat([vc, hv]), *idx, scale)
    torch.cuda.synchronize()
    live = int(b["cu_seqlens"][int(b["num_seqs"][0])])
    assert torch.all(out[live:] == 0)
    torch.testing.assert_close(out[:live].float(), ref[:live],
                               **flash_check.TOL[dtype])
    assert torch.equal(out, one)
    assert (b["block_tables"] >= nb).sum() > 0


@pytest.mark.gpu
def test_a_virtual_entry_write_is_dropped_on_the_card(card):
    """A row whose entry is virtual writes nothing (the mirror is read
    only), every other row lands in the cache, and the kernel launches."""
    b, hk, hv = _mirror_batch(card, torch.bfloat16, seed=1)
    bt = b["block_tables"].clone()
    nb = b["key_cache"].shape[0]
    bt[1, :] = torch.where(bt[1] >= 0, nb + 20 + torch.arange(
        bt.shape[1], device=card) % 4, bt[1])
    b["block_tables"] = bt
    hk0, hv0 = hk.clone(), hv.clone()
    kc_ref, vc_ref = b["key_cache"].clone(), b["value_cache"].clone()
    seg, pos, _ = rpa._token_layout(b["q"].shape[0], bt.shape[0],
                                    b["cu_seqlens"], b["context_lens"],
                                    b["num_seqs"])
    rpa._write_kv(kc_ref, b["k_new"], bt, seg, pos)
    rpa._write_kv(vc_ref, b["v_new"], bt, seg, pos)
    before = rpa.launches
    rpa.ragged_paged_attention(**b, host_key_cache=hk, host_value_cache=hv)
    torch.cuda.synchronize()
    assert rpa.launches == before + 1
    assert torch.equal(b["key_cache"], kc_ref)
    assert torch.equal(b["value_cache"], vc_ref)
    assert torch.equal(hk, hk0) and torch.equal(hv, hv0)


@pytest.mark.gpu
def test_tiny_tiered_engine_card_matches_untiered_and_cpu(card):
    """LlamaConfig.tiny in f32 (TF32 off): a 60-token prompt + 12 new on
    an 8-block tiered engine (demotes, mirror steps) serves the tokens of
    a 256-block untiered engine on the card and of the tiered engine on
    the CPU, from the same weights."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (EngineConfig, LLMEngine,
                                          SamplingParams)
    from paddle_tpu_torch.tools.llama3_8b_tiers import MirrorSteps

    torch.backends.cuda.matmul.allow_tf32 = False
    prompt = [int(t) for t in np.random.RandomState(3).randint(1, 256, 60)]
    kw = dict(block_size=4, max_num_seqs=4, max_model_len=96,
              max_batched_tokens=16)
    got = {}
    for name, dev, extra in (
            ("tiered", card, dict(num_blocks=8,
                                  kv_tiers={"num_host_blocks": 32})),
            ("untiered", card, dict(num_blocks=256)),
            ("cpu", torch.device("cpu"),
             dict(num_blocks=8, kv_tiers={"num_host_blocks": 32}))):
        model = LlamaForCausalLM(LlamaConfig.tiny(), device=dev)
        model.init_weights(torch.Generator(device=dev).manual_seed(0))
        if dev.type == "cpu":
            model.load_state_dict({k: v.cpu() for k, v in
                                   got["weights"].items()})
        else:
            got.setdefault("weights", model.state_dict())
        eng = LLMEngine(model, EngineConfig(**kw, **extra))
        steps = MirrorSteps(eng) if name == "tiered" else None
        eng.add_request("r", prompt, SamplingParams(max_new_tokens=12))
        eng.run()
        got[name] = list(eng.get_request("r").generated)
        if steps is not None:
            assert eng.block_manager.num_demotes > 0
            assert steps.mirror_steps > 0
    assert got["tiered"] == got["untiered"] == got["cpu"], got


@pytest.mark.gpu
def test_kernel_refuses_a_mirror_it_does_not_take(card):
    """No fallback for the second pool: a mirror in another dtype, of
    other pages, on the CPU, or without its value half raises before any
    launch."""
    b, hk, hv = _mirror_batch(card, torch.bfloat16, seed=2)
    before = rpa.launches
    for bad_k, bad_v in ((hk.float(), hv.float()), (hk[:, :8], hv[:, :8]),
                         (hk.cpu(), hv.cpu()), (hk, None)):
        with pytest.raises(ValueError, match="ragged_paged_attention"):
            rpa.ragged_paged_attention(**b, host_key_cache=bad_k,
                                       host_value_cache=bad_v)
    assert rpa.launches == before


# ---------------------------------------------------------------------------
# the long tail (PR 13): every case of the vision, long-tail and nn long
# tail sections, the ops at reduced published sizes, the packed flash
# wrappers and the DeepSpeech2-widths model, the card against the CPU
# ---------------------------------------------------------------------------
from paddle_tpu_torch.tools import long_tail_cases as _LC  # noqa: E402


@pytest.mark.gpu
@pytest.mark.parametrize("case", _LC.CASES, ids=[c.id for c in _LC.CASES])
def test_long_tail_case_on_the_card_matches_the_cpu(card_place, case):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import place

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got, ggot, sgot = _LC.run_case(case, paddle.CUDAPlace(0))
    place.set_device("cpu")
    try:
        want, gwant, swant = _LC.run_case(case, paddle.CPUPlace())
    finally:
        place.set_device("gpu")
    bad, _, _ = _LC.compare(case, (got, ggot, sgot), (want, gwant, swant))
    assert not bad, bad


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ctc", "rnnt", "roi_align",
                                  "deform_conv2d", "grid_sample",
                                  "yolo_loss"])
def test_long_tail_op_at_a_reduced_published_size(card_place, name):
    """``tools/long_tail_sizes.py`` at its CPU-check batch: values and
    gradients within the workload's tolerance (rtol 1e-4 and 1e-4 x the
    CPU's largest magnitude; CTC's 1e-3 x)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.tools import long_tail_sizes as LS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = LS.WORKLOADS[name]
    got = LS.numpy(LS.forward_backward(spec["make"](spec["check"],
                                                    paddle.CUDAPlace(0))))
    place.set_device("cpu")
    try:
        want = LS.numpy(LS.forward_backward(spec["make"](
            spec["check"], paddle.CPUPlace())))
    finally:
        place.set_device("gpu")
    rtol, share = spec.get("tol", LS.TOL)
    for key in want:
        scale = float(np.abs(want[key]).max())
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   atol=share * scale, err_msg=key)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attn_qkvpacked_is_flash_attention_on_the_card(card_place,
                                                             dtype):
    """The packed wrapper runs K2-K4 once each and gives, bit for bit,
    ``F.flash_attention`` on the contiguous slices, its gradient packed."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import functional as F

    rng = np.random.default_rng(13)
    qkv_np = rng.standard_normal((2, 300, 3, 4, 64)).astype(np.float32)
    do_np = rng.standard_normal((2, 300, 4, 64)).astype(np.float32)
    qkv = paddle.to_tensor(qkv_np, dtype=dtype, stop_gradient=False)
    do = paddle.to_tensor(do_np, dtype=dtype)
    before = dict(fa.launches)
    out, _ = F.flash_attn_qkvpacked(qkv, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert {k: fa.launches[k] - before[k] for k in fa.launches} == {
        "flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkv": 1}
    parts = [paddle.to_tensor(qkv._data[:, :, i].detach().contiguous(),
                              stop_gradient=False) for i in range(3)]
    ref, _ = F.flash_attention(*parts, causal=True)
    ref.backward(do)
    assert torch.equal(out._data, ref._data)
    g = qkv.grad._data
    assert tuple(g.shape) == (2, 300, 3, 4, 64)
    for i in range(3):
        assert torch.equal(g[:, :, i], parts[i].grad._data)


@pytest.mark.gpu
def test_flash_attn_varlen_qkvpacked_is_unpadded_on_the_card(card_place):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import functional as F

    lens = [130, 7, 64]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    x = np.random.default_rng(3).standard_normal(
        (int(cu[-1]), 3, 4, 64)).astype(np.float32)
    qkv = paddle.to_tensor(x, dtype="bfloat16")
    cut = paddle.to_tensor(cu)
    out, _ = F.flash_attn_varlen_qkvpacked(qkv, cut, cut, 130, 130,
                                           causal=True)
    ref, _ = F.flash_attn_unpadded(
        *(paddle.to_tensor(x[:, i], dtype="bfloat16") for i in range(3)),
        cut, cut, 130, 130, scale=64 ** -0.5, causal=True)
    assert torch.equal(out._data, ref._data)


@pytest.mark.gpu
def test_ds2_widths_model_card_matches_cpu(card_place):
    """DeepSpeech2's recurrent widths at 1 layer, batch 2, 60 frames:
    loss within rtol 1e-4, every gradient within relative L2 1e-4."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import ds2_ctc_train as D

    res = D.card_against_cpu(paddle, layers=1, batch_size=2, frames=60,
                             labels=(10, 20))
    paddle.set_device("gpu")
    assert res["loss_rel_err"] <= 1e-4, res
    assert res["grad_rel_l2_max"] <= 1e-4, res


@pytest.mark.gpu
def test_tp2_engine_on_one_card_serves_the_k1_tokens(card):
    """Two ranks of a ``tp_degree=2`` engine on this card (the testing
    hook) serve the tiny Llama in f32 with the k = 1 engine's tokens,
    greedy and sampled; rank 1 launched K1 once a layer a step."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa_
    from paddle_tpu_torch.serving import (EngineConfig, LLMEngine,
                                          SamplingParams)
    from paddle_tpu_torch.testing import tp_hooks

    rng = np.random.default_rng(14)
    prompts = [list(map(int, rng.integers(0, 256, size=n)))
               for n in (5, 19, 33, 8)]
    tokens = {}
    for tp in (1, 2):
        m = LlamaForCausalLM(LlamaConfig.tiny(), device=card).init_weights(
            torch.Generator(device=card).manual_seed(0))
        with tp_hooks.ranks_share_one_device():
            eng = LLMEngine(m, EngineConfig(tp_degree=tp, block_size=4,
                                            max_num_seqs=4, max_model_len=64))
        if tp == 2:
            assert eng._tp.backend == "gloo"
            eng._tp.report(reset=True)
            rpa_.launches = 0
        for i, p in enumerate(prompts):
            eng.add_request(f"r{i}", p, SamplingParams(
                max_new_tokens=6, temperature=0.7 if i == 1 else 0.0,
                seed=5))
        eng.run()
        tokens[tp] = [eng.get_request(f"r{i}").generated
                      for i in range(len(prompts))]
        if tp == 2:
            (rank1,) = eng._tp.report()
            steps = eng.metrics.engine_steps
            assert rank1["k1_launches"] == rpa_.launches == 2 * steps
        del eng, m
    assert tokens[1] == tokens[2]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_ship_round_trip_lands_in_place_and_graphs_replay(card, dtype):
    """The fleet's KV ship on the card: a request prefilled by engine A
    is exported (``export_kv``) and imported (``import_kv``) by engine B,
    whose step graphs were captured before: the shipped blocks equal A's
    bit for bit, B's caches are the same tensors at the same addresses,
    B re-exports the same message, and B's decode steps replay its
    captured graphs (no new capture) to A's tokens."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (EngineConfig, LLMEngine,
                                          SamplingParams)

    torch.backends.cuda.matmul.allow_tf32 = False
    m = LlamaForCausalLM(LlamaConfig.tiny(dtype=dtype), device=card)
    m.init_weights(torch.Generator(device=card).manual_seed(0))
    kw = dict(block_size=4, max_num_seqs=4, max_model_len=64)
    prompt = [int(t) for t in np.random.RandomState(8).randint(1, 256, 22)]
    sp = SamplingParams(max_new_tokens=8)
    a = LLMEngine(m, EngineConfig(**kw))
    a.add_request("x", prompt, sp)
    a.run()
    want = list(a.get_request("x").generated)
    a.release_request("x")

    b = LLMEngine(m, EngineConfig(**kw))
    b.add_request("warm", prompt, sp)       # captures b's buckets
    b.run()
    b.release_request("warm")
    ptrs = (b._kcs.data_ptr(), b._vcs.data_ptr())
    caches = (b._kcs, b._vcs)

    a.add_request("x", prompt, sp)
    a.step()                                # prefill + the first token
    first = list(a.get_request("x").generated)
    meta, payload = a.export_kv("x")
    b.import_kv("x", prompt + first, sampling=SamplingParams(
        max_new_tokens=7), meta=meta, payload=payload,
        rng_state={"device_key": [int(k) for k in
                                  a.get_request("x").device_key]})
    torch.cuda.synchronize()
    assert (b._kcs.data_ptr(), b._vcs.data_ptr()) == ptrs
    assert b._kcs is caches[0] and b._vcs is caches[1]
    n = meta["tokens_covered"]
    ta = a.block_manager.export_blocks("x", n)
    tb = b.block_manager.export_blocks("x", n)
    assert torch.equal(b._kcs[:, tb], a._kcs[:, ta])
    assert torch.equal(b._vcs[:, tb], a._vcs[:, ta])
    assert b.export_kv("x") == (meta, payload)
    assert meta["dtype"] == dtype
    snap = b._graphs.snapshot()
    b.run()
    window = b._graphs.since(snap)
    assert window["captures"] == 0, window
    assert sum(window["replays"].values()) > 0, window
    assert first + list(b.get_request("x").generated) == want


def _tiny_tp_engine(card, tp, seed=0, **kw):
    """``LlamaConfig.tiny`` in f32 (TF32 off) from ``seed`` behind an
    engine at ``tp_degree=tp``, every rank on this card."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import EngineConfig, LLMEngine
    from paddle_tpu_torch.testing import tp_hooks

    torch.backends.cuda.matmul.allow_tf32 = False
    m = LlamaForCausalLM(LlamaConfig.tiny(), device=card).init_weights(
        torch.Generator(device=card).manual_seed(seed))
    if kw.get("draft_model") == "target":
        kw["draft_model"] = m
    kw.setdefault("block_size", 4)
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("max_model_len", 64)
    with tp_hooks.ranks_share_one_device():
        return LLMEngine(m, EngineConfig(tp_degree=tp, **kw))


@pytest.mark.gpu
def test_tp2_kv_import_on_one_card_writes_in_place(card):
    """A KV ship from a k = 1 engine into a ``tp_degree=2`` engine on this
    card: rank 0's caches stay the same tensors at the same addresses,
    the importer's re-export (a gather from both ranks' caches) holds
    the exporter's bytes split by kv heads bit for bit, and the steps
    after the import give the exporter's tokens."""
    from paddle_tpu_torch.serving import SamplingParams

    prompt = [int(t) for t in np.random.RandomState(8).randint(1, 256, 22)]
    sp = SamplingParams(max_new_tokens=8)
    a = _tiny_tp_engine(card, 1)
    a.add_request("x", prompt, sp)
    a.run()
    want = list(a.get_request("x").generated)
    a.release_request("x")
    b = _tiny_tp_engine(card, 2)
    b.add_request("warm", prompt[:9], sp)
    b.run()
    b.release_request("warm")
    ptrs = (b._kcs.data_ptr(), b._vcs.data_ptr())
    caches = (b._kcs, b._vcs)
    a.add_request("x", prompt, sp)
    a.step()
    first = list(a.get_request("x").generated)
    meta, payload = a.export_kv("x")
    b.import_kv("x", prompt + first, sampling=SamplingParams(
        max_new_tokens=7), meta=meta, payload=payload,
        rng_state={"device_key": [int(k) for k in
                                  a.get_request("x").device_key]})
    torch.cuda.synchronize()
    assert b.num_kv_reshards == 1
    assert (b._kcs.data_ptr(), b._vcs.data_ptr()) == ptrs
    assert b._kcs is caches[0] and b._vcs is caches[1]
    bmeta, bpayload = b.export_kv("x")
    assert bmeta["layout"]["mesh_axes"] == [["tp", 2]]
    assert bmeta["shape"] == meta["shape"]
    L, n, bs, kh, d = meta["shape"]
    frames = np.frombuffer(bpayload, np.float32).reshape(2, 2, L, n, bs,
                                                         kh // 2, d)
    ta = a.block_manager.export_blocks("x", meta["tokens_covered"])
    for j, cache in enumerate((a._kcs, a._vcs)):
        full = cache[:, ta].cpu().numpy()
        for r in range(2):
            np.testing.assert_array_equal(
                frames[j, r], full[:, :, :, r * kh // 2:(r + 1) * kh // 2])
    b.run()
    assert first + list(b.get_request("x").generated) == want


@pytest.mark.gpu
def test_tp2_tiers_and_sessions_on_one_card_serve_the_k1_tokens(card):
    """A ``tp_degree=2`` tiered engine on this card (8 device blocks, 32
    host blocks; each rank's mirror its K1 second pool): a 62-token
    prompt + 12 new demotes, reads the mirror, and serves the k = 1
    tiered engine's tokens; the finished request parked and resumed with
    a longer prompt reuses its whole chain (its tail framed per rank)
    and serves the k = 1 engine's turn 2."""
    from paddle_tpu_torch.serving import SamplingParams
    from paddle_tpu_torch.tools.llama3_8b_tiers import MirrorSteps

    prompt = [int(t) for t in np.random.RandomState(3).randint(1, 256, 62)]
    sp = SamplingParams(max_new_tokens=12)
    got = {}
    for tp in (1, 2):
        eng = _tiny_tp_engine(card, tp, max_model_len=96,
                              max_batched_tokens=16, num_blocks=8,
                              kv_tiers={"num_host_blocks": 32})
        steps = MirrorSteps(eng)
        eng.add_request("r", prompt, sp)
        eng.run()
        turn1 = list(eng.get_request("r").generated)
        assert eng.block_manager.num_demotes > 0 and steps.mirror_steps > 0
        eng.release_request("r")
        info = eng.park_session("r")
        tail = eng._kvtier.sessions["r"].tail_k
        assert tuple(tail.shape) == ((2, 2, 1, 4, 1, 16) if tp == 2
                                     else (2, 1, 4, 2, 16))
        hit = eng.resume_session("r2", "r", prompt + turn1 + [5, 6, 7],
                                 sampling=SamplingParams(max_new_tokens=6))
        assert hit == info["tokens_covered"]
        eng.run()
        assert eng._kvtier.num_resume_recomputed_tokens == 0
        eng.block_manager.check_invariants()
        got[tp] = (turn1, list(eng.get_request("r2").generated))
        del eng, steps
    assert got[1] == got[2], got


@pytest.mark.gpu
def test_tp2_spec_on_one_card_serves_the_k1_tokens(card):
    """A ``tp_degree=2`` speculative engine on this card whose draft is
    its target (copied whole to rank 0 before the hand-off; the draft's
    forwards captured, K2): greedy and sampled tokens and the draft
    counters equal the k = 1 spec engine's; rank 1 launched K1 once a
    layer a step and no K2."""
    from paddle_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(21)
    prompts = [list(map(int, rng.integers(0, 256, size=n)))
               for n in (5, 19, 33, 8)]
    got = {}
    for tp in (1, 2):
        eng = _tiny_tp_engine(card, tp, draft_model="target",
                              num_spec_tokens=3)
        if tp == 2:
            eng._tp.report(reset=True)
            snap = eng._spec.graphs.snapshot()
        for i, p in enumerate(prompts):
            eng.add_request(f"s{i}", p, SamplingParams(
                max_new_tokens=8, temperature=0.7 if i == 1 else 0.0,
                seed=5))
        eng.run()
        got[tp] = ([eng.get_request(f"s{i}").generated
                    for i in range(len(prompts))],
                   eng.num_spec_proposed, eng.num_spec_accepted)
        if tp == 2:
            (rank1,) = eng._tp.report()
            assert rank1["k1_launches"] == 2 * eng.metrics.engine_steps
            assert rank1["k2_launches"] == 0
            win = eng._spec.graphs.since(snap)
            assert win["executed_launches"]["flash_attention_fwd"] > 0
            assert eng._spec.model is not eng.model
        del eng
    assert got[1] == got[2], got
    assert got[2][2] > 0


@pytest.mark.gpu
def test_tiny_two_replica_fleet_on_the_card_serves_one_engines_tokens(card):
    """``LlamaConfig.tiny`` in f32 (TF32 off) on the card: a two-replica
    ``FleetRouter`` over one model (two engines, each with its own graphs
    and caches), and a prefill/decode pair with KV ship, serve one
    engine's greedy and sampled tokens; every request finishes once."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (EngineConfig, LLMEngine,
                                          SamplingParams)
    from paddle_tpu_torch.serving.fleet import (FleetConfig, FleetRouter,
                                                InProcessReplica)

    torch.backends.cuda.matmul.allow_tf32 = False
    m = LlamaForCausalLM(LlamaConfig.tiny(), device=card)
    m.init_weights(torch.Generator(device=card).manual_seed(0))
    kw = dict(block_size=4, max_num_seqs=4, max_model_len=64,
              drain_grace_s=0.0)
    rng = np.random.default_rng(17)
    work = [(f"f{i}", list(map(int, rng.integers(1, 256, size=n))),
             SamplingParams(max_new_tokens=8, temperature=0.8 if i % 2
                            else 0.0, top_p=0.9))
            for i, n in enumerate((7, 18, 11, 29, 4))]
    ref = LLMEngine(m, EngineConfig(**kw))
    for rid, p, sp in work:
        ref.add_request(rid, p, sp)
    ref.run()
    want = {rid: list(ref.get_request(rid).generated) for rid, _, _ in work}
    for roles in (None, {"a": "prefill", "b": "decode"}):
        reps = [InProcessReplica(m, EngineConfig(**kw), replica_id=r)
                for r in ("a", "b")]
        router = FleetRouter(reps, FleetConfig(roles=roles))
        for rid, p, sp in work:
            router.add_request(rid, p, sp)
        outs = []
        while router.has_unfinished():
            outs.extend(router.step())
            assert len(outs) < 1000
        finals = [o.request_id for o in outs if o.finished]
        assert sorted(finals) == sorted(want)
        got = {rid: list(router.get_request(rid).generated) for rid in want}
        assert got == want, roles
        if roles:
            snap = router.snapshot()
            assert snap["fleet_kv_ship_requests"] == len(work)
            assert snap["fleet_tokens_recomputed"] == 0


# ---------------------------------------------------------------------------
# hybrid-parallel training (slice D1): ranks sharing the card over gloo
# ---------------------------------------------------------------------------
# a small Llama (head_dim 64: the flash kernels' tensor-core route) and
# batch for phase 28's machinery at card-test size
HYBRID_TINY = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=4, max_position_embeddings=128,
                   batch=(4, 128))


@pytest.fixture(scope="module")
def hybrid_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.tools import gpt_1b_hybrid_train as H

    return H.run(parts=("a",), timeout_s=300.0, shrink=HYBRID_TINY)


@pytest.mark.gpu
def test_hybrid_dp_mp_steps_on_one_card_match_one_rank(hybrid_run):
    """Four gloo ranks on the card (dp 2, mp 2, dp 2 x mp 2 with and
    without SP, eager DataParallel): each case's losses and parameter
    shards match a one-rank TrainStep on the card (losses rtol 1e-4, the
    parameters at the AdamW bound of phase 28); no rank outlives the
    run."""
    assert hybrid_run["alive_after"] == []
    for r in hybrid_run["ranks"]:
        assert r["backend"] == "gloo" and r["device"] == "cuda:0"
        for name in ("dp2", "mp2", "dp2_mp2", "dp2_mp2_sp",
                     "data_parallel_dp2"):
            c = r["cases"].get(name)
            if c is not None:
                assert c["losses_ok"], (name, c)
                assert c["params"]["within_adam_bound"], (name, c)


@pytest.mark.gpu
def test_hybrid_zero3_step_on_one_card_matches_stage0(hybrid_run):
    """ZeRO 1-3 at dp 2 give the stage-0 losses and parameters; each
    rank's optimizer state is the reckoned share."""
    base = hybrid_run["ranks"][0]["cases"]["dp2"]
    seen = set()
    for r in hybrid_run["ranks"]:
        for name in ("zero1_dp2", "zero2_dp2", "zero3_dp2"):
            c = r["cases"].get(name)
            if c is None:
                continue
            seen.add(name)
            assert c["losses_ok"], (name, c)
            assert c["params"]["within_adam_bound"], (name, c)
            np.testing.assert_allclose(c["losses"], base["losses"],
                                       rtol=1e-4)
            assert c["slot_bytes"] == c["reckoned_slot_bytes"], (name, c)
    assert seen == {"zero1_dp2", "zero2_dp2", "zero3_dp2"}
    assert hybrid_run["ranks"][0]["cases"]["zero3_dp2"]["slot_bytes"] * 2 \
        == base["slot_bytes"]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,d", [(2, 256, 8, 128), (1, 128, 2, 64)])
def test_flash_kernels_at_a_hybrid_rank_heads(card, b, s, h, d):
    """K2-K4 at a data- and model-parallel rank's share of a batch and of
    the heads (bf16, causal) hold their plain versions (flash_check)."""
    gen = torch.Generator(device=card).manual_seed(28)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=card)
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    before = dict(fa.launches)
    o, lse = fa._flash_fwd_cuda(q, k, v, scale, True)
    delta = fa._delta(o, do)
    dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, True)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, True)
    torch.cuda.synchronize()
    assert all(fa.launches[n] == before[n] + 1 for n in fa.launches)
    flash_check.check(q, k, v, do, {"o": o, "lse": lse, "dq": dq, "dk": dk,
                                    "dv": dv}, scale, True)


# ---------------------------------------------------------------------------
# pipeline-parallel training (slice D2): two ranks sharing the card
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pipe_pairs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.testing import pipeline_ranks

    return pipeline_ranks.card_pairs()


@pytest.mark.gpu
def test_pipeline_pp2_f32_on_one_card_matches_one_rank(pipe_pairs):
    """pp 2 of the Llama Pipe on the card (gloo through the host) against
    the one-rank TrainStep of the same model and batch: losses rtol
    1e-4, each stage parameter within phase 28's AdamW bound."""
    for r in pipe_pairs[("float32", False)]:
        np.testing.assert_allclose(r["losses"], r["ref_losses"], rtol=1e-4)
        for name, p in r["params"].items():
            assert p["max_abs_err"] <= 2.5e-4, (name, p)
            assert p["beyond_1e-5"] < 1e-3 * p["elements"], (name, p)


@pytest.mark.gpu
def test_pipeline_pp2_bf16_on_one_card_matches_one_rank(pipe_pairs):
    """The same in bf16 with f32 master weights on both sides: losses
    within phase 29's 0.02 nats of the one-rank run, the first step's
    gradients the f32 sum of its two chunks' over 2, bit for bit, and
    under 1% of each parameter's master weight more than lr / 2 from the
    one-rank run's (``pipeline_ranks.pair_faults``)."""
    from paddle_tpu_torch.testing import pipeline_ranks

    for r in pipe_pairs[("bfloat16", False)]:
        assert r["compared"] == "master_weight"
        assert pipeline_ranks.pair_faults(r) == []


@pytest.mark.gpu
def test_tied_pipe_copies_bitwise_equal_after_a_step(pipe_pairs):
    """The tied Pipe: after the steps the table rank 0's embedding and
    rank 1's head gather is the same bits on both ranks, and the run
    matches the one-rank tied model."""
    a, b = pipe_pairs[("float32", True)]
    np.testing.assert_array_equal(a["tied_table"], b["tied_table"])
    for r in (a, b):
        np.testing.assert_allclose(r["losses"], r["ref_losses"], rtol=1e-4)


# ---------------------------------------------------------------------------
# context parallelism and the mixture of experts (slice D3)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_chunked_kernel_path_matches_the_plain_recurrence(card, dtype):
    """Every rank's body of a causal ring of 2 at phase 30's chunk
    (B 2, S 1024, H 16, D 128): f32 against the reference's plain
    recurrence and its autograd at ``flash_check.TOL``; bf16 chunk by
    chunk, K2 and K3/K4 (given the merged lse and delta) by
    ``flash_check``. Rank 0 runs one chunk, rank 1 two: 3 launches of
    each kernel."""
    from paddle_tpu_torch.testing import cp_ranks

    before = dict(fa.launches)
    res = cp_ranks.ring_path_check(card, (2, 1024, 16, 128),
                                   dtypes=(dtype,))
    assert dtype in res
    assert all(fa.launches[n] == before[n] + 3 for n in fa.launches)


@pytest.fixture(scope="module")
def cp_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.tools import gpt_1b_cp_train as C

    return C.run(parts=("a", "b"), timeout_s=300.0, shrink=HYBRID_TINY)


@pytest.mark.gpu
def test_context_parallel_steps_on_one_card_match_one_rank(cp_run):
    """Four gloo ranks on the card, the Llama sequence-sharded over sp
    (dp 2 x sp 2, sp 4, dp 2 x sp 2 ZeRO 1): each case's losses and
    parameter shards match a one-rank TrainStep of the dense model
    (phase 28's bounds); the bf16 run launches K2-K4 (r + 1) x layers x
    steps times on the rank at sp index r; no rank outlives the run."""
    from paddle_tpu_torch.tools import gpt_1b_cp_train as C

    assert cp_run["alive_after"] == []
    for r in cp_run["ranks"]:
        assert r["backend"] == "gloo" and r["device"] == "cuda:0"
        for name, c in r["cases"].items():
            assert c["losses_ok"], (name, c["losses"])
            assert c["params"]["within_adam_bound"], (name, c["params"])
            assert c["slot_bytes"] == c["reckoned_slot_bytes"], name
        f = r["full"]
        assert f["losses"] == cp_run["ranks"][0]["full"]["losses"]
        assert np.isfinite(f["losses"]).all()
        assert f["kernel_launches"] == C.reckoned_launches(
            f["sp_index"], HYBRID_TINY["num_hidden_layers"], C.TIMED_STEPS)
        assert f["p2p_bytes_per_step"] > 0


@pytest.fixture(scope="module")
def moe_pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.testing import gloo_ranks, moe_ranks, tp_hooks

    with tp_hooks.ranks_share_one_device():
        return gloo_ranks.run(moe_ranks.card_pair, 2, "cuda",
                              timeout_s=300)


@pytest.mark.gpu
def test_moe_ep2_pair_on_one_card_matches_one_rank(moe_pair):
    """An ep 2 pair on the card (``moe_ranks.CARD_PAIR``): with the batch
    replicated over ep and sharded over it (the all-to-all), three f32
    AdamW steps give the one-rank TrainStep's losses (rtol 1e-4) and
    parameters (phase 28's AdamW bound); the sharded ranks' dropped
    choices add up to the one-rank run's, step by step; bf16 sharded
    within 0.02 of the one-rank bf16 losses."""
    from paddle_tpu_torch.tools import moe_train

    one = moe_pair[0]["reference_f32"]["dropped"]
    for r in moe_pair:
        for name, c in r["f32"].items():
            assert c["losses_ok"], (name, c["losses"],
                                    r["reference_f32"]["losses"])
            assert c["params"]["within_adam_bound"], (name, c["params"])
        assert r["f32"]["ep2_replicated"]["dropped"] == one
        assert r["bf16"]["max_loss_diff"] <= moe_train.BF16_LOSS_ATOL
        assert np.isfinite(r["bf16"]["losses"]).all()
    assert [a + b for a, b in zip(
        moe_pair[0]["f32"]["ep2_sharded"]["dropped"],
        moe_pair[1]["f32"]["ep2_sharded"]["dropped"])] == one


# ---------------------------------------------------------------------------
# the gang (slice D4): the launcher, the gang watchdog, multi-rank
# checkpoints
# ---------------------------------------------------------------------------
def _gang_launch(tmp_path, tag, extra=(), env=()):
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / tag
    out.mkdir()
    e = dict(os.environ, PADDLE_TORCH_RANKS_SHARE_DEVICE="1",
             PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    e.update(dict(env))
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--log_dir", str(out / "logs"), *extra,
         os.path.join(repo, "paddle_tpu_torch/tools/gpt_1b_gang_train.py"),
         "--ckpt", str(tmp_path / f"ckpt_{tag}"), "--out", str(out),
         "--tiny", "--dp", "2", "--mp", "1"],
        env=e, capture_output=True, text=True, timeout=300)
    res = {p.name: json.loads(p.read_text())
           for p in out.glob("result.*.json")}
    logs = [(out / "logs" / f"workerlog.{i}").read_text() for i in (0, 1)]
    return r, res, logs


@pytest.mark.gpu
def test_gang_pair_hangs_restarts_and_resumes_bit_identically(card,
                                                              tmp_path):
    """Two ranks share the card (the port's launcher, gloo): rank 1 hangs
    in step 3 and exits 6 naming its collective, rank 0 exits 7 naming
    rank 1, the launcher relaunches the gang, and attempt 1 resumes at
    step 2: steps 3-4's losses and every parameter's and slot's sha256
    bit-identical to an unbroken run's (the tiny Llama, f32, dp 2)."""
    r, base, _ = _gang_launch(tmp_path, "unbroken")
    assert r.returncode == 0, r.stderr[-4000:]
    r, hung, logs = _gang_launch(
        tmp_path, "hang", ("--max_restart", "1"),
        {"GANG_HANG": "1:3", "PADDLE_STEP_TIMEOUT": "6",
         "PADDLE_ABORT_POLL": "0.5"})
    assert r.returncode == 0, r.stderr[-4000:]
    assert "[launch] rank 1 exited rc=6" in r.stderr
    assert "[launch] rank 0 exited rc=7" in r.stderr
    assert r.stderr.count("restarting") == 1
    assert "[watchdog] rank 1: step(s) [all_reduce@ranks[0, 1]]" in logs[1]
    assert "[watchdog] rank 1 aborted on [all_reduce@ranks[0, 1]]" in \
        logs[0]
    for rank in (0, 1):
        a = base[f"result.attempt0.rank{rank}.json"]
        b = hung[f"result.attempt1.rank{rank}.json"]
        assert a["device"] == b["device"] == "cuda:0"
        assert b["resumed_from"] == 2
        assert b["losses"] == {k: v for k, v in a["losses"].items()
                               if int(k) >= 3}
        assert b["sha256"] == a["sha256"]
        assert all(n == 2 * 2 for n in b["kernel_launches"].values())


# ---------------------------------------------------------------------------
# the rest of slice D: a pipeline checkpoint, Lamb in the pipeline, a
# masked context-parallel call (two ranks sharing the card)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def slice_d(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.testing import gloo_ranks, pipeline_ranks, tp_hooks

    path = str(tmp_path_factory.mktemp("pipe_ckpt") / "ckpt")
    with tp_hooks.ranks_share_one_device():
        return gloo_ranks.run(pipeline_ranks.card_slice_d, 2, path,
                              timeout_s=300)


@pytest.mark.gpu
def test_pipeline_checkpoint_round_trip_on_one_card(slice_d):
    """pp 2 on the card: a save after step 2, a rebuilt stage and step
    restore it, and step 3's loss, parameters and slots are bit-identical
    to the unbroken run's."""
    for r in slice_d:
        t = r["round_trip"]
        assert t["bit_identical"] and t["slots"] > 0, t


@pytest.mark.gpu
def test_pipeline_lamb_on_one_card_matches_one_rank(slice_d):
    """pp 2 with Lamb (one trust ratio per parameter) against the one-rank
    TrainStep with Lamb: losses rtol 1e-4, each parameter within phase
    28's 2.5e-4, moved from its start, and its update within phase 29's
    Lamb bound of the one-rank update (a trust ratio off by k reads
    |k - 1|)."""
    from paddle_tpu_torch.tools.gpt_1b_pipe_train import LAMB_UPDATE_REL

    for r in slice_d:
        lamb = r["lamb"]
        np.testing.assert_allclose(lamb["losses"], lamb["ref_losses"],
                                   rtol=1e-4)
        assert lamb["max_abs_err"] <= 2.5e-4, lamb
        assert lamb["update"]["unmoved"] == [], lamb["update"]
        assert lamb["update"]["max_rel_err"] <= LAMB_UPDATE_REL, \
            lamb["update"]


@pytest.mark.gpu
def test_masked_context_parallel_call_on_one_card(slice_d):
    """sp 2 given a padding mask: each rank's logits and the gradients
    summed over the ranks within 1e-4 of the one-rank dense model's
    largest values."""
    for r in slice_d:
        assert r["masked"]["max_rel_err"] <= 1e-4, r["masked"]


# -- slice E2a and the high-level API ----------------------------------------
def _small_bert(paddle, cls, seed=0):
    from paddle_tpu_torch.models import bert

    paddle.seed(seed)
    cfg = bert.BertConfig(vocab_size=128, hidden_size=32,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=64, max_position_embeddings=64)
    return cfg, getattr(bert, cls)(cfg)


def _bert_fit_once(paddle, device, state, rng, ids, types, y):
    """One ``Model.fit`` batch of the small BERT classifier on
    ``device`` (dropout on), then an eval forward: (loss, logits)."""
    paddle.set_device(device)
    _, net = _small_bert(paddle, "BertForSequenceClassification")
    if state is not None:
        net.set_state_dict(state)
    paddle.set_rng_state(rng)
    m = paddle.Model(net, inputs=[None, None])
    m.prepare(paddle.optimizer.AdamW(1e-3, parameters=net.parameters()),
              paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    n = len(y)
    hist = m.fit([(ids[i], types[i], y[i]) for i in range(n)], batch_size=n,
                 epochs=1, verbose=0, shuffle=False)
    logits = m.predict([(ids[i], types[i]) for i in range(n)],
                       batch_size=n)[0][0]
    return hist[0]["loss"], logits, net


@pytest.mark.gpu
def test_small_bert_forward_and_fit_batch_card_against_cpu(card_place):
    """The small BERT classifier (2 layers, hidden 32), f32, TF32 off:
    its forward, and one ``Model.fit`` batch with dropout on (the same
    masks on both devices), then ``predict``, within rtol 1e-4 of the
    CPU's."""
    import paddle_tpu_torch as paddle

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 128, (4, 16)).astype("int64")
    ids[0, 12:] = 0
    types = (np.arange(16)[None] >= 8).astype("int64").repeat(4, 0)
    y = np.asarray([0, 1, 1, 0], "int64")
    paddle.set_device("cpu")
    _, net = _small_bert(paddle, "BertForSequenceClassification")
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    net.eval()
    fwd_cpu = net(paddle.to_tensor(ids), paddle.to_tensor(types)).numpy()
    gen = paddle.get_rng_state()
    loss_cpu, logits_cpu, _ = _bert_fit_once(paddle, "cpu", state, gen,
                                             ids, types, y)
    paddle.set_device("gpu")
    _, card_net = _small_bert(paddle, "BertForSequenceClassification")
    card_net.set_state_dict(state)
    card_net.eval()
    fwd = card_net(paddle.to_tensor(ids), paddle.to_tensor(types))
    assert fwd._data.is_cuda
    np.testing.assert_allclose(fwd.numpy(), fwd_cpu, rtol=1e-4, atol=1e-5)
    loss, logits, _ = _bert_fit_once(paddle, "gpu", state, gen, ids, types,
                                     y)
    np.testing.assert_allclose(loss, loss_cpu, rtol=1e-4)
    np.testing.assert_allclose(logits, logits_cpu, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_fused_attention_functions_card_against_cpu(card_place):
    """``masked_multihead_attention`` (with its returned cache) and
    ``fused_multi_head_attention`` (pre- and post-norm) on the card
    against the CPU, f32."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate.nn import functional as IF

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    b, h, d, smax, e = 2, 2, 4, 6, 8
    cache = np.zeros((2, b, h, smax, d), "float32")
    cache[:, :, :, :3] = rng.standard_normal((2, b, h, 3, d))
    x = rng.standard_normal((b, 3 * h * d)).astype("float32")
    lens = np.array([3, 2], "int32")
    xe = rng.standard_normal((2, 3, e)).astype("float32")
    qkvw = rng.standard_normal((3, h, e // h, e)).astype("float32")
    lw = rng.standard_normal((e, e)).astype("float32")
    out = {}
    for dev in ("cpu", "gpu"):
        paddle.set_device(dev)
        t = paddle.to_tensor
        o, c = IF.masked_multihead_attention(t(x), t(cache),
                                             sequence_lengths=t(lens))
        mha = [IF.fused_multi_head_attention(
            t(xe), t(qkvw), t(lw), pre_layer_norm=pre, dropout_rate=0.0,
            attn_dropout_rate=0.0, training=False).numpy()
            for pre in (True, False)]
        out[dev] = [o.numpy(), c.numpy()] + mha
    for a, g in zip(out["cpu"], out["gpu"]):
        np.testing.assert_allclose(g, a, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_tied_decoder_after_model_load_on_the_card(card_place, tmp_path):
    """The masked-LM decoder is the word embedding after a
    ``Model.save`` / ``Model.load`` round trip on the card, and the
    loaded model predicts the saved one's logits bit for bit."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import bert

    cfg, net = _small_bert(paddle, "BertForMaskedLM")
    ids = np.random.default_rng(2).integers(1, 128, (2, 8)).astype("int64")
    labels = np.where(ids % 3 == 0, ids, -100).astype("int64")
    m = paddle.Model(net)
    m.prepare(paddle.optimizer.AdamW(1e-3, parameters=net.parameters()),
              bert.BertPretrainingCriterion(cfg))
    m.train_batch([ids], [labels])
    m.save(str(tmp_path / "ck"))
    _, net2 = _small_bert(paddle, "BertForMaskedLM", seed=1)
    m2 = paddle.Model(net2)
    m2.prepare(paddle.optimizer.AdamW(1e-3, parameters=net2.parameters()),
               bert.BertPretrainingCriterion(cfg))
    m2.load(str(tmp_path / "ck"))
    emb = net2.bert.embeddings.word_embeddings.weight
    assert net2.decoder_weight is emb and emb._data.is_cuda
    np.testing.assert_array_equal(m2.predict_batch([ids])[0],
                                  m.predict_batch([ids])[0])
