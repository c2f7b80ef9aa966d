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
gives the CPU's loss and gradients."""
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


def _mirror_batch(card, dtype, seed=0, nhb=24):
    """``_batch`` (bs 16, GQA 32/8, D 128) with each live slot's blocks
    below its first written block moved to a second pool: the entries
    become virtual (``nb + slot``) and the device copies are zeroed."""
    b = _batch(card, dtype, 32, 8, 128, 16, seed=seed)
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
