#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line of its numbers; any failure exits
non-zero (nothing is caught and passed over):

1. device    — the card's name, the device count, and nvidia-smi's name
               and power limit. No CUDA device: fail.
2. build     — build the ragged paged attention kernel from
               ``paddle_tpu_torch/csrc/`` with nvcc for sm_90a; seconds
               taken and ptxas's registers / shared memory.
3. kernel    — the kernel against its plain PyTorch version on the card
               at Llama-3-8B head shapes (H=32, KH=8, D=128, block 16,
               bf16) on one mixed batch: decode rows, a prefill chunk
               starting mid-context, padding slots, -1 table entries,
               padding rows past cu[num_seqs]. Times (CUDA events, L2
               flushed before each launch) and the bound.
4. serve     — Llama-3-8B at full width and depth (32 layers, bf16,
               random weights from a seeded generator on the card)
               through the port's LLMEngine: 8 requests, prompts of
               128-1024 tokens, 32 new tokens each (7 greedy, 1 sampled).
               The kernel's launch count must be 32 x the model steps.
5. parity    — LlamaConfig.tiny in f32 (TF32 off) served on the card
               (kernel) and on the CPU (plain version) from the same
               weights: the greedy tokens must be identical.

Then one line with the kernel table (name, route, source, launches on
the main path, error, times, bound), nvidia-smi's line, and last
``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters, flush=None):
    """Mean device time of ``fn`` over ``iters`` launches, each timed on
    its own between CUDA events; ``flush`` runs before each (outside the
    timed window)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# ---------------------------------------------------------------------------
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build():
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    t0 = time.perf_counter()
    info = _build.build("ragged_paged_attention")
    smem = rpa._library().ragged_paged_attention_smem_bytes(128)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": round(info["seconds"], 3),
          "built": info["built"], "ptxas": info["ptxas"].splitlines(),
          "dynamic_smem_bytes_per_cta_d128": smem})


def _mixed_batch(dev, gen):
    """Llama-3-8B head shapes, one mixed batch (see phase 3)."""
    h, kh, d, bs, nb, s_slots, mb = 32, 8, 128, 16, 1024, 8, 128
    # (rows this step, context after the step) per live slot
    live = [(1, 17), (1, 300), (512, 1536), (1, 1000), (100, 100),
            (1, 2048)]
    ns = len(live)
    cu = np.zeros((s_slots + 1,), np.int32)
    cu[1:ns + 1] = np.cumsum([n for n, _ in live])
    cu[ns + 1:] = cu[ns]
    ctx = np.zeros((s_slots,), np.int32)
    ctx[:ns] = [c for _, c in live]
    bt = np.full((s_slots, mb), -1, np.int32)
    perm = np.random.default_rng(0).permutation(nb)
    k = 0
    for i, (_, c) in enumerate(live):
        need = -(-c // bs)
        bt[i, :need] = perm[k:k + need]
        k += need
    t_total = int(cu[ns]) + 37          # padding rows past cu[num_seqs]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    b = dict(q=randn(t_total, h, d), k_new=randn(t_total, kh, d),
             v_new=randn(t_total, kh, d), key_cache=randn(nb, bs, kh, d),
             value_cache=randn(nb, bs, kh, d),
             block_tables=torch.from_numpy(bt).to(dev),
             cu_seqlens=torch.from_numpy(cu).to(dev),
             context_lens=torch.from_numpy(ctx).to(dev),
             num_seqs=torch.tensor([ns], dtype=torch.int32, device=dev))
    return b, live


def phase_kernel(dev):
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    gen = torch.Generator(device=dev).manual_seed(1)
    b, live = _mixed_batch(dev, gen)
    q = b["q"]
    t_total, h, d = q.shape
    kh = b["key_cache"].shape[2]
    scale = d ** -0.5
    n_live = int(sum(n for n, _ in live))

    kc_ref = b["key_cache"].clone()
    vc_ref = b["value_cache"].clone()
    out, kc, vc = rpa.ragged_paged_attention(
        q, b["k_new"], b["v_new"], b["key_cache"], b["value_cache"],
        b["block_tables"], b["cu_seqlens"], b["context_lens"],
        b["num_seqs"], scale=scale)
    seg, pos, _ = rpa._token_layout(t_total, b["block_tables"].shape[0],
                                    b["cu_seqlens"], b["context_lens"],
                                    b["num_seqs"])
    rpa._write_kv(kc_ref, b["k_new"], b["block_tables"], seg, pos)
    rpa._write_kv(vc_ref, b["v_new"], b["block_tables"], seg, pos)
    ref = rpa._ragged_attend_ref(q, kc_ref, vc_ref, b["block_tables"],
                                 b["cu_seqlens"], b["context_lens"],
                                 b["num_seqs"], scale,
                                 out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(kc, kc_ref) and torch.equal(vc, vc_ref), \
        "kernel path and plain path left different caches"
    assert torch.all(out[n_live:] == 0), "padding rows are not exact zeros"
    err = (out[:n_live].float() - ref[:n_live]).abs()
    max_abs_err = float(err.max())
    # tolerance: the kernel accumulates in f32 like the plain version
    # (only the summation order differs, ~1e-6) and rounds its output to
    # bf16, at most half a relative step of 2^-8, which rtol covers; the
    # reference stays in f32. atol stays well under |out| (~0.05 on the
    # long-context rows), so a dropped chunk of keys there cannot pass
    torch.testing.assert_close(out[:n_live].float(), ref[:n_live],
                               rtol=1e-2, atol=1e-3)

    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    args = (q, kc, vc, b["block_tables"], b["cu_seqlens"],
            b["context_lens"], b["num_seqs"], scale)
    launches_before = rpa.launches
    ms = cuda_ms(lambda: rpa._ragged_attend_cuda(*args), 20,
                 flush=flush_buf.zero_)
    plain_ms = cuda_ms(lambda: rpa._ragged_attend_ref(*args), 3,
                       flush=flush_buf.zero_)
    assert rpa.launches > launches_before

    # least work: Q read, O written (all T rows), each slot's K and V
    # read once; 4*H*D flops per (row, visible position)
    esz = q.element_size()
    kv_tokens = sum(c for _, c in live)
    nbytes = (n_live * h * d * esz + t_total * h * d * esz
              + 2 * kv_tokens * kh * d * esz)
    flops = 0
    for n, c in live:
        pos_plus_1 = np.arange(c - n + 1, c + 1, dtype=np.int64)
        flops += 4 * h * d * int(pos_plus_1.sum())
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_flops = flops / H100_BF16_FLOP_PER_S * 1e3
    res = {"phase": "kernel", "rows_live": n_live, "rows": t_total,
           "slots_live": len(live), "max_abs_err": max_abs_err,
           "tolerance": "rtol=1e-2, atol=1e-3 vs f32 plain (bf16 output)",
           "ms": ms, "plain_ms": plain_ms, "bytes": nbytes, "flops": flops,
           "bound_ms": max(t_bytes, t_flops),
           "bound_by": "bytes" if t_bytes >= t_flops else "operations"}
    emit(res)
    return res


def phase_serve(dev):
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.tools import llama3_8b_serve

    t0 = time.perf_counter()
    eng = llama3_8b_serve.build_engine(dev)   # model, engine, warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = eng.model.config
    n_params = sum(p.numel() for p in eng.model.parameters())
    rids, lens = llama3_8b_serve.add_requests(eng)
    torch.cuda.reset_peak_memory_stats()
    rpa.launches = 0                  # main path starts here
    t1 = time.perf_counter()
    steps = 0
    while eng.has_unfinished():
        eng.step()
        steps += 1
        assert steps < 1000, "engine failed to converge"
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = rpa.launches           # main path ends here
    model_steps = eng.metrics.engine_steps
    assert launches == cfg.num_hidden_layers * model_steps, \
        (launches, model_steps)
    gen_tokens = 0
    for rid in rids:
        r = eng.get_request(rid)
        assert r.finish_reason == "length", (rid, r.finish_reason)
        assert len(r.generated) == llama3_8b_serve.MAX_NEW_TOKENS
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
        gen_tokens += len(r.generated)
    assert eng.block_manager.num_free_blocks == eng.cfg.num_blocks
    m = eng.metrics
    res = {"phase": "serve", "model": "llama3_8b", "params": n_params,
           "layers": cfg.num_hidden_layers, "dtype": "bfloat16",
           "prompt_lens": [int(x) for x in lens],
           "prompt_tokens": int(lens.sum()), "generated_tokens": gen_tokens,
           "wall_s": wall, "tokens_per_s": gen_tokens / wall,
           "ttft_ms_p50": float(np.percentile(m.ttfts_s, 50) * 1e3),
           "tpot_ms_p50": float(np.percentile(m.tpots_s, 50) * 1e3),
           "steps": model_steps, "prefill_chunks":
               int(eng.scheduler.num_prefill_chunks),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "setup_s": setup_s, "kernel_launches": launches,
           "sampled": eng.get_request("r7").generated[:8]}
    emit(res)
    del eng
    torch.cuda.empty_cache()
    return res


def phase_parity(dev):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import (EngineConfig, LLMEngine,
                                          SamplingParams)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.tiny()
    cpu_model = LlamaForCausalLM(cfg, device="cpu")
    cpu_model.init_weights(torch.Generator().manual_seed(0))
    card_model = LlamaForCausalLM(cfg, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    prompts = [list(map(int, np.random.default_rng(i).integers(
        0, cfg.vocab_size, size=n))) for i, n in enumerate([5, 17, 33, 9])]
    sp = SamplingParams(max_new_tokens=8)
    ecfg = dict(block_size=4, max_num_seqs=4, max_model_len=64,
                max_batched_tokens=32)
    before = rpa.launches
    on_card = LLMEngine(card_model, EngineConfig(**ecfg)).generate(prompts,
                                                                   sp)
    card_launches = rpa.launches - before
    on_cpu = LLMEngine(cpu_model, EngineConfig(**ecfg)).generate(prompts,
                                                                 sp)
    assert card_launches > 0
    assert on_card == on_cpu, (on_card, on_cpu)
    emit({"phase": "parity", "model": "tiny", "dtype": "float32",
          "requests": len(prompts), "identical": True,
          "kernel_launches": card_launches, "tokens": on_card})


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    k = phase_kernel(dev)
    s = phase_serve(dev)
    phase_parity(dev)
    emit({"kernels": [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/ragged_paged_attention.py:146",
        "launches": s["kernel_launches"], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
