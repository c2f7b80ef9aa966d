"""Speculative-decode draft proposer (port of
``paddle_tpu/serving/spec.py``).

A :class:`SpecDecoder` wraps a SMALL draft model and, once per engine
iteration, proposes ``k = num_spec_tokens`` greedy continuations for
every decode-eligible running request. The TARGET model then verifies
all k proposals in its one ragged step (they ride as mid-context
multi-token rows, the chunk-continuation shape the ragged kernel
already serves) with rejection sampling in the on-device sampler
(:func:`paddle_tpu_torch.ops.sampling.sample_or_verify`).

The draft proposes GREEDILY: a point-mass proposal makes the accept
probability ``p_target(t_i)`` and the corrected distribution
``p_target`` with ``t_i`` masked, so the emitted tokens are distributed
exactly as the target alone would emit them whatever the draft
proposes, and no draft probabilities cross the host boundary.

The proposer keeps no KV cache: each proposal runs ``k`` full draft
forwards over a padded (B, W) id buffer under ``torch.no_grad()`` on the
draft's device. Batch and width are bucketed to powers of two as the JAX
package buckets its compiled shapes ("one compiled shape per bucket
pair"), so the same prefixes give the same proposals in both packages;
on the card the k chained forwards of a bucket are one CUDA graph
(:class:`~paddle_tpu_torch.jit.trace.StepGraphs`), captured at the
bucket's first use and replayed after. Its forward is
``LlamaForCausalLM.forward``: on the card every draft layer runs the
flash attention forward kernel, whose TMA descriptors the graph holds
by address (the id buffer is a static input, never reallocated). Its
host boundary is one (B, k) int32 fetch.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from paddle_tpu_torch.jit.trace import StepGraphs
from paddle_tpu_torch.ops import kernel_launches

__all__ = ["SpecDecoder"]


class SpecDecoder:
    """Greedy k-token draft proposer over a padded (B, W) id buffer.

    ``propose`` buckets batch and width to powers of two (width at least
    8), runs ``k`` draft forwards in a row — each argmaxes the logit at
    every row's frontier and writes it back into the buffer — and
    returns the (B, k) proposals. ``pool``: the CUDA graph memory pool
    to share (the engine passes its step's)."""

    def __init__(self, model, num_spec_tokens: int, pool=None):
        if num_spec_tokens < 1:
            raise ValueError("num_spec_tokens must be >= 1")
        self.model = model
        self.k = int(num_spec_tokens)
        self.vocab_size = model.config.vocab_size
        self.graphs = StepGraphs(model.device, counters=kernel_launches,
                                 pool=pool)

    @staticmethod
    def _bucket(n: int, lo: int = 1) -> int:
        b = lo
        while b < n:
            b *= 2
        return b

    def _forwards(self, ids, lens):
        """The k chained greedy forwards on a (B, W) id buffer and the
        (B,) prefix lengths: (B, k) int32 proposals. Works on a copy of
        ``ids``; the function each bucket's graph captures."""
        toks = ids.clone()
        rows = torch.arange(toks.shape[0], device=toks.device)
        outs = []
        for i in range(self.k):
            logits = self.model(toks)
            nxt = logits[rows, lens - 1 + i].argmax(dim=-1)
            outs.append(nxt)
            toks[rows, lens + i] = nxt
        return torch.stack(outs, dim=1).to(torch.int32)

    @torch.no_grad()
    def propose(self, token_lists: Sequence[Sequence[int]]) -> np.ndarray:
        """Greedy k-token proposals for each token prefix. Returns
        (len(token_lists), k) int32. Right-padding is safe under the
        draft's causal attention — positions past a row's frontier never
        influence the argmaxed logit."""
        n = len(token_lists)
        b = self._bucket(n)
        w = self._bucket(max(len(t) for t in token_lists) + self.k, 8)
        ids = np.zeros((b, w), np.int64)
        lens = np.ones((b,), np.int64)  # pad rows index position 0
        for i, toks in enumerate(token_lists):
            ids[i, :len(toks)] = toks
            lens[i] = len(toks)
        out = self.graphs.run(("draft", b, w), self._forwards, (ids, lens))
        return self.graphs.fetch(out)[:n]
