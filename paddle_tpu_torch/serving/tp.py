"""Tensor-parallel serving over ``torch.distributed``: the port's
counterpart of the JAX engine's TP mesh (``paddle_tpu/serving/engine.py``,
the ``tp_degree`` mesh, the weights committed to their placements, and
the step's pinned output shardings).

The JAX engine runs ONE SPMD program over a 1-D ``"tp"`` mesh: weights
and caches carry ``NamedSharding``s and GSPMD inserts the collectives.
PyTorch's idiom is one process per shard, so ``LLMEngine(model,
EngineConfig(tp_degree=k))`` with k > 1 runs k processes:

* the engine's process is **rank 0**. It keeps every host-side
  structure (scheduler, block manager, sampler keys, metrics, admission)
  and is the only rank that applies ``lm_head`` and samples;
* at construction it spawns k - 1 **workers** (spawn context; their entry
  point, :func:`_worker_main`, lives in this module, so a worker imports
  only the port). The ranks meet through a ``FileStore`` in a temporary
  directory, not a TCP port;
* two process groups: a gloo **host group** carries the commands and the
  weight hand-off; a **device group** carries the activations. It is
  NCCL when the k ranks sit on k distinct cards, and gloo when they share
  one device (the CPU, or one card through
  :func:`paddle_tpu_torch.testing.tp_hooks.ranks_share_one_device`).
  :attr:`TPGroup.backend` names it; nothing falls back;
* **weights.** Rank r holds shard r of each parameter by the engine's
  layouts (``LLMEngine.param_layouts``): the column-parallel projections
  (q, k, v, gate, up; torch's ``[out, in]``) split dim 0, the
  row-parallel ones (o, down) dim 1, embeddings, norms and ``lm_head``
  are replicated. Rank 0 cuts its own model down to its shards in place
  (the JAX engine commits the placements in place on the model too); the
  workers receive theirs over the host group (:attr:`TPGroup.handoff_s`)
  into a model skeleton built on the meta device;
* **the forward.** Every rank runs the port's ``forward_ragged`` on H/k
  query heads, KH/k kv heads and intermediate/k MLP width: a forward hook
  on each ``o_proj`` and ``down_proj`` all-reduces its partial sum over
  the device group (in f32 for 16-bit activations), two all-reduces a
  layer. The ragged attention (K1 on the card) runs per rank on the
  rank's cache shard, (L, NB, BS, KH/k, D). The workers stop after the
  final norm;
* **commands.** Every engine operation that touches device state goes
  through one dispatcher: rank 0 broadcasts an opcode and its int32
  arrays on the host group, then runs the operation on its own shard;
  the workers loop on receive-and-run. The step (ids, block tables,
  cu_seqlens, context lens, num_seqs) goes out when it is dispatched; the
  copy-on-write copies and the host-swap spills and restores are queued
  in the order rank 0 runs them and go out ahead of the next step
  (:meth:`TPGroup.flush`), so a worker that died fails that step;
* **host swap.** Each rank spills its own cache shard to its own host
  pool, (L, NHB, BS, KH/k, D): rank r's pool is frame r of the JAX
  engine's (tp, L, NHB, BS, KH/tp, D) pool;
* **failure.** An error in any command marks the group broken: the step
  fails with ``EngineStepError`` without retry (the ranks' collectives
  no longer pair), and every later command raises at once. A rank that
  dies or hangs fails the collective within the group's timeout
  (:data:`GROUP_TIMEOUT_S`);
* **lifecycle.** No public method: the engine's ``weakref.finalize``
  calls :meth:`TPGroup.close`, which sends the shutdown, joins the
  workers and kills any that linger. The workers are daemons, and a
  worker whose rank 0 is gone leaves its loop when the host group's
  sockets close.

The step runs uncaptured at its bucket width: gloo collectives cannot
be captured in a CUDA graph (capture under NCCL is queued in ROADMAP).
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from datetime import timedelta
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.distributed.redistribute import Layout
from paddle_tpu_torch.serving.engine import _KVSwapper, _tp_param_layout

__all__ = ["TPGroup", "TPSwapper", "GROUP_TIMEOUT_S", "rank_devices",
           "shard_layers"]

# seconds a collective (or the start-up rendezvous) waits for a rank
GROUP_TIMEOUT_S = 120.0

OP_STEP, OP_COW, OP_SPILL, OP_RESTORE, OP_REPORT, OP_POOLS, OP_SHUTDOWN = \
    range(1, 8)
_HDR = 8          # int64 header: opcode, up to 6 sizes, payload length


def rank_devices(device: torch.device, k: int) -> List[torch.device]:
    """The device of each rank: rank 0 on ``device`` (the model's). On
    the CPU every rank; on the card rank r on its own card, which needs
    k visible cards (the JAX engine's rule), or every rank on ``device``
    under :func:`~paddle_tpu_torch.testing.tp_hooks.
    ranks_share_one_device`."""
    from paddle_tpu_torch.testing import tp_hooks

    if device.type == "cpu" or tp_hooks.shared_device():
        return [device] * k
    n = torch.cuda.device_count()
    if n < k:
        raise ValueError(f"tp_degree {k} needs {k} devices, {n} visible")
    return [torch.device("cuda", (device.index + r) % n) for r in range(k)]


def _all_reduce(pg, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over ``pg``; 16-bit activations reduce in f32 and round
    once."""
    x = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
    pg.allreduce([x.contiguous()]).wait()
    return x.to(t.dtype) if x is not t else x


def shard_layers(layers: Sequence[nn.Module], k: int, reduce) -> None:
    """Cut the decoder layers' head counts to one rank's share (their
    weights are set by the caller) and hook ``reduce`` onto the output of
    each row-parallel projection."""
    for layer in layers:
        attn, mlp = layer.self_attn, layer.mlp
        attn.n_heads //= k
        attn.n_kv //= k
        for lin in (attn.o_proj, mlp.down_proj):
            lin.register_forward_hook(lambda m, inp, out: reduce(out))


def _set_param(module: nn.Module, name: str, value: torch.Tensor):
    """Put ``value`` in place of the parameter ``name`` (dotted)."""
    owner, _, leaf = name.rpartition(".")
    mod = module.get_submodule(owner) if owner else module
    old = mod._parameters[leaf]
    if isinstance(old, nn.Parameter) and old.device == value.device:
        old.data = value
    else:
        mod._parameters[leaf] = nn.Parameter(value, requires_grad=False)
    if isinstance(mod, nn.Linear) and leaf == "weight":
        mod.out_features, mod.in_features = value.shape


def _groups(store_dir: str, rank: int, k: int, backend: str,
            timeout_s: float):
    """The host group (gloo, on the loopback interface) and the device
    group (``backend``) of rank ``rank``."""
    import torch.distributed as dist

    td = timedelta(seconds=timeout_s)
    store = dist.FileStore(os.path.join(store_dir, "store"), k)
    store.set_timeout(td)

    def gloo(prefix):
        opts = dist.ProcessGroupGloo._Options()
        opts._timeout = td
        opts._devices = [dist.ProcessGroupGloo.create_device(
            hostname="127.0.0.1")]
        return dist.ProcessGroupGloo(dist.PrefixStore(prefix, store), rank,
                                     k, opts)

    host = gloo("host")
    if backend == "gloo":
        dev = gloo("dev")
    else:
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = td
        dev = dist.ProcessGroupNCCL(dist.PrefixStore("dev", store), rank, k,
                                    opts)
    return host, dev


def _broadcast(pg, t: torch.Tensor):
    """Broadcast ``t`` from rank 0 over ``pg`` (blocking)."""
    import torch.distributed as dist

    opts = dist.BroadcastOptions()
    opts.rootRank = 0
    pg.broadcast([t], opts).wait()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU tensor as its bytes (gloo's send and recv are
    byte moves; a uint8 view carries any dtype)."""
    return t.reshape(-1).view(torch.uint8)


class TPGroup:
    """Rank 0's side of a k-rank TP engine: the workers, the two process
    groups, the command queue. Built by ``LLMEngine``; see the module
    docstring."""

    def __init__(self, k: int, devices: List[torch.device], model_config,
                 geometry: dict):
        self.k = k
        self.backend = ("gloo" if len({str(d) for d in devices}) < k
                        else "nccl")
        self.timeout_s = GROUP_TIMEOUT_S
        self.broken = False
        self.handoff_s = 0.0
        self._queue: List[tuple] = []
        self._procs: List = []
        self._dir = tempfile.mkdtemp(prefix="paddle-tp-")
        ctx = mp.get_context("spawn")
        try:
            for r in range(1, k):
                p = ctx.Process(
                    target=_worker_main, name=f"paddle-tp-rank{r}",
                    args=(r, k, self._dir, str(devices[r]), self.backend,
                          dataclasses.asdict(model_config), geometry,
                          self.timeout_s),
                    daemon=True)
                p.start()
                self._procs.append(p)
            self.host, self.dev = self._rendezvous()
        except BaseException:
            self.close()
            raise

    def _rendezvous(self):
        """Build rank 0's groups while watching the workers: a worker
        that exits during start-up fails the construction at once."""
        out: dict = {}

        def build():
            try:
                out["groups"] = _groups(self._dir, 0, self.k, self.backend,
                                        self.timeout_s)
            except BaseException as e:   # surfaced below
                out["error"] = e

        th = threading.Thread(target=build, daemon=True)
        th.start()
        while th.is_alive():
            th.join(0.05)
            for r, p in enumerate(self._procs, start=1):
                if p.exitcode is not None:
                    raise RuntimeError(
                        f"tensor-parallel worker rank {r} exited with code "
                        f"{p.exitcode} during start-up")
        if "error" in out:
            raise out["error"]
        return out["groups"]

    # -- the weight hand-off ------------------------------------------------
    def hand_off(self, model, layouts: Dict[str, Layout]) -> None:
        """Send each worker its shard of every decoder parameter (the
        ``llama.*`` ones, in ``named_parameters`` order, over the host
        group), then cut ``model`` down to rank 0's shards in place and
        hook the all-reduces in."""
        t0 = time.perf_counter()
        for name, p in model.llama.named_parameters():
            lay = layouts["llama." + name]
            full = p.detach()
            for r in range(1, self.k):
                shard = full[lay.shard_slices(full.shape, r)]
                self.host.send([_bytes(shard.contiguous().cpu())], r,
                               0).wait()
            if not lay.is_replicated:
                _set_param(model.llama, name, full[lay.shard_slices(
                    full.shape, 0)].clone())
        shard_layers(model.llama.layers, self.k, self.all_reduce)
        model._tp_shard = (0, self.k)
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        self.handoff_s = time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return _all_reduce(self.dev, t)

    # -- commands -----------------------------------------------------------
    def _check(self):
        if self.broken:
            raise RuntimeError(
                "the tensor-parallel group is broken: an earlier command "
                "failed, so its ranks no longer pair")

    def _send(self, op: int, sizes: Sequence[int],
              arrays: Sequence[np.ndarray]):
        payload = (np.concatenate([np.asarray(a, np.int32).reshape(-1)
                                   for a in arrays])
                   if arrays else np.zeros((0,), np.int32))
        hdr = torch.zeros((_HDR,), dtype=torch.int64)
        hdr[0] = op
        for i, n in enumerate(sizes):
            hdr[1 + i] = int(n)
        hdr[_HDR - 1] = payload.size
        _broadcast(self.host, hdr)
        if payload.size:
            _broadcast(self.host, torch.from_numpy(payload))

    def enqueue(self, op: int, *arrays: Sequence[int]):
        """Queue a cache operation (copy-on-write, spill, restore) that
        rank 0 runs now on its own shard; it goes out ahead of the next
        step."""
        self._queue.append((op, [len(a) for a in arrays],
                            [np.asarray(a, np.int32) for a in arrays]))

    def flush(self):
        """Send every queued cache operation, in order."""
        self._check()
        try:
            while self._queue:
                op, sizes, arrays = self._queue.pop(0)
                self._send(op, sizes, arrays)
        except BaseException:
            self.broken = True
            raise

    def step(self, ids, bt, cu, ctx, nseq):
        """Send the queued operations and the ragged step's inputs; rank
        0 then runs its own shard of the step."""
        self.flush()
        try:
            self._send(OP_STEP, (ids.shape[0], bt.shape[0], bt.shape[1]),
                       (ids, bt, cu, ctx, nseq))
        except BaseException:
            self.broken = True
            raise

    def report(self, reset: bool = False) -> List[dict]:
        """Each worker's K1 launches (its wrapper's count) and peak device
        memory, ranks 1..k-1; ``reset`` zeroes both after reading."""
        self.flush()
        self._send(OP_REPORT, (int(reset),), ())
        out = []
        for r in range(1, self.k):
            got = torch.zeros((2,), dtype=torch.int64)
            self.host.recv([got], r, 0).wait()
            out.append({"rank": r, "k1_launches": int(got[0]),
                        "max_memory_allocated": int(got[1])})
        return out

    def host_pools(self, own_k: torch.Tensor, own_v: torch.Tensor):
        """Every rank's host pool stacked by rank: (k, L, NHB, BS, KH/k,
        D) for K and V, rank 0's from ``own_k`` / ``own_v`` (the layout
        of the JAX engine's ``_host_k`` / ``_host_v``)."""
        self.flush()
        self._send(OP_POOLS, (), ())
        ks, vs = [own_k.clone()], [own_v.clone()]
        for r in range(1, self.k):
            for dst in (ks, vs):
                buf = torch.empty_like(own_k)
                self.host.recv([_bytes(buf)], r, 0).wait()
                dst.append(buf)
        return torch.stack(ks), torch.stack(vs)

    def close(self):
        """Shut the workers down (best effort), join them, kill what is
        left, drop the groups and the rendezvous directory. Idempotent."""
        procs, self._procs = self._procs, []
        told = False
        if procs and not self.broken and getattr(self, "host", None) \
                is not None:
            try:
                self._queue.clear()
                self._send(OP_SHUTDOWN, (), ())
                told = True
            except Exception:
                pass
        for p in procs:
            p.join(10.0 if told else 0.5)
            if p.exitcode is None:
                p.kill()
                p.join(10.0)
        self.broken = True
        self.host = self.dev = None
        shutil.rmtree(self._dir, ignore_errors=True)


class TPSwapper(_KVSwapper):
    """Rank 0's host-swap mover at k > 1: each spill and restore runs on
    rank 0's shard and is queued for the workers, which run it on
    theirs."""

    def __init__(self, group: TPGroup, *tensors):
        super().__init__(*tensors)
        self._group = group

    def spill(self, key, dev_blocks: List[int], host_slots: List[int]):
        self._group.enqueue(OP_SPILL, dev_blocks, host_slots)
        super().spill(key, dev_blocks, host_slots)

    def restore(self, host_slots: List[int], dev_blocks: List[int]):
        self._group.enqueue(OP_RESTORE, host_slots, dev_blocks)
        super().restore(host_slots, dev_blocks)


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------
class _Worker:
    """Rank r > 0: a skeleton of the decoder with rank r's weights, its
    cache shard and host pool, and the receive-and-run loop."""

    def __init__(self, rank: int, k: int, device: torch.device, host, dev,
                 cfg_dict: dict, geo: dict):
        from paddle_tpu_torch.core.dtype import to_torch
        from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                                   _rope_tables)

        self.rank, self.k, self.device = rank, k, device
        self.host, self.dev = host, dev
        cfg = LlamaConfig(**cfg_dict)
        dtype = to_torch(cfg.dtype)
        model = LlamaModel(cfg, device="meta", dtype=dtype)
        for name, p in list(model.named_parameters()):
            lay = _tp_param_layout("llama." + name, p.ndim, k)
            buf = torch.empty(lay.local_shape(tuple(p.shape)), dtype=dtype)
            host.recv([_bytes(buf)], 0, 0).wait()
            _set_param(model, name, buf.to(device))
        cos, sin = _rope_tables(cfg.max_position_embeddings,
                                cfg.hidden_size // cfg.num_attention_heads,
                                cfg.rope_theta, device=device)
        model.rope_cos, model.rope_sin = cos, sin
        shard_layers(model.layers, k, lambda t: _all_reduce(dev, t))
        self.model = model.eval()
        cache_dtype = to_torch(geo["cache_dtype"])
        shape = (cfg.num_hidden_layers, geo["num_blocks"], geo["block_size"],
                 cfg.num_key_value_heads // k,
                 cfg.hidden_size // cfg.num_attention_heads)
        self.kcs = torch.zeros(shape, dtype=cache_dtype, device=device)
        self.vcs = torch.zeros(shape, dtype=cache_dtype, device=device)
        if geo["num_host_blocks"] > 0:
            hshape = (shape[0], geo["num_host_blocks"]) + shape[2:]
            pin = device.type == "cuda"
            self.host_k = torch.zeros(hshape, dtype=cache_dtype,
                                      pin_memory=pin)
            self.host_v = torch.zeros(hshape, dtype=cache_dtype,
                                      pin_memory=pin)
        else:
            self.host_k = self.host_v = None
        self.swapper = _KVSwapper(self.kcs, self.vcs, self.host_k,
                                  self.host_v)

    def _recv(self):
        hdr = torch.zeros((_HDR,), dtype=torch.int64)
        _broadcast(self.host, hdr)
        n = int(hdr[_HDR - 1])
        payload = torch.zeros((n,), dtype=torch.int32)
        if n:
            _broadcast(self.host, payload)
        return int(hdr[0]), [int(x) for x in hdr[1:_HDR - 1]], payload

    def _split(self, payload, sizes):
        out, off = [], 0
        for n in sizes:
            out.append(payload[off:off + n])
            off += n
        return out

    def serve(self):
        from paddle_tpu_torch.ops import ragged_paged_attention as rpa

        dev = self.device
        while True:
            op, sizes, payload = self._recv()
            if op == OP_SHUTDOWN:
                return
            if op == OP_STEP:
                t, s, mb = sizes[:3]
                ids, bt, cu, ctx, nseq = self._split(
                    payload.to(dev), (t, s * mb, s + 1, s, 1))
                with torch.no_grad():
                    self.model.forward_ragged(ids, self.kcs, self.vcs,
                                              bt.view(s, mb), cu, ctx, nseq)
            elif op == OP_COW:
                src, dst = (x.to(dev).long() for x in
                            self._split(payload, sizes[:2]))
                self.kcs[:, dst] = self.kcs[:, src]
                self.vcs[:, dst] = self.vcs[:, src]
            elif op == OP_SPILL:
                blocks, slots = self._split(payload, sizes[:2])
                self.swapper.spill(None, blocks.tolist(), slots.tolist())
                self.swapper.fence()
            elif op == OP_RESTORE:
                slots, blocks = self._split(payload, sizes[:2])
                self.swapper.restore(slots.tolist(), blocks.tolist())
            elif op == OP_REPORT:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                    peak = torch.cuda.max_memory_allocated(dev)
                else:
                    peak = 0
                got = torch.as_tensor([rpa.launches, peak],
                                      dtype=torch.int64)
                self.host.send([got], 0, 0).wait()
                if sizes[0]:
                    rpa.launches = 0
                    if dev.type == "cuda":
                        torch.cuda.reset_peak_memory_stats(dev)
            elif op == OP_POOLS:
                for pool in (self.host_k, self.host_v):
                    self.host.send([_bytes(pool)], 0, 0).wait()
            else:
                raise RuntimeError(f"unknown tensor-parallel opcode {op}")


def _worker_main(rank: int, k: int, store_dir: str, device: str,
                 backend: str, cfg_dict: dict, geo: dict,
                 timeout_s: float):
    """A worker process's entry point: join the groups, take the weights,
    run commands until shutdown or until rank 0's sockets close."""
    code = 0
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        host, devpg = _groups(store_dir, rank, k, backend, timeout_s)
        _Worker(rank, k, dev, host, devpg, cfg_dict, geo).serve()
    except BaseException:
        traceback.print_exc()
        code = 1
    # no interpreter teardown: the groups' and the card's destructors may
    # wait on a rank 0 that is gone
    sys.stderr.flush()
    os._exit(code)
