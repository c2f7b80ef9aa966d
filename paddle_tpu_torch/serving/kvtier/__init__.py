"""Tiered KV (port of ``paddle_tpu/serving/kvtier/``): device HBM -> host
RAM, one card.

One :class:`TieredKVStore` per engine unifies the two tiers behind the
BlockManager's virtual-block addressing (``block_manager.py`` module
docstring): table entries ``>= num_blocks`` name host-pool slots, the
ragged step attends them through the host tier's device mirror, which
the ragged attention reads as a second pool, and the prefix trie is
tier-blind — so demotion and promotion are byte moves plus an id
rewrite, never a recompute. The JAX package's third tier, a peer's
cache reached through the fleet router, comes with the fleet (C2).
"""
from paddle_tpu_torch.serving.kvtier.store import (
    KVTiersConfig, SessionRecord, TieredKVStore,
)

__all__ = ["KVTiersConfig", "SessionRecord", "TieredKVStore"]
