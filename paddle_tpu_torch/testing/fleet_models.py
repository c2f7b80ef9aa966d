"""Worker model factories for fleets whose weights come from a file.

``WorkerSpec(model="paddle_tpu_torch.testing.fleet_models:npz_llama")``
makes each worker process build the tiny Llama (``LlamaConfig.tiny()``)
on the spec's device and load its weights from the ``.npz`` named by the
``PADDLE_REPLICA_WEIGHTS`` environment variable (pass it through
``SupervisorConfig.env``). The file holds a JAX-package ``state_dict()``
saved with ``numpy.savez`` — the layout ``models/convert.py``
``llama_state_from_jax`` reads — so a worker fleet serves the very
weights an in-process reference (either package's) holds.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["WEIGHTS_ENV", "npz_llama"]

WEIGHTS_ENV = "PADDLE_REPLICA_WEIGHTS"


def npz_llama(spec: dict):
    """The worker factory (see the module docstring)."""
    from paddle_tpu_torch.models.convert import llama_state_from_jax
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    path = os.environ.get(WEIGHTS_ENV)
    if not path:
        raise ValueError(f"npz_llama needs {WEIGHTS_ENV}: the .npz of "
                         f"the weights to serve")
    with np.load(path) as f:
        state = {k: f[k] for k in f.files}
    model = LlamaForCausalLM(LlamaConfig.tiny(), device=spec.get("device"))
    model.load_state_dict(llama_state_from_jax(state))
    model.eval()
    return model
