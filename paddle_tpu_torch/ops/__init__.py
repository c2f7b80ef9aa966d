"""Operators of the port: the op registry built from ``ops.yaml`` (its
functional API as module attributes, ``paddle_tpu_torch.ops.matmul`` ...),
the plain PyTorch emitters, and the wrappers of the hand-written kernels.

The manifest is read by this module's own parser (the JAX package's
fallback for machines without PyYAML, which the card's machine is): no
``yaml`` import."""
from __future__ import annotations

import os
import types
from typing import Dict

# emitter modules must be imported before building the registry
from paddle_tpu_torch.ops import (  # noqa: F401
    creation, extras, linalg, logic, manipulation, math, nn_extras, nn_ops,
    random_ops, spectral, vision_ops,
)
from paddle_tpu_torch.ops import registry as _registry
from paddle_tpu_torch.ops.registry import OPS, get_op  # noqa: F401


def _parse_flow_yaml(path):
    """Parser for this file's restricted flow-style yaml (each entry is
    one ``- {k: v, ...}`` line); the JAX package's, copied."""
    import re

    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("- {"):
                continue
            body = line[3:-1]
            ent = {}
            # split on commas not inside brackets
            parts = re.split(r",\s*(?![^\[]*\])", body)
            for p in parts:
                k, _, v = p.partition(":")
                k = k.strip()
                v = v.strip()
                if v.startswith("["):
                    items = [s.strip().strip('"\'')
                             for s in v[1:-1].split(",") if s.strip()]
                    ent[k] = items
                elif v in ("true", "false"):
                    ent[k] = v == "true"
                else:
                    ent[k] = v.strip('"\'')
            entries.append(ent)
    return entries


_yaml_path = os.path.join(os.path.dirname(__file__), "ops.yaml")
_API = _registry.build_registry(_parse_flow_yaml(_yaml_path))

# an op whose name is a submodule's (flash_attention) stays reachable as
# API["flash_attention"]; the module keeps the attribute
globals().update({k: v for k, v in _API.items()
                  if not isinstance(globals().get(k), types.ModuleType)})

# in-place __setitem__ on Tensor: run the op, then rebind the data
from paddle_tpu_torch.core.tensor import Tensor as _Tensor  # noqa: E402


def _tensor_setitem(self, index, value):
    out = _API["setitem"](self, value, index=index)
    return _registry.rebind_inplace(self, out)


_Tensor.__setitem__ = _tensor_setitem


def kernel_launches() -> Dict[str, int]:
    """The launch counts of the port's kernel wrappers, as they count: each
    wrapper's Python count and, for a kernel library already loaded, its
    successful launches by route (``"<kernel>/<route>"``). This is the
    counter that the captured steps (:class:`~paddle_tpu_torch.jit.trace.
    StepGraphs`) read around each capture."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    out = {"ragged_paged_attention": rpa.launches, **fa.launches}
    if rpa._lib is not None:
        out.update({f"ragged_paged_attention/{route}": n
                    for route, n in rpa.route_launches().items()})
    if fa._lib is not None:
        for name, routes in fa.route_launches().items():
            out.update({f"{name}/{route}": n for route, n in routes.items()})
    return out


__all__ = sorted(_API.keys()) + ["kernel_launches"]
