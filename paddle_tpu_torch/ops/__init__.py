"""Operators of the port: plain PyTorch functions and the wrappers of
the hand-written kernels."""
from typing import Dict

__all__ = ["kernel_launches"]


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
