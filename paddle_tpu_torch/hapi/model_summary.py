"""Model summary and FLOPs estimate (port of
``paddle_tpu/hapi/model_summary.py``).

A forward post hook on every leaf layer records its output shape,
parameter count and FLOPs (per layer type: a multiply-add counts 2); the
table has the JAX package's headings and counts.
"""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.tensor import Tensor

__all__ = ["summary", "flops"]


def _num_params(layer):
    seen, total, trainable = set(), 0, 0
    for p in layer.parameters():
        if id(p) in seen:
            continue
        seen.add(id(p))
        n = int(np.prod(p.shape)) if p.shape else 1
        total += n
        if not p.stop_gradient:
            trainable += n
    return total, trainable


def _layer_flops(layer, inputs, output):
    """One call's FLOPs by layer type."""
    from paddle_tpu_torch import nn

    x = inputs[0] if inputs else None
    if isinstance(layer, nn.Linear):
        batch = int(np.prod(x.shape[:-1])) if x is not None else 1
        return 2 * batch * layer.weight.shape[0] * layer.weight.shape[1]
    if isinstance(layer, nn.Conv2D):
        w = layer.weight  # [out_c, in_c/groups, kh, kw]
        return int(np.prod(output.shape)) * 2 * int(np.prod(w.shape[1:]))
    if isinstance(layer, (nn.BatchNorm2D, nn.LayerNorm, nn.RMSNorm)) \
            and x is not None:
        return 2 * int(np.prod(x.shape))
    return 0


def summary(net, input_size=None, dtypes=None, input=None):
    """Print a per-layer table; returns ``{'total_params',
    'trainable_params', 'flops'}``."""
    import paddle_tpu_torch as paddle

    rows, hooks, flop_total = [], [], [0]
    leaf_layers = [lyr for lyr in net.sublayers(include_self=False)
                   if not lyr.sublayers()]

    def make_hook(name):
        def hook(layer, inputs, output):
            out = output[0] if isinstance(output, (tuple, list)) else output
            shape = list(out.shape) if isinstance(out, Tensor) else "?"
            total, _ = _num_params(layer)
            fl = _layer_flops(layer, inputs, out)
            flop_total[0] += fl
            rows.append((name, type(layer).__name__, shape, total, fl))

        return hook

    names = {id(lyr): n for n, lyr in net.named_sublayers()}
    for lyr in leaf_layers:
        hooks.append(lyr.register_forward_post_hook(
            make_hook(names.get(id(lyr), type(lyr).__name__))))

    if input is not None:
        xs = input if isinstance(input, (list, tuple)) else [input]
    else:
        if input_size is None:
            raise ValueError("summary needs input_size or input")
        sizes = input_size if isinstance(input_size, list) and \
            isinstance(input_size[0], (list, tuple)) else [input_size]
        dts = dtypes if isinstance(dtypes, (list, tuple)) else \
            [dtypes] * len(sizes)
        xs = [paddle.zeros(list(s), dtype=dt or "float32")
              for s, dt in zip(sizes, dts)]

    was_training = net.training
    net.eval()
    try:
        net(*xs)
    finally:
        for h in hooks:
            h.remove()
        if was_training:
            net.train()

    total, trainable = _num_params(net)
    header = f"{'Layer':<38}{'Type':<18}{'Output Shape':<22}{'Params':>12}"
    lines = ["-" * len(header), header, "-" * len(header)]
    for name, tname, shape, nparam, _ in rows:
        lines.append(f"{name:<38}{tname:<18}{str(shape):<22}{nparam:>12,}")
    lines += ["-" * len(header),
              f"Total params: {total:,}",
              f"Trainable params: {trainable:,}",
              f"Non-trainable params: {total - trainable:,}",
              f"Estimated FLOPs (fwd, per batch): {flop_total[0]:,}",
              "-" * len(header)]
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable,
            "flops": flop_total[0]}


def flops(net, input_size=None, inputs=None, custom_ops=None,
          print_detail=False):
    """One forward pass's FLOPs, by :func:`summary`'s rules."""
    return summary(net, input_size=input_size, input=inputs)["flops"]
