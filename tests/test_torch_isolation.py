"""The port stands alone: ``paddle_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package (whose ``__init__`` loads JAX),
nor ``ml_dtypes`` (the card's machine does not have it: a bf16 numpy
array is known by its dtype's name), nor ``yaml`` (the card's machine
has no PyYAML: the op manifest is read by the port's own parser)."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")

_MODULES = [
    "paddle_tpu_torch", "paddle_tpu_torch.core", "paddle_tpu_torch.nn",
    "paddle_tpu_torch.profiler", "paddle_tpu_torch.testing.faults",
    "paddle_tpu_torch.ops._build", "paddle_tpu_torch.ops.sampling",
    "paddle_tpu_torch.ops.ragged_paged_attention",
    "paddle_tpu_torch.incubate.nn.functional",
    "paddle_tpu_torch.models.llama", "paddle_tpu_torch.models.convert",
    "paddle_tpu_torch.serving", "paddle_tpu_torch.ops.flash_attention",
    "paddle_tpu_torch.ops.nn_ops", "paddle_tpu_torch.nn.functional",
    "paddle_tpu_torch.nn.clip", "paddle_tpu_torch.optimizer",
    "paddle_tpu_torch.jit", "paddle_tpu_torch.tools.gpt_1b_train",
    "paddle_tpu_torch.tools.profile_train",
    "paddle_tpu_torch.tools.tiny_train_parity",
    "paddle_tpu_torch.ops.threefry", "paddle_tpu_torch.serving.spec",
    "paddle_tpu_torch.tools.llama3_8b_serve",
    "paddle_tpu_torch.tools.llama3_8b_spec_serve",
    "paddle_tpu_torch.tools.tiny_spec_parity",
    "paddle_tpu_torch.distributed", "paddle_tpu_torch.distributed.watchdog",
    "paddle_tpu_torch.serving.engine", "paddle_tpu_torch.serving.scheduler",
    "paddle_tpu_torch.serving.block_manager",
    "paddle_tpu_torch.serving.metrics", "paddle_tpu_torch.serving.request",
    "paddle_tpu_torch.incubate.nn.functional.block_attention",
    "paddle_tpu_torch.tools.tiny_resilience_parity",
    "paddle_tpu_torch.tools.step_checks",
    "paddle_tpu_torch.tools.flash_check_draws",
    "paddle_tpu_torch.testing.flash_check", "paddle_tpu_torch.amp",
    "paddle_tpu_torch.core.op", "paddle_tpu_torch.optimizer.lr",
    "paddle_tpu_torch.distributed.checkpoint",
    "paddle_tpu_torch.distributed.checkpoint.manager",
    "paddle_tpu_torch.distributed.checkpoint.metadata",
    "paddle_tpu_torch.tools.eager_train", "paddle_tpu_torch.io",
    "paddle_tpu_torch.io.shm_queue", "paddle_tpu_torch.io.prefetch",
    "paddle_tpu_torch.profiler.timer", "paddle_tpu_torch.tools.fed_train",
    "paddle_tpu_torch.core.place", "paddle_tpu_torch.core.dtype",
    "paddle_tpu_torch.core.flags", "paddle_tpu_torch.core.tensor",
    "paddle_tpu_torch.ops", "paddle_tpu_torch.ops.registry",
    "paddle_tpu_torch.ops.math", "paddle_tpu_torch.ops.creation",
    "paddle_tpu_torch.ops.logic", "paddle_tpu_torch.ops.manipulation",
    "paddle_tpu_torch.ops.linalg", "paddle_tpu_torch.autograd",
    "paddle_tpu_torch.autograd.engine",
    "paddle_tpu_torch.autograd.functional",
    "paddle_tpu_torch.autograd.py_layer",
    "paddle_tpu_torch.nn.functional.flash_attention",
    "paddle_tpu_torch.nn.norm", "paddle_tpu_torch.tools.tensor_api_train",
    "paddle_tpu_torch.core.generator", "paddle_tpu_torch.ops.random_ops",
    "paddle_tpu_torch.ops.spectral", "paddle_tpu_torch.nn.layer",
    "paddle_tpu_torch.nn.initializer", "paddle_tpu_torch.nn.common",
    "paddle_tpu_torch.nn.activation", "paddle_tpu_torch.nn.loss",
    "paddle_tpu_torch.nn.conv_pool", "paddle_tpu_torch.nn.utils",
    "paddle_tpu_torch.framework", "paddle_tpu_torch.framework.io_utils",
    "paddle_tpu_torch.framework.param_attr",
    "paddle_tpu_torch.distributed.fleet",
    "paddle_tpu_torch.distributed.fleet.mp_layers",
    "paddle_tpu_torch.compat_extra",
    "paddle_tpu_torch.tools.layer_api_train",
    "paddle_tpu_torch.serving.kvtier", "paddle_tpu_torch.serving.kvtier.store",
    "paddle_tpu_torch.tools.llama3_8b_tiers",
    "paddle_tpu_torch.ops.extras", "paddle_tpu_torch.ops.nn_extras",
    "paddle_tpu_torch.ops.vision_ops", "paddle_tpu_torch.nn.rnn",
    "paddle_tpu_torch.nn.transformer", "paddle_tpu_torch.nn.layers_extra",
    "paddle_tpu_torch.nn.functional.extras", "paddle_tpu_torch.signal",
    "paddle_tpu_torch.fft", "paddle_tpu_torch.linalg",
    "paddle_tpu_torch.tools.ds2_ctc_train",
    "paddle_tpu_torch.tools.long_tail_cases",
    "paddle_tpu_torch.distributed.redistribute",
    "paddle_tpu_torch.serving.tp", "paddle_tpu_torch.testing.tp_hooks",
    "paddle_tpu_torch.testing.gloo_ranks",
    "paddle_tpu_torch.tools.llama3_8b_tp",
    "paddle_tpu_torch.distributed.store",
    "paddle_tpu_torch.distributed.replica_registry",
    "paddle_tpu_torch.serving.fleet", "paddle_tpu_torch.serving.fleet.lease",
    "paddle_tpu_torch.serving.fleet.tenant",
    "paddle_tpu_torch.serving.fleet.metrics",
    "paddle_tpu_torch.serving.fleet.replica",
    "paddle_tpu_torch.serving.fleet.router",
    "paddle_tpu_torch.serving.fleet.controller",
    "paddle_tpu_torch.serving.fleet.sim",
    "paddle_tpu_torch.serving.fleet.transport",
    "paddle_tpu_torch.serving.fleet.worker",
    "paddle_tpu_torch.serving.fleet.supervisor",
    "paddle_tpu_torch.testing.fleet_models",
    "paddle_tpu_torch.tools.llama3_8b_fleet",
    "paddle_tpu_torch.distributed.env", "paddle_tpu_torch.distributed.mesh",
    "paddle_tpu_torch.distributed.communication",
    "paddle_tpu_torch.distributed.compat",
    "paddle_tpu_torch.distributed.topology",
    "paddle_tpu_torch.distributed.engine",
    "paddle_tpu_torch.distributed.parallel_wrapper",
    "paddle_tpu_torch.distributed.fleet.facade",
    "paddle_tpu_torch.distributed.fleet.recompute",
    "paddle_tpu_torch.distributed.fleet.utils",
    "paddle_tpu_torch.distributed.fleet.utils.sequence_parallel_utils",
    "paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util",
    "paddle_tpu_torch.testing.hybrid_ranks",
    "paddle_tpu_torch.tools.gpt_1b_hybrid_train",
    "paddle_tpu_torch.distributed.fleet.pipeline_parallel",
    "paddle_tpu_torch.distributed.fleet.pp_engine",
    "paddle_tpu_torch.distributed.api",
    "paddle_tpu_torch.testing.pipeline_ranks",
    "paddle_tpu_torch.testing.semi_auto_ranks",
    "paddle_tpu_torch.tools.gpt_1b_pipe_train",
    "paddle_tpu_torch.ops.ring_attention", "paddle_tpu_torch.incubate",
    "paddle_tpu_torch.incubate.moe",
    "paddle_tpu_torch.incubate.moe.moe_layer",
    "paddle_tpu_torch.incubate.moe.grad_clip",
    "paddle_tpu_torch.testing.cp_ranks",
    "paddle_tpu_torch.testing.moe_ranks",
    "paddle_tpu_torch.tools.gpt_1b_cp_train",
    "paddle_tpu_torch.tools.moe_train",
    # slice D4: the gang
    "paddle_tpu_torch.distributed.launch",
    "paddle_tpu_torch.distributed.launch.elastic",
    "paddle_tpu_torch.distributed.auto_tuner",
    "paddle_tpu_torch.distributed.store",
    "paddle_tpu_torch.distributed.env",
    "paddle_tpu_torch.distributed.communication",
    "paddle_tpu_torch.distributed.engine",
    "paddle_tpu_torch.testing.gang_ranks",
    "paddle_tpu_torch.testing.launch_workers",
    "paddle_tpu_torch.tools.gpt_1b_gang_train",
    # slice E2a and the high-level API
    "paddle_tpu_torch.incubate.nn",
    "paddle_tpu_torch.incubate.nn.functional.fused_ops",
    "paddle_tpu_torch.incubate.nn.layer",
    "paddle_tpu_torch.incubate.compat",
    "paddle_tpu_torch.models", "paddle_tpu_torch.models.bert",
    "paddle_tpu_torch.metric", "paddle_tpu_torch.hapi",
    "paddle_tpu_torch.hapi.callbacks", "paddle_tpu_torch.hapi.model",
    "paddle_tpu_torch.hapi.model_summary",
    "paddle_tpu_torch.tools.bert_base_train",
]


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import importlib, json, sys\n"
            f"for m in {_MODULES!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(k for k in sys.modules\n"
            "    if k == 'jax' or k.startswith('jax.')\n"
            "    or k == 'paddle_tpu' or k.startswith('paddle_tpu.')\n"
            "    or k == 'ml_dtypes' or k.startswith('ml_dtypes.')\n"
            "    or k == 'yaml' or k.startswith('yaml.'))))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("pattern", [
    r"^\s*(import|from)\s+jax\b",
    r"^\s*(import|from)\s+paddle_tpu(\.|\s|$)",
    r"^\s*(import|from)\s+ml_dtypes\b",
    r"^\s*(import|from)\s+yaml\b",
])
def test_sources_do_not_import_jax(pattern):
    rx = re.compile(pattern, re.M)
    hits = []
    for path in _sources():
        with open(path) as f:
            for m in rx.finditer(f.read()):
                hits.append(f"{os.path.relpath(path, ROOT)}: {m.group(0)}")
    assert not hits, hits
