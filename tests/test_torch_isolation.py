"""The port stands alone: ``paddle_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package (whose ``__init__`` loads JAX)."""
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
    "paddle_tpu_torch.serving",
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
            "    or k == 'paddle_tpu' or k.startswith('paddle_tpu.'))))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("pattern", [
    r"^\s*(import|from)\s+jax\b",
    r"^\s*(import|from)\s+paddle_tpu(\.|\s|$)",
])
def test_sources_do_not_import_jax(pattern):
    rx = re.compile(pattern, re.M)
    hits = []
    for path in _sources():
        with open(path) as f:
            for m in rx.finditer(f.read()):
                hits.append(f"{os.path.relpath(path, ROOT)}: {m.group(0)}")
    assert not hits, hits
