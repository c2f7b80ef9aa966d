"""Every op of the port's manifest sections against the JAX package:
the math sections here (binary and unary math, reductions; the cases and
their rules are in ``tests/test_torch_ops_cases.py``), and the manifest
itself: the port's entries equal the reference's field for field, every
ported entry has a case, and the entries left out are exactly the ones
ROADMAP.md lists.
"""
import os
import re

import pytest

from test_torch_ops_cases import _cpu_place, cases, check_case  # noqa: F401

from test_torch_ops_cases import CASES, port_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("case", **cases("binary math", "unary math",
                                         "reductions"))
def test_op_matches_reference(case):
    check_case(case)

# ---------------------------------------------------------------------------
def _yaml_entries(path):
    from paddle_tpu_torch.ops import _parse_flow_yaml
    return _parse_flow_yaml(path)


_REF_YAML = os.path.join(ROOT, "paddle_tpu", "ops", "ops.yaml")
_PORT_YAML = os.path.join(ROOT, "paddle_tpu_torch", "ops", "ops.yaml")
_PORTED_SECTIONS = (
    "binary math", "unary math", "reductions", "creation",
    "logic / compare", "manipulation", "linalg", "activations",
    "nn: linear / embedding / conv / pool", "nn: normalization",
    "nn: dropout / sampling", "losses", "attention", "random",
    "vision (RoI family + deformable conv; emitters in vision_ops.py)",
    "long-tail surface (emitters in extras.py)",
    "nn long tail (emitters in nn_extras.py)")
# the recurrent sequence ops nn/rnn.py registers outside the manifest, in
# both packages
_RNN_SEQ_OPS = {"lstm_seq", "gru_seq", "rnn_seq"}


def _sections(path):
    """{section title: [entry line, ...]} of a manifest."""
    out, cur = {}, None
    with open(path) as fh:
        for line in fh:
            m = re.match(r"# ---- (.+?) -+$", line.strip())
            if m:
                cur = m.group(1)
                out.setdefault(cur, [])
            elif line.startswith("- {") and cur is not None:
                out[cur].append(line.strip())
    return out


def test_every_ported_entry_has_a_case():
    ops = {e["op"] for e in _yaml_entries(_PORT_YAML)}
    assert ops | _RNN_SEQ_OPS == set(port_registry.OPS)
    assert not ops & _RNN_SEQ_OPS
    assert ops == {c.op for c in CASES}
    # every case sits in a section one of the sweep files runs
    assert {c.section for c in CASES} == set(_PORTED_SECTIONS)


def test_manifest_entries_equal_the_reference():
    ref = {e["op"]: e for e in _yaml_entries(_REF_YAML)}
    ref["flash_attention"] = {"op": "flash_attention",
                              "tensor_args": ["q", "k", "v"], "methods": []}
    port = _yaml_entries(_PORT_YAML)
    for e in port:
        assert e == ref[e["op"]], e["op"]
    # every entry of the reference's manifest is the port's
    assert {e["op"] for e in port} == set(ref)
    assert len(port) == len(ref) == 408


def test_left_out_entries_are_the_ones_roadmap_lists():
    """Every entry of the ported sections is ported, the drawing ones
    (``gumbel_softmax``, the dropout / sampling and random sections)
    included since the generator came (item 7); ROADMAP's sentence says
    so."""
    ref = _sections(_REF_YAML)
    port_ops = {e["op"] for e in _yaml_entries(_PORT_YAML)}
    left_out = set()
    for title in _PORTED_SECTIONS:
        for line in ref[title]:
            op = re.match(r"- \{op: (\w+)", line).group(1)
            if op not in port_ops:
                left_out.add(op)
    with open(os.path.join(ROOT, "ROADMAP.md")) as fh:
        roadmap = fh.read()
    m = re.search(r"Left out of the ported manifest sections:\s+(.+?)\.",
                  roadmap, re.S)
    assert m, "ROADMAP.md lists no left-out manifest entries"
    listed = set(re.findall(r"`(\w+)`", m.group(1)))
    assert left_out == listed == set()
