"""The port's fleet (``paddle_tpu_torch.serving.fleet``) against the JAX
package's.

``tests/test_fleet.py`` runs again with every name it takes from the JAX
package bound to the port's counterpart (:func:`ported`): its classes
(``FakeReplica``, the test classes) are rebuilt on the port's bases and
its functions re-bound to the port's names, so each of its assertions
(dispatch decisions, DRR shares, registry TTLs, hand-off budgets,
scaling, counters, token identity against one engine) holds the port.
``LlamaForCausalLM(LlamaConfig.tiny())`` builds the port's tiny Llama on
the CPU with the JAX package's seed-0 tiny weights carried across
(``llama_state_from_jax``). ``tests/test_torch_fleet_prefix.py``,
``_fleet_routers.py``, ``_fleet_transport.py``, ``_peer_data_plane.py``,
``_fleet_subprocess.py`` and ``test_torch_kvtier.py`` do the same for
the other suites through :func:`ported`.

Then the two packages side by side: the array-free scenarios run once
on each and their routers' snapshots (every counter, the finish and
ticket buckets, per-tenant dispatch counts, per-replica flags; the
wall-clock fields left out) must be equal; the tiny-Llama fleets
serve greedy and sampled tokens identical to the JAX package's fleet;
and the stores under the registry (``FileStore``, ``TCPStore``) answer
alike; ``Store`` works once ``init_parallel_env`` has joined a world.
"""
import ast
import functools
import importlib
import inspect
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch
import test_fleet
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.models.convert import llama_state_from_jax

# ---------------------------------------------------------------------------
# the reference's suites, bound to the port
# ---------------------------------------------------------------------------
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny engines' ops are too small to split across threads: one
    intra-op thread in this test process (the suite runs several at
    once, and a thread per core in each oversubscribes the machine),
    restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_TINY_STATE = {}


def _jax_tiny_state():
    """The JAX package's tiny Llama at ``paddle.seed(0)`` (what every
    reference fleet suite seeds before building it), as numpy."""
    if not _TINY_STATE:
        jpaddle.seed(0)
        jm = JLlama(JLlamaConfig.tiny())
        _TINY_STATE.update({k: np.asarray(v.numpy())
                            for k, v in jm.state_dict().items()})
    return _TINY_STATE


def PortTinyLlama(config=None, device="cpu"):
    """``LlamaForCausalLM(LlamaConfig.tiny())`` of a reference suite,
    built by the port on the CPU with the JAX package's seed-0 tiny
    weights."""
    config = config or port_llama.LlamaConfig.tiny()
    if vars(config) != vars(port_llama.LlamaConfig.tiny()):
        raise ValueError("the reference fleet suites build the tiny "
                         "Llama only")
    m = port_llama.LlamaForCausalLM(config, device=device)
    m.load_state_dict(llama_state_from_jax(_jax_tiny_state()))
    m.eval()
    return m


PortTinyLlama.tiny = port_llama.LlamaConfig.tiny

# names whose port counterpart is not the same name in the mirrored
# module
_OVERRIDES = {"LlamaForCausalLM": PortTinyLlama}


def _port_name(name):
    if name == "paddle_tpu" or name.startswith("paddle_tpu."):
        return "paddle_tpu_torch" + name[len("paddle_tpu"):]
    return None


def _imported_names(mod):
    """{global name: port object} for every name ``mod`` imports from
    the JAX package (read off its import statements)."""
    out = {}
    tree = ast.parse(inspect.getsource(mod))
    for node in tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                port = _port_name(a.name)
                if port is not None:
                    out[a.asname or a.name.split(".")[0]] = \
                        importlib.import_module(port)
        elif isinstance(node, ast.ImportFrom) and node.module:
            port = _port_name(node.module)
            if port is None:
                continue
            pmod = importlib.import_module(port)
            for a in node.names:
                name = a.asname or a.name
                val = getattr(pmod, a.name, None)
                if val is None:
                    val = importlib.import_module(f"{port}.{a.name}")
                out[name] = val
    return out


def _body_imports(fn):
    """The JAX-package modules ``fn`` imports inside its body."""
    try:
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    except (OSError, TypeError):
        return []
    names = []
    for node in ast.walk(tree.body[0]):
        if isinstance(node, ast.ImportFrom) and _port_name(node.module
                                                           or ""):
            names.append(node.module)
        elif isinstance(node, ast.Import):
            names += [a.name for a in node.names if _port_name(a.name)]
    return names


def _aliased(fn, names):
    """``fn`` with the JAX-package modules it imports in its body bound
    to the port's while it runs (``sys.modules`` entries, restored
    after)."""
    @functools.wraps(fn)
    def call(*args, **kw):
        saved = {n: sys.modules.get(n) for n in names}
        sys.modules.update({n: importlib.import_module(_port_name(n))
                            for n in names})
        try:
            return fn(*args, **kw)
        finally:
            for n, m in saved.items():
                if m is None:
                    sys.modules.pop(n, None)
                else:
                    sys.modules[n] = m
    return call


def _rebind(fn, g):
    new = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                             fn.__closure__)
    new.__kwdefaults__ = fn.__kwdefaults__
    new.__dict__.update(fn.__dict__)
    new.__qualname__ = fn.__qualname__
    names = _body_imports(fn)
    if names:
        assert not inspect.isgeneratorfunction(fn), fn
        return _aliased(new, names)
    return new


def _rebind_attr(v, g):
    if isinstance(v, types.FunctionType):
        return _rebind(v, g)
    if isinstance(v, staticmethod):
        return staticmethod(_rebind_attr(v.__func__, g))
    if isinstance(v, classmethod):
        return classmethod(_rebind_attr(v.__func__, g))
    if isinstance(v, property):
        return property(*(_rebind_attr(f, g) if f else None
                          for f in (v.fget, v.fset, v.fdel)), v.__doc__)
    return v


def _fixture_of(obj):
    return getattr(obj, "_fixture_function_marker", None)


def ported(mod):
    """``mod``'s namespace with every JAX-package name bound to the
    port's: functions re-bound, classes and fixtures rebuilt (a class on
    the port's bases). Returns the new globals dict."""
    g = dict(mod.__dict__)
    g.update(_imported_names(mod))
    g.update({k: v for k, v in _OVERRIDES.items() if k in g})
    rebuilt = {}
    for name, obj in list(mod.__dict__.items()):
        marker = _fixture_of(obj)
        if marker is not None:
            fn = _rebind(obj._get_wrapped_function(), g)
            g[name] = pytest.fixture(scope=marker.scope,
                                     params=marker.params,
                                     autouse=marker.autouse,
                                     ids=marker.ids, name=marker.name)(fn)
        elif isinstance(obj, types.FunctionType) and \
                obj.__module__ == mod.__name__:
            g[name] = _rebind(obj, g)
        elif isinstance(obj, type) and obj.__module__ == mod.__name__:
            rebuilt[name] = obj
    # classes in definition order, so a base defined in the module is
    # rebuilt before its subclasses
    for name, cls in sorted(rebuilt.items(),
                            key=lambda kv: inspect.getsourcelines(kv[1])[1]):
        bases = tuple(g.get(b.__name__, b)
                      if b.__module__ == mod.__name__ else
                      _port_class(b) for b in cls.__bases__)
        body = {k: _rebind_attr(v, g) for k, v in cls.__dict__.items()
                if k not in ("__dict__", "__weakref__")}
        new = type(cls)(name, bases, body)
        new.__module__ = __name__
        g[name] = new
    return g


def _port_class(cls):
    port = _port_name(cls.__module__)
    if port is None:
        return cls
    return getattr(importlib.import_module(port), cls.__qualname__)


def export(mod, into, only=None):
    """Put ``mod``'s test classes, test functions and fixtures, bound to
    the port, into the namespace ``into`` (a test module's globals);
    ``only`` picks test classes / functions by name."""
    g = ported(mod)
    for name, obj in g.items():
        if _fixture_of(obj) is not None:
            into.setdefault(name, obj)
        elif name.startswith("Test") and isinstance(obj, type) and \
                obj.__module__ == __name__ and (only is None
                                                or name in only):
            into[name] = obj
        elif name.startswith("test_") and isinstance(
                obj, types.FunctionType) and (only is None or name in only):
            into[name] = obj
    return g


PORT = export(test_fleet, globals())


# ---------------------------------------------------------------------------
# both packages side by side
# ---------------------------------------------------------------------------
_WALL_CLOCK = ("ms_avg", "ms_max", "per_sec", "tokens_per_s", "_s_avg",
               "ttft", "tpot", "wall", "uptime", "elapsed")


def _stable(snap):
    """A snapshot without its wall-clock fields (and without the
    engines' own snapshots, which carry latencies: a replica keeps its
    alive / draining / retiring flags)."""
    out = {}
    for k, v in snap.items():
        if any(w in k for w in _WALL_CLOCK) or k in ("fleet_load",
                                                     "fleet_tenant_load"):
            continue
        if k == "replicas":
            v = {r: {f: rec[f] for f in ("alive", "draining", "retiring")}
                 for r, rec in v.items()}
        elif isinstance(v, dict):
            v = _stable(v)
        out[k] = v
    return out


class _Recorder:
    """Collects every router the scenario builds (one package's
    ``FleetRouter``), for their snapshots after it ran."""

    def __init__(self, router_cls, monkeypatch):
        self.routers = []
        init = router_cls.__init__
        rec = self

        def wrapped(self, *a, **kw):
            init(self, *a, **kw)
            rec.routers.append(self)

        monkeypatch.setattr(router_cls, "__init__", wrapped)

    def snapshots(self):
        return [_stable(r.snapshot()) for r in self.routers]


def _run_scenario(cls, meth, router_cls, monkeypatch, **kw):
    rec = _Recorder(router_cls, monkeypatch)
    getattr(cls(), meth)(**kw)
    monkeypatch.undo()
    return rec.snapshots()


# run by the ported classes only: a wall-clock deadline (restated with
# margin below), and a check that a dropped router frees its providers
# (the recorder holds every router)
_ALONE = ("test_queued_deadline_expires_in_queue",
          "test_dropped_router_unregisters_providers")
_ARRAY_FREE = [(c, m) for c in ("TestDispatch", "TestTenantFairness",
                                "TestRegistry", "TestHandoff",
                                "TestScaling", "TestFleetMetrics")
               for m in sorted(vars(getattr(test_fleet, c)))
               if m.startswith("test_") and m not in _ALONE]


@pytest.mark.parametrize("cls,meth", _ARRAY_FREE,
                         ids=[f"{c}.{m}" for c, m in _ARRAY_FREE])
def test_array_free_scenarios_match_the_reference(cls, meth, monkeypatch):
    """FakeReplica scenarios through both packages' routers: every
    router's snapshot equal (decisions, counters, buckets)."""
    from paddle_tpu.serving.fleet import FleetRouter as JRouter
    from paddle_tpu_torch.serving.fleet import FleetRouter as TRouter

    ref = _run_scenario(getattr(test_fleet, cls), meth, JRouter,
                        monkeypatch)
    got = _run_scenario(PORT[cls], meth, TRouter, monkeypatch)
    assert got == ref


def test_queued_deadline_expires_with_margin():
    """The reference's in-queue expiry with a deadline far from the
    test's own timing (its 5 ms one has expired late under load): a
    request queued behind a full replica expires in the router queue,
    on both packages, with the same outputs and counters."""
    import time

    from paddle_tpu.serving import SamplingParams as JSP
    from paddle_tpu.serving.fleet import FleetRouter as JRouter

    from paddle_tpu_torch.serving import SamplingParams as TSP
    from paddle_tpu_torch.serving.fleet import FleetRouter as TRouter

    got = []
    for router_cls, sp, fake in ((JRouter, JSP, test_fleet.FakeReplica),
                                 (TRouter, TSP, PORT["FakeReplica"])):
        rep = fake("ra", capacity=1)
        router = router_cls([rep])
        r1 = router.add_request([1], sp(max_new_tokens=6))
        r2 = router.add_request([2], sp(max_new_tokens=1,
                                        deadline_ms=200.0))
        router.step()                  # r1 dispatched, r2 blocked
        time.sleep(0.4)
        outs = test_fleet._drain_router(router)
        final = {o.request_id: o.finish_reason for o in outs if o.finished}
        assert final == {r1: "length", r2: "expired"}
        assert rep.dispatch_log == [r1]
        got.append(_stable(router.snapshot()))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# the tiny-Llama fleets: the port's tokens are the JAX package's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def both_models():
    jpaddle.seed(0)
    jm = JLlama(JLlamaConfig.tiny())
    jm.eval()
    return jm, PortTinyLlama()


def _serve(pkg, model, roles, sampled, drain_at=None):
    """Four requests through a two-replica fleet of ``pkg``; the
    generated tokens by id and the router's stable snapshot."""
    serving = importlib.import_module(f"{pkg}.serving")
    fleet = importlib.import_module(f"{pkg}.serving.fleet")
    faults = importlib.import_module(f"{pkg}.testing.faults")
    ecfg = dict(block_size=4, max_num_seqs=4, max_model_len=64,
                drain_grace_s=0.0)
    reps = [fleet.InProcessReplica(model, serving.EngineConfig(**ecfg),
                                   replica_id=r) for r in ("a", "b")]
    router = fleet.FleetRouter(reps, fleet.FleetConfig(
        roles=roles, prefix_affinity=False, peer_data_plane=False))
    sp = (serving.SamplingParams(max_new_tokens=8, temperature=0.8,
                                 top_p=0.9) if sampled
          else serving.SamplingParams(max_new_tokens=8))
    rng = np.random.default_rng(5)
    for i, n in enumerate((9, 14, 6, 19)):
        router.add_request(f"s{i}", [int(t) for t in
                                     rng.integers(1, 255, size=n)], sp)
    steps = 0
    while router.has_unfinished():
        if steps == drain_at:
            faults.install("fleet.drain_replica:flag:a*1")
        router.step()
        steps += 1
        assert steps < 300
    faults.clear()
    toks = {f"s{i}": list(router.get_request(f"s{i}").generated)
            for i in range(4)}
    return toks, _stable(router.snapshot())


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("mode", ["load", "disagg", "drain"])
def test_tiny_fleet_tokens_equal_the_reference(both_models, mode, sampled):
    """Two replicas load-balanced, a prefill/decode pair with KV ship,
    and a drain mid-stream (zero grace, blocks handed off): the port's
    fleet serves the JAX package's tokens and keeps its counters."""
    roles = {"a": "prefill", "b": "decode"} if mode == "disagg" else None
    drain = 2 if mode == "drain" else None
    jm, tm = both_models
    ref = _serve("paddle_tpu", jm, roles, sampled, drain)
    got = _serve("paddle_tpu_torch", tm, roles, sampled, drain)
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    if mode == "disagg":
        assert got[1]["fleet_kv_ship_requests"] == 4
        assert got[1]["fleet_tokens_recomputed"] == 0
    if mode == "drain":
        assert got[1]["fleet_handoffs"] >= 1


def test_the_package_exports_the_reference_names():
    from paddle_tpu.serving import fleet as jfleet
    from paddle_tpu_torch.serving import fleet as tfleet

    assert tfleet.__all__ == jfleet.__all__
    assert paddle_tpu_torch.serving.fleet is tfleet


# ---------------------------------------------------------------------------
# the stores under the registry
# ---------------------------------------------------------------------------
def _store_script(st):
    st.set("a/b", "1")
    st.set("c", b"\x00\xff")
    out = [st.try_get("a/b"), st.try_get("c"), st.try_get("nope"),
           st.get("c", timeout=1.0), st.add("n", 2), st.add("n", 3)]
    out.append(sorted(k for k in st.list("a") if not k.startswith("n")))
    st.delete("a/b")
    out.append(st.try_get("a/b"))
    return out


@pytest.mark.parametrize("kind", ["file", "tcp"])
def test_stores_answer_like_the_reference(kind, tmp_path):
    """``FileStore`` and ``TCPStore`` of both packages answer the same
    script alike, and a ``FileStore`` directory one package wrote reads
    the same through the other's."""
    from paddle_tpu.distributed import store as jstore

    from paddle_tpu_torch.distributed import store as tstore

    got = []
    for mod, sub in ((jstore, "j"), (tstore, "t")):
        if kind == "file":
            got.append(_store_script(mod.FileStore(str(tmp_path / sub))))
        else:
            spec, stop = mod.TCPStore.serve("127.0.0.1", 0)
            try:
                got.append(_store_script(mod.TCPStore(spec)))
            finally:
                stop()
    assert got[0] == got[1]
    if kind == "file":
        assert tstore.FileStore(str(tmp_path / "j")).try_get("c") == \
            jstore.FileStore(str(tmp_path / "j")).try_get("c")


def test_the_runtime_store_waits_for_slice_d(tmp_path, monkeypatch):
    """Before ``init_parallel_env`` the runtime ``Store`` (the default
    process group's store) and ``FileStore.barrier`` without
    ``world_size`` raise naming it, and ``current_store`` takes the
    ``PADDLE_STORE_DIR`` FileStore, as the reference does without a
    coordination service. After it (a one-rank world here) ``Store``
    sets, gets, counts, lists and passes a barrier, and
    ``FileStore.barrier`` takes the world's size."""
    import paddle_tpu_torch.distributed as tdist
    from paddle_tpu_torch.distributed import store as tstore

    with pytest.raises(RuntimeError, match="init_parallel_env"):
        tstore.Store()
    with pytest.raises(ValueError, match="init_parallel_env"):
        tstore.FileStore(str(tmp_path / "b")).barrier("x")
    monkeypatch.setattr(tstore, "_store", None)
    monkeypatch.setenv("PADDLE_STORE_DIR", str(tmp_path / "s"))
    st = tstore.current_store()
    assert isinstance(st, tstore.FileStore)
    st.set("k", "v")
    assert tstore.current_store().try_get("k") == b"v"

    for var in ("PADDLE_TRAINERS_NUM", "WORLD_SIZE", "PADDLE_TRAINER_ID",
                "RANK"):
        monkeypatch.delenv(var, raising=False)
    tdist.init_parallel_env()
    try:
        rs = tstore.Store(prefix="t")
        rs.set("a/1", "x")
        rs.set("a/2", b"y")
        assert rs.get("a/1") == b"x" and rs.try_get("a/2") == b"y"
        assert rs.try_get("missing") is None
        assert rs.add("n", 2) == 2 and rs.add("n", 3) == 5
        assert sorted(rs.list("a/")) == ["a/1", "a/2"]
        rs.delete("a/1")
        assert rs.list("a/") == ["a/2"]
        rs.barrier("b")
        with pytest.raises(TimeoutError):
            rs.get("never", timeout=0.2)
        tstore.FileStore(str(tmp_path / "b")).barrier("x", timeout=5.0)
        monkeypatch.setattr(tstore, "_store", None)
        assert isinstance(tstore.current_store(), tstore.Store)
    finally:
        tdist.destroy_process_group()
