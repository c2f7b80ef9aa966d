"""The port's ``nn.Layer`` (``paddle_tpu_torch/nn/layer.py``) against the
JAX package's: each scenario runs the same code on both packages and
compares what it returns (names, shapes, dtypes, flags, reprs exactly;
values at rtol 1e-6): registration by attribute, ``create_parameter``
with ``ParamAttr`` and the global initializer, buffers (persistable or
not), ``named_*``, ``state_dict`` / ``set_state_dict`` (which keeps the
Parameter objects, so the optimizer still holds them), ``train`` /
``eval``, ``to`` / ``astype`` / ``float`` / ``bfloat16``, forward pre- and
post-hooks, ``clear_gradients``, ``__repr__`` and the containers."""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import place as port_place


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = (port_place._current_place, port_place._current_device)
    tpaddle.set_device("cpu")
    yield
    port_place._current_place, port_place._current_device = prev


def _np(t):
    return np.asarray(t.numpy())


def _both(fn):
    out = []
    for P in (jpaddle, tpaddle):
        P.seed(0)
        out.append(fn(P))
    return out


def _net(P):
    nn = P.nn

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 3)
            self.scale = self.create_parameter(
                [3], default_initializer=nn.initializer.Constant(2.0))
            self.register_buffer("count", P.to_tensor(np.zeros([1],
                                                               np.float32)))
            self.register_buffer("scratch", P.to_tensor(np.ones([2],
                                                                np.float32)),
                                 persistable=False)
            self.act = nn.ReLU()

        def forward(self, x):
            return self.act(self.fc(x)) * self.scale

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.b1 = Block()
            self.b2 = Block()
            self.head = nn.Linear(3, 2, bias_attr=False)

        def forward(self, x):
            return self.head(self.b1(x) + self.b2(x))

    return Net()


def test_registration_traversal_and_state_dict_keys():
    def run(P):
        net = _net(P)
        return (
            [n for n, _ in net.named_parameters()],
            [(n, p.shape, p.dtype.name, p.stop_gradient, p.persistable,
              p.trainable) for n, p in net.named_parameters()],
            [n for n, _ in net.named_sublayers()],
            [n for n, _ in net.named_children()],
            [n for n, _ in net.named_buffers()],
            list(net.state_dict().keys()),
            len(net.parameters()), len(net.sublayers(include_self=True)),
            len(net.buffers()),
            [n for n, _ in net.named_parameters(include_sublayers=False)],
            repr(net), net.full_name())
    ref, got = _both(run)
    assert got == ref


def test_create_parameter_attr_and_global_initializer():
    def run(P):
        nn = P.nn

        class L(nn.Layer):
            def __init__(self):
                super().__init__()
                self.w = self.create_parameter([3, 4])
                self.b = self.create_parameter([4], is_bias=True)
                self.f = self.create_parameter(
                    [2], attr=P.ParamAttr(
                        initializer=nn.initializer.Constant(0.3),
                        learning_rate=0.5, trainable=False))
                self.h = self.create_parameter([2], dtype="bfloat16",
                                               is_bias=True)

        a = L()
        nn.initializer.set_global_initializer(
            nn.initializer.Uniform(-0.1, 0.1), nn.initializer.Constant(7.0))
        try:
            b = L()
        finally:
            nn.initializer.set_global_initializer(None)
        return ([_np(p) for p in a.parameters() + b.parameters()],
                [p.dtype.name for p in a.parameters()],
                a.f.optimize_attr, a.f.trainable, a.f.stop_gradient,
                P.get_rng_state())
    ref, got = _both(run)
    for x, y in zip(ref[0], got[0]):
        np.testing.assert_array_equal(y, x)
    assert got[1:] == ref[1:]


def test_set_state_dict_keeps_the_objects_and_the_optimizer_follows():
    def run(P):
        net = _net(P)
        params = {n: p for n, p in net.named_parameters()}
        opt = P.optimizer.AdamW(learning_rate=0.1,
                                parameters=net.parameters())
        rng = np.random.default_rng(3)
        new = {k: rng.standard_normal(v.shape).astype(np.float32)
               for k, v in net.state_dict().items()}
        new["extra"] = np.zeros([1], np.float32)
        del new["head.weight"]
        missing, unexpected = net.set_state_dict(new)
        same = all(p is params[n] for n, p in net.named_parameters())
        x = P.to_tensor(rng.standard_normal((5, 4)).astype(np.float32))
        loss = net(x).sum()
        loss.backward()
        opt.step()
        return (missing, unexpected, same,
                {n: _np(p) for n, p in net.named_parameters()},
                _np(net.b1.count))
    ref, got = _both(run)
    assert got[:3] == ref[:3]
    assert got[2] is True
    for k in ref[3]:
        np.testing.assert_allclose(got[3][k], ref[3][k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(got[4], ref[4])


def test_modes_hooks_and_clear_gradients():
    def run(P):
        net = _net(P)
        seen = []
        h1 = net.b1.register_forward_pre_hook(
            lambda layer, inputs: (inputs[0] * 2.0,))
        h2 = net.register_forward_post_hook(
            lambda layer, inputs, out: out + 1.0)
        h3 = net.b2.register_forward_post_hook(
            lambda layer, inputs, out: seen.append(out.shape))
        x = P.to_tensor(np.linspace(-1, 1, 8, dtype=np.float32).reshape(2,
                                                                        4))
        y1 = net(x)
        h1.remove()
        h2.remove()
        h3.remove()
        y2 = net(x)
        net.eval()
        modes = [lyr.training for lyr in net.sublayers(include_self=True)]
        net.train()
        modes2 = [lyr.training for lyr in net.sublayers(include_self=True)]
        y2.sum().backward()
        had = [p.grad is not None for p in net.parameters()]
        net.clear_gradients()
        cleared = [p.grad is None for p in net.parameters()]
        return _np(y1), _np(y2), seen, modes, modes2, had, cleared
    ref, got = _both(run)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)
    assert got[2:] == ref[2:]


def test_to_astype_float_bfloat16():
    def run(P):
        net = _net(P)
        out = []
        for step in (lambda n: n.astype("bfloat16"), lambda n: n.float(),
                     lambda n: n.bfloat16(), lambda n: n.to(dtype="float32"),
                     lambda n: n.to("cpu")):
            params = [id(p) for p in net.parameters()]
            step(net)
            out.append(([p.dtype.name for p in net.parameters()],
                        [b.dtype.name for b in net.buffers()],
                        params == [id(p) for p in net.parameters()],
                        all(not p.stop_gradient for p in net.parameters())))
        return out, [_np(p) for p in net.parameters()]
    ref, got = _both(run)
    assert got[0] == ref[0]
    for x, y in zip(ref[1], got[1]):
        np.testing.assert_array_equal(y, x)


def test_containers():
    def run(P):
        nn = P.nn
        seq = nn.Sequential(nn.Linear(2, 3), nn.ReLU(), nn.Linear(3, 1))
        named = nn.Sequential(("a", nn.Linear(2, 2)), ("b", nn.Tanh()))
        named2 = nn.Sequential([("c", nn.Identity()), ("d", nn.Sigmoid())])
        ll = nn.LayerList([nn.Linear(1, 1), nn.Linear(1, 2)])
        ll.append(nn.Linear(2, 3))
        ll.insert(1, nn.ReLU())
        ll.extend([nn.Identity()])
        pl = nn.ParameterList([nn.Parameter(P.to_tensor(
            np.ones([2], np.float32)))])
        pl.append(nn.Parameter(P.to_tensor(np.zeros([3], np.float32))))
        ld = nn.LayerDict({"x": nn.Linear(1, 1)})
        ld["y"] = nn.ReLU()
        ld.update([("z", nn.Tanh())])
        del ld["x"]
        x = P.to_tensor(np.array([[0.5, -1.0]], np.float32))
        return (_np(seq(x)), _np(named(x)), _np(named2(x)),
                len(seq), type(seq[1]).__name__, list(seq.state_dict()),
                list(named.state_dict()), len(ll),
                [type(l).__name__ for l in ll], type(ll[-1]).__name__,
                len(ll[1:3]), [p.shape for p in pl], pl[1].shape,
                list(ld.keys()), [type(v).__name__ for v in ld.values()],
                list(ld), len(ld), repr(seq), repr(ll))
    ref, got = _both(run)
    for i in range(3):
        np.testing.assert_allclose(got[i], ref[i], rtol=1e-6)
    assert got[3:] == ref[3:]


def test_parameter_and_layer_attribute_protocol():
    def run(P):
        nn = P.nn
        lyr = nn.Layer()
        p = nn.Parameter(P.to_tensor(np.ones([2], np.float32)))
        lyr.w = p
        lyr.sub = nn.Linear(1, 1)
        lyr.plain = 3
        had = [hasattr(lyr, "w"), "w" in lyr._parameters,
               "sub" in lyr._sub_layers, lyr.plain]
        del lyr.w
        del lyr.sub
        gone = [hasattr(lyr, "w"), hasattr(lyr, "sub")]
        p.trainable = False
        q = nn.Parameter(P.to_tensor(np.ones([1], np.float32)),
                         trainable=False)
        lyr.add_parameter("q", q)
        lyr.add_sublayer("s", nn.Identity())
        with pytest.raises(AttributeError):
            lyr.missing
        with pytest.raises(NotImplementedError):
            nn.Layer()(1)
        return (had, gone, p.stop_gradient, q.trainable, q.persistable,
                [n for n, _ in lyr.named_parameters()],
                [n for n, _ in lyr.named_children()],
                lyr.apply(lambda m: None) is lyr)
    ref, got = _both(run)
    assert got == ref
