"""``paddle.save`` / ``paddle.load`` across the two packages: a file that
either package writes loads in the other to equal values (exact), in f32
and bf16 (stored as the bf16 bits in a uint16 array under the
``__bf16__`` tag), for a Layer's ``state_dict``, a nested object of
Tensors, numbers and strings, and an optimizer's ``state_dict``; and a
model restored from the other package's file computes the same loss."""
import pickle

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import place as port_place

PACKAGES = {"jax": jpaddle, "torch": tpaddle}


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = (port_place._current_place, port_place._current_device)
    tpaddle.set_device("cpu")
    yield
    port_place._current_place, port_place._current_device = prev


def _np(t):
    return np.asarray(t.astype("float32").numpy()) \
        if t.dtype.name == "bfloat16" else np.asarray(t.numpy())


def _model(P, dtype):
    P.seed(6)
    net = P.nn.Sequential(P.nn.Embedding(11, 6), P.nn.Linear(6, 5),
                          P.nn.LayerNorm(5), P.nn.Linear(5, 3))
    if dtype != "float32":
        net.to(dtype=dtype)
    return net


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
def test_state_dict_file_loads_in_the_other_package(tmp_path, writer,
                                                    reader, dtype):
    W, R = PACKAGES[writer], PACKAGES[reader]
    src = _model(W, dtype)
    path = str(tmp_path / "m.pdparams")
    W.save(src.state_dict(), path)
    loaded = R.load(path)
    want = src.state_dict()
    assert list(loaded) == list(want)
    for k, v in want.items():
        assert loaded[k].dtype.name == dtype, k
        np.testing.assert_array_equal(_np(loaded[k]), _np(v), k)
    dst = _model(R, dtype)
    dst.set_state_dict(loaded)
    ids = np.array([[1, 2, 3], [10, 0, 4]])
    np.testing.assert_array_equal(
        _np(dst(R.to_tensor(ids))), _np(_model_from(R, src, dtype)(
            R.to_tensor(ids))))


def _model_from(R, src, dtype):
    """A model of ``R`` holding ``src``'s values (through numpy)."""
    m = _model(R, dtype)
    m.set_state_dict({k: _np(v) for k, v in src.state_dict().items()})
    return m


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_nested_objects_and_optimizer_state_cross(tmp_path, writer, reader):
    W, R = PACKAGES[writer], PACKAGES[reader]
    net = _model(W, "float32")
    opt = W.optimizer.AdamW(learning_rate=0.01,
                            parameters=net.parameters())
    net(W.to_tensor(np.array([[1, 2]]))).sum().backward()
    opt.step()
    obj = {"model": net.state_dict(), "opt": opt.state_dict(),
           "meta": {"epoch": 3, "name": "run", "lr": 0.01,
                    "shapes": [[1, 2], (3,)]},
           "extra": [W.to_tensor(np.arange(4, dtype=np.float32)),
                     W.to_tensor(np.array([True, False]))]}
    path = str(tmp_path / "ckpt.pd")
    W.save(obj, path)
    back = R.load(path)
    assert back["meta"] == obj["meta"]
    for k, v in obj["model"].items():
        np.testing.assert_array_equal(_np(back["model"][k]), _np(v))
    for k, v in obj["opt"].items():
        got = back["opt"][k]
        if hasattr(got, "numpy"):
            np.testing.assert_array_equal(np.asarray(got.numpy()),
                                          np.asarray(v.numpy()
                                                     if hasattr(v, "numpy")
                                                     else v))
        else:
            assert got == v, k
    np.testing.assert_array_equal(_np(back["extra"][0]), np.arange(4))
    np.testing.assert_array_equal(np.asarray(back["extra"][1].numpy()),
                                  [True, False])


def test_the_file_is_the_reference_format(tmp_path):
    """What the port writes: plain numpy arrays, bf16 as its bits in a
    uint16 array under ``__bf16__``, nothing of torch in the pickle."""
    path = str(tmp_path / "x.pd")
    t16 = tpaddle.to_tensor(np.array([1.5, -2.25, 3.0], np.float32),
                            dtype="bfloat16")
    tpaddle.save({"a": tpaddle.to_tensor(np.ones((2, 2), np.float32)),
                  "b": t16}, path)
    with open(path, "rb") as fh:
        raw = pickle.load(fh)
    assert isinstance(raw["a"], np.ndarray) and raw["a"].dtype == np.float32
    assert raw["b"]["__bf16__"] is True
    assert raw["b"]["data"].dtype == np.uint16
    np.testing.assert_array_equal(raw["b"]["data"],
                                  [0x3FC0, 0xC010, 0x4040])
    with open(path, "rb") as fh:
        assert b"torch" not in fh.read()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_state_round_trips_through_save_and_load(tmp_path, dtype):
    """An AdamW ``state_dict`` saved with ``paddle.save`` and loaded with
    ``paddle.load`` restores into a fresh optimizer with every slot in
    its dtype, and the next step of both optimizers is bit-identical."""
    def run(model, opt, ids):
        model(tpaddle.to_tensor(ids)).astype("float32").sum().backward()
        opt.step()
        opt.clear_grad()

    ids = np.array([[1, 2, 3], [10, 0, 4]])
    net = _model(tpaddle, dtype)
    opt = tpaddle.optimizer.AdamW(learning_rate=0.01,
                                  parameters=net.parameters())
    run(net, opt, ids)
    path = str(tmp_path / "o.pdopt")
    tpaddle.save(opt.state_dict(), path)
    twin = _model(tpaddle, dtype)
    twin.set_state_dict(net.state_dict())
    opt2 = tpaddle.optimizer.AdamW(learning_rate=0.01,
                                   parameters=twin.parameters())
    opt2.set_state_dict(tpaddle.load(path))
    for k, v in opt.state_dict().items():
        got = opt2.state_dict()[k]
        if hasattr(v, "dtype"):
            assert got.dtype == v.dtype, k
    run(net, opt, ids)
    run(twin, opt2, ids)
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(_np(twin.state_dict()[k]), _np(v), k)
