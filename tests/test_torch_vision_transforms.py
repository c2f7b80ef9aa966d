"""The port's ``vision.transforms`` and ``vision.datasets`` against the JAX
package's.

Every class and functional transform on the same arrays: the
deterministic ones on fixed inputs, the random ones under the same
``np.random.seed`` (both draw from numpy's global RNG in the same order).
``Resize`` (torch's antialiased ``interpolate`` against
``jax.image.resize(method="linear")``) up and down, CHW and HWC, at rtol
1e-5 (atol 1e-5 of the largest value). Every dataset on synthetic files
written here (a CIFAR-10 and a CIFAR-100 tar, MNIST idx gzips, an
``ImageFolder`` of ``.npy`` images) and in its synthetic mode. The
loaders' workers share numpy's RNG in both packages (each worker draws
the same crops); a ``worker_init_fn`` that seeds each worker parts them.
"""
import gzip
import io as _io
import os
import pickle
import tarfile

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu.io  # noqa: F401
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.io  # noqa: F401
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as jT
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as tT

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    saved = (_place._current_place, _place._current_device)
    tpaddle.set_device("cpu")
    yield
    _place._current_place, _place._current_device = saved


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _same(a, b, **tol):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_allclose(b, a, **(tol or TOL))


def _img(shape, seed=0, dtype=np.float32, scale=1.0):
    x = np.random.RandomState(seed).rand(*shape) * scale
    return x.astype(dtype)


def _both(make, img, seed=None):
    """``make(T)`` applied to ``img`` with each package's transforms,
    numpy seeded alike before each when ``seed`` is given."""
    outs = []
    for T in (jT, tT):
        if seed is not None:
            np.random.seed(seed)
        outs.append(make(T)(np.array(img)))
    return outs


# ---------------------------------------------------------------------------
# Resize
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("src,size", [
    ((3, 375, 500), 224), ((3, 100, 90), 224), ((3, 256, 256), (224, 200)),
    ((3, 7, 5), (13, 11)), ((1, 40, 30), (10, 17)), ((4, 3, 3), 1),
    ((375, 500, 3), 224), ((90, 100, 3), (256, 120)), ((9, 6, 2), (4, 4)),
])
def test_resize_matches_jax_image_resize(src, size):
    img = _img(src, scale=255.0)
    j, t = _both(lambda T: T.Resize(size), img)
    _same(j, t, rtol=1e-5, atol=1e-5 * float(np.abs(j).max()))


def test_resize_takes_uint8_and_makes_a_square():
    img = _img((300, 400, 3), dtype=np.uint8, scale=255.0)
    j, t = _both(lambda T: T.Resize(256), img)
    assert t.shape == (256, 256, 3) and t.dtype == np.float32
    _same(j, t, rtol=1e-5, atol=1e-5 * 255)
    _same(jT.resize(img, 64), tT.resize(img, 64), rtol=1e-5,
          atol=1e-5 * 255)


def test_resize_under_one_worker_thread():
    """DataLoader workers run with ``torch.set_num_threads(1)``: the
    resize is the same there."""
    import torch

    img = _img((3, 300, 200), scale=255.0)
    want = tT.Resize(224)(img)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        np.testing.assert_array_equal(tT.Resize(224)(img), want)
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the deterministic class transforms
# ---------------------------------------------------------------------------
_CHW = _img((3, 20, 24), seed=1)
_HWC = _img((20, 24, 3), seed=2)
_U8 = _img((20, 24, 3), seed=3, dtype=np.uint8, scale=255.0)


@pytest.mark.parametrize("name,make,img", [
    ("normalize_chw", lambda T: T.Normalize([0.4, 0.5, 0.6],
                                            [0.2, 0.3, 0.25]), _CHW),
    ("normalize_hwc", lambda T: T.Normalize([0.4, 0.5, 0.6],
                                            [0.2, 0.3, 0.25], "HWC"), _HWC),
    ("to_tensor_u8", lambda T: T.ToTensor(), _U8),
    ("to_tensor_float", lambda T: T.ToTensor(), _HWC),
    ("to_tensor_hwc", lambda T: T.ToTensor("HWC"), _U8),
    ("transpose", lambda T: T.Transpose(), _HWC),
    ("center_crop_chw", lambda T: T.CenterCrop(11), _CHW),
    ("center_crop_hwc", lambda T: T.CenterCrop((9, 13)), _HWC),
    ("pad_chw", lambda T: T.Pad(3), _CHW),
    ("pad_hwc", lambda T: T.Pad(2), _HWC),
    ("grayscale", lambda T: T.Grayscale(3), _CHW),
    ("compose", lambda T: T.Compose([T.ToTensor(), T.CenterCrop(16),
                                     T.Normalize([0.5] * 3, [0.5] * 3)]),
     _U8),
])
def test_deterministic_class_transforms(name, make, img):
    j, t = _both(make, img)
    _same(j, t)


# ---------------------------------------------------------------------------
# the random class transforms, under one numpy seed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,make,img", [
    ("random_crop", lambda T: T.RandomCrop(12), _CHW),
    ("random_crop_pad_hwc", lambda T: T.RandomCrop((16, 18), padding=2),
     _HWC),
    ("random_resized_crop", lambda T: T.RandomResizedCrop(16), _CHW),
    ("random_resized_crop_hwc", lambda T: T.RandomResizedCrop((12, 20)),
     _U8),
    ("hflip_chw", lambda T: T.RandomHorizontalFlip(0.5), _CHW),
    ("hflip_hwc", lambda T: T.RandomHorizontalFlip(0.5), _HWC),
    ("vflip", lambda T: T.RandomVerticalFlip(0.5), _CHW),
    ("brightness", lambda T: T.BrightnessTransform(0.4), _CHW),
    ("contrast", lambda T: T.ContrastTransform(0.4), _HWC),
    ("saturation", lambda T: T.SaturationTransform(0.4), _CHW),
    ("hue", lambda T: T.HueTransform(0.3), _CHW),
    ("color_jitter", lambda T: T.ColorJitter(0.4, 0.4, 0.4, 0.2), _U8),
    ("rotation", lambda T: T.RandomRotation(30), _CHW),
    ("affine", lambda T: T.RandomAffine(20, translate=(0.1, 0.2),
                                        scale=(0.8, 1.2), shear=10), _HWC),
    ("perspective", lambda T: T.RandomPerspective(1.0, 0.4), _CHW),
    ("erasing", lambda T: T.RandomErasing(1.0), _CHW),
    ("erasing_random", lambda T: T.RandomErasing(1.0, value="random"),
     _CHW),
    ("imagenet_train", lambda T: T.Compose([
        T.RandomResizedCrop(16), T.RandomHorizontalFlip(), T.ToTensor(),
        T.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])]), _U8),
])
@pytest.mark.parametrize("seed", [0, 3])
def test_random_class_transforms_draw_alike(name, make, img, seed):
    j, t = _both(make, img, seed=seed)
    tol = TOL
    if "resized" in name or "imagenet" in name:
        tol = dict(rtol=1e-5, atol=1e-5 * float(np.abs(_np(j)).max()))
    _same(j, t, **tol)
    # both consumed the same draws
    np.random.seed(seed)
    make(jT)(np.array(img))
    after_j = np.random.rand()
    np.random.seed(seed)
    make(tT)(np.array(img))
    assert np.random.rand() == after_j


def test_random_resized_crop_falls_back_to_the_whole_image():
    """Ten failed tries (an aspect ratio no crop of the image can have):
    the whole image is resized, not a centre crop."""
    img = _img((3, 30, 40), scale=255.0)
    j, t = _both(lambda T: T.RandomResizedCrop(8, scale=(0.9, 1.0),
                                               ratio=(50.0, 60.0)), img,
                 seed=0)
    _same(j, t, rtol=1e-5, atol=1e-5 * 255)
    _same(tT.Resize(8)(img), t)


# ---------------------------------------------------------------------------
# the functional transforms
# ---------------------------------------------------------------------------
_PTS = ([[0, 0], [23, 0], [23, 19], [0, 19]],
        [[2, 1], [21, 3], [22, 18], [1, 17]])


@pytest.mark.parametrize("name,call,img", [
    ("resize", lambda F: F.resize(_CHW, (10, 30)), None),
    ("crop", lambda F: F.crop(_HWC, 2, 3, 10, 12), None),
    ("center_crop", lambda F: F.center_crop(_CHW, 8), None),
    ("hflip", lambda F: F.hflip(_CHW), None),
    ("hflip_hwc", lambda F: F.hflip(_HWC), None),
    ("vflip", lambda F: F.vflip(_HWC), None),
    ("pad", lambda F: F.pad(_CHW, 2), None),
    ("adjust_brightness", lambda F: F.adjust_brightness(_CHW, 1.3), None),
    ("adjust_contrast", lambda F: F.adjust_contrast(_HWC, 0.7), None),
    ("adjust_hue", lambda F: F.adjust_hue(_CHW, 0.2), None),
    ("rotate", lambda F: F.rotate(_CHW, 25), None),
    ("affine", lambda F: F.affine(_HWC, 10, (2, -1), 1.1, 5), None),
    ("perspective", lambda F: F.perspective(_CHW, *_PTS), None),
    ("to_grayscale", lambda F: F.to_grayscale(_HWC, 1), None),
    ("erase", lambda F: F.erase(_CHW, 2, 3, 5, 6, 0.5), None),
    ("erase_hwc", lambda F: F.erase(_HWC, 1, 1, 4, 4, 0.0), None),
    ("normalize", lambda F: F.normalize(_CHW, [0.5] * 3, [0.2] * 3), None),
    ("normalize_hwc", lambda F: F.normalize(_HWC, [0.5] * 3, [0.2] * 3,
                                            "HWC"), None),
])
def test_functional_transforms(name, call, img):
    j, t = call(jT), call(tT)
    tol = TOL
    if name == "resize":
        tol = dict(rtol=1e-5, atol=1e-5)
    _same(j, t, **tol)


def test_functional_to_tensor_and_erase_on_tensors():
    j, t = jT.to_tensor(_U8), tT.to_tensor(_U8)
    assert isinstance(t, tpaddle.Tensor)
    assert str(t._data.device) == "cpu"
    _same(j, t)
    dark = (_U8 // 16).astype(np.uint8)     # scaled by dtype, not value
    _same(jT.to_tensor(dark), tT.to_tensor(dark))
    _same(jT.to_tensor(_img((5, 6), dtype=np.uint8, scale=255.0), "HWC"),
          tT.to_tensor(_img((5, 6), dtype=np.uint8, scale=255.0), "HWC"))
    je = jT.erase(jpaddle.to_tensor(_CHW), 1, 2, 3, 4, 0.25)
    te = tT.erase(tpaddle.to_tensor(_CHW), 1, 2, 3, 4, 0.25)
    assert isinstance(te, tpaddle.Tensor)
    _same(je, te)


def test_base_transform_routes_keys():
    def make(T):
        class Scale(T.BaseTransform):
            def _apply_image(self, image):
                return np.asarray(image) * 2.0

        return Scale(keys=("image", "label"))

    for T in (jT, tT):
        out = make(T)((np.ones(3), 7))
        assert out[1] == 7 and np.array_equal(out[0], np.full(3, 2.0))
        assert np.array_equal(make(T)(np.ones(2)), np.full(2, 2.0))
        with pytest.raises(NotImplementedError):
            T.BaseTransform()(np.ones(2))


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------
def _add(tf, name, payload):
    info = tarfile.TarInfo(name)
    info.size = len(payload)
    tf.addfile(info, _io.BytesIO(payload))


def _cifar_tar(path, cifar100=False):
    rng = np.random.RandomState(5)
    with tarfile.open(path, "w:gz") as tf:
        if cifar100:
            for split, n in (("train", 6), ("test", 4)):
                _add(tf, f"cifar-100-python/{split}", pickle.dumps({
                    b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                    b"fine_labels": rng.randint(0, 100, n).tolist()}))
        else:
            for name, n in (("data_batch_2", 5), ("data_batch_1", 4),
                            ("test_batch", 3)):
                _add(tf, f"cifar-10-batches-py/{name}", pickle.dumps({
                    b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                    b"labels": rng.randint(0, 10, n).tolist()}))


def _mnist_files(root):
    rng = np.random.RandomState(6)
    imgs = rng.randint(0, 256, (7, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 7).astype(np.uint8)
    ip, lp = os.path.join(root, "img.gz"), os.path.join(root, "lab.gz")
    with gzip.open(ip, "wb") as f:
        f.write(b"\0" * 16 + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(b"\0" * 8 + labels.tobytes())
    return ip, lp


def _same_dataset(a, b, n=None):
    assert len(a) == len(b)
    for i in range(len(a) if n is None else n):
        xa, xb = a[i], b[i]
        assert len(xa) == len(xb)
        for ea, eb in zip(xa, xb):
            ea, eb = np.asarray(ea), np.asarray(eb)
            assert ea.dtype == eb.dtype and ea.shape == eb.shape
            np.testing.assert_array_equal(eb, ea)


@pytest.mark.parametrize("cls,cifar100", [("Cifar10", False),
                                          ("Cifar100", True)])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_cifar_parses_the_tar(tmp_path, cls, cifar100, mode):
    path = str(tmp_path / "c.tar.gz")
    _cifar_tar(path, cifar100)
    j = getattr(jds, cls)(data_file=path, mode=mode)
    t = getattr(tds, cls)(data_file=path, mode=mode)
    assert len(t) == {(False, "train"): 9, (False, "test"): 3,
                      (True, "train"): 6, (True, "test"): 4}[cifar100, mode]
    assert t.data.dtype == np.float32 and t.labels.dtype == np.int64
    _same_dataset(j, t)


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
def test_mnist_parses_the_idx_gzip(tmp_path, cls):
    ip, lp = _mnist_files(str(tmp_path))
    tf = tT.Normalize([0.5], [0.5])
    j = getattr(jds, cls)(image_path=ip, label_path=lp,
                          transform=jT.Normalize([0.5], [0.5]))
    t = getattr(tds, cls)(image_path=ip, label_path=lp, transform=tf)
    assert len(t) == 7 and t.data.shape == (7, 1, 28, 28)
    _same_dataset(j, t)


@pytest.mark.parametrize("make", [
    lambda D, d: D.Cifar10(data_file=os.path.join(d, "none"), mode="test"),
    lambda D, d: D.Cifar100(data_file=os.path.join(d, "none")),
    lambda D, d: D.MNIST(image_path=os.path.join(d, "none"), mode="test"),
    lambda D, d: D.FashionMNIST(mode="train"),
    lambda D, d: D.Flowers(data_file=os.path.join(d, "none"), mode="test"),
    lambda D, d: D.VOC2012(data_file=os.path.join(d, "none")),
    lambda D, d: D.RandomImageDataset(6, shape=(3, 8, 8), num_classes=5,
                                      seed=3),
], ids=["cifar10", "cifar100", "mnist", "fashion", "flowers", "voc",
        "random"])
def test_synthetic_modes_are_bit_for_bit(tmp_path, make):
    j, t = make(jds, str(tmp_path)), make(tds, str(tmp_path))
    _same_dataset(j, t, n=min(len(t), 6))
    for name in ("data", "labels", "images", "masks"):
        if hasattr(j, name) and getattr(j, name) is not None:
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


def _image_folder(root, n_classes=3, per_class=3, seed=0):
    rng = np.random.RandomState(seed)
    for c in range(n_classes):
        d = os.path.join(root, f"class_{c}")
        os.makedirs(d)
        for i in range(per_class):
            h, w = rng.randint(20, 40, 2)
            np.save(os.path.join(d, f"{i}.npy"),
                    rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        with open(os.path.join(d, "notes.txt"), "w") as f:
            f.write("not an image")
    os.makedirs(os.path.join(root, "empty"))


@pytest.mark.parametrize("cls", ["ImageFolder", "DatasetFolder"])
def test_image_folder_of_npy_images(tmp_path, cls):
    _image_folder(str(tmp_path))
    make = lambda T: T.Compose([  # noqa: E731
        T.RandomResizedCrop(16), T.RandomHorizontalFlip(), T.ToTensor(),
        T.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])])
    j = getattr(jds, cls)(str(tmp_path), transform=make(jT))
    t = getattr(tds, cls)(str(tmp_path), transform=make(tT))
    assert t.class_to_idx == j.class_to_idx == {
        "class_0": 0, "class_1": 1, "class_2": 2, "empty": 3}
    assert [(os.path.basename(p), c) for p, c in t.samples] == \
        [(os.path.basename(p), c) for p, c in j.samples]
    assert len(t) == 9
    for i in range(len(t)):
        np.random.seed(i)
        xj, yj = j[i]
        np.random.seed(i)
        xt, yt = t[i]
        assert yt == yj and xt.shape == (3, 16, 16)
        np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-4)
    plain = tds.DatasetFolder(str(tmp_path), extensions=(".txt",))
    assert len(plain) == 3


# ---------------------------------------------------------------------------
# the loader's workers and numpy's RNG
# ---------------------------------------------------------------------------
def _one_image_dataset(P, T):
    """Eight copies of one image behind a random crop and flip."""
    img = np.arange(3 * 12 * 12, dtype=np.float32).reshape(3, 12, 12)
    tf = T.Compose([T.RandomCrop(8), T.RandomHorizontalFlip()])

    class Same(P.io.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return tf(img), np.int64(i)

    return Same()


def _seed_worker(wid):
    np.random.seed(1000 + wid)


def _batches(P, T, init=None):
    kw = {"places": "cpu"} if P is tpaddle else {}
    loader = P.io.DataLoader(_one_image_dataset(P, T), batch_size=2,
                             shuffle=False, num_workers=2,
                             use_shared_memory=False, worker_init_fn=init,
                             **kw)
    np.random.seed(0)
    return [(_np(x), _np(y)) for x, y in loader]


def test_loader_workers_share_numpy_rng_as_in_the_reference():
    """Neither package reseeds numpy in a forked worker: at
    ``num_workers=2`` both give the same batches, and worker 1's first
    batch (batch 1) repeats worker 0's first (batch 0)."""
    j, t = _batches(jpaddle, jT), _batches(tpaddle, tT)
    assert len(t) == 4
    for (xj, yj), (xt, yt) in zip(j, t):
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(t[0][0], t[1][0])
    np.testing.assert_array_equal(t[2][0], t[3][0])


def test_worker_init_fn_seeds_each_worker():
    j = _batches(jpaddle, jT, init=_seed_worker)
    t = _batches(tpaddle, tT, init=_seed_worker)
    for (xj, _), (xt, _) in zip(j, t):
        np.testing.assert_array_equal(xt, xj)
    assert not np.array_equal(t[0][0], t[1][0])
