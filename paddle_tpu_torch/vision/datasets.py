"""Vision datasets (port of ``paddle_tpu/vision/datasets.py``;
reference: python/paddle/vision/datasets/).

The image has no network egress, so the download-backed datasets
(CIFAR/MNIST/...) also provide a deterministic synthetic mode
(``backend='synthetic'`` or when files are absent) generating class-
conditional data — enough for pipeline/throughput work and tests; real
files are used when present at the standard paths.
"""
from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from paddle_tpu_torch.io import Dataset

__all__ = ["Flowers", "VOC2012", "Cifar10", "Cifar100", "MNIST", "FashionMNIST", "DatasetFolder",
           "ImageFolder", "RandomImageDataset"]


class _SyntheticImageMixin:
    def _make_synthetic(self, n, shape, num_classes, seed=0):
        rng = np.random.RandomState(seed)
        labels = rng.randint(0, num_classes, size=n).astype(np.int64)
        # class-conditional means so models can actually learn
        means = rng.uniform(-0.5, 0.5, size=(num_classes,) + shape)
        data = (means[labels] +
                rng.normal(0, 0.25, size=(n,) + shape)).astype(np.float32)
        return data, labels


class Cifar10(Dataset, _SyntheticImageMixin):
    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        self.backend = backend or "numpy"
        n = 50000 if mode == "train" else 10000
        path = data_file or os.path.expanduser(
            "~/.cache/paddle/dataset/cifar/cifar-10-python.tar.gz")
        if os.path.exists(path):
            self.data, self.labels = self._load_real(path, mode)
        else:
            n_synth = min(n, 10000)
            self.data, self.labels = self._make_synthetic(
                n_synth, (3, 32, 32), self.NUM_CLASSES,
                seed=0 if mode == "train" else 1)

    def _load_real(self, path, mode):
        datas, labels = [], []
        with tarfile.open(path, "r:gz") as tf:
            # CIFAR-10 members: data_batch_1..5 / test_batch;
            # CIFAR-100 members: train / test
            if mode == "train":
                names = [m for m in tf.getmembers()
                         if "data_batch" in m.name
                         or m.name.endswith("/train")]
            else:
                names = [m for m in tf.getmembers()
                         if "test_batch" in m.name
                         or m.name.endswith("/test")]
            for m in sorted(names, key=lambda m: m.name):
                batch = pickle.load(tf.extractfile(m), encoding="bytes")
                datas.append(batch[b"data"].reshape(-1, 3, 32, 32))
                labels.extend(batch.get(b"labels", batch.get(b"fine_labels")))
        data = (np.concatenate(datas).astype(np.float32) / 255.0)
        return data, np.asarray(labels, dtype=np.int64)

    def __getitem__(self, idx):
        img, label = self.data[idx], self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    NUM_CLASSES = 100

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        data_file = data_file or os.path.expanduser(
            "~/.cache/paddle/dataset/cifar/cifar-100-python.tar.gz")
        super().__init__(data_file, mode, transform, download, backend)


class MNIST(Dataset, _SyntheticImageMixin):
    NUM_CLASSES = 10
    SHAPE = (1, 28, 28)

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.transform = transform
        n = 60000 if mode == "train" else 10000
        if image_path and os.path.exists(image_path):
            self.data, self.labels = self._load_idx(image_path, label_path)
        else:
            self.data, self.labels = self._make_synthetic(
                min(n, 10000), self.SHAPE, self.NUM_CLASSES,
                seed=2 if mode == "train" else 3)

    def _load_idx(self, image_path, label_path):
        import gzip

        with gzip.open(image_path, "rb") as f:
            f.read(16)
            data = np.frombuffer(f.read(), dtype=np.uint8)
        data = data.reshape(-1, 1, 28, 28).astype(np.float32) / 255.0
        with gzip.open(label_path, "rb") as f:
            f.read(8)
            labels = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int64)
        return data, labels

    def __getitem__(self, idx):
        img, label = self.data[idx], self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.data)


class FashionMNIST(MNIST):
    pass


class RandomImageDataset(Dataset):
    """Pure-random benchmark dataset."""

    def __init__(self, num_samples, shape=(3, 224, 224), num_classes=1000,
                 seed=0):
        self.num_samples = num_samples
        self.shape = shape
        self.num_classes = num_classes
        self.seed = seed

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        img = rng.normal(0, 1, self.shape).astype(np.float32)
        label = np.int64(rng.randint(self.num_classes))
        return img, label

    def __len__(self):
        return self.num_samples


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or _default_loader
        extensions = extensions or (".png", ".jpg", ".jpeg", ".bmp", ".npy")
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(extensions):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    pass


def _default_loader(path):
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image

        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    except ImportError:
        raise RuntimeError("PIL unavailable; use .npy images")


class Flowers(Dataset, _SyntheticImageMixin):
    """Oxford-102 flowers (reference vision/datasets/flowers.py): real
    archives when present (102flowers.tgz + imagelabels.mat +
    setid.mat, parsed via Pillow/scipy), synthetic class-conditional
    images otherwise."""

    NUM_CLASSES = 102

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True,
                 backend=None):
        self.mode = mode
        self.transform = transform
        root = os.path.expanduser("~/.cache/paddle/dataset/flowers")
        data_file = data_file or os.path.join(root, "102flowers.tgz")
        label_file = label_file or os.path.join(root, "imagelabels.mat")
        setid_file = setid_file or os.path.join(root, "setid.mat")
        if all(os.path.exists(p) for p in
               (data_file, label_file, setid_file)):
            self._load_real(data_file, label_file, setid_file, mode)
        else:
            n = 1020 if mode == "train" else 512
            self.data, self.labels = self._make_synthetic(
                n, (3, 64, 64), self.NUM_CLASSES,
                seed=0 if mode == "train" else 1)
            self._images = None

    def _load_real(self, data_file, label_file, setid_file, mode):
        from scipy.io import loadmat

        labels = loadmat(label_file)["labels"][0]
        setid = loadmat(setid_file)
        key = {"train": "trnid", "valid": "valid", "test": "tstid"}[mode]
        ids = setid[key][0]
        self._tar_path = data_file
        self._tar = None       # opened lazily, per process (fork-safe)
        self._tar_pid = None
        self._ids = ids
        self.labels = (labels[ids - 1] - 1).astype(np.int64)
        self.data = None
        self._images = {}

    def _get_tar(self):
        # DataLoader workers fork: a shared tarfile handle has a shared
        # file offset, so concurrent reads interleave — every process
        # opens its own handle. (r:gz re-decompresses per member; fine
        # for preprocessing, use DatasetFolder for hot loops.)
        if self._tar is None or self._tar_pid != os.getpid():
            self._tar = tarfile.open(self._tar_path, "r:gz")
            self._tar_pid = os.getpid()
        return self._tar

    def __getitem__(self, i):
        if self.data is not None:
            img, label = self.data[i], self.labels[i]
        else:
            from PIL import Image

            idx = int(self._ids[i])
            name = f"jpg/image_{idx:05d}.jpg"
            f = self._get_tar().extractfile(name)
            img = np.asarray(Image.open(f).convert("RGB"),
                             np.float32).transpose(2, 0, 1) / 255.0
            label = self.labels[i]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.labels)


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation pairs (reference
    vision/datasets/voc2012.py): (image, label-mask) tuples from the
    devkit tar when present, synthetic blob masks otherwise."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        data_file = data_file or os.path.expanduser(
            "~/.cache/paddle/dataset/voc2012/VOCtrainval_11-May-2012.tar")
        if os.path.exists(data_file):
            self._load_real(data_file, mode)
        else:
            rng = np.random.RandomState(0 if mode == "train" else 1)
            n = 64
            self.images = rng.uniform(
                0, 1, size=(n, 3, 64, 64)).astype(np.float32)
            masks = np.zeros((n, 64, 64), np.int64)
            for i in range(n):
                cy, cx = rng.randint(8, 56, 2)
                cls = rng.randint(1, 21)
                masks[i, cy - 8:cy + 8, cx - 8:cx + 8] = cls
            self.masks = masks
            self._tar = None

    def _load_real(self, data_file, mode):
        from PIL import Image  # noqa: F401 (needed at getitem)

        self._tar_path = data_file
        self._tar_pid = None
        self._tar = tarfile.open(data_file, "r")
        self._tar_pid = os.getpid()
        base = "VOCdevkit/VOC2012"
        split = {"train": "train", "valid": "val",
                 "test": "trainval"}[mode]
        lst = self._tar.extractfile(
            f"{base}/ImageSets/Segmentation/{split}.txt")
        self._names = [ln.strip().decode() for ln in lst.readlines()]
        self._base = base

    def _get_tar(self):
        if self._tar is None or self._tar_pid != os.getpid():
            self._tar = tarfile.open(self._tar_path, "r")
            self._tar_pid = os.getpid()
        return self._tar

    def __getitem__(self, i):
        if self._tar is None:
            img, mask = self.images[i], self.masks[i]
        else:
            from PIL import Image

            name = self._names[i]
            tar = self._get_tar()
            img = np.asarray(Image.open(tar.extractfile(
                f"{self._base}/JPEGImages/{name}.jpg")).convert("RGB"),
                np.float32).transpose(2, 0, 1) / 255.0
            mask = np.asarray(Image.open(tar.extractfile(
                f"{self._base}/SegmentationClass/{name}.png")),
                np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, mask

    def __len__(self):
        return len(self.masks) if self._tar is None else len(self._names)
