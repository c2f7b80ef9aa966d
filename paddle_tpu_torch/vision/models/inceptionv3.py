"""Inception v3 (port of ``paddle_tpu/vision/models/inceptionv3.py``;
reference: python/paddle/vision/models/inceptionv3.py)."""
from __future__ import annotations

from paddle_tpu_torch import nn, ops

__all__ = ["InceptionV3", "inception_v3"]


def _cb(in_ch, out_ch, kernel, stride=1, padding=0):
    return nn.Sequential(
        nn.Conv2D(in_ch, out_ch, kernel, stride=stride, padding=padding,
                  bias_attr=False),
        nn.BatchNorm2D(out_ch), nn.ReLU())


class InceptionA(nn.Layer):
    def __init__(self, in_ch, pool_ch):
        super().__init__()
        self.b1 = _cb(in_ch, 64, 1)
        self.b5 = nn.Sequential(_cb(in_ch, 48, 1),
                                _cb(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_cb(in_ch, 64, 1),
                                _cb(64, 96, 3, padding=1),
                                _cb(96, 96, 3, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _cb(in_ch, pool_ch, 1))

    def forward(self, x):
        return ops.concat([self.b1(x), self.b5(x), self.b3(x),
                           self.bp(x)], axis=1)


class InceptionB(nn.Layer):
    def __init__(self, in_ch):
        super().__init__()
        self.b3 = _cb(in_ch, 384, 3, stride=2)
        self.b3d = nn.Sequential(_cb(in_ch, 64, 1),
                                 _cb(64, 96, 3, padding=1),
                                 _cb(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return ops.concat([self.b3(x), self.b3d(x), self.pool(x)], axis=1)


class InceptionC(nn.Layer):
    def __init__(self, in_ch, c7):
        super().__init__()
        self.b1 = _cb(in_ch, 192, 1)
        self.b7 = nn.Sequential(
            _cb(in_ch, c7, 1), _cb(c7, c7, (1, 7), padding=(0, 3)),
            _cb(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = nn.Sequential(
            _cb(in_ch, c7, 1), _cb(c7, c7, (7, 1), padding=(3, 0)),
            _cb(c7, c7, (1, 7), padding=(0, 3)),
            _cb(c7, c7, (7, 1), padding=(3, 0)),
            _cb(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _cb(in_ch, 192, 1))

    def forward(self, x):
        return ops.concat([self.b1(x), self.b7(x), self.b7d(x),
                           self.bp(x)], axis=1)


class InceptionD(nn.Layer):
    def __init__(self, in_ch):
        super().__init__()
        self.b3 = nn.Sequential(_cb(in_ch, 192, 1),
                                _cb(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(
            _cb(in_ch, 192, 1), _cb(192, 192, (1, 7), padding=(0, 3)),
            _cb(192, 192, (7, 1), padding=(3, 0)),
            _cb(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return ops.concat([self.b3(x), self.b7(x), self.pool(x)], axis=1)


class InceptionE(nn.Layer):
    def __init__(self, in_ch):
        super().__init__()
        self.b1 = _cb(in_ch, 320, 1)
        self.b3_stem = _cb(in_ch, 384, 1)
        self.b3_a = _cb(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _cb(384, 384, (3, 1), padding=(1, 0))
        self.bd_stem = nn.Sequential(_cb(in_ch, 448, 1),
                                     _cb(448, 384, 3, padding=1))
        self.bd_a = _cb(384, 384, (1, 3), padding=(0, 1))
        self.bd_b = _cb(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _cb(in_ch, 192, 1))

    def forward(self, x):
        s = self.b3_stem(x)
        d = self.bd_stem(x)
        return ops.concat([
            self.b1(x),
            ops.concat([self.b3_a(s), self.b3_b(s)], axis=1),
            ops.concat([self.bd_a(d), self.bd_b(d)], axis=1),
            self.bp(x)], axis=1)


class InceptionV3(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _cb(3, 32, 3, stride=2), _cb(32, 32, 3),
            _cb(32, 64, 3, padding=1), nn.MaxPool2D(3, 2),
            _cb(64, 80, 1), _cb(80, 192, 3), nn.MaxPool2D(3, 2))
        self.blocks = nn.Sequential(
            InceptionA(192, 32), InceptionA(256, 64), InceptionA(288, 64),
            InceptionB(288),
            InceptionC(768, 128), InceptionC(768, 160),
            InceptionC(768, 160), InceptionC(768, 192),
            InceptionD(768),
            InceptionE(1280), InceptionE(2048))
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(nn.Flatten()(x)))
        return x


def inception_v3(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (zero-egress build)")
    return InceptionV3(**kwargs)
