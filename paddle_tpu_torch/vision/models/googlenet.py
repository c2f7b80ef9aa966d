"""GoogLeNet / Inception v1 (port of
``paddle_tpu/vision/models/googlenet.py``; reference:
python/paddle/vision/models/googlenet.py). Returns (main, aux1, aux2)
logits in train mode like the reference."""
from __future__ import annotations

from paddle_tpu_torch import nn, ops

__all__ = ["GoogLeNet", "googlenet"]


def _conv_relu(in_ch, out_ch, kernel, stride=1, padding=0):
    return nn.Sequential(
        nn.Conv2D(in_ch, out_ch, kernel, stride=stride, padding=padding),
        nn.ReLU())


class Inception(nn.Layer):
    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.branch1 = _conv_relu(in_ch, c1, 1)
        self.branch2 = nn.Sequential(_conv_relu(in_ch, c3r, 1),
                                     _conv_relu(c3r, c3, 3, padding=1))
        self.branch3 = nn.Sequential(_conv_relu(in_ch, c5r, 1),
                                     _conv_relu(c5r, c5, 5, padding=2))
        self.branch4 = nn.Sequential(nn.MaxPool2D(3, 1, padding=1),
                                     _conv_relu(in_ch, proj, 1))

    def forward(self, x):
        return ops.concat([self.branch1(x), self.branch2(x),
                           self.branch3(x), self.branch4(x)], axis=1)


class _AuxHead(nn.Layer):
    def __init__(self, in_ch, num_classes):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(4)
        self.conv = _conv_relu(in_ch, 128, 1)
        self.fc1 = nn.Linear(128 * 16, 1024)
        self.relu = nn.ReLU()
        self.drop = nn.Dropout(0.7)
        self.fc2 = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.conv(self.pool(x))
        x = self.relu(self.fc1(nn.Flatten()(x)))
        return self.fc2(self.drop(x))


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _conv_relu(3, 64, 7, stride=2, padding=3),
            nn.MaxPool2D(3, 2, padding=1),
            _conv_relu(64, 64, 1),
            _conv_relu(64, 192, 3, padding=1),
            nn.MaxPool2D(3, 2, padding=1))
        self.inc3a = Inception(192, 64, 96, 128, 16, 32, 32)
        self.inc3b = Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, 2, padding=1)
        self.inc4a = Inception(480, 192, 96, 208, 16, 48, 64)
        self.inc4b = Inception(512, 160, 112, 224, 24, 64, 64)
        self.inc4c = Inception(512, 128, 128, 256, 24, 64, 64)
        self.inc4d = Inception(512, 112, 144, 288, 32, 64, 64)
        self.inc4e = Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, 2, padding=1)
        self.inc5a = Inception(832, 256, 160, 320, 32, 128, 128)
        self.inc5b = Inception(832, 384, 192, 384, 48, 128, 128)
        if num_classes > 0:
            self.aux1 = _AuxHead(512, num_classes)
            self.aux2 = _AuxHead(528, num_classes)
            self.pool = nn.AdaptiveAvgPool2D(1)
            self.drop = nn.Dropout(0.4)
            self.fc = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.inc3b(self.inc3a(x)))
        x = self.inc4a(x)
        aux1 = self.aux1(x) if self.num_classes > 0 and self.training \
            else None
        x = self.inc4d(self.inc4c(self.inc4b(x)))
        aux2 = self.aux2(x) if self.num_classes > 0 and self.training \
            else None
        x = self.pool4(self.inc4e(x))
        x = self.inc5b(self.inc5a(x))
        if self.num_classes > 0:
            x = self.fc(self.drop(nn.Flatten()(self.pool(x))))
            if self.training:
                return x, aux1, aux2
        return x


def googlenet(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (zero-egress build)")
    return GoogLeNet(**kwargs)
