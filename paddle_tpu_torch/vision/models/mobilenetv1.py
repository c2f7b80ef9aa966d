"""MobileNetV1 (port of ``paddle_tpu/vision/models/mobilenetv1.py``;
reference: python/paddle/vision/models/mobilenetv1.py).
Depthwise-separable convs: the depthwise one is a grouped Conv2D
(groups=ch).
"""
from __future__ import annotations

from paddle_tpu_torch import nn

__all__ = ["MobileNetV1", "mobilenet_v1"]


class ConvBNLayer(nn.Layer):
    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0,
                 groups=1):
        super().__init__()
        self.conv = nn.Conv2D(in_ch, out_ch, kernel, stride=stride,
                              padding=padding, groups=groups,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(out_ch)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_ch, out_ch1, out_ch2, stride, scale):
        super().__init__()
        c1 = int(out_ch1 * scale)
        c2 = int(out_ch2 * scale)
        self.dw = ConvBNLayer(in_ch, c1, 3, stride=stride, padding=1,
                              groups=in_ch)
        self.pw = ConvBNLayer(c1, c2, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        s = lambda c: int(c * scale)
        self.conv1 = ConvBNLayer(3, s(32), 3, stride=2, padding=1)
        cfg = [  # in, out1, out2, stride
            (s(32), 32, 64, 1), (s(64), 64, 128, 2),
            (s(128), 128, 128, 1), (s(128), 128, 256, 2),
            (s(256), 256, 256, 1), (s(256), 256, 512, 2),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1), (s(512), 512, 1024, 2),
            (s(1024), 1024, 1024, 1),
        ]
        self.blocks = nn.Sequential(*[
            DepthwiseSeparable(i, o1, o2, st, scale)
            for i, o1, o2, st in cfg])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(nn.Flatten()(x))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (zero-egress build)")
    return MobileNetV1(scale=scale, **kwargs)
