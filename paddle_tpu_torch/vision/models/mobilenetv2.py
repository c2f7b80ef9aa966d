"""MobileNetV2 (port of ``paddle_tpu/vision/models/mobilenetv2.py``;
reference: python/paddle/vision/models/mobilenetv2.py)."""
from __future__ import annotations

from paddle_tpu_torch import nn

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(nn.Sequential):
    def __init__(self, in_ch, out_ch, kernel=3, stride=1, groups=1):
        super().__init__(
            nn.Conv2D(in_ch, out_ch, kernel, stride=stride,
                      padding=(kernel - 1) // 2, groups=groups,
                      bias_attr=False),
            nn.BatchNorm2D(out_ch),
            nn.ReLU6())


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden, kernel=1))
        layers += [
            ConvBNReLU(hidden, hidden, stride=stride, groups=hidden),
            nn.Conv2D(hidden, oup, 1, bias_attr=False),
            nn.BatchNorm2D(oup),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [  # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        in_ch = _make_divisible(32 * scale)
        last_ch = _make_divisible(1280 * max(1.0, scale))
        feats = [ConvBNReLU(3, in_ch, stride=2)]
        for t, c, n, s in cfg:
            out_ch = _make_divisible(c * scale)
            for i in range(n):
                feats.append(InvertedResidual(
                    in_ch, out_ch, s if i == 0 else 1, t))
                in_ch = out_ch
        feats.append(ConvBNReLU(in_ch, last_ch, kernel=1))
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last_ch, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(nn.Flatten()(x))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (zero-egress build)")
    return MobileNetV2(scale=scale, **kwargs)
