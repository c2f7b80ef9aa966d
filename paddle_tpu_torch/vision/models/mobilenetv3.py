"""MobileNetV3 (port of ``paddle_tpu/vision/models/mobilenetv3.py``;
reference: python/paddle/vision/models/mobilenetv3.py)."""
from __future__ import annotations

from paddle_tpu_torch import nn

__all__ = ["MobileNetV3Small", "MobileNetV3Large",
           "mobilenet_v3_small", "mobilenet_v3_large"]


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SqueezeExcitation(nn.Layer):
    def __init__(self, ch, squeeze_ch):
        super().__init__()
        self.avgpool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(ch, squeeze_ch, 1)
        self.relu = nn.ReLU()
        self.fc2 = nn.Conv2D(squeeze_ch, ch, 1)
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.avgpool(x)))))
        return x * s


class ConvBNAct(nn.Sequential):
    def __init__(self, in_ch, out_ch, kernel=3, stride=1, groups=1,
                 act=nn.Hardswish):
        layers = [
            nn.Conv2D(in_ch, out_ch, kernel, stride=stride,
                      padding=(kernel - 1) // 2, groups=groups,
                      bias_attr=False),
            nn.BatchNorm2D(out_ch),
        ]
        if act is not None:
            layers.append(act())
        super().__init__(*layers)


class InvertedResidual(nn.Layer):
    def __init__(self, in_ch, exp_ch, out_ch, kernel, stride, use_se,
                 act):
        super().__init__()
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        if exp_ch != in_ch:
            layers.append(ConvBNAct(in_ch, exp_ch, kernel=1, act=act))
        layers.append(ConvBNAct(exp_ch, exp_ch, kernel=kernel,
                                stride=stride, groups=exp_ch, act=act))
        if use_se:
            layers.append(SqueezeExcitation(
                exp_ch, _make_divisible(exp_ch // 4)))
        layers.append(ConvBNAct(exp_ch, out_ch, kernel=1, act=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_RE = nn.ReLU
_HS = nn.Hardswish

# kernel, exp, out, use_se, act, stride
_LARGE = [
    (3, 16, 16, False, _RE, 1), (3, 64, 24, False, _RE, 2),
    (3, 72, 24, False, _RE, 1), (5, 72, 40, True, _RE, 2),
    (5, 120, 40, True, _RE, 1), (5, 120, 40, True, _RE, 1),
    (3, 240, 80, False, _HS, 2), (3, 200, 80, False, _HS, 1),
    (3, 184, 80, False, _HS, 1), (3, 184, 80, False, _HS, 1),
    (3, 480, 112, True, _HS, 1), (3, 672, 112, True, _HS, 1),
    (5, 672, 160, True, _HS, 2), (5, 960, 160, True, _HS, 1),
    (5, 960, 160, True, _HS, 1),
]
_SMALL = [
    (3, 16, 16, True, _RE, 2), (3, 72, 24, False, _RE, 2),
    (3, 88, 24, False, _RE, 1), (5, 96, 40, True, _HS, 2),
    (5, 240, 40, True, _HS, 1), (5, 240, 40, True, _HS, 1),
    (5, 120, 48, True, _HS, 1), (5, 144, 48, True, _HS, 1),
    (5, 288, 96, True, _HS, 2), (5, 576, 96, True, _HS, 1),
    (5, 576, 96, True, _HS, 1),
]


class _MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_exp, scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        s = lambda c: _make_divisible(c * scale)
        in_ch = s(16)
        feats = [ConvBNAct(3, in_ch, stride=2)]
        for k, exp, out, se, act, st in cfg:
            feats.append(InvertedResidual(in_ch, s(exp), s(out), k, st,
                                          se, act))
            in_ch = s(out)
        last_ch = s(last_exp)
        feats.append(ConvBNAct(in_ch, last_ch, kernel=1))
        self.features = nn.Sequential(*feats)
        head_ch = 1280 if last_exp == 960 else 1024
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(last_ch, head_ch), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(head_ch, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(nn.Flatten()(x))
        return x


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_LARGE, 960, scale, num_classes, with_pool)


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_SMALL, 576, scale, num_classes, with_pool)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (zero-egress build)")
    return MobileNetV3Large(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (zero-egress build)")
    return MobileNetV3Small(scale=scale, **kwargs)
