"""DenseNet (port of ``paddle_tpu/vision/models/densenet.py``;
reference: python/paddle/vision/models/densenet.py)."""
from __future__ import annotations

from paddle_tpu_torch import nn, ops

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CFGS = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
    264: (64, 32, [6, 12, 64, 48]),
}


class _DenseLayer(nn.Layer):
    def __init__(self, in_ch, growth_rate, bn_size, dropout):
        super().__init__()
        self.norm1 = nn.BatchNorm2D(in_ch)
        self.relu = nn.ReLU()
        self.conv1 = nn.Conv2D(in_ch, bn_size * growth_rate, 1,
                               bias_attr=False)
        self.norm2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return ops.concat([x, out], axis=1)


class _Transition(nn.Sequential):
    def __init__(self, in_ch, out_ch):
        super().__init__(
            nn.BatchNorm2D(in_ch), nn.ReLU(),
            nn.Conv2D(in_ch, out_ch, 1, bias_attr=False),
            nn.AvgPool2D(2, 2))


class DenseNet(nn.Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        init_ch, growth, blocks = _CFGS[layers]
        feats = [nn.Conv2D(3, init_ch, 7, stride=2, padding=3,
                           bias_attr=False),
                 nn.BatchNorm2D(init_ch), nn.ReLU(),
                 nn.MaxPool2D(3, 2, padding=1)]
        ch = init_ch
        for bi, n in enumerate(blocks):
            for _ in range(n):
                feats.append(_DenseLayer(ch, growth, bn_size, dropout))
                ch += growth
            if bi != len(blocks) - 1:
                feats.append(_Transition(ch, ch // 2))
                ch //= 2
        feats += [nn.BatchNorm2D(ch), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(ch, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(nn.Flatten()(x))
        return x


def _densenet(layers, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (zero-egress build)")
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kw):
    return _densenet(121, pretrained, **kw)


def densenet161(pretrained=False, **kw):
    return _densenet(161, pretrained, **kw)


def densenet169(pretrained=False, **kw):
    return _densenet(169, pretrained, **kw)


def densenet201(pretrained=False, **kw):
    return _densenet(201, pretrained, **kw)


def densenet264(pretrained=False, **kw):
    return _densenet(264, pretrained, **kw)
