"""ShuffleNetV2 (port of ``paddle_tpu/vision/models/shufflenetv2.py``;
reference: python/paddle/vision/models/shufflenetv2.py)."""
from __future__ import annotations

from paddle_tpu_torch import nn, ops

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
           "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
           "shufflenet_v2_swish"]


def channel_shuffle(x, groups):
    b, c, h, w = x.shape
    x = ops.reshape(x, [b, groups, c // groups, h, w])
    x = ops.transpose(x, [0, 2, 1, 3, 4])
    return ops.reshape(x, [b, c, h, w])


def _conv_bn(in_ch, out_ch, kernel, stride=1, groups=1, act=nn.ReLU):
    layers = [nn.Conv2D(in_ch, out_ch, kernel, stride=stride,
                        padding=kernel // 2, groups=groups,
                        bias_attr=False),
              nn.BatchNorm2D(out_ch)]
    if act is not None:
        layers.append(act())
    return nn.Sequential(*layers)


class InvertedResidual(nn.Layer):
    def __init__(self, in_ch, out_ch, stride, act=nn.ReLU):
        super().__init__()
        self.stride = stride
        branch = out_ch // 2
        if stride == 1:
            self.branch2 = nn.Sequential(
                _conv_bn(branch, branch, 1, act=act),
                _conv_bn(branch, branch, 3, stride=1, groups=branch,
                         act=None),
                _conv_bn(branch, branch, 1, act=act))
        else:
            self.branch1 = nn.Sequential(
                _conv_bn(in_ch, in_ch, 3, stride=stride, groups=in_ch,
                         act=None),
                _conv_bn(in_ch, branch, 1, act=act))
            self.branch2 = nn.Sequential(
                _conv_bn(in_ch, branch, 1, act=act),
                _conv_bn(branch, branch, 3, stride=stride, groups=branch,
                         act=None),
                _conv_bn(branch, branch, 1, act=act))

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            x1 = x[:, :c]
            x2 = x[:, c:]
            out = ops.concat([x1, self.branch2(x2)], axis=1)
        else:
            out = ops.concat([self.branch1(x), self.branch2(x)], axis=1)
        return channel_shuffle(out, 2)


_STAGE_OUT = {
    0.25: [24, 24, 48, 96, 512], 0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024], 1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024], 2.0: [24, 244, 488, 976, 2048],
}


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        act_layer = nn.ReLU if act == "relu" else nn.Swish
        chs = _STAGE_OUT[scale]
        self.conv1 = _conv_bn(3, chs[0], 3, stride=2, act=act_layer)
        self.max_pool = nn.MaxPool2D(3, stride=2, padding=1)
        stages = []
        in_ch = chs[0]
        for i, repeat in enumerate([4, 8, 4]):
            out_ch = chs[i + 1]
            seq = [InvertedResidual(in_ch, out_ch, 2, act_layer)]
            seq += [InvertedResidual(out_ch, out_ch, 1, act_layer)
                    for _ in range(repeat - 1)]
            stages.append(nn.Sequential(*seq))
            in_ch = out_ch
        self.stages = nn.Sequential(*stages)
        self.conv_last = _conv_bn(in_ch, chs[4], 1, act=act_layer)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(chs[4], num_classes)

    def forward(self, x):
        x = self.conv_last(self.stages(self.max_pool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(nn.Flatten()(x))
        return x


def _shufflenet(scale, act="relu", pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (zero-egress build)")
    return ShuffleNetV2(scale=scale, act=act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return _shufflenet(0.25, pretrained=pretrained, **kw)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    return _shufflenet(0.33, pretrained=pretrained, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return _shufflenet(0.5, pretrained=pretrained, **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return _shufflenet(1.0, pretrained=pretrained, **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return _shufflenet(1.5, pretrained=pretrained, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return _shufflenet(2.0, pretrained=pretrained, **kw)


def shufflenet_v2_swish(pretrained=False, **kw):
    return _shufflenet(1.0, act="swish", pretrained=pretrained, **kw)
