"""Model zoo (port of ``paddle_tpu/vision/models/``; reference:
python/paddle/vision/models/): twelve families."""
from paddle_tpu_torch.vision.models.resnet import (  # noqa: F401
    ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
    wide_resnet50_2, wide_resnet101_2,
    resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
    resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
)
from paddle_tpu_torch.vision.models.lenet import LeNet  # noqa: F401
from paddle_tpu_torch.vision.models.alexnet import AlexNet, alexnet  # noqa: F401
from paddle_tpu_torch.vision.models.vgg import (  # noqa: F401
    VGG, vgg11, vgg13, vgg16, vgg19,
)
from paddle_tpu_torch.vision.models.mobilenetv1 import (  # noqa: F401
    MobileNetV1, mobilenet_v1,
)
from paddle_tpu_torch.vision.models.mobilenetv2 import (  # noqa: F401
    MobileNetV2, mobilenet_v2,
)
from paddle_tpu_torch.vision.models.mobilenetv3 import (  # noqa: F401
    MobileNetV3Large, MobileNetV3Small, mobilenet_v3_large,
    mobilenet_v3_small,
)
from paddle_tpu_torch.vision.models.squeezenet import (  # noqa: F401
    SqueezeNet, squeezenet1_0, squeezenet1_1,
)
from paddle_tpu_torch.vision.models.shufflenetv2 import (  # noqa: F401
    ShuffleNetV2, shufflenet_v2_swish, shufflenet_v2_x0_25,
    shufflenet_v2_x0_33, shufflenet_v2_x0_5, shufflenet_v2_x1_0,
    shufflenet_v2_x1_5, shufflenet_v2_x2_0,
)
from paddle_tpu_torch.vision.models.densenet import (  # noqa: F401
    DenseNet, densenet121, densenet161, densenet169, densenet201,
    densenet264,
)
from paddle_tpu_torch.vision.models.googlenet import GoogLeNet, googlenet  # noqa: F401
from paddle_tpu_torch.vision.models.inceptionv3 import (  # noqa: F401
    InceptionV3, inception_v3,
)
