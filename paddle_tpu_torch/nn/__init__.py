"""paddle_tpu_torch.nn (port of ``paddle_tpu/nn/``): ``Layer`` and its
containers, the common, conv/pool, norm, activation and loss layers, the
initializers, ``nn.utils``, the gradient clips and ``nn.functional``.
``transformer``, ``rnn`` and ``layers_extra`` come with slice E."""
from paddle_tpu_torch.nn.layer import (  # noqa: F401
    Identity, Layer, LayerDict, LayerList, Parameter, ParameterList,
    Sequential,
)
from paddle_tpu_torch.nn.common import (  # noqa: F401
    AlphaDropout, Bilinear, CosineSimilarity, Dropout, Dropout2D, Dropout3D,
    Embedding, Flatten, Linear, Pad1D, Pad2D, Pad3D, PairwiseDistance,
    PixelShuffle, Unfold, Upsample, UpsamplingBilinear2D,
    UpsamplingNearest2D,
)
from paddle_tpu_torch.nn.conv_pool import (  # noqa: F401
    AdaptiveAvgPool2D, AdaptiveMaxPool2D, AvgPool1D, AvgPool2D, Conv1D,
    Conv2D, Conv2DTranspose, Conv3D, MaxPool1D, MaxPool2D,
)
from paddle_tpu_torch.nn.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, RMSNorm, SpectralNorm, SyncBatchNorm,
)
from paddle_tpu_torch.nn.activation import (  # noqa: F401
    CELU, ELU, GELU, GLU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    SELU, Sigmoid, Silu, Softmax, Softplus, Softshrink, Softsign, Swish,
    Tanh, Tanhshrink, ThresholdedReLU,
)
from paddle_tpu_torch.nn.loss import (  # noqa: F401
    BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss, CrossEntropyLoss,
    CTCLoss, HingeLoss, KLDivLoss, L1Loss, MarginRankingLoss, MSELoss,
    NLLLoss, RNNTLoss, SmoothL1Loss,
)
from paddle_tpu_torch.nn.clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)
from paddle_tpu_torch.nn import functional  # noqa: F401
from paddle_tpu_torch.nn import initializer  # noqa: F401
from paddle_tpu_torch.nn import utils  # noqa: F401
