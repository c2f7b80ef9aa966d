"""paddle_tpu_torch.nn (port of ``paddle_tpu/nn/``): ``Layer`` and its
containers, the common, conv/pool, norm, activation and loss layers, the
transformer and recurrent layers, the long-tail layers of
``layers_extra``, the initializers, ``nn.utils``, the gradient clips and
``nn.functional``: every name the JAX package's ``nn`` exports."""
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
from paddle_tpu_torch.nn.transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
)
from paddle_tpu_torch.nn.rnn import (  # noqa: F401
    GRU, GRUCell, LSTM, LSTMCell, RNN, SimpleRNN, SimpleRNNCell,
)
from paddle_tpu_torch.nn.clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)
from paddle_tpu_torch.nn import functional  # noqa: F401
from paddle_tpu_torch.nn import initializer  # noqa: F401
from paddle_tpu_torch.nn import utils  # noqa: F401
from paddle_tpu_torch.nn.layers_extra import (  # noqa: F401,E402
    AdaptiveAvgPool1D, AdaptiveAvgPool3D, AdaptiveMaxPool1D,
    AdaptiveMaxPool3D, AvgPool3D, BeamSearchDecoder, BiRNN,
    ChannelShuffle, Conv1DTranspose, Conv3DTranspose, Fold,
    FractionalMaxPool2D, FractionalMaxPool3D, GaussianNLLLoss,
    HingeEmbeddingLoss, HSigmoidLoss, MaxPool3D, MaxUnPool1D,
    MaxUnPool2D, MaxUnPool3D, MultiLabelSoftMarginLoss, MultiMarginLoss,
    PixelUnshuffle, PoissonNLLLoss, RNNCellBase, RReLU, SoftMarginLoss,
    Softmax2D, TripletMarginLoss, TripletMarginWithDistanceLoss,
    Unflatten, ZeroPad2D, dynamic_decode,
)
