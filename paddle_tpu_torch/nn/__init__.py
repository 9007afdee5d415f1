"""paddle_tpu_torch.nn (counterpart of `paddle_tpu/nn`): Layer, ParamAttr,
the containers, the common, norm, activation and loss layers, the
clips, `functional` and `initializer`. Convolution, pooling, recurrent,
transformer and vision layers wait for ROADMAP item 13b."""
from .layer.layers import Layer, ParamAttr  # noqa: F401
from .layer.container import Sequential, LayerList, LayerDict, ParameterList  # noqa: F401
from .layer.common import (  # noqa: F401
    Identity, Linear, Bilinear, Dropout, Dropout2D, Dropout3D, AlphaDropout,
    FeatureAlphaDropout, Embedding, Flatten, Unflatten, Upsample,
    UpsamplingNearest2D, UpsamplingBilinear2D, Pad1D, Pad2D, Pad3D, ZeroPad1D,
    ZeroPad2D, ZeroPad3D, CosineSimilarity, PairwiseDistance, Unfold, Fold,
)
from .layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, LayerNorm, RMSNorm,
    GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
    LocalResponseNorm,
)
from .layer.activation import (  # noqa: F401
    ReLU, ReLU6, SiLU, Swish, Sigmoid, LogSigmoid, Tanh, Tanhshrink, Softsign,
    Mish, Hardswish, ELU, CELU, SELU, GELU, Hardshrink, Hardsigmoid, Hardtanh,
    LeakyReLU, PReLU, RReLU, Softplus, Softshrink, ThresholdedReLU, Softmax,
    Softmax2D, LogSoftmax, Maxout, GLU,
)
from .layer.loss import (  # noqa: F401
    CrossEntropyLoss, MSELoss, L1Loss, SmoothL1Loss, HuberLoss, NLLLoss,
    BCELoss, BCEWithLogitsLoss, KLDivLoss, MarginRankingLoss,
    HingeEmbeddingLoss, CosineEmbeddingLoss, TripletMarginLoss,
    TripletMarginWithDistanceLoss, MultiLabelSoftMarginLoss, SoftMarginLoss,
    MultiMarginLoss, PoissonNLLLoss, GaussianNLLLoss,
)
from .clip import (  # noqa: F401
    ClipGradByValue, ClipGradByNorm, ClipGradByGlobalNorm, clip_grad_norm_,
    clip_grad_value_,
)
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layer import layers  # noqa: F401
from .layer.activation import SiLU as Silu  # noqa: F401  (paddle alias)
