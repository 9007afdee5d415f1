"""paddle_tpu_torch.nn.functional (counterpart of
`paddle_tpu/nn/functional`): activations, common ops, norms, losses and
the attention entry points. Convolution, pooling and the vision
functionals wait for ROADMAP item 13b."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .attention import (  # noqa: F401
    scaled_dot_product_attention, flash_attention, flash_attn_unpadded,
    sdp_kernel, flash_attn_qkvpacked, flash_attn_varlen_qkvpacked,
    sparse_attention, flashmask_attention,
)
