from repro_torch.kernels.flash_attention import ops  # noqa: F401
from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    MAX_HEAD_DIM, flash_attention_kernel)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: F401
