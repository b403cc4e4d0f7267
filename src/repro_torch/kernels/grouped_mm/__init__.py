from repro_torch.kernels.grouped_mm.kernel import (GroupedMM, grouped_mm,  # noqa: F401
                                                   grouped_mm_wgrad)
from repro_torch.kernels.grouped_mm.ops import grouped_swiglu  # noqa: F401
from repro_torch.kernels.grouped_mm.ref import (grouped_mm_ref,  # noqa: F401
                                                grouped_mm_wgrad_ref)
