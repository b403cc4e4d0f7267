from repro_torch.kernels.masked_adam import ops  # noqa: F401
from repro_torch.kernels.masked_adam.kernel import (LANES,  # noqa: F401
                                                    MaskedAdamCohort,
                                                    masked_adam_,
                                                    masked_adam_stacked_)
from repro_torch.kernels.masked_adam.ref import (masked_adam_cohort_ref,  # noqa: F401
                                                 masked_adam_ref)
