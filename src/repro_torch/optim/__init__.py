from repro_torch.optim.adam import (AdamConfig, AdamState,  # noqa: F401
                                    adam_init, adam_update)
from repro_torch.optim.partial import (PackedTree, full_step,  # noqa: F401
                                      fused_adam, fused_masked_step,
                                      guard_fused_config, masked_step,
                                      partitioned_step, value_and_grad)
from repro_torch.optim.sgd import SGDConfig, SGDState, sgd_init, sgd_update  # noqa: F401
