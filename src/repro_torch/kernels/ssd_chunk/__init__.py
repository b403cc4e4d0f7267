from repro_torch.kernels.ssd_chunk import ops  # noqa: F401
from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_kernel  # noqa: F401
from repro_torch.kernels.ssd_chunk.ref import ssd_ref  # noqa: F401
