"""Published peaks by device name (``torch.cuda.get_device_name``).

NVIDIA H100 SXM5 (data sheet, dense rates at the 700 W limit): float32
outside the tensor cores 67 TFLOP/s; HBM3 3.35 TB/s.  A card not listed
has no peaks, and the metrics that need them are left out of its runs.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_name: str) -> dict | None:
    return PEAKS.get(device_name)
