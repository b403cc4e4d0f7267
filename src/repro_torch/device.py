"""Device resolution and the full-f32 switch.

Entry points take a device name and never fall back: asking for ``"cuda"``
without a card raises.  On the card, cuDNN convolutions default to TF32,
which keeps about three decimal digits; ``strict_fp32`` makes every conv and
matmul run in full f32, so the port agrees with the f32 reference.
"""

from __future__ import annotations

import torch


def strict_fp32() -> None:
    """Turn TF32 off for cuBLAS matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cuda"`` / ``"cuda:N"`` / ``"cpu"`` -> ``torch.device``; a CUDA
    device without a card raises ``RuntimeError``."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch sees no CUDA "
                "device; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}; expected cuda or cpu")
    return dev
