"""Hand-written Hopper kernels, each the port of one Pallas TPU kernel of
``repro.kernels``.

- ``masked_adam``: fused Eq.-1 masked Adam (block-skip on frozen groups),
  CUDA C++ in ``csrc/masked_adam.cu``.
- ``flash_attention``: forward online-softmax attention (GQA, causal,
  sliding window), CUDA C++ in ``csrc/flash_attention.cu``; every prefill
  attention of the serving path runs through it.
- ``ssd_chunk``: the chunked decay linear-attention scan of Mamba2 (state
  carried across chunks), CUDA C++ in ``csrc/ssd_chunk.cu``; every Mamba2
  prefill scan of the hybrid serving path runs through it.

Each kernel package ships ``kernel.py`` (the wrapper: checks, launch, launch
count), ``ref.py`` (the plain PyTorch version the CPU takes and the tests
hold the kernel against) and ``ops.py`` (layout helpers).  ``build.py``
compiles the CUDA sources with nvcc at first use.
"""

import torch


def refuse_grad(name: str, *inputs: torch.Tensor) -> None:
    """Raise when autograd would need a backward through kernel ``name``.

    The serving kernels (flash attention, the SSD scan) have no backward,
    as their TPU counterparts have none, and on a CUDA tensor they write
    their outputs through raw pointers, so autograd would see no graph and
    a loss would silently back-propagate nothing.  The check runs before
    the device dispatch, so the CPU (plain version) and the card refuse
    alike; serving runs under ``torch.no_grad`` / ``inference_mode`` and
    never trips it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name} has no backward: an input requires grad with grad mode "
            "on; differentiate through impl='plain', or call it under "
            "torch.no_grad()")


def refuse_dtensor(name: str, *inputs) -> None:
    """Raise when a DTensor reaches kernel ``name``.  A kernel launches on
    raw device pointers of one rank's tensors: a DTensor step reaches it
    only through ``models.sharded_heads``' ``local_map`` regions, which
    hand it each rank's local heads.  The check runs on every device, so a
    sharded path that skipped the region fails on the CPU as on the card
    (and never falls back to the plain version)."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in inputs):
        raise TypeError(
            f"{name} takes plain tensors, got a DTensor: run it on each rank's "
            "local heads (models.sharded_heads routes a DTensor step there)")
