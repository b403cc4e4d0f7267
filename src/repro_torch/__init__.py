"""FedPart in PyTorch for one NVIDIA H100 — the port of ``repro``.

The package mirrors ``src/repro/``'s layout and names, so each module's
counterpart is easy to find.  It imports ``torch`` and numpy, never ``jax``
and nothing of ``repro``: the numpy-only reference modules it needs are
copied here.  Parameters are path-keyed nested dicts of tensors with the
reference's keys and shapes (HWIO convs, ``(in, out)`` heads), flattened in
sorted-key order (``repro_torch.tree``), so partitions, pack layouts and
block masks are identical across the two packages.

Entry points run on the card unless the caller asks for the CPU
(``FLRunConfig(device="cpu")``, as the tests do).  The fused local Adam step
is a hand-written CUDA kernel (``kernels/masked_adam``, source
``csrc/masked_adam.cu``) built with nvcc at first use.
"""
