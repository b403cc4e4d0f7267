"""FedPart in PyTorch for one NVIDIA H100 — the port of ``repro``.

The package mirrors ``src/repro/``'s layout and names, so each module's
counterpart is easy to find.  It imports ``torch`` and numpy, never ``jax``
and nothing of ``repro``: the numpy-only reference modules it needs are
copied here.  Parameters are path-keyed nested dicts of tensors with the
reference's keys and shapes (HWIO convs, ``(in, out)`` heads), flattened in
sorted-key order (``repro_torch.tree``), so partitions, pack layouts and
block masks are identical across the two packages.

On the card run the FedPart loop (``fl``: both engines, both paper
tasks, compression, the async runtime), whose fused local Adam step is a
hand-written CUDA kernel (``kernels/masked_adam``); serving of TinyLlama
and Zamba2 (``launch/serve.py``), whose prefill attention and Mamba2 scans
are two more (``kernels/flash_attention``, ``kernels/ssd_chunk``); and the
launchers (``launch/fedtrain.py``: FedPart training of a served model and
the simulation's command line; ``launch/train.py``; ``checkpoint``).  The
kernels are built with nvcc at first use.  Entry points (``fl``, ``launch``)
run on the card unless the caller asks for the CPU (``device="cpu"``, as the
tests do); the model builders under them (``models.api.init``,
``cache_init``, ``synth_batch``) take the device as a required argument.
"""
