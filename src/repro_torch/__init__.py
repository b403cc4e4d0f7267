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
kernels are built with nvcc at first use.  The sharded-model layer:
``launch/mesh.py``'s data x model meshes, ``launch/sharding.py``'s
placements, ``models/moe_ep.py`` (expert parallelism over
``torch.distributed``), ``models/act_sharding.py``, the DTensor-propagated
steps (``launch/steps.py`` ``make_sharded_*``, the attention, scans and
kernels on each rank's heads through ``models/sharded_heads.py``) and the
dry run on them (``launch/dryrun.py``, ``cost_probes.py``,
``hlo_analysis.py``: fake tensors, per-device counts, no card).  Two JAX shims have no counterpart:
``core/compat.py`` (jax's ``shard_map`` symbol and keyword churn: torch has
no ``shard_map``) and ``launch/_simdev.py`` (an XLA flag for simulated host
devices: ``torchrun`` sets the world size, and the dry run makes a
``"fake"`` process group of any size).  Entry points (``fl``, ``launch``)
run on the card unless the caller asks for the CPU (``device="cpu"``, as the
tests do); the model builders under them (``models.api.init``,
``cache_init``, ``synth_batch``) take the device as a required argument.
"""
