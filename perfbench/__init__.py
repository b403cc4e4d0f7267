"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on NVIDIA cards.

``BENCHMARK.json`` at the root of the repository names its cells, its
configurations, its traffic mixes and its metrics; this package holds
everything they refer to, found by name:

* ``configs/<config>/config.json``: the sizes the configuration runs at,
  with ``reference.py`` (its plain PyTorch model, weights and data from the
  seed), ``program.py`` (the port's task for it, the system under test) and
  ``counts.py`` (its operation and byte counts) beside it;
* ``traffic/<traffic>.json``: the parameters of a traffic mix, read by the
  one generator in ``traffic.py``;
* ``metrics/<metric>.py``: one reader per metric;
* ``limits/<cell>.json``: the limits of the numbers that decide ``correct``.

``run.py`` runs one cell once; ``control.py`` takes the readings the limits
are set from.  Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro``.
"""
