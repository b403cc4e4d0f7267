"""Twelve rounds of ``launch.fedtrain``'s simulation setup on both engines of
both packages: the port's vmap-vs-sequential drift stays within
``MULTIPLE`` (2) times the reference's own.

The two engines sum their convolutions in different orders (grouped over
the stacked clients against one client at a time), and Adam compounds the
difference over rounds, in the reference as in the port.
``chip_smoke.py`` ``phase_fedtrain_sim`` holds the card's 12-round drift to
a bound derived from the reference's (``FEDTRAIN_SIM_REL_TOL``); this test
is the CPU side of that claim.

Setup: ``fedtrain --sim-clients 3 --rounds 12 --batch 32`` (ResNet-8 at 8
classes on 16 x 16 images, 160 samples a client, the warm-up FNU round
then one layer group a round), cut from 8 clients to 3 to keep the file
short, at ``adam_eps=1e-3``; the reference's initial parameters, bridged.
Run as a script, it prints both drifts of any client count, fused or not,
and the reference's largest final |param|:

    JAX_PLATFORMS=cpu PYTHONPATH=src:. python tests/test_torch_fedtrain_drift.py --clients 8 --fused-adam

The drift is the max-abs difference of the final params.  Measured with
this script (one torch thread): at 3 clients the port 2.638e-4, the
reference 3.065e-4; at all 8 clients, fused as ``chip_smoke.py`` runs it,
1.477e-4 and 1.500e-4; at 8 clients unfused 1.808e-4 and 1.349e-4.  Which
package drifts more flips with the configuration, so the bound is the
multiple the card's check uses, not a strict order.
"""

import dataclasses

import jax
import numpy as np
import torch

import repro.fl as jfl
from repro.core.partition import tree_paths as j_tree_paths
from repro.core.schedule import FedPartSchedule
from repro.data import (VisionDatasetSpec, balanced_eval_set, build_clients,
                        iid_partition, make_vision_dataset)
from repro_torch import bridge
from repro_torch import fl as tfl
from repro_torch.launch import fedtrain
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)   # one thread per xdist worker (see test_torch_masked_adam)

CLIENTS = 3
MULTIPLE = 2.0     # chip_smoke.py FEDTRAIN_SIM_REL_TOL's multiple


def _reference_setup(clients: int):
    """The reference's ``fedtrain.run_simulation`` setup, built the same way."""
    spec = VisionDatasetSpec(num_classes=8, image_size=16)
    xe, ye = make_vision_dataset(spec, 400, seed=99)
    x, y = make_vision_dataset(spec, 160 * clients, seed=0)
    datasets = build_clients(x, y, iid_partition(len(y), clients, seed=0))
    rounds = FedPartSchedule(num_groups=10, warmup_rounds=1, rounds_per_layer=1,
                             cycles=2).rounds()[:12]
    return (jfl.resnet_task("resnet8", num_classes=8), datasets,
            balanced_eval_set(xe, ye, per_class=24), rounds)


def drifts(clients: int, fused: bool = False) -> tuple[float, float, float]:
    """(port, reference) max-abs final-param difference between the vmap
    and the sequential engine over the 12 rounds, ``clients`` clients, and
    the reference's largest final |param| (sequential engine)."""
    argv = ["--sim-clients", str(clients), "--rounds", "12", "--batch", "32",
            "--device", "cpu"] + (["--fused-adam"] if fused else [])
    adapter, datasets, eval_set, rounds, cfg = fedtrain.build_simulation(
        fedtrain.parse_args(argv))
    jadapter, jdatasets, jeval, jrounds = _reference_setup(clients)
    assert [(r.index, r.group) for r in rounds] == [(r.index, r.group) for r in jrounds]
    init = jax.tree.map(np.asarray, jadapter.init(jax.random.key(0)))
    ref, port = {}, {}
    for engine in ("vmap", "sequential"):
        ref[engine] = [np.asarray(x) for _, x in j_tree_paths(jfl.run_federated(
            jadapter, jdatasets, jeval, jrounds,
            jfl.FLRunConfig(local_epochs=1, batch_size=32, lr=1e-3, adam_eps=1e-3,
                            engine=engine, fused_adam=fused),
            init_key=jax.random.key(0)).params)]
        port[engine] = [x.numpy() for x in tree_leaves(tfl.run_federated(
            adapter, datasets, eval_set, rounds,
            dataclasses.replace(cfg, engine=engine, adam_eps=1e-3),
            init_params=bridge.from_numpy_tree(init)).params)]

    def drift(runs):
        return max(float(np.abs(a - b).max())
                   for a, b in zip(runs["vmap"], runs["sequential"]))

    return (drift(port), drift(ref),
            max(float(np.abs(x).max()) for x in ref["sequential"]))


def test_port_drift_within_a_multiple_of_the_reference_over_12_rounds():
    port_drift, ref_drift, _ = drifts(CLIENTS)
    assert 0.0 < port_drift <= MULTIPLE * ref_drift, (port_drift, ref_drift)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--fused-adam", action="store_true")
    a = ap.parse_args()
    port_drift, ref_drift, scale = drifts(a.clients, a.fused_adam)
    print(f"12 rounds, {a.clients} clients, fused {a.fused_adam}: vmap vs sequential "
          f"max param diff: port {port_drift:.6g}, reference {ref_drift:.6g}; the "
          f"reference's largest |param| {scale:.6g}")
