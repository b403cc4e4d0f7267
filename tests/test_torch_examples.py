"""The port's examples (``repro_torch.examples``) against the reference's
``examples/*.py``.

* Each example's ``build`` / ``setup`` at its defaults makes the reference
  script's data, eval set, client shards (or streamed population),
  schedules and run configs bit for bit; each constant is cited by the
  reference script's line.
* Each example's ``main(argv)`` runs end to end on the CPU, its sizes cut
  through keyword arguments to ``run`` (the module's ``run`` wrapped), and
  prints the reference's summary fields.
* ``serve_llm`` on every assigned architecture: the kernel session's tokens
  and logits equal an ``impl="plain"`` session's on the CPU (where the
  wrappers run their plain versions), and the calls into the flash and SSD
  wrappers equal ``kernel_launches(cfg)``, the counts ``chip_smoke.py``
  asserts on the card.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

from repro.configs.base import get_config
from repro.core import compress
from repro.core.costs import comm_cost
from repro.core.schedule import FedPartSchedule, matched_fnu
from repro.data import (TextDatasetSpec, VisionDatasetSpec, balanced_eval_set,
                        build_clients, dirichlet_partition, iid_partition,
                        make_text_dataset, make_vision_dataset)
from repro.fl import AvailabilityConfig, FLRunConfig, resnet_task
from repro.fl.population import SyntheticPopulation
from repro_torch import bridge
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.configs import get_config as tget_config
from repro_torch.core.costs import comm_cost as tcomm_cost
from repro_torch.core.schedule import matched_fnu as tmatched_fnu
from repro_torch.examples import (fedpart_ablations, fedpart_async, fedpart_language,
                                  fedpart_mesh_training, quickstart, serve_llm)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.launch import fedtrain

torch.set_num_threads(1)

# FedPart's comm book of the quickstart (12 rounds, ResNet-8 with 8 classes)
# by compression: the reference's, pinned here and asserted by chip_smoke.py
QUICKSTART_COMM = {"none": 1833888, "int8": 467244}

RUN_FIELDS = ("local_epochs", "batch_size", "lr", "adam_eps", "engine", "seed",
              "sample_fraction", "cohort_size", "plan", "capacity_tiers",
              "compression", "runtime", "async_policy", "buffer_k",
              "staleness_exponent", "max_inflight_cohorts", "track_stepsizes")


def _rounds(rounds):
    return [(r.index, r.phase, r.cycle, r.group) for r in rounds]


def _same_clients(ref, port):
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert np.array_equal(a.inputs, b.inputs) and np.array_equal(a.labels, b.labels)


def _same_eval(ref, port):
    for a, b in zip(ref, port):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _same_config(ref, port, **port_expected):
    for field in RUN_FIELDS:
        assert getattr(port, field) == getattr(ref, field), field
    assert port.algo.name == ref.algo.name
    assert dataclasses.asdict(port.availability) == dataclasses.asdict(ref.availability)
    for field, value in port_expected.items():
        assert getattr(port, field) == value, field


@pytest.mark.parametrize("population", [0, 1_000_000])
def test_quickstart_build_matches_reference(population):
    spec = VisionDatasetSpec(num_classes=8, image_size=16, noise=1.0)         # :69
    xe, ye = make_vision_dataset(spec, 600, seed=99)                          # :70
    eval_set = balanced_eval_set(xe, ye, per_class=24)                        # :71
    sched = FedPartSchedule(num_groups=10, warmup_rounds=2, rounds_per_layer=1,
                            cycles=1)                                         # :83-84
    cfg = FLRunConfig(local_epochs=1, batch_size=32, lr=1e-3,
                      cohort_size=4 if population else 0)                     # :75, :85
    _, clients, teval, tsched, tcfg = quickstart.build(
        population=population, device="cpu", fused_adam=True)
    _same_eval(eval_set, teval)
    assert _rounds(tsched.rounds()) == _rounds(sched.rounds())
    assert _rounds(tmatched_fnu(tsched).rounds()) == _rounds(matched_fnu(sched).rounds())
    _same_config(cfg, tcfg, fused_adam=True, device="cpu")
    if population:
        ref = SyntheticPopulation(spec=spec, population=population,
                                  samples_per_client=300, seed=0)             # :74-75
        assert clients.num_clients == ref.num_clients
        _same_clients([ref.dataset(c) for c in (0, 17, 999_999)],
                      [clients.dataset(c) for c in (0, 17, 999_999)])
    else:
        x, y = make_vision_dataset(spec, 1200, seed=0)                        # :78
        _same_clients(build_clients(x, y, iid_partition(len(y), 4, seed=0)),  # :79
                      clients)


@pytest.mark.parametrize("compression", sorted(QUICKSTART_COMM))
def test_quickstart_comm_book_matches_reference(compression):
    """FedPart's and FNU's comm books of the quickstart equal the
    reference's (``core.costs`` on its ResNet-8, examples/quickstart.py:81)
    to the byte, and the pinned value."""
    adapter = resnet_task("resnet8", num_classes=8)
    params = adapter.init(jax.random.key(0))
    part = adapter.partition(params)
    tadapter, _, _, tsched, tcfg = quickstart.build(compression=compression,
                                                    device="cpu")
    tparams = bridge.from_numpy_tree(jax.tree.map(np.asarray, params))
    tpart = tadapter.partition(tparams)
    sched = FedPartSchedule(num_groups=10, warmup_rounds=2, rounds_per_layer=1,
                            cycles=1)
    for rounds, trounds in ((sched.rounds(), tsched.rounds()),
                            (matched_fnu(sched).rounds(), tmatched_fnu(tsched).rounds())):
        ref = comm_cost(params, part, rounds, compression=compress.make_config(compression))
        port = tcomm_cost(tparams, tpart, trounds, compression=tcfg.compression_config())
        assert (port.total_bytes, port.fnu_total_bytes) == \
            (ref.total_bytes, ref.fnu_total_bytes)
    fedpart = tcomm_cost(tparams, tpart, tsched.rounds(),
                         compression=tcfg.compression_config())
    assert fedpart.total_bytes == QUICKSTART_COMM[compression]


def test_language_build_matches_reference():
    spec = TextDatasetSpec(num_classes=4, vocab_size=512, seq_len=48)         # :19
    x, y = make_text_dataset(spec, 1600, seed=0)                              # :20
    xe, ye = make_text_dataset(spec, 800, seed=7)                             # :21
    clients = build_clients(x, y, dirichlet_partition(y, 4, alpha=1.0, seed=0))  # :24
    sched = FedPartSchedule(num_groups=4, warmup_rounds=2, rounds_per_layer=2,
                            cycles=2, bridge_rounds=1)                        # :28-29
    adapter, tclients, teval, tsched = fedpart_language.build()
    _same_clients(clients, tclients)
    _same_eval(balanced_eval_set(xe, ye, per_class=48), teval)                # :22
    assert _rounds(tsched.rounds()) == _rounds(sched.rounds())
    assert _rounds(tmatched_fnu(tsched).rounds()) == _rounds(matched_fnu(sched).rounds())
    assert adapter.partition(adapter.init(torch.Generator().manual_seed(0))) \
        .num_groups == 4                                                      # :25, :27
    assert fedpart_language.ALGOS == ("fedavg", "fedprox")                    # :31
    for algo in fedpart_language.ALGOS:
        ref = FLRunConfig(local_epochs=2, batch_size=32, lr=1e-3)             # :32-33
        _same_config(dataclasses.replace(ref, algo=dataclasses.replace(ref.algo, name=algo)),
                     fedpart_language.run_config(algo, device="cpu"))


@pytest.mark.parametrize("order,warmup", [("sequential", 2), ("reverse", 2),
                                          ("random", 2), ("sequential", 0),
                                          ("sequential", 5)])
def test_ablations_build_matches_reference(order, warmup):
    spec = VisionDatasetSpec(num_classes=8, image_size=16, noise=1.0)         # :18
    x, y = make_vision_dataset(spec, 1000, seed=0)                            # :19
    xe, ye = make_vision_dataset(spec, 500, seed=9)                           # :20
    sched = FedPartSchedule(num_groups=10, warmup_rounds=warmup,
                            rounds_per_layer=1, cycles=1, order=order)        # :24-25
    _, clients, teval, tsched, tcfg = fedpart_ablations.build(order, warmup,
                                                              device="cpu")
    _same_clients(build_clients(x, y, iid_partition(len(y), 4, seed=0)), clients)  # :22
    _same_eval(balanced_eval_set(xe, ye, per_class=24), teval)               # :21
    assert _rounds(tsched.rounds()) == _rounds(sched.rounds())
    _same_config(FLRunConfig(local_epochs=1, batch_size=32, lr=1e-3), tcfg)   # :26
    assert fedpart_ablations.ORDERS == ("sequential", "reverse", "random")    # :36
    assert fedpart_ablations.WARMUPS == (0, 2, 5)                             # :41


def test_async_setup_matches_reference():
    clients, rounds, spread, inflight = 8, 16, 4.0, 2          # argparse defaults :57-65
    cfg = get_config("nlp-transformer", smoke=True).with_(
        num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
        vocab_size=256, max_position_embeddings=16)                          # :44-46
    spec = TextDatasetSpec(num_classes=4, vocab_size=256, seq_len=16)        # :47
    x, y = make_text_dataset(spec, 48 * clients, seed=0)                     # :42, :48
    xe, ye = make_text_dataset(spec, 400, seed=99)                           # :49
    adapter, data, eval_set = fedpart_async.setup(clients)
    _same_clients(build_clients(x, y, iid_partition(len(y), clients, seed=0)), data)  # :51
    _same_eval(balanced_eval_set(xe, ye, per_class=32), eval_set)            # :50
    params = adapter.init(torch.Generator().manual_seed(0))
    assert params["embed"]["table"].shape == (256, 32) and len(params["blocks"]) == 2
    assert params["embed"]["pos"].shape == (16, 32)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tget_config(
        "nlp-transformer", smoke=True).with_(
            num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
            vocab_size=256, max_position_embeddings=16))
    sched = FedPartSchedule(num_groups=4, warmup_rounds=2, rounds_per_layer=2,
                            cycles=2, bridge_rounds=1)                       # :77-78
    assert _rounds(fedpart_async.schedule_rounds(rounds)) == \
        _rounds(sched.rounds()[:rounds])                                     # :79
    fleet = AvailabilityConfig(speed_spread=spread, latency_jitter=0.2, seed=7)  # :80-81
    base = dict(local_epochs=1, batch_size=16, lr=3e-3, engine="vmap",
                sample_fraction=0.5, availability=fleet, plan="homogeneous",
                capacity_tiers=(), runtime="async")                          # :82-84
    buff = dict(async_policy="fedbuff", buffer_k=max(1, clients // 4),
                staleness_exponent=0.5)                                      # :89-96
    ref = [("sync barrier", FLRunConfig(**base, async_policy="sync")),
           ("fedbuff K=n/4", FLRunConfig(**base, **buff)),
           (f"fedbuff x{inflight} inflight",
            FLRunConfig(**base, **buff, max_inflight_cohorts=inflight))]
    port = fedpart_async.variants(clients, device="cpu", fused_adam=True)
    assert [n for n, _ in port] == [n for n, _ in ref]
    for (_, r), (_, t) in zip(ref, port):
        _same_config(r, t, fused_adam=True, device="cpu")


def test_mesh_training_and_serve_match_reference():
    # examples/fedpart_mesh_training.py:18-25 (argparse defaults, then the argv)
    argv = fedpart_mesh_training.fedtrain_argv()
    assert argv[:-2] == ["--arch", "tinyllama-1.1b", "--rounds", "6",
                         "--steps-per-round", "3", "--batch", "4", "--seq", "32"]
    args = fedtrain.parse_args(argv)
    assert (args.device, args.sim_clients, args.full_size) == ("cuda", 0, False)
    # examples/serve_llm.py:21-27: B 4, prompt 32, 12 tokens, the smoke config
    main_defaults = serve_llm.run.__kwdefaults__
    assert (main_defaults["arch"], main_defaults["batch"], main_defaults["prompt_len"],
            main_defaults["gen"], main_defaults["impl"]) == \
        ("tinyllama-1.1b", 4, 32, 12, "kernel")
    for arch in ASSIGNED_ARCHS:
        assert dataclasses.asdict(tget_config(arch, smoke=True)) == \
            dataclasses.asdict(get_config(arch, smoke=True)), arch


def _tiny(module, monkeypatch, **kw):
    monkeypatch.setattr(module, "run", functools.partial(module.run, **kw))


QUICK_TINY = dict(samples=160, eval_samples=96, samples_per_client=40, rounds=4)


@pytest.mark.parametrize("argv", [["--engine", "sequential", "--fused-adam"],
                                  ["--engine", "vmap", "--plan", "nested",
                                   "--capacity-tiers", "0.5", "1.0"],
                                  ["--engine", "shard_map", "--compression", "int8"],
                                  ["--population", "1000000", "--cohort-size", "4"]],
                         ids=["sequential", "vmap-nested", "shard_map-int8",
                              "population"])
def test_quickstart_main_runs(argv, monkeypatch, capsys):
    _tiny(quickstart, monkeypatch, **QUICK_TINY)
    fp, fnu = quickstart.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    for field in ("=== FedPart (partial network updates)", "best acc", "comm (MB)",
                  "comp ratio", "FedAvg-FNU", "FedPart comm ="):
        assert field in out, field
    assert len(fp.history) == len(fnu.history) == 4
    assert fp.comm_total_bytes < fnu.comm_total_bytes
    assert all(np.isfinite(h["loss"]) for h in fp.history + fnu.history)


def test_language_main_runs(monkeypatch, capsys):
    _tiny(fedpart_language, monkeypatch, samples=256, eval_samples=64, rounds=4)
    out = fedpart_language.main(["--device", "cpu", "--fused-adam"])
    text = capsys.readouterr().out
    for algo in ("fedavg", "fedprox"):
        fp, fnu = out[algo]
        assert f"[{algo}] FedPart best=" in text
        assert len(fp.history) == len(fnu.history) == 4
    assert "of FNU) | FNU best=" in text


def test_ablations_main_runs(monkeypatch, capsys):
    _tiny(fedpart_ablations, monkeypatch, samples=160, eval_samples=96, rounds=3)
    out = fedpart_ablations.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert set(out) == {("order", o) for o in fedpart_ablations.ORDERS} | \
        {("warmup", w) for w in fedpart_ablations.WARMUPS}
    for line in ("selection order (paper Table 7", "order=reverse    best_acc=",
                 "warm-up rounds (paper Table 6)", "warmup=5 best_acc="):
        assert line in text, line
    assert [h["phase"] for h in out["warmup", 0].history] == ["partial"] * 3
    assert [h["phase"] for h in out["warmup", 5].history] == ["warmup"] * 3


def test_async_main_runs(monkeypatch, capsys):
    _tiny(fedpart_async, monkeypatch, samples_per_client=16, eval_samples=64)
    out = fedpart_async.main(["--device", "cpu", "--clients", "4", "--rounds", "4",
                              "--fused-adam"])
    text = capsys.readouterr().out
    assert list(out) == ["sync barrier", "fedbuff K=n/4", "fedbuff x2 inflight"]
    for field in ("summary (virtual time)", "best acc", "total (s)", "tta (s)",
                  "staleness", "overlap", "virtual=", "max_staleness="):
        assert field in text, field
    for res in out.values():
        assert res.timeline.of_kind("merge") and np.isfinite(res.timeline.total_seconds)


def test_mesh_training_main_runs(capsys):
    assert fedpart_mesh_training.main(["--device", "cpu", "--rounds", "2"]) == 0
    text = capsys.readouterr().out
    assert "[fedtrain] round   0 [FNU ]" in text and "of FNU" in text
    _, records = fedpart_mesh_training.run(device="cpu", rounds=2)
    assert [r["group"] for r in records] == [-1, 0]


def _counting(monkeypatch):
    counts = {"flash": 0, "ssd": 0}

    def wrap(name, fn):
        def counted(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return counted

    monkeypatch.setattr(fa_ops, "flash_attention", wrap("flash", fa_ops.flash_attention))
    monkeypatch.setattr(ssd_ops, "ssd_scan", wrap("ssd", ssd_ops.ssd_scan))
    return counts


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_serve_llm_matches_plain_session(arch, monkeypatch, capsys):
    """The kernel session (through main) against the plain one on the same
    weights: the same tokens and logits; the wrapper calls of its prefill
    equal ``kernel_launches``."""
    counts = _counting(monkeypatch)
    kernel = serve_llm.main(["--arch", arch, "--device", "cpu"])
    text = capsys.readouterr().out
    assert f"[serve_llm] {arch}: generated token grid (4, 12)" in text
    assert (counts["flash"], counts["ssd"]) == \
        serve_llm.kernel_launches(tget_config(arch, smoke=True))
    plain = serve_llm.run(arch=arch, device="cpu", impl="plain", verbose=False)
    assert torch.equal(kernel.tokens, plain.tokens)
    for a, b in zip(kernel.logits, plain.logits):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
