"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; a metric names its reader.
Each lives in files of its own, so a cell, a configuration, a mix or a
metric is added by adding files and entries, never by editing one:

    perfbench/configs/<config>/config.json, reference.py, program.py, counts.py
    perfbench/traffic/<traffic>.json
    perfbench/metrics/<metric>.py          (def read(run) -> float | None)
    perfbench/limits/<cell>.json
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _modname(*parts: str) -> str:
    return "perfbench_" + "_".join(re.sub(r"[^A-Za-z0-9_]", "_", p) for p in parts)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    reference: ModuleType
    counts: ModuleType
    config_dir: Path
    end_to_end: list[dict]
    per_layer: list[dict]

    def program(self) -> ModuleType:
        """The configuration's binding to the port (imports the program)."""
        return load_module(self.config_dir / "program.py",
                           _modname("program", self.config["name"]))


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def metric_applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(root: Path, metric: str) -> ModuleType:
    return load_module(root / "perfbench" / "metrics" / f"{metric}.py",
                       _modname("metric", metric))


def load_cell(root: Path, name: str) -> Cell:
    bench = load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"there are {sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = root / configs[w["config"]]["file"]
    cfg_dir = cfg_file.parent
    config = json.loads(cfg_file.read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        reference=load_module(cfg_dir / "reference.py", _modname("reference", w["config"])),
        counts=load_module(cfg_dir / "counts.py", _modname("counts", w["config"])),
        config_dir=cfg_dir,
        end_to_end=[m for m in bench["end_to_end"] if metric_applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if metric_applies(m, name)])
