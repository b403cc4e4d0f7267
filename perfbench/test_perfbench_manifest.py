"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
finding of cells, configurations, mixes and metrics by name alone."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench.manifest import NAME, UNIT, load_benchmark, load_cell

ROOT = Path(__file__).resolve().parent.parent
BENCH = load_benchmark(ROOT)
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|expan|d_model"
                   r"|d_ff|channels|experts_per|per_tok")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.endswith("_torch")
        assert (ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    assert 1 <= len(names) <= {"configs": 24, "workloads": 24, "end_to_end": 16,
                               "per_layer": 128}[section]


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        cdir = (ROOT / c["file"]).parent
        for f in ("reference.py", "program.py", "counts.py"):
            assert (cdir / f).is_file()


def test_workloads():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        four += w["chips"] == 4
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metrics(section):
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH[section]:
        keys = ({"name", "unit", "better", "bound", "source"} if section == "end_to_end"
                else {"name", "unit", "better", "source", "layer", "moves"})
        assert set(m) - {"workloads"} == keys, m["name"]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        if section == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert TEXT.match(m["layer"]) and m["moves"] in e2e
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    if section == "end_to_end":
        assert "setup_s" in e2e


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    """Each per-layer metric's ``moves`` is an end-to-end metric that every
    cell it lists reports; every cell reports setup_s, another end-to-end
    metric and a per-layer metric."""
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", cells):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        names = [n for n, m in e2e.items() if reports(m, cell)]
        assert "setup_s" in names and len(names) >= 2
        assert any(reports(m, cell) for m in BENCH["per_layer"])


def test_layers_are_named_alike_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert f"**{layer}**" in perf, layer


def test_limits_files_hold_every_compared_number():
    from perfbench.compare import NAMES, load_limits
    for w in BENCH["workloads"]:
        limits = load_limits(ROOT, w["name"])
        assert set(limits) <= set(NAMES) and len(limits) >= 3
        assert limits["unmoved"] == 0 and limits["stuck"] == 0


def test_new_config_traffic_and_metric_are_found_by_name_alone(tmp_path):
    """A cell, a configuration, a mix and a metric added as new files (and
    entries of BENCHMARK.json) are found with no edit to an existing file."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    shutil.copytree(tmp_path / "perfbench" / "configs" / "nlp-transformer",
                    tmp_path / "perfbench" / "configs" / "nlp-tiny")
    cfg_path = tmp_path / "perfbench" / "configs" / "nlp-tiny" / "config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg.update(name="nlp-tiny", num_layers=1, d_model=16, num_heads=2, num_kv_heads=2,
               d_ff=32, vocab_size=50, max_position_embeddings=8, seq_len=8)
    cfg_path.write_text(json.dumps(cfg))
    mix = json.loads((tmp_path / "perfbench" / "traffic" / "fnu.json").read_text())
    mix.update(name="fnu-small", clients=2, samples_per_client=16, batch_size=8, local_epochs=1,
               eval_samples=8, rounds_per_call=2)
    (tmp_path / "perfbench" / "traffic" / "fnu-small.json").write_text(json.dumps(mix))
    (tmp_path / "perfbench" / "metrics" / "rounds_per_s.py").write_text(
        "def read(run):\n    return len(run.rounds) / run.window_s\n")
    shutil.copy(tmp_path / "perfbench" / "limits" / "nlp.fnu.json",
                tmp_path / "perfbench" / "limits" / "tiny.fnu.json")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "nlp-tiny", "source": "a test",
                             "file": "perfbench/configs/nlp-tiny/config.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.fnu", "config": "nlp-tiny",
                               "traffic": "fnu-small", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "rounds_per_s", "unit": "rounds/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny.fnu"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "src").symlink_to(ROOT / "src")

    from perfbench.cell import run_cell
    cell = load_cell(tmp_path, "tiny.fnu")
    assert cell.config["d_model"] == 16 and cell.traffic["clients"] == 2
    result = run_cell(tmp_path, "tiny.fnu", 11, 0.01, False, device="cpu",
                      log=lambda msg: None)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"samples_per_s", "peak_mem_gib", "setup_s",
                                      "rounds_per_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before
