"""Nothing the benchmark runs imports JAX or the JAX package, reads the old
CPU benchmarks, or lets its references import the program."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _sources():
    return [p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts]


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not (_imports(path) & FORBIDDEN), path


def test_references_and_counts_import_nothing_of_the_program():
    for path in PKG.rglob("*.py"):
        if path.name in ("reference.py", "counts.py") or path.parent.name == "metrics" or \
                path.name in ("fedref.py", "compare.py", "synthetic.py", "flopgraph.py",
                              "kernelcounts.py", "traffic.py"):
            assert "repro_torch" not in _imports(path), path


def test_nothing_reads_the_old_cpu_benchmarks():
    for path in _sources():
        if path.name.startswith("test_"):
            continue
        text = path.read_text()
        for word in ("benchmarks/", "BENCH_", "chip_smoke"):
            assert word not in text, (path, word)


def test_a_run_loads_no_jax_module():
    """A whole run in a fresh process (on the CPU, at smoke size): the
    harness's own check after the window finds nothing, and neither does a
    look at ``sys.modules`` after it, by whole top-level names."""
    code = f"""
import json, sys
from pathlib import Path
from perfbench.cell import run_cell
r = run_cell(Path({str(ROOT)!r}), "nlp.fnu", 5, 0.01, False, device="cpu",
             config_override=dict(num_layers=1, d_model=16, num_heads=2, num_kv_heads=2,
                                  d_ff=32, vocab_size=50, max_position_embeddings=8,
                                  seq_len=8),
             traffic_override=dict(clients=2, samples_per_client=16, batch_size=8, local_epochs=1,
                                   eval_samples=8), log=lambda m: None)
print(json.dumps({{"correct": r["correct"],
                   "found": sorted({{n.split(".")[0] for n in sys.modules}} & set({sorted(FORBIDDEN)!r}))}}))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "src")]))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "found": []}


def test_run_without_a_card_prints_no_result(tmp_path):
    """The entry point refuses to run where torch sees no CUDA card (here),
    with another exit code than 0 and nothing on standard output."""
    import torch
    if torch.cuda.is_available():
        return
    env = dict(os.environ)
    out = subprocess.run([sys.executable, str(PKG / "run.py"), "--workload", "nlp.fnu",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         env=env, capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    """``repro_torch`` begins with ``repro`` and is allowed; ``repro`` and
    its submodules are not."""
    import types

    from perfbench.run import loaded_forbidden
    clean = {n: m for n, m in sys.modules.items() if n.split(".")[0] not in FORBIDDEN}
    monkeypatch.setattr(sys, "modules", dict(clean))
    sys.modules["repro_torch_fake"] = types.ModuleType("repro_torch_fake")
    sys.modules["jaxlike.sub"] = types.ModuleType("jaxlike.sub")
    assert loaded_forbidden() == []
    sys.modules["repro.core"] = types.ModuleType("repro.core")
    sys.modules["flax"] = types.ModuleType("flax")
    assert loaded_forbidden() == ["flax", "repro.core"]
