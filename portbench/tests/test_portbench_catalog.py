"""Every configuration, cell, mix and metric is a file found by its name,
and a cell added as new files (with no file that is there edited) is found
too."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import catalog
from portbench.tests import tiny

REPO = tiny.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found(name):
    cell = catalog.cell(name)
    assert cell.chips == 1
    assert cell.spec["why"] == {w["name"]: w for w in BENCH["workloads"]}[name]["why"]
    assert set(cell.spec["limits"]) == {"mean_code_gap", "worst_frame_gap"}
    rate = [m for m in cell.end_to_end if m.split(".")[0] == "frames_per_s"]
    assert len(rate) == 1 and "setup_s" in cell.end_to_end
    # every per-layer metric of the cell moves an end-to-end metric that the cell reports
    moves = {m["name"]: m["moves"] for m in BENCH["per_layer"]}
    assert cell.per_layer and all(moves[m] in cell.end_to_end for m in cell.per_layer)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file(entry):
    raw = json.loads((REPO / entry["file"]).read_text())
    assert raw["name"] == entry["name"] and raw["source"] == entry["source"]
    assert raw["reduced"] == entry["reduced"] == []


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_its_reader(entry):
    m = catalog.metric(entry["name"])
    assert (m.UNIT, m.BETTER, m.SOURCE) == (entry["unit"], entry["better"], entry["source"])
    if "layer" in entry:
        assert m.LAYER == entry["layer"]
        assert entry["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("path", sorted((REPO / "portbench" / "traffic").glob("*.json")), ids=lambda p: p.stem)
def test_every_mix_finds_its_kind_by_name(path):
    params = json.loads(path.read_text())
    mix = catalog.generator(params).Mix(params, 2**33 + 1)
    assert mix.block == len(params["sizes"])
    sizes = [tuple(mix.request(i).frames.shape[1:3]) for i in range(4 * mix.block)]
    for b in range(4):  # every block holds each size once
        assert sorted(sizes[b * mix.block:(b + 1) * mix.block]) == sorted(map(tuple, params["sizes"]))


def test_a_new_cell_is_new_files_only(tmp_path):
    before = {p: p.read_bytes() for p in (REPO / "portbench").rglob("*.json")}
    root = tiny.make_root(tmp_path)
    cell = catalog.cell(tiny.CELL, root)
    assert cell.config["name"] == "tiny" and cell.traffic["frames"] == 10
    assert "idle_share" in cell.per_layer and "frames_per_s" in cell.end_to_end
    assert "request_s_p90" not in cell.end_to_end
    # the copy's existing files are the repository's, unchanged
    for p, data in before.items():
        assert (root / p.relative_to(REPO)).read_bytes() == data


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((REPO / "portbench").rglob("*.py")), ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "seedvr2_tpu"}
    if "reference" in path.parts:  # the plain reference reads nothing of the program either
        assert "seedvr2_tpu_torch" not in tops


def test_loaded_modules_after_a_cpu_run(tmp_path):
    """A whole run of the tiny cell in a fresh interpreter: no module whose
    top-level name is jax, jaxlib, flax or seedvr2_tpu is loaded."""
    root = tiny.make_root(tmp_path)
    code = (
        "import sys, torch; torch.set_num_threads(1)\n"
        "from pathlib import Path\n"
        "from portbench import run\n"
        f"r = run.run_cell({tiny.CELL!r}, 5, 0.5, False, 'cpu', Path({str(root)!r}))\n"
        "assert r['correct'], r\n"
        "print(run.forbidden_modules())\n"
    )
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "seedvr2_tpu_torch_fake", sys)
    assert "seedvr2_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "seedvr2_tpu.config", sys)
    assert "seedvr2_tpu" in run.forbidden_modules()
