"""The benchmark is driven by data: a configuration, a cell and a metric
added as files (and entries of BENCHMARK.json) are taken up with no edit
to a file that is there. Its files name nothing they may not: no module
imports JAX or the JAX package (top-level names compared whole), the
reference imports nothing of the program, and BENCHMARK.json keeps to
the allowed characters."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from gnnbench.cell import load_cell
from gnnbench.harness import run_cell

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "egc_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((HERE / "reference").rglob("*.py")):
        assert "egc_tpu_torch" not in _imports(f), f
    code = ("import sys; import gnnbench.reference.train, "
            "gnnbench.reference.graphs, gnnbench.reference.arxiv_net, "
            "gnnbench.reference.mag_net; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'egc_tpu_torch', 'egc_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(HERE))
    import run
    monkeypatch.setitem(sys.modules, "egc_tpu_torch.fake", object())
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "egc_tpu.fake", object())
    assert run.loaded_forbidden() == ["egc_tpu"]


def test_benchmark_json_keeps_to_the_allowed_characters():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics + bench["configs"]
             + bench["workloads"]]
    names += [w[k] for w in bench["workloads"] for k in ("config",
                                                         "traffic")]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for w in bench["workloads"]:
        assert (HERE / "workloads" / f"{w['name']}.json").is_file()
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for m in metrics:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_an_added_cell_config_and_metric_are_taken_up(tmp_path):
    root = tmp_path / "gnnbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    cfg = json.loads((root / "configs" / "egc_m_arxiv.json").read_text())
    cfg.update(name="egc_m_arxiv_small")
    cfg["graph"].update(num_nodes=900, avg_degree=6)
    (root / "configs" / "egc_m_arxiv_small.json").write_text(
        json.dumps(cfg))
    cell = {"config": "egc_m_arxiv_small", "traffic": "full", "chips": 1,
            "why": "a cell added as files"}
    limits = json.loads((root / "workloads" / "arxiv_egcm_full.json")
                        .read_text())["limits"]
    (root / "workloads" / "arxiv_small_full.json").write_text(
        json.dumps(dict(cell, limits=limits)))
    (root / "metrics" / "steps_per_s.py").write_text(
        "def read(r):\n    return r['steps'] / r['window_s']\n")
    bench["configs"].append({"name": "egc_m_arxiv_small", "source": "x",
                             "file": "gnnbench/configs/"
                                     "egc_m_arxiv_small.json",
                             "reduced": ["graph"], "why": "a test"})
    bench["workloads"].append(dict(cell, name="arxiv_small_full"))
    for m in bench["end_to_end"]:
        if m["name"] == "step_ms_p95":
            m["workloads"].append("arxiv_small_full")
    bench["end_to_end"].append({"name": "steps_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["arxiv_small_full"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    for p, data in before.items():
        assert p.read_bytes() == data         # nothing that was there moved
    found = load_cell("arxiv_small_full", root)
    assert found.config["graph"]["num_nodes"] == 900
    assert "steps_per_s" in found.end_to_end
    assert "step_ms_p95" in found.end_to_end
    assert "steps_per_s" not in load_cell("arxiv_egcm_full", root).end_to_end
    res = run_cell(found, 17, 0.5, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["steps_per_s"] > 0


def test_a_per_layer_metric_without_workloads_follows_its_moves(tmp_path):
    root = tmp_path / "gnnbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "epochs_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["mag_egc_full"]})
    for name, moves in (("epoch_ms", "epochs_per_s"),
                        ("kernel_ms", "train_edges_per_s")):
        bench["per_layer"].append({"name": name, "unit": "ms",
                                   "better": "lower",
                                   "source": "device_trace",
                                   "layer": "device", "moves": moves})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cells = [w["name"] for w in bench["workloads"]]
    per_layer = {c: load_cell(c, root).per_layer for c in cells}
    assert [c for c in cells if "epoch_ms" in per_layer[c]] == \
        ["mag_egc_full"]
    assert all("kernel_ms" in per_layer[c] for c in cells)
