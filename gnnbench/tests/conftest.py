"""The benchmark's own tests. Those marked ``card`` need an NVIDIA card
and skip elsewhere; whether there is one is decided in the ``card``
fixture, never while a module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (run on the chip: "
        "python3 -m pytest gnnbench/tests -m card)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


# Nodes of each model's small graph. The arxiv net's max aggregation
# routes a gradient to one sender; where two senders' values lie within
# round-off, the program and the reference may pick different ones. On
# 5,000 nodes one such pick is a large share of a gradient (up to 1e-4 of
# it on some seeds, CPU against CPU), a size at which the full-size
# limits do not hold; from 20,000 nodes the picks average out as on the
# cell's 169,343.
SMALL_NODES = {"arxiv_net": 20000, "mag_net": 5000}


# Cells whose files stay for a later PR that BENCHMARK.json does not list
# (PERF.md, Open questions): their end-to-end and per-layer metrics.
KEPT = {"mag_egc_sampled": (
    ["sampled_seeds_per_s", "peak_mem_gib", "setup_s"],
    ["loader_wait_share.sampled", "device_idle_share.sampled"])}


def _cell(name: str):
    """The cell ``name``: as BENCHMARK.json lists it, or a kept one from
    its workload file."""
    from gnnbench.cell import HERE, Cell, _json, load_cell
    if name not in KEPT:
        return load_cell(name)
    work = _json(HERE / "workloads" / f"{name}.json")
    e2e, per_layer = KEPT[name]
    return Cell(name=name,
                config=_json(HERE / "configs" / f"{work['config']}.json"),
                traffic=_json(HERE / "traffic" / f"{work['traffic']}.json"),
                workload=work, end_to_end=e2e, per_layer=per_layer,
                chips=work["chips"], root=HERE)


@pytest.fixture
def bench_cell():
    return _cell


@pytest.fixture
def small_cell():
    """A cell loaded from the benchmark's files, its graph cut to a size
    a CPU test holds (the widths as configured)."""

    def make(name: str):
        cell = _cell(name)
        cell.config["graph"].update(
            num_nodes=SMALL_NODES[cell.config["model"]], avg_degree=8)
        if cell.traffic["mode"] == "sampled":
            # 10,760 batch rows: past the bf16 path's 4,096
            cell.traffic.update(batch_size=512, fanouts=[5, 3])
        return cell
    return make
