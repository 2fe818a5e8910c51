"""Every cell run on the CPU at a small size (the harness's look for a
card skipped; the widths as configured) is correct; with the program
broken underneath it is not: a step that returns its state unchanged,
half the batch left out, the loss altered where it is produced, and the
control, the program's own bf16 matmuls in place of the float32 the
configurations state. (The exchange between chips is no fault here:
every cell runs on one.) The control is left out of the sampled cell on
the CPU: the bf16 path needs a kernel plan, which a sampled batch gets on
the card only. The ``card`` tests hold the control to the same at the
cells' own sizes on the chip."""

import pytest

from gnnbench.harness import run_cell

CELLS = ("arxiv_egcm_full", "arxiv_egcm_trial", "mag_egc_full",
         "mag_egc_sampled")            # the last kept for a later PR
FAULTS = ("frozen", "half_batch", "altered", "control")


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, small_cell):
    res = run_cell(small_cell(name), 2 ** 31 + 5, 0.2, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == set(small_cell(name).end_to_end)


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS for fault in FAULTS
    if (name, fault) != ("mag_egc_sampled", "control")])
def test_a_broken_run_is_not_correct(name, fault, small_cell):
    res = run_cell(small_cell(name), 2 ** 31 + 7, 0.0, False, "cpu",
                   fault=fault)
    assert not res["correct"], res["checks"]


def test_a_traced_run_reads_its_per_layer_metrics(small_cell):
    res = run_cell(small_cell("mag_egc_sampled"), 2 ** 31 + 9, 0.2, True,
                   "cpu")
    assert res["correct"]
    assert "loader_wait_share.sampled" in res["metrics"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_own_size(name, card, bench_cell):
    cell = bench_cell(name)
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        assert run_cell(cell, seed, 0.0, False, card)["correct"]
        res = run_cell(cell, seed, 0.0, False, card, fault="control")
        assert not res["correct"], res["checks"]
