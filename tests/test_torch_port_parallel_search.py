"""The port's trial-parallel search (``egc_tpu_torch.exp.parallel_search``,
counterpart of ``egc_tpu.exp.parallel_search``) on the CPU.

A toy config makes the trials cheap and deterministic: its val loss is a
function of the learning rate and the iteration, so the successive-
halving pruner has something to cut. With one worker, the shared rung
table must make the sequential search's decisions (the same trials
pruned at the same iterations, the same best); with two, every candidate
lands in ``search_results.json``. Each search runs under a 120 s
timeout, so a hung worker fails.
"""

import ast
import json
import math
import multiprocessing
import os

import pytest
import torch

from egc_tpu_torch.exp import parallel_search as ps
from egc_tpu_torch.exp.config import (
    ExperimentConfig, ExperimentSettings, Metric, StopperSpec,
    TrialResources,
)
from egc_tpu_torch.exp.hyperparams import LogUniformHyperParam
from egc_tpu_torch.exp.search import (
    AsyncHyperBandPruner, RandomSearchStrategy, run_search,
)

SAMPLES = 8
SPEC = (__name__, "ToyConfig", (), {})


class ToyConfig(ExperimentConfig):
    """A trial of up to 8 iterations whose val loss falls with the
    iteration and is least at lr = 0.05; pruned by successive halving
    (grace 1, reduction 2: rungs 1, 2, 4). ``test`` gives the iterations
    the trial ran."""

    def __init__(self, device=None):
        self.device = torch.device(device or "cpu")
        self.iters = 0

    def settings(self):
        return ExperimentSettings("toy", final_max_iterations=8)

    def stoppers(self):
        return StopperSpec(patience=100, max_iters=8)

    def trial_metric(self):
        return Metric("val_loss", "min")

    def hyperparams(self):
        return {"lr": LogUniformHyperParam(1e-3, 1.0, default=0.1)}

    def search_strategy(self):
        return RandomSearchStrategy(SAMPLES)

    def trial_scheduler(self):
        return AsyncHyperBandPruner("min", grace_period=1,
                                    reduction_factor=2, max_t=8)

    def resource_requirements(self):
        return TrialResources(cpus=1)

    def data(self, hparams):
        return None

    def model(self, hparams, *, seed=0):
        return torch.nn.Linear(1, 1)

    def init_state(self, model, hparams, data, seed):
        self.iters = 0
        self.lr = hparams["lr"]
        return super().init_state(model, hparams, data, seed)

    def train(self, model, state, data, rng, iteration):
        self.iters += 1
        return state, {"train_loss": 0.0}

    def val(self, model, state, data):
        return {"val_loss": math.log(self.lr / 0.05) ** 2
                + 1.0 / self.iters}

    def test(self, model, state, data):
        return {"iters": self.iters}


def candidates():
    import numpy as np
    cfg = ToyConfig()
    return cfg.search_strategy().generate(cfg.hyperparams(),
                                          np.random.default_rng(0))


def search(workers, exp_dir):
    cfg = ToyConfig()
    metric = cfg.trial_metric()
    return ps.run_search_parallel(
        SPEC, candidates(), metric_mode=metric.mode,
        metric_name=metric.name, num_workers=workers, exp_dir=exp_dir,
        worker_device="cpu", resources=cfg.resource_requirements(),
        scheduler=cfg.trial_scheduler())


def run_bounded(fn, *args):
    """``fn(*args)`` in a thread pool of one, failing after 120 s."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as pool:
        return pool.submit(fn, *args).result(timeout=120)


def test_one_worker_makes_the_sequential_decisions(tmp_path):
    """One worker against ``exp.search.run_search`` on the same candidates
    and seeds: each trial's iterations (a pruned trial stops at its
    rung), best value and best iteration, and the best hyperparameters."""
    seq_cfg = ToyConfig()
    seq_iters = []
    orig_test = seq_cfg.test
    seq_cfg.test = lambda *a: (seq_iters.append(seq_cfg.iters),
                               orig_test(*a))[1]
    best_seq = run_search(seq_cfg, tmp_path / "seq", verbose=False)
    best_par = run_bounded(search, 1, tmp_path / "par")
    seq = json.loads((tmp_path / "seq" / "search_results.json").read_text())
    par = json.loads((tmp_path / "par" / "search_results.json").read_text())
    assert best_par == best_seq == seq["best"] == par["best"]
    assert [r["hparams"] for r in par["results"]] == \
        [r["hparams"] for r in seq["results"]] == candidates()
    for a, b in zip(par["results"], seq["results"]):
        assert (a["best_val"], a["best_iter"]) == \
            (b["best_val"], b["best_iter"])
    iters = [r["test"]["iters"] for r in par["results"]]
    assert iters == seq_iters
    assert [r["pruned"] for r in par["results"]] == [i < 8 for i in iters]
    assert any(i < 8 for i in iters) and 8 in iters


def test_two_workers_write_every_candidate(tmp_path):
    """Two workers: ``search_results.json`` holds one result a candidate,
    in order, with the JAX module's keys, and the best of them."""
    best = run_bounded(search, 2, tmp_path)
    res = json.loads((tmp_path / "search_results.json").read_text())
    assert [r["hparams"] for r in res["results"]] == candidates()
    for r in res["results"]:
        assert set(r) == {"hparams", "best_val", "best_iter", "test",
                          "pruned"}
    assert best == res["best"] == min(
        res["results"], key=lambda r: r["best_val"])["hparams"]


def test_shared_rungs_prune_as_the_pruner():
    """``SharedRungs.report`` against ``AsyncHyperBandPruner`` on one
    stream of (iteration, best-so-far) reports."""
    ahb = AsyncHyperBandPruner("min", grace_period=1, reduction_factor=2,
                               max_t=8)
    with multiprocessing.get_context("spawn").Manager() as manager:
        shared = ps.make_shared_rungs(manager, ahb, "min")
        assert sorted(shared.rungs) == ahb.rungs == [1, 2, 4]
        for trial, vals in enumerate([[5, 4, 3, 2, 1], [1, 1, 1, 1, 1],
                                      [9, 8, 7, 6, 5], [0.5, 3, 2, 1, 0]]):
            ahb.start_trial()
            best = float("inf")
            for it, v in enumerate(vals):
                best = min(best, v)
                assert shared.report(it, best) == ahb(it, v), (trial, it)


def test_workers_are_capped_at_the_cores(monkeypatch, tmp_path):
    """``resources.cpus`` caps the workers: with a trial needing every
    core, one worker runs all candidates."""
    seen = []
    real = ps.ProcessPoolExecutor

    def pool(max_workers, mp_context):
        seen.append(max_workers)
        return real(max_workers=max_workers, mp_context=mp_context)

    monkeypatch.setattr(ps, "ProcessPoolExecutor", pool)
    run_bounded(lambda: ps.run_search_parallel(
        SPEC, candidates()[:2], metric_mode="min", metric_name="val_loss",
        num_workers=4, exp_dir=tmp_path, worker_device="cpu",
        resources=TrialResources(cpus=os.cpu_count() or 1)))
    assert seen == [1]
    assert len(json.loads((tmp_path / "search_results.json").read_text())
               ["results"]) == 2


def test_a_failing_worker_fails_the_search(tmp_path):
    """A trial that raises in its worker raises here."""
    bad = (__name__, "ToyConfig", (), {"no_such_option": 1})
    with pytest.raises(TypeError):
        run_bounded(lambda: ps.run_search_parallel(
            bad, candidates()[:1], metric_mode="min",
            metric_name="val_loss", num_workers=1, worker_device="cpu"))


STUB_NVCC = """#!/bin/sh
# records its parent (the building process) and its target, then builds
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "$PPID $out" >> "$STUB_LOG"
echo "built by $PPID"
sleep 0.5
echo stub > "$out"
"""

BUILD = """import sys
from pathlib import Path
from egc_tpu_torch.ops.cuda import _build
_build.BUILD_DIR = Path(sys.argv[1])
print(sorted(p.name for p in _build.build_all().values()))
"""


def test_build_lock_compiles_each_source_once(tmp_path):
    """Two processes run ``_build.build_all`` on one cold build directory
    at once, with a stub ``nvcc`` on ``CUDA_HOME``: each source is
    compiled once, by one process, whose output is its ``.log``; both
    get the same libraries and no temporary file is left."""
    import subprocess
    import sys
    from pathlib import Path

    from egc_tpu_torch.ops.cuda import _build
    (tmp_path / "cuda" / "bin").mkdir(parents=True)
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.write_text(STUB_NVCC)
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    env = {**os.environ, "CUDA_HOME": str(tmp_path / "cuda"),
           "STUB_LOG": str(tmp_path / "calls")}
    repo = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(build)],
                              env=env, cwd=repo, stdout=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0] == outs[1]
    sources = sorted(_build.CSRC.glob("*.cu"))
    calls = [line.split() for line in
             (tmp_path / "calls").read_text().splitlines()]
    assert len(calls) == len(sources)
    compiling = {pid for pid, _ in calls}
    assert len(compiling) == 1 and compiling <= {str(p.pid) for p in procs}
    libs = sorted(build.glob("*.so"))
    assert [p.name for p in libs] == ast.literal_eval(outs[0])
    assert len(libs) == len(sources)
    for lib in libs:
        assert lib.read_text() == "stub\n"
        assert lib.with_suffix(".log").read_text() == \
            f"built by {calls[0][0]}\n"
    assert not list(build.glob("*.tmp*"))
