"""Port parity for the experiment harness against the JAX package (CPU):
the hyperparameter space, the search strategies and the pruner, the
split accuracies, ``run_trial`` on ``ArxivConfig`` from the same weights,
the checkpoint round trips (``persist_trial`` / ``restore_trial`` /
``resume``), the summaries and the ogbn-arxiv reader.

``run_trial`` is held so: the train loss at rtol 1e-4, the plateau's lr
equal, and each split's accuracy within 2 / (the split's size), i.e. two
argmax ties that round the other way (on this graph they agree exactly).
"""

import gzip
import json
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from egc_tpu.data import ondisk as jondisk
from egc_tpu.data import synthetic as jsyn
from egc_tpu.exp import fullgraph as jfg
from egc_tpu.exp import hyperparams as jhp
from egc_tpu.exp import runner as jrunner
from egc_tpu.exp import search as jsearch
from egc_tpu.exp import summaries as jsum
from egc_tpu.train import metrics as jmetrics

from egc_tpu_torch.data import ondisk as tondisk
from egc_tpu_torch.data import synthetic as tsyn
from egc_tpu_torch.exp import fullgraph as tfg
from egc_tpu_torch.exp import hyperparams as thp
from egc_tpu_torch.exp import runner as trunner
from egc_tpu_torch.exp import search as tsearch
from egc_tpu_torch.exp import summaries as tsum
from egc_tpu_torch.exp.weight_port import arxiv_state_dict_from_jax
from egc_tpu_torch.train import metrics as tmetrics

torch.set_num_threads(2)
HP = {"lr": 0.01, "wd": 5e-4, "dropout": 0.0}


def space(mod):
    return {"lr": mod.LogUniformHyperParam(1e-4, 1e-2, default=1e-3),
            "bs": mod.ChoiceHyperParam([32, 64, 128]),
            "u": mod.UniformHyperParam(0.0, 1.0)}


def test_hyperparams_sample_as_the_jax_ones():
    tsp, jsp = space(thp), space(jhp)
    tr, jr = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(20):
        for k in tsp:
            assert tsp[k].sample(tr) == jsp[k].sample(jr), k
    for k in tsp:
        assert tsp[k].default() == jsp[k].default()
        for n in (1, 2, 5):
            np.testing.assert_array_equal(tsp[k].grid(n), jsp[k].grid(n))
    assert thp.default_hparams(tsp) == jhp.default_hparams(jsp)


def test_arxiv_search_candidates_equal_the_jax_ones():
    """The arxiv grid (10 x 2 x 2) and a random search of 7, array-equal
    to the JAX strategies' from the same seed."""
    tcfg = tfg.ArxivConfig("gcn", 16, device="cpu")
    jcfg = jfg.ArxivConfig("gcn", 16)
    tgrid = tcfg.search_strategy().generate(
        tcfg.hyperparams(), np.random.default_rng(0))
    jgrid = jcfg.search_strategy().generate(
        jcfg.hyperparams(), np.random.default_rng(0))
    assert len(tgrid) == len(jgrid) == 40
    for a, b in zip(tgrid, jgrid):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(list(a.values()), list(b.values()))
    trand = tsearch.RandomSearchStrategy(7).generate(
        tcfg.hyperparams(), np.random.default_rng(5))
    jrand = jsearch.RandomSearchStrategy(7).generate(
        jcfg.hyperparams(), np.random.default_rng(5))
    assert trand == jrand
    assert tcfg.default_hparams() == jcfg.default_hparams()
    assert tcfg.plateau(HP) == tuple(jcfg.plateau(HP))
    assert tcfg.stoppers() == tfg.StopperSpec(80, 1000)
    assert jcfg.stoppers().patience == 80
    assert tcfg.settings().final_max_iterations == 1000
    assert tcfg.trial_scheduler() is None


@pytest.mark.parametrize("mode", ["min", "max"])
def test_pruner_decisions_equal_the_jax_ones(mode):
    rng = np.random.default_rng(9)
    scores = rng.random((12, 60))
    tp = tsearch.AsyncHyperBandPruner(mode, grace_period=3,
                                      reduction_factor=2, max_t=50)
    jp = jsearch.AsyncHyperBandPruner(mode, grace_period=3,
                                      reduction_factor=2, max_t=50)
    decisions = []
    for trial in scores:
        tp.start_trial()
        jp.start_trial()
        for it, v in enumerate(trial):
            d = tp(it, float(v))
            assert d == jp(it, float(v)), (it, v)
            decisions.append(d)
            if d:
                break
    assert any(decisions) and not all(decisions)
    assert tp.rungs == jp.rungs == [3, 6, 12, 24, 48]


def test_split_accuracies_match_jax():
    rng = np.random.default_rng(2)
    out = rng.normal(size=(90, 6)).astype(np.float32)
    out[:5, :2] = 1.0          # argmax ties: the first index wins
    y = rng.integers(0, 6, 90)
    masks = {k: rng.random(90) < p for k, p in
             (("train", 0.5), ("val", 0.3), ("test", 0.0))}
    ref = jmetrics.split_accuracies(jnp.asarray(out), jnp.asarray(y),
                                    {k: jnp.asarray(v)
                                     for k, v in masks.items()})
    got = tmetrics.split_accuracies(torch.as_tensor(out),
                                    torch.as_tensor(y),
                                    {k: torch.as_tensor(v)
                                     for k, v in masks.items()})
    assert got == ref and got["test_acc"] == 0.0


def small_raw(mod):
    return mod.synthetic_full_graph(num_nodes=400, avg_degree=8,
                                    num_classes=10, num_features=32, seed=4)


SPLIT_SIZES = {"train": 240, "val": 80, "test": 80}


class JaxSmallArxiv(jfg.ArxivConfig):
    def load_full_graph(self):
        return small_raw(jsyn)


class SmallArxiv(tfg.ArxivConfig):
    """The port's ArxivConfig on the small graph; ``weights``, where set,
    replace the seeded init (the JAX run's, through the weight port)."""

    weights = None

    def load_full_graph(self):
        return small_raw(tsyn)

    def model(self, hparams, *, seed=0):
        m = super().model(hparams, seed=seed)
        if self.weights is not None:
            m.load_state_dict(self.weights, strict=True)
        return m


@pytest.mark.parametrize("kind", ["sage", "pna"])
def test_run_trial_matches_jax(kind):
    """Three iterations of ``run_trial`` on both packages from the same
    weights (hidden 16, dropout 0; PNA reads the data's avg_log_deg, so
    data comes before the model on both sides)."""
    jcfg = JaxSmallArxiv(kind, 16)
    jres = jrunner.run_trial(jcfg, HP, seed=0, max_iterations=3,
                             patience=10, verbose=False)
    # the JAX trial's initial weights: its init_state's draw
    init = jres["model"].init(jcfg.rng(0), jres["data"]["graph"],
                              train=False)
    cfg = SmallArxiv(kind, 16, device="cpu")
    cfg.weights = arxiv_state_dict_from_jax(jax.tree.map(np.asarray, init),
                                            kind=kind)
    res = trunner.run_trial(cfg, HP, seed=0, max_iterations=3, patience=10,
                            verbose=False)
    assert cfg._avg_log_deg == jcfg._avg_log_deg
    assert [h["iteration"] for h in res["history"]] == [0, 1, 2]
    for a, b in zip(res["history"], jres["history"]):
        assert a.keys() == b.keys()
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=1e-4)
        assert a["lr"] == b["lr"]
        for s, size in SPLIT_SIZES.items():
            assert abs(a[f"{s}_acc"] - b[f"{s}_acc"]) <= 2 / size + 1e-7
    assert res["best_iter"] == jres["best_iter"]
    assert res["test"].keys() == jres["test"].keys()
    assert int(jres["state"].step) == 3


@pytest.fixture()
def trained(tmp_path):
    cfg = SmallArxiv("gcn", 16, device="cpu")
    res = trunner.run_trial(cfg, HP, seed=1, max_iterations=3, patience=10,
                            trial_dir=tmp_path / "t", verbose=False)
    return cfg, res, tmp_path / "t"


def test_persist_and_restore_trial(trained):
    """The trial directory holds the reference's payload (``model``,
    ``opt``, ``step``) and the JAX package's meta; ``restore_trial`` gives
    the model, optimizer and plateau back, and the recorded accuracies."""
    cfg, res, d = trained
    payload = torch.load(d / "checkpoint.pt", weights_only=True)
    assert set(payload) == {"model", "opt", "step"}
    assert payload["step"] == 3
    assert set(payload["model"]) == set(res["model"].state_dict())
    meta = json.loads((d / "checkpoint.json").read_text())
    assert set(meta) == {"hparams", "plateau", "extra"}
    assert meta["hparams"] == HP and len(meta["plateau"]) == 8
    assert meta["extra"] == {"iteration": 2}
    result = json.loads((d / "result.json").read_text())
    assert set(result) == {"best_val", "best_iter", "test", "hparams"}
    assert len(json.loads((d / "history.json").read_text())) == 3

    model, state, plateau, hp, data = cfg.restore_trial(d, seed=7)
    assert hp == HP and plateau.lr == res["history"][-1]["lr"]
    assert cfg.val(model, state, data) == result["test"]
    for k, v in res["model"].state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert state.state_dict()["state"].keys() == \
        res["state"].state_dict()["state"].keys()
    assert state.param_groups[0]["lr"] == plateau.lr


def test_resume_continues_the_trial(trained, tmp_path):
    """Resuming a 3-iteration trial to 5 gives iterations 3 and 4 of a
    straight 5-iteration run (dropout 0, the same weights). A CPU step is
    not bitwise reproducible (threaded reductions move the weights by
    ~1e-8), so the accuracies are held as in ``run_trial``'s test."""
    cfg, _, d = trained
    res = trunner.run_trial(cfg, HP, seed=1, max_iterations=5, patience=10,
                            trial_dir=d, resume=True, verbose=False)
    straight = trunner.run_trial(cfg, HP, seed=1, max_iterations=5,
                                 patience=10, verbose=False)
    assert [h["iteration"] for h in res["history"]] == [3, 4]
    for a, b in zip(res["history"], straight["history"][3:]):
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=1e-5)
        assert a["lr"] == b["lr"]
        for s, size in SPLIT_SIZES.items():
            assert abs(a[f"{s}_acc"] - b[f"{s}_acc"]) <= 2 / size + 1e-7


def test_plateau_cuts_the_optimizer_lr():
    cfg = SmallArxiv("gcn", 16, device="cpu")
    model = cfg.model(HP)
    opt = cfg.init_state(model, HP, None, 0)
    plateau = cfg.plateau(HP)._replace(patience=0)
    opt, plateau = cfg.apply_plateau(opt, plateau, {"val_acc": 0.5})
    opt, plateau = cfg.apply_plateau(opt, plateau, {"val_acc": 0.4})
    assert plateau.lr == 0.005 and opt.param_groups[0]["lr"] == 0.005
    g = cfg.rng(3)
    assert isinstance(g, torch.Generator) and g.device.type == "cpu"


def test_final_models_and_summaries(tmp_path):
    """``train_final_models`` writes the JAX package's files and keys; the
    summaries equal the JAX ones on the same rows."""
    cfg = SmallArxiv("gcn", 16, device="cpu")
    cfg.settings = lambda: tfg.ExperimentSettings(
        "arxiv", final_repeats=2, final_max_iterations=2)
    cfg.stoppers = lambda: tfg.StopperSpec(patience=5, max_iters=2)
    summary = trunner.train_final_models(cfg, HP, tmp_path, verbose=False)
    assert set(summary) == {"hparams", "repeats", "train_acc", "val_acc",
                            "test_acc"}
    assert set(summary["val_acc"]) == {"mean", "std", "values"}
    for rep in (0, 1):
        assert (tmp_path / "final" / f"run_{rep}" / "result.json").exists()
    assert (tmp_path / "curves.csv").exists()
    assert (tmp_path / "test_metric_summaries.json").exists()

    hist = [[{"iteration": i, "train_loss": 1.0 / (i + 1 + r),
              "val_acc": 0.1 * i} for i in range(3)] for r in range(2)]
    tests = [{"a": 0.5, "b": 0.25}, {"a": 0.75, "b": 0.5}]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tsum.TrialCurvePlotter(["train_loss", "val_acc"])(hist, tmp_path / "t")
    jsum.TrialCurvePlotter(["train_loss", "val_acc"])(hist, tmp_path / "j")
    assert (tmp_path / "t" / "curves.csv").read_text() == \
        (tmp_path / "j" / "curves.csv").read_text()
    assert tsum.TestMetricSummaries()(tests, tmp_path / "t") == \
        jsum.TestMetricSummaries()(tests, tmp_path / "j")


def test_run_search_picks_the_best(tmp_path):
    """An in-process grid of two lr values, two iterations each."""
    cfg = SmallArxiv("sage", 16, device="cpu")
    cfg.stoppers = lambda: tfg.StopperSpec(patience=5, max_iters=2)
    strategy = tsearch.GridSearchStrategy({"lr": 2})
    best = tsearch.run_search(cfg, tmp_path, strategy=strategy,
                              verbose=False)
    res = json.loads((tmp_path / "search_results.json").read_text())
    assert len(res["results"]) == 2 and res["best"] == best
    vals = [r["best_val"] for r in res["results"]]
    assert best == res["results"][int(np.argmax(vals))]["hparams"]


def write_csv_gz(path, arr, fmt="%d"):
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        np.savetxt(f, np.asarray(arr), delimiter=",", fmt=fmt)


def test_load_ogbn_arxiv_matches_jax(tmp_path, monkeypatch):
    """A tiny OGB-layout ogbn-arxiv, read by both readers (each from its
    own copy, so neither reads the other's ``.npy`` cache), then again
    by the port from its cache."""
    root = tmp_path / "a" / "ogbn_arxiv"
    rng = np.random.default_rng(0)
    n = 30
    write_csv_gz(root / "raw" / "edge.csv.gz", rng.integers(0, n, (70, 2)))
    write_csv_gz(root / "raw" / "node-feat.csv.gz",
                 rng.normal(size=(n, 5)), fmt="%.6f")
    write_csv_gz(root / "raw" / "node-label.csv.gz",
                 (np.arange(n) % 4).reshape(-1, 1))
    sd = root / "split" / "time"
    write_csv_gz(sd / "train.csv.gz", np.arange(18).reshape(-1, 1))
    write_csv_gz(sd / "valid.csv.gz", np.arange(18, 24).reshape(-1, 1))
    write_csv_gz(sd / "test.csv.gz", np.arange(24, 30).reshape(-1, 1))
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    ref = jondisk.load_ogbn_arxiv(tmp_path / "b")
    monkeypatch.setenv("DATASET_LOC", str(tmp_path / "a"))
    assert tondisk.data_location() == tmp_path / "a"
    for _ in range(2):     # the second read comes from the .npy caches
        got = tondisk.load_ogbn_arxiv()
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
    assert (root / "raw" / "node-feat.csv.gz.npy").exists()


def test_csv_rows_must_agree(tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text("1,2\n3\n4,5,6\n")
    with pytest.raises(ValueError, match="fields"):
        tondisk._read_csv_gz(p)
    p.write_text("1,2\n3,x\n")
    with pytest.raises(ValueError, match="number"):
        tondisk._read_csv_gz(p)
