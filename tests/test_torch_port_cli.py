"""The port's command line, ``python -m egc_tpu_torch`` (``cli.py``),
against the JAX package's ``main.py``: the same options and defaults,
``--check`` of all nine kinds on the CPU and of every other dataset,
rmag's config, sampled mag's, the final runs' files, ``--pretrained``,
``--partitions`` (arxiv and rmag) and ``--search-workers`` on the CPU,
and the exit code of a usage error."""

import ast
import contextlib
import io
import json
import pathlib
import subprocess
import sys

import pytest
import torch

import main as jmain

from egc_tpu_torch import cli

torch.set_num_threads(2)
EGC = ["--aggrs", "symnorm,max,mean", "--egc-num-heads", "4",
       "--egc-num-bases", "4"]


def run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


def test_parser_takes_every_option_of_main():
    """Every click parameter of ``main.main`` by name, flags and default;
    ``--device`` is the one option more."""
    actions = {}
    for a in cli.build_parser()._actions:     # the first of each dest
        if a.dest != "help":
            actions.setdefault(a.dest, a)
    for p in jmain.main.params:
        if p.param_type_name == "argument":
            assert actions[p.name].option_strings == [], p.name
            continue
        a = actions[p.name]
        assert set(p.opts) <= set(a.option_strings), p.name
        assert a.default == p.default, p.name
        for flag in p.secondary_opts:          # --synthetic/--real
            off = [b for b in cli.build_parser()._actions
                   if flag in b.option_strings]
            assert off and off[0].dest == p.name and off[0].const is False
    names = {p.name for p in jmain.main.params}
    assert set(actions) - names == {"device"}
    assert actions["device"].default is None
    positional = [a.dest for a in cli.build_parser()._actions
                  if not a.option_strings]
    assert positional == ["exp_directory", "model", "dataset"]
    assert cli.MODELS == jmain.MODELS and cli.DATASETS == jmain.DATASETS
    assert cli.SUPPORTED == jmain.SUPPORTED


@pytest.mark.parametrize("model", cli.MODELS)
def test_check_runs_each_kind_on_the_cpu(tmp_path, model):
    """``--check --check-epochs 2 --hidden 16 --device cpu`` prints the
    dict ``main.py`` prints: best_val, best_iter and the test metrics."""
    argv = [str(tmp_path), model, "arxiv", "--hidden", "16", "--check",
            "--check-epochs", "2", "--device", "cpu"]
    if model == "egc":
        argv += EGC
    res = ast.literal_eval(run_cli(argv).strip().splitlines()[-1])
    assert set(res) == {"best_val", "best_iter", "test"}
    assert set(res["test"]) == {"train_acc", "val_acc", "test_acc"}
    assert res["best_iter"] in (0, 1) and 0.0 <= res["best_val"] <= 1.0


def test_final_runs_write_the_jax_keys(tmp_path, monkeypatch):
    """``--use-default-hparams --final-runs 2`` (each run cut to 3
    iterations): ``final_summary.json`` with the JAX package's keys, a
    trial directory per run, and the invocation."""
    from egc_tpu_torch.exp import fullgraph as tfg
    monkeypatch.setattr(tfg.ArxivConfig, "stoppers",
                        lambda self: tfg.StopperSpec(80, 3))
    argv = [str(tmp_path), "sage", "arxiv", "--hidden", "8",
            "--use-default-hparams", "--final-runs", "2", "--device", "cpu"]
    out = run_cli(argv)
    assert "Using default hyperparams:" in out
    summary = json.loads((tmp_path / "final_summary.json").read_text())
    assert set(summary) == {"hparams", "repeats", "train_acc", "val_acc",
                            "test_acc"}
    assert summary["repeats"] == 2
    assert summary["hparams"] == {"lr": 0.01, "wd": 0.0005, "dropout": 0.2}
    assert len(summary["val_acc"]["values"]) == 2
    for rep in (0, 1):
        d = tmp_path / "final" / f"run_{rep}"
        assert (d / "checkpoint.pt").exists()
        assert len(json.loads((d / "history.json").read_text())) == 3
    inv = json.loads((tmp_path / "invocation.json").read_text())
    assert inv["argv"][-len(argv):] == argv


def test_hparams_are_a_literal(tmp_path):
    with pytest.raises(ValueError):
        cli.main([str(tmp_path), "gcn", "arxiv", "--hidden", "8",
                  "--hparams", "__import__('os')", "--device", "cpu"])


@pytest.mark.parametrize("argv", [["gcn", "code"], ["egc", "zinc"],
                                  ["gcn", "hiv"], ["egc", "cifar"],
                                  ["egc", "mag"],
                                  ["egc", "mag", "--sampled"],
                                  ["egc", "mag", "--device-sampler"]])
def test_check_runs_each_dataset_on_the_cpu(tmp_path, argv):
    """``--check --check-epochs 1 --device cpu`` at width 8 on the batched
    datasets and homogeneous mag (synthetic data): the dict ``main.py``
    prints, with finite metrics of the dataset's config."""
    full = [str(tmp_path)] + argv + ["--hidden", "8", "--aggrs", "symnorm",
                                      "--check", "--check-epochs", "1",
                                      "--device", "cpu"]
    res = ast.literal_eval(run_cli(full).strip().splitlines()[-1])
    assert set(res) == {"best_val", "best_iter", "test"}
    assert res["best_iter"] == 0
    split = "test" if argv[1] != "mag" else "val"
    assert any(k.startswith(split) for k in res["test"])
    values = [res["best_val"], *res["test"].values()]
    assert all(v == v and abs(v) < 1e6 for v in values), res


@pytest.mark.parametrize("argv,item", [
    (["egc", "rmag", "--partitions", "2"], "A16"),
])
def test_out_of_scope_raises_with_its_roadmap_item(tmp_path, capfd, argv,
                                                   item):
    """What ROADMAP.md ``item`` ported runs: ``rmag --partitions 2 --check
    --check-epochs 1 --device cpu`` (2 gloo ranks the command spawns)
    prints one result, the dict ``main.py`` prints, from rank 0."""
    full = [str(tmp_path)] + argv + ["--hidden", "8", "--check",
                                      "--check-epochs", "1", "--device",
                                      "cpu"]
    cli.main(full)
    lines = capfd.readouterr().out.strip().splitlines()
    assert sum(line.startswith("{'best_val'") for line in lines) == 1
    res = ast.literal_eval(lines[-1])
    assert set(res) == {"best_val", "best_iter", "test"}
    assert res["best_iter"] == 0
    assert all(0.0 <= v <= 1.0 for v in [res["best_val"],
                                         *res["test"].values()])


def _pretrained_run(tmp_path, monkeypatch):
    """A checkpoint.pt of the published gcn arxiv width (h156); the
    printed model and accuracies are the in-process eval's."""
    from egc_tpu_torch.exp.fullgraph import ArxivConfig
    cfg = ArxivConfig("gcn", 156, device="cpu")
    hp = cfg.default_hparams()
    data = cfg.data(hp)
    model = cfg.model(hp, seed=3)
    torch.save(model.state_dict(), tmp_path / "checkpoint.pt")
    out = run_cli([str(tmp_path), "gcn", "arxiv", "--hidden", "156",
                   "--pretrained", "--device", "cpu"])
    assert "ArxivNet(" in out and "GCNConv(" in out
    got = ast.literal_eval(out.strip().splitlines()[-1])
    ref = cfg.test(model, None, data)
    assert got.keys() == ref.keys()
    for k in ref:      # two argmax ties may round the other way
        assert abs(got[k] - ref[k]) <= 2 / 800 + 1e-7, k


def _partitions_run(tmp_path, monkeypatch):
    """Four gloo ranks started by the command: one trial line and one
    result dict, from rank 0."""
    res = subprocess.run(
        [sys.executable, "-m", "egc_tpu_torch", str(tmp_path), "gcn",
         "arxiv", "--hidden", "8", "--partitions", "4", "--check",
         "--check-epochs", "1", "--device", "cpu"],
        capture_output=True, text=True, timeout=120,
        cwd=pathlib.Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert sum(line.startswith("[arxiv] trial") for line in lines) == 1
    got = ast.literal_eval(lines[-1])
    assert set(got) == {"best_val", "best_iter", "test"}
    assert got["best_iter"] == 0 and 0.0 <= got["best_val"] <= 1.0


def _search_workers_run(tmp_path, monkeypatch):
    """Two workers on the CPU, the grid cut to its first two candidates
    at two iterations each (and the final run to two): the best printed,
    ``search_results.json`` with both candidates, the final summary."""
    from egc_tpu_torch.exp import fullgraph as tfg
    from egc_tpu_torch.exp import parallel_search as ps
    real = ps.run_search_parallel
    seen = {}

    def cut(spec, candidates, **kw):
        seen.update(spec=spec, workers=kw["num_workers"],
                    device=kw["worker_device"])
        return real(spec, candidates[:2], max_iterations=2, **kw)

    monkeypatch.setattr(ps, "run_search_parallel", cut)
    monkeypatch.setattr(tfg.ArxivConfig, "stoppers",
                        lambda self: tfg.StopperSpec(80, 2))
    out = run_cli([str(tmp_path), "gcn", "arxiv", "--hidden", "8",
                   "--search-workers", "2", "--final-runs", "1",
                   "--device", "cpu"])
    assert seen["spec"][:3] == ("egc_tpu_torch.cli", "build_config",
                                ("arxiv", "gcn"))
    assert seen["workers"] == 2 and seen["device"] == "cpu"
    res = json.loads((tmp_path / "search_results.json").read_text())
    assert len(res["results"]) == 2
    assert "Best hparams:" in out
    assert res["best"] in [r["hparams"] for r in res["results"]]
    assert (tmp_path / "final_summary.json").exists()


def _cut_rank(mesh, argv, pretrained):
    """A rank of ``--partitions`` with the arxiv search cut to its first
    two grid points at two iterations each (the final run too)."""
    from egc_tpu_torch.exp import fullgraph as tfg
    from egc_tpu_torch.exp import search as tsearch
    grid = tsearch.GridSearchStrategy.generate
    tsearch.GridSearchStrategy.generate = \
        lambda self, space, rng: grid(self, space, rng)[:2]
    tfg.ArxivConfig.stoppers = lambda self: tfg.StopperSpec(80, 2)
    cli._partition_rank(mesh, argv, pretrained)


def _partitioned_search(tmp_path, monkeypatch, capfd, workers):
    """``gcn arxiv --hidden 8 --partitions 2 --search-workers W
    --num-samples 2 --final-runs 1 --device cpu`` through ``cli.main``,
    its two gloo ranks running ``_cut_rank``: what rank 0 printed."""
    from egc_tpu_torch.parallel import mesh as tmesh
    spawn = getattr(tmesh.spawn, "original", tmesh.spawn)

    def cut(fn, world_size, **kw):
        assert fn is cli._partition_rank and world_size == 2
        return spawn(_cut_rank, world_size, timeout=240, **kw)

    cut.original = spawn
    monkeypatch.setattr(tmesh, "spawn", cut)
    capfd.readouterr()
    cli.main([str(tmp_path), "gcn", "arxiv", "--hidden", "8",
              "--partitions", "2", "--search-workers", str(workers),
              "--num-samples", "2", "--final-runs", "1", "--device", "cpu"])
    return capfd.readouterr().out


def test_partitions_run_the_search_of_search_workers(tmp_path, monkeypatch,
                                                     capfd):
    """``--partitions 2 --search-workers 2``: the two gloo ranks run the
    trials in turn through the in-process search and say so once; rank 0
    writes EXP_DIR (the search's two candidates, the final run) and the
    other rank nothing there; the search is the one ``--search-workers 1``
    runs (the same candidates in the same order, each trial's best val
    within two of 800 validation nodes, the same best)."""
    out = _partitioned_search(tmp_path / "w2", monkeypatch, capfd, 2)
    lines = out.splitlines()
    said = [line for line in lines if "the trials run in turn" in line]
    assert said == ["--search-workers 2 with --partitions 2: the trials run "
                    "in turn, each on all 2 ranks (the search of "
                    "--search-workers 1)"]
    assert sum(line.startswith("[search arxiv] trial") for line in lines) \
        == 2
    assert any(line.startswith("Best hparams:") for line in lines)
    got = json.loads((tmp_path / "w2" / "search_results.json").read_text())
    assert len(got["results"]) == 2
    assert got["best"] in [r["hparams"] for r in got["results"]]
    summary = json.loads((tmp_path / "w2" / "final_summary.json")
                         .read_text())
    assert summary["repeats"] == 1 and summary["hparams"] == got["best"]
    assert (tmp_path / "w2" / "final" / "run_0").is_dir()
    assert sorted(p.name for p in (tmp_path / "w2").iterdir()) == [
        "curves.csv", "curves.png", "final", "final_summary.json",
        "invocation.json", "search_results.json",
        "test_metric_summaries.json"]
    out = _partitioned_search(tmp_path / "w1", monkeypatch, capfd, 1)
    assert "the trials run in turn" not in out
    ref = json.loads((tmp_path / "w1" / "search_results.json").read_text())
    assert [r["hparams"] for r in got["results"]] == \
        [r["hparams"] for r in ref["results"]]
    for a, b in zip(got["results"], ref["results"]):
        assert abs(a["best_val"] - b["best_val"]) <= 2 / 800 + 1e-7
    assert got["best"] == ref["best"]


@pytest.mark.parametrize("run", [_pretrained_run, _partitions_run,
                                 _search_workers_run],
                         ids=["pretrained", "partitions", "search_workers"])
def test_harness_options_run_on_the_cpu(tmp_path, monkeypatch, run):
    """``--pretrained``, ``--partitions 4`` and ``--search-workers 2`` on
    arxiv with ``--device cpu``, each checked by what it printed or
    wrote."""
    run(tmp_path, monkeypatch)


@pytest.mark.parametrize("flags", [dict(sampled=True),
                                   dict(device_sampler=True)])
def test_sampled_options_build_the_config_of_main(flags):
    """``--sampled`` and ``--device-sampler`` (which implies it) give the
    SampledMagConfig of ``main.build_config``: its hidden, heads, bases,
    aggregators, fanouts, batch size and sampler, and the synthetic flag
    and sample count."""
    kw = dict(hidden=16, heads=None, bases=2, aggrs="symnorm,max",
              num_samples=3, synthetic=False, **flags)
    ref = jmain.build_config("mag", "egc", **kw)
    got = cli.build_config("mag", "egc", device="cpu", **kw)
    assert type(got).__name__ == type(ref).__name__ == "SampledMagConfig"
    for k in ("hidden", "heads", "bases", "aggrs", "fanouts", "batch_size",
              "device_sampler", "synthetic", "_num_samples"):
        assert getattr(got, k) == getattr(ref, k), k
    assert got.device_sampler == bool(flags.get("device_sampler"))
    assert (got.heads, got.bases, got.aggrs) == (8, 2, ("symnorm", "max"))


@pytest.mark.parametrize("argv,msg", [
    (["sage", "zinc"], "not supported"),
    (["egc", "arxiv", "--hidden", "8"], "--aggrs is required"),
    (["gcn", "arxiv"], "--hidden is required"),
    (["gcn", "arxiv", "--hidden", "8", "--sampled"], "mag dataset only"),
    (["gcn", "arxiv", "--partitions", "2"], "--hidden is required"),
])
def test_usage_errors(tmp_path, argv, msg):
    with pytest.raises(cli.UsageError, match=msg):
        cli.main([str(tmp_path)] + argv + ["--device", "cpu"])


def test_the_card_is_the_default(tmp_path, monkeypatch):
    """Without ``--device cpu`` and without a card, the command raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([str(tmp_path), "gcn", "arxiv", "--hidden", "8", "--check",
                  "--check-epochs", "1"])


def test_module_entry_point_exits_2_on_what_it_cannot_run(tmp_path):
    """A usage error (``rmag --sampled``: sampling is mag's) exits 2 with
    its message, before any training."""
    res = subprocess.run(
        [sys.executable, "-m", "egc_tpu_torch", str(tmp_path), "egc",
         "rmag", "--hidden", "8", "--sampled", "--device", "cpu"],
        capture_output=True, text=True, timeout=120,
        cwd=pathlib.Path(__file__).resolve().parents[1])
    assert res.returncode == 2
    assert "error: --sampled/--device-sampler apply to the mag dataset " \
        "only" in res.stderr
    assert "[rmag]" not in res.stdout


@pytest.mark.parametrize("opts,want", [
    ([], (4, 4)), (["--egc-num-heads", "2"], (2, 4)),
    (["--egc-num-heads", "8", "--egc-num-bases", "2"], (8, 2))])
def test_rmag_options_build_the_config_of_main(opts, want):
    """``rmag``'s options give the RMagConfig that ``main.build_config``
    gives: hidden, heads (default 4), bases (default 4), the synthetic
    flag and the sample count. ``main.py`` asks for ``--aggrs`` on every
    egc run, rmag's too, where no config reads it; the port does not."""
    heads = int(opts[1]) if opts else None
    bases = int(opts[3]) if len(opts) > 2 else None
    kw = dict(hidden=16, heads=heads, bases=bases, num_samples=7,
              synthetic=False)
    ref = jmain.build_config("rmag", "egc", aggrs="mean,max", **kw)
    for aggrs in ("mean,max", None):
        got = cli.build_config("rmag", "egc", aggrs=aggrs, device="cpu",
                               **kw)
        assert type(got).__name__ == type(ref).__name__ == "RMagConfig"
        assert (got.hidden, got.heads, got.bases, got.use_egc) == \
            (ref.hidden, ref.heads, ref.bases, ref.use_egc) == \
            (16, *want, True)
        assert (got.synthetic, got._num_samples) == \
            (ref.synthetic, ref._num_samples) == (False, 7)
        assert got.num_layers == ref.num_layers == 2
    with pytest.raises(cli.UsageError, match="not supported"):
        cli.build_config("rmag", "gcn", aggrs=None, device="cpu", **kw)


def test_rmag_partitions_raise_with_a16(tmp_path):
    """``rmag --partitions 2`` builds the ``PartitionedRMagConfig`` that
    ``main.build_config`` builds: hidden, heads (4), bases (4), the
    partition count, the synthetic flag and the sample count, on the
    rank's process group (here a two-rank ``Mesh`` that joins none);
    without one it raises."""
    from egc_tpu_torch.parallel.mesh import Mesh
    kw = dict(hidden=8, heads=None, bases=None, num_samples=1,
              partitions=2)
    ref = jmain.build_config("rmag", "egc", aggrs="mean,max", **kw)
    got = cli.build_config("rmag", "egc", aggrs=None, device="cpu",
                           mesh=Mesh(0, 2, torch.device("cpu"), "gloo"),
                           **kw)
    assert type(got).__name__ == type(ref).__name__ == \
        "PartitionedRMagConfig"
    assert (got.hidden, got.heads, got.bases, got.use_egc,
            got.partitions) == (ref.hidden, ref.heads, ref.bases,
                                ref.use_egc, ref.partitions) == \
        (8, 4, 4, True, 2)
    assert (got.synthetic, got._num_samples) == \
        (ref.synthetic, ref._num_samples)
    with pytest.raises(ValueError, match="process group"):
        cli.build_config("rmag", "egc", aggrs=None, device="cpu", **kw)


def test_rmag_check_runs_on_the_cpu(tmp_path):
    """``egc rmag --check --check-epochs 2 --device cpu`` on the synthetic
    set, without ``--aggrs``: the dict ``main.py`` prints, accuracies in
    [0, 1]."""
    out = run_cli([str(tmp_path), "egc", "rmag", "--hidden", "16",
                   "--egc-num-heads", "4", "--egc-num-bases", "2",
                   "--check", "--check-epochs", "2", "--device", "cpu"])
    res = ast.literal_eval(out.strip().splitlines()[-1])
    assert set(res) == {"best_val", "best_iter", "test"}
    assert set(res["test"]) == {"train_acc", "val_acc", "test_acc"}
    assert all(0.0 <= v <= 1.0 for v in [res["best_val"],
                                         *res["test"].values()])
