"""The port's ``--pretrained`` (``exp/pretrained.py``,
``exp.weight_port.restore_pretrained_pt``, ``cli.py``) against the JAX
package on the CPU.

``validate_pretrained`` must accept and refuse what JAX's does for every
row of the registry. A reference-format ``checkpoint.pt`` (a JAX
trial's variables through ``export_model_state``, saved with
``torch.save``) must give, through ``python -m egc_tpu_torch ...
--pretrained``, the test metrics JAX's ``restore_pretrained_pt`` gives:
arxiv EGC-M h136 H4 B4 (accuracies within two nodes of each split) and
zinc EGC-M h124 (the MAE at rtol 1e-5).
"""

import ast
import contextlib
import io
import types

import jax
import numpy as np
import pytest
import torch

import main as jmain
from egc_tpu.exp import pretrained as jpre
from egc_tpu.exp import runner as jrunner
from egc_tpu.exp.weight_port import (
    export_model_state, restore_pretrained_pt as jrestore,
)

from egc_tpu_torch import cli
from egc_tpu_torch.exp import pretrained as tpre
from egc_tpu_torch.exp.fullgraph import ArxivConfig

torch.set_num_threads(2)
MODELS = {"egc_s": "egc", "egc_m": "egc", "mpnn_max": "mpnn-max",
          "mpnn_add": "mpnn-sum"}


def run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


def outcome(fn):
    try:
        return fn()
    except ValueError as exc:
        return ("refused", str(exc))


def requests(entry):
    """The published architecture, then one field off at a time."""
    good = dict(hidden=entry.hidden, heads=entry.heads, bases=entry.bases,
                aggrs=tuple(sorted(entry.aggrs)) if entry.aggrs else None)
    yield good
    yield {**good, "hidden": entry.hidden + 8}
    if entry.heads is not None:
        yield {**good, "heads": entry.heads * 2}
        yield {**good, "bases": entry.bases + 1}
        yield {**good, "aggrs": good["aggrs"][:-1] + ("min",)}
        yield {**good, "aggrs": good["aggrs"] + ("var",)}


@pytest.mark.parametrize("dataset", ["zinc", "cifar", "hiv", "arxiv", "code",
                                     "mag"])
def test_validate_pretrained_agrees_with_jax(dataset):
    """Every registry row's own architecture and each one-field change, as
    a full-graph config (``hidden``, ``heads``, ``bases``, ``aggrs``) and
    as a batched one (a ``conv`` spec): the same registry key or the same
    refusal. ``mag`` has no row: both refuse."""
    assert tpre.PRETRAINED_CONF.keys() == jpre.PRETRAINED_CONF.keys()
    rows = jpre.PRETRAINED_CONF.get(dataset, {"egc_m": jpre.PretrainedEntry(
        128, 4, 4, ("sum",))})
    seen = set()
    for key, entry in rows.items():
        model = MODELS.get(key, key)
        for req in requests(entry):
            conv = types.SimpleNamespace(heads=req["heads"],
                                         bases=req["bases"],
                                         aggrs=req["aggrs"])
            for cfg in (types.SimpleNamespace(**req),
                        types.SimpleNamespace(hidden=req["hidden"],
                                              conv=conv)):
                got = outcome(lambda: tpre.validate_pretrained(
                    dataset, model, cfg))
                ref = outcome(lambda: jpre.validate_pretrained(
                    dataset, model, cfg))
                assert got == ref, (key, req)
                seen.add(got if isinstance(got, str) else got[0])
    assert ("refused" in seen) and (dataset == "mag") == (seen ==
                                                          {"refused"})


def _checkpoint(tmp_path, dataset, variables, **spec):
    sd = export_model_state(dataset, "egc", jax.tree.map(np.asarray,
                                                         variables), **spec)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               tmp_path / "checkpoint.pt")
    return tmp_path / "checkpoint.pt"


def test_pretrained_arxiv_egc_m_equals_jax(tmp_path):
    """Arxiv EGC-M h136 H4 B4 symadd/max/mean, the published row: two JAX
    iterations (so BatchNorm holds real statistics), exported as the
    reference's ``checkpoint.pt``; the port's ``--pretrained`` prints the
    model and the accuracies of JAX's ``restore_pretrained_pt`` + test."""
    egc = ["--egc-num-heads", "4", "--egc-num-bases", "4", "--aggrs",
           "symadd,max,mean"]
    jcfg = jmain.build_config("arxiv", "egc", hidden=136, heads=4, bases=4,
                              aggrs="symadd,max,mean", num_samples=1)
    jres = jrunner.run_trial(jcfg, {"lr": 0.01, "wd": 5e-4, "dropout": 0.0},
                             seed=0, max_iterations=2, verbose=False)
    state = jres["state"]
    pt = _checkpoint(tmp_path, "arxiv", {"params": state.params,
                                         "batch_stats": state.batch_stats},
                     heads=4, bases=4, aggrs=("symadd", "max", "mean"))
    jm, js, jd = jrestore(jcfg, "arxiv", pt)
    ref = jcfg.test(jm, js, jd)
    out = run_cli([str(tmp_path), "egc", "arxiv", "--hidden", "136"] + egc
                  + ["--pretrained", "--device", "cpu"])
    assert "ArxivNet(" in out and "EGConv(" in out
    got = ast.literal_eval(out.strip().splitlines()[-1])
    assert got.keys() == ref.keys()
    raw = ArxivConfig("egc", 136, device="cpu").load_full_graph()
    for split in ("train", "val", "test"):
        size = len(raw[f"{split}_idx"])
        assert abs(got[f"{split}_acc"] - float(ref[f"{split}_acc"])) <= \
            2 / size + 1e-7, split


def test_pretrained_zinc_egc_m_equals_jax(tmp_path):
    """A batched set: zinc EGC-M h124 H4 B4 add/std/max, one JAX iteration,
    the same way; the test MAE at rtol 1e-5."""
    jcfg = jmain.build_config("zinc", "egc", hidden=124, heads=4, bases=4,
                              aggrs="add,std,max", num_samples=1)
    jres = jrunner.run_trial(jcfg, jcfg.default_hparams(), seed=0,
                             max_iterations=1, verbose=False)
    state = jres["state"]
    pt = _checkpoint(tmp_path, "zinc", {"params": state.params,
                                        "batch_stats": state.batch_stats},
                     heads=4, bases=4, aggrs=("add", "std", "max"))
    jm, js, jd = jrestore(jcfg, "zinc", pt)
    ref = jcfg.test(jm, js, jd)
    out = run_cli([str(tmp_path), "egc", "zinc", "--hidden", "124",
                   "--egc-num-heads", "4", "--egc-num-bases", "4",
                   "--aggrs", "add,std,max", "--pretrained", "--device",
                   "cpu"])
    got = ast.literal_eval(out.strip().splitlines()[-1])
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(float(ref[k]), rel=1e-5), k


def test_pretrained_refuses_another_architecture(tmp_path):
    """``--pretrained`` at a width the registry does not publish raises
    before anything is read, as ``main.py`` does."""
    with pytest.raises(ValueError, match="hidden=156, requested 8"):
        run_cli([str(tmp_path), "gcn", "arxiv", "--hidden", "8",
                 "--pretrained", "--device", "cpu"])


def test_restore_pretrained_pt_takes_a_bare_state_dict(tmp_path):
    """A bare state dict and the trial payload ``{"model": ...}`` restore
    the same weights, strictly."""
    from egc_tpu_torch.exp.weight_port import restore_pretrained_pt
    cfg = ArxivConfig("sage", 115, device="cpu")
    data = cfg.data(cfg.default_hparams())
    sd = cfg.model(cfg.default_hparams(), seed=5).state_dict()
    torch.save(sd, tmp_path / "bare.pt")
    torch.save({"model": sd, "opt": {}, "step": 3}, tmp_path / "trial.pt")
    for name in ("bare.pt", "trial.pt"):
        model, state, d = restore_pretrained_pt(cfg, tmp_path / name,
                                                data=data)
        assert d is data and isinstance(state, torch.optim.Adam)
        for k, v in sd.items():
            assert torch.equal(model.state_dict()[k], v), k
    torch.save({k: v for k, v in sd.items() if "lin_r" not in k},
               tmp_path / "short.pt")
    with pytest.raises(RuntimeError, match="Missing key"):
        restore_pretrained_pt(cfg, tmp_path / "short.pt", data=data)
