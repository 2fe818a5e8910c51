"""The port's command line (counterpart of the JAX package's ``main.py``,
the reference command line, reference ``main.py:211-372``):

    python -m egc_tpu_torch EXP_DIR MODEL DATASET [options]

The positional arguments, option names and defaults are ``main.py``'s,
plus ``--device`` (default: the card; ``--device cpu`` runs the plain
PyTorch path). Modes: ``--check`` (a short smoke trial), ``--hparams``
(parsed with ``ast.literal_eval``) or ``--use-default-hparams`` straight
to the seeded final runs, else a hyperparameter search first (in
process), then the final runs.

This port runs every dataset with every model kind the reference
supports on it (``SUPPORTED``): zinc, cifar, hiv and code as batched
tasks, arxiv, mag (homogeneous) and rmag (heterogeneous ogbn-mag, REGC) on
the full graph; mag also on neighbour-sampled batches (``--sampled``,
and ``--device-sampler``, which samples on the card and implies
``--sampled``).

- ``--pretrained`` checks the architecture against the pretrained
  registry (``exp/pretrained.py``), restores ``EXP_DIR/checkpoint.pt``
  (``exp.weight_port.restore_pretrained_pt``) or else the trial in
  ``EXP_DIR`` (``restore_trial``), and prints the model and its test
  metrics.
- ``--search-workers N`` (N > 1) runs the search's trials on N spawned
  workers (``exp/parallel_search.py``), each on ``--device``. With
  ``--partitions`` every trial runs on all the ranks, so the trials run
  in turn through the in-process search (the ``--search-workers 1``
  search), and a line says so.
- ``--partitions N`` (arxiv and rmag) trains over N ranks that the
  command starts itself, one a card under NCCL, or N gloo ranks with
  ``--device cpu``; each rank runs ``main``, and only rank 0 prints and
  writes ``EXP_DIR``. More ranks than visible cards is a usage error,
  raised before any rank starts.
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence

MODELS = ["gcn", "gat", "egc", "gin", "mpnn-sum", "mpnn-max", "pna", "sage",
          "gatv2"]
DATASETS = ["zinc", "hiv", "arxiv", "cifar", "code", "rmag", "mag"]

# the reference's support matrix (main.py:56-208)
SUPPORTED = {
    "zinc": {"egc", "gatv2"},
    "cifar": {"egc", "gatv2"},
    "hiv": {"egc", "gcn", "gat", "gatv2", "gin", "mpnn-sum", "mpnn-max",
            "sage"},
    "arxiv": set(MODELS),
    "code": set(MODELS),
    "mag": {"egc"},
    "rmag": {"egc"},
}

# the datasets that ``--partitions`` partitions (main.py:91-93, 111-116)
PARTITIONED = ("arxiv", "rmag")


class UsageError(ValueError):
    """A command line that cannot run (``click.UsageError``)."""


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m egc_tpu_torch",
        description="Train a GNN with the PyTorch/CUDA port of egc_tpu.")
    ap.add_argument("exp_directory")
    ap.add_argument("model", choices=MODELS)
    ap.add_argument("dataset", choices=DATASETS)
    ap.add_argument("--num-samples", type=int, default=50)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--check-epochs", type=int, default=200)
    ap.add_argument("--use-default-hparams", action="store_true")
    ap.add_argument("--hparams", type=str, default=None)
    ap.add_argument("--egc-num-bases", type=int, default=None)
    ap.add_argument("--egc-num-heads", type=int, default=None)
    ap.add_argument("--final-runs", type=int, default=None)
    ap.add_argument("--aggrs", type=str, default=None)
    ap.add_argument("--hidden", type=int, default=None)
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--use-old-code-dataset", action="store_true")
    ap.add_argument("--pretrained", action="store_true")
    ap.add_argument("--partitions", type=int, default=0)
    ap.add_argument("--search-workers", type=int, default=0)
    ap.add_argument("--synthetic", dest="synthetic", action="store_true",
                    default=True, help="synthetic data (the default)")
    ap.add_argument("--real", dest="synthetic", action="store_false",
                    help="the real dataset under $DATASET_LOC")
    ap.add_argument("--sampled", action="store_true")
    ap.add_argument("--device-sampler", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def _conv_kwargs(model, heads, bases, aggrs):
    """``main._conv_kwargs``: EGC's heads (8), bases (4) and aggregators."""
    if model != "egc":
        return {}
    if aggrs is None:
        raise UsageError("--aggrs is required for egc")
    return dict(heads=heads or 8, bases=bases or 4,
                aggrs=tuple(aggrs.split(",")))


def build_config(dataset, model, *, hidden, heads, bases, aggrs,
                 num_samples, synthetic=True, use_old_code_dataset=False,
                 partitions=0, sampled=False, device_sampler=False,
                 device=None, mesh=None):
    """``main.build_config`` for the datasets this port runs; ``mesh``: the
    rank's process group, for ``partitions``."""
    if model not in SUPPORTED[dataset]:
        raise UsageError(f"{model!r} not supported for {dataset!r} "
                         f"(supported: {sorted(SUPPORTED[dataset])})")
    if (sampled or device_sampler) and dataset != "mag":
        raise UsageError(
            "--sampled/--device-sampler apply to the mag dataset only")
    if hidden is None:
        raise UsageError("--hidden is required")
    if dataset == "rmag":
        # main.py:111-119: REGC heads and bases, no --aggrs
        from egc_tpu_torch.exp import hetero
        kw = dict(heads=heads or 4, bases=bases or 4, device=device)
        if partitions:
            cfg = hetero.PartitionedRMagConfig(
                hidden, partitions=partitions, mesh=mesh, **kw)
        else:
            cfg = hetero.RMagConfig(hidden, **kw)
        cfg.synthetic = synthetic
        cfg._num_samples = num_samples
        return cfg
    kw = _conv_kwargs(model, heads, bases, aggrs)
    from egc_tpu_torch.exp import batched, fullgraph
    if dataset in ("zinc", "cifar", "hiv"):
        ctor = {"zinc": batched.ZincConfig, "cifar": batched.CifarConfig,
                "hiv": batched.MolConfig}[dataset]
        cfg = ctor(model, hidden, device=device, **kw)
    elif dataset == "code":
        cfg = batched.CodeConfig(model, hidden, device=device,
                                 use_old_code_dataset=use_old_code_dataset,
                                 **kw)
    elif dataset == "arxiv":
        kw = dict(heads=heads or 8, bases=bases or 8,
                  aggrs=tuple(aggrs.split(",")) if aggrs else None,
                  gat_version=2 if model == "gatv2" else 1, device=device)
        if partitions:
            cfg = fullgraph.PartitionedArxivConfig(
                model, hidden, partitions=partitions, mesh=mesh, **kw)
        else:
            cfg = fullgraph.ArxivConfig(model, hidden, **kw)
    else:   # mag
        mag_kw = dict(heads=heads or 8, bases=bases or 4,
                      aggrs=tuple(aggrs.split(",")) if aggrs else
                      ("symnorm",), device=device)
        if sampled or device_sampler:
            cfg = fullgraph.SampledMagConfig(
                model, hidden, device_sampler=device_sampler, **mag_kw)
        else:
            cfg = fullgraph.MagConfig(model, hidden, **mag_kw)
    cfg.synthetic = synthetic
    cfg._num_samples = num_samples
    return cfg


def dump_invocation_state(exp_dir: Path, argv: Sequence[str]):
    (exp_dir / "invocation.json").write_text(json.dumps({
        "argv": list(argv), "time": time.strftime("%Y-%m-%d %H:%M:%S"),
    }))


def _partition_rank(mesh, argv: List[str], pretrained: bool) -> None:
    """One rank of ``--partitions``: ``main`` on the rank's process group.
    Only rank 0 prints and writes ``EXP_DIR``; another rank runs quiet in
    a directory of its own (``EXP_DIR`` itself when it only reads it, for
    ``--pretrained``)."""
    import contextlib
    import os
    import tempfile

    if mesh.rank == 0:
        main(argv, mesh=mesh)
        return
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet), \
            tempfile.TemporaryDirectory() as scratch:
        main(argv if pretrained else [scratch] + argv[1:], mesh=mesh)


def _start_partitions(a, argv: List[str]) -> None:
    """``--partitions N``: start N ranks that each run ``main``."""
    import torch

    from egc_tpu_torch.parallel.mesh import device_count, spawn
    device = torch.device(a.device or "cuda")
    if device.type == "cuda" and a.partitions > device_count():
        raise UsageError(
            f"--partitions {a.partitions} needs {a.partitions} CUDA cards "
            f"(one rank a card), {device_count()} visible")
    spawn(_partition_rank, a.partitions, device=device,
          args=(argv, a.pretrained))


def main(argv: Optional[List[str]] = None, mesh=None) -> None:
    """``main.main``. ``mesh``: set on each rank that ``--partitions``
    started."""
    from egc_tpu_torch.exp.runner import check_config, train_final_models
    from egc_tpu_torch.exp.search import run_search

    argv = sys.argv[1:] if argv is None else list(argv)
    a = build_parser().parse_args(argv)
    config_kw = dict(hidden=a.hidden, heads=a.egc_num_heads,
                     bases=a.egc_num_bases, aggrs=a.aggrs,
                     num_samples=a.num_samples, synthetic=a.synthetic,
                     use_old_code_dataset=a.use_old_code_dataset,
                     partitions=a.partitions, sampled=a.sampled,
                     device_sampler=a.device_sampler)
    if a.partitions and a.dataset in PARTITIONED and mesh is None:
        # a usage error surfaces here, not inside the ranks
        build_config(a.dataset, a.model, device=a.device,
                     **{**config_kw, "partitions": 0})
        _start_partitions(a, argv)
        return
    exp_directory = Path(a.exp_directory).expanduser()
    exp_directory.mkdir(parents=True, exist_ok=True)
    config = build_config(a.dataset, a.model, device=a.device, mesh=mesh,
                          **config_kw)

    if a.pretrained:
        # the architecture must be the published one (reference
        # load_pretrained and its per-config asserts)
        from egc_tpu_torch.exp.pretrained import validate_pretrained
        validate_pretrained(a.dataset, a.model, config)
        pt = exp_directory / "checkpoint.pt"
        if pt.exists():
            from egc_tpu_torch.exp.weight_port import restore_pretrained_pt
            model, state, data = restore_pretrained_pt(config, pt,
                                                       seed=a.seed_base)
            print(model)
            print(config.test(model, state, data))
            return
        model, state, _, hp, data = config.restore_trial(exp_directory)
        print(model)
        print(hp)
        print(config.test(model, state, data))
        return

    if a.check:
        res = check_config(config, a.check_epochs)
        print({k: res[k] for k in ("best_val", "best_iter", "test")})
        return

    dump_invocation_state(exp_directory, ["-m", "egc_tpu_torch"] + argv)

    if a.hparams is not None:
        best_hparams = ast.literal_eval(a.hparams)
        print("Using given hyperparams:", best_hparams)
    elif a.use_default_hparams:
        best_hparams = config.default_hparams()
        print("Using default hyperparams:", best_hparams)
    elif a.search_workers > 1 and mesh is None:
        # the trials across worker processes (the Ray role)
        import numpy as np
        from egc_tpu_torch.exp.parallel_search import run_search_parallel
        metric = config.trial_metric()
        candidates = config.search_strategy().generate(
            config.hyperparams(), np.random.default_rng(a.seed_base))
        spec = ("egc_tpu_torch.cli", "build_config", (a.dataset, a.model),
                config_kw)
        best_hparams = run_search_parallel(
            spec, candidates, metric_mode=metric.mode,
            metric_name=metric.name, num_workers=a.search_workers,
            exp_dir=exp_directory, seed=a.seed_base,
            worker_device=a.device,
            resources=config.resource_requirements(),
            scheduler=config.trial_scheduler())
        print("Best hparams:", best_hparams)
    else:
        if a.search_workers > 1:
            # every rank takes part in every trial, so the ranks run the
            # trials in turn: the in-process search, whose pruning
            # decisions the parallel search makes with one worker
            print(f"--search-workers {a.search_workers} with --partitions "
                  f"{a.partitions}: the trials run in turn, each on all "
                  f"{a.partitions} ranks (the search of --search-workers 1)")
        best_hparams = run_search(config, exp_directory, seed=a.seed_base)
        print("Best hparams:", best_hparams)

    train_final_models(config, best_hparams, exp_directory,
                       override_repeats=a.final_runs, seed_base=a.seed_base)


def cli() -> int:
    """``python -m egc_tpu_torch``: a command line that cannot run exits 2
    with its message."""
    try:
        main()
    except UsageError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    return 0
