"""The reference against the program on the CPU: one training-mode
forward and backward of each configuration on a small graph, from the
same weights and the same dropout stream, give the same loss and
gradients; and a batch of the program's sampler is judged sound, and
faulty once altered."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gnnbench import graph, port
from gnnbench.reference import common, graphs
from gnnbench.reference.train import model_module
from gnnbench.weights import make_weights

HERE = Path(__file__).resolve().parents[1]


def _config(name: str, nodes: int = 600) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg["graph"].update(num_nodes=nodes, avg_degree=6)
    return cfg


@pytest.mark.parametrize("name", ["egc_m_arxiv", "egc_mag"])
def test_reference_matches_the_program(name):
    from egc_tpu_torch.exp.fullgraph import masked_nll
    cfg = _config(name)
    raw = graph.synthetic_full_graph(**cfg["graph"], seed=3)
    mod = model_module(cfg)
    w0 = make_weights(mod.param_specs(cfg), 7, "cpu")
    config = port.bench_config(cfg, {"mode": "full"}, raw, w0, "cpu")
    data = config.data(cfg["hparams"])
    model = config.model(cfg["hparams"])
    model.train()
    out = model(data["graph"], generator=torch.Generator().manual_seed(5))
    loss = masked_nll(out, data["y"], data["masks"]["train"])
    loss.backward()

    g, y, masks = graphs.full_graph(raw, "cpu")
    P = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    logp = mod.forward(P, g, cfg, mod.init_running(cfg, "cpu"), True,
                       torch.Generator().manual_seed(5))
    ref = common.masked_nll(logp, y, masks["train"])
    grads = dict(zip(P, torch.autograd.grad(ref, list(P.values()))))
    assert float(loss.detach()) == pytest.approx(float(ref.detach()),
                                                rel=1e-6)
    for k, p in model.named_parameters():
        torch.testing.assert_close(p.grad, grads[k], rtol=1e-4, atol=1e-6)


def _sampled_batch(raw, fanouts, batch_size):
    from egc_tpu_torch.data.sampling import NeighborSampler, SampledNodeLoader
    n = raw["x"].shape[0]
    sampler = NeighborSampler(raw["senders"], raw["receivers"], n,
                              fanouts=fanouts)
    loader = SampledNodeLoader(sampler, raw["x"], raw["y"],
                               raw["train_idx"], batch_size, rng_seed=11,
                               gather_on_device=True)
    g, y, seed_mask, gids = next(iter(loader))
    out = {k: getattr(g, k).numpy() for k in
           ("senders", "receivers", "edge_mask", "node_mask")}
    out.update(y=y.numpy(), seed_mask=seed_mask.numpy(), gids=gids.numpy())
    return out


def test_judge_batch_holds_the_sampler_to_the_graph():
    cfg = _config("egc_mag", nodes=3000)
    raw = graph.synthetic_full_graph(**cfg["graph"], seed=4)
    fanouts, bs = (5, 3), 64
    batch = _sampled_batch(raw, fanouts, bs)
    judge = dict(fanouts=fanouts, batch_size=bs, seeds_expected=bs)
    assert graphs.judge_batch(raw, batch, **judge) == []

    ev = int(batch["edge_mask"].sum())
    bad = {k: v.copy() for k, v in batch.items()}      # an edge moved
    s, r = bad["senders"], bad["receivers"]
    gids = bad["gids"]
    nbrs = set(raw["senders"][raw["receivers"] == gids[r[0]]].tolist())
    s[0] = next(i for i in range(int(bad["node_mask"].sum()))
                if gids[i] not in nbrs and i != r[0])
    assert graphs.judge_batch(raw, bad, **judge)

    bad = {k: v.copy() for k, v in batch.items()}      # an edge dropped
    bad["edge_mask"][ev - 1] = False
    assert graphs.judge_batch(raw, bad, **judge)

    bad = {k: v.copy() for k, v in batch.items()}      # a label altered
    bad["y"][0] = (bad["y"][0] + 1) % cfg["graph"]["num_classes"]
    assert graphs.judge_batch(raw, bad, **judge)


def test_weights_are_one_draw_from_the_seed():
    specs = [("a", (3, 4), 0.0, 0.5), ("b", (5,), 1.0, 0.1)]
    w = make_weights(specs, 9, "cpu")
    assert w["a"].shape == (3, 4) and w["b"].shape == (5,)
    assert float(w["a"].abs().max()) <= 0.5
    assert np.all(np.abs(w["b"].numpy() - 1.0) <= 0.1)
    again = make_weights(specs, 9, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
