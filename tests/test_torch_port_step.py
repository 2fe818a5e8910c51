"""The one step body, ``train.loop.train_step``, on the CPU with no JAX.

It gives every parameter the loss does not reach a zero gradient before
Adam's step (JAX's ``add_decayed_weights`` then decays it). One step of
each of the nine arxiv kinds, of ``MagNet`` and of each batched net at
test size reaches every parameter through backward, so the fill changes
no number outside rmag, where the last layer's products of the types
other than paper never reach the loss."""

import pytest
import torch

from egc_tpu_torch.data import synthetic
from egc_tpu_torch.exp import batched, fullgraph, hetero
from egc_tpu_torch.train.loop import train_step

torch.set_num_threads(2)
ARXIV_KINDS = ("egc", "gat", "gatv2", "gcn", "gin", "sage", "mpnn-sum",
               "mpnn-max", "pna")
BATCHED = {"zinc": batched.ZincConfig, "cifar": batched.CifarConfig,
           "hiv": batched.MolConfig, "code": batched.CodeConfig}


def _reached(model, step) -> set:
    """The names of ``model``'s parameters whose gradient backward
    accumulated during ``step()`` (a gradient set by hand fires no
    hook)."""
    reached = set()
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, name=name: reached.add(name))
        for name, p in model.named_parameters()]
    try:
        step()
    finally:
        for h in hooks:
            h.remove()
    return reached


def _full_graph_case(cfg, classes: int):
    raw = synthetic.synthetic_full_graph(num_nodes=300, avg_degree=6,
                                         num_classes=classes,
                                         num_features=32)
    hp = {"lr": 0.01, "wd": 5e-4, "dropout": 0.2}
    data = cfg.full_data(raw)
    model = cfg.model(hp, seed=0)
    opt = cfg.init_state(model, hp, data, 0)
    return model, lambda: cfg.train(model, opt, data, cfg.rng(0), 0)


def _batched_case(name: str):
    cfg = BATCHED[name]("egc", 16, heads=4, bases=4, num_layers=2,
                        aggrs=("symnorm", "max"), device="cpu")
    hp = {"lr": 0.001, "wd": 5e-4, "batch_size": 8, "dropout": 0.2}
    graph, y = next(iter(cfg.data(hp)["train"]))
    model = cfg.model(hp, seed=0)
    opt = cfg.init_state(model, hp, None, 0)
    return model, lambda: train_step(model, opt, cfg.loss_fn, graph, y,
                                     torch.Generator().manual_seed(0))


@pytest.mark.parametrize(
    "net", [f"arxiv-{k}" for k in ARXIV_KINDS] + ["mag"] + list(BATCHED))
def test_one_step_reaches_every_parameter(net):
    if net.startswith("arxiv-"):
        kind = net[len("arxiv-"):]
        model, step = _full_graph_case(fullgraph.ArxivConfig(
            kind, 16, heads=4, bases=4, aggrs=("symnorm", "max", "mean"),
            gat_version=2 if kind == "gatv2" else 1, device="cpu"), 40)
    elif net == "mag":
        model, step = _full_graph_case(fullgraph.MagConfig(
            "egc", 16, heads=2, bases=2, device="cpu"), 349)
    else:
        model, step = _batched_case(net)
    names = {name for name, _ in model.named_parameters()}
    assert _reached(model, step) == names


def test_rmag_unreached_parameters_get_a_zero_gradient_and_decay():
    """rmag's head reaches only the paper type: the other types' root
    products and relations into them get no gradient from backward, a
    zero one from the fill, and Adam's L2 moves them."""
    hp = {"lr": 0.01, "wd": 1e-3, "dropout": 0.5}
    cfg = hetero.RMagConfig(16, heads=4, bases=2, device="cpu")
    data = cfg.data(hp)
    model = cfg.model(hp, seed=0)
    opt = cfg.init_state(model, hp, data, 0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    reached = _reached(model,
                       lambda: cfg.train(model, opt, data, cfg.rng(0), 0))
    unreached = set(before) - reached
    assert "convs.1.root_lins.author.weight" in unreached
    assert "convs.1.root_lins.paper.weight" in reached
    for name, p in model.named_parameters():
        if name in unreached:
            assert torch.equal(p.grad, torch.zeros_like(p)), name
            assert not torch.equal(p.detach(), before[name]), name
