"""The heterogeneous ogbn-mag step's spans and loss (``exp/hetero``,
``nn/conv/hetero``) on ``synthetic_rmag``: one ``RMagConfig.train`` step
marks ``egc.step`` and its phases, the modules and the dense products,
nested as the benchmark's span readers take them; the spans change no
number; the loss is ``exp.fullgraph.masked_nll``, read through the module
so that a replacement there reaches the step (rmag's, and the arxiv and
sampled steps, which share ``train.loop.train_step``), and bitwise the
loss the step took before. No JAX here, so that the test marked ``card``
runs on the chip: ``python -m pytest tests/test_torch_port_hetero_spans.py
--noconftest -m card``."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from egc_tpu_torch.data import synthetic
from egc_tpu_torch.exp import fullgraph
from egc_tpu_torch.exp import hetero as thet
from egc_tpu_torch.train.losses import gather_label_scores
from egc_tpu_torch.utils.profiling import span_totals

HP = {"lr": 0.01, "wd": 0.001, "dropout": 0.5}

# each span's enclosing span (None: outermost); a set where it may be
# either
PARENT = {
    "egc.step": {None},
    "egc.optimizer": {"egc.step"}, "egc.forward": {"egc.step"},
    "egc.loss": {"egc.step"}, "egc.backward": {"egc.step"},
    "egc.conv": {"egc.forward"}, "egc.pointwise": {"egc.forward"},
    "egc.head": {"egc.forward"},
    "egc.conv.dense": {"egc.conv", "egc.head"},
    "egc.aggregate": {"egc.conv", "egc.head"},
    "egc.headmix": {"egc.conv"},
}
# one step at 2 layers: 1 REGConv (the bases and root combs, 6 relation
# combs, 6 aggregations, 3 root and 6 relation head mixes), the RGCN head
# (the root Linear, 3 relation Linears and 3 aggregations)
COUNTS = {"egc.step": 1, "egc.forward": 1, "egc.loss": 1,
          "egc.backward": 1, "egc.optimizer": 2, "egc.conv": 1,
          "egc.pointwise": 1, "egc.head": 1, "egc.conv.dense": 1 + 6 + 1 + 3,
          "egc.aggregate": 9, "egc.headmix": 9}


def _setup(device="cpu", seed=0):
    cfg = thet.RMagConfig(16, heads=4, bases=2, device=device)
    data = cfg.data(HP)
    model = cfg.model(HP, seed=seed)
    state = cfg.init_state(model, HP, data, seed)
    return cfg, data, model, state


def _enclosing(evt):
    node = evt.cpu_parent
    while node is not None and not node.name.startswith("egc."):
        node = node.cpu_parent
    return None if node is None else node.name


def test_one_step_marks_its_spans_nested():
    cfg, data, model, state = _setup()
    with span_totals() as totals, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        cfg.train(model, state, data, cfg.rng(0), 0)
    assert {k: v[1] for k, v in totals.items()} == COUNTS
    assert all(v[0] > 0 for v in totals.values())
    seen = {}
    for evt in prof.events():
        if evt.name.startswith("egc."):
            seen.setdefault(evt.name, set()).add(_enclosing(evt))
    assert set(seen) == set(PARENT)
    for name, parents in seen.items():
        assert parents <= PARENT[name], (name, parents)


def _step(spans_on: bool):
    cfg, data, model, state = _setup()
    if spans_on:
        with span_totals(), profile(activities=[ProfilerActivity.CPU]):
            _, m = cfg.train(model, state, data, cfg.rng(3), 0)
    else:
        _, m = cfg.train(model, state, data, cfg.rng(3), 0)
    return m["train_loss"], \
        {n: p.grad.clone() for n, p in model.named_parameters()}, \
        {n: p.detach().clone() for n, p in model.named_parameters()}


def test_the_spans_change_no_number():
    loss_off, grads_off, params_off = _step(False)
    loss_on, grads_on, params_on = _step(True)
    assert loss_off == loss_on
    assert grads_off.keys() == grads_on.keys()
    for n in grads_off:
        assert torch.equal(grads_off[n], grads_on[n]), n
        assert torch.equal(params_off[n], params_on[n]), n


def _own_loss(out, y, mask):
    """The loss the step took before it read ``fullgraph.masked_nll``."""
    m = mask.to(out.dtype)
    return -(gather_label_scores(out, y) * m).sum() / \
        torch.clamp(m.sum(), min=1.0)


def test_the_loss_is_the_shared_one_bitwise():
    cfg, data, model, _ = _setup()
    model.train()
    outs = []
    for loss_fn in (_own_loss, fullgraph.masked_nll):
        out = model(data["hetero"], generator=torch.Generator().manual_seed(1))
        loss = loss_fn(out, data["y"], data["masks"]["train"])
        model.zero_grad(set_to_none=True)
        loss.backward()
        outs.append((loss.detach(), {n: p.grad.clone() for n, p in
                                     model.named_parameters()
                                     if p.grad is not None}))
    (la, ga), (lb, gb) = outs
    assert torch.equal(la, lb)
    assert ga.keys() == gb.keys()
    assert all(torch.equal(ga[n], gb[n]) for n in ga)


def _full_graph_loss(cfg_class) -> float:
    """The loss of one step of ``cfg_class`` (the arxiv config's
    ``train``, the sampled config's ``sampled_step`` on its first batch)
    on a 300-node graph."""
    cfg = cfg_class("egc", 16, heads=2, bases=2, aggrs=("symnorm", "max"),
                    device="cpu")
    raw = synthetic.synthetic_full_graph(num_nodes=300, avg_degree=6,
                                         num_classes=40, num_features=32)
    cfg.load_full_graph = lambda: raw
    data = cfg.data(HP)
    model = cfg.model(HP, seed=0)
    state = cfg.init_state(model, HP, data, 0)
    if cfg_class is fullgraph.ArxivConfig:
        return cfg.train(model, state, data, cfg.rng(3), 0)[1]["train_loss"]
    gen, *batch = next(cfg.batches(data, cfg.rng(3), 0))
    return float(cfg.sampled_step(model, state, data["x_full"], *batch,
                                  generator=gen))


STEPS = {"arxiv": lambda: _full_graph_loss(fullgraph.ArxivConfig),
         "rmag": lambda: _step(False)[0],
         "sampled": lambda: _full_graph_loss(fullgraph.SampledMagConfig)}


@pytest.mark.parametrize("path", list(STEPS))
def test_a_replaced_shared_loss_reaches_the_step(monkeypatch, path):
    """``gnnbench/faults.py`` plants its faults by replacing
    ``fullgraph.masked_nll``: every step must read it when it runs."""
    base = STEPS[path]()
    nll = fullgraph.masked_nll
    monkeypatch.setattr(fullgraph, "masked_nll",
                        lambda out, y, mask: nll(out, y, mask) * 2.0)
    assert STEPS[path]() == pytest.approx(2.0 * base, rel=1e-6)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.card
def test_a_step_launches_each_egc_kernel_nine_times(card):
    """6 relations in the REGConv and 3 in the RGCN head: 9 gather-reduce
    pairs, each in the split geometry at this net's F 8; 3 root and 6
    relation head mixes; no BatchNorm."""
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    cfg, data, model, state = _setup(card)
    rng = cfg.rng(0)
    cfg.train(model, state, data, rng, 0)
    reset_launch_counts()
    steps = 3
    for it in range(1, steps + 1):
        cfg.train(model, state, data, rng, it)
    egc = ("gather_reduce_fwd", "gather_reduce_bwd",
           "gather_reduce_fwd_split", "gather_reduce_bwd_split",
           "headmix_fwd", "headmix_bwd")
    counts = launch_counts()
    assert {k: counts[k] for k in egc} == {k: 9 * steps for k in egc}
    assert all(v == 0 for k, v in counts.items() if k not in egc), counts
