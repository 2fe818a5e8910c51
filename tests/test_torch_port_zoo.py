"""Port parity for the conv zoo on ``conv_aggregate``: GCN, GIN, SAGE,
MPNN (sum and max) and PNA against the JAX convs (their XLA path on the
CPU) from the same weights, and the MLP. The nets of every kind are in
``test_torch_port_zoo_nets.py``.

Tolerances: values rtol = atol = 1e-4, gradients relative L2 <= 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from egc_tpu.data import synthetic as jsyn
from egc_tpu.graph.structure import Graph as JGraph, pad_graph as jpad
from egc_tpu.graph.transforms import coalesce_np
from egc_tpu.nn import mlp as jmlp
from egc_tpu.nn.conv import mpnn as jmpnn
from egc_tpu.nn.conv import pna as jpna
from egc_tpu.nn.conv import simple as jsimple

from egc_tpu_torch.exp import fullgraph as tfg
from egc_tpu_torch.exp.weight_port import arxiv_state_dict_from_jax
from egc_tpu_torch.graph.structure import Graph as TGraph, pad_graph as tpad
from egc_tpu_torch.graph.transforms import symnorm_weight
from egc_tpu_torch.models.nets import ConvSpec
from egc_tpu_torch.nn.conv.mpnn import MPNNConv
from egc_tpu_torch.nn.conv.pna import PNAConv, avg_log_degree
from egc_tpu_torch.nn.conv.simple import GCNConv, GINConv, SAGEConv
from egc_tpu_torch.nn.mlp import MLP, linear
from egc_tpu_torch.ops.dispatch import build_kernel_plan

torch.set_num_threads(2)
ZOO = ("gcn", "gin", "sage", "mpnn-sum", "mpnn-max", "pna")
CLS = {"gcn": "GCNConv", "gin": "GINConv", "sage": "SAGEConv",
       "mpnn-sum": "MPNNConv", "mpnn-max": "MPNNConv", "pna": "PNAConv"}


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _dense(i, o):
    return {"kernel": np.zeros((i, o), np.float32),
            "bias": np.zeros((o,), np.float32)}


def small_graph(seed, n, e, isolated=0):
    """Coalesced random graph without self-loops; the last ``isolated``
    nodes receive no edge."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n - isolated, e).astype(np.int32)
    keep = s != r
    s, r, _ = coalesce_np(s[keep], r[keep], n)
    return s, r


def jax_conv(kind, out, avg_log_deg):
    if kind == "gcn":
        return jsimple.GCNConv(out)
    if kind == "gin":
        return jsimple.GINConv(mlp=jmlp.MLP([out]), train_eps=True)
    if kind == "sage":
        return jsimple.SAGEConv(out)
    if kind in ("mpnn-sum", "mpnn-max"):
        return jmpnn.MPNNConv(out, aggr=kind[len("mpnn-"):])
    return jpna.PNAConv(out, avg_log_deg=avg_log_deg)


def torch_conv(kind, fin, out, avg_log_deg):
    return ConvSpec(kind=kind, avg_log_deg=avg_log_deg).build(
        fin, out, layer_idx=0, num_layers=3)


def conv_state(kind, tree):
    """A JAX conv's params -> the port conv's state dict, through the
    arxiv weight port (a standalone JAX GIN holds its net as ``mlp``)."""
    tree = to_np(tree)
    params = {"embed": _dense(1, 1), "out": _dense(1, 1)}
    if kind == "gin":
        params["GINConv_0"] = {"eps": tree["eps"]}
        params["MLP_0"] = tree["mlp"]
    else:
        params[f"{CLS[kind]}_0"] = tree
    sd = arxiv_state_dict_from_jax({"params": params}, kind=kind)
    return {k[len("convs.0."):]: v for k, v in sd.items()
            if k.startswith("convs.0.")}


@pytest.mark.parametrize("isolated", [0, 7], ids=["all", "isolated"])
@pytest.mark.parametrize("kind", ZOO)
def test_conv_matches_jax(kind, isolated):
    """Values and the gradients of a fixed projection w.r.t. the input and
    every parameter, on a padded graph (``isolated`` receivers without
    in-edges); nonzero biases and GIN's eps = 0.3."""
    n, fin, out = 70, 16, 24
    s, r = small_graph(3, n, 380, isolated=isolated)
    if isolated:
        assert (np.bincount(r, minlength=n)[n - isolated:] == 0).all()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n + 3, fin)).astype(np.float32)
    proj = rng.normal(size=(n + 3, out)).astype(np.float32)
    gj = jax.tree.map(jnp.asarray, jpad(JGraph.from_coo(x[:n], s, r),
                                        num_nodes=n + 3,
                                        num_edges=len(s) + 5))
    gt = tpad(TGraph.from_coo(x[:n], s, r), num_nodes=n + 3,
              num_edges=len(s) + 5)
    ald = avg_log_degree(np.bincount(np.bincount(r, minlength=n)))

    conv = jax_conv(kind, out, ald)
    params = conv.init(jax.random.PRNGKey(5), gj, jnp.asarray(x))["params"]
    params = jax.tree.map(lambda v: v, dict(params))
    for key in ("bias", "msg_bias", "pre_bias"):   # exercise every path
        if key in params:
            params[key] = jnp.asarray(rng.normal(
                size=params[key].shape).astype(np.float32))
    if kind == "gin":
        params["eps"] = jnp.asarray(0.3, jnp.float32)

    def fj(p, xx):
        o = conv.apply({"params": p}, gj, xx)
        return jnp.sum(o * proj), o

    (_, jout), (gp, gx) = jax.value_and_grad(fj, argnums=(0, 1),
                                             has_aux=True)(
        params, jnp.asarray(x))

    tconv = torch_conv(kind, fin, out, ald)
    tconv.load_state_dict(conv_state(kind, params), strict=True)
    xt = torch.tensor(x, requires_grad=True)
    tout = tconv(gt, xt)
    (tout * torch.as_tensor(proj)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy()[:n],
                               np.asarray(jout)[:n], rtol=1e-4, atol=1e-4)
    assert rel_l2(xt.grad.numpy()[:n], np.asarray(gx)[:n]) <= 1e-4
    gsd = conv_state(kind, gp)
    assert set(gsd) == {k for k, _ in tconv.named_parameters()}
    for name, p in tconv.named_parameters():
        assert rel_l2(p.grad.numpy(), gsd[name].numpy()) <= 1e-4, name


@pytest.mark.parametrize("kind", ["gcn", "sage", "mpnn-max", "pna"])
def test_conv_with_a_plan_matches_without(kind):
    """A graph carrying a kernel plan (its in-degree, its symnorm weights)
    gives the same conv as the bare graph on the CPU."""
    n, fin = 60, 16
    s, r = small_graph(6, n, 300, isolated=5)
    x = np.random.default_rng(7).normal(size=(n + 1, fin)).astype(
        np.float32)
    g = tpad(TGraph.from_coo(x[:n], s, r), num_nodes=n + 1,
             num_edges=len(s) + 3)
    ew, sw = symnorm_weight(g.senders, g.receivers, n + 1,
                            edge_mask=g.edge_mask)
    g = g.replace(edge_weight=ew, self_weight=sw)
    gp = g.replace(kernel_plan=build_kernel_plan(
        g.senders.numpy(), g.receivers.numpy(), n + 1,
        edge_mask=g.edge_mask.numpy(), edge_weight=ew.numpy()))
    conv = torch_conv(kind, fin, 24, 1.7)
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(conv(gp, xt).detach().numpy(),
                               conv(g, xt).detach().numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_mlp_matches_jax(train):
    """MLP [32, 16, 5]: Linear -> masked BN -> ReLU per hidden size, then
    a Linear, at the reference's Sequential indices; the BN counts the
    mask's rows."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(40, 12)).astype(np.float32)
    mask = rng.random(40) < 0.8
    jm = jmlp.MLP([32, 16, 5])
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                        jnp.asarray(mask), train=False)
    ref, _ = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                      train=train, mutable=["batch_stats"])
    tm = MLP(12, [32, 16, 5])
    p, st = to_np(variables["params"]), to_np(variables["batch_stats"])
    sd = {}
    for k in range(3):
        sd[f"{4 * k}.weight"] = p[f"Dense_{k}"]["kernel"].T
        sd[f"{4 * k}.bias"] = p[f"Dense_{k}"]["bias"]
    for k in range(2):
        bn, stats = p[f"MaskedBatchNorm_{k}"], st[f"MaskedBatchNorm_{k}"]
        sd.update({f"{4 * k + 1}.weight": bn["scale"],
                   f"{4 * k + 1}.bias": bn["bias"],
                   f"{4 * k + 1}.running_mean": stats["mean"],
                   f"{4 * k + 1}.running_var": stats["var"],
                   f"{4 * k + 1}.num_batches_tracked": np.asarray(0)})
    tm.load_state_dict({k: torch.as_tensor(np.array(v))
                        for k, v in sd.items()}, strict=True)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.as_tensor(x), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_mlp_of_one_size_is_one_linear():
    m = MLP(8, [3])
    assert [type(c).__name__ for c in m] == ["Linear"]
    assert set(m.state_dict()) == {"0.weight", "0.bias"}


@pytest.fixture(scope="module")
def raw():
    return jsyn.synthetic_full_graph(num_nodes=300, avg_degree=8, seed=1)


@pytest.mark.parametrize("kind", ZOO)
def test_train_full_graph_runs_each_kind(raw, kind):
    """Two CPU steps of ``train_full_graph`` (PNA with the graph's
    avg_log_deg), finite and falling."""
    run = tfg.train_full_graph(raw, steps=3, kind=kind, hidden=16,
                               dropout=0.0, device="cpu")
    assert np.all(np.isfinite(run.losses))
    assert run.losses[-1] < run.losses[0]
    if kind == "pna":
        assert run.model.convs[0].avg_log_deg == run.data["avg_log_deg"]
    if kind == "gin":
        assert isinstance(run.model.convs[0], GINConv)
        assert isinstance(run.model.convs[0].nn, torch.nn.Linear)


def test_conv_classes_and_names():
    convs = {k: torch_conv(k, 16, 16, 1.0) for k in ZOO}
    assert isinstance(convs["gcn"], GCNConv)
    assert isinstance(convs["sage"], SAGEConv)
    assert isinstance(convs["pna"], PNAConv)
    assert convs["mpnn-max"].aggr == "max"
    assert isinstance(convs["mpnn-sum"], MPNNConv)
    assert set(dict(convs["sage"].named_parameters())) == {
        "lin_l.weight", "lin_l.bias", "lin_r.weight"}
    assert set(dict(convs["gin"].named_parameters())) == {
        "eps", "nn.weight", "nn.bias"}
    assert tuple(convs["gin"].eps.shape) == ()
    with pytest.raises(ValueError, match="towers"):
        MPNNConv(18, 18)
    with pytest.raises(ValueError, match="towers"):
        PNAConv(18, 16, avg_log_deg=1.0)
    assert isinstance(linear(3, 4), torch.nn.Linear)
