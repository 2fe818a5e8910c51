"""Port parity for the slices as a whole: the weight port, EGConv, the
arxiv EGC-M, GAT and GATv2 nets and one full Adam training step of each
against the JAX package (CPU, from the same weights)."""

import re

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from egc_tpu.data import synthetic as jsyn
from egc_tpu.exp import fullgraph as jfg
from egc_tpu.exp.weight_port import export_model_state
from egc_tpu.graph.structure import Graph as JGraph, pad_graph as jpad
from egc_tpu.models.nets import ArxivNet as JArxivNet, ConvSpec as JSpec
from egc_tpu.nn.conv.egc import EGConv as JEGConv
from egc_tpu.train.optim import make_optimizer

from egc_tpu_torch.exp import fullgraph as tfg
from egc_tpu_torch.exp.weight_port import arxiv_state_dict_from_jax
from egc_tpu_torch.graph.structure import Graph as TGraph, pad_graph as tpad
from egc_tpu_torch.models.nets import ArxivNet as TArxivNet, ConvSpec
from egc_tpu_torch.nn.conv.egc import EGConv as TEGConv

torch.set_num_threads(2)
AGGRS = ("symnorm", "max", "mean")


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def raw():
    return jsyn.synthetic_full_graph(num_nodes=300, avg_degree=8, seed=1)


def jax_net(hidden, dropout=0.0):
    return JArxivNet(conv=JSpec(kind="egc", heads=4, bases=4, aggrs=AGGRS),
                     hidden_dim=hidden, num_layers=3, dropout=dropout)


def torch_net(hidden, variables, dropout=0.0):
    net = TArxivNet(ConvSpec(kind="egc", heads=4, bases=4, aggrs=AGGRS),
                    hidden, num_layers=3, dropout=dropout)
    net.load_state_dict(arxiv_state_dict_from_jax(to_np(variables), bases=4),
                        strict=True)
    return net


def both_data(raw):
    jd = jfg.full_graph_to_device_dict(raw, use_kernel=False)
    td = tfg.full_graph_to_device_dict(raw, device="cpu")
    return jd, td


def test_weight_port_equals_export_model_state(raw):
    jd, _ = both_data(raw)
    variables = jax_net(64).init(jax.random.PRNGKey(0), jd["graph"],
                                 train=False)
    ref = export_model_state("arxiv", "egc", to_np(variables), bases=4)
    got = arxiv_state_dict_from_jax(to_np(variables), bases=4)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    net = TArxivNet(ConvSpec(kind="egc", heads=4, bases=4, aggrs=AGGRS), 64)
    net.load_state_dict(got, strict=True)
    assert set(net.state_dict()) == set(ref)


def test_data_dicts_match(raw):
    jd, td = both_data(raw)
    gj, gt = jd["graph"], td["graph"]
    for name in ("nodes", "senders", "receivers", "node_mask", "edge_mask",
                 "edge_weight", "self_weight"):
        np.testing.assert_allclose(getattr(gt, name).numpy(),
                                   np.asarray(getattr(gj, name)), rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(td["y"].numpy(), np.asarray(jd["y"]))
    for k in ("train", "val", "test"):
        np.testing.assert_array_equal(td["masks"][k].numpy(),
                                      np.asarray(jd["masks"][k]))


@pytest.mark.parametrize("weighting,mode", [
    ("none", "paper"), ("softmax", "paper"), ("sigmoid", "all"),
    ("hardtanh", "all")])
def test_egconv_values_and_grads(weighting, mode):
    rng = np.random.default_rng(2)
    n, fin, out = 80, 24, 32
    s = rng.integers(0, n, 400).astype(np.int32)
    r = rng.integers(0, n, 400).astype(np.int32)
    keep = s != r
    from egc_tpu_torch.graph.transforms import coalesce_np
    s, r, _ = coalesce_np(s[keep], r[keep], n)
    x = rng.normal(size=(n + 4, fin)).astype(np.float32)
    proj = rng.normal(size=(n + 4, out)).astype(np.float32)
    gj = jpad(JGraph.from_coo(x[:n], s, r), num_nodes=n + 4,
              num_edges=len(s) + 6)
    gt = tpad(TGraph.from_coo(x[:n], s, r), num_nodes=n + 4,
              num_edges=len(s) + 6)
    gj = jax.tree.map(jnp.asarray, gj)

    conv = JEGConv(out, num_heads=4, num_bases=3, aggrs=AGGRS + ("std",),
                   weighting=weighting, self_loop_mode=mode)
    variables = conv.init(jax.random.PRNGKey(1), gj, jnp.asarray(x))
    # nudge the zero-initialised bias so its gradient path is exercised
    params = jax.tree.map(lambda v: v, variables["params"])
    params["bias"] = jnp.asarray(rng.normal(size=(out,)).astype(np.float32))

    def fj(p, xx):
        return jnp.sum(conv.apply({"params": p}, gj, xx) * proj)

    loss_j, (gp, gx) = jax.value_and_grad(fj, argnums=(0, 1))(
        params, jnp.asarray(x))

    tconv = TEGConv(fin, out, num_heads=4, num_bases=3,
                    aggrs=AGGRS + ("std",), weighting=weighting,
                    self_loop_mode=mode)
    sd = arxiv_state_dict_from_jax({"params": {"EGConv_0": to_np(params),
                                               "embed": _dense(1, 1),
                                               "out": _dense(1, 1)}},
                                   bases=3)
    tconv.load_state_dict({k[len("convs.0."):]: v for k, v in sd.items()
                           if k.startswith("convs.0.")}, strict=True)
    xt = torch.tensor(x, requires_grad=True)
    loss_t = (tconv(gt, xt) * torch.as_tensor(proj)).sum()
    loss_t.backward()
    assert loss_t.item() == pytest.approx(float(loss_j), rel=1e-4, abs=1e-3)
    assert rel_l2(xt.grad.numpy(), gx) <= 1e-4
    gsd = arxiv_state_dict_from_jax({"params": {"EGConv_0": to_np(gp),
                                                "embed": _dense(1, 1),
                                                "out": _dense(1, 1)}},
                                    bases=3)
    for name, p in tconv.named_parameters():
        assert rel_l2(p.grad.numpy(), gsd["convs.0." + name]) <= 1e-4, name


def _dense(i, o):
    return {"kernel": np.zeros((i, o), np.float32),
            "bias": np.zeros((o,), np.float32)}


@pytest.mark.parametrize("hidden", [128, 32])
@pytest.mark.parametrize("train", [False, True])
def test_arxiv_net_forward(raw, hidden, train):
    jd, td = both_data(raw)
    jm = jax_net(hidden)
    variables = jm.init(jax.random.PRNGKey(3), jd["graph"], train=False)
    tm = torch_net(hidden, variables)
    if train:
        ref, mutated = jm.apply(variables, jd["graph"], train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)},
                                mutable=["batch_stats"])
        tm.train()
    else:
        ref = jm.apply(variables, jd["graph"], train=False)
        tm.eval()
    with torch.no_grad():
        got = tm(td["graph"])
    n = raw["x"].shape[0]
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(ref)[:n],
                               rtol=1e-4, atol=1e-4)
    if train:
        sd = arxiv_state_dict_from_jax(
            {"params": to_np(variables["params"]),
             "batch_stats": to_np(mutated["batch_stats"])}, bases=4)
        for i in range(3):
            for stat in ("running_mean", "running_var"):
                k = f"bns.{i}.{stat}"
                np.testing.assert_allclose(
                    getattr(tm.bns[i], stat).numpy(), sd[k].numpy(),
                    rtol=1e-4, atol=1e-5, err_msg=k)


def gat_nets(hidden, heads, kind="gat"):
    jm = JArxivNet(conv=JSpec(kind=kind, heads=heads), hidden_dim=hidden,
                   num_layers=3, dropout=0.0)
    tm = TArxivNet(ConvSpec(kind=kind, heads=heads), hidden, num_layers=3,
                   dropout=0.0)
    return jm, tm


def test_gat_weight_port_equals_export_model_state(raw):
    """The GAT rules give ``export_model_state``'s dict, key for key, and
    it loads strictly into the port's net (H 4, the last layer 1)."""
    jd, _ = both_data(raw)
    jm, tm = gat_nets(16, 4)
    variables = jm.init(jax.random.PRNGKey(5), jd["graph"], train=False)
    ref = export_model_state("arxiv", "gat", to_np(variables))
    got = arxiv_state_dict_from_jax(to_np(variables))
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    tm.load_state_dict(got, strict=True)
    assert set(tm.state_dict()) == set(ref)
    assert tuple(tm.convs[0].att_src.shape) == (1, 4, 4)
    assert tuple(tm.convs[2].att_src.shape) == (1, 1, 16)


def test_gatv2_weight_port_equals_export_model_state(raw):
    """The GATv2 rules give ``export_model_state``'s dict, key for key, and
    it loads strictly into the port's net (H 4, the last layer 1)."""
    jd, _ = both_data(raw)
    jm, tm = gat_nets(16, 4, kind="gatv2")
    variables = jm.init(jax.random.PRNGKey(7), jd["graph"], train=False)
    ref = export_model_state("arxiv", "gatv2", to_np(variables))
    got = arxiv_state_dict_from_jax(to_np(variables))
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    tm.load_state_dict(got, strict=True)
    assert set(tm.state_dict()) == set(ref)
    assert tuple(tm.convs[0].att.shape) == (1, 4, 4)
    assert tuple(tm.convs[2].att.shape) == (1, 1, 16)
    assert tuple(tm.convs[1].lin_r.weight.shape) == (16, 16)


def test_one_training_step(raw):
    """Loss, every parameter gradient, the post-Adam parameters and the BN
    running stats of one step (dropout 0, lr 0.01, wd 5e-4)."""
    jd, td = both_data(raw)
    jm = jax_net(128)
    check_one_step(jd, td, jm, torch_net(128, jm.init(
        jax.random.PRNGKey(4), jd["graph"], train=False)), seed=4,
        params_per_layer=9)


def test_gat_one_training_step(raw):
    """The same step of the GAT net: hidden 16, H 4, the last layer
    single-head."""
    jd, td = both_data(raw)
    jm, tm = gat_nets(16, 4)
    tm.load_state_dict(arxiv_state_dict_from_jax(to_np(jm.init(
        jax.random.PRNGKey(6), jd["graph"], train=False))), strict=True)
    check_one_step(jd, td, jm, tm, seed=6, params_per_layer=6)


def test_gatv2_one_training_step(raw):
    """The same step of the GATv2 net: hidden 16, H 4, the last layer
    single-head; lin_l, lin_r, att and the conv bias in each layer."""
    jd, td = both_data(raw)
    jm, tm = gat_nets(16, 4, kind="gatv2")
    tm.load_state_dict(arxiv_state_dict_from_jax(to_np(jm.init(
        jax.random.PRNGKey(8), jd["graph"], train=False))), strict=True)
    check_one_step(jd, td, jm, tm, seed=8, params_per_layer=8)


def check_one_step(jd, td, jm, tm, *, seed, params_per_layer):
    """One dropout-0 step of the JAX net ``jm`` and the port's ``tm``
    (holding the same weights as ``jm.init(PRNGKey(seed))``)."""
    variables = jm.init(jax.random.PRNGKey(seed), jd["graph"], train=False)
    params, bstats = variables["params"], variables["batch_stats"]
    y, mask = jd["y"], jd["masks"]["train"]

    def loss_fn(p):
        out, mutated = jm.apply({"params": p, "batch_stats": bstats},
                                jd["graph"], train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)},
                                mutable=["batch_stats"])
        return jfg.FullGraphConfig.loss_fn(None, out, (y, mask), None), \
            mutated["batch_stats"]

    (loss_j, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    tx = make_optimizer(0.01, 5e-4)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)

    opt = torch.optim.Adam(tm.parameters(), lr=0.01, weight_decay=5e-4)
    loss_t = tfg.train_step(tm, opt, td)
    assert loss_t.item() == pytest.approx(float(loss_j), rel=1e-5)

    g_sd = arxiv_state_dict_from_jax(
        {"params": to_np(grads), "batch_stats": to_np(new_bs)}, bases=4)
    p_sd = arxiv_state_dict_from_jax(
        {"params": to_np(new_params), "batch_stats": to_np(new_bs)}, bases=4)
    names = dict(tm.named_parameters())
    assert len(names) == 3 * params_per_layer + 4     # BN 2 per layer
    scale = max(float(np.abs(g_sd[k].numpy()).max()) for k in names)
    for name, p in names.items():
        if re.fullmatch(r"convs\.\d+\.bias", name):
            # BatchNorm follows each conv and removes any constant shift,
            # so the conv bias has a true gradient of 0: both sides carry
            # only rounding noise, and Adam scales noise to an lr-sized
            # step of either sign. Gate that the noise is noise.
            for g in (p.grad.numpy(), g_sd[name].numpy()):
                assert np.abs(g).max() <= 1e-6 * scale, name
            assert np.abs(p.detach().numpy()).max() <= 0.01 * (1 + 1e-6)
            continue
        assert rel_l2(p.grad.numpy(), g_sd[name]) <= 1e-4, name
        assert rel_l2(p.detach().numpy(), p_sd[name]) <= 1e-4, name
    for name, buf in tm.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), p_sd[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("log_probs", [True, False])
def test_nll_scores_match_jax(log_probs):
    from egc_tpu.train.losses import nll_scores as jnll
    from egc_tpu_torch.train.losses import nll_scores as tnll
    rng = np.random.default_rng(5)
    out = rng.normal(size=(50, 7)).astype(np.float32)
    if log_probs:
        out = np.array(jax.nn.log_softmax(out, axis=-1))
    labels = rng.integers(0, 7, 50).astype(np.int32)
    ref = jnll(jnp.asarray(out), jnp.asarray(labels), log_probs=log_probs)
    got = tnll(torch.as_tensor(out), torch.as_tensor(labels),
               log_probs=log_probs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_arxiv_net_raw_logits(raw):
    """``log_probs=False`` returns the logits whose log-softmax is the
    default output."""
    _, td = both_data(raw)
    spec = ConvSpec(kind="egc", heads=4, bases=4, aggrs=AGGRS)
    a = TArxivNet(spec, 32, generator=torch.Generator().manual_seed(0))
    b = TArxivNet(spec, 32, log_probs=False,
                  generator=torch.Generator().manual_seed(0))
    a.eval()
    b.eval()
    with torch.no_grad():
        torch.testing.assert_close(torch.log_softmax(b(td["graph"]), -1),
                                   a(td["graph"]))
