"""Port parity for ``ArxivNet`` of all nine kinds against the JAX package
(CPU, from the same weights): the weight port of the six conv-zoo kinds
against ``export_model_state``, PNA's ``avg_log_deg``, and the eval
forward and one dropout-0 Adam step of every kind.

Tolerances: values rtol = atol = 1e-4, gradients relative L2 <= 1e-4,
the loss rtol 1e-5.
"""

import re

import numpy as np
import jax
import optax
import pytest
import torch

from egc_tpu.data import synthetic as jsyn
from egc_tpu.exp import fullgraph as jfg
from egc_tpu.exp.weight_port import export_model_state
from egc_tpu.models.nets import ArxivNet as JArxivNet, ConvSpec as JSpec
from egc_tpu.nn.conv import pna as jpna
from egc_tpu.train.optim import make_optimizer

from egc_tpu_torch.exp import fullgraph as tfg
from egc_tpu_torch.exp.weight_port import arxiv_state_dict_from_jax
from egc_tpu_torch.models.nets import ArxivNet as TArxivNet, ConvSpec
from egc_tpu_torch.nn.conv.pna import avg_log_degree

torch.set_num_threads(2)
ZOO = ("gcn", "gin", "sage", "mpnn-sum", "mpnn-max", "pna")
KINDS = ("gcn", "gat", "gatv2", "gin", "mpnn-sum", "mpnn-max", "pna",
         "sage", "egc")


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def raw():
    return jsyn.synthetic_full_graph(num_nodes=300, avg_degree=8, seed=1)


@pytest.fixture(scope="module")
def both(raw):
    return (jfg.full_graph_to_device_dict(raw, use_kernel=False),
            tfg.full_graph_to_device_dict(raw, device="cpu"))


def nets(kind, hidden, ald):
    """The JAX and port ArxivNet of ``kind`` at dropout 0 (EGC: H4 B4
    symnorm/max/mean; GAT / GATv2: H4, the last layer single-head)."""
    kw = {}
    if kind == "egc":
        kw = dict(heads=4, bases=4, aggrs=("symnorm", "max", "mean"))
    elif kind in ("gat", "gatv2"):
        kw = dict(heads=4)
    jm = JArxivNet(conv=JSpec(kind=kind, avg_log_deg=ald, **kw),
                   hidden_dim=hidden, num_layers=3, dropout=0.0)
    tm = TArxivNet(ConvSpec(kind=kind, avg_log_deg=ald, **kw), hidden,
                   num_layers=3, dropout=0.0)
    return jm, tm


def test_avg_log_deg_matches_jax(both):
    jd, td = both
    assert td["avg_log_deg"] == jd["avg_log_deg"]
    hist = np.array([0, 3, 5, 1, 0, 2])
    assert avg_log_degree(hist) == jpna.avg_log_degree(hist)


@pytest.mark.parametrize("kind", ZOO)
def test_weight_port_equals_export_model_state(both, kind):
    """The rules give ``export_model_state``'s dict, key for key and in
    its order, and it loads strictly into the port's net."""
    jd, _ = both
    jm, tm = nets(kind, 16, jd["avg_log_deg"])
    variables = to_np(jm.init(jax.random.PRNGKey(11), jd["graph"],
                              train=False))
    ref = export_model_state("arxiv", kind, variables)
    got = arxiv_state_dict_from_jax(variables, kind=kind)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    tm.load_state_dict(got, strict=True)
    assert set(tm.state_dict()) == set(ref)
    with pytest.raises(ValueError, match="hold no"):
        arxiv_state_dict_from_jax(variables, kind="gat")


def test_conv_spec_takes_the_jax_kinds_and_refuses_others():
    """The port builds exactly the JAX package's kinds; any other kind
    raises, naming the supported ones."""
    from egc_tpu.models.nets import MODEL_KINDS as JKINDS
    from egc_tpu_torch.models.nets import MODEL_KINDS
    assert tuple(MODEL_KINDS) == tuple(JKINDS)
    with pytest.raises(ValueError, match="supported"):
        ConvSpec(kind="rgcn").build(8, 8, layer_idx=0, num_layers=3)


# parameters that feed a BatchNorm through affine maps only: BN removes
# any constant shift, so their true gradient is 0 (rounding noise on both
# sides), and Adam scales that noise to an lr-sized step of either sign.
# MPNN-max's message biases join them on a graph where every real node
# has an in-edge (a constant shift of every real row's max)
_CANCELLED = {"sage": r"lin_l\.bias", "gin": r"nn\.bias",
              "mpnn-sum": r"lin\.bias|update_layer\.\d+\.bias",
              "mpnn-max": r"lin\.bias|(update|message)_layer\.\d+\.bias",
              "pna": r"lin\.bias|post_nns\.\d+\.0\.bias"}


def bn_cancelled(kind):
    return re.compile(rf"convs\.\d+\.({_CANCELLED.get(kind, 'bias')})")


@pytest.mark.parametrize("kind", KINDS)
def test_arxiv_net_forward_and_one_step(raw, both, kind):
    """The eval forward, then one dropout-0 training step (lr 0.01, wd
    5e-4): loss, every parameter gradient, the parameters after Adam and
    the BN running statistics."""
    jd, td = both
    n = raw["x"].shape[0]
    jm, tm = nets(kind, 16, jd["avg_log_deg"])
    variables = jm.init(jax.random.PRNGKey(12), jd["graph"], train=False)
    tm.load_state_dict(arxiv_state_dict_from_jax(to_np(variables),
                                                 kind=kind), strict=True)
    tm.eval()
    with torch.no_grad():
        got = tm(td["graph"]).numpy()
    ref = np.asarray(jax.jit(lambda v, g: jm.apply(v, g, train=False))(
        variables, jd["graph"]))
    np.testing.assert_allclose(got[:n], ref[:n], rtol=1e-4, atol=1e-4)

    params, bstats = variables["params"], variables["batch_stats"]
    y, mask = jd["y"], jd["masks"]["train"]

    def loss_fn(p):
        out, mutated = jm.apply({"params": p, "batch_stats": bstats},
                                jd["graph"], train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)},
                                mutable=["batch_stats"])
        return jfg.FullGraphConfig.loss_fn(None, out, (y, mask), None), \
            mutated["batch_stats"]

    tx = make_optimizer(0.01, 5e-4)

    @jax.jit
    def step(p):
        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, bs, grads, optax.apply_updates(p, updates)

    loss_j, new_bs, grads, new_params = step(params)
    opt = torch.optim.Adam(tm.parameters(), lr=0.01, weight_decay=5e-4)
    loss_t = tfg.train_step(tm, opt, td)
    assert loss_t.item() == pytest.approx(float(loss_j), rel=1e-5)
    g_sd = arxiv_state_dict_from_jax(
        {"params": to_np(grads), "batch_stats": to_np(new_bs)})
    p_sd = arxiv_state_dict_from_jax(
        {"params": to_np(new_params), "batch_stats": to_np(new_bs)})
    names = dict(tm.named_parameters())
    assert set(names) <= set(g_sd)
    scale = max(float(np.abs(g_sd[k].numpy()).max()) for k in names)
    for name, p in names.items():
        if bn_cancelled(kind).fullmatch(name):
            for g in (p.grad.numpy(), g_sd[name].numpy()):
                assert np.abs(g).max() <= 1e-6 * scale, name
            assert np.abs(p.detach().numpy() - p_sd[name].numpy()).max() \
                <= 0.02 * (1 + 1e-6), name
            continue
        assert rel_l2(p.grad.numpy(), g_sd[name]) <= 1e-4, name
        assert rel_l2(p.detach().numpy(), p_sd[name]) <= 1e-4, name
    for name, buf in tm.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), p_sd[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
