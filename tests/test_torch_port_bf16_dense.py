"""Port parity for the opt-in bf16 EGConv matmuls (``EGC_TPU_BF16_DENSE=1``,
``egc_tpu_torch.nn.conv.egc.bf16_matmuls``) against the JAX package's
fused-mix branch on the CPU.

JAX takes bf16 only where ``use_fused_mix`` holds
(``egc_tpu/nn/conv/egc.py:95-98``), so its side runs as
``tests/test_headmix.py`` forces that branch: ``jax.default_backend``
reports "tpu", ``pl.pallas_call`` runs in interpret mode, and
``EGC_TPU_HEADMIX_MIN_ROWS=0``. The port's graphs carry a kernel plan and
its threshold ``BF16_MIN_ROWS`` is set to 0 the same way. Inputs and
weights are numpy-seeded; the weights go across through
``exp/weight_port``'s rules.

Tolerances: values relative L2 <= 1e-5; the cotangents of x, the bases,
the comb weight and bias, and one Adam step's gradients and parameters
<= 1e-4. Off the switch the port's output is bitwise its f32 output.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from egc_tpu_torch.exp.weight_port import arxiv_state_dict_from_jax
from egc_tpu_torch.nn.conv import egc as tegc

torch.set_num_threads(2)
N, E = 300, 1200
AGGRS = ("symnorm", "max")
PLAN = dict(fwd_block_rows=128, fwd_window_rows=256, bwd_block_rows=256,
            bwd_window_rows=128)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture
def fused_branch(monkeypatch):
    """JAX on its ``use_fused_mix`` branch, the port's threshold at 0,
    and the opt-in set for both."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interpret(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interpret)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setenv("EGC_TPU_HEADMIX_MIN_ROWS", "0")
    monkeypatch.setenv("EGC_TPU_BF16_DENSE", "1")
    monkeypatch.setattr(tegc, "BF16_MIN_ROWS", 0)


def small_graph(seed=1):
    from egc_tpu_torch.graph.transforms import coalesce_np
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N, E).astype(np.int32)
    r = rng.integers(0, N, E).astype(np.int32)
    keep = s != r
    s, r, _ = coalesce_np(s[keep], r[keep], N)
    return rng, s, r


def both_graphs(x, s, r, plan=True):
    from egc_tpu.graph.structure import Graph as JGraph
    from egc_tpu.ops.dispatch import build_kernel_plan as jplan
    from egc_tpu_torch.graph.structure import Graph as TGraph
    from egc_tpu_torch.ops.dispatch import build_kernel_plan as tplan
    gj = JGraph.from_coo(x, s, r).replace(
        kernel_plan=jplan(s, r, x.shape[0], **PLAN))
    gt = TGraph.from_coo(x, s, r)
    if plan:
        gt = gt.replace(kernel_plan=tplan(s, r, x.shape[0]))
    return gj, gt


def conv_pair(kind, fan_in, out, heads, bases):
    """The JAX ``EGConv`` and the port's layer of ``kind`` ("paper":
    ``EGConv``; "optimized": ``OptimizedEGConv``) and the rule that
    carries JAX's parameters (or their gradients) across."""
    from egc_tpu.nn.conv.egc import EGConv as JEGConv
    mode = "paper" if kind == "paper" else "all"
    jconv = JEGConv(out, num_heads=heads, num_bases=bases, aggrs=AGGRS,
                    self_loop_mode=mode)
    if kind == "paper":
        tconv = tegc.EGConv(fan_in, out, num_heads=heads, num_bases=bases,
                            aggrs=AGGRS)

        def port(p):
            sd = arxiv_state_dict_from_jax({"params": {
                "EGConv_0": to_np(p), "embed": _dense(), "out": _dense()}},
                bases=bases)
            return {k[len("convs.0."):]: v for k, v in sd.items()
                    if k.startswith("convs.0.")}
    else:
        tconv = tegc.OptimizedEGConv(fan_in, out, num_heads=heads,
                                     num_bases=bases, aggrs=AGGRS)
        inv = np.argsort(tegc.comb_perm(heads, bases, len(AGGRS)))

        def port(p):
            p = to_np(p)
            return {"bases_weight": torch.tensor(p["bases"]["kernel"]),
                    "comb_weight.weight": torch.tensor(
                        p["comb"]["kernel"][:, inv].T.copy()),
                    "comb_weight.bias": torch.tensor(p["comb"]["bias"][inv]),
                    "bias": torch.tensor(p["bias"])}
    return jconv, tconv, port


def _dense():
    return {"kernel": np.zeros((1, 1), np.float32),
            "bias": np.zeros((1,), np.float32)}


def conv_case(kind, fan_in, out=16, heads=4, bases=2):
    """Numpy-seeded inputs, JAX's init with a nudged bias, both layers."""
    rng, s, r = small_graph()
    x = rng.normal(size=(N, fan_in)).astype(np.float32)
    proj = rng.normal(size=(N, out)).astype(np.float32)
    gj, gt = both_graphs(x, s, r)
    jconv, tconv, port = conv_pair(kind, fan_in, out, heads, bases)
    params = dict(jconv.init(jax.random.PRNGKey(1), jax.tree.map(
        jnp.asarray, gj), jnp.asarray(x))["params"])
    params["bias"] = jnp.asarray(rng.normal(size=(out,)).astype(np.float32))
    tconv.load_state_dict(port(params), strict=True)
    return dict(x=x, proj=proj, gj=jax.tree.map(jnp.asarray, gj), gt=gt,
                jconv=jconv, tconv=tconv, port=port, params=params)


def port_run(c, g=None):
    xt = torch.tensor(c["x"], requires_grad=True)
    out = c["tconv"](c["gt"] if g is None else g, xt)
    c["tconv"].zero_grad()
    (out * torch.as_tensor(c["proj"])).sum().backward()
    return out.detach(), xt.grad, {n: p.grad.clone() for n, p in
                                   c["tconv"].named_parameters()}


@pytest.mark.parametrize("kind", ["paper", "optimized"])
@pytest.mark.parametrize("fan_in", [24, 200])
def test_conv_matches_jax_fused_branch(fused_branch, kind, fan_in):
    """One layer with the opt-in against JAX's bf16 branch: the output,
    and the cotangents of x, the bases, the comb weight and bias (fan-in
    200 takes JAX's one product over [bases | comb])."""
    c = conv_case(kind, fan_in)
    jconv, gj = c["jconv"], c["gj"]

    def fj(p, xx):
        out = jconv.apply({"params": p}, gj, xx)
        return jnp.sum(out * c["proj"]), out

    (_, out_j), (gp, gx) = jax.value_and_grad(fj, argnums=(0, 1),
                                              has_aux=True)(
        c["params"], jnp.asarray(c["x"]))
    out_t, gx_t, grads = port_run(c)
    assert rel_l2(out_t.numpy(), out_j) <= 1e-5
    assert rel_l2(gx_t.numpy(), gx) <= 1e-4
    ref = c["port"](gp)
    assert set(grads) == set(ref)
    for name, g in grads.items():
        assert rel_l2(g.numpy(), np.asarray(ref[name])) <= 1e-4, name
    # and the opt-in did act: the f32 layer is another function
    f32 = c["tconv"](c["gt"].replace(kernel_plan=None), torch.tensor(c["x"]))
    assert rel_l2(out_t.numpy(), f32.detach().numpy()) > 1e-4


def test_conv_bf16_dense_bitwise_off_the_switch(monkeypatch):
    """Without the variable, without a plan, or below the threshold, the
    layer's output and gradients are bitwise its f32 ones; with all three
    it is the bf16 function."""
    c = conv_case("paper", 24)
    monkeypatch.delenv("EGC_TPU_BF16_DENSE", raising=False)
    ref = port_run(c)
    monkeypatch.setenv("EGC_TPU_BF16_DENSE", "1")
    cases = {"no plan": (0, c["gt"].replace(kernel_plan=None)),
             "below the threshold": (N + 1, None)}
    for label, (rows, g) in cases.items():
        monkeypatch.setattr(tegc, "BF16_MIN_ROWS", rows)
        got = port_run(c, g)
        assert torch.equal(got[0], ref[0]), label
        assert torch.equal(got[1], ref[1]), label
        for name in ref[2]:
            assert torch.equal(got[2][name], ref[2][name]), (label, name)
    monkeypatch.setattr(tegc, "BF16_MIN_ROWS", N)
    assert tegc.bf16_dense(c["gt"], N)
    got = port_run(c)
    assert not torch.equal(got[0], ref[0])
    assert rel_l2(got[0].numpy(), ref[0].numpy()) <= 1e-2


def test_bf16_matmuls_are_jax_vjp():
    """``bf16_matmuls`` of one x and two weights against ``jax.vjp`` of
    the same bf16 products: the values, each dW rounded to bf16 and dx
    summed in bf16 (``add_any``), all on the bf16 grid."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 24)).astype(np.float32)
    ws = [rng.normal(size=(24, m)).astype(np.float32) for m in (16, 8)]
    cts = [rng.normal(size=(64, m)).astype(np.float32) for m in (16, 8)]

    def fj(xx, w1, w2):
        xm = xx.astype(jnp.bfloat16)
        return tuple(jnp.matmul(xm, w.astype(jnp.bfloat16),
                                preferred_element_type=jnp.float32)
                     for w in (w1, w2))

    outs_j, vjp = jax.vjp(fj, x, *ws)
    grads_j = vjp(tuple(jnp.asarray(ct) for ct in cts))
    xt = torch.tensor(x, requires_grad=True)
    wt = [torch.tensor(w, requires_grad=True) for w in ws]
    outs_t = tegc.bf16_matmuls(xt, *wt)
    torch.autograd.backward(outs_t, [torch.tensor(ct) for ct in cts])
    for got, ref in zip(outs_t, outs_j):
        assert got.dtype == torch.float32
        assert rel_l2(got.detach().numpy(), ref) <= 1e-6
    for got, ref in zip([xt.grad] + [w.grad for w in wt], grads_j):
        got, ref = got.numpy(), np.asarray(ref)
        # every gradient lies on the bf16 grid, as JAX's does
        assert np.array_equal(got, got.astype(jnp.bfloat16).astype(
            np.float32))
        assert rel_l2(got, ref) <= 1e-4
    # an x that needs no gradient (a net's input features) gets none, and
    # the weights' gradients do not change
    wt2 = [torch.tensor(w, requires_grad=True) for w in ws]
    torch.autograd.backward(tegc.bf16_matmuls(torch.tensor(x), *wt2),
                            [torch.tensor(ct) for ct in cts])
    for a, b in zip(wt2, wt):
        assert torch.equal(a.grad, b.grad)


def test_arxiv_step_matches_jax_fused_branch(fused_branch):
    """One dropout-0 Adam step of an ``ArxivNet`` h16, 2 layers, EGC H2 B2
    symnorm/max, with the opt-in: the loss, every gradient and every
    parameter after the step against JAX's on its bf16 branch."""
    from egc_tpu.data import synthetic as jsyn
    from egc_tpu.exp import fullgraph as jfg
    from egc_tpu.models.nets import ArxivNet as JArxivNet
    from egc_tpu.models.nets import ConvSpec as JSpec
    from egc_tpu.train.optim import make_optimizer
    from egc_tpu_torch.exp import fullgraph as tfg
    from egc_tpu_torch.models.nets import ArxivNet, ConvSpec
    raw = jsyn.synthetic_full_graph(num_nodes=N, avg_degree=8, seed=1,
                                    num_features=24, num_classes=5)
    jd = jfg.full_graph_to_device_dict(raw, plan_kwargs=PLAN)
    td = tfg.full_graph_to_device_dict(raw, device="cpu")
    assert jd["graph"].kernel_plan is not None
    assert td["graph"].kernel_plan is not None
    conv = dict(kind="egc", heads=2, bases=2, aggrs=AGGRS)
    jm = JArxivNet(conv=JSpec(**conv), hidden_dim=16, num_layers=2,
                   dropout=0.0, num_features=24, num_classes=5)
    variables = jm.init(jax.random.PRNGKey(4), jd["graph"], train=False)
    tm = ArxivNet(ConvSpec(**conv), 16, num_layers=2, dropout=0.0,
                  num_features=24, num_classes=5)
    tm.load_state_dict(arxiv_state_dict_from_jax(to_np(variables), bases=2),
                       strict=True)
    params, bstats = variables["params"], variables["batch_stats"]

    def loss_fn(p):
        out, _ = jm.apply({"params": p, "batch_stats": bstats}, jd["graph"],
                          train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                          mutable=["batch_stats"])
        return jfg.FullGraphConfig.loss_fn(None, out, (jd["y"],
                                                       jd["masks"]["train"]),
                                           None)

    loss_j, grads = jax.value_and_grad(loss_fn)(params)
    tx = make_optimizer(0.01, 5e-4)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)

    opt = torch.optim.Adam(tm.parameters(), lr=0.01, weight_decay=5e-4)
    loss_t = tfg.train_step(tm, opt, td)
    assert rel_l2(loss_t.item(), float(loss_j)) <= 1e-5
    g_sd = arxiv_state_dict_from_jax(
        {"params": to_np(grads), "batch_stats": to_np(bstats)}, bases=2)
    p_sd = arxiv_state_dict_from_jax(
        {"params": to_np(new_params), "batch_stats": to_np(bstats)}, bases=2)
    names = dict(tm.named_parameters())
    scale = max(float(np.abs(g_sd[k].numpy()).max()) for k in names)
    for name, p in names.items():
        if re.fullmatch(r"convs\.\d+\.bias", name):
            # the conv bias feeds a BatchNorm: its true gradient is 0
            for g in (p.grad.numpy(), g_sd[name].numpy()):
                assert np.abs(g).max() <= 1e-6 * scale, name
            continue
        assert rel_l2(p.grad.numpy(), g_sd[name]) <= 1e-4, name
        assert rel_l2(p.detach().numpy(), p_sd[name]) <= 1e-4, name


def test_egconv_overlap_stays_f32(monkeypatch):
    """``parallel/halo.egconv_overlap`` (the plan-free partitioned path,
    as JAX's ``EGConvOverlap``) takes f32 matmuls with the variable set
    and the threshold at 0: bitwise its output without the variable."""
    import torch.distributed as dist
    from egc_tpu_torch.parallel.halo import egconv_overlap
    from egc_tpu_torch.parallel.mesh import free_port
    from egc_tpu_torch.parallel.partition import partition_graph
    rng, s, r = small_graph(2)
    x = rng.normal(size=(N, 16)).astype(np.float32)
    conv = tegc.EGConv(16, 16, num_heads=4, num_bases=2, aggrs=AGGRS,
                       generator=torch.Generator().manual_seed(0))
    from egc_tpu_torch.graph.transforms import symnorm_weight
    ew, sw = symnorm_weight(torch.as_tensor(s), torch.as_tensor(r), N)
    plan = partition_graph(s, r, N, 1, method="bfs", sym_edge_w=ew.numpy(),
                           sym_self_w=sw.numpy())
    xe = np.zeros((plan.n_ext, 16), np.float32)
    xe[:plan.n_local] = plan.scatter_nodes(x)[0]
    g = plan.extended_graph(0, xe)
    sidx = torch.from_numpy(plan.send_idx[0])
    monkeypatch.setattr(tegc, "BF16_MIN_ROWS", 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        outs = []
        for value in (None, "1"):
            if value is None:
                monkeypatch.delenv("EGC_TPU_BF16_DENSE", raising=False)
            else:
                monkeypatch.setenv("EGC_TPU_BF16_DENSE", value)
            outs.append(egconv_overlap(conv, g, g.nodes, sidx,
                                       e_interior=plan.e_interior))
    finally:
        dist.destroy_process_group()
    assert torch.equal(outs[0], outs[1])
