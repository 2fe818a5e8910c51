"""Port parity for neighbour-sampled ogbn-mag against the JAX package on
the CPU: the host sampler and loader (array-equal from the same numpy
streams), the device sampler (equal to JAX's ``raw()`` on JAX's replayed
uniforms) and its invariants, the plan built in torch ops against the host
plan, the fused aggregate on that plan, and ``SampledMagConfig`` (one
step against JAX's ``_sampled_steps`` with the same weights, its trials,
its full-graph eval).

Tolerances: samples, plans and loader items exactly equal; aggregates
rtol = atol = 1e-5 and gradients relative L2 <= 1e-4 (sums in another
order); the sampled step's loss rtol 1e-5, gradients relative L2 <= 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from egc_tpu.data import device_sampling as jds
from egc_tpu.data import sampling as jsamp
from egc_tpu.data import synthetic as jsyn
from egc_tpu.exp import fullgraph as jfg
from egc_tpu.exp.weight_port import import_model_state

from egc_tpu_torch.data import device_sampling as tds
from egc_tpu_torch.data import sampling as tsamp
from egc_tpu_torch.exp import fullgraph as tfg
from egc_tpu_torch.exp.runner import run_trial
from egc_tpu_torch.exp.weight_port import mag_state_dict_from_jax
from egc_tpu_torch.ops.dispatch import (
    build_kernel_plan, build_kernel_plan_device, fused_multi_aggregate,
)
from egc_tpu_torch.ops.segment import multi_aggregate
from egc_tpu_torch.graph.transforms import symnorm_weight

torch.set_num_threads(2)
HIDDEN, HEADS, BASES = 16, 2, 2
HP0 = {"lr": 0.01, "wd": 0.0, "dropout": 0.0}


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def random_graph(seed, n=300, e=2500):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    pair = np.unique(np.stack([s, r], 1), axis=0)   # no duplicate edges
    return pair[:, 0].copy(), pair[:, 1].copy()


def star_graph():
    """Seeds 0-9 take in-edges from 10-49, which have none: the second
    hop's frontier has no in-edge (the sampler stops there)."""
    rng = np.random.default_rng(5)
    r = np.repeat(np.arange(10), 6)
    s = 10 + rng.permutation(np.arange(40).repeat(2))[:60]
    pair = np.unique(np.stack([s, r], 1), axis=0)
    return pair[:, 0].copy(), pair[:, 1].copy(), 50


def small_raw(seed=3, n=400):
    return jsyn.synthetic_full_graph(num_nodes=n, avg_degree=8,
                                     num_classes=349, num_features=24,
                                     seed=seed)


def item_arrays(item):
    g = item[0]
    return [g.nodes, g.senders, g.receivers, g.node_mask, g.edge_mask,
            *item[1:]]


# ---------------------------------------------------------------------------
# the host sampler and loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph,fanouts,seed", [
    ("random", (5, 3), 0), ("random", (15, 10), 1), ("random", (2,), 2),
    ("random", (4, 4, 2), 3), ("star", (3, 5), 4)])
def test_neighbor_sampler_equals_jax(graph, fanouts, seed):
    """``sample`` gives JAX's arrays from the same generator; the star
    graph's second hop has no in-edge."""
    if graph == "star":
        s, r, n = star_graph()
        seeds = np.arange(10)
    else:
        n = 300
        s, r = random_graph(seed, n)
        seeds = np.random.default_rng(seed).choice(n, 24, replace=False)
    js = jsamp.NeighborSampler(s, r, n, fanouts=fanouts)
    ts = tsamp.NeighborSampler(s, r, n, fanouts=fanouts)
    assert ts.budgets(24) == js.budgets(24)
    for k in range(2):
        want = js.sample(seeds, rng=np.random.default_rng([seed, k]))
        got = ts.sample(seeds, rng=np.random.default_rng([seed, k]))
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[3] == want[3]
    if graph == "star":       # the seeds' in-neighbours and no more
        assert set(got[0][10:]) <= set(range(10, 50))
        assert len(got[1]) == 10 * 3


@pytest.mark.parametrize("gather_on_device", [False, True])
def test_loader_items_equal_jax(gather_on_device):
    """Two epochs of shuffled items (a short final batch: 70 seeds in
    batches of 32) equal the JAX loader's, array for array."""
    raw = small_raw()
    n = raw["x"].shape[0]
    seed_ids = raw["train_idx"][:70]
    kw = dict(shuffle=True, rng_seed=7, gather_on_device=gather_on_device)
    jl = jsamp.SampledNodeLoader(
        jsamp.NeighborSampler(raw["senders"], raw["receivers"], n, (4, 3)),
        raw["x"], raw["y"], seed_ids, 32, **kw)
    tl = tsamp.SampledNodeLoader(
        tsamp.NeighborSampler(raw["senders"], raw["receivers"], n, (4, 3)),
        raw["x"], raw["y"], seed_ids, 32, **kw)
    assert (tl.node_budget, tl.edge_budget) == (jl.node_budget,
                                                jl.edge_budget)
    for _ in range(2):
        j_items, t_items = list(jl), list(tl)
        assert len(j_items) == len(t_items) == len(tl) == 3
        for ji, ti in zip(j_items, t_items):
            jg = ji[0]
            want = [jg.nodes, jg.senders, jg.receivers, jg.node_mask,
                    jg.edge_mask, *ji[1:]]
            got = item_arrays(ti)
            assert len(got) == len(want) == (5 + 2 + gather_on_device)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(t_items[-1][2].sum()) == 70 - 64


def test_loader_prefetch_and_plans():
    """Prefetch 2 gives the synchronous loader's items; with
    ``kernel_plans`` each graph carries the host plan of its valid
    edges."""
    raw = small_raw()
    n = raw["x"].shape[0]
    sampler = tsamp.NeighborSampler(raw["senders"], raw["receivers"], n,
                                    (5, 3))

    def mk(prefetch, plans=False):
        return tsamp.SampledNodeLoader(
            sampler, raw["x"], raw["y"], raw["train_idx"][:100], 32,
            rng_seed=11, prefetch=prefetch, gather_on_device=True,
            kernel_plans=plans)

    sync, pre, planned = list(mk(0)), list(mk(2)), list(mk(2, True))
    assert len(sync) == len(pre) == len(planned) == 4
    for a, b, c in zip(sync, pre, planned):
        for x, y, z in zip(item_arrays(a), item_arrays(b),
                           item_arrays(c)):
            assert torch.equal(x, y) and torch.equal(x, z)
        g = c[0]
        plan = g.kernel_plan
        assert plan.num_nodes == g.num_nodes == 32 * (1 + 5 + 15) + 8
        assert int(plan.rowptr[-1]) == int(g.edge_mask.sum())
        want = build_kernel_plan(g.senders.numpy(), g.receivers.numpy(),
                                 g.num_nodes, edge_mask=g.edge_mask.numpy())
        assert torch.equal(plan.fwd_perm, want.fwd_perm)


# ---------------------------------------------------------------------------
# the device sampler
# ---------------------------------------------------------------------------

def jax_uniforms(key, batch, fanouts):
    """The uniforms JAX's ``raw()`` draws, in its order: per hop one key
    split, then one split a Floyd round."""
    draws, fb = [], batch
    for fanout in fanouts:
        key, sub = jax.random.split(key)
        for _ in range(fanout):
            sub, u = jax.random.split(sub)
            draws.append(np.asarray(jax.random.uniform(u, (fb,))))
        fb *= fanout
    return draws


def replay(draws):
    it = iter(draws)

    def uniform(n):
        u = torch.from_numpy(next(it).copy())
        assert u.shape == (n,)
        return u
    return uniform


@pytest.mark.parametrize("k", [1, 3, 6])
def test_floyd_subset_equals_jax(k):
    deg = jnp.asarray(np.array([0, 1, k - 1, k, k + 1, 2 * k, 30, 200]
                               * 4, np.int32).clip(min=0))
    key = jax.random.key(k)
    sel, ok = jds._floyd_subset(key, deg, k)
    draws, sub = [], key
    for _ in range(k):
        sub, u = jax.random.split(sub)
        draws.append(np.asarray(jax.random.uniform(u, deg.shape)))
    got_sel, got_ok = tds._floyd_subset(replay(draws),
                                        torch.from_numpy(np.array(deg)), k)
    np.testing.assert_array_equal(got_sel.numpy(), np.asarray(sel))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ok))


@pytest.mark.parametrize("fanouts,n_seeds,key", [
    ((5, 3), 20, 0), ((15, 10), 64, 1), ((4, 4, 2), 16, 2), ((3,), 32, 3)])
def test_device_sample_equals_jax_raw(fanouts, n_seeds, key):
    """A whole sample (32 seed slots, ``n_seeds`` real ones, the rest the
    sentinel) equals JAX's on its replayed uniforms, every output."""
    n = 300
    s, r = random_graph(key, n)
    seeds = np.full(32 if n_seeds <= 32 else n_seeds, n, np.int32)
    seeds[:n_seeds] = np.random.default_rng(key).choice(n, n_seeds,
                                                        replace=False)
    jsampler = jds.DeviceNeighborSampler(s, r, n, fanouts=fanouts)
    k = jax.random.key(key)
    want = jax.tree.map(np.asarray, jsampler.sample(k, jnp.asarray(seeds)))
    tsampler = tds.DeviceNeighborSampler(s, r, n, fanouts=fanouts,
                                         device="cpu")
    got = tsampler.sample(torch.from_numpy(seeds.astype(np.int64)),
                          uniform=replay(jax_uniforms(k, len(seeds),
                                                      fanouts)))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)


def test_device_sampler_invariants():
    """Every sampled edge is a real one, a receiver gets min(deg, k)
    distinct in-edges a hop (seeds: exactly), padded seed slots sample
    nothing, and the budgets are the host sampler's."""
    n = 400
    s, r = random_graph(9, n, 3000)
    fanouts = (7, 4)
    ts = tds.DeviceNeighborSampler(s, r, n, fanouts=fanouts, device="cpu")
    assert ts.budgets(64) == tsamp.NeighborSampler(
        s, r, n, fanouts=fanouts).budgets(64)
    seeds = np.full(64, n, np.int64)
    seeds[:50] = np.random.default_rng(0).choice(n, 50, replace=False)
    gen = torch.Generator().manual_seed(3)
    gids, sl, rl, em, nm, n_nodes = (
        t.numpy() for t in ts.sample(torch.from_numpy(seeds),
                                     generator=gen))
    assert np.array_equal(gids[:50], seeds[:50])
    assert nm.sum() == n_nodes - 14       # n_nodes counts the seed slots
    assert not nm[50:64].any()
    valid = gids[nm]
    assert len(np.unique(valid)) == len(valid)
    adj = {}
    for a, b in zip(s, r):
        adj.setdefault(int(b), set()).add(int(a))
    per_recv = {}
    hop0 = 64 * fanouts[0]
    for j, (a, b) in enumerate(zip(sl, rl)):
        if not em[j]:
            continue
        ga, gb = int(gids[a]), int(gids[b])
        assert ga in adj.get(gb, set()), (ga, gb)
        per_recv.setdefault((j < hop0, b), []).append(ga)
    for (_, b), lst in per_recv.items():
        assert len(set(lst)) == len(lst)
    for i in range(50):
        deg = len(adj.get(int(seeds[i]), ()))
        assert len(per_recv.get((True, i), [])) == min(deg, fanouts[0])
    assert not set(rl[em]) & set(range(50, 64))


def test_device_loader_item_contract():
    """``(graph, y, seed_mask, gids)`` with the labels of the gids, the
    seed mask on the real seeds, and the sentinel on the short final
    batch's padding."""
    raw = small_raw()
    n = raw["x"].shape[0]
    ts = tds.DeviceNeighborSampler(raw["senders"], raw["receivers"], n,
                                   fanouts=(4, 3), device="cpu")
    loader = tds.DeviceSampledLoader(ts, raw["y"], raw["train_idx"][:70],
                                     32, rng_seed=2)
    items = list(loader)
    assert len(items) == len(loader) == 3
    for g, y, m, gids in items:
        nb, eb = ts.padded_budgets(32)
        assert g.num_nodes == nb and g.num_edges == eb
        gl = gids.long()
        ok = g.node_mask
        np.testing.assert_array_equal(y[ok].numpy(), raw["y"][gl[ok]])
        assert torch.equal(m, (torch.arange(nb) < 32) & ok)
    g, y, m, gids = items[-1]
    assert int(m.sum()) == 6 and (gids[6:32] == n).all()


# ---------------------------------------------------------------------------
# the plan built in torch ops
# ---------------------------------------------------------------------------

def sampled_batch(seed=0, fanouts=(5, 3), batch=24):
    raw = small_raw(seed=seed)
    n = raw["x"].shape[0]
    loader = tsamp.SampledNodeLoader(
        tsamp.NeighborSampler(raw["senders"], raw["receivers"], n, fanouts),
        raw["x"], raw["y"], raw["train_idx"], batch, rng_seed=seed)
    return raw, next(iter(loader))


@pytest.mark.parametrize("seed,fanouts", [(0, (5, 3)), (1, (15, 10)),
                                          (2, (2, 2, 2))])
def test_device_plan_equals_host_plan(seed, fanouts):
    """Every field equals the host plan's on the valid prefix; the masked
    edges sit past ``rowptr[N]`` and ``colptr[N]``."""
    _, (g, _, _) = sampled_batch(seed, fanouts)
    host = build_kernel_plan(g.senders.numpy(), g.receivers.numpy(),
                             g.num_nodes, edge_mask=g.edge_mask.numpy())
    dev = build_kernel_plan_device(g.senders, g.receivers, g.num_nodes,
                                   edge_mask=g.edge_mask)
    e = int(g.edge_mask.sum())
    assert e < g.num_edges
    assert dev.num_nodes == host.num_nodes and dev.num_src is None
    assert dev.fwd_w is None and dev.bwd_w is None
    for name in ("rowptr", "colptr", "deg"):
        a, b = getattr(dev, name), getattr(host, name)
        assert a.dtype == b.dtype
        assert torch.equal(a, b), name
    for name in ("fwd_senders", "fwd_perm", "bwd_receivers", "bwd_perm",
                 "fwd_to_bwd"):
        a, b = getattr(dev, name), getattr(host, name)
        assert a.dtype == b.dtype and a.shape[0] == g.num_edges
        assert b.shape[0] == e
        assert torch.equal(a[:e], b), name
    assert int(dev.rowptr[-1]) == int(dev.colptr[-1]) == e
    tail = ~g.edge_mask
    assert torch.equal(torch.sort(dev.fwd_perm[e:]).values,
                       torch.nonzero(tail).flatten())
    assert torch.equal(torch.sort(dev.bwd_perm[e:]).values,
                       torch.nonzero(tail).flatten())


@pytest.mark.parametrize("aggrs,include_self", [
    (("symnorm", "max", "mean"), False), (("symnorm", "max", "mean"), True),
    (("sum", "min", "std"), True)])
def test_fused_aggregate_on_device_plan(aggrs, include_self):
    """``fused_multi_aggregate`` on the device-built plan (the kernels'
    plain versions, reading the valid prefix) equals ``multi_aggregate``
    with the edge mask: values and gradients."""
    _, (g, _, _) = sampled_batch(1, (6, 4))
    plan = build_kernel_plan_device(g.senders, g.receivers, g.num_nodes,
                                    edge_mask=g.edge_mask)
    x = torch.randn(g.num_nodes, 12,
                    generator=torch.Generator().manual_seed(0))
    ew, sw = symnorm_weight(g.senders, g.receivers, g.num_nodes,
                            edge_mask=g.edge_mask)
    dz = torch.randn(g.num_nodes, len(aggrs), 12,
                     generator=torch.Generator().manual_seed(1))
    outs, grads = [], []
    for fused in (True, False):
        v = x.clone().requires_grad_(True)
        if fused:
            out = fused_multi_aggregate(v, plan, aggrs,
                                        include_self=include_self,
                                        symnorm_edge_w=ew,
                                        symnorm_self_w=sw)
        else:
            out = multi_aggregate(v, g.senders, g.receivers, aggrs,
                                  edge_mask=g.edge_mask,
                                  include_self=include_self,
                                  symnorm_edge_w=ew, symnorm_self_w=sw)
        (out * dz).sum().backward()
        outs.append(out.detach())
        grads.append(v.grad)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-5,
                               atol=1e-5)
    assert rel_l2(grads[0], grads[1]) <= 1e-4


# ---------------------------------------------------------------------------
# SampledMagConfig
# ---------------------------------------------------------------------------

def configs(raw, device_sampler=False, batch_size=32, fanouts=(5, 3)):
    kw = dict(heads=HEADS, bases=BASES, aggrs=("symnorm",),
              fanouts=fanouts, batch_size=batch_size,
              device_sampler=device_sampler)
    jcfg = jfg.SampledMagConfig("egc", HIDDEN, **kw)
    tcfg = tfg.SampledMagConfig("egc", HIDDEN, device="cpu", **kw)
    for cfg in (jcfg, tcfg):
        cfg.load_full_graph = lambda: raw
    return jcfg, tcfg


def test_sampled_mag_config_surface_equals_jax():
    """Defaults (fanouts (15, 10), batch 512, the host sampler), and the
    rest of ``MagConfig``'s surface."""
    jcfg = jfg.SampledMagConfig("egc", 16)
    tcfg = tfg.SampledMagConfig("egc", 16, device="cpu")
    assert (tcfg.fanouts, tcfg.batch_size, tcfg.device_sampler) == \
        (jcfg.fanouts, jcfg.batch_size, jcfg.device_sampler) == \
        ((15, 10), 512, False)
    assert tcfg.default_hparams() == jcfg.default_hparams()
    assert tcfg.settings().name == jcfg.settings().name == "mag"
    assert tcfg.num_layers == jcfg.num_layers == 2


def test_sampled_step_equals_jax():
    """One step on a host-sampled batch at dropout 0 with the JAX weights:
    the loss of JAX's ``_sampled_steps`` step and the gradients of its
    loss; the full-graph eval of the same weights gives JAX's accuracies."""
    raw = small_raw()
    jcfg, tcfg = configs(raw)
    jdata, tdata = jcfg.data(HP0), tcfg.data(HP0)
    jmodel = jcfg.model(HP0)
    jstate = jcfg.init_state(jmodel, HP0, jdata, 0)
    variables = jax.tree.map(np.asarray, {"params": jstate.params})
    tmodel = tcfg.model(HP0)
    tmodel.load_state_dict(mag_state_dict_from_jax(
        variables, heads=HEADS, bases=BASES, num_aggrs=1), strict=True)
    np.testing.assert_array_equal(tdata["x_full"].numpy(), raw["x"])
    assert tdata["x_full"].untyped_storage().data_ptr() == \
        tdata["full"]["graph"].nodes.untyped_storage().data_ptr()

    # the full-graph eval of the same weights
    assert tcfg.val(tmodel, None, tdata) == pytest.approx(
        jcfg.val(jmodel, jstate, jdata), abs=1e-7)

    item = next(iter(tdata["loader"]))
    jitem = next(iter(jdata["loaders"]["train"]))
    for a, b in zip(item_arrays(item), item_arrays((jitem[0],
                                                    *jitem[1:]))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    g, yb, m, gids = item
    jg = jax.tree.map(jnp.asarray, jitem[0])
    key = jax.random.key(0)
    x_full = jdata["x_full"]
    jy = (jnp.asarray(yb.numpy()), jnp.asarray(m.numpy()))
    _, jloss = jcfg._sampled_steps(jmodel)(
        jstate, jg, jnp.asarray(gids.numpy()), x_full, jy, key)

    def loss_of(params):
        graph = jg.replace(nodes=jnp.take(x_full, jnp.asarray(gids.numpy()),
                                          axis=0))
        out = jmodel.apply({"params": params}, graph, train=True,
                           rngs={"dropout": key})
        return jcfg.loss_fn(out, jy, graph)

    lj, grads = jax.value_and_grad(loss_of)(jstate.params)
    assert float(lj) == pytest.approx(float(jloss), rel=1e-6)
    opt = tcfg.init_state(tmodel, HP0, tdata, 0)
    lt = tcfg.sampled_step(tmodel, opt, tdata["x_full"], g, yb, m, gids)
    assert float(lt) == pytest.approx(float(jloss), rel=1e-5)
    g_sd = mag_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, grads)}, heads=HEADS,
        bases=BASES, num_aggrs=1)
    for name, p in tmodel.named_parameters():
        assert rel_l2(p.grad.numpy(), g_sd[name]) <= 1e-4, name


@pytest.mark.parametrize("device_sampler", [False, True])
def test_run_trial_of_both_branches(device_sampler):
    """Three iterations through ``run_trial``: finite losses, every
    iteration's batches, and a full-graph val equal to ``MagConfig.val``
    of the same weights; the weights also give JAX's eval accuracies."""
    raw = small_raw(seed=6)
    jcfg, tcfg = configs(raw, device_sampler, batch_size=64)
    hp = {"lr": 0.01, "wd": 0.0, "dropout": 0.1}
    seen = []
    step = tcfg.sampled_step

    def counting(*a, **kw):
        seen.append(a[3].num_nodes)
        return step(*a, **kw)

    tcfg.sampled_step = counting
    res = run_trial(tcfg, hp, seed=0, max_iterations=3, patience=10,
                    verbose=False)
    batches = -(-len(raw["train_idx"]) // 64)
    assert len(seen) == 3 * batches
    assert len(set(seen)) == 1
    assert all(np.isfinite(h["train_loss"]) for h in res["history"])
    model = res["model"]
    mcfg = tfg.MagConfig("egc", HIDDEN, heads=HEADS, bases=BASES,
                         device="cpu")
    mcfg.load_full_graph = lambda: raw
    want = mcfg.val(model, None, mcfg.data(hp))
    assert tcfg.val(model, res["state"], res["data"]) == want
    assert res["test"] == want

    jdata = jcfg.data(hp)
    jmodel = jcfg.model(hp)
    jstate = jcfg.init_state(jmodel, hp, jdata, 0)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    imported = import_model_state("mag", "egc", sd,
                                  {"params": jstate.params}, heads=HEADS,
                                  bases=BASES, aggrs=("symnorm",))
    jstate = jstate.replace(params=imported["params"])
    assert jcfg.val(jmodel, jstate, jdata) == pytest.approx(want,
                                                             abs=1e-7)


def test_device_branch_batches_follow_the_trial_generator():
    """The device branch's epoch: one batch per ``batch_size`` seeds, the
    seeds of each epoch a permutation of the train split, and the same
    batches for the same trial generator and iteration."""
    raw = small_raw()
    _, tcfg = configs(raw, device_sampler=True)
    data = tcfg.data(HP0)
    rng = tcfg.rng(4)

    def epoch(it):
        return [(g.senders.clone(), gids.clone()) for _, g, _, _, gids
                in tcfg.batches(data, rng, it)]

    a, b, c = epoch(0), epoch(0), epoch(1)
    assert len(a) == -(-len(raw["train_idx"]) // 32)
    for (s1, g1), (s2, g2) in zip(a, b):
        assert torch.equal(s1, s2) and torch.equal(g1, g2)
    seeds = torch.cat([g[:32] for _, g in a])
    seeds = seeds[seeds < raw["x"].shape[0]]
    assert sorted(seeds.tolist()) == sorted(raw["train_idx"].tolist())
    assert not all(torch.equal(x[1], y[1]) for x, y in zip(a, c))
