"""Port parity for graph-partitioned heterogeneous ogbn-mag (``rmag
--partitions``: ``parallel/hetero_partition``, ``parallel/hetero_halo``,
``PartitionedRMagConfig``, the CLI) against the JAX package on the CPU.

The port's partitions are gloo ranks (``parallel.mesh.spawn``; each
spawned group runs under a 120 s timeout, so a hang fails); the JAX
package's are 2 or 4 of the 8 forced host devices. Both sides start from
the same weights: a JAX ``REGCNet`` init on ``synthetic_rmag``'s 300
papers (``tests/test_hetero_partition.py``'s graph), through the weight
port.

Tolerances: the plan array-equal; the halo bitwise; a rank's relation
aggregate at 2e-4 against JAX's fused path (Pallas in interpret mode) and
the port's segment path; the partitioned forward at 2e-4
(``tests/test_hetero_partition.py``'s) against JAX's
``DistributedREGCNet`` and the port's single-device ``REGCNet``; one
Adam step's loss at rtol 1e-5 and its gradients, parameters and gathered
embedding rows at relative L2 1e-4.
"""

import ast
import contextlib
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from egc_tpu_torch.data import synthetic as tsyn
from egc_tpu_torch.exp import hetero as thet
from egc_tpu_torch.graph import hetero as thg
from egc_tpu_torch.parallel import hetero_partition as tpart
from egc_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)
TIMEOUT = 120
HIDDEN, HEADS, BASES = 16, 2, 2
SMALL = dict(num_paper=300, num_author=150, num_inst=20, num_fos=30,
             num_classes=6, num_features=16)
HP = {"lr": 0.05, "wd": 1e-3, "dropout": 0.0}
TRIAL_HP = {"lr": 0.01, "wd": 1e-4, "dropout": 0.0}
AGGRS = ("mean", "max")
SMALL_GEOM = dict(fwd_block_rows=128, fwd_window_rows=256,
                  bwd_block_rows=256, bwd_window_rows=128)
REPO = pathlib.Path(__file__).resolve().parents[1]


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def small_raw(seed=3):
    return tsyn.synthetic_rmag(**SMALL, seed=seed)


def padded_counts(raw):
    hg = thg.hetero_from_numpy(raw["nodes"], raw["edges"])
    return {t: hg.num_nodes(t) for t in hg.node_types}


def port_plan(raw, parts, method="bfs"):
    return tpart.partition_hetero(padded_counts(raw), raw["edges"], parts,
                                  method=method)


def zero_type_graph():
    """Three types, one of them with no node and no edge."""
    rng = np.random.default_rng(2)
    num_nodes = {"a": 40, "b": 0, "c": 25}
    edges = {thg.rel_key("a", "x", "c"): (rng.integers(0, 40, 120),
                                          rng.integers(0, 25, 120)),
             thg.rel_key("c", "y", "a"): (rng.integers(0, 25, 90),
                                          rng.integers(0, 40, 90)),
             thg.rel_key("a", "z", "a"): (rng.integers(0, 40, 60),
                                          rng.integers(0, 40, 60))}
    return num_nodes, edges


GRAPHS = {"rmag": lambda: (padded_counts(small_raw()), small_raw()["edges"]),
          "zero_type": zero_type_graph}


class SmallPartitioned(thet.PartitionedRMagConfig):
    """``PartitionedRMagConfig`` at h16 H2 B2 on ``small_raw(seed)``; its
    nets load ``weights`` (``REGCNet``'s state dict) when given."""

    def __init__(self, mesh, weights=None, seed=3):
        super().__init__(HIDDEN, heads=HEADS, bases=BASES, mesh=mesh)
        self.weights, self.seed = weights, seed

    def load_hetero(self):
        return small_raw(self.seed)

    def model(self, hparams, *, seed=0):
        net = super().model(hparams, seed=seed)
        if self.weights is not None:
            net.load_full_state_dict(self.weights)
        return net


# ---------------------------------------------------------------------------
# the ranks' work: one spawned group a world size
# ---------------------------------------------------------------------------

def rank_work(mesh, weights, x_halo, step):
    """One rank's share: the halo refresh of ``x_halo`` (each type's rows),
    the eval forward of ``DistributedREGCNet`` from ``weights``, and, when
    ``step``, one ``partitioned_rmag_train_step`` with Adam (L2 in the
    gradient): its loss, the replicated gradients, the embeddings'
    gradients and the state after the step, gathered to full tables."""
    from egc_tpu_torch.parallel.halo import halo_refresh
    from egc_tpu_torch.parallel.hetero_halo import (
        full_optimizer_state, gathered_embedding_grads,
        partitioned_rmag_eval, partitioned_rmag_train_step,
    )
    from egc_tpu_torch.train.optim import make_optimizer
    cfg = SmallPartitioned(mesh, weights)
    d = cfg.data(HP)
    plan, r = d["plan"], mesh.rank
    out = {"gids": {t: tp.node_gids[r] for t, tp in plan.types.items()},
           "halo": {}}
    for t, x in x_halo.items():
        tp = plan.types[t]
        xe = np.zeros((tp.n_ext, x.shape[1]), np.float32)
        xe[:tp.n_local] = tp.rank_rows(x, r)
        out["halo"][t] = halo_refresh(torch.from_numpy(xe),
                                      d["send_idx"][t]).numpy()
    net = cfg.model(HP)
    n_local = plan.types["paper"].n_local
    out["fwd"] = partitioned_rmag_eval(net, d["hetero"],
                                       d["send_idx"])[:n_local].numpy()
    if step:
        opt = make_optimizer(net.parameters(), HP["lr"], HP["wd"])
        loss = partitioned_rmag_train_step(
            net, opt, d["hetero"], d["send_idx"], d["y"],
            d["masks"]["train"])
        out["step"] = {
            "loss": float(loss),
            "grads": {n: p.grad.numpy() for n, p in net.named_parameters()
                      if not n.startswith("embs.")},
            "emb_grads": {t: g.numpy() for t, g in
                          gathered_embedding_grads(net).items()},
            "new": {k: v.numpy() for k, v in
                    net.full_state_dict().items()},
            "opt": {i: {k: v.numpy() for k, v in st.items()} for i, st in
                    full_optimizer_state(net, opt)["state"].items()}}
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def featureless(raw):
    return tuple(sorted(t for t, x in raw["nodes"].items()
                        if x.shape[-1] == 0))


def jax_init(raw):
    """JAX ``REGCNet`` (h16 H2 B2, 2 layers) variables on ``raw``."""
    import jax
    import jax.numpy as jnp
    from egc_tpu.graph.hetero import hetero_from_numpy
    from egc_tpu.nn.conv.hetero import REGCNet
    net = REGCNet(hidden_dim=HIDDEN, num_layers=2, dropout=0.0,
                  use_egc=True, heads=HEADS, bases=BASES,
                  num_classes=raw["num_classes"],
                  in_features=SMALL["num_features"],
                  featureless_types=featureless(raw), target_type="paper")
    g = jax.tree.map(jnp.asarray, hetero_from_numpy(raw["nodes"],
                                                    raw["edges"]))
    return jax.tree.map(np.asarray, net.init(jax.random.key(0), g,
                                             train=False))


def jax_mesh(parts):
    import jax
    from egc_tpu.parallel.mesh import make_mesh
    return make_mesh({"graph": parts}, devices=jax.devices()[:parts])


def jax_partitioned(raw, variables, parts):
    """``tests/test_hetero_partition.py``'s ``_distributed`` on ``parts``
    devices: the plan, the net, its replicated parameters, the stacked
    features, embedding rows, graph and send lists."""
    import jax
    import jax.numpy as jnp
    from egc_tpu.graph.hetero import hetero_from_numpy
    from egc_tpu.parallel.hetero_halo import DistributedREGCNet
    from egc_tpu.parallel.hetero_partition import partition_hetero
    hg = hetero_from_numpy(raw["nodes"], raw["edges"])
    plan = partition_hetero({t: hg.num_nodes(t) for t in hg.node_types},
                            raw["edges"], parts)
    dnet = DistributedREGCNet(hidden_dim=HIDDEN, num_layers=2, dropout=0.0,
                              use_egc=True, heads=HEADS, bases=BASES,
                              num_classes=raw["num_classes"],
                              target_type="paper")
    params = dict(variables["params"])
    x_stack, emb = {}, {}
    for t in hg.node_types:
        tp = plan.types[t]
        if t in featureless(raw):
            emb[t] = jnp.asarray(tp.scatter(params.pop(f"emb_{t}")))
            x_stack[t] = jnp.zeros((parts, tp.n_ext, 0), jnp.float32)
        else:
            x_loc = tp.scatter(np.asarray(hg.nodes[t]))
            x_stack[t] = jnp.asarray(np.pad(
                x_loc, ((0, 0), (0, tp.n_ext - tp.n_local), (0, 0))))
    hg_stack = jax.tree.map(jnp.asarray, plan.extended_hetero_graph(
        {t: np.asarray(v) for t, v in x_stack.items()}))
    send_idx = {t: jnp.asarray(plan.types[t].send_idx)
                for t in hg.node_types}
    return plan, dnet, params, x_stack, emb, hg_stack, send_idx


def jax_forward(raw, variables, parts):
    """JAX's ``DistributedREGCNet`` eval forward on ``parts`` devices,
    the paper rows gathered to global order."""
    import jax
    from jax.sharding import PartitionSpec as P
    from egc_tpu.parallel.hetero_halo import extend_local
    plan, dnet, params, x_stack, emb, hg_stack, send_idx = \
        jax_partitioned(raw, variables, parts)
    n_ext = {t: plan.types[t].n_ext for t in emb}

    def fwd(hg_, x_, emb_, sidx_):
        h = jax.tree.map(lambda a: a[0], hg_)
        x = {t: v[0] for t, v in x_.items()}
        x.update({t: extend_local(v[0], n_ext[t]) for t, v in emb_.items()})
        sidx = {t: v[0] for t, v in sidx_.items()}
        return dnet.apply({"params": params}, h, x, sidx, train=False)[None]

    fn = jax.jit(jax.shard_map(
        fwd, mesh=jax_mesh(parts), in_specs=(P("graph"),) * 4,
        out_specs=P("graph"), check_vma=True))
    out = np.asarray(fn(hg_stack, x_stack, emb, send_idx))
    pp = plan.types["paper"]
    return pp.gather(out[:, :pp.n_local], len(pp.owner))


def jax_step(raw, variables, tx_fn):
    """JAX's ``build_hetero_partitioned_steps`` at P 2, dropout 0, with
    the optimizer ``tx_fn()`` for both parameter sets: the loss, the new
    replicated parameters and the new embedding tables (gathered)."""
    import jax
    from egc_tpu.train.state import TrainState
    from egc_tpu.parallel.hetero_halo import build_hetero_partitioned_steps
    plan, dnet, params, x_stack, emb, hg_stack, send_idx = \
        jax_partitioned(raw, variables, 2)
    pp = plan.types["paper"]
    n_paper = len(pp.owner)
    y = np.zeros(n_paper, np.int32)
    y[:len(raw["y"])] = raw["y"]
    tmask = np.zeros(n_paper, bool)
    tmask[raw["train_idx"]] = True
    state = TrainState.create(params=params, batch_stats={}, tx=tx_fn())
    emb_tx = tx_fn()
    train_step, _ = build_hetero_partitioned_steps(
        dnet, jax_mesh(2), emb_tx, {t: plan.types[t].n_ext for t in emb})
    new, new_emb, _, loss = train_step(
        state, emb, jax.vmap(emb_tx.init)(emb), hg_stack, x_stack,
        send_idx, pp.scatter(y), pp.scatter(tmask), jax.random.key(0))
    tables = {t: plan.types[t].gather(np.asarray(v), len(plan.types[t].owner))
              for t, v in new_emb.items()}
    return float(loss), jax.tree.map(np.asarray, new.params), tables


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    from egc_tpu_torch.exp.weight_port import rmag_state_dict_from_jax
    raw = small_raw()
    jvars = jax_init(raw)
    hg = thg.hetero_from_numpy(raw["nodes"], raw["edges"])
    spec = dict(relations=hg.relations, node_types=hg.node_types,
                featureless_types=featureless(raw))
    sd = rmag_state_dict_from_jax(jvars, **spec)
    rng = np.random.default_rng(0)
    x_halo = {t: rng.normal(size=(n, 4)).astype(np.float32)
              for t, n in padded_counts(raw).items()}
    return raw, jvars, sd, spec, x_halo


@pytest.fixture(scope="module")
def groups(setup):
    _, _, sd, _, x_halo = setup
    return {p: tmesh.spawn(rank_work, p, device="cpu", timeout=TIMEOUT,
                           args=(sd, x_halo, p == 2))
            for p in (2, 4)}


def single_device(raw, sd):
    """The port's single-device ``RMagConfig`` net and data from ``sd``."""
    cfg = thet.RMagConfig(HIDDEN, heads=HEADS, bases=BASES, device="cpu")
    cfg.load_hetero = lambda: raw
    data = cfg.data(HP)
    model = cfg.model(HP)
    model.load_state_dict(sd, strict=True)
    return cfg, model, data


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

TYPE_ARRAYS = ("owner", "local_index", "node_gids", "node_mask", "send_idx",
               "send_mask", "uniq_key", "uniq_slot")
REL_ARRAYS = ("senders_ext", "receivers_loc", "edge_mask")


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("method", ["bfs", "block"])
@pytest.mark.parametrize("parts", [2, 4])
def test_plan_equals_jax(parts, method, graph):
    """Every ``TypePlan`` and ``RelPlan`` array-equal to
    ``egc_tpu.parallel.hetero_partition.partition_hetero``'s (a type of
    zero nodes included), ``_cumcount`` too; each rank's
    ``extended_hetero_graph`` its slice of JAX's stacked one, and
    ``rank_rows`` its row of ``scatter``."""
    from egc_tpu.parallel import hetero_partition as jpart
    num_nodes, edges = GRAPHS[graph]()
    got = tpart.partition_hetero(num_nodes, edges, parts, method=method)
    ref = jpart.partition_hetero(num_nodes, edges, parts, method=method)
    assert got.num_parts == ref.num_parts == parts
    assert list(got.types) == list(ref.types)
    assert list(got.rels) == list(ref.rels)
    for t, tp in ref.types.items():
        g = got.types[t]
        assert (g.n_local, g.halo, g.n_ext) == (tp.n_local, tp.halo,
                                                tp.n_ext), t
        for f in TYPE_ARRAYS:
            a, b = getattr(g, f), getattr(tp, f)
            assert a.dtype == b.dtype, (t, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{t}.{f}")
    for k, rp in ref.rels.items():
        assert got.rels[k].e_local == rp.e_local
        for f in REL_ARRAYS:
            np.testing.assert_array_equal(getattr(got.rels[k], f),
                                          getattr(rp, f), err_msg=f"{k}.{f}")
    keys = np.random.default_rng(parts).integers(0, 7, 200)
    np.testing.assert_array_equal(tpart._cumcount(keys),
                                  jpart._cumcount(keys))
    rng = np.random.default_rng(1)
    x_ext = {t: rng.normal(size=(parts, tp.n_ext, 3)).astype(np.float32)
             for t, tp in ref.types.items()}
    jg = ref.extended_hetero_graph(x_ext)
    for r in range(parts):
        hg = got.extended_hetero_graph(r, {t: x[r] for t, x in x_ext.items()})
        assert hg.node_types == sorted(ref.types) and \
            hg.relations == sorted(ref.rels)
        for f in ("nodes", "node_mask", "senders", "receivers", "edge_mask"):
            for k, v in getattr(jg, f).items():
                np.testing.assert_array_equal(getattr(hg, f)[k].numpy(),
                                              np.asarray(v)[r],
                                              err_msg=f"{f}[{k}]")
        for t, tp in got.types.items():
            vals = rng.normal(size=(len(tp.owner), 2))
            np.testing.assert_array_equal(tp.rank_rows(vals, r),
                                          tp.scatter(vals)[r])


@pytest.mark.parametrize("parts", [2, 4])
def test_rank_kernel_plans_cover_the_owned_receivers(parts):
    """``build_kernel_plans(rank)``: one bipartite plan a relation over
    the source type's ``n_ext`` rows and the destination type's
    ``n_local`` rows, holding the rank's valid edges, each once."""
    plan = port_plan(small_raw(), parts)
    for r in range(parts):
        kplans = plan.build_kernel_plans(r)
        assert sorted(kplans) == sorted(plan.rels)
        for key, kp in kplans.items():
            src, _, dst = thg.split_rel_key(key)
            rp = plan.rels[key]
            valid = np.nonzero(rp.edge_mask[r])[0]
            assert (kp.num_nodes, kp.src_rows) == \
                (plan.types[dst].n_local, plan.types[src].n_ext)
            assert kp.num_edges == len(valid)
            np.testing.assert_array_equal(np.sort(kp.fwd_perm.numpy()), valid)
            np.testing.assert_array_equal(
                kp.fwd_senders.numpy(), rp.senders_ext[r][kp.fwd_perm])
            np.testing.assert_array_equal(
                kp.deg.numpy(), np.bincount(rp.receivers_loc[r][valid],
                                            minlength=kp.num_nodes))


@pytest.fixture
def interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl
    import egc_tpu.ops.pallas.gather_reduce as gr

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(gr.pl, "pallas_call", patched)


@pytest.mark.parametrize("key", sorted(small_raw()["edges"]))
def test_rank_aggregate_equals_jax_fused_and_segment(key, interpret_pallas):
    """Each rank's {mean, max} of a relation at P 2 through its rank plan
    (``bipartite_multi_aggregate`` zero-padded to the extended rows, the
    kernels' plain versions on the CPU), values and the gradient, against
    JAX's fused path on the same rank (the device plan JAX's
    ``build_kernel_plans`` stacks, Pallas in interpret mode, padded as
    ``egc_tpu/nn/conv/hetero.py:39-44`` pads) and against the port's
    segment path on the rank's extended graph."""
    import jax
    import jax.numpy as jnp
    from egc_tpu.ops import dispatch as jdisp
    from egc_tpu_torch.nn.conv.hetero import _rel_multi_aggregate
    from egc_tpu_torch.ops.dispatch import bipartite_multi_aggregate
    plan = port_plan(small_raw(), 2)
    src, _, dst = thg.split_rel_key(key)
    sp, dp, rp = plan.types[src], plan.types[dst], plan.rels[key]
    rng = np.random.default_rng(7)
    f = 24
    for r in range(2):
        x = rng.normal(size=(sp.n_ext, f)).astype(np.float32)
        proj = rng.normal(size=(dp.n_ext, len(AGGRS), f)).astype(np.float32)
        jplan = jdisp.build_bipartite_kernel_plan(
            rp.senders_ext[r], rp.receivers_loc[r], sp.n_ext, dp.n_local,
            edge_mask=rp.edge_mask[r], keep_masked_edges=True, **SMALL_GEOM)

        def fused(v):
            out = jdisp.bipartite_multi_aggregate(v, jplan, AGGRS)
            if out.shape[0] < dp.n_ext:
                out = jnp.pad(out, ((0, dp.n_ext - out.shape[0]), (0, 0),
                                    (0, 0)))
            return out[:dp.n_local]

        own = proj[:dp.n_local]
        ref = np.asarray(fused(jnp.asarray(x)))
        g_ref = np.asarray(jax.grad(lambda v: jnp.sum(fused(v) * own))(
            jnp.asarray(x)))

        xt = torch.tensor(x, requires_grad=True)
        got = bipartite_multi_aggregate(xt, plan.build_kernel_plans(r)[key],
                                        AGGRS, num_dst=dp.n_ext)
        (got * torch.from_numpy(proj)).sum().backward()
        assert got.shape == (dp.n_ext, len(AGGRS), f)
        assert not got[dp.n_local:].any()
        np.testing.assert_allclose(got[:dp.n_local].detach().numpy(), ref,
                                   rtol=2e-4, atol=2e-4)

        xs = torch.tensor(x, requires_grad=True)
        hg = plan.extended_hetero_graph(r, {t: np.zeros((tp.n_ext, 0))
                                            for t, tp in plan.types.items()})
        seg = _rel_multi_aggregate(hg, key, xs, dp.n_ext, AGGRS)
        (seg * torch.from_numpy(proj)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(),
                                   seg.detach().numpy(), rtol=2e-4,
                                   atol=2e-4)
        assert rel_l2(xt.grad, xs.grad) <= 2e-4
        xo = torch.tensor(x, requires_grad=True)
        (bipartite_multi_aggregate(xo, plan.build_kernel_plans(r)[key],
                                   AGGRS, num_dst=dp.n_ext)
         * torch.from_numpy(np.concatenate(
             [own, np.zeros_like(proj[dp.n_local:])]))).sum().backward()
        assert rel_l2(xo.grad, g_ref) <= 2e-4


def test_num_dst_below_the_plan_raises():
    from egc_tpu_torch.ops.dispatch import bipartite_multi_aggregate
    plan = port_plan(small_raw(), 2)
    kp = plan.build_kernel_plans(0)["paper__cites__paper"]
    x = torch.zeros(kp.src_rows, 4)
    with pytest.raises(ValueError, match="below the plan"):
        bipartite_multi_aggregate(x, kp, AGGRS, num_dst=kp.num_nodes - 1)


# ---------------------------------------------------------------------------
# the halo, the forward, the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [2, 4])
def test_halo_refresh_delivers_owner_values(groups, setup, parts):
    """Per type, halo slot (q, h) of rank p holds the row rank q sends to
    p; the owned rows are unchanged (bitwise)."""
    raw, _, _, _, x_halo = setup
    plan = port_plan(raw, parts)
    for p, res in enumerate(groups[parts]):
        for t, tp in plan.types.items():
            got = res["halo"][t]
            np.testing.assert_array_equal(got[:tp.n_local],
                                          tp.rank_rows(x_halo[t], p))
            for q in range(parts):
                for h in np.where(tp.send_mask[q, p])[0]:
                    gid = tp.node_gids[q, tp.send_idx[q, p, h]]
                    np.testing.assert_array_equal(
                        got[tp.n_local + q * tp.halo + h], x_halo[t][gid])


def gathered_papers(results, n_paper, key="fwd"):
    out = None
    for res in results:
        gids = res["gids"]["paper"]
        rows = res[key]
        if out is None:
            out = np.zeros((n_paper,) + rows.shape[1:], rows.dtype)
        out[gids[gids >= 0]] = rows[gids >= 0]
    return out


@pytest.mark.parametrize("parts", [2, 4])
def test_partitioned_forward_equals_jax_and_one_device(groups, setup,
                                                       parts):
    """The eval forward over P gloo ranks, the paper rows gathered to
    global order, against JAX's ``DistributedREGCNet`` on P devices and
    the port's single-device ``REGCNet``, from the same weights."""
    raw, jvars, sd, _, _ = setup
    _, model, data = single_device(raw, sd)
    model.eval()
    with torch.no_grad():
        ref = model(data["hetero"]).numpy()
    got = gathered_papers(groups[parts], ref.shape[0])
    valid = data["hetero"].node_mask["paper"].numpy()
    np.testing.assert_allclose(got[valid], ref[valid], rtol=2e-4, atol=2e-4)
    ref_jax = jax_forward(raw, jvars, parts)
    np.testing.assert_allclose(got[valid], ref_jax[valid], rtol=2e-4,
                               atol=2e-4)


def _gate(got: dict, ref: dict, what: str):
    """Every tensor at relative L2 1e-4; where the reference is 0 (what the
    loss does not reach), exactly 0."""
    assert sorted(got) == sorted(ref), what
    for k in ref:
        if not np.any(ref[k]):
            assert not np.any(got[k]), (what, k)
        else:
            assert rel_l2(got[k], ref[k]) <= 1e-4, (what, k)


def test_partitioned_step_equals_jax_and_one_device(groups, setup):
    """One Adam (L2 in the gradient) step at P 2, dropout 0: the loss at
    rtol 1e-5, every gradient (the embeddings' gathered) and the state
    after the step (the embedding rows gathered) at relative L2 1e-4,
    against JAX's ``build_hetero_partitioned_steps`` (SGD at lr 1 gives
    its gradients; its Adam step the state) and against the port's
    single-device ``RMagConfig`` step; the replicas stay equal."""
    import optax
    from egc_tpu.train.optim import make_optimizer as jmake_optimizer
    from egc_tpu_torch.exp.weight_port import rmag_state_dict_from_jax
    raw, jvars, sd, spec, _ = setup
    res = [g["step"] for g in groups[2]]
    assert res[0]["loss"] == res[1]["loss"]
    for k, v in res[0]["new"].items():
        np.testing.assert_array_equal(res[1]["new"][k], v)
    got = res[0]
    grads = dict(got["grads"])
    grads.update({f"embs.{t}": g for t, g in got["emb_grads"].items()})

    def port_dict(params, tables):
        full = {**params, **{f"emb_{t}": v for t, v in tables.items()}}
        return {k: v.numpy() for k, v in rmag_state_dict_from_jax(
            {"params": full}, **spec).items()}

    sgd_loss, sgd_params, sgd_tables = jax_step(raw, jvars,
                                                lambda: optax.sgd(1.0))
    before = {k: v.numpy() for k, v in sd.items()}
    after = port_dict(sgd_params, sgd_tables)
    assert got["loss"] == pytest.approx(sgd_loss, rel=1e-5)
    _gate(grads, {k: before[k] - after[k] for k in before}, "jax grads")
    loss_j, params_j, tables_j = jax_step(
        raw, jvars, lambda: jmake_optimizer(HP["lr"], HP["wd"]))
    assert loss_j == pytest.approx(sgd_loss, rel=1e-6)
    _gate(got["new"], port_dict(params_j, tables_j), "jax state")

    cfg, model, data = single_device(raw, sd)
    opt = cfg.init_state(model, HP, data, 0)
    loss = thet.train_step(model, opt, data)
    assert got["loss"] == pytest.approx(float(loss), rel=1e-5)
    _gate(grads, {n: p.grad.numpy() for n, p in model.named_parameters()},
          "one-device grads")
    _gate(got["new"], {k: v.numpy() for k, v in model.state_dict().items()},
          "one-device state")
    ref_opt = opt.state_dict()["state"]
    assert sorted(got["opt"]) == sorted(ref_opt)
    for i, st in ref_opt.items():
        _gate(got["opt"][i], {k: v.numpy() for k, v in st.items()},
              f"Adam state {i}")


# ---------------------------------------------------------------------------
# PartitionedRMagConfig and --partitions
# ---------------------------------------------------------------------------

def trial_rank(mesh, weights, trial_dir):
    """``run_trial`` of ``PartitionedRMagConfig`` from ``weights`` into
    ``trial_dir``, then a fresh config's ``restore_trial`` and ``test``;
    the seeded net's full state dict beside ``REGCNet``'s of the seed."""
    from egc_tpu_torch.exp.runner import run_trial
    cfg = SmallPartitioned(mesh, weights)
    res = run_trial(cfg, TRIAL_HP, seed=0, max_iterations=3, patience=10,
                    trial_dir=pathlib.Path(trial_dir), verbose=False)
    fresh = SmallPartitioned(mesh)
    model, state, _, hp, data = fresh.restore_trial(trial_dir)
    one = thet.RMagConfig(HIDDEN, heads=HEADS, bases=BASES, device="cpu")
    one.load_hetero = lambda: small_raw()
    seeded = fresh.model(TRIAL_HP, seed=5).full_state_dict()
    same = one.model(TRIAL_HP, seed=5).state_dict()
    return {"history": res["history"], "test": res["test"],
            "restored": fresh.test(model, state, data), "hp": hp,
            "full": {k: v.numpy() for k, v in
                     res["model"].full_state_dict().items()},
            "restored_full": {k: v.numpy() for k, v in
                              model.full_state_dict().items()},
            "seeded_equal": list(seeded) == list(same) and all(
                torch.equal(v, same[k]) for k, v in seeded.items())}


def test_partitioned_config_trial_equals_jax(tmp_path, monkeypatch, setup):
    """Three ``run_trial`` iterations of the port's
    ``PartitionedRMagConfig`` on 2 gloo ranks against JAX's on 2 devices
    from the same weights (dropout 0, Adam): the train loss at rtol 1e-4,
    the lr, and every accuracy within two nodes of its split (ROADMAP.md
    §C); the replicas equal; then the persist / restore round trip: rank
    0's ``checkpoint.pt`` is ``REGCNet``'s and loads strictly into the
    single-device net, and ``restore_trial`` gives every rank the trial's
    state and test metrics. The net of a seed is ``REGCNet``'s of it."""
    import jax
    import jax.numpy as jnp
    import egc_tpu.parallel.mesh as jmesh
    from egc_tpu.exp import hetero as jhet
    from egc_tpu.exp import runner as jrunner
    raw, jvars, sd, spec, _ = setup

    class JaxSmall(jhet.PartitionedRMagConfig):
        def load_hetero(self):
            return raw

        def init_state(self, model, hparams, data, seed):
            state = super().init_state(model, hparams, data, seed)
            params = dict(jvars["params"])
            emb = {t: jnp.asarray(data["plan"].types[t].scatter(
                params.pop(f"emb_{t}"))) for t in data["featureless"]}
            return state.replace(params=params, batch_stats={
                "emb": emb, "emb_opt": state.batch_stats["emb_opt"]})

    orig = jmesh.make_mesh
    monkeypatch.setattr(jmesh, "make_mesh", lambda axes: orig(
        axes, devices=jax.devices()[:2]))
    jcfg = JaxSmall(HIDDEN, heads=HEADS, bases=BASES, partitions=2)
    jres = jrunner.run_trial(jcfg, TRIAL_HP, seed=0, max_iterations=3,
                             patience=10, verbose=False)

    d = tmp_path / "trial"
    res = tmesh.spawn(trial_rank, 2, device="cpu", timeout=TIMEOUT,
                      args=(sd, str(d)))
    sizes = {s: len(raw[f"{s}_idx"]) for s in ("train", "val", "test")}
    assert len(res[0]["history"]) == len(jres["history"]) == 3
    for a, b in zip(res[0]["history"], jres["history"]):
        assert a.keys() == b.keys()
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=1e-4)
        assert a["lr"] == b["lr"]
        for s, size in sizes.items():
            assert abs(a[f"{s}_acc"] - b[f"{s}_acc"]) <= 2 / size + 1e-7
    for a, b in zip(res[0]["history"], res[1]["history"]):
        assert {k: v for k, v in a.items() if k != "time_s"} == \
            {k: v for k, v in b.items() if k != "time_s"}
    for r in res:
        assert r["restored"] == r["test"] and r["hp"] == TRIAL_HP
        assert r["seeded_equal"]
        for k, v in res[0]["full"].items():
            np.testing.assert_array_equal(r["full"][k], v, err_msg=k)
            np.testing.assert_array_equal(r["restored_full"][k], v,
                                          err_msg=k)
    from egc_tpu_torch.exp.weight_port import (
        partitioned_rmag_state_dict_from_jax,
    )
    jstate = jres["state"]
    jfinal = partitioned_rmag_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        {t: np.asarray(v) for t, v in jstate.batch_stats["emb"].items()},
        jres["data"]["plan"].types, **spec)
    _gate(res[0]["full"], {k: v.numpy() for k, v in jfinal.items()},
          "the trial's state against JAX's")
    _, model, _ = single_device(raw, sd)
    payload = torch.load(d / "checkpoint.pt", weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    assert payload["step"] == 3
    assert set(payload["opt"]["state"]) == set(range(len(list(
        model.parameters()))))


@pytest.mark.parametrize("parts", [2, 4])
def test_partitioned_weight_port_equals_the_one_device_port(setup, parts):
    """``partitioned_rmag_state_dict_from_jax`` of JAX's partitioned state
    (the replicated parameters and each embedding's stacked ``[P,
    n_local, F]`` rows, as JAX's ``PartitionedRMagConfig`` holds them)
    equals ``rmag_state_dict_from_jax`` of the single-device variables,
    key for key and in order; each rank's ``DistributedREGCNet`` takes
    its rows of it."""
    from egc_tpu_torch.exp.weight_port import (
        partitioned_rmag_state_dict_from_jax,
    )
    from egc_tpu_torch.parallel.hetero_halo import DistributedREGCNet
    raw, jvars, sd, spec, _ = setup
    plan, _, params, _, emb, _, _ = jax_partitioned(raw, jvars, parts)
    got = partitioned_rmag_state_dict_from_jax(
        params, {t: np.asarray(v) for t, v in emb.items()}, plan.types,
        **spec)
    assert list(got) == list(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    tplan = port_plan(raw, parts)
    for r in range(parts):
        net = DistributedREGCNet(
            HIDDEN, type_plans=tplan.types, rank=r, heads=HEADS,
            bases=BASES, node_types=spec["node_types"],
            relations=spec["relations"], num_classes=raw["num_classes"],
            in_features=SMALL["num_features"],
            featureless_types=spec["featureless_types"])
        net.load_full_state_dict(got)
        for t in spec["featureless_types"]:
            np.testing.assert_array_equal(
                net.embs[t].detach().numpy(),
                tplan.types[t].rank_rows(sd[f"embs.{t}"].numpy(), r))


def test_cli_partitions_agrees_with_main(tmp_path, monkeypatch):
    """``python -m egc_tpu_torch DIR egc rmag --hidden 16 --egc-num-heads 4
    --egc-num-bases 2 --partitions 2 --check --check-epochs 2 --device
    cpu`` (2 gloo ranks, started by the command) prints, once, the dict
    that ``main.main`` prints for the same options on 2 devices: the same
    keys, two iterations, accuracies of the synthetic splits (the two
    packages' seeded weights and dropout draws differ, so the values are
    not compared); and it writes nothing into EXP_DIR."""
    import jax
    import egc_tpu.parallel.mesh as jmesh
    import main as jmain

    opts = ["egc", "rmag", "--hidden", "16", "--egc-num-heads", "4",
            "--egc-num-bases", "2", "--partitions", "2", "--check",
            "--check-epochs", "2"]
    run = subprocess.run(
        [sys.executable, "-m", "egc_tpu_torch", str(tmp_path / "t")] + opts
        + ["--device", "cpu"], capture_output=True, text=True,
        timeout=TIMEOUT, cwd=REPO)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.strip().splitlines()
    assert sum(line.startswith("{'best_val'") for line in lines) == 1
    assert sum(line.startswith("[rmag] trial") for line in lines) == 1
    got = ast.literal_eval(lines[-1])
    assert list((tmp_path / "t").iterdir()) == []

    orig = jmesh.make_mesh
    monkeypatch.setattr(jmesh, "make_mesh", lambda axes: orig(
        axes, devices=jax.devices()[:2]))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jmain.main.main(args=[str(tmp_path / "j")] + opts + [
            "--aggrs", "mean,max"], standalone_mode=False)
    ref = ast.literal_eval(out.getvalue().strip().splitlines()[-1])
    assert got.keys() == ref.keys() == {"best_val", "best_iter", "test"}
    assert got["test"].keys() == ref["test"].keys()
    assert got["best_iter"] in (0, 1) and ref["best_iter"] in (0, 1)
    for res in (got, ref):
        assert 0.0 <= res["best_val"] <= 1.0
        assert all(0.0 <= v <= 1.0 for v in res["test"].values())


def test_new_modules_import_no_jax():
    """The modules this slice adds or rewires import neither ``jax`` nor
    ``egc_tpu`` (in a fresh interpreter)."""
    mods = ["egc_tpu_torch", "egc_tpu_torch.parallel.hetero_partition",
            "egc_tpu_torch.parallel.hetero_halo", "egc_tpu_torch.exp.hetero",
            "egc_tpu_torch.native", "egc_tpu_torch.data.ondisk",
            "egc_tpu_torch.exp.weight_port", "egc_tpu_torch.cli"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'flax' or m == 'egc_tpu' or "
            "m.startswith('egc_tpu.')]\nprint(bad)\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=TIMEOUT, cwd=REPO)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "[]"
