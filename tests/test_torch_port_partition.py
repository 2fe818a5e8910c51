"""Port parity for graph-partitioned full-graph training
(``egc_tpu_torch.parallel``: ``mesh``, ``partition``, ``halo``, sync-BN,
``PartitionedArxivConfig``, ``--partitions``) against the JAX package on
the CPU.

The port's partitions are gloo ranks (``parallel.mesh.spawn``; each
spawned group runs under a 120 s timeout, so a hang fails); the JAX
package's are 2 or 4 of the 8 forced host devices. Both sides start from
the same weights: a JAX ``ArxivNet`` init, through the weight port.

Tolerances: the plan array-equal; the halo bitwise; the partitioned
forward at 2e-4 (``tests/test_partition.py``'s) against JAX's
``DistributedNodeClassifier`` and against the port's single-device
``ArxivNet``; one train step's loss at rtol 1e-5 and its gradients at
relative L2 1e-4 (the whole gradient, and each tensor whose norm is not
BatchNorm-cancelled noise); BatchNorm running statistics at 1e-6.
"""

import ast
import contextlib
import io
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from egc_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)
TIMEOUT = 120
FEATS, CLASSES, HIDDEN = 8, 5, 16
EGC_M = dict(kind="egc", heads=2, bases=2, aggrs=("symnorm", "max", "mean"))
CONVS = {"egc_overlap": (EGC_M, True), "egc_generic": (EGC_M, False),
         "gcn": (dict(kind="gcn"), False),
         "gat": (dict(kind="gat", heads=2), False)}
HP = {"lr": 0.01, "wd": 5e-4, "dropout": 0.0}
REPO = pathlib.Path(__file__).resolve().parents[1]


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def small_raw(n=300, seed=5):
    from egc_tpu_torch.data import synthetic
    return synthetic.synthetic_full_graph(
        num_nodes=n, avg_degree=6, num_classes=CLASSES,
        num_features=FEATS, seed=seed)


def port_plan(raw, parts, method="bfs"):
    from egc_tpu_torch.graph.transforms import symnorm_weight
    from egc_tpu_torch.parallel.partition import partition_graph
    n = raw["x"].shape[0]
    ew, sw = symnorm_weight(torch.as_tensor(raw["senders"]),
                            torch.as_tensor(raw["receivers"]), n)
    return partition_graph(raw["senders"], raw["receivers"], n, parts,
                           method=method, sym_edge_w=ew.numpy(),
                           sym_self_w=sw.numpy())


def rank_graph(plan, raw, rank):
    x_ext = np.zeros((plan.n_ext, raw["x"].shape[1]), np.float32)
    x_ext[:plan.n_local] = plan.scatter_nodes(raw["x"])[rank]
    return plan.extended_graph(rank, x_ext)


def dnet(conv, overlap, plan, mesh, sd):
    from egc_tpu_torch.models.nets import ConvSpec
    from egc_tpu_torch.parallel.halo import DistributedNodeClassifier
    net = DistributedNodeClassifier(
        ConvSpec(**conv), HIDDEN, num_layers=2, dropout=0.0,
        num_features=FEATS, num_classes=CLASSES,
        e_interior=plan.e_interior if overlap else None, group=mesh.group)
    net.load_state_dict(sd, strict=True)
    return net


def rank_work(mesh, raw, weights, x_halo, step_weights):
    """One rank's share of every check: the halo refresh of ``x_halo``,
    the eval forward of each conv in ``weights``, and, given
    ``step_weights``, one SGD train step on each EGC-M path."""
    from egc_tpu_torch.parallel.halo import (
        halo_refresh, partitioned_eval, partitioned_train_step,
    )
    plan = port_plan(raw, mesh.world_size)
    r = mesh.rank
    sidx = torch.from_numpy(plan.send_idx[r])
    xe = np.zeros((plan.n_ext, x_halo.shape[1]), np.float32)
    xe[:plan.n_local] = plan.scatter_nodes(x_halo)[r]
    out = {"halo": halo_refresh(torch.from_numpy(xe), sidx).numpy(),
           "gids": plan.node_gids[r], "fwd": {}, "step": {}}
    g = rank_graph(plan, raw, r)
    for name, (conv, overlap) in CONVS.items():
        net = dnet(conv, overlap, plan, mesh, weights[name])
        out["fwd"][name] = partitioned_eval(net, g, sidx)[
            :plan.n_local].numpy()
    if step_weights is not None:
        y = torch.from_numpy(plan.scatter_nodes(
            raw["y"].astype(np.int64))[r])
        tmask = np.zeros(raw["x"].shape[0], bool)
        tmask[raw["train_idx"]] = True
        tm = torch.from_numpy(plan.scatter_nodes(tmask)[r])
        for overlap in (True, False):
            net = dnet(EGC_M, overlap, plan, mesh, step_weights)
            opt = torch.optim.SGD(net.parameters(), lr=1.0)
            before = {k: v.clone() for k, v in net.state_dict().items()}
            loss = partitioned_train_step(net, opt, g, sidx, y, tm)
            after = net.state_dict()
            out["step"][overlap] = {
                "loss": float(loss),
                "grads": {k: (before[k] - after[k]).numpy()
                          for k, _ in net.named_parameters()},
                "stats": {k: v.numpy() for k, v in after.items()
                          if "running" in k}}
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def jax_conv(conv):
    from egc_tpu.models.nets import ConvSpec as JConvSpec
    return JConvSpec(**conv)


def jax_init(conv, raw, num_layers=2):
    import jax
    import jax.numpy as jnp
    from egc_tpu.graph.structure import Graph as JGraph
    from egc_tpu.models.nets import ArxivNet as JArxivNet
    g = jax.tree.map(jnp.asarray, JGraph.from_coo(
        raw["x"], raw["senders"], raw["receivers"]))
    net = JArxivNet(conv=jax_conv(conv), hidden_dim=HIDDEN,
                    num_layers=num_layers, dropout=0.0, residual=True,
                    num_features=FEATS,
                    num_classes=CLASSES)
    return jax.tree.map(np.asarray, net.init(jax.random.key(0), g,
                                             train=False))


def jax_mesh(parts):
    import jax
    from egc_tpu.parallel import make_mesh
    return make_mesh({"graph": parts}, devices=jax.devices()[:parts])


def jax_partitioned(raw, parts):
    import jax.numpy as jnp
    from egc_tpu.graph.transforms import symnorm_weight
    from egc_tpu.parallel import partition_graph
    n = raw["x"].shape[0]
    ew, sw = symnorm_weight(jnp.asarray(raw["senders"]),
                            jnp.asarray(raw["receivers"]), n)
    plan = partition_graph(raw["senders"], raw["receivers"], n, parts,
                           method="bfs", sym_edge_w=np.asarray(ew),
                           sym_self_w=np.asarray(sw))
    x_ext = np.zeros((parts, plan.n_ext, FEATS), np.float32)
    x_ext[:, :plan.n_local] = plan.scatter_nodes(raw["x"])
    return plan, plan.extended_graph(x_ext)


def jax_dnet(conv, overlap, plan):
    from egc_tpu.parallel import DistributedNodeClassifier as JDNC
    return JDNC(conv=jax_conv(conv), hidden_dim=HIDDEN, num_layers=2,
                dropout=0.0, residual=True, num_features=FEATS,
                num_classes=CLASSES,
                e_interior=plan.e_interior if overlap else None)


def jax_forward(raw, parts, conv, overlap, variables):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    plan, gl = jax_partitioned(raw, parts)
    net = jax_dnet(conv, overlap, plan)

    def fwd(graphs, sidx):
        graph = jax.tree.map(lambda a: a[0], graphs)
        return net.apply(variables, graph, sidx[0], train=False)[None]

    fn = jax.jit(jax.shard_map(
        fwd, mesh=jax_mesh(parts), in_specs=(P("graph"), P("graph")),
        out_specs=P("graph"), check_vma=True))
    out = np.asarray(fn(jax.tree.map(jnp.asarray, gl),
                        jnp.asarray(plan.send_idx)))
    return plan.gather_nodes(out[:, :plan.n_local], raw["x"].shape[0])


def jax_train_step(raw, variables):
    """JAX's ``make_partitioned_train_step`` at P 2 (the overlap path),
    SGD at lr 1: the loss, p - p', and the new BatchNorm statistics."""
    import jax
    import jax.numpy as jnp
    import optax
    from egc_tpu.parallel import make_partitioned_train_step
    from egc_tpu.train.state import TrainState
    plan, gl = jax_partitioned(raw, 2)
    net = jax_dnet(EGC_M, True, plan)
    state = TrainState.create(params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=optax.sgd(1.0))
    tmask = np.zeros(raw["x"].shape[0], bool)
    tmask[raw["train_idx"]] = True
    step = make_partitioned_train_step(net, jax_mesh(2))
    new, loss = step(state, jax.tree.map(jnp.asarray, gl),
                     jnp.asarray(plan.send_idx),
                     jnp.asarray(plan.scatter_nodes(raw["y"])),
                     jnp.asarray(plan.scatter_nodes(tmask)),
                     jax.random.key(0))
    grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                         state.params, new.params)
    return float(loss), {"params": grads,
                         "batch_stats": jax.tree.map(np.asarray,
                                                     new.batch_stats)}


# ---------------------------------------------------------------------------
# fixtures: one spawned group a world size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    from egc_tpu_torch.exp.weight_port import arxiv_state_dict_from_jax
    raw = small_raw()
    jvars = {name: jax_init(conv, raw) for name, (conv, _) in CONVS.items()}
    weights = {name: arxiv_state_dict_from_jax(v, kind=CONVS[name][0][
        "kind"], bases=2) for name, v in jvars.items()}
    x_halo = np.random.default_rng(0).normal(
        size=(raw["x"].shape[0], 4)).astype(np.float32)
    return raw, jvars, weights, x_halo


@pytest.fixture(scope="module")
def groups(setup):
    raw, _, weights, x_halo = setup
    return {p: tmesh.spawn(rank_work, p, device="cpu", timeout=TIMEOUT,
                           args=(raw, weights, x_halo,
                                 weights["egc_overlap"] if p == 2 else None))
            for p in (2, 4)}


def gathered(results, key, name, n):
    out = None
    for res in results:
        v = res["gids"] >= 0
        rows = res[key][name]
        if out is None:
            out = np.zeros((n,) + rows.shape[1:], rows.dtype)
        out[res["gids"][v]] = rows[v]
    return out


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("method", ["bfs", "hash", "block"])
def test_partition_plan_equals_jax(method, parts):
    """Owner, local order, send lists, edge layout, ``e_interior``, the
    extended senders and receivers and the symnorm weights, array-equal
    to ``egc_tpu.parallel.partition_graph``'s; the rank's extended graph
    is its slice of the stacked one."""
    import jax.numpy as jnp
    from egc_tpu.graph.transforms import symnorm_weight
    from egc_tpu.parallel import partition_graph as jpartition
    raw = small_raw(seed=3)
    n = raw["x"].shape[0]
    ew, sw = symnorm_weight(jnp.asarray(raw["senders"]),
                            jnp.asarray(raw["receivers"]), n)
    ref = jpartition(raw["senders"], raw["receivers"], n, parts,
                     method=method, sym_edge_w=np.asarray(ew),
                     sym_self_w=np.asarray(sw))
    got = port_plan(raw, parts, method)
    for f in ("num_parts", "n_local", "halo", "e_local", "e_interior",
              "n_ext"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("owner", "local_index", "node_gids", "node_mask", "send_idx",
              "send_mask", "senders_ext", "receivers_loc", "edge_mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    np.testing.assert_allclose(got.sym_edge_w, ref.sym_edge_w, rtol=1e-6)
    np.testing.assert_allclose(got.sym_self_w, ref.sym_self_w, rtol=1e-6)
    x_ext = np.zeros((parts, ref.n_ext, FEATS), np.float32)
    x_ext[:, :ref.n_local] = ref.scatter_nodes(raw["x"])
    jg = ref.extended_graph(x_ext)
    for r in range(parts):
        g = got.extended_graph(r, x_ext[r])
        for f in ("nodes", "senders", "receivers", "node_mask",
                  "edge_mask"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(jg, f))[r])
        np.testing.assert_allclose(g.self_weight.numpy(),
                                   np.asarray(jg.self_weight)[r], rtol=1e-6)


@pytest.mark.parametrize("parts", [2, 4])
def test_rank_kernel_plan_covers_its_owned_receivers(parts):
    """``build_kernel_plan(rank)``: the rank's valid edges, each once, in
    the CSR of its owned receivers (halo and padding rows have no
    in-edge), its CSC over the extended rows, and the global symnorm
    weights in both orders."""
    raw = small_raw(seed=3)
    plan = port_plan(raw, parts)
    for r in range(parts):
        kp = plan.build_kernel_plan(r)
        valid = np.nonzero(plan.edge_mask[r])[0]
        assert kp.num_nodes == plan.n_ext
        assert kp.num_edges == len(valid)
        deg = kp.deg.numpy()
        assert deg[plan.n_local:].sum() == 0
        np.testing.assert_array_equal(
            deg, np.bincount(plan.receivers_loc[r][valid],
                             minlength=plan.n_ext))
        np.testing.assert_array_equal(np.sort(kp.fwd_perm.numpy()), valid)
        np.testing.assert_array_equal(
            kp.fwd_senders.numpy(),
            plan.senders_ext[r][kp.fwd_perm.numpy()])
        np.testing.assert_array_equal(
            kp.fwd_w.numpy(), plan.sym_edge_w[r][kp.fwd_perm.numpy()])
        np.testing.assert_array_equal(
            kp.bwd_w.numpy(), plan.sym_edge_w[r][kp.bwd_perm.numpy()])


# ---------------------------------------------------------------------------
# the halo, the forward, the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [2, 4])
def test_halo_refresh_delivers_owner_values(groups, setup, parts):
    """Halo slot (q, h) of rank p holds the row rank q sends to p (as in
    ``tests/test_partition.py::test_halo_refresh_delivers_owner_values``);
    the owned rows are unchanged."""
    raw, _, _, x_halo = setup
    plan = port_plan(raw, parts)
    for p, res in enumerate(groups[parts]):
        got = res["halo"]
        np.testing.assert_array_equal(
            got[:plan.n_local], plan.scatter_nodes(x_halo)[p])
        for q in range(parts):
            for h in np.where(plan.send_mask[q, p])[0]:
                gid = plan.node_gids[q, plan.send_idx[q, p, h]]
                np.testing.assert_array_equal(
                    got[plan.n_local + q * plan.halo + h], x_halo[gid])


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("name", list(CONVS))
def test_partitioned_forward_equals_jax_and_one_device(groups, setup, name,
                                                       parts):
    """The eval forward over P gloo ranks, gathered to global order,
    against JAX's ``DistributedNodeClassifier`` on P devices (the same
    path: overlap or generic) and the port's single-device ``ArxivNet``,
    from the same weights."""
    from egc_tpu_torch.graph.structure import Graph
    from egc_tpu_torch.models.nets import ArxivNet, ConvSpec
    raw, jvars, weights, _ = setup
    conv, overlap = CONVS[name]
    n = raw["x"].shape[0]
    got = gathered(groups[parts], "fwd", name, n)
    ref_jax = jax_forward(raw, parts, conv, overlap, jvars[name])
    net = ArxivNet(ConvSpec(**conv), HIDDEN, num_layers=2, dropout=0.0,
                   num_features=FEATS, num_classes=CLASSES)
    net.load_state_dict(weights[name], strict=True)
    net.eval()
    with torch.no_grad():
        ref = net(Graph.from_coo(raw["x"], raw["senders"],
                                 raw["receivers"])).numpy()
    np.testing.assert_allclose(got, ref_jax, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def _grad_gate(got: dict, ref: dict):
    keys = sorted(ref)
    assert sorted(got) == keys
    flat = [np.concatenate([np.ravel(d[k]) for k in keys])
            for d in (got, ref)]
    assert rel_l2(*flat) <= 1e-4
    scale = np.linalg.norm(flat[1])
    for k in keys:    # a conv bias feeds a BatchNorm: its gradient is noise
        if np.linalg.norm(ref[k]) > 1e-5 * scale:
            assert rel_l2(got[k], ref[k]) <= 1e-4, k


@pytest.mark.parametrize("overlap", [True, False],
                         ids=["overlap", "generic"])
def test_partitioned_train_step_equals_jax_and_one_device(groups, setup,
                                                          overlap):
    """One EGC-M train step at P 2 (SGD at lr 1, so p - p' is the
    gradient): the loss at rtol 1e-5 and the gradients at relative L2
    1e-4 against JAX's ``make_partitioned_train_step`` (through the
    weight port) and against the port's single-device step; BatchNorm's
    running statistics equal both."""
    from egc_tpu_torch.exp.weight_port import arxiv_state_dict_from_jax
    from egc_tpu_torch.graph.structure import Graph
    from egc_tpu_torch.models.nets import ArxivNet, ConvSpec
    raw, jvars, weights, _ = setup
    res = groups[2]
    assert res[0]["step"][overlap]["loss"] == res[1]["step"][overlap]["loss"]
    got = res[0]["step"][overlap]
    for other in res[1:]:      # the replicas stay equal
        for k, v in other["step"][overlap]["grads"].items():
            np.testing.assert_array_equal(v, got["grads"][k])

    jloss, jdelta = jax_train_step(raw, jvars["egc_overlap"])
    jsd = arxiv_state_dict_from_jax(jdelta, kind="egc", bases=2)
    assert got["loss"] == pytest.approx(jloss, rel=1e-5)
    _grad_gate(got["grads"], {k: jsd[k].numpy() for k in got["grads"]})

    net = ArxivNet(ConvSpec(**EGC_M), HIDDEN, num_layers=2, dropout=0.0,
                   num_features=FEATS, num_classes=CLASSES)
    net.load_state_dict(weights["egc_overlap"], strict=True)
    net.train()
    g = Graph.from_coo(raw["x"], raw["senders"], raw["receivers"])
    tmask = torch.zeros(raw["x"].shape[0], dtype=torch.bool)
    tmask[torch.as_tensor(raw["train_idx"])] = True
    m = tmask.float()
    nll = -net(g).gather(1, torch.as_tensor(raw["y"]).long()[:, None])[:, 0]
    loss = (nll * m).sum() / m.sum()
    loss.backward()
    assert got["loss"] == pytest.approx(loss.item(), rel=1e-5)
    _grad_gate(got["grads"], {k: p.grad.numpy()
                              for k, p in net.named_parameters()})
    for k, v in got["stats"].items():
        np.testing.assert_allclose(v, net.state_dict()[k].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(v, jsd[k].numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# PartitionedArxivConfig and --partitions
# ---------------------------------------------------------------------------

def _port_config(mesh, weights):
    from egc_tpu_torch.exp import fullgraph as tfg

    class SmallPartitioned(tfg.PartitionedArxivConfig):
        def load_full_graph(self):
            return small_raw(n=400, seed=4)

        def model(self, hparams, *, seed=0):
            net = super().model(hparams, seed=seed)
            if weights is not None:
                net.load_state_dict(weights, strict=True)
            return net

    return SmallPartitioned("egc", HIDDEN, heads=2, bases=2,
                            aggrs=EGC_M["aggrs"], mesh=mesh)


def trial_rank(mesh, weights, trial_dir):
    """``run_trial`` of ``PartitionedArxivConfig`` into ``trial_dir``, then
    a fresh config's ``restore_trial`` and ``test``; and the replica's
    state dict after the trial."""
    from egc_tpu_torch.exp.runner import run_trial
    cfg = _port_config(mesh, weights)
    res = run_trial(cfg, HP, seed=0, max_iterations=3, patience=10,
                    trial_dir=pathlib.Path(trial_dir), verbose=False)
    fresh = _port_config(mesh, None)
    model, state, _, hp, data = fresh.restore_trial(trial_dir)
    return {"history": res["history"], "test": res["test"],
            "restored": fresh.test(model, state, data), "hp": hp,
            "sd": {k: v.numpy() for k, v in res["model"].state_dict()
                   .items()}}


def test_partitioned_config_trial_equals_jax(tmp_path, monkeypatch):
    """Three ``run_trial`` iterations of the port's
    ``PartitionedArxivConfig`` on 2 gloo ranks against JAX's on 2 devices
    from the same weights (dropout 0, Adam): the train loss at rtol 1e-4,
    the lr, and every accuracy within two nodes of its split; then the
    persist / restore round trip: rank 0's ``checkpoint.pt`` loads
    strictly into the single-device ``ArxivNet`` and ``restore_trial``
    gives the trial's test metrics on every rank."""
    import jax
    import egc_tpu.parallel as jpar
    from egc_tpu.exp import fullgraph as jfg
    from egc_tpu.exp import runner as jrunner
    from egc_tpu.train.state import TrainState
    from egc_tpu_torch.exp.weight_port import arxiv_state_dict_from_jax
    from egc_tpu_torch.models.nets import ArxivNet, ConvSpec

    raw = small_raw(n=400, seed=4)
    jvars = jax_init(EGC_M, raw, num_layers=3)    # ArxivConfig's depth
    weights = arxiv_state_dict_from_jax(jvars, kind="egc", bases=2)

    class JaxSmall(jfg.PartitionedArxivConfig):
        def load_full_graph(self):
            return raw

        def init_state(self, model, hparams, data, seed):
            self._last_pdata = data
            self._model_obj = self.model(hparams)
            return TrainState.create(params=jvars["params"],
                                     batch_stats=jvars["batch_stats"],
                                     tx=self.optimizer(hparams))

    orig = jpar.make_mesh
    monkeypatch.setattr(jpar, "make_mesh", lambda axes: orig(
        axes, devices=jax.devices()[:2]))
    jcfg = JaxSmall("egc", HIDDEN, heads=2, bases=2, aggrs=EGC_M["aggrs"],
                    partitions=2)
    jres = jrunner.run_trial(jcfg, HP, seed=0, max_iterations=3,
                             patience=10, verbose=False)

    d = tmp_path / "trial"
    res = tmesh.spawn(trial_rank, 2, device="cpu", timeout=TIMEOUT,
                      args=(weights, str(d)))
    sizes = {s: len(raw[f"{s}_idx"]) for s in ("train", "val", "test")}
    for a, b in zip(res[0]["history"], jres["history"]):
        assert a.keys() == b.keys()
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=1e-4)
        assert a["lr"] == b["lr"]
        for s, size in sizes.items():
            assert abs(a[f"{s}_acc"] - b[f"{s}_acc"]) <= 2 / size + 1e-7
    for a, b in zip(res[0]["history"], res[1]["history"]):
        assert {k: v for k, v in a.items() if k != "time_s"} == \
            {k: v for k, v in b.items() if k != "time_s"}
    for k, v in res[0]["sd"].items():
        np.testing.assert_array_equal(res[1]["sd"][k], v)
    assert {r["restored"] == r["test"] for r in res} == {True}
    assert res[0]["hp"] == HP
    net = ArxivNet(ConvSpec(**EGC_M), HIDDEN, num_layers=3, dropout=0.0,
                   num_features=FEATS, num_classes=CLASSES)
    payload = torch.load(d / "checkpoint.pt", weights_only=True)
    net.load_state_dict(payload["model"], strict=True)
    assert set(json.loads((d / "checkpoint.json").read_text())) == \
        {"hparams", "plateau", "extra"}


@pytest.mark.parametrize("name", ["egc_overlap", "gat"])
def test_replicas_start_from_the_seed(name):
    """Every rank builds its replica from the trial seed: the
    ``DistributedNodeClassifier`` of a seed holds the ``ArxivNet`` of the
    same seed, key for key (so no broadcast is needed, and
    ``checkpoint.pt`` has one format)."""
    from egc_tpu_torch.models.nets import ArxivNet, ConvSpec
    from egc_tpu_torch.parallel.halo import DistributedNodeClassifier
    conv = ConvSpec(**CONVS[name][0])
    kw = dict(num_layers=2, num_features=FEATS, num_classes=CLASSES)
    got = DistributedNodeClassifier(
        conv, HIDDEN, e_interior=128,
        generator=torch.Generator().manual_seed(7), **kw).state_dict()
    ref = ArxivNet(conv, HIDDEN, generator=torch.Generator().manual_seed(7),
                   **kw).state_dict()
    assert list(got) == list(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


def test_partitioned_config_refuses_without_its_group():
    from egc_tpu_torch.exp import fullgraph as tfg
    with pytest.raises(ValueError, match="process group"):
        tfg.PartitionedArxivConfig("gcn", 8, partitions=2)


def test_cli_partitions_agrees_with_main(tmp_path, monkeypatch):
    """``python -m egc_tpu_torch DIR egc arxiv ... --partitions 2 --check
    --check-epochs 2 --device cpu`` (2 gloo ranks, started by the
    command) prints, once, the dict that ``main.main`` prints for the
    same options on 2 devices: the same keys, two iterations, and
    accuracies of the synthetic arxiv splits (the two packages' seeded
    weights and dropout draws differ, so the values are not compared);
    and it writes nothing into EXP_DIR."""
    import jax
    import egc_tpu.parallel as jpar
    import main as jmain

    opts = ["egc", "arxiv", "--hidden", "16", "--egc-num-heads", "4",
            "--egc-num-bases", "4", "--aggrs", "symnorm,max,mean",
            "--partitions", "2", "--check", "--check-epochs", "2"]
    run = subprocess.run(
        [sys.executable, "-m", "egc_tpu_torch", str(tmp_path / "t")] + opts
        + ["--device", "cpu"], capture_output=True, text=True,
        timeout=TIMEOUT, cwd=REPO)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.strip().splitlines()
    assert sum(line.startswith("{'best_val'") for line in lines) == 1
    assert sum(line.startswith("[arxiv] trial") for line in lines) == 1
    got = ast.literal_eval(lines[-1])
    assert list((tmp_path / "t").iterdir()) == []

    orig = jpar.make_mesh
    monkeypatch.setattr(jpar, "make_mesh", lambda axes: orig(
        axes, devices=jax.devices()[:2]))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jmain.main.main(args=[str(tmp_path / "j")] + opts,
                        standalone_mode=False)
    ref = ast.literal_eval(out.getvalue().strip().splitlines()[-1])
    assert got.keys() == ref.keys() == {"best_val", "best_iter", "test"}
    assert got["test"].keys() == ref["test"].keys()
    assert got["best_iter"] in (0, 1) and ref["best_iter"] in (0, 1)
    for res in (got, ref):
        assert 0.0 <= res["best_val"] <= 1.0
        assert all(0.0 <= v <= 1.0 for v in res["test"].values())


def test_parallel_modules_import_no_jax():
    """``parallel/*`` and the new ``exp`` modules import neither ``jax`` nor
    ``egc_tpu`` (in a fresh interpreter)."""
    mods = ["egc_tpu_torch.parallel", "egc_tpu_torch.parallel.mesh",
            "egc_tpu_torch.parallel.dp", "egc_tpu_torch.parallel.partition",
            "egc_tpu_torch.parallel.halo", "egc_tpu_torch.exp.pretrained",
            "egc_tpu_torch.exp.parallel_search",
            "egc_tpu_torch.exp.weight_port", "egc_tpu_torch.exp.fullgraph",
            "egc_tpu_torch.cli"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'flax' or m == 'egc_tpu' or "
            "m.startswith('egc_tpu.')]\nprint(bad)\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=TIMEOUT, cwd=REPO)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "[]"
