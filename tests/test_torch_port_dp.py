"""Port parity for data parallelism (``egc_tpu_torch.parallel.dp``) against
the JAX package on the CPU: one DP step of ZincNet EGC at world 2 (two
gloo ranks, each its own microbatch of zinc graphs; spawned under a 120 s
timeout) against JAX's ``make_dp_train_step`` on 2 devices and against
one device on the stacked batch (``tests/test_partition.py::
test_dp_step_matches_big_batch``), from the same weights.

Tolerances: the loss at rtol 1e-5, the gradients (SGD at lr 1, so p - p'
is the gradient) at relative L2 1e-4, the BatchNorm running statistics
at 1e-6.
"""

import numpy as np
import pytest
import torch

from egc_tpu_torch.parallel import mesh as tmesh
from egc_tpu_torch.train.loop import fold_in

torch.set_num_threads(2)
CONV = dict(kind="egc", heads=2, bases=2, aggrs=("symnorm",), softmax=True)
MICRO = dict(num_nodes=160, num_edges=512, num_graphs=9)
WORLD, PER_RANK = 2, 4


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def zinc_graphs():
    from egc_tpu_torch.data import synthetic
    return synthetic.synthetic_zinc(num_graphs=64)["train"][:WORLD * PER_RANK]


def port_batches(graphs):
    from egc_tpu_torch.graph.structure import batch_np
    micro = [batch_np(graphs[d * PER_RANK:(d + 1) * PER_RANK], **MICRO)
             for d in range(WORLD)]
    big = batch_np(graphs, num_nodes=WORLD * MICRO["num_nodes"],
                   num_edges=WORLD * MICRO["num_edges"],
                   num_graphs=WORLD * MICRO["num_graphs"])
    return micro, big


def loss_sum(out, y, graph):
    m = graph.graph_mask.to(out.dtype)
    err = (out.reshape(-1) - torch.as_tensor(y).reshape(-1).to(out.dtype))
    return (err.abs() * m).sum(), m.sum()


def port_net(weights):
    from egc_tpu_torch.models.nets import ConvSpec, ZincNet
    net = ZincNet(ConvSpec(**CONV), 16, num_layers=2)
    net.load_state_dict(weights, strict=True)
    return net


def sgd_step(net, step_fn):
    """Run ``step_fn(optimizer)`` with SGD at lr 1: (loss, p - p', stats)."""
    opt = torch.optim.SGD(net.parameters(), lr=1.0)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    loss = step_fn(opt)
    after = net.state_dict()
    return (float(loss),
            {k: (before[k] - after[k]).numpy()
             for k, _ in net.named_parameters()},
            {k: v.numpy() for k, v in after.items() if "running" in k})


def dp_rank(mesh, weights):
    from egc_tpu_torch.parallel.dp import (
        make_dp_train_step, microbatch_iter, rank_generator,
    )
    micro, _ = port_batches(zinc_graphs())
    (g, y), = list(microbatch_iter(micro, mesh.world_size, mesh.rank))
    net = port_net(weights)
    step = make_dp_train_step(net, loss_sum, mesh.group)
    res = sgd_step(net, lambda opt: step(opt, g, torch.from_numpy(y)))
    seed = rank_generator(torch.Generator().manual_seed(3),
                          mesh.group).initial_seed()
    return res + (seed,)


@pytest.fixture(scope="module")
def setup():
    import jax
    import jax.numpy as jnp
    from egc_tpu.graph.structure import batch_np as jbatch_np
    from egc_tpu.models.nets import ConvSpec as JConvSpec
    from egc_tpu.models.nets import ZincNet as JZincNet
    from egc_tpu_torch.exp.weight_port import batched_state_dict_from_jax
    graphs = zinc_graphs()
    g0, _ = jbatch_np(graphs[:PER_RANK], **MICRO)
    net = JZincNet(conv=JConvSpec(**CONV), hidden_dim=16, num_layers=2,
                   residual=True)
    variables = jax.tree.map(np.asarray, net.init(
        jax.random.key(2), jax.tree.map(jnp.asarray, g0), train=False))
    weights = batched_state_dict_from_jax("zinc", variables, bases=2)
    ranks = tmesh.spawn(dp_rank, WORLD, device="cpu", timeout=120,
                        args=(weights,))
    return graphs, variables, weights, ranks


def _grad_gate(got, ref):
    keys = sorted(ref)
    assert sorted(got) == keys
    flat = [np.concatenate([np.ravel(d[k]) for k in keys])
            for d in (got, ref)]
    assert rel_l2(*flat) <= 1e-4
    scale = np.linalg.norm(flat[1])
    for k in keys:    # a conv bias feeds a BatchNorm: its gradient is noise
        if np.linalg.norm(ref[k]) > 1e-5 * scale:
            assert rel_l2(got[k], ref[k]) <= 1e-4, k


def test_microbatch_iter_groups_as_jax():
    """Consecutive groups of ``world_size`` batches, rank r taking the r-th
    of each; an incomplete last group is dropped."""
    from egc_tpu_torch.parallel.dp import microbatch_iter
    assert [list(microbatch_iter(range(7), 3, r)) for r in range(3)] == \
        [[0, 3], [1, 4], [2, 5]]


def test_dp_step_matches_big_batch(setup):
    """The DP step at world 2 equals the port's one-device step on the
    stacked batch: the loss, every gradient, the BatchNorm statistics;
    the two replicas stay equal."""
    graphs, _, weights, ranks = setup
    (loss, grads, stats, _), other = ranks[0], ranks[1]
    assert other[0] == loss
    for k, v in grads.items():
        np.testing.assert_array_equal(other[1][k], v)
    _, (big_g, big_y) = port_batches(graphs)
    net = port_net(weights)

    def one_device(opt):
        net.train()
        opt.zero_grad()
        s, c = loss_sum(net(big_g), big_y, big_g)
        (s / c).backward()
        opt.step()
        return (s / c).detach()

    ref_loss, ref_grads, ref_stats = sgd_step(net, one_device)
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    _grad_gate(grads, ref_grads)
    for k, v in stats.items():
        np.testing.assert_allclose(v, ref_stats[k], rtol=1e-6, atol=1e-6)


def test_dp_step_matches_jax(setup):
    """The DP step at world 2 equals JAX's ``make_dp_train_step`` on 2
    devices (SGD at lr 1), through the zinc weight port."""
    import jax
    import jax.numpy as jnp
    import optax
    from egc_tpu.graph.structure import batch_np as jbatch_np
    from egc_tpu.models.nets import ConvSpec as JConvSpec
    from egc_tpu.models.nets import ZincNet as JZincNet
    from egc_tpu.parallel import make_dp_train_step, make_mesh
    from egc_tpu.parallel import stack_microbatches
    from egc_tpu.train.state import TrainState
    from egc_tpu_torch.exp.weight_port import batched_state_dict_from_jax
    graphs, variables, _, ranks = setup
    loss, grads, stats, _ = ranks[0]

    def jloss_sum(out, y, graph):
        err = jnp.abs(out.reshape(-1) - y.reshape(-1).astype(out.dtype))
        m = graph.graph_mask.astype(out.dtype)
        return jnp.sum(err * m), jnp.sum(m)

    net = JZincNet(conv=JConvSpec(**CONV), hidden_dim=16, num_layers=2,
                   residual=True, bn_axis="data")
    state = TrainState.create(params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=optax.sgd(1.0))
    mesh = make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])
    step = make_dp_train_step(net, jloss_sum, mesh)
    sg, sy = stack_microbatches([
        jbatch_np(graphs[d * PER_RANK:(d + 1) * PER_RANK], **MICRO)
        for d in range(WORLD)])
    new, jloss = step(state, jax.tree.map(jnp.asarray, sg),
                      jnp.asarray(sy), jax.random.key(0))
    delta = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                         state.params, new.params)
    ref = batched_state_dict_from_jax(
        "zinc", {"params": delta,
                 "batch_stats": jax.tree.map(np.asarray, new.batch_stats)},
        bases=2)
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    _grad_gate(grads, {k: ref[k].numpy() for k in grads})
    for k, v in stats.items():
        np.testing.assert_allclose(v, ref[k].numpy(), rtol=1e-6, atol=1e-6)


def test_each_rank_draws_its_own_dropout_stream(setup):
    """Rank r's dropout generator is the step's folded with r
    (``fold_in(rng, axis_index)``)."""
    gen = torch.Generator().manual_seed(3)
    seeds = [r[3] for r in setup[3]]
    assert seeds == [fold_in(gen, r).initial_seed() for r in range(WORLD)]
    assert len(set(seeds)) == WORLD
