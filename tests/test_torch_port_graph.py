"""Port parity: graph transforms, synthetic data, the kernel plan and the
plain segment reductions against the JAX package (CPU)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from egc_tpu.data import synthetic as jsyn
from egc_tpu.graph import structure as jstruct
from egc_tpu.graph import transforms as jtf
from egc_tpu.ops import segment as jseg

from egc_tpu_torch.data import synthetic as tsyn
from egc_tpu_torch.graph import structure as tstruct
from egc_tpu_torch.graph import transforms as ttf
from egc_tpu_torch.ops import segment as tseg
from egc_tpu_torch.ops.dispatch import build_kernel_plan

torch.set_num_threads(2)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def masked_graph(seed=0, n=60, e=300, pad_e=20):
    """A coalesced graph with one pre-existing self-loop and masked padding
    edges pointing at the last node."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n - 1, e).astype(np.int32)
    r = rng.integers(0, n - 1, e).astype(np.int32)
    s, r, _ = ttf.coalesce_np(s, r, n)
    s = np.concatenate([s, [5], np.full(pad_e, n - 1)]).astype(np.int32)
    r = np.concatenate([r, [5], np.full(pad_e, n - 1)]).astype(np.int32)
    mask = np.ones(len(s), bool)
    mask[-pad_e:] = False
    return s, r, mask, n


@pytest.mark.parametrize("add_self_loops", [True, False])
def test_symnorm_weight_matches_jax(add_self_loops):
    s, r, mask, n = masked_graph()
    ew_j, sw_j = jtf.symnorm_weight(jnp.asarray(s), jnp.asarray(r), n,
                                    edge_mask=jnp.asarray(mask),
                                    add_self_loops=add_self_loops)
    ew_t, sw_t = ttf.symnorm_weight(torch.as_tensor(s), torch.as_tensor(r),
                                    n, edge_mask=torch.as_tensor(mask),
                                    add_self_loops=add_self_loops)
    np.testing.assert_allclose(ew_t.numpy(), np.asarray(ew_j), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(sw_t.numpy(), np.asarray(sw_j), rtol=1e-6,
                               atol=1e-7)
    assert np.all(ew_t.numpy()[~mask] == 0)          # masked edges
    if add_self_loops:                    # the pre-existing loop is deduped
        assert ew_t.numpy()[len(s) - 21] == 0
    deg_j = jtf.in_degree(jnp.asarray(r), n, jnp.asarray(mask))
    deg_t = ttf.in_degree(torch.as_tensor(r), n, torch.as_tensor(mask))
    np.testing.assert_array_equal(deg_t.numpy(), np.asarray(deg_j))


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_full_graph_is_array_equal(seed):
    a = jsyn.synthetic_full_graph(num_nodes=500, avg_degree=10, seed=seed)
    b = tsyn.synthetic_full_graph(num_nodes=500, avg_degree=10, seed=seed)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                      err_msg=k)


def test_undirected_and_coalesce_match_jax():
    rng = np.random.default_rng(2)
    s = rng.integers(0, 40, 200).astype(np.int32)
    r = rng.integers(0, 40, 200).astype(np.int32)
    for got, ref in zip(ttf.to_undirected_np(s, r, 40),
                        jtf.to_undirected_np(s, r, 40)):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(ttf.coalesce_np(s, r, 40), jtf.coalesce_np(s, r, 40)):
        np.testing.assert_array_equal(got, ref)


def test_pad_graph_matches_jax():
    s, r, _, n = masked_graph(pad_e=0)
    x = np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32)
    gj = jstruct.pad_graph(jstruct.Graph.from_coo(x, s, r), num_nodes=n + 5,
                           num_edges=len(s) + 9)
    gt = tstruct.pad_graph(tstruct.Graph.from_coo(x, s, r), num_nodes=n + 5,
                           num_edges=len(s) + 9)
    for name in ("nodes", "senders", "receivers", "node_mask", "edge_mask",
                 "graph_ids", "graph_mask"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                      np.asarray(getattr(gj, name)),
                                      err_msg=name)


def test_plan_csr_and_csc_hold_the_valid_edges():
    s, r, mask, n = masked_graph(seed=4)
    w = np.random.default_rng(5).random(len(s)).astype(np.float32)
    plan = build_kernel_plan(s, r, n, edge_mask=mask, edge_weight=w)
    valid = sorted(zip(s[mask].tolist(), r[mask].tolist(), w[mask].tolist()))
    # forward CSR: receiver-major rows, senders inside
    rp = plan.rowptr.numpy()
    fwd = []
    for row in range(n):
        for k in range(rp[row], rp[row + 1]):
            fwd.append((int(plan.fwd_senders[k]), row, float(plan.fwd_w[k])))
    # backward CSC: sender-major rows, receivers inside
    cp = plan.colptr.numpy()
    bwd = []
    for row in range(n):
        for k in range(cp[row], cp[row + 1]):
            bwd.append((row, int(plan.bwd_receivers[k]), float(plan.bwd_w[k])))
    assert sorted(fwd) == valid and sorted(bwd) == valid
    assert plan.num_edges == int(mask.sum())
    np.testing.assert_array_equal(plan.fwd_perm.numpy(),
                                  np.nonzero(mask)[0][np.lexsort(
                                      (s[mask], r[mask]))])
    np.testing.assert_array_equal(
        plan.deg.numpy(), np.bincount(r[mask], minlength=n).astype(np.float32))
    # the padding node's masked self-loops are not in the plan
    assert rp[n] - rp[n - 1] == 0 and cp[n] - cp[n - 1] == 0


SEG_CASES = [
    (("sum", "mean", "max", "min"), False, False),
    (("sum", "mean", "max", "min", "var", "std"), True, True),
    (("symnorm", "max", "mean"), False, True),
    (("min", "std", "symnorm"), True, False),
]


@pytest.mark.parametrize("aggrs,include_self,use_mask", SEG_CASES)
def test_multi_aggregate_matches_jax(aggrs, include_self, use_mask):
    s, r, mask, n = masked_graph(seed=6)
    if not use_mask:
        mask = None
    rng = np.random.default_rng(8)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    proj = rng.normal(size=(n, len(aggrs), 16)).astype(np.float32)
    ew = sw = None
    kw_j, kw_t = {}, {}
    if "symnorm" in aggrs:
        ew, sw = jtf.symnorm_weight(jnp.asarray(s), jnp.asarray(r), n,
                                    edge_mask=None if mask is None
                                    else jnp.asarray(mask))
        kw_j = dict(symnorm_edge_w=ew, symnorm_self_w=sw)
        kw_t = dict(symnorm_edge_w=torch.tensor(np.asarray(ew)),
                    symnorm_self_w=torch.tensor(np.asarray(sw)))

    def fj(v):
        return jseg.multi_aggregate(
            v, jnp.asarray(s), jnp.asarray(r), aggrs,
            edge_mask=None if mask is None else jnp.asarray(mask),
            include_self=include_self, **kw_j)

    ref, vjp = jax.vjp(fj, jnp.asarray(x))
    (g_ref,) = vjp(jnp.asarray(proj))

    xt = torch.tensor(x, requires_grad=True)
    got = tseg.multi_aggregate(
        xt, torch.as_tensor(s), torch.as_tensor(r), aggrs,
        edge_mask=None if mask is None else torch.as_tensor(mask),
        include_self=include_self, **kw_t)
    (got * torch.as_tensor(proj)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    assert rel_l2(xt.grad.numpy(), g_ref) <= 1e-4


@pytest.mark.parametrize("prim", ["sum", "wsum", "sumsq", "max", "min"])
def test_segment_primitives_match_jax(prim):
    """Masked segment primitives over edge data, values and gradients;
    empty segments (the padding node) give 0."""
    s, r, mask, n = masked_graph(seed=9)
    rng = np.random.default_rng(10)
    data = rng.normal(size=(len(r), 8)).astype(np.float32)
    w = rng.random(len(r)).astype(np.float32)
    ct = rng.normal(size=(n, 8)).astype(np.float32)
    jr, jm = jnp.asarray(r), jnp.asarray(mask)

    def fj(d):
        if prim == "sum":
            return jseg.segment_sum(d, jr, n, mask=jm)
        if prim == "wsum":
            return jseg.segment_sum(d * jnp.asarray(w)[:, None], jr, n,
                                    mask=jm)
        if prim == "sumsq":
            return jseg.segment_sum(d * d, jr, n, mask=jm)
        return getattr(jseg, f"segment_{prim}")(d, jr, n, mask=jm)

    ref, vjp = jax.vjp(fj, jnp.asarray(data))
    (g_ref,) = vjp(jnp.asarray(ct))
    dt = torch.tensor(data, requires_grad=True)
    tr, tm = torch.as_tensor(r), torch.as_tensor(mask)
    if prim == "wsum":
        got = tseg.segment_wsum(dt, tr, torch.as_tensor(w), n, mask=tm)
    else:
        got = getattr(tseg, f"segment_{prim}")(dt, tr, n, mask=tm)
    got.backward(torch.as_tensor(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    assert np.all(got.detach().numpy()[n - 1] == 0)
    assert rel_l2(dt.grad.numpy(), g_ref) <= 1e-5


def test_segment_max_ties_get_the_full_cotangent():
    """Three edges into receiver 0 carry the same value: each gets the
    whole cotangent, as in the JAX package (not torch's even split)."""
    s = np.array([1, 2, 3, 1], np.int32)
    r = np.array([0, 0, 0, 2], np.int32)
    x = np.array([[0.0], [2.0], [2.0], [2.0]], np.float32)
    ct = np.array([[1.5], [0.0], [0.7], [0.0]], np.float32)

    def fj(v):
        return jseg.multi_aggregate(v, jnp.asarray(s), jnp.asarray(r),
                                    ("max", "min"))
    _, vjp = jax.vjp(fj, jnp.asarray(x))
    (g_ref,) = vjp(jnp.asarray(np.stack([ct, ct], 1)))
    xt = torch.tensor(x, requires_grad=True)
    out = tseg.multi_aggregate(xt, torch.as_tensor(s), torch.as_tensor(r),
                               ("max", "min"))
    (out * torch.as_tensor(np.stack([ct, ct], 1))).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(g_ref))
    # node 1 feeds receivers 0 and 2 (max and min each): 2 * (1.5 + 0.7)
    assert xt.grad[1, 0].item() == pytest.approx(4.4)
    assert out[1, 0, 0].item() == 0.0 and out[3, 1, 0].item() == 0.0
