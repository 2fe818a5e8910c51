"""The gather-reduce kernels 1 and 2 on the card (``ops/cuda/gather_reduce``,
``csrc/gather_reduce.cu``) in each lane geometry (``lane_geometry``: split
at F 16 to 64, chunks then a split tail at F 136, 176 and 260, chunks at
F 37, 128 and 256): the forward with every primitive and both masks, and
the backward with every coefficient and both masks, against the plain
versions on a graph with a hub of 300 in-edges, 20 empty receivers and an
odd row count (a split warp's last group has no row), and on a bipartite
plan whose neighbouring rows differ in degree by 100x on both sides;
extrema and mask words exactly, sums against float64 at rtol = atol =
1e-5 (a row of more than 32 terms by relative L2 <= 1e-4, as
``exp/kernel_ab.py`` holds its hub rows), two launches bitwise; the
geometry counters; the compiled geometry rule against its mirror; and the
counters of a training step of the arxiv, mag and rmag configurations at
their cells' widths. No JAX here, so that the tests marked ``card`` run
on the chip: ``python -m pytest tests/test_torch_port_gather_reduce_card.py
--noconftest -m card``."""

import numpy as np
import pytest
import torch

from egc_tpu_torch.graph.transforms import coalesce_np
from egc_tpu_torch.ops import dispatch as dsp
from egc_tpu_torch.ops.cuda import gather_reduce as gr
from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

WIDTHS = (16, 32, 37, 40, 64, 128, 136, 176, 256, 260)
TOL = dict(rtol=1e-5, atol=1e-5)
LONG = 32   # a row summing more terms is held by relative L2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def hub_graph(seed, n=401, e=2400, hub_degree=300, isolated=20):
    """Coalesced graph over an odd ``n`` rows with a hub receiver (node 0)
    of ``hub_degree`` in-edges and ``isolated`` receivers without any,
    planned with random edge weights."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = rng.integers(1, n - isolated, e)
    s = np.concatenate([s, rng.choice(n, hub_degree, replace=False)])
    r = np.concatenate([r, np.zeros(hub_degree, np.int64)])
    s, r, _ = coalesce_np(s.astype(np.int32), r.astype(np.int32), n)
    return dsp.build_kernel_plan(s, r, n,
                                 edge_weight=rng.random(len(s)))


def skewed_bipartite(seed, n_src=257, n_dst=301):
    """A bipartite plan over odd row counts: even destination rows have 2
    in-edges, odd ones 200; even source rows are drawn 100x as often as
    odd ones."""
    rng = np.random.default_rng(seed)
    dst = np.arange(n_dst)
    r = np.repeat(dst, np.where(dst % 2 == 0, 2, 200))
    odds = np.where(np.arange(n_src) % 2 == 0, 100.0, 1.0)
    s = rng.choice(n_src, len(r), p=odds / odds.sum())
    keys = np.unique(s.astype(np.int64) * n_dst + r)
    return dsp.build_bipartite_kernel_plan(keys // n_dst, keys % n_dst,
                                           n_src, n_dst)


def tie_vals(seed, n, f):
    """Integer values in [-2, 2] (ties everywhere), with a signed zero
    wherever a value is 0: -0 and +0 must tie."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-2, 3, size=(n, f)).astype(np.float32)
    v[(v == 0) & (rng.random((n, f)) < 0.5)] = -0.0
    return torch.as_tensor(v)


def _inputs(graph, values, f, dev):
    """The plan on the card, its CSR and CSC edge weights, and its sender
    rows' values."""
    plan = hub_graph(f) if graph == "hub" else skewed_bipartite(f)
    rng = np.random.default_rng(f + 1)
    vals = tie_vals(f, plan.src_rows, f) if values == "ties" else \
        torch.as_tensor(rng.normal(size=(plan.src_rows, f))
                        .astype(np.float32))
    if plan.fwd_w is None:   # weights in CSR order, and where CSC puts them
        plan.fwd_w = torch.as_tensor(rng.random(plan.num_edges)
                                     .astype(np.float32))
        plan.bwd_w = torch.empty_like(plan.fwd_w)
        plan.bwd_w[plan.fwd_to_bwd.long()] = plan.fwd_w
    return plan.to(dev), vals.to(dev)


def _assert_sums_close(got, ref64, terms, msg=""):
    """``got`` against the float64 ``ref64``: rows of at most ``LONG``
    ``terms`` at ``TOL``, each longer row by relative L2 <= 1e-4."""
    got, short = got.double(), terms <= LONG
    torch.testing.assert_close(got[short], ref64[short], **TOL, msg=msg)
    err = (got[~short] - ref64[~short]).norm(dim=1)
    assert bool((err <= 1e-4 * ref64[~short].norm(dim=1)).all()), msg


def _counts_of(f, fwd, bwd):
    """The gather-reduce counters after ``fwd`` and ``bwd`` launches at
    width ``f``."""
    want = dict.fromkeys(gr.launches, 0)
    want.update(gather_reduce_fwd=fwd, gather_reduce_bwd=bwd)
    geometry = gr.lane_geometry(f)
    if geometry != "chunks":
        want[f"gather_reduce_fwd_{geometry}"] = fwd
        want[f"gather_reduce_bwd_{geometry}"] = bwd
    return want


@pytest.mark.card
@pytest.mark.parametrize("values", ["ties", "normal"])
@pytest.mark.parametrize("graph", ["hub", "bipartite"])
@pytest.mark.parametrize("f", WIDTHS)
def test_forward(card, f, graph, values):
    plan, vals = _inputs(graph, values, f, card)
    prims, masks = gr.PRIMS, gr.EXTREMA
    args = (vals, plan.rowptr, plan.fwd_senders, plan.fwd_w, prims)
    kw = dict(masks=masks, fwd_to_bwd=plan.fwd_to_bwd)
    reset_launch_counts()
    got = gr.gather_reduce_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert {k: launch_counts()[k] for k in gr.launches} == _counts_of(f, 1, 0)
    ref = gr.gather_reduce_fwd_plain(*args, **kw)
    ref64 = gr.gather_reduce_fwd_plain(vals.double(), *args[1:3],
                                       plan.fwd_w.double(), prims, **kw)
    for name, a, b, b64 in zip(prims + masks, got, ref, ref64):
        if name in ("sum", "wsum", "sumsq"):
            _assert_sums_close(a, b64, plan.rowptr.diff(), name)
        else:   # the extrema and both masks
            assert torch.equal(a, b), name
    empty = plan.deg == 0
    assert bool(empty.any()) == (graph == "hub")
    assert bool((got[3][empty] == 0).all() and (got[4][empty] == 0).all())
    again = gr.gather_reduce_fwd(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.card
@pytest.mark.parametrize("coeffs", [gr.COEFFS, ("c_sum", "c_max"),
                                    ("c_wsum",), ("c_sumsq2", "c_min")])
@pytest.mark.parametrize("values", ["ties", "normal"])
@pytest.mark.parametrize("graph", ["hub", "bipartite"])
@pytest.mark.parametrize("f", WIDTHS)
def test_backward(card, f, graph, values, coeffs):
    plan, vals = _inputs(graph, values, f, card)
    gen = torch.Generator(device=card).manual_seed(f)
    masks = gr.gather_reduce_fwd(
        vals, plan.rowptr, plan.fwd_senders, None, ("max", "min"),
        masks=gr.EXTREMA, fwd_to_bwd=plan.fwd_to_bwd)[2:]
    kw = {c: torch.randn(plan.num_nodes, f, generator=gen, device=card)
          for c in coeffs}
    if "c_wsum" in coeffs:
        kw["edge_w"] = plan.bwd_w
    if "c_sumsq2" in coeffs:
        kw["vals"] = vals
    if "c_max" in coeffs:
        kw["max_mask"] = masks[0]
    if "c_min" in coeffs:
        kw["min_mask"] = masks[1]
    reset_launch_counts()
    got = gr.gather_reduce_bwd(plan.colptr, plan.bwd_receivers, **kw)
    torch.cuda.synchronize()
    assert {k: launch_counts()[k] for k in gr.launches} == _counts_of(f, 0, 1)
    ref64 = gr.gather_reduce_bwd_plain(
        plan.colptr, plan.bwd_receivers,
        **{k: t if k.endswith("_mask") else t.double()
           for k, t in kw.items()})
    assert got.shape == (plan.src_rows, f)
    _assert_sums_close(got, ref64, plan.colptr.diff())
    assert torch.equal(got, gr.gather_reduce_bwd(plan.colptr,
                                                 plan.bwd_receivers, **kw))


@pytest.mark.card
def test_the_compiled_geometry_is_the_mirrors(card):
    for f in range(1, 600):
        assert gr.kernel_lane_geometry(f) == gr.lane_geometry(f), f
        assert gr.kernel_mask_words(f) == gr.mask_words(f), f


HP = {"lr": 0.01, "wd": 0.001, "dropout": 0.5}


def _arxiv(dev):
    from egc_tpu_torch.exp.fullgraph import ArxivConfig
    return ArxivConfig("egc", 136, heads=4, bases=4,
                       aggrs=("symnorm", "max", "mean"), device=dev)


def _mag(dev):
    from egc_tpu_torch.exp.fullgraph import MagConfig
    return MagConfig("egc", 352, heads=8, bases=4, aggrs=("symnorm",),
                     device=dev)


def _rmag(dev):
    from egc_tpu_torch.exp.hetero import RMagConfig
    return RMagConfig(64, heads=4, bases=4, device=dev)


# config at its cell's widths -> (geometry, gather pairs a training step,
# forwards an eval pass); the eval pass is the arxiv trial's
STEP_COUNTS = {"arxiv": (_arxiv, "split_tail", 3, 3),
               "mag": (_mag, "split_tail", 2, None),
               "rmag": (_rmag, "split", 9, None)}


@pytest.mark.card
@pytest.mark.parametrize("config", list(STEP_COUNTS))
def test_a_training_step_launches_in_its_geometry(card, config):
    """arxiv EGC-M h136 (F 136): 3 split-tail pairs a step and 3
    split-tail forwards an eval pass; mag's MagNet h352 H8 B4 (F 176): 2
    split-tail pairs; rmag's REGCNet h64 H4 B4 (F 64): 9 split pairs."""
    make, geometry, pairs, evals = STEP_COUNTS[config]
    cfg = make(card)
    data = cfg.data(HP)
    model = cfg.model(HP, seed=0)
    state = cfg.init_state(model, HP, data, 0)
    rng = cfg.rng(0)
    cfg.train(model, state, data, rng, 0)
    reset_launch_counts()
    steps = 2
    for it in range(1, steps + 1):
        cfg.train(model, state, data, rng, it)
    want = dict.fromkeys(gr.launches, 0)
    for k in ("fwd", "bwd"):
        want[f"gather_reduce_{k}"] = want[f"gather_reduce_{k}_{geometry}"] \
            = pairs * steps
    assert {k: launch_counts()[k] for k in gr.launches} == want
    if evals is not None:
        reset_launch_counts()
        cfg.val(model, state, data)
        want = dict.fromkeys(gr.launches, 0)
        want["gather_reduce_fwd"] = want[f"gather_reduce_fwd_{geometry}"] \
            = evals
        assert {k: launch_counts()[k] for k in gr.launches} == want
