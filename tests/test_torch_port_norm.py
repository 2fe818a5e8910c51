"""Port parity: masked BatchNorm (``ops/cuda/batch_norm``'s autograd
function through its plain versions on the CPU, as ``MaskedBatchNorm``
runs it) against two oracles:

- the autograd of the formula ``nn/norm.py`` ran before the kernels,
  copied here (``formula_bn``): the forward and the running statistics to
  the bit, the gradients to f32 rounding;
- the JAX package's ``MaskedBatchNorm`` and ``jax.vjp`` on the CPU.

y, dx, dweight, dbias, the running mean, variance and
``num_batches_tracked``, in training and evaluation, over masks (none,
some rows, no row valid), N in {1, 2, 57, 1000} and F in {34, 136, 352},
with one constant column. Also ``gradcheck`` in float64, the variance's
clamp, the grid and variant rules, and sync-BN over two gloo ranks
against one rank on the stacked rows.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from egc_tpu.nn.norm import MaskedBatchNorm as JaxBN
from egc_tpu_torch.nn.norm import MaskedBatchNorm
from egc_tpu_torch.ops.cuda import batch_norm as bn
from egc_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

MASKS = ("none", "some", "no_row")
NS = (1, 2, 57, 1000)
FS = (34, 136, 352)
CONST = 0.5     # the constant column: its sums are exact in f32


def formula_bn(x, mask, weight, bias, running_mean, running_var,
               num_batches_tracked, training):
    """``MaskedBatchNorm.forward``'s formula before the kernels (plain
    autograd; no process group)."""
    if not training:
        mean, var = running_mean, running_var
    else:
        xf = x.float()
        if mask is None:
            s, ssq = xf.sum(0), (xf * xf).sum(0)
            n = torch.tensor(float(x.shape[0]), device=x.device)
        else:
            m = mask.to(torch.float32)[:, None]
            s, ssq = (xf * m).sum(0), (xf * xf * m).sum(0)
            n = m.sum()
        n = torch.clamp(n, min=1.0)
        mean = s / n
        var = torch.clamp(ssq / n - mean * mean, min=0.0)
        with torch.no_grad():
            unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
            running_mean.mul_(1 - 0.1).add_(0.1 * mean)
            running_var.mul_(1 - 0.1).add_(0.1 * unbiased)
            num_batches_tracked.add_(1)
    y = (x.float() - mean) * torch.reciprocal(torch.sqrt(var + 1e-5))
    return (y * weight + bias).to(x.dtype)


def make_case(n, f, mask_kind, seed=0):
    """x [n, f] (column 0 constant), the mask, dy, weight, bias and the
    running statistics as numpy float32 / bool arrays."""
    rng = np.random.default_rng(seed + 31 * n + f)
    x = (rng.normal(size=(n, f)) * 2 + 0.5).astype(np.float32)
    x[:, 0] = CONST
    mask = {"none": None, "no_row": np.zeros(n, bool),
            "some": rng.random(n) < 0.6}[mask_kind]
    if mask is not None and mask_kind == "some":
        mask[0] = True
    dy = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=f).astype(np.float32)
    b = rng.normal(size=f).astype(np.float32)
    rm = rng.normal(size=f).astype(np.float32)
    rv = (rng.random(f) + 0.5).astype(np.float32)
    return x, mask, dy, w, b, rm, rv


def port_run(x, mask, dy, w, b, rm, rv, training, fn=None):
    """(y, dx, dweight, dbias, running_mean, running_var, tracked) of the
    port's module (or of ``fn`` with the module's arguments)."""
    f = x.shape[1]
    mod = MaskedBatchNorm(f)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w))
        mod.bias.copy_(torch.from_numpy(b))
        mod.running_mean.copy_(torch.from_numpy(rm))
        mod.running_var.copy_(torch.from_numpy(rv))
    mod.train(training)
    xt = torch.tensor(x, requires_grad=True)
    mt = None if mask is None else torch.from_numpy(mask)
    if fn is None:
        y = mod(xt, mt)
    else:
        y = fn(xt, mt, mod.weight, mod.bias, mod.running_mean,
               mod.running_var, mod.num_batches_tracked, training)
    y.backward(torch.from_numpy(dy))
    return (y.detach().numpy(), xt.grad.numpy(), mod.weight.grad.numpy(),
            mod.bias.grad.numpy(), mod.running_mean.numpy(),
            mod.running_var.numpy(), int(mod.num_batches_tracked))


def jax_run(x, mask, dy, w, b, rm, rv, training):
    """(y, dx, dscale, dbias, mean, var) of the JAX package's module."""
    f = x.shape[1]
    variables = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                 "batch_stats": {"mean": jnp.asarray(rm),
                                 "var": jnp.asarray(rv)}}
    m = None if mask is None else jnp.asarray(mask)

    def fwd(xj, scale, bias):
        v = {"params": {"scale": scale, "bias": bias},
             "batch_stats": variables["batch_stats"]}
        return JaxBN().apply(v, xj, m, use_running_average=not training,
                             mutable=["batch_stats"])

    y, vjp, upd = jax.vjp(fwd, jnp.asarray(x), jnp.asarray(w),
                          jnp.asarray(b), has_aux=True)
    dx, dw, db = vjp(jnp.asarray(dy))
    upd = upd["batch_stats"]
    assert f == y.shape[1]
    return tuple(np.asarray(a) for a in (y, dx, dw, db, upd["mean"],
                                         upd["var"]))


def scales(x, mask, dy, w, b, rm, rv, training):
    """The size of the f32 terms behind each of port_run's first six
    results, per column: y's own, the terms of dx and the magnitudes
    summed into dweight and dbias, each (except dbias) times
    kappa = E[x^2] / (var + eps) where training, the factor by which the
    uncentred ``E[x^2] - E[x]^2`` multiplies the rounding error of its
    sums (about 1 for spread columns, 1e5 for two rows a hundredth
    apart); the running statistics' own size."""
    x64, dy64 = x.astype(np.float64), dy.astype(np.float64)
    if training:
        xv = x64 if mask is None else x64[mask]
        cnt = max(xv.shape[0], 1)
        mean, ex2 = xv.sum(0) / cnt, (xv * xv).sum(0) / cnt
        var = np.maximum(ex2 - mean ** 2, 0.0)
        kap = np.maximum(1.0, ex2 / (var + 1e-5))
    else:
        mean, var, kap = rm.astype(np.float64), rv.astype(np.float64), 1.0
    r = 1.0 / np.sqrt(var + 1e-5)
    y = kap * (np.abs((x64 - mean) * r * w).max(0) + np.abs(w))
    # dx = dy w r + m (ds + 2 x dssq): the sizes of its terms, ds and dssq
    # through dvar = -r^3 w sum dy (x - mean) / 2 (training only)
    sgx = np.abs(dy64 * (x64 - mean)).sum(0)
    dx = kap * np.abs(dy64).max(0) * np.abs(w) * r
    if training:
        dvar = 0.5 * r ** 3 * np.abs(w) * sgx
        dx = dx + kap * (r * np.abs(w) * np.abs(dy64).sum(0) + 2 * dvar * (
            np.abs(x64).max(0) + np.abs(mean))) / cnt
    dw = kap * r * sgx
    db = np.abs(dy64).sum(0)
    stat = kap * (np.abs(rm) + np.abs(rv) + np.abs(mean) + var)
    return y, dx, dw, db, stat, stat


def close(got, ref, scale, rtol):
    """|got - ref| <= rtol (|ref| + scale): f32 results of the same terms
    in other orders; ``scale`` the size of the terms (``scales``)."""
    ref = np.asarray(ref, np.float64)
    err = np.abs(np.asarray(got, np.float64) - ref)
    tol = rtol * (np.abs(ref) + scale)
    assert np.all(err <= tol), (
        f"{int((err > tol).sum())} of {err.size} beyond tolerance; max "
        f"err {err.max():.3g}, max err / tol {(err / tol).max():.3g}")


@pytest.mark.parametrize("f", FS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("mask_kind", MASKS)
def test_training_matches_the_formula(mask_kind, n, f):
    """Training: y and the running statistics equal the formula's autograd
    bit for bit (the same operations on the CPU), the gradients within f32
    rounding; ``num_batches_tracked`` counts one."""
    case = make_case(n, f, mask_kind)
    got = port_run(*case, training=True)
    ref = port_run(*case, training=True, fn=formula_bn)
    for a, r in zip(got[:1] + got[4:6], ref[:1] + ref[4:6]):
        np.testing.assert_array_equal(a, r)
    sc = scales(*case, training=True)
    for a, r, scale in zip(got[1:4], ref[1:4], sc[1:4]):
        close(a, r, scale, 1e-5)
    assert got[6] == ref[6] == 1


@pytest.mark.parametrize("f", FS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("mask_kind", MASKS)
def test_training_matches_jax(mask_kind, n, f):
    """Training against the JAX package's module and ``jax.vjp``: y, dx,
    dweight (JAX's scale), dbias and the running statistics."""
    case = make_case(n, f, mask_kind)
    got = port_run(*case, training=True)
    ref = jax_run(*case, training=True)
    for a, r, scale in zip(got[:6], ref, scales(*case, training=True)):
        close(a, r, scale, 1e-5)


@pytest.mark.parametrize("f", FS)
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("oracle", ("formula", "jax"))
def test_evaluation_matches(oracle, mask_kind, f):
    """Evaluation reads the running statistics and leaves them, and
    ``num_batches_tracked``, as they were; y to the bit against the
    formula, and the gradients, against both oracles."""
    case = make_case(57, f, mask_kind)
    got = port_run(*case, training=False)
    np.testing.assert_array_equal(got[4], case[5])
    np.testing.assert_array_equal(got[5], case[6])
    assert got[6] == 0
    sc = scales(*case, training=False)
    if oracle == "formula":
        ref = port_run(*case, training=False, fn=formula_bn)
        np.testing.assert_array_equal(got[0], ref[0])
        for a, r, scale in zip(got[1:4], ref[1:4], sc[1:4]):
            close(a, r, scale, 1e-5)
    else:
        ref = jax_run(*case, training=False)
        for a, r, scale in zip(got[:4], ref[:4], sc):
            close(a, r, scale, 1e-5)


def _negative_u_column(n):
    """A constant whose column of n rows has ssq / n - mean^2 below 0 in f32
    (the clamp at work) and a mean off the constant (so that, with masked
    rows beside it, the clamp's gradient reaches dx), found among a few."""
    for c in np.linspace(0.1, 3.0, 300, dtype=np.float32):
        col = torch.full((n, 1), float(c))
        s, ssq = col.sum(0), (col * col).sum(0)
        mean = s / n
        if float(ssq / n - mean * mean) < 0 and float(mean) != float(c):
            return float(c)
    raise AssertionError("no constant rounds the variance below 0")


@pytest.mark.parametrize("mask_kind", ("none", "some"))
def test_the_variance_clamp(mask_kind):
    """A constant column whose f32 variance rounds below 0: var is clamped
    to 0 and the clamp passes no gradient, as the formula's autograd (with
    masked rows of another value, a gradient let through would move dx);
    the other columns as there."""
    n, f = 1000, 34
    x, mask, dy, w, b, rm, rv = make_case(n, f, mask_kind)
    c = _negative_u_column(n if mask is None else int(mask.sum()))
    x[:, 3] = c
    if mask is not None:        # the clamp needs the valid rows' count
        x[~mask, 3] = 7.0
    stats = bn.stats_plain(torch.from_numpy(x),
                           None if mask is None else torch.from_numpy(mask))
    pos = bn._columns(stats, None, None, f)[4]
    assert not bool(pos[3]) and bool(pos[1])
    got = port_run(x, mask, dy, w, b, rm, rv, training=True)
    ref = port_run(x, mask, dy, w, b, rm, rv, training=True, fn=formula_bn)
    np.testing.assert_array_equal(got[0], ref[0])
    sc = scales(x, mask, dy, w, b, rm, rv, training=True)
    for a, r, scale in zip(got[1:4], ref[1:4], sc[1:4]):
        close(a, r, scale, 1e-5)
    # the cotangents of (s, ssq) that bn_grad_sums forms, against autograd
    # through the formula from the same statistics: the clamped column's
    # dssq is 0, the others' not
    d = bn.grad_sums_plain(torch.from_numpy(dy), torch.from_numpy(x), stats,
                           None, None, torch.from_numpy(w))[2]
    ds_ref, dssq_ref = stats_cotangents(x, stats, dy, w)
    assert float(d[f + 3]) == float(dssq_ref[3]) == 0.0
    assert bool((dssq_ref[4:] != 0).all())
    close(d[:f].numpy(), ds_ref, np.abs(ds_ref).max(), 1e-5)
    close(d[f:].numpy(), dssq_ref, np.abs(dssq_ref).max(), 1e-5)


def stats_cotangents(x, stats, dy, w):
    """Autograd's cotangents of s and ssq in the formula's y, from
    ``stats``."""
    f = x.shape[1]
    s = stats[:f].clone().requires_grad_(True)
    ssq = stats[f:2 * f].clone().requires_grad_(True)
    n = torch.clamp(stats[2 * f], min=1.0)
    mean = s / n
    var = torch.clamp(ssq / n - mean * mean, min=0.0)
    y = (torch.from_numpy(x) - mean) * torch.reciprocal(torch.sqrt(
        var + 1e-5)) * torch.from_numpy(w)
    ds, dssq = torch.autograd.grad(y, (s, ssq), torch.from_numpy(dy))
    return ds.numpy(), dssq.numpy()


@pytest.mark.parametrize("training", (True, False))
def test_gradcheck_float64(training):
    """The function's backward (the plain ``grad_sums`` and ``apply_bwd``)
    against finite differences of its forward, in float64."""
    gen = torch.Generator().manual_seed(5)
    n, f = 9, 6
    x = torch.randn(n, f, generator=gen, dtype=torch.float64) * 2 + 0.5
    mask = torch.tensor([True, False] * 4 + [True])
    w = torch.randn(f, generator=gen, dtype=torch.float64)
    b = torch.randn(f, generator=gen, dtype=torch.float64)
    rm = torch.randn(f, generator=gen, dtype=torch.float64)
    rv = torch.rand(f, generator=gen, dtype=torch.float64) + 0.5
    nbt = torch.tensor(0)

    def fn(x_, w_, b_):
        return bn.masked_batch_norm(x_, mask, w_, b_, rm, rv, nbt,
                                    training=training)

    args = tuple(t.clone().requires_grad_(True) for t in (x, w, b))
    assert torch.autograd.gradcheck(fn, args)


def test_grid_and_variant_rules():
    """The grid covers every row, at most ``max_blocks`` blocks of whole
    passes, and a short input launches a small grid; the float4 variant
    wants F % 4 == 0 and aligned pointers."""
    for n in (0, 1, 2, 57, 128, 1000, 169_344, 736_389):
        for f in (1, 34, 68, 136, 352, 750, 4096):
            for vec in (True, False):
                if vec and f % 4:
                    continue
                blocks, rpb = bn.grid(n, f, vec, bn.SUM_BLOCKS)
                c = f // 4 if vec else f
                rows = bn.THREADS // min(c, bn.THREADS)
                assert 1 <= blocks <= bn.SUM_BLOCKS
                assert rpb % rows == 0 and blocks * rpb >= n
    assert bn.grid(128, 136, True, bn.SUM_BLOCKS)[0] == 2
    assert bn.grid(169_344, 136, True, bn.SUM_BLOCKS)[0] == bn.SUM_BLOCKS
    assert bn.variant(136, [0, 16, 32]) == "vector"
    assert bn.variant(136, [0, 4]) == "scalar"
    assert bn.variant(34, [0]) == "scalar"


def test_launchers_refuse_cpu_tensors():
    """The kernel launchers take CUDA tensors only: on the CPU they raise
    (the dispatch runs the plain versions there)."""
    x, w = torch.zeros(4, 8), torch.ones(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        bn._launch_stats(x, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        bn._launch_apply(x, None, w, w, w, w, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        bn._launch_grad_sums(x, x, None, w, w, w)
    with pytest.raises(RuntimeError, match="CUDA"):
        bn._launch_apply_bwd(x, x, None, None, w, w, w, torch.zeros(16))


def test_launches_count_nothing_on_the_cpu():
    bn.launches.update(dict.fromkeys(bn.launches, 0))
    port_run(*make_case(57, 34, "some"), training=True)
    assert set(bn.launches) == {"bn_stats", "bn_apply", "bn_grad_sums",
                                "bn_apply_bwd"}
    assert not any(bn.launches.values())


# ---------------------------------------------------------------------------
# sync-BN over two gloo ranks
# ---------------------------------------------------------------------------

SYNC_N, SYNC_F = 90, 34


def sync_case():
    x, mask, dy, w, b, rm, rv = make_case(2 * SYNC_N, SYNC_F, "some", seed=7)
    return x, mask, dy, w, b, rm, rv


def sync_rank(mesh):
    """Rank r's half of the stacked rows through a module whose process
    group is the world."""
    from egc_tpu_torch.nn.norm import sync_process_group
    x, mask, dy, w, b, rm, rv = sync_case()
    rows = slice(mesh.rank * SYNC_N, (mesh.rank + 1) * SYNC_N)

    def fn(xt, mt, weight, bias, running_mean, running_var, tracked, tr):
        mod = sync_process_group(MaskedBatchNorm(SYNC_F), mesh.group)
        mod.weight, mod.bias = weight, bias
        mod.running_mean, mod.running_var = running_mean, running_var
        mod.num_batches_tracked = tracked
        return mod(xt, mt)

    return port_run(x[rows], mask[rows], dy[rows], w, b, rm, rv,
                    training=True, fn=fn)


def test_sync_bn_matches_one_rank_on_the_stacked_rows():
    """World 2: each rank's y and dx rows, the running statistics on both
    ranks, and the ranks' dweight and dbias summed, against one module on
    all the rows (``psum``'s semantics: the global batch's statistics)."""
    ranks = tmesh.spawn(sync_rank, 2, device="cpu", timeout=120)
    one = port_run(*sync_case(), training=True)
    sc = scales(*sync_case(), training=True)
    for r, got in enumerate(ranks):
        rows = slice(r * SYNC_N, (r + 1) * SYNC_N)
        close(got[0], one[0][rows], sc[0], 1e-5)
        close(got[1], one[1][rows], sc[1], 1e-5)
        close(got[4], one[4], sc[4], 1e-5)
        close(got[5], one[5], sc[5], 1e-5)
        assert got[6] == 1
    close(ranks[0][2] + ranks[1][2], one[2], sc[2], 1e-5)
    close(ranks[0][3] + ranks[1][3], one[3], sc[3], 1e-5)
