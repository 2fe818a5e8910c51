"""The port's public segment ops against ``egc_tpu.ops`` on the CPU:
``segment_var``, ``segment_std`` and ``segment_softmax``, with and
without ``mask``, on segments that include empty ones, for values and
the gradient of a fixed projection; and the package exports the same
names.

Tolerances: values rtol 1e-5 / atol 1e-6, gradients relative L2 <= 1e-4
(the ops reduce in another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import egc_tpu.ops as jops

import egc_tpu_torch.ops as tops

torch.set_num_threads(2)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def test_exports_the_jax_names():
    names = {n for n in dir(jops) if not n.startswith("_")}
    ported = {n for n in dir(tops) if not n.startswith("_")}
    assert names - {"segment", "dispatch", "pallas"} <= ported


def _segments(seed, shape):
    """Data over 40 entries into 9 segments, of which 2 hold no entry and
    one only masked entries; the mask drops about a quarter."""
    rng = np.random.default_rng(seed)
    e, n = 40, 9
    ids = rng.integers(0, n - 3, e).astype(np.int32)
    ids[:3] = n - 3                     # segment n - 3: masked entries only
    mask = rng.random(e) > 0.25
    mask[:3] = False
    x = rng.normal(size=(e,) + shape).astype(np.float32)
    proj = rng.normal(size=(n,) + shape).astype(np.float32)
    return x, ids, mask, n, proj


@pytest.mark.parametrize("op", ["segment_var", "segment_std"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(5,), (2, 3)])
def test_var_std_match_jax(op, masked, shape):
    x, ids, mask, n, proj = _segments(1, shape)
    m = mask if masked else None

    def jf(xx):
        out = getattr(jops, op)(xx, jnp.asarray(ids), n,
                                mask=None if m is None else jnp.asarray(m))
        return jnp.sum(out * proj), out

    (_, ref), jgrad = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = getattr(tops, op)(xt, torch.as_tensor(ids), n,
                            mask=None if m is None else torch.as_tensor(m))
    (out * torch.as_tensor(proj)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    empty = 1e-5 ** 0.5 if op == "segment_std" else 0.0
    np.testing.assert_allclose(out.detach().numpy()[n - 2:], empty,
                               rtol=1e-6)
    assert rel_l2(xt.grad.numpy(), jgrad) <= 1e-4
    if masked:
        assert np.all(xt.grad.numpy()[~mask] == 0)


def test_std_gate_of_a_constant_segment():
    """A segment of equal values has var 0: std gives sqrt(1e-5) and its
    gradient is gated to 0, as the JAX op's."""
    x = np.full((4, 3), 0.7, np.float32)
    ids = np.zeros(4, np.int32)
    jgrad = jax.grad(lambda xx: jnp.sum(jops.segment_std(
        xx, jnp.asarray(ids), 1)))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tops.segment_std(xt, torch.as_tensor(ids), 1).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(), (3,)])
def test_softmax_matches_jax(masked, shape):
    """Per-segment probabilities (a masked entry 0, a segment with no
    unmasked entry all 0) and the gradient of a projection."""
    x, ids, mask, n, _ = _segments(2, shape)
    x = 3.0 * x
    m = mask if masked else None
    proj = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)

    def jf(xx):
        out = jops.segment_softmax(
            xx, jnp.asarray(ids), n,
            mask=None if m is None else jnp.asarray(m))
        return jnp.sum(out * proj), out

    (_, ref), jgrad = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = tops.segment_softmax(xt, torch.as_tensor(ids), n,
                               mask=None if m is None else
                               torch.as_tensor(m))
    (out * torch.as_tensor(proj)).sum().backward()
    got = out.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert rel_l2(xt.grad.numpy(), jgrad) <= 1e-4
    keep = mask if masked else np.ones(len(ids), bool)
    sums = np.zeros((n,) + shape)
    np.add.at(sums, ids[keep], got[keep])
    live = np.unique(ids[keep])
    np.testing.assert_allclose(sums[live], 1.0, rtol=1e-5)
    if masked:
        assert np.all(got[~mask] == 0)
