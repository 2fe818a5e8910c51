"""Port parity: the head mix (kernels 3/4 through their plain versions on
the CPU) against the JAX ``head_mix_fused`` with its Pallas kernels in
interpret mode, values and gradients w.r.t. w, ys and bias."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import jax.experimental.pallas as pl
import egc_tpu.ops.pallas.headmix as jhm

from egc_tpu_torch.ops.cuda import headmix as thm

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jhm.pl, "pallas_call", patched)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


@pytest.mark.parametrize("H,B,A,L,yw,with_bias", [
    (4, 4, 3, 32, 128, True),      # arxiv EGC-M h128
    (4, 4, 3, 32, 128, False),
    (2, 3, 2, 5, 24, True),        # odd shape, y_width > B*L
    (3, 2, 1, 7, 14, False),       # A = 1
])
def test_head_mix_matches_jax(H, B, A, L, yw, with_bias):
    n = 100
    rng = np.random.default_rng(0)
    w2d = rng.normal(size=(n, H * B * A)).astype(np.float32)
    ys = [rng.normal(size=(n, yw)).astype(np.float32) for _ in range(A)]
    bias = rng.normal(size=(H * L,)).astype(np.float32) if with_bias \
        else None
    dz = rng.normal(size=(n, H * L)).astype(np.float32)

    def fj(w, y, b):
        return jhm.head_mix_fused(w, y, H=H, B=B, A=A, L=L, y_width=yw,
                                  bias=b)

    args = (jnp.asarray(w2d), tuple(jnp.asarray(y) for y in ys),
            None if bias is None else jnp.asarray(bias))
    ref, vjp = jax.vjp(fj, *args)
    dw_ref, dys_ref, db_ref = vjp(jnp.asarray(dz))

    wt = torch.tensor(w2d, requires_grad=True)
    yts = [torch.tensor(y, requires_grad=True) for y in ys]
    bt = None if bias is None else torch.tensor(bias, requires_grad=True)
    got = thm.head_mix_fused(wt, yts, H=H, B=B, A=A, L=L, y_width=yw,
                             bias=bt)
    got.backward(torch.as_tensor(dz))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    assert rel_l2(wt.grad.numpy(), dw_ref) <= 1e-4
    for a in range(A):
        assert rel_l2(yts[a].grad.numpy(), dys_ref[a]) <= 1e-4
        # dy's tail beyond B*L is exactly zero on both sides
        assert np.all(yts[a].grad.numpy()[:, B * L:] == 0)
    if with_bias:
        assert rel_l2(bt.grad.numpy(), db_ref) <= 1e-4


def test_plain_bwd_is_the_autograd_of_plain_fwd():
    """The explicit plain backward (kernel 4's reference) equals autograd
    through the plain forward formula."""
    H, B, A, L, yw, n = 4, 4, 3, 32, 130, 50
    rng = np.random.default_rng(3)
    w = torch.tensor(rng.normal(size=(n, H * B * A)).astype(np.float32),
                     requires_grad=True)
    ys = [torch.tensor(rng.normal(size=(n, yw)).astype(np.float32),
                       requires_grad=True) for _ in range(A)]
    dz = torch.tensor(rng.normal(size=(n, H * L)).astype(np.float32))
    thm.headmix_fwd_plain(w, ys, None, H=H, B=B, A=A, L=L).backward(dz)
    dw, dys = thm.headmix_bwd_plain(w.detach(), [y.detach() for y in ys], dz,
                                    H=H, B=B, A=A, L=L, y_width=yw)
    torch.testing.assert_close(dw, w.grad, rtol=1e-5, atol=1e-5)
    for a in range(A):
        torch.testing.assert_close(dys[a], ys[a].grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L,yw,offsets,with_bias,want", [
    (32, 128, (0, 0, 0), True, "vector"),     # arxiv EGC-M h128
    (8, 32, (0, 0), True, "vector"),          # y_width > B*L
    (10, 40, (0,), True, "scalar"),           # L % 4 != 0
    (5, 24, (0, 0), False, "scalar"),
    (8, 30, (0,), False, "scalar"),           # y_width % 4 != 0
    (32, 128, (0, 1, 0), True, "scalar"),     # one ys 4 bytes off
    (32, 128, (0, 0, 0), False, "vector"),
])
def test_fwd_variant_rule(L, yw, offsets, with_bias, want):
    """Kernel 3's variant from L, y_width and the alignment of the ys and
    bias pointers, on real CPU tensors (the rule the card's kernel uses)."""
    n = 6
    bufs = [torch.zeros(n * yw + 4) for _ in offsets]
    ys = [b[o:o + n * yw].view(n, yw) for b, o in zip(bufs, offsets)]
    assert all(y.is_contiguous() for y in ys)
    bias = torch.zeros(4 * L) if with_bias else None
    ptrs = [y.data_ptr() for y in ys] + ([bias.data_ptr()] if with_bias
                                         else [0])
    assert thm.fwd_variant(L, yw, ptrs) == want
    # the bias alone misaligned also forces the scalar variant
    if with_bias:
        off_bias = torch.zeros(4 * L + 1)[1:]
        assert thm.fwd_variant(L, yw, ptrs[:-1] + [off_bias.data_ptr()]) \
            == "scalar"


def test_offset_views_match_jax():
    """ys handed over as contiguous views at a 4-byte offset (the scalar
    variant on the card) give the JAX head mix on the CPU."""
    H, B, A, L, n = 4, 4, 3, 32, 40
    rng = np.random.default_rng(5)
    w2d = rng.normal(size=(n, H * B * A)).astype(np.float32)
    ys = [rng.normal(size=(n, B * L)).astype(np.float32) for _ in range(A)]
    ref = jhm.head_mix_fused(jnp.asarray(w2d), tuple(map(jnp.asarray, ys)),
                             H=H, B=B, A=A, L=L, y_width=B * L, bias=None)
    views = []
    for y in ys:
        buf = torch.zeros(n * B * L + 1)
        buf[1:] = torch.as_tensor(y).reshape(-1)
        views.append(buf[1:].view(n, B * L))
    assert thm.fwd_variant(L, B * L, [v.data_ptr() for v in views]) \
        == "scalar"
    got = thm.head_mix_fused(torch.as_tensor(w2d), views, H=H, B=B, A=A, L=L)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
