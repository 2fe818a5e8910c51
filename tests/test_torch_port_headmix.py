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


@pytest.mark.parametrize("L,yw,offsets,with_bias,want", [
    (32, 128, (0, 0, 0), True, "vector"),     # arxiv EGC-M h128
    (32, 128, (0, 0, 0), False, "vector"),
    (8, 32, (0, 0, 0), False, "vector"),      # y_width > B*L
    (44, 176, (0, 0, 0), True, "vector"),     # mag h352 H8
    (34, 136, (0, 0, 0), True, "scalar"),     # L % 4 != 0: EGC-M h136 H4
    (10, 40, (0, 0, 0), False, "scalar"),
    (8, 30, (0, 0, 0), False, "scalar"),      # y_width % 4 != 0
    (32, 128, (1, 0, 0), True, "scalar"),     # a ys 4 bytes off
    (32, 128, (0, 2, 0), False, "scalar"),    # a dy 8 bytes off
    (32, 128, (0, 0, 3), True, "scalar"),     # dz 12 bytes off
])
def test_bwd_variant_rule(L, yw, offsets, with_bias, want):
    """Kernel 4's variant from L, y_width and the alignment of the ys, dy
    and dz pointers (offsets in floats, in that order), on real CPU
    tensors. The bias never reaches kernel 4 (dbias is dz.sum(0) in
    torch), so it cannot move the pick; and where the ys alone decide,
    kernel 3 picks the same."""
    n, H = 6, 4
    ys_off, dy_off, dz_off = offsets

    def view(off, rows, cols):
        return torch.zeros(rows * cols + 4)[off:off + rows * cols].view(
            rows, cols)

    ys = [view(ys_off, n, yw), view(0, n, yw)]
    dys = [view(dy_off, n, yw), view(0, n, yw)]
    dz = view(dz_off, n, H * L)
    ptrs = [t.data_ptr() for t in ys + dys + [dz]]
    assert thm.bwd_variant(L, yw, ptrs) == want
    bias = torch.zeros(H * L) if with_bias else None
    fwd_ptrs = [y.data_ptr() for y in ys] + (
        [bias.data_ptr()] if with_bias else [0])
    if dy_off == 0 and dz_off == 0:
        assert thm.fwd_variant(L, yw, fwd_ptrs) == want


def headmix_bwd_emulated(w2d, ys, dz, H, B, A, L, y_width, V):
    """A torch emulation of kernel 4's order: each base b of a node gets T
    threads (its chunks of V columns rounded up to a power of two, at most
    32), thread j taking the nc chunks l = V (j + T i); a thread's dw
    partial of (h, b, a) is its sum over its columns in order, the T
    partials meet by xor partner at offsets 1, 2, ..., T/2 (every thread
    then holds the same sum), and thread (h' A + a) % T writes entry
    (h, b, a), h' the head's place in its pass of HP = 4 (H <= 4) or 8
    heads. dy sums the heads of a pass in order, a later pass adding into
    the dy the first one wrote. Returns ``(dw, dys, T, owner)``, owner
    [H, A] the writing thread of each base."""
    n = w2d.shape[0]
    chunks = -(-L // V)
    T = 1
    while T < chunks and T < 32:
        T *= 2
    nc = -(-chunks // T)
    HP = 4 if H <= 4 else 8
    w = w2d.reshape(n, H, B, A)
    dz3 = dz.reshape(n, H, L)
    y = torch.stack([t[:, :B * L] for t in ys], 1).reshape(n, A, B, L)
    part = torch.zeros(n, T, H, B, A)
    for j in range(T):
        for i in range(nc):
            l0 = V * (j + T * i)
            if l0 >= L:
                break
            for l in range(l0, l0 + V):
                part[:, j] += (dz3[:, :, l, None, None]
                               * y[:, :, :, l].permute(0, 2, 1)[:, None])
    off = 1
    while off < T:
        part = part + part[:, torch.arange(T) ^ off]
        off *= 2
    assert torch.equal(part, part[:, :1].expand_as(part))
    owner = torch.tensor([[((h % HP) * A + a) % T for a in range(A)]
                          for h in range(H)])
    dw = part.gather(1, owner[None, None, :, None, :].expand(
        n, 1, H, B, A)).reshape(n, H * B * A)
    dy = torch.zeros(n, A, B, L)
    for h0 in range(0, H, HP):
        acc = dy if h0 else torch.zeros(n, A, B, L)
        for h in range(h0, min(H, h0 + HP)):
            acc = acc + (w[:, h].permute(0, 2, 1)[..., None]
                         * dz3[:, h, None, None, :])
        dy = acc
    dys = [torch.cat([dy[:, a].reshape(n, B * L),
                      torch.zeros(n, y_width - B * L)], 1) for a in range(A)]
    return dw, dys, T, owner


@pytest.mark.parametrize("H,B,A,L", [
    (4, 4, 3, 32),      # arxiv EGC-M h128: float4, 8 threads per base
    (4, 4, 3, 34),      # EGC-M h136 H4: scalar, 32 threads, 2 chunks
    (8, 4, 3, 44),      # mag h352 H8: float4, 16 threads, 5 idle
    (4, 4, 6, 32),      # six aggregators
    (1, 1, 1, 4),       # one thread per node
    (12, 2, 2, 8),      # a second pass of heads
])
def test_headmix_bwd_reduction_matches_plain_and_jax(H, B, A, L):
    """Kernel 4's reduction order and dw ownership, emulated in torch,
    against ``headmix_bwd_plain`` and the gradient of the JAX
    ``head_mix_fused`` (Pallas kernels in interpret mode) at rtol = atol =
    1e-5; every dw entry has one writer."""
    n, yw = 24, B * L
    rng = np.random.default_rng(H * 100 + L)
    w2d = rng.normal(size=(n, H * B * A)).astype(np.float32)
    ys = [rng.normal(size=(n, yw)).astype(np.float32) for _ in range(A)]
    dz = rng.normal(size=(n, H * L)).astype(np.float32)
    V = 4 if thm.bwd_variant(L, yw, []) == "vector" else 1
    assert V == (1 if L % 4 else 4)

    tw, tys, tdz = (torch.as_tensor(w2d), [torch.as_tensor(y) for y in ys],
                    torch.as_tensor(dz))
    dw, dys, T, owner = headmix_bwd_emulated(tw, tys, tdz, H, B, A, L, yw,
                                             V)
    # the kernel's store condition, thread by thread, writes each entry
    # of a b once
    HP = 4 if H <= 4 else 8
    writes = [(h, a) for j in range(T) for h in range(H) for a in range(A)
              if ((h % HP) * A + a) % T == j == int(owner[h, a])]
    assert sorted(writes) == [(h, a) for h in range(H) for a in range(A)]
    dw_p, dys_p = thm.headmix_bwd_plain(tw, tys, tdz, H=H, B=B, A=A, L=L,
                                        y_width=yw)
    torch.testing.assert_close(dw, dw_p, rtol=1e-5, atol=1e-5)
    for a in range(A):
        torch.testing.assert_close(dys[a], dys_p[a], rtol=1e-5, atol=1e-5)

    def fj(w, y):
        return jhm.head_mix_fused(w, y, H=H, B=B, A=A, L=L, y_width=yw)

    _, vjp = jax.vjp(fj, jnp.asarray(w2d), tuple(map(jnp.asarray, ys)))
    dw_j, dys_j = vjp(jnp.asarray(dz))
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), rtol=1e-5,
                               atol=1e-5)
    for a in range(A):
        np.testing.assert_allclose(dys[a].numpy(), np.asarray(dys_j[a]),
                                   rtol=1e-5, atol=1e-5)
