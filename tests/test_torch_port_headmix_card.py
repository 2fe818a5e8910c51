"""The head-mix kernels 3 and 4 on the card (``ops/cuda/headmix``,
``csrc/headmix.cu``): the tile variant, which takes every shape whose L or
y_width is not a multiple of 4 or whose pointers are not 16-byte aligned,
against the plain versions at rtol = atol = 1e-5, two launches bitwise, dy's
tail columns zero, its launch counters, and its plan against the
library's; the float4 variant at the cells' L 32, 44 and 16 as it was. No
JAX here, so that the tests marked ``card`` run on the chip:
``python -m pytest tests/test_torch_port_headmix_card.py --noconftest -m
card``."""

import pytest
import torch

from egc_tpu_torch.ops.cuda import headmix as hm
from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

TOL = dict(rtol=1e-5, atol=1e-5)
COUNTERS = ("headmix_fwd", "headmix_bwd", "headmix_fwd_tile",
            "headmix_bwd_tile")

# (H, B, A, L, y_width, rows, float offset of every input and output view)
TILE_CASES = [
    (4, 4, 3, 34, 136, 169_343, 0),   # arxiv EGC-M h136 at ogbn-arxiv's rows
    (4, 4, 3, 34, 136, 5_000, 1),     # views 4 bytes off 16-byte alignment
    (1, 1, 1, 3, 5, 1_000, 0),        # L 3, a 2-column tail
    (12, 2, 2, 6, 14, 1_000, 0),      # H 12, a 2-column tail
    (4, 4, 3, 32, 128, 1_000, 2),     # L 32 taken off the float4 variant
    (1, 1, 8, 3_500, 3_500, 5, 1),    # a node past one block's shared memory
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _view(rows, cols, off, dev, gen, scale=1.0):
    buf = torch.randn(rows * cols + 4, generator=gen, device=dev) * scale
    return buf[off:off + rows * cols].view(rows, cols)


def _inputs(H, B, A, L, yw, n, off, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    w2d = _view(n, H * B * A, off, dev, gen)
    # ys scaled so that dw's sums over L stay of order 1 at any L
    ys = [_view(n, yw, off, dev, gen, scale=L ** -0.5) for _ in range(A)]
    bias = _view(1, H * L, off, dev, gen).reshape(H * L)
    dz = _view(n, H * L, off, dev, gen)
    return w2d, ys, bias, dz


@pytest.mark.card
@pytest.mark.parametrize("H,B,A,L,yw,n,off", TILE_CASES)
def test_tile_variant(card, H, B, A, L, yw, n, off):
    w2d, ys, bias, dz = _inputs(H, B, A, L, yw, n, off, card)
    kw = dict(H=H, B=B, A=A, L=L)
    reset_launch_counts()
    z = hm.headmix_fwd(w2d, ys, bias, y_width=yw, **kw)
    dw, dys = hm.headmix_bwd(w2d, ys, dz, y_width=yw, **kw)
    torch.cuda.synchronize()
    assert {k: launch_counts()[k] for k in COUNTERS} == dict.fromkeys(
        COUNTERS, 1)
    ptrs_f = [y.data_ptr() for y in ys] + [bias.data_ptr()]
    ptrs_b = [t.data_ptr() for t in (*ys, *dys, dz)]
    assert hm.fwd_variant(L, yw, ptrs_f) == "tile"
    assert hm.kernel_fwd_variant(ys, bias, L, yw) == "tile"
    assert hm.bwd_variant(L, yw, ptrs_b) == "tile"
    assert hm.kernel_bwd_variant(ys, dys, dz, L, yw) == "tile"
    torch.testing.assert_close(z, hm.headmix_fwd_plain(w2d, ys, bias, **kw),
                               **TOL)
    dw_p, dys_p = hm.headmix_bwd_plain(w2d, ys, dz, y_width=yw, **kw)
    torch.testing.assert_close(dw, dw_p, **TOL)
    for d, p in zip(dys, dys_p):
        torch.testing.assert_close(d, p, **TOL)
        assert bool((d[:, B * L:] == 0).all())
    assert torch.equal(z, hm.headmix_fwd(w2d, ys, bias, y_width=yw, **kw))
    dw2, dys2 = hm.headmix_bwd(w2d, ys, dz, y_width=yw, **kw)
    assert torch.equal(dw, dw2)
    assert all(torch.equal(a, b) for a, b in zip(dys, dys2))


@pytest.mark.card
def test_tile_without_bias(card):
    """No bias, y_width past B*L at L 34, every view 12 bytes off."""
    H, B, A, L, yw, n, off = 4, 4, 3, 34, 140, 1_001, 3
    w2d, ys, _, dz = _inputs(H, B, A, L, yw, n, off, card)
    kw = dict(H=H, B=B, A=A, L=L)
    assert hm.kernel_fwd_variant(ys, None, L, yw) == "tile"
    torch.testing.assert_close(hm.headmix_fwd(w2d, ys, None, y_width=yw, **kw),
                               hm.headmix_fwd_plain(w2d, ys, None, **kw), **TOL)
    dw, dys = hm.headmix_bwd(w2d, ys, dz, y_width=yw, **kw)
    dw_p, dys_p = hm.headmix_bwd_plain(w2d, ys, dz, y_width=yw, **kw)
    torch.testing.assert_close(dw, dw_p, **TOL)
    for d, p in zip(dys, dys_p):
        torch.testing.assert_close(d, p, **TOL)


@pytest.mark.card
@pytest.mark.parametrize("shape", [(4, 4, 3, 34, 136), (1, 1, 1, 3, 5),
                                   (12, 2, 2, 6, 14), (4, 4, 6, 10, 40),
                                   (8, 4, 1, 44, 176), (1, 1, 8, 3_500, 3_500),
                                   (4, 4, 3, 75, 300)])
def test_tile_plan_matches_the_library(card, shape):
    for bwd in (False, True):
        assert hm.kernel_tile_plan(bwd, *shape) == hm.tile_plan(bwd, *shape)


@pytest.mark.card
@pytest.mark.parametrize("H,B,A,L", [(4, 4, 3, 32), (8, 4, 1, 44),
                                     (4, 4, 1, 16)])
def test_float4_variant_at_the_cells_widths(card, H, B, A, L):
    """arxiv h128, mag and rmag keep the float4 variant: no tile launch,
    the plain values, two launches bitwise."""
    yw, n = B * L, 20_000
    w2d, ys, bias, dz = _inputs(H, B, A, L, yw, n, 0, card)
    kw = dict(H=H, B=B, A=A, L=L)
    reset_launch_counts()
    z = hm.headmix_fwd(w2d, ys, bias, y_width=yw, **kw)
    dw, dys = hm.headmix_bwd(w2d, ys, dz, y_width=yw, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["headmix_fwd"], counts["headmix_bwd"]) == (1, 1)
    assert counts["headmix_fwd_tile"] == counts["headmix_bwd_tile"] == 0
    assert hm.kernel_fwd_variant(ys, bias, L, yw) == "vector"
    assert hm.kernel_bwd_variant(ys, dys, dz, L, yw) == "vector"
    torch.testing.assert_close(z, hm.headmix_fwd_plain(w2d, ys, bias, **kw),
                               **TOL)
    dw_p, dys_p = hm.headmix_bwd_plain(w2d, ys, dz, y_width=yw, **kw)
    torch.testing.assert_close(dw, dw_p, **TOL)
    for d, p in zip(dys, dys_p):
        torch.testing.assert_close(d, p, **TOL)
    assert torch.equal(z, hm.headmix_fwd(w2d, ys, bias, y_width=yw, **kw))
    dw2, dys2 = hm.headmix_bwd(w2d, ys, dz, y_width=yw, **kw)
    assert torch.equal(dw, dw2)
    assert all(torch.equal(a, b) for a, b in zip(dys, dys2))


@pytest.mark.card
def test_tile_z_and_dy_have_the_float4_bits(card):
    """The same values at L 32, aligned (float4 variant) and 4 bytes off
    (tile variant): z and dy add in the same order, so agree bitwise; dw
    sums in another order and agrees at 1e-5."""
    H, B, A, L, n = 4, 4, 3, 32, 4_000
    yw = B * L
    w2d, ys, bias, dz = _inputs(H, B, A, L, yw, n, 0, card)
    gen = torch.Generator(device=card).manual_seed(1)

    def shifted(t):
        v = _view(t.shape[0], t.shape[1], 1, card, gen)
        v.copy_(t)
        return v

    ys_off = [shifted(y) for y in ys]
    kw = dict(H=H, B=B, A=A, L=L, y_width=yw)
    assert hm.kernel_fwd_variant(ys, bias, L, yw) == "vector"
    assert hm.kernel_fwd_variant(ys_off, bias, L, yw) == "tile"
    assert torch.equal(hm.headmix_fwd(w2d, ys, bias, **kw),
                       hm.headmix_fwd(w2d, ys_off, bias, **kw))
    dw, dys = hm.headmix_bwd(w2d, ys, dz, **kw)
    dw_t, dys_t = hm.headmix_bwd(w2d, ys_off, dz, **kw)
    assert hm.kernel_bwd_variant(ys_off, dys_t, dz, L, yw) == "tile"
    assert all(torch.equal(a, b) for a, b in zip(dys, dys_t))
    torch.testing.assert_close(dw_t, dw, **TOL)
