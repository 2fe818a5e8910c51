"""The benchmark's FLOP and byte arithmetic against a count by hand."""

import json
from pathlib import Path

import pytest

from gnnbench.counts import arxiv_net, egc, mag_net

HERE = Path(__file__).resolve().parents[1]


def test_one_egc_layer_by_hand():
    # n 10 rows, e 20 edges, fan-in 4 -> 4 wide, H 2, B 2 (L 2, F 4),
    # symnorm and max (A 2): 4 x (4 + 8) weights
    c = egc.egc_layer(10, 20, 4, 4, 2, 2, ("symnorm", "max"), False, True)
    mm = 3 * 2 * 10 * 4 * 12          # forward, dW, dX
    agg = 2 * (2 + 1) * 20 * 4        # fwd + bwd, (mul, add) + compare
    mix = 6 * 10 * 2 * 2 * 2 * 2      # 2 n H L B A forward, twice back
    assert c["flops"] == mm + agg + mix == 4320
    # fwd: vals 40, rowptr 11, senders 20, weights 20, outputs 2 x 40;
    # bwd: 2 cotangents x 40, the same structure, d_vals 40
    assert c["gather_reduce_bytes"] == 4 * (171 + 171)
    # fwd: w 80, ys 2 x 40, bias 4, z 40; bwd: w, ys, dw, dys, dz
    assert c["headmix_bytes"] == 4 * (204 + 360)


def test_a_step_is_its_layers():
    cfg = json.loads((HERE / "configs" / "egc_m_arxiv.json").read_text())
    n, e, h = 1000, 5000, cfg["net"]["hidden"]
    step = arxiv_net.step_counts(cfg, n, e)
    layer = egc.egc_layer(n, e, h, h, 4, 4, ("symnorm", "max", "mean"),
                          False, True)
    dense = 2 * 2 * n * 128 * h + 3 * 2 * n * h * 40
    assert step["flops"] == pytest.approx(3 * layer["flops"] + dense)
    assert step["gather_reduce_bytes"] == 3 * layer["gather_reduce_bytes"]

    cfg = json.loads((HERE / "configs" / "egc_mag.json").read_text())
    step = mag_net.step_counts(cfg, n, e)
    first = egc.egc_layer(n, e, 128, 352, 8, 4, ("symnorm",), True, False)
    second = egc.egc_layer(n, e, 352, 352, 8, 4, ("symnorm",), True, True)
    assert step["flops"] == pytest.approx(first["flops"] + second["flops"])
    assert step["headmix_bytes"] == first["headmix_bytes"] \
        + second["headmix_bytes"]
