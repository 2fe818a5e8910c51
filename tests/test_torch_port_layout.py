"""Layout of the PyTorch port: no JAX at import, device dispatch rules,
and launch counters that stay at 0 on the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "egc_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "egc_tpu")


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def _tiny_raw():
    from egc_tpu_torch.data.synthetic import synthetic_full_graph
    return synthetic_full_graph(num_nodes=120, avg_degree=6, seed=3)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from egc_tpu_torch.device import resolve_device
    from egc_tpu_torch.exp.fullgraph import (
        full_graph_to_device_dict, train_full_graph,
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = _tiny_raw()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_full_graph(raw, steps=1, hidden=16)
    with pytest.raises(RuntimeError):
        full_graph_to_device_dict(raw)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_run_launches_no_kernel():
    from egc_tpu_torch.exp.fullgraph import train_full_graph
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    reset_launch_counts()
    run = train_full_graph(_tiny_raw(), steps=2, hidden=16, device="cpu")
    assert len(run.losses) == 2 and np.all(np.isfinite(run.losses))
    for kind in ("gat", "gatv2"):
        run = train_full_graph(_tiny_raw(), steps=2, kind=kind, hidden=16,
                               heads=4, device="cpu")
        assert len(run.losses) == 2 and np.all(np.isfinite(run.losses))
    assert set(launch_counts()) == {"gather_reduce_fwd", "gather_reduce_bwd",
                                    "headmix_fwd", "headmix_bwd", "gat_fwd",
                                    "gat_bwd_t", "gat_bwd_f", "gatv2_fwd",
                                    "gatv2_bwd_t", "gatv2_bwd_f",
                                    "gatv2w_fwd", "gatv2w_bwd_t",
                                    "gatv2w_bwd_f", "bn_stats", "bn_apply",
                                    "bn_grad_sums", "bn_apply_bwd"}
    assert all(v == 0 for v in launch_counts().values())


def test_kernel_launchers_refuse_cpu_tensors():
    """The plain version serves CPU tensors only through the dispatching
    wrapper; the launchers themselves never run anything but a kernel."""
    from egc_tpu_torch.ops.cuda import gather_reduce as gr
    from egc_tpu_torch.ops.cuda import headmix as hm
    vals = torch.zeros(4, 8)
    ptr = torch.zeros(5, dtype=torch.int32)
    idx = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        gr._launch_fwd(vals, ptr, idx, None, ("sum",), (), None)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        gr._launch_bwd(ptr, idx, c_sum=torch.zeros(4, 8))
    w = torch.zeros(4, 2)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        hm._launch_fwd(w, (torch.zeros(4, 3),), None, 1, 2, 1, 1, 3)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        hm._launch_bwd(w, (torch.zeros(4, 3),), torch.zeros(4, 1),
                       1, 2, 1, 1, 3)


def test_gatv2_launchers_refuse_cpu_tensors():
    from egc_tpu_torch.ops.cuda import attention as at
    hl = torch.zeros(4, 6)
    att = torch.zeros(2, 3)
    z = torch.zeros(4, 2)
    ptr = torch.zeros(5, dtype=torch.int32)
    idx = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        at._launch_v2_fwd(hl, hl, att, ptr, idx)
    for name in ("gatv2_bwd_t", "gatv2_bwd_f"):
        with pytest.raises(RuntimeError, match="CUDA tensor"):
            at._launch_v2_bwd(name, hl, hl, att, z, hl, z, ptr, idx)


def test_gat_kind_builds_single_head_last_layer():
    from egc_tpu_torch.models.nets import ConvSpec
    from egc_tpu_torch.nn.conv.attention import GATConv
    spec = ConvSpec(kind="gat", heads=8)
    convs = [spec.build(152, 152, layer_idx=i, num_layers=3)
             for i in range(3)]
    assert all(isinstance(c, GATConv) for c in convs)
    assert [(c.heads, c.out_channels) for c in convs] == [
        (8, 19), (8, 19), (1, 152)]
    with pytest.raises(ValueError, match="multiple"):
        spec.build(150, 150, layer_idx=0, num_layers=3)


def test_gatv2_kind_builds_single_head_last_layer():
    from egc_tpu_torch.models.nets import ConvSpec
    from egc_tpu_torch.nn.conv.attention import GATv2Conv
    spec = ConvSpec(kind="gatv2", heads=8)
    convs = [spec.build(112, 112, layer_idx=i, num_layers=3)
             for i in range(3)]
    assert all(isinstance(c, GATv2Conv) for c in convs)
    assert [(c.heads, c.out_channels) for c in convs] == [
        (8, 14), (8, 14), (1, 112)]
    assert all(c.lin_r is not c.lin_l for c in convs)
    with pytest.raises(ValueError, match="multiple"):
        spec.build(110, 110, layer_idx=0, num_layers=3)


def test_gatv2conv_on_cuda_tensor_needs_a_plan(monkeypatch):
    """A CUDA tensor without a kernel plan raises instead of falling back
    to the plain path (the device check is all that is faked here)."""
    from egc_tpu_torch.graph.structure import Graph
    from egc_tpu_torch.nn.conv.attention import GATv2Conv
    conv = GATv2Conv(8, 4, heads=2)
    g = Graph.from_coo(np.zeros((5, 8), np.float32), [0, 1], [1, 2])
    x = torch.zeros(5, 8)

    class FakeDevice:
        type = "cuda"

    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return FakeDevice()

    with pytest.raises(RuntimeError, match="kernel plan"):
        conv(g, x.as_subclass(FakeCuda))
