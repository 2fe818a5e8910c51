"""The port's utils (``egc_tpu_torch.utils``) against the checks of the JAX
package's ``tests/test_utils.py``: ``check_finite`` over nested trees of
tensors and arrays, seeding, determinism and the profiler's device op
table (the spans: ``test_torch_port_tracing.py``)."""

import json
import os
import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from egc_tpu import utils as jutils
from egc_tpu_torch import utils as tutils

torch.set_num_threads(2)


@pytest.mark.parametrize("bad", [
    {"a": torch.tensor([1.0, float("nan")])},
    {"b": [torch.ones(2), np.array([np.inf])]},
    {"c": ({"d": torch.ones(3)}, torch.tensor([[0.0, -float("inf")]]))}])
def test_check_finite_names_the_bad_leaf(bad):
    """The error names the same path as the JAX check on the same tree
    (JAX arrays in place of tensors)."""
    def as_jax(tree):
        if isinstance(tree, dict):
            return {k: as_jax(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(as_jax(v) for v in tree)
        return jnp.asarray(np.asarray(tree))

    with pytest.raises(FloatingPointError) as jerr:
        jutils.check_finite(as_jax(bad))
    with pytest.raises(FloatingPointError) as terr:
        tutils.check_finite(bad)
    assert str(terr.value) == str(jerr.value)


def test_check_finite_passes_finite_and_integer_trees():
    tree = {"a": torch.ones(3), "b": [np.arange(4), (torch.zeros(2, 2),)],
            "n": None, "i": torch.tensor([2 ** 31 - 1])}
    assert tutils.check_finite(tree) is tree
    jutils.check_finite({"a": jnp.ones(3)})


def test_seed_all_seeds_python_numpy_and_torch():
    def draws():
        return (random.random(), np.random.rand(), float(torch.rand(())))

    tutils.seed_all(5)
    a = draws()
    tutils.seed_all(5)
    assert draws() == a
    jutils.seed_all(5)
    assert (random.random(), np.random.rand()) == a[:2]


def test_enable_determinism(monkeypatch):
    """Deterministic algorithms on, cuDNN autotuning off, and the cuBLAS
    workspace set (an explicit setting kept); an op without a
    deterministic version then raises on the card only, so a CPU step
    still runs."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.benchmark,
              torch.backends.cudnn.deterministic)
    try:
        tutils.enable_determinism()
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.backends.cudnn.benchmark
        assert torch.backends.cudnn.deterministic
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
        tutils.enable_determinism()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
        x = torch.zeros(4).index_add_(0, torch.tensor([0, 0, 1]),
                                      torch.ones(3))
        assert x.tolist() == [2.0, 1.0, 0.0, 0.0]
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.benchmark = before[1]
        torch.backends.cudnn.deterministic = before[2]


def test_profile_trace_and_op_table(tmp_path):
    """The trace context writes a Chrome trace; on the CPU the device op
    table is empty (no CUDA activity); disabled, it yields no
    profiler."""
    with tutils.profile_trace(tmp_path / "prof") as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert tutils.device_op_table(prof) == []
    with tutils.profile_trace(tmp_path / "off", enabled=False) as off:
        assert off is None
    assert not (tmp_path / "off").exists()
