"""Ranks that join from a launcher's environment (``parallel.mesh.
init_mesh_from_env``), the port's counterpart of ``tests/test_multihost.py``.

``python -m egc_tpu_torch.exp.multihost_smoke --device cpu`` starts 2
"hosts" x 2 gloo ranks as OS processes with ``torch.distributed.run``'s
environment (ranks 2 and 3 are local ranks 0 and 1 of the second host);
its psum, DP loss and partitioned loss must equal those of the same steps
on 4 ``spawn`` ranks (``--reference --device cpu``) within 1e-6. Each run
is a subprocess under a 120 s timeout. The unit cases need no group.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from egc_tpu_torch.parallel import mesh as tmesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 120


def _smoke(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-m", "egc_tpu_torch.exp.multihost_smoke", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, res.stdout
    return json.loads(lines[0])


def test_env_joined_ranks_equal_spawned_ranks():
    ref = _smoke("--reference", "--device", "cpu")
    out = _smoke("--device", "cpu")
    assert out["ok"] is True and ref["ok"] is True
    assert out["psum"] == 4.0 and ref["psum"] == 4.0
    assert abs(out["loss"] - ref["loss"]) < 1e-6, (out, ref)
    assert abs(out["ploss"] - ref["ploss"]) < 1e-6, (out, ref)
    assert [(r["rank"], r["local_rank"], r["device"]) for r in
            out["ranks"]] == [(0, 0, "cpu"), (1, 1, "cpu"), (2, 0, "cpu"),
                              (3, 1, "cpu")]


def _env(**over):
    env = {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
           "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "10.0.0.1",
           "MASTER_PORT": "29500"}
    env.update(over)
    return {k: v for k, v in env.items() if v is not None}


@pytest.mark.parametrize("name", tmesh.LAUNCHER_ENV)
def test_a_missing_variable_raises_and_names_it(name, monkeypatch):
    with pytest.raises(ValueError, match=name):
        tmesh.launcher_env(_env(**{name: None}))
    for k, v in _env(**{name: None}).items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match=name):     # before any rendezvous
        tmesh.init_mesh_from_env("cpu")


def test_inconsistent_counts_raise():
    with pytest.raises(ValueError, match="inconsistent"):
        tmesh.launcher_env(_env(RANK="4"))
    with pytest.raises(ValueError, match="inconsistent"):
        tmesh.launcher_env(_env(LOCAL_RANK="2"))
    with pytest.raises(ValueError, match="inconsistent"):
        tmesh.launcher_env(_env(LOCAL_WORLD_SIZE="5"))


def test_the_card_is_the_local_rank(monkeypatch):
    """Rank 3 of 4, local rank 1 of its host's 2: ``cuda:1``, not
    ``cuda:3``; on the CPU the device stays the CPU."""
    monkeypatch.setattr(tmesh, "device_count", lambda: 2)
    rank, world, dev = tmesh.env_rank("cuda", _env())
    assert (rank, world) == (3, 4)
    assert dev == torch.device("cuda", 1)
    assert tmesh.env_rank("cpu", _env())[2] == torch.device("cpu")


def test_the_card_count_holds_the_local_world_size(monkeypatch):
    """Two cards a host take 2 local ranks of a world of 4 or 8; 3 local
    ranks on that host raise. ``init_mesh`` (``spawn``'s ranks, all on
    one host) still holds the world size."""
    monkeypatch.setattr(tmesh, "device_count", lambda: 2)
    assert tmesh.env_rank("cuda", _env(RANK="7", WORLD_SIZE="8"))[2] == \
        torch.device("cuda", 1)
    with pytest.raises(ValueError, match="3 ranks need 3 CUDA cards"):
        tmesh.env_rank("cuda", _env(LOCAL_WORLD_SIZE="3"))
    with pytest.raises(ValueError, match="4 ranks need 4 CUDA cards"):
        tmesh.init_mesh(3, 4, device="cuda", init_method="env://")


def test_multihost_smoke_imports_no_jax():
    code = ("import sys, egc_tpu_torch.exp.multihost_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'egc_tpu')]\n"
            "sys.exit(f'imported {bad}' if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stdout + res.stderr
