"""Ranks that join from a launcher's environment, across hosts (counterpart
of ``scripts/multihost_smoke.py``).

    python -m egc_tpu_torch.exp.multihost_smoke [--device cpu|cuda]
    python -m egc_tpu_torch.exp.multihost_smoke --worker [--device ...]
    python -m egc_tpu_torch.exp.multihost_smoke --reference [--world N]

Every rank joins one process group and runs, on the same seeded data:

(a) a sum all-reduce of ones over the world;
(b) one data-parallel step of ``ZincNet`` h16, 2 layers, EGC H2 B2
    symnorm with softmax weighting, sync-BN, on
    ``synthetic_zinc(num_graphs=4 * world)``: rank r takes microbatch r
    (graphs 2r and 2r + 1), the global mean L1 loss;
(c) one graph-partitioned ``ArxivNet`` step: h16, 2 layers, EGC H2 B2
    symnorm/max, dropout 0, on ``synthetic_full_graph(num_nodes=240,
    avg_degree=6, num_classes=4, num_features=8, seed=7)``, a BFS
    partition over the world, the halo all-to-all, sync-BN and the
    gradient all-reduce.

The weights come from seeded generators on every rank; each step first
holds every rank's initial weights equal to rank 0's, bit for bit. On the
card the steps run with torch's deterministic algorithms (the readout's
``index_add`` otherwise sums by atomics, in another order each run), so
two runs agree to the bit and can be held at 1e-6.

Modes:

- default: a launcher that starts ``HOSTS`` (2) x ``LOCAL`` (2) ranks
  as OS processes on this machine with the environment that
  ``torch.distributed.run`` gives them (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``
  on a free port), so ranks 2 and 3 are local ranks 0 and 1 of the
  second host. With ``--device cuda`` each host sees its own ``LOCAL``
  cards (``CUDA_VISIBLE_DEVICES``), so it needs 4 cards.
- ``--worker``: one rank under any launcher that set that environment
  (``parallel.mesh.init_mesh_from_env``), for example ``torchrun`` on
  each of several hosts::

      torchrun --nnodes 2 --nproc-per-node 4 --node-rank K \\
          --master-addr HOST0 --master-port 29500 \\
          -m egc_tpu_torch.exp.multihost_smoke --worker

- ``--reference``: the same steps on ``--world`` ranks (default 4) that
  ``parallel.mesh.spawn`` starts on this host: the numbers the
  env-joined ranks must reproduce.

Rank 0 prints one JSON line: ``ok``, ``loss`` (b), ``ploss`` (c),
``psum`` (a), and ``world`` and ``ranks`` (each rank's ``rank``,
``local_rank`` and device). ``--device`` defaults to the card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import List

import numpy as np
import torch
import torch.distributed as dist

HOSTS, LOCAL = 2, 2
TIMEOUT_S = 600
HIDDEN, LAYERS, HEADS, BASES = 16, 2, 2, 2
ZINC_BUDGET = dict(num_nodes=80, num_edges=256, num_graphs=3)
GRAPH = dict(num_nodes=240, avg_degree=6, num_classes=4, num_features=8,
             seed=7)


def _same_on_every_rank(model: torch.nn.Module, label: str) -> None:
    """Raise unless every rank holds rank 0's ``model`` state, bitwise."""
    flat = torch.cat([v.detach().reshape(-1).double()
                      for v in model.state_dict().values()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    same = torch.tensor([float(torch.equal(flat, ref))], device=flat.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    if same.item() != 1.0:
        raise RuntimeError(f"{label}: a rank starts from other weights "
                           "than rank 0")


def psum_step(mesh) -> float:
    ones = torch.ones(1, device=mesh.device)
    dist.all_reduce(ones)
    return float(ones.item())


def dp_step(mesh) -> float:
    """(b): the global mean L1 loss of one DP step."""
    from egc_tpu_torch.data.synthetic import synthetic_zinc
    from egc_tpu_torch.graph.structure import batch_np
    from egc_tpu_torch.models.nets import ConvSpec, ZincNet
    from egc_tpu_torch.ops.dispatch import build_kernel_plan
    from egc_tpu_torch.parallel.dp import make_dp_train_step
    from egc_tpu_torch.train.optim import make_optimizer

    world, r, dev = mesh.world_size, mesh.rank, mesh.device
    graphs = synthetic_zinc(num_graphs=4 * world)["train"][:2 * world]
    g, y = batch_np(graphs[2 * r:2 * r + 2], **ZINC_BUDGET)
    if dev.type == "cuda":
        g = g.replace(kernel_plan=build_kernel_plan(
            g.senders.numpy(), g.receivers.numpy(), g.num_nodes,
            edge_mask=g.edge_mask.numpy()))
    g, y = g.to(dev), torch.from_numpy(y).to(dev)
    conv = ConvSpec(kind="egc", heads=HEADS, bases=BASES,
                    aggrs=("symnorm",), softmax=True)
    net = ZincNet(conv, HIDDEN, num_layers=LAYERS,
                  generator=torch.Generator().manual_seed(1)).to(dev)
    _same_on_every_rank(net, "dp")

    def loss_sum(out, y_, graph):
        m = graph.graph_mask.to(out.dtype)
        err = (out.reshape(-1) - y_.reshape(-1).to(out.dtype)).abs()
        return (err * m).sum(), m.sum()

    step = make_dp_train_step(net, loss_sum, mesh.group)
    return float(step(make_optimizer(net.parameters(), 1e-3, 1e-4), g, y))


def partitioned_step(mesh) -> float:
    """(c): the global mean NLL of one graph-partitioned step."""
    from egc_tpu_torch.data.synthetic import synthetic_full_graph
    from egc_tpu_torch.graph.transforms import symnorm_weight
    from egc_tpu_torch.models.nets import ConvSpec
    from egc_tpu_torch.parallel.halo import (
        DistributedNodeClassifier, partitioned_train_step,
    )
    from egc_tpu_torch.parallel.partition import partition_graph
    from egc_tpu_torch.train.optim import make_optimizer

    r, dev = mesh.rank, mesh.device
    raw = synthetic_full_graph(**GRAPH)
    n, f = raw["x"].shape
    ew, sw = symnorm_weight(torch.as_tensor(raw["senders"]),
                            torch.as_tensor(raw["receivers"]), n)
    plan = partition_graph(raw["senders"], raw["receivers"], n,
                           mesh.world_size, method="bfs",
                           sym_edge_w=ew.numpy(), sym_self_w=sw.numpy())
    x_ext = np.zeros((plan.n_ext, f), np.float32)
    x_ext[:plan.n_local] = plan.scatter_nodes(raw["x"])[r]
    kplan = plan.build_kernel_plan(r) if dev.type == "cuda" else None
    g = plan.extended_graph(r, x_ext, kplan).to(dev)
    tmask = np.zeros(n, bool)
    tmask[raw["train_idx"]] = True
    y = torch.from_numpy(plan.scatter_nodes(
        np.asarray(raw["y"], np.int64))[r]).to(dev)
    tm = torch.from_numpy(plan.scatter_nodes(tmask)[r]).to(dev)
    conv = ConvSpec(kind="egc", heads=HEADS, bases=BASES,
                    aggrs=("symnorm", "max"))
    net = DistributedNodeClassifier(
        conv, HIDDEN, num_layers=LAYERS, dropout=0.0, num_features=f,
        num_classes=GRAPH["num_classes"], e_interior=plan.e_interior,
        group=mesh.group, generator=torch.Generator().manual_seed(1)
    ).to(dev)
    _same_on_every_rank(net, "partitioned")
    return float(partitioned_train_step(
        net, make_optimizer(net.parameters(), 1e-3, 0.0), g,
        torch.from_numpy(plan.send_idx[r]).to(dev), y, tm))


def run_steps(mesh, local_rank: int) -> dict:
    """(a), (b) and (c) on this rank; every rank returns the result."""
    if mesh.device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False
    psum = psum_step(mesh)
    loss = dp_step(mesh)
    ploss = partitioned_step(mesh)
    ranks: List[dict] = [None] * mesh.world_size
    dist.all_gather_object(ranks, {"rank": mesh.rank,
                                   "local_rank": local_rank,
                                   "device": str(mesh.device)})
    return {"ok": bool(math.isfinite(loss) and math.isfinite(ploss)
                       and psum == mesh.world_size),
            "loss": loss, "ploss": ploss, "psum": psum,
            "world": mesh.world_size, "ranks": ranks}


def _spawned_rank(mesh):
    return run_steps(mesh, mesh.rank)


def worker(device: str) -> dict:
    """One rank of a group whose launcher set the environment."""
    from egc_tpu_torch.parallel.mesh import init_mesh_from_env
    mesh = init_mesh_from_env(device)
    try:
        out = run_steps(mesh, int(os.environ["LOCAL_RANK"]))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def reference(world: int, device: str) -> dict:
    """The same steps on ``world`` ranks that ``spawn`` starts."""
    from egc_tpu_torch.parallel.mesh import spawn
    return spawn(_spawned_rank, world, device=device, timeout=TIMEOUT_S)[0]


def launch(device: str) -> int:
    """Start ``HOSTS`` x ``LOCAL`` worker processes with the environment
    ``torch.distributed.run`` gives them; rank 0's output passes through.
    Returns the first nonzero exit code (every rank stopped), else 0."""
    from egc_tpu_torch.parallel.mesh import device_count, free_port
    world = HOSTS * LOCAL
    if device == "cuda" and device_count() < world:
        print(f"multihost_smoke: {HOSTS} hosts x {LOCAL} ranks on the "
              f"card need {world} cards, {device_count()} visible",
              file=sys.stderr)
        return 2
    base = dict(os.environ, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
                LOCAL_WORLD_SIZE=str(LOCAL))
    if device == "cpu":
        base.setdefault("OMP_NUM_THREADS",
                        str(max(1, (os.cpu_count() or 1) // world)))
    cards = (os.environ.get("CUDA_VISIBLE_DEVICES")
             or ",".join(map(str, range(device_count())))).split(",")
    procs = []
    for rank in range(world):
        host = rank // LOCAL
        env = dict(base, RANK=str(rank), LOCAL_RANK=str(rank % LOCAL))
        if device == "cuda":     # each host sees its own cards
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                cards[host * LOCAL:(host + 1) * LOCAL])
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "egc_tpu_torch.exp.multihost_smoke",
             "--worker", "--device", device], env=env,
            stdout=None if rank == 0 else subprocess.DEVNULL))
    deadline = time.monotonic() + TIMEOUT_S
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            bad = [p.returncode for p in procs if p.returncode]
            if bad or time.monotonic() > deadline:
                rc = bad[0] if bad else 124
                break
            time.sleep(0.2)
        else:
            rc = next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--worker", action="store_true")
    mode.add_argument("--reference", action="store_true")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--world", type=int, default=HOSTS * LOCAL,
                    help="--reference's ranks")
    args = ap.parse_args(argv)
    if not (args.worker or args.reference):
        return launch(args.device)
    if args.worker:
        out = worker(args.device)
        if os.environ["RANK"] != "0":
            return 0 if out["ok"] else 1
    else:
        out = reference(args.world, args.device)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
