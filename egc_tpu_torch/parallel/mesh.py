"""Process groups for the distributed paths (counterpart of
``egc_tpu.parallel.mesh``).

The JAX package runs P partitions in one process, on a mesh of P devices
(``shard_map`` over a named axis). Here a partition is a process: one
rank per card under NCCL, or ranks on the CPU under gloo, in one
``torch.distributed`` process group. The backend follows the device and
is never swapped behind the caller's back.

- ``init_mesh`` joins a rendezvous and returns the rank's ``Mesh``:
  rank, world size, its device (``cuda:<rank>``, or the CPU) and the
  backend.
- ``spawn`` starts ``world_size`` ranks from one process (``spawn``, never
  ``fork``), runs ``fn(mesh, *args)`` on each and returns their results in
  rank order. A rank that raises, dies or outlives ``timeout`` makes it
  raise, after the others are stopped. Its ranks all sit on one host.
- ``init_mesh_from_env`` joins the group that a launcher started, on one
  host or several (``torch.distributed.run``, or any launcher that sets
  its variables): the counterpart of an argument-less
  ``jax.distributed.initialize()``. The rank's card is
  ``cuda:LOCAL_RANK``, and the card count is held against the host's
  ``LOCAL_WORLD_SIZE`` ranks, not the world's.
- ``all_to_all`` is the differentiable collective: an all-to-all of
  equal chunks is its own transpose. It can be issued asynchronously: it
  returns at once and the caller waits on the handle it appended before
  reading the result.

Asking for more CUDA ranks on a host than it has visible cards raises,
as ``make_mesh`` does (``egc_tpu/parallel/mesh.py:29-33``).
"""

from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def device_count() -> int:
    """Visible CUDA cards."""
    return torch.cuda.device_count()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the process group (the ``graph`` or ``data``
    axis of the JAX mesh)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str

    @property
    def group(self):
        return dist.group.WORLD


def check_world_size(world_size: int, device) -> None:
    """Raise unless ``world_size`` ranks fit on this host's ``device``
    kind: one card a rank under CUDA."""
    if world_size < 1:
        raise ValueError(f"world size must be at least 1, got {world_size}")
    if torch.device(device).type == "cuda" and world_size > device_count():
        raise ValueError(
            f"{world_size} ranks need {world_size} CUDA cards, "
            f"{device_count()} visible (one rank a card; NCCL takes no "
            "two ranks on one card)")


def rank_device(device, local_rank: int) -> torch.device:
    """The device of the rank that is ``local_rank`` on its host:
    ``cuda:<local_rank>`` for a CUDA ``device``, else ``device``."""
    dev = torch.device(device)
    return torch.device("cuda", local_rank) if dev.type == "cuda" else dev


def _join(rank: int, world_size: int, dev: torch.device, init_method: str
          ) -> Mesh:
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend, extra = "nccl", {"device_id": dev}
    elif dev.type == "cpu":
        backend, extra = "gloo", {}
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **extra)
    return Mesh(rank, world_size, dev, backend)


def init_mesh(rank: int, world_size: int, *, device, init_method: str
              ) -> Mesh:
    """Join the process group at ``init_method`` as ``rank``: NCCL on
    ``cuda:<rank>`` for a CUDA ``device``, gloo for the CPU. Every rank
    is on this host (``spawn``'s)."""
    check_world_size(world_size, device)
    return _join(rank, world_size, rank_device(device, rank), init_method)


LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT")


def launcher_env(environ=None) -> dict:
    """The rendezvous variables that ``torch.distributed.run`` sets for a
    rank (``LAUNCHER_ENV``), the four counts as ints. Raises, naming
    them, if any is missing, or if the counts do not describe a rank of
    the world and of its host."""
    environ = os.environ if environ is None else environ
    missing = [k for k in LAUNCHER_ENV if not environ.get(k)]
    if missing:
        raise ValueError(
            f"joining from the launcher's environment needs "
            f"{', '.join(missing)} set (torch.distributed.run sets "
            f"{', '.join(LAUNCHER_ENV)})")
    env = {k: environ[k] for k in LAUNCHER_ENV}
    for k in LAUNCHER_ENV[:4]:
        env[k] = int(env[k])
    if not (0 <= env["RANK"] < env["WORLD_SIZE"]
            and 0 <= env["LOCAL_RANK"] < env["LOCAL_WORLD_SIZE"]
            <= env["WORLD_SIZE"]):
        raise ValueError(f"inconsistent launcher environment {env}")
    return env


def env_rank(device, environ=None) -> tuple:
    """``(rank, world_size, device)`` of the rank that the launcher's
    environment describes, its card ``cuda:LOCAL_RANK``, after holding
    the host's ``LOCAL_WORLD_SIZE`` ranks against its visible cards."""
    env = launcher_env(environ)
    check_world_size(env["LOCAL_WORLD_SIZE"], device)
    return (env["RANK"], env["WORLD_SIZE"],
            rank_device(device, env["LOCAL_RANK"]))


def init_mesh_from_env(device) -> Mesh:
    """Join the group a launcher started (``init_method="env://"``, from
    ``MASTER_ADDR`` and ``MASTER_PORT``) as ``RANK`` of ``WORLD_SIZE``,
    on ``cuda:LOCAL_RANK`` under NCCL for a CUDA ``device``, or under gloo
    on the CPU. A missing variable raises; nothing falls back to
    ``spawn``, to one process or to the CPU."""
    rank, world_size, dev = env_rank(device)
    return _join(rank, world_size, dev, "env://")


def free_port() -> int:
    """A free TCP port on localhost for the rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, world_size, device, init_method, args, results):
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // world_size))
        mesh = init_mesh(rank, world_size, device=device,
                         init_method=init_method)
        try:
            out = fn(mesh, *args)
            dist.barrier()    # no rank tears down while another still talks
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def spawn(fn: Callable, world_size: int, *, device,
          args: Sequence[Any] = (), timeout: Optional[float] = None
          ) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world_size`` fresh ranks (spawned; the
    rendezvous on a free localhost port) and return their results in rank
    order. ``fn``, ``args`` and the results are pickled: ``fn`` must be
    importable. Raises, with the rank's traceback, if a rank raises, exits
    nonzero or has not delivered within ``timeout`` seconds; every rank is
    stopped before it returns or raises."""
    import multiprocessing

    check_world_size(world_size, device)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world_size, str(device), init_method,
                               tuple(args), results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got, failed = {}, {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while len(got) < world_size and not failed:
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue_mod.Empty:
                for r, p in enumerate(procs):
                    if r not in got and p.exitcode not in (None, 0):
                        failed[r] = f"exited with code {p.exitcode}"
                if deadline is not None and time.monotonic() > deadline:
                    failed.update({r: f"no result within {timeout} s"
                                   for r in range(world_size)
                                   if r not in got})
                continue
            (got if ok else failed)[rank] = payload
        while failed:      # the failing ranks' tracebacks, if they came
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                break
            if not ok:
                failed[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=0 if failed else 60)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    for r, p in enumerate(procs):
        if p.exitcode != 0 and r not in failed:
            failed[r] = f"exited with code {p.exitcode}"
    if failed:
        raise RuntimeError("rank(s) failed:\n" + "\n".join(
            f"[rank {r}] {msg}" for r, msg in sorted(failed.items())))
    return [got[r] for r in range(world_size)]


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pending):
        ctx.group = group
        out = torch.empty_like(x)
        work = dist.all_to_all_single(out, x, group=group,
                                      async_op=pending is not None)
        if pending is not None:
            pending.append(work)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad)
        dist.all_to_all_single(out, grad.contiguous(), group=ctx.group)
        return out, None, None


def all_to_all(x: torch.Tensor, group=None,
               pending: Optional[list] = None) -> torch.Tensor:
    """``x [P * H, ...]``: chunk q (rows q*H .. q*H + H) goes to rank q,
    and chunk q of the result came from rank q (``jax.lax.all_to_all``
    with split and concat axis 0). With ``pending`` (a list) the exchange
    is issued asynchronously and its handle appended: ``wait()`` on it
    before reading the result. Differentiable: the backward is the
    reverse exchange of the cotangent."""
    return _AllToAll.apply(x.contiguous(), group, pending)
