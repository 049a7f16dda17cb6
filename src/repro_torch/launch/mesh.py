"""Client meshes over ``torch.distributed``: the twin of ``repro.launch.mesh``.

The JAX package lays clients onto a device mesh and reduces with
``lax.psum`` over named axes inside ``shard_map``.  Here every client is a
process (a rank), and each named axis is a tier of process groups: the
ranks that differ only along that axis.  Clients map to ranks in row-major
order over the axes, as ``jax.make_mesh((2, 2), ("pod", "data"))`` lays
out its devices: rank = pod * data_size + data.

``make_client_mesh(axes)`` builds the groups over an initialized default
process group, whatever its backend: the caller chooses the backend
(NCCL across cards, gloo where several ranks share one card or run on the
CPU).  ``run_local_mesh`` starts ``pod * data`` ranks on this host, joins
them through a ``FileStore`` in a temporary directory (no TCP port, so
parallel test workers cannot collide), and returns each rank's result.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.utils.device import resolve_device


@dataclass(frozen=True)
class ClientMesh:
    """One rank's view of the client mesh.

    ``axes``: ((name, size), ...) outer -> inner, whose sizes multiply to
    the world size; ``rank``: this process's rank (= its client index);
    ``groups``: {axis name: the process group of the ranks that differ from
    this one only along that axis}."""

    axes: tuple
    rank: int
    groups: dict = field(default_factory=dict, compare=False)

    @property
    def size(self) -> int:
        return math.prod(size for _, size in self.axes)

    @property
    def coords(self) -> dict[str, int]:
        """This rank's index along every axis (row-major)."""
        out, rest = {}, self.rank
        for name, size in reversed(self.axes):
            out[name] = rest % size
            rest //= size
        return dict(reversed(list(out.items())))

    def tier_groups(self, client_axes) -> tuple:
        """The process groups of ``client_axes``, in their order (outer ->
        inner); reducers walk them reversed, inner tier first.  Raises
        ``ValueError`` for an axis not on the mesh (``collective_tiers``)."""
        return tuple(self.groups[a] for a, _ in collective_tiers(self, client_axes))


def make_client_mesh(axes, *, timeout_s: float = 300.0) -> ClientMesh:
    """Build this rank's ``ClientMesh`` over the initialized default group.

    Every rank must call it with the same ``axes``: ``dist.new_group`` is a
    collective call, made here for every group of every axis in one order."""
    axes = tuple((str(name), int(size)) for name, size in axes)
    shape = tuple(size for _, size in axes)
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {axes} has {math.prod(shape)} ranks, the world has {world}")
    grid = torch.arange(world).reshape(shape)
    timeout = datetime.timedelta(seconds=timeout_s)
    groups = {}
    for i, (name, size) in enumerate(axes):
        lines = grid.movedim(i, -1).reshape(-1, size)
        for line in lines.tolist():
            group = dist.new_group(ranks=line, timeout=timeout)
            if rank in line:
                groups[name] = group
    return ClientMesh(axes=axes, rank=rank, groups=groups)


def mesh_info(mesh: ClientMesh) -> dict:
    return {"axes": dict(mesh.axes), "n_devices": mesh.size}


def collective_tiers(mesh: ClientMesh, client_axes) -> tuple:
    """The tiers of the round step's all-reduce on a concrete mesh: the
    client axes it reduces over, outer -> inner, with their sizes (the JAX
    package's ``CostModel.mesh_tiers``)."""
    sizes = dict(mesh.axes)
    missing = [a for a in client_axes if a not in sizes]
    if missing:
        raise ValueError(f"client axes {missing} not on mesh axes {tuple(sizes)}")
    return tuple((a, int(sizes[a])) for a in client_axes)


def _rank_main(rank, world, store_path, backend, device, axes, fn, args, timeout_s, results):
    """One rank of ``run_local_mesh``: join, build the mesh, run ``fn``,
    send back its pickled result or the traceback."""
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        try:
            mesh = make_client_mesh(axes, timeout_s=timeout_s)
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except Exception:  # the rank's boundary: report, and let the parent raise
        results.put((rank, False, traceback.format_exc()))


def run_local_mesh(fn: Callable, *, pod: int, data: int, backend: str, device=None,
                   args: tuple = (), timeout_s: float = 300.0) -> list[Any]:
    """Run ``fn(mesh, *args)`` on ``pod * data`` ranks of a
    ``(("pod", pod), ("data", data))`` mesh on this host; return the
    results in rank order.

    ``fn`` and ``args`` are pickled to the ranks (``fn`` by import path),
    and each result comes back pickled: return host data.  ``backend`` is
    the caller's choice ("gloo" or "nccl").  ``device=None`` means the
    card, as everywhere in the package, and raises here without one; on
    the card rank r uses card ``r % device_count``, and ``device="cpu"``
    asks for CPU ranks.  The ranks start with ``spawn`` (CUDA
    cannot fork).  Every process group and the wait for the results are
    bounded by ``timeout_s``: a rank that fails or hangs raises here, and
    every rank still running is stopped."""
    device = resolve_device(device).type
    world = pod * data
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    axes = (("pod", pod), ("data", data))
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(r, world, os.path.join(tmp, "store"), backend, device, axes, fn, args,
                  timeout_s, results),
            daemon=True,
        )
        for r in range(world)
    ]
    try:
        for p in procs:
            p.start()
        got: dict[int, Any] = {}
        deadline = time.monotonic() + timeout_s
        while len(got) < world:
            try:
                rank, ok, payload = results.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise TimeoutError(
                    f"run_local_mesh: {world - len(got)} of {world} ranks gave no result "
                    f"within {timeout_s} s"
                ) from None
            if not ok:  # the others may wait on the failed rank: ``finally`` stops them
                raise RuntimeError(f"run_local_mesh: rank {rank} failed\n{payload}")
            got[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=timeout_s)
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.pid is None:  # never started: a failed start raised above
                continue
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
