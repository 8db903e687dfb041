"""Process groups for the sharded MSM and NTT over ``torch.distributed``.

Counterpart of ``panda_tpu/parallel/cluster.py``.  Every rank runs the same
program: :func:`initialize` joins the process group (address, size and rank
from its arguments, or from the ``MASTER_ADDR`` / ``MASTER_PORT`` /
``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` variables that ``torchrun``
sets), :func:`pod_mesh` and :func:`mesh` name the axes that the sharded
functions communicate over, and :func:`spawn` starts the ranks of a world on
one host itself.

Backends: NCCL, the default on the GPU, one GPU a rank; gloo for ranks on
the CPU, or for several ranks sharing one card.  Each rank's device is
``cuda:<local rank mod device count>``, or the CPU when the caller asks for
it.  The two collectives used here, ``all_gather_into_tensor`` and
``all_to_all_single``, take CUDA tensors under both backends (gloo copies
them through the host itself; checked with PyTorch 2.11 on an H100).
"""

from __future__ import annotations

import math
import os
import pickle
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

_device: torch.device | None = None
_meshes: dict = {}


def _rank_device(device, local_rank: int) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device=None, local_rank: int | None = None) -> torch.device:
    """Join the process group and return this rank's device.  Idempotent.

    ``coordinator_address`` is an init method (``tcp://host:port``);
    without it the ``MASTER_ADDR`` / ``MASTER_PORT`` variables are read.
    ``backend`` defaults to NCCL on the GPU and gloo on the CPU; ``device``
    defaults to ``cuda:<local rank mod device count>`` and raises when there
    is no GPU (``device="cpu"`` runs the rank on the CPU)."""
    global _device
    if dist.is_initialized():
        return _device
    rank = int(os.environ["RANK"]) if process_id is None else process_id
    world = (int(os.environ["WORLD_SIZE"]) if num_processes is None
             else num_processes)
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = _rank_device(device, local_rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs CUDA devices")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=coordinator_address or
                            "env://", world_size=world, rank=rank,
                            device_id=dev if backend == "nccl" else None)
    _device = dev
    return dev


def shutdown() -> None:
    """Leave the process group and forget this process's meshes."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None
    _meshes.clear()


def device() -> torch.device:
    """This rank's device (after :func:`initialize`)."""
    if _device is None:
        raise RuntimeError("cluster.initialize() has not run")
    return _device


class Mesh:
    """Named axes over the world's ranks: rank r sits at the row-major
    coordinates of r in ``shape``.  ``shape`` maps each axis to its size,
    ``coords`` to this rank's index on it, ``groups`` to the process group
    of the ranks that differ from this one only on that axis (group rank =
    index on the axis)."""

    def __init__(self, axis_names: tuple, sizes: tuple, coords: tuple,
                 groups: dict, device: torch.device):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.coords = dict(zip(self.axis_names, coords))
        self.groups = groups
        self.device = device

    def index(self, axis: str) -> int:
        """This rank's index on ``axis`` (``jax.lax.axis_index``)."""
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]


def mesh(sizes: tuple, axis_names: tuple) -> Mesh:
    """A mesh of the given axis sizes over the whole world.  Every rank
    creates every group, in the same order, so every rank calls this with
    the same arguments; a mesh is made once a process."""
    key = (tuple(sizes), tuple(axis_names))
    if key not in _meshes:
        world, rank = dist.get_world_size(), dist.get_rank()
        if math.prod(sizes) != world or len(sizes) != len(axis_names):
            raise ValueError(f"mesh {dict(zip(axis_names, sizes))} does not "
                             f"cover a world of {world}")
        ids = np.arange(world).reshape(sizes)
        groups = {}
        for k, name in enumerate(axis_names):
            for line in np.moveaxis(ids, k, -1).reshape(-1, sizes[k]):
                g = dist.new_group(line.tolist())
                if rank in line:
                    groups[name] = g
        coords = tuple(int(v) for v in np.unravel_index(rank, sizes))
        _meshes[key] = Mesh(axis_names, sizes, coords, groups, device())
    return _meshes[key]


def pod_mesh(axis: str = "points") -> Mesh:
    """1-D mesh over every rank of the world."""
    return mesh((dist.get_world_size(),), (axis,))


def host_local_slice(n: int) -> slice:
    """The [start, stop) range of a length-n global axis owned by this
    process (the whole axis when no process group is up)."""
    procs = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0
    per = -(-n // procs)
    return slice(pid * per, min((pid + 1) * per, n))


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(D, *t.shape): every rank's ``t`` in group-rank order
    (``jax.lax.all_gather``)."""
    D = dist.get_world_size(group)
    src = t.reshape(-1).contiguous()
    out = src.new_empty((D * src.numel(),))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.view((D,) + tuple(t.shape))


def all_to_all(t: torch.Tensor, split_axis: int, concat_axis: int,
               group) -> torch.Tensor:
    """``jax.lax.all_to_all(t, axis, split_axis, concat_axis, tiled=True)``:
    ``t`` cut into D chunks along ``split_axis``, chunk q sent to group rank
    q; the chunks received are joined along ``concat_axis`` in group-rank
    order.  ``all_to_all_single`` exchanges along dim 0 only, so the chunks
    are stacked on a new leading axis first."""
    D = dist.get_world_size(group)
    if t.shape[split_axis] % D:
        raise ValueError(f"axis {split_axis} of {tuple(t.shape)} does not "
                         f"split over {D} ranks")
    send = torch.stack(t.chunk(D, dim=split_axis))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


# ---------------------------------------------------------------------------
# Starting the ranks of a one-host world
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, address, backend, device, fn, args, results):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        initialize(address, world, rank, backend, device, local_rank=rank)
        # pickled here, by value: a tensor put on the queue as it is would
        # travel as a shared-memory handle that dies with this process
        out = pickle.dumps(fn(*args))
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        shutdown()


# The longest a world started by spawn may run.
SPAWN_TIMEOUT_S = 900


def spawn(fn, world: int, *args, backend: str | None = None,
          device=None) -> list:
    """Run ``fn(*args)`` on ``world`` new processes that form one process
    group (``tcp://localhost``, a free port) and return their results in
    rank order.  ``fn`` must be importable by name from a module that the
    processes can import (they start with ``spawn``), and its arguments and
    result picklable.  ``backend`` and ``device`` go to :func:`initialize`
    (rank r on ``cuda:<r mod device count>`` by default).  A rank that
    raises or dies, or a run over SPAWN_TIMEOUT_S, raises here; every
    process is stopped before this returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, address, backend, device, fn, args,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline, dead_at = {}, time.monotonic() + SPAWN_TIMEOUT_S, None
    try:
        while len(out) < world:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                # a rank that failed reports before it exits: give its
                # report a few seconds to arrive
                dead_at = dead_at or (time.monotonic() if dead else None)
                if dead and time.monotonic() > dead_at + 10:
                    raise RuntimeError(f"ranks {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{SPAWN_TIMEOUT_S} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{payload}")
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
    return [out[r] for r in range(world)]
