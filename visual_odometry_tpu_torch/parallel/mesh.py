"""Device meshes on ``torch.distributed`` (port of visual_odometry_tpu.parallel.mesh).

The axes are the JAX package's:

  * ``dp`` — data parallel over sequences (serving) or over the chunks of one
    sequence (sequence parallelism);
  * ``lm`` — the landmark blocks the sharded bundle adjustment and the
    sharded matcher reduce over.

The SPMD contract. JAX runs a ``shard_map`` program from one controller over
global arrays; here every rank is a process that calls the same function.

1. **A mesh spans the whole world.** :class:`Mesh` wraps a
   ``torch.distributed.device_mesh.DeviceMesh`` over every rank, rank ``r`` at
   coordinate ``(r // lm, r % lm)`` as in JAX's ``reshape(dp, lm)``. It keeps
   the axis names, ``shape[name]``, this rank's ``device``, and per axis its
   process ``group(name)`` and this rank's ``axis_index(name)`` (JAX's
   ``lax.axis_index``). :func:`make_mesh` keeps JAX's default ``dp_size``
   rule, but its ``n_devices`` must be the world size: a process cannot be
   left out of the groups' creation, where JAX takes the first n devices.
   Each rank runs on ``cuda:(local_rank % device_count)``, or on the CPU
   with ``device="cpu"``; with neither a card nor ``device="cpu"`` the call
   raises. The backend defaults to NCCL on a card and gloo on the CPU.
2. **Collectives go through** :func:`psum`, :func:`pmin` **and**
   :func:`all_gather` **over a named axis, and nowhere else.** Under gloo a
   CUDA tensor's collective runs on a host copy made here, whose bytes the
   mesh counts (``Mesh.staged_bytes``); under NCCL tensors stay on the card.
3. **A function at the level of JAX's ``shard_map`` takes and returns
   rank-local blocks where JAX shards, and whole tensors where JAX
   replicates** (``matcher.sharded_best_match``, the steps of
   ``bundle_adjustment.make_sharded_ba_step`` and
   ``sparse_ba.make_sharded_sparse_ba_step``). Outputs follow JAX's
   ``out_specs``, so a loop of steps moves no landmark between ranks.
4. **An entry point takes global inputs and returns global outputs on every
   rank** (``multiseq.run_sequences_batched``,
   ``posegraph.run_sequence_chunked``, ``refinement.refine_trajectory[_sparse]``,
   ``posegraph.refine_stitched``): every rank passes the same whole inputs,
   computes its block and all-gathers the results.
5. **Every rank enters every collective in the same order**, the gathers that
   build a whole result included, and every decision that ends a loop is
   taken on replicated values (the sparse-BA CG takes its exit test through
   :func:`pmin`).

A world comes from ``torchrun`` (:func:`init_distributed` with no arguments
reads its environment) or, on one host, from :func:`run_local`, which spawns
the ranks with a ``file://`` rendezvous in a temporary directory: the
counterpart of the JAX tests' virtual 8-device CPU mesh.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


class Mesh:
    """Named axes over every rank of the world, and this rank's place in them."""

    def __init__(self, device_mesh: DeviceMesh, device: torch.device, backend: str):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape))
        self.device = device
        self.backend = backend
        # Bytes copied between the card and the host for gloo collectives.
        self.staged_bytes = 0

    def group(self, name: str) -> dist.ProcessGroup:
        return self.device_mesh.get_group(name)

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along axis ``name`` (JAX's ``lax.axis_index``)."""
        return self.device_mesh.get_local_rank(name)


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def _rank_device(device) -> torch.device:
    """``cpu`` when asked for, else this rank's card, ``cuda:(local_rank %
    device_count)``, made current; raises without a card."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh needs a CUDA device on every rank, or device='cpu'")
    index = _local_rank() % torch.cuda.device_count()
    torch.cuda.set_device(index)
    torch.cuda.init()
    return torch.device("cuda", index)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> int:
    """Join the world (the NCCL/MPI-init analog); returns the world size.

    With no arguments reads ``torchrun``'s environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``). ``coordinator_address`` is a
    ``host:port`` (TCP) or an init method URL such as ``file:///path``.
    ``backend`` defaults to NCCL where a card is present, else gloo. A no-op
    when the world is already initialised."""
    if dist.is_initialized():
        return dist.get_world_size()
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = "tcp://" + coordinator_address
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend=backend, init_method=init_method, **kw)
    return dist.get_world_size()


def _world(n_devices: Optional[int], device, backend: Optional[str]):
    """(n, this rank's device, backend) of a mesh over the whole world."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs torch.distributed initialised: run under torchrun "
                           "and call init_distributed(), or start the ranks with run_local")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"a mesh spans the whole world of {world} ranks, got n_devices="
                         f"{n_devices}")
    running = dist.get_backend()
    if backend is not None and backend != running:
        raise ValueError(f"backend={backend!r}, but the world runs {running!r}")
    return n_devices, _rank_device(device), running


def default_dp_size(n_devices: int) -> int:
    """JAX's default ``dp_size``: the largest power-of-two divisor <= sqrt(n)
    (the landmark axis takes the larger share of the mesh)."""
    dp_size = 1
    while n_devices % (dp_size * 2) == 0 and dp_size * dp_size * 4 <= n_devices:
        dp_size *= 2
    return dp_size


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, str] = ("dp", "lm"),
    dp_size: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
) -> Mesh:
    """A (dp, lm) mesh over the whole world; every rank calls it."""
    n_devices, dev, backend = _world(n_devices, device, backend)
    if dp_size is None:
        dp_size = default_dp_size(n_devices)
    if n_devices % dp_size:
        raise ValueError(f"dp_size {dp_size} does not divide {n_devices}")
    layout = torch.arange(n_devices).reshape(dp_size, n_devices // dp_size)
    return Mesh(DeviceMesh(dev.type, layout, mesh_dim_names=tuple(axis_names)), dev, backend)


def single_axis_mesh(n_devices: Optional[int] = None, name: str = "lm", device=None,
                     backend: Optional[str] = None) -> Mesh:
    """A one-axis mesh over the whole world; every rank calls it."""
    n_devices, dev, backend = _world(n_devices, device, backend)
    return Mesh(DeviceMesh(dev.type, torch.arange(n_devices), mesh_dim_names=(name,)), dev,
                backend)


def pad_to_multiple(x: np.ndarray, axis: int, multiple: int, fill=0):
    """Pad ``x`` so shape[axis] divides ``multiple`` (sharding needs equal shards)."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad, constant_values=fill), n


# --------------------------------------------------------------------------
# The collectives
# --------------------------------------------------------------------------


def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.is_cuda


def _send_buffer(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` the collective may overwrite: on the host
    (counted) for gloo and a CUDA tensor; bool travels as uint8."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if _staged(mesh, x):
        mesh.staged_bytes += x.numel() * x.element_size()
        return x.to("cpu", copy=True).contiguous()
    return x.clone(memory_format=torch.contiguous_format)


def _received(mesh: Mesh, buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if buf.device != like.device:
        mesh.staged_bytes += buf.numel() * buf.element_size()
        buf = buf.to(like.device)
    return buf.to(torch.bool) if like.dtype == torch.bool else buf


def _all_reduce(mesh: Mesh, x: torch.Tensor, axis: str, op) -> torch.Tensor:
    buf = _send_buffer(mesh, x)
    dist.all_reduce(buf, op=op, group=mesh.group(axis))
    return _received(mesh, buf, x)


def psum(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (JAX's ``lax.psum``), on every rank."""
    return _all_reduce(mesh, x, axis, dist.ReduceOp.SUM)


def pmin(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Elementwise minimum of ``x`` over the ranks of ``axis`` (``lax.pmin``)."""
    return _all_reduce(mesh, x, axis, dist.ReduceOp.MIN)


def all_gather(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Every rank's ``x`` of ``axis`` concatenated along dim 0 in axis order
    (``lax.all_gather(..., tiled=True)``); every rank's ``x`` has one shape."""
    buf = _send_buffer(mesh, x)
    parts = [torch.empty_like(buf) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, buf, group=mesh.group(axis))
    return _received(mesh, torch.cat(parts, dim=0), x)


def all_gather_tuple(mesh: Mesh, t, axis: str):
    """:func:`all_gather` of each tensor of a NamedTuple, in field order."""
    return type(t)(*(all_gather(mesh, x, axis) for x in t))


# --------------------------------------------------------------------------
# A world on one host
# --------------------------------------------------------------------------


def _rank_main(rank: int, fn, world_size: int, tmp: str, backend: str, device, args: Sequence):
    os.environ.update(LOCAL_RANK=str(rank), RANK=str(rank), WORLD_SIZE=str(world_size))
    if torch.device(device).type == "cpu":
        # An equal share of the host's cores: ranks that each spin a full
        # thread pool starve each other's collectives.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    init_distributed("file://" + os.path.join(tmp, "rendezvous"), world_size, rank, backend)
    try:
        torch.save(fn(*args), os.path.join(tmp, f"result-{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_local(fn, world_size: int, *args, backend: Optional[str] = None, device="cpu",
              timeout: float = 900.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks of a one-host world
    and return each rank's result, by rank (tensors mapped to the CPU).

    The ranks rendezvous through a file in a temporary directory; ``backend``
    defaults to gloo for ``device="cpu"`` and NCCL otherwise; CPU ranks each
    take an equal share of the host's cores. ``fn`` must be
    importable by the child processes (a module-level function) and builds
    its mesh with :func:`make_mesh` or :func:`single_axis_mesh`. A rank that
    raises ends the world and raises here with its traceback; so does a
    world still running after ``timeout`` seconds."""
    backend = backend or ("gloo" if torch.device(device).type == "cpu" else "nccl")
    with tempfile.TemporaryDirectory(prefix="vo_world_") as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world_size, tmp, backend, device, args), nprocs=world_size,
            join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {world_size} ranks ran past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(30)
        return [torch.load(os.path.join(tmp, f"result-{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(world_size)]
