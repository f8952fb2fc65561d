"""The rank mesh and the work split of the multi-rank training step
(counterpart of ``recmv_tpu/parallel/mesh.py``).

The JAX package lays one scene's step over a ('data', 'rays') device mesh
and lets jit's partitioner insert the reductions. The port runs one
process per rank over ``torch.distributed`` and splits the work itself:

- **frames** (① and ②): contiguous blocks of the batch over 'data'
  (``frame_share``); blocks may be uneven and one may be empty, as
  GSPMD pads;
- **rays** (the solve and ③): the step's global ray list in contiguous
  shares over every rank, data×rays collapsed as ``shard_rays`` does
  there, padded per ``pad_to_devices`` (``ray_share``, ``shard_rays``);
- **parameters, optimizer states, mesh buffers**: replicated, broadcast
  from rank 0 and kept equal by all-reduced gradients.

Ranks are laid out row-major, rank = data·rays_size + rays, as the JAX
mesh reshapes its device list. Only ``all_reduce`` (SUM) and
``broadcast`` are used, and a gather is an all-reduce of a zero-filled
buffer into which each rank writes its slice: gloo supports those two on
CUDA tensors, so one code path runs over gloo (CPU tensors, or ranks that
share one card) and over NCCL (one rank per card).
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

AXES = ("data", "rays")
TIMEOUT_S = 600.0            # a process group's set-up and each collective


@dataclass
class Mesh:
    """This rank's view of the ('data', 'rays') mesh over the default
    process group: ``shape`` {axis: size}, ``devices`` the (data, rays)
    array of ranks, ``coord`` this rank's (data, rays) position and
    ``device`` the torch device its tensors live on. ``comm`` counts the
    collectives (calls, bytes, seconds); with ``timed`` each one is
    bracketed by device synchronizations, so its seconds are the
    collective's own."""

    shape: dict
    rank: int
    device: torch.device
    backend: str
    timed: bool = False
    comm: dict = field(default_factory=lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})

    axis_names = AXES

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["rays"]

    @property
    def devices(self) -> np.ndarray:
        return np.arange(self.size).reshape(self.shape["data"], self.shape["rays"])

    @property
    def coord(self) -> tuple:
        return divmod(self.rank, self.shape["rays"])

    def reset_comm(self):
        self.comm = {"calls": 0, "bytes": 0, "seconds": 0.0}

    def _run(self, op, t: torch.Tensor):
        sync = self.timed and t.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        op(t)
        if sync:
            torch.cuda.synchronize(t.device)
        self.comm["calls"] += 1
        self.comm["bytes"] += t.numel() * t.element_size()
        self.comm["seconds"] += time.perf_counter() - t0
        return t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over every rank, in place; returns it."""
        return self._run(lambda x: dist.all_reduce(x, op=dist.ReduceOp.SUM), t)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, in place; returns it."""
        return self._run(lambda x: dist.broadcast(x, src=0), t)

    def sum_flat(self, tensors: list) -> list:
        """Every rank's sum of each tensor (one flat all-reduce of their
        detached float32 copies) → new tensors of the inputs' shapes."""
        if not tensors:
            return []
        flat = torch.cat([t.detach().reshape(-1).to(self.device, torch.float32)
                          for t in tensors])
        self.all_reduce(flat)
        return [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    def check_device(self, device) -> None:
        """Raise unless tensors on ``device`` are this rank's and the
        backend can reduce them (NCCL only CUDA tensors)."""
        device = torch.device(device)
        if self.backend == "nccl" and device.type != "cuda":
            raise ValueError(f"the nccl backend cannot reduce {device} tensors")
        if device.type != self.device.type or (
                device.type == "cuda" and (device.index or 0) != (self.device.index or 0)):
            raise ValueError(f"tensors on {device}, but this rank's device is {self.device}")


def make_mesh(data: int = 1, device=None) -> Mesh:
    """The ('data', 'rays') mesh over the initialized default process
    group, every rank of it: ``rays = world // data``. ``device`` is this
    rank's; by default ``cuda:<rank>`` with NCCL and ``cuda:<rank mod
    cards>`` with gloo (ranks may share a card), ``cpu`` only when asked
    for."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (init_parallel)")
    n, rank = dist.get_world_size(), dist.get_rank()
    if data < 1 or n % data:
        raise ValueError(f"data={data} does not divide {n} ranks")
    backend = str(dist.get_backend())
    if device is None:
        if not torch.cuda.is_available():
            resolve_device(None)                  # raises: no card, no device named
        cards = torch.cuda.device_count()
        if backend == "nccl" and rank >= cards:
            raise RuntimeError(f"nccl rank {rank} has no card of its own ({cards} cards)")
        device = torch.device("cuda", rank % cards)
    device = resolve_device(device)
    mesh = Mesh(shape={"data": data, "rays": n // data}, rank=rank, device=device,
                backend=backend)
    mesh.check_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return mesh


def pad_to_devices(x, mesh: Mesh, axis: int = 0):
    """Pad dim ``axis`` with zeros to a multiple of the mesh's rank count
    → (padded, original size); numpy arrays or torch tensors."""
    n = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    size = x.shape[axis]
    pad = (-size) % n
    if pad == 0:
        return x, size
    if torch.is_tensor(x):
        shape = list(x.shape)
        shape[axis] = pad
        return torch.cat([x, x.new_zeros(shape)], axis), size
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths), size


@dataclass(frozen=True)
class FrameShare:
    """A rank's block [lo, hi) of a batch of ``n`` frames and the weight
    (1 or 0) of its frame terms: 1 on the first rank of a data group
    whose block holds a frame, 0 elsewhere, so each frame counts once in
    a sum over all ranks. An empty block computes on frame 0 as a
    stand-in (``rows``) with weight 0. ``mesh`` is None on one device,
    where the share is the whole batch with weight 1."""

    lo: int
    hi: int
    n: int
    weight: float
    mesh: Mesh | None = None

    @property
    def rows(self) -> slice:
        return slice(self.lo, self.hi) if self.hi > self.lo else slice(0, 1)

    @property
    def root(self) -> bool:
        """Whether this rank computes the terms that are neither per frame
        nor per ray (rank 0; the one device)."""
        return self.mesh is None or self.mesh.rank == 0

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's sum of ``t``, in place; ``t`` on one device."""
        return t if self.mesh is None else self.mesh.all_reduce(t)

    def sum_flat(self, tensors: list) -> list:
        """Every rank's sum of each tensor (``Mesh.sum_flat``, detached);
        the tensors as given on one device."""
        return tensors if self.mesh is None else self.mesh.sum_flat(tensors)

    def count(self, tensors: list) -> list:
        """Every rank's sum of these counts of its block, weighed by the
        share's weight, so each frame's count is taken once (detached);
        the counts as given on one device."""
        if self.mesh is None:
            return tensors
        return self.mesh.sum_flat([t * self.weight for t in tensors])


def frame_share(n_frames: int, mesh: Mesh | None) -> FrameShare:
    """This rank's contiguous block of ``n_frames`` over 'data': blocks of
    ceil(n / data) frames, the last ones shorter or empty."""
    if mesh is None:
        return FrameShare(0, n_frames, n_frames, 1.0)
    d, r = mesh.coord
    block = -(-n_frames // mesh.shape["data"])
    lo = min(d * block, n_frames)
    hi = min(lo + block, n_frames)
    return FrameShare(lo, hi, n_frames, float(r == 0 and hi > lo), mesh)


def ray_share(n: int, mesh: Mesh | None) -> tuple:
    """This rank's contiguous share of ``n`` rows over every rank (data×rays
    collapsed): rows [lo, hi) of the list padded to a multiple of the rank
    count, clipped to the real rows → (lo, hi)."""
    if mesh is None:
        return 0, n
    per = -(-n // mesh.size)
    lo = min(mesh.rank * per, n)
    return lo, min(lo + per, n)


def shard_rays(mesh: Mesh, *arrays):
    """Each ray-major array's share on this rank: its leading dim padded
    per ``pad_to_devices`` and cut into ``mesh.size`` equal contiguous
    shares (the JAX ``shard_rays`` placement)."""
    out = []
    for a in arrays:
        padded, _ = pad_to_devices(a, mesh)
        per = padded.shape[0] // mesh.size
        out.append(padded[mesh.rank * per:(mesh.rank + 1) * per])
    return tuple(out) if len(out) > 1 else out[0]


def agree(mesh: Mesh, ok: bool, what: str) -> None:
    """Raise on every rank unless ``ok`` holds on every rank."""
    flag = torch.tensor([0.0 if ok else 1.0], device=mesh.device)
    if float(mesh.all_reduce(flag)) > 0:
        raise RuntimeError(f"the ranks disagree on {what}")


def broadcast_tensors(mesh: Mesh, tensors: list, what: str = "the replicated state") -> None:
    """Copy rank 0's values of ``tensors`` into every rank's, in place: one
    broadcast per dtype, after a check of the list's layout (count, sizes
    and dtypes) that raises on every rank where any rank's differs."""
    desc = ";".join(f"{t.numel()}:{t.dtype}" for t in tensors).encode()
    code = torch.tensor([len(tensors), zlib.crc32(desc)], dtype=torch.int64, device=mesh.device)
    mine = code.clone()
    agree(mesh, torch.equal(mesh.broadcast(code), mine), what)
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for dtype in sorted(groups, key=str):
        group = groups[dtype]
        flat = mesh.broadcast(torch.cat([t.detach().reshape(-1).to(mesh.device) for t in group]))
        if mesh.rank != 0:
            with torch.no_grad():
                for t, part in zip(group, flat.split([t.numel() for t in group])):
                    t.copy_(part.view_as(t))


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------

def init_parallel(backend: str, rank: int, world_size: int, init_file: str) -> None:
    """Join the default process group over a ``file://`` store (no TCP
    port). Raises when the group cannot be formed within ``TIMEOUT_S``."""
    dist.init_process_group(backend=backend, init_method="file://" + os.path.abspath(init_file),
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _rank_entry(rank, fn, nprocs, backend, init_file, out_dir, threads, args):
    # ranks of one host talk over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if threads:
        torch.set_num_threads(threads)
    init_parallel(backend, rank, nprocs, init_file)
    try:
        out = fn(rank, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, backend: str = "gloo", args: tuple = (), threads: int | None = None
          ) -> list:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes, each a rank of
    one process group (``init_parallel`` over a ``file://`` store in a
    temporary directory), and wait for all of them: the first failure
    raises, after the others are stopped. ``fn`` must be importable
    (module level) and its return value picklable. ``threads`` sets each
    rank's intra-op threads. Returns the ranks' results in rank order."""
    work = tempfile.mkdtemp(prefix="recmv_ranks_")
    try:
        torch.multiprocessing.start_processes(
            _rank_entry, args=(fn, nprocs, backend, os.path.join(work, "store"), work, threads,
                               args), nprocs=nprocs, join=True, start_method="spawn")
        out = []
        for r in range(nprocs):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)
