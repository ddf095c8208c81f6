"""The device mesh over a ``torch.distributed`` world (counterpart of the JAX
``runtime/mesh.py``).

The reference bootstraps distribution with a TCP rendezvous into a gloo
process group (``--master --port --world-size --rank``). The JAX package
maps that onto ``jax.distributed.initialize`` and a named device mesh whose
collectives XLA compiles. Here a :class:`World` is the rendezvous (a
``torch.distributed`` store, this rank, the world's size, the backend and
this rank's device), and a :class:`DeviceMesh` names axes over it
(``{"data": 2}``, ``{"data": 2, "model": 2}``) and holds one process group
for each axis slice this rank belongs to. Every collective of the port's
parallel modules goes through a mesh method that names its axis, so none
touches the default process group: that is what lets a world run as threads
of one process (:func:`run_threaded`, the counterpart of the JAX
``force_cpu_devices``), each thread a rank with its own gloo groups over one
in-memory store.

The backend is explicit: ``nccl`` (the default on ``cuda``) or ``gloo``.
NCCL refuses two ranks on one card, so a world with more ranks than this
host has cards raises ``ValueError`` under ``nccl``; the code never switches
backend by itself. Under ``gloo`` a CUDA tensor goes to the group as it is:
on torch 2.11 with an H100, gloo's all_reduce (float32, bfloat16, max),
broadcast, all_gather, reduce_scatter and all_to_all take CUDA tensors,
while a send of one aborts the process (gloo hands the device pointer to
its socket). So :meth:`DeviceMesh.permute`, :meth:`DeviceMesh.send`,
:meth:`DeviceMesh.recv` and :meth:`DeviceMesh.all_to_all` copy a CUDA
tensor through pinned host memory under gloo and count each copy in
``host_staged``. Under ``nccl`` nothing is staged.

Values never depend on the mesh's shape: every rank builds the full
initial state from the seed on the host and keeps its shard
(``parallel/fsdp.py``, ``parallel/tensor_parallel.py``), the counterpart of
the JAX ``sharded_init``.
"""

from __future__ import annotations

import datetime
import math
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
#: seconds a collective may wait for its peers before it raises
DEFAULT_TIMEOUT_S = 300.0

_CURRENT = threading.local()
_PROCESS_WORLD = None  # the World of init_distributed, for the whole process


@dataclass
class World:
    """One rank's view of the rendezvous: the store every group is built
    from, this rank, the world's size, the backend and the rank's device."""

    store: object
    rank: int
    size: int
    backend: str
    device: torch.device
    timeout_s: float = DEFAULT_TIMEOUT_S
    meshes: int = field(default=0, repr=False)

    def new_group(self, prefix: str, rank: int, size: int):
        """A process group of ``size`` ranks (this one ``rank`` in it) under
        the store's ``prefix``, of the world's backend."""
        store = dist.PrefixStore(prefix, self.store)
        timeout = datetime.timedelta(seconds=self.timeout_s)
        if self.backend == "gloo":
            return dist.ProcessGroupGloo(store, rank, size, timeout)
        return dist.ProcessGroupNCCL(store, rank, size)


def default_backend(device) -> str:
    """``nccl`` on the card, ``gloo`` on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, world_size: int, device) -> None:
    """Refuse a backend that cannot serve this world (see module docstring)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError("the nccl backend needs device='cuda'; use gloo on the CPU")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world_size > cards:
        raise ValueError(
            f"nccl with {world_size} ranks needs {world_size} cards, this host has "
            f"{cards}: NCCL refuses two ranks on one device — use the gloo backend "
            f"to share a card")


def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:<rank mod cards>`` on the card (ranks
    share the cards round-robin), the CPU otherwise."""
    from distributed_ml_pytorch_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _make_world(store, rank: int, size: int, backend: Optional[str], device,
                timeout_s: float) -> World:
    backend = backend or default_backend(device)
    check_backend(backend, size, device)
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a world of {size}")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return World(store, rank, size, backend, dev, timeout_s)


def init_distributed(backend: Optional[str] = None, master: str = "localhost",
                     port=29500, world_size: int = 1, rank: int = 0, device="cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> World:
    """Join a world of processes (the reference's ``--master --port
    --world-size --rank``; the JAX ``initialize_distributed``): rank 0 hosts
    a TCP store on ``master:port``, every rank connects to it. ``backend``
    ``None`` takes :func:`default_backend` of ``device``. The world becomes
    this process's current one (:func:`process_rank`, :func:`world_size`)."""
    store = dist.TCPStore(master, int(port), int(world_size), int(rank) == 0,
                          datetime.timedelta(seconds=timeout_s))
    world = _make_world(store, int(rank), int(world_size), backend, device, timeout_s)
    global _PROCESS_WORLD
    _PROCESS_WORLD = world
    return world


def run_threaded(n: int, fn: Callable[[World], object], backend: str = "gloo",
                 device="cpu", timeout_s: float = 120.0) -> List[object]:
    """Run ``fn(world)`` on ``n`` ranks that are threads of this process,
    over one in-memory store (the counterpart of the JAX
    ``force_cpu_devices``); returns the ranks' results in rank order and
    raises the first rank's exception. Each thread's current world is its
    own."""
    store = dist.HashStore()
    worlds = [_make_world(store, r, n, backend, device, timeout_s) for r in range(n)]
    results: List[object] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n

    def run(r: int) -> None:
        _CURRENT.world = worlds[r]
        if worlds[r].device.type == "cuda":
            torch.cuda.set_device(worlds[r].device)
        try:
            results[r] = fn(worlds[r])
        except BaseException as e:  # re-raised in the caller's thread below
            errors[r] = e
        finally:
            _CURRENT.world = None

    threads = [threading.Thread(target=run, args=(r,), name=f"rank{r}", daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s + 60.0)
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"a rank of the {n}-thread world did not finish in "
                           f"{timeout_s + 60.0:.0f} s")
    for e in errors:
        if e is not None:
            raise e
    return results


def current_world() -> Optional[World]:
    """The calling thread's world (:func:`run_threaded`), else the process's
    (:func:`init_distributed`), else ``None``."""
    return getattr(_CURRENT, "world", None) or _PROCESS_WORLD


def process_rank() -> int:
    """This rank (the reference's ``dist.get_rank()``); 0 outside a world."""
    w = current_world()
    return w.rank if w is not None else 0


def world_size() -> int:
    """The world's size; 1 outside a world."""
    w = current_world()
    return w.size if w is not None else 1


def local_device_count() -> int:
    """The cards this host exposes (0 without one)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class DeviceMesh:
    """Named axes over a :class:`World`, ranks laid out row-major as the JAX
    mesh lays out its devices (``{"data": 2, "model": 2}``: rank ``2·d +
    m``). Holds one process group per axis: the ranks that share every
    other coordinate with this one. The collectives take the axis by name
    and index ranks along it."""

    def __init__(self, axis_sizes: Mapping[str, int], world: World):
        self.world = world
        self.names: Tuple[str, ...] = tuple(axis_sizes)
        self.dims: Tuple[int, ...] = tuple(int(v) for v in axis_sizes.values())
        if any(d < 1 for d in self.dims):
            raise ValueError(f"mesh axes must be positive: {dict(axis_sizes)}")
        if math.prod(self.dims) != world.size:
            raise ValueError(f"mesh shape {dict(axis_sizes)} needs {math.prod(self.dims)} "
                             f"ranks, the world has {world.size}")
        self.rank = world.rank
        self.backend = world.backend
        self.device = world.device
        coords = [int(c) for c in np.unravel_index(self.rank, self.dims)]
        self.coords: Dict[str, int] = dict(zip(self.names, coords))
        self.host_staged = 0
        world.meshes += 1
        tag = f"mesh{world.meshes}/" + "x".join(f"{n}{d}" for n, d in zip(self.names, self.dims))
        self._tag, self._lanes = tag, {}
        self._groups = {}
        for i, name in enumerate(self.names):
            key = ",".join("*" if j == i else str(c) for j, c in enumerate(coords))
            self._groups[name] = world.new_group(f"{tag}/{name}/{key}", coords[i], self.dims[i])

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, self.dims))

    @property
    def size(self) -> int:
        return self.world.size

    def axis_size(self, axis: str) -> int:
        return self.dims[self.names.index(axis)]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    # ------------------------------------------------------------ collectives

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """``t`` (contiguous) reduced over ``axis`` with ``sum`` or ``max``,
        in place; returns ``t``."""
        opts = dist.AllreduceOptions()
        opts.reduceOp = _OPS[op]
        self._groups[axis].allreduce([t], opts).wait()
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The axis' ranks' ``t`` concatenated along dim 0 in rank order."""
        t = t.contiguous()
        out = torch.empty((self.axis_size(axis) * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        self._groups[axis]._allgather_base(out, t).wait()
        return out

    def reduce_scatter(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over the axis' ranks of ``t``, split along dim 0 into the
        axis size's chunks: this rank's chunk."""
        n = self.axis_size(axis)
        if t.shape[0] % n:
            raise ValueError(f"reduce_scatter of {t.shape[0]} rows over {n} ranks")
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        out = torch.empty((t.shape[0] // n, *t.shape[1:]), dtype=t.dtype, device=t.device)
        self._groups[axis]._reduce_scatter_base(out, t.contiguous(), opts).wait()
        return out

    def broadcast(self, t: torch.Tensor, axis: str, src: int = 0) -> torch.Tensor:
        """``t`` of rank ``src`` along ``axis`` on every rank of it, in place."""
        opts = dist.BroadcastOptions()
        opts.rootRank, opts.rootTensor = int(src), 0
        self._groups[axis].broadcast([t], opts).wait()
        return t

    def permute(self, t: torch.Tensor, pairs: Sequence[Tuple[int, int]], axis: str,
                tag: int = 0) -> torch.Tensor:
        """``pairs`` ``[(src, dst), ...]`` along ``axis``: each ``src`` sends
        its ``t`` to ``dst``; returns what this rank received, zeros where it
        is no destination (the ``lax.ppermute`` semantics). Every send and
        receive is posted before any is waited on, so a ring does not
        deadlock. The traffic is :meth:`send`'s, on the axis' own group."""
        me = self.axis_index(axis)
        srcs = [s for s, d in pairs if d == me]
        if len(srcs) > 1:
            raise ValueError(f"rank {me} of {axis!r} is the destination of {len(srcs)} pairs")
        held, got = [], None
        for s, d in pairs:
            if s == me and d == me:
                got = t.contiguous().clone()
            elif s == me:
                held.append(self.send(t, d, axis, tag=tag))
            elif d == me:
                got = self._landing(t)
                held.append((self._groups[axis].recv([got], int(s), tag), got))
        for work, _buf in held:
            work.wait()
        if got is None:
            return torch.zeros_like(t, memory_format=torch.contiguous_format)
        return got.to(t.device)

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """The tiled ``lax.all_to_all`` over ``axis``: ``t`` split along
        ``split_dim`` into the axis size's chunks, chunk ``j`` sent to rank
        ``j``, and the chunks received from ranks ``0 .. n-1`` concatenated
        along ``concat_dim`` in rank order. Under gloo a CUDA tensor goes
        through pinned host memory (counted in ``host_staged``)."""
        n = self.axis_size(axis)
        if t.shape[split_dim] % n:
            raise ValueError(f"all_to_all of {t.shape[split_dim]} along dim {split_dim} "
                             f"over {n} ranks of {axis!r}")
        x = t.movedim(split_dim, 0)
        src, out = self._staged(x), self._landing(x)
        self._groups[axis].alltoall_base(out, src, [], [], dist.AllToAllOptions()).wait()
        chunks = [c.movedim(0, split_dim) for c in out.to(t.device).chunk(n, dim=0)]
        return torch.cat(chunks, dim=concat_dim)

    def lane(self, axis: str, name: str):
        """A second process group over ``axis``'s ranks, for point-to-point
        traffic of its own (a pipeline's activations one way, its cotangents
        the other): under NCCL each group has its own stream, so a send one
        way never waits behind a receive the other way. Every rank of the
        axis must ask for the same lanes in the same order."""
        key = (axis, name)
        if key not in self._lanes:
            i = self.names.index(axis)
            coords = [self.coords[a] for a in self.names]
            slot = ",".join("*" if j == i else str(c) for j, c in enumerate(coords))
            self._lanes[key] = self.world.new_group(
                f"{self._tag}/{axis}/{slot}/lane-{name}", coords[i], self.dims[i])
        return self._lanes[key]

    def _group(self, axis: str, lane: Optional[str]):
        return self._groups[axis] if lane is None else self.lane(axis, lane)

    def send(self, t: torch.Tensor, dst: int, axis: str, lane: Optional[str] = None,
             tag: int = 0):
        """Post a send of ``t`` to rank ``dst`` of ``axis``, on ``lane`` (the
        axis' own group when ``None``); returns the work and the buffer it
        reads (hold both until the work is waited on)."""
        buf = self._staged(t)
        return self._group(axis, lane).send([buf], int(dst), tag), buf

    def recv(self, like: torch.Tensor, src: int, axis: str, lane: Optional[str] = None,
             tag: int = 0) -> torch.Tensor:
        """A tensor shaped as ``like`` received from rank ``src`` of
        ``axis`` on ``lane`` (waits for it)."""
        buf = self._landing(like)
        self._group(axis, lane).recv([buf], int(src), tag).wait()
        return buf.to(like.device)

    # gloo takes no CUDA tensor in its point-to-point calls (on torch 2.11
    # they abort the process): under gloo a CUDA tensor leaves from, and
    # lands in, pinned host memory, each buffer counted in ``host_staged``

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend sends it: contiguous, or its pinned host copy."""
        t = t.contiguous()
        if self.backend == "gloo" and t.is_cuda:
            self.host_staged += 1
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
        return t

    def _landing(self, like: torch.Tensor) -> torch.Tensor:
        """An empty contiguous buffer shaped as ``like`` to receive into: in
        pinned host memory for a CUDA ``like`` under gloo."""
        if self.backend == "gloo" and like.is_cuda:
            self.host_staged += 1
            return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return torch.empty_like(like, memory_format=torch.contiguous_format)


def make_mesh(axis_sizes: Optional[Mapping[str, int]] = None,
              world: Optional[World] = None) -> DeviceMesh:
    """A named mesh over ``world`` (default: the current one), e.g.
    ``{"data": 4, "model": 2}``; ``None`` is a 1-D ``data`` mesh over every
    rank (in sync SPMD every rank is a worker). Its axes' product must be
    the world's size."""
    world = world or current_world()
    if world is None:
        raise ValueError("no world: call init_distributed() or run under run_threaded()")
    return DeviceMesh(axis_sizes or {"data": world.size}, world)


def data_mesh(n_ranks: Optional[int] = None, world: Optional[World] = None) -> DeviceMesh:
    """The 1-D ``data`` mesh over the world (``n_ranks``, when given, must be
    its size: the port's ranks are processes or threads, not devices one
    controller could leave out)."""
    world = world or current_world()
    if world is None:
        raise ValueError("no world: call init_distributed() or run under run_threaded()")
    if n_ranks is not None and n_ranks != world.size:
        raise ValueError(f"a data mesh of {n_ranks} ranks in a world of {world.size}")
    return DeviceMesh({"data": world.size}, world)


def rows_of(n_rows: int, mesh: DeviceMesh, axis: str = "data") -> slice:
    """This rank's contiguous block of ``n_rows`` rows sharded over ``axis``
    (the JAX ``P(axis)`` layout of a leading dim)."""
    n = mesh.axis_size(axis)
    if n_rows % n:
        raise ValueError(f"{n_rows} rows do not divide over {n} ranks of {axis!r}")
    b = n_rows // n
    i = mesh.axis_index(axis)
    return slice(i * b, (i + 1) * b)


def flat_all_reduce(mesh: DeviceMesh, tensors: Sequence[torch.Tensor], axis: str,
                    op: str = "sum") -> List[torch.Tensor]:
    """``tensors`` reduced over ``axis`` in one collective per dtype (each
    dtype's tensors flattened into one buffer); returns new tensors of the
    inputs' shapes, contiguous."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        mesh.all_reduce(flat, axis, op)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out
