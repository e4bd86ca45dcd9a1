"""Process meshes for multi-rank streaming inference over
``torch.distributed`` (port of ``stc_tpu/parallel/mesh.py``).

One process per rank.  The axes:

  dp  independent streams: each dp rank holds batch / dp of them
  sp  sequence (temporal) parallel: a chunk's frames on the vision side and
      an append's tokens on the LM side split over the sp ranks
  tp  tensor parallel over attention heads and the MLP hidden (Megatron
      layout); the page store holds each rank's kv heads
  pp  pipeline parallel over the LM's layers (parallel/pipeline.py), on a
      pp x tp mesh of its own

The JAX package gets its collectives from GSPMD.  Here each one is a call
of an ``Axis`` of the mesh, written where the sharded computation needs it
(the models, the engine, the session).  An axis of size 1 makes no call, so
a model on a mesh of size 1, or on no mesh, computes what the unsharded
code computes.

The communication backend is an argument of ``init_parallel``: "gloo" for
CPU ranks and for ranks that share one card, "nccl" for one card a rank.
Nothing picks it by trying.  gloo moves host memory: on gloo every
operation on a CUDA tensor is staged through host memory by the axis
itself (a copy to the host, the operation, a copy back), always, and the
staged bytes are counted beside each operation's calls, bytes and
seconds (``Mesh.stats``).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def init_parallel(backend: str, rank: int, world_size: int,
                  init_method: str) -> None:
    """Join the process group: backend "gloo" or "nccl", this process's
    rank, the world size and the rendezvous address (for example
    "tcp://localhost:29511").  Nothing here reads the environment."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world_size)


@dataclasses.dataclass
class OpStats:
    calls: int = 0
    bytes: int = 0
    staged_bytes: int = 0
    seconds: float = 0.0


class Axis:
    """One mesh axis seen from this rank: its size, this rank's index on
    it, the global ranks along it and its process group.  Collectives
    count themselves in `stats` under (axis, op, site): `site` names the
    call site (for example "qwen2.attn_out")."""

    def __init__(self, name: str, ranks: Sequence[int], index: int,
                 group=None, backend: Optional[str] = None,
                 stats: Optional[dict] = None):
        self.name = name
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.rank = int(index)
        self.group = group
        self.backend = backend
        self.stats = {} if stats is None else stats

    def __repr__(self):
        return f"Axis({self.name}, {self.rank}/{self.size})"

    # ------------------------------------------------------------------ #
    def _need_group(self):
        if self.group is None:
            raise RuntimeError(f"axis {self.name} has no process group "
                               "(a layout-only mesh cannot communicate)")

    def _count(self, op: str, site: str, x: torch.Tensor, staged: bool,
               t0: float):
        st = self.stats.setdefault((self.name, op, site), OpStats())
        n = x.numel() * x.element_size()
        st.calls += 1
        st.bytes += n
        st.staged_bytes += n if staged else 0
        st.seconds += time.perf_counter() - t0

    def _stage(self, x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
        """x as the backend takes it: gloo gets host memory."""
        if self.backend == "gloo" and x.device.type != "cpu":
            return x.cpu(), True
        return x, False

    @staticmethod
    def _bytes(x: torch.Tensor) -> torch.Tensor:
        """A contiguous flat uint8 view: movement ops move bytes, so every
        dtype (bfloat16, bool) rides every backend."""
        return x.contiguous().reshape(-1).view(torch.uint8)

    # ------------------------------------------------------------------ #
    def all_reduce(self, x: torch.Tensor, site: str = "") -> torch.Tensor:
        """Sum over the axis; half-precision floats are summed in float32
        and rounded once.  Every rank gets the same bytes."""
        if self.size == 1:
            return x
        self._need_group()
        t0 = time.perf_counter()
        y = x.to(torch.float32) if x.dtype in (torch.bfloat16,
                                               torch.float16) else x
        y, staged = self._stage(y.contiguous())
        if not staged and y is x:
            y = y.clone()
        dist.all_reduce(y, group=self.group)
        out = y.to(device=x.device, dtype=x.dtype)
        self._count("all_reduce", site, x, staged, t0)
        return out

    def all_gather(self, x: torch.Tensor, dim: int = 0,
                   site: str = "") -> torch.Tensor:
        """The ranks' x concatenated along dim, in axis order (every rank
        gives the same shape)."""
        if self.size == 1:
            return x
        self._need_group()
        t0 = time.perf_counter()
        xs = x.movedim(dim, 0).contiguous()
        flat, staged = self._stage(self._bytes(xs))
        bufs = [torch.empty_like(flat) for _ in range(self.size)]
        dist.all_gather(bufs, flat, group=self.group)
        parts = [b.to(x.device).view(x.dtype).reshape(xs.shape)
                 for b in bufs]
        out = torch.cat(parts, 0).movedim(0, dim)
        self._count("all_gather", site, x, staged, t0)
        return out

    def broadcast(self, x: torch.Tensor, src: int,
                  site: str = "") -> torch.Tensor:
        """x of the axis rank `src` on every rank of the axis."""
        if self.size == 1:
            return x
        self._need_group()
        t0 = time.perf_counter()
        flat, staged = self._stage(self._bytes(x))
        if not staged and self.rank != src:
            flat = flat.clone()
        dist.broadcast(flat, src=self.ranks[src], group=self.group)
        out = flat.to(x.device).view(x.dtype).reshape(x.shape)
        self._count("broadcast", site, x, staged, t0)
        return out

    def send(self, x: torch.Tensor, dst: int, site: str = "") -> None:
        """Point-to-point send to the axis rank `dst` (blocking)."""
        self._need_group()
        t0 = time.perf_counter()
        flat, staged = self._stage(self._bytes(x))
        dist.send(flat, dst=self.ranks[dst])
        self._count("send", site, x, staged, t0)

    def recv(self, like: torch.Tensor, src: int,
             site: str = "") -> torch.Tensor:
        """A tensor of like's shape, dtype and device from the axis rank
        `src` (blocking)."""
        self._need_group()
        t0 = time.perf_counter()
        n = like.numel() * like.element_size()
        dev = "cpu" if self.backend == "gloo" else like.device
        flat = torch.empty((n,), dtype=torch.uint8, device=dev)
        dist.recv(flat, src=self.ranks[src])
        out = flat.to(like.device).view(like.dtype).reshape(like.shape)
        self._count("recv", site, like, dev == "cpu" and
                    like.device.type != "cpu", t0)
        return out


class Mesh:
    """A named grid of ranks, row-major, the last axis innermost (tp, as
    in the JAX package: its collectives are the densest).  `coord[name]` is
    this rank's index on each axis; `axis(name)` its Axis (a size-1 axis
    for a name the mesh lacks).  The process groups are made with
    dist.new_group in the same order on every rank."""

    def __init__(self, names: Sequence[str], shape: Sequence[int],
                 backend: Optional[str] = None,
                 coord: Optional[Dict[str, int]] = None):
        """coord given: a layout-only mesh of this rank (no process group;
        its axes slice weights but cannot communicate).  Else the world
        must be initialised (init_parallel) with prod(shape) ranks."""
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"repeated axis names {names}")
        dims = tuple(self.shape[n] for n in self.axis_names)
        self.size = int(np.prod(dims))
        self.stats: dict = {}
        if coord is not None:
            self.backend = None
            self.rank = int(np.ravel_multi_index(
                tuple(coord[n] for n in self.axis_names), dims))
            groups = False
        else:
            if not dist.is_initialized():
                raise RuntimeError("Mesh needs init_parallel first")
            if dist.get_world_size() != self.size:
                raise ValueError(f"a {dict(self.shape)} mesh needs "
                                 f"{self.size} ranks, the world has "
                                 f"{dist.get_world_size()}")
            self.backend = dist.get_backend()
            self.rank = dist.get_rank()
            groups = True
        here = np.unravel_index(self.rank, dims)
        self.coord = {n: int(c) for n, c in zip(self.axis_names, here)}
        self._axes = {}
        for i, name in enumerate(self.axis_names):
            mine, mine_group = None, None
            others = [range(d) for j, d in enumerate(dims) if j != i]
            for rest in itertools.product(*others):
                ranks = []
                for k in range(dims[i]):
                    c = list(rest)
                    c.insert(i, k)
                    ranks.append(int(np.ravel_multi_index(tuple(c), dims)))
                g = (dist.new_group(ranks) if groups and dims[i] > 1
                     else None)
                if self.rank in ranks:
                    mine, mine_group = ranks, g
            self._axes[name] = Axis(name, mine, self.coord[name], mine_group,
                                    self.backend, self.stats)

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank}, {self.backend})"

    def axis(self, name: str) -> Axis:
        if name in self._axes:
            return self._axes[name]
        return Axis(name, (self.rank,), 0, None, self.backend, self.stats)

    def size_of(self, name: str) -> int:
        return self.shape.get(name, 1)

    def reset_stats(self) -> None:
        self.stats.clear()

    def stats_summary(self) -> dict:
        """{"axis.op.site": {"calls", "bytes", "staged_bytes", "ms"}}."""
        return {".".join(k): {"calls": v.calls, "bytes": v.bytes,
                              "staged_bytes": v.staged_bytes,
                              "ms": v.seconds * 1e3}
                for k, v in sorted(self.stats.items())}


def make_mesh(dp: int, tp: int, sp: int = 1, **kw) -> Mesh:
    """dp x tp mesh, or dp x sp x tp when sp > 1 (tp innermost)."""
    if sp == 1:
        return Mesh(("dp", "tp"), (dp, tp), **kw)
    return Mesh(("dp", "sp", "tp"), (dp, sp, tp), **kw)


def make_pp_mesh(pp: int, tp: int = 1, **kw) -> Mesh:
    """pp x tp mesh (the JAX callers' Mesh(devs.reshape(pp, tp),
    ("pp", "tp")))."""
    return Mesh(("pp", "tp"), (pp, tp), **kw)
