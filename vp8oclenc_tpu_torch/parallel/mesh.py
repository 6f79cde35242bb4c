"""A rank's place in the multi-GPU layout, and the exchanges between ranks:
the counterpart of the JAX package's parallel/mesh.py over
torch.distributed, one process per rank.

The world is a (gop, tile) grid, rank = g * tile + t:
  * gop  -- data parallelism over independent keyframe-aligned GOPs: each
            gop lane (the `tile` ranks of one g) encodes its own GOPs and
            talks to no other lane until the payloads are collected;
  * tile -- row shards of every frame of the lane's GOPs: halo rows,
            all-gathers and the filter's hand-off go over the lane's tile
            group, and rank t = 0 of the lane (its leader) assembles and
            entropy-codes the frames.

The backend is the caller's choice: "nccl" between distinct cards, "gloo"
on the CPU or for ranks that share one card (NCCL refuses two ranks on one
device).  Under gloo every tensor travels through host buffers, pinned
for a CUDA tensor, in this module's helpers.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def default_split(world: int, gop: int | None = None,
                  tile: int | None = None) -> tuple:
    """(gop, tile) of a world: the JAX package's make_mesh rule, favouring
    GOP parallelism (no traffic) and a tile factor of 2 when the world is
    even and larger than 1."""
    if gop is None or tile is None:
        tile = tile or (2 if world % 2 == 0 and world > 1 else 1)
        gop = world // tile
    if gop * tile != world:
        raise ValueError(f"layout {gop}x{tile} != {world} ranks")
    return gop, tile


class Layout:
    """This rank's (g, t) coordinates, its lane's tile group and leader,
    its device, and the transfers the multi-GPU layer makes.  Every rank of
    the world constructs it at once (the tile groups are made
    collectively)."""

    def __init__(self, backend: str, device, gop: int | None = None,
                 tile: int | None = None) -> None:
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                             f"{backend!r}")
        self.backend = backend
        self.device = torch.device(device)
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.gop, self.tile = default_split(self.world, gop, tile)
        self.g, self.t = divmod(self.rank, self.tile)
        groups = [dist.new_group(list(range(g * self.tile,
                                            (g + 1) * self.tile)))
                  for g in range(self.gop)]
        self.tile_group = groups[self.g]
        self.lane_ranks = list(range(self.g * self.tile,
                                     (self.g + 1) * self.tile))
        self.leader = self.lane_ranks[0]

    @property
    def is_leader(self) -> bool:
        return self.rank == self.leader

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """t as the backend carries it: under gloo on the host (a pinned
        copy of a CUDA tensor), under NCCL on the rank's device."""
        if self.backend == "nccl" or t.device.type == "cpu":
            return t.contiguous()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def _home(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device)

    def exchange(self, sends: dict, recvs: dict) -> dict:
        """Point-to-point transfers with the ranks of this lane's tile
        group, all posted at once: sends {tile index: [tensors]}, recvs
        {tile index: [(shape, dtype)]}.  The tensors for one peer travel as
        one byte buffer.  Returns {tile index: [tensors]} on the device."""
        ops, bufs = [], {}
        for s, ts in sends.items():
            flat = torch.cat([t.contiguous().view(torch.uint8).reshape(-1)
                              for t in ts])
            ops.append(dist.P2POp(dist.isend, self._wire(flat),
                                  self.lane_ranks[s]))
        for s, specs in recvs.items():
            n = sum(_nbytes(shape, dt) for shape, dt in specs)
            buf = torch.empty(n, dtype=torch.uint8,
                              device="cpu" if self.backend == "gloo"
                              else self.device)
            bufs[s] = buf
            ops.append(dist.P2POp(dist.irecv, buf, self.lane_ranks[s]))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        out = {}
        for s, specs in recvs.items():
            buf, o, got = self._home(bufs[s]), 0, []
            for shape, dt in specs:
                n = _nbytes(shape, dt)
                got.append(buf[o:o + n].clone().view(dt).reshape(shape))
                o += n
            out[s] = got
        return out

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The tile group's tensors of t's shape, stacked along dim 0 in
        tile order."""
        if self.tile == 1:
            return t
        w = self._wire(t)
        parts = [torch.empty_like(w) for _ in range(self.tile)]
        dist.all_gather(parts, w, group=self.tile_group)
        return self._home(torch.cat(parts))

    def all_reduce_min(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise minimum of t over the tile group."""
        if self.tile == 1:
            return t
        w = self._wire(t).clone()
        dist.all_reduce(w, op=dist.ReduceOp.MIN, group=self.tile_group)
        return self._home(w)

    def broadcast_flag(self, flag: bool) -> bool:
        """The leader's flag, on every rank of the lane."""
        if self.tile == 1:
            return flag
        w = torch.tensor([int(flag)], dtype=torch.int32,
                         device="cpu" if self.backend == "gloo"
                         else self.device)
        dist.broadcast(w, src=self.leader, group=self.tile_group)
        return bool(w.item())


def _nbytes(shape, dtype) -> int:
    n = torch.empty((), dtype=dtype).element_size()
    for d in shape:
        n *= d
    return n
