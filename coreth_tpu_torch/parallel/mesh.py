"""Shards on one card: the mesh and its collective reduce.

Port of reference ``parallel/mesh.py`` (``make_mesh``,
``collective_reduce``).  The reference shards replay over a ``dp`` axis
of devices; the port runs the ``n`` shards on one GPU, as the CTAs of
one thread-block cluster (``csrc/sharded_window.cu``), so a mesh is only
its width and the device the shards' tensors live on.  A collective is
a reduction over the shards' tensors: ``collective_reduce_plain`` is its
plain version, the one the sharded window's plain version uses.  There
is no NCCL.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

# the largest thread-block cluster the CUDA kernel may use portably
MAX_SHARDS = 8


@dataclass(frozen=True)
class ShardMesh:
    """``n_shards`` shards of replay state on one ``device`` (None: the
    device of the tensors handed to the kernels)."""

    n_shards: int
    device: Optional[torch.device] = None


def make_mesh(n: int, device=None) -> ShardMesh:
    """A mesh of ``n`` shards: a power of two, at most ``MAX_SHARDS``;
    anything else raises ``ValueError``."""
    if not isinstance(n, int) or n < 1 or n & (n - 1) or n > MAX_SHARDS:
        raise ValueError(f"make_mesh: {n!r} shards; the width must be a "
                         f"power of two in [1, {MAX_SHARDS}]")
    return ShardMesh(n, None if device is None else torch.device(device))


def collective_reduce_plain(parts: torch.Tensor, mode: str = "psum",
                            op: str = "add") -> torch.Tensor:
    """Reduce ``parts`` ([n, ...] int32, shard d's contribution at d)
    over the shard axis; returns [n, ...], shard d's result at d.

    ``"psum"``: every shard sums the parts in shard order.
    ``"ppermute"``: the reference's ring (``mesh.py:77-91``): each of
    n-1 steps passes every shard's payload one hop to shard d+1, which
    accumulates it, so shard d sums d, d-1, d-2, ... .  ``op`` is
    ``"add"`` (int32, wrapping) or ``"max"``.  Both orders give equal
    results: integer add and max are associative and commutative."""
    if op not in ("add", "max"):
        raise ValueError(f"collective_reduce_plain: unknown op {op!r}")
    if mode not in ("psum", "ppermute"):
        raise ValueError(f"collective_reduce_plain: unknown mode {mode!r}")
    f = torch.add if op == "add" else torch.maximum
    n = parts.shape[0]
    if mode == "psum" or n <= 1:
        acc = parts[0]
        for d in range(1, n):
            acc = f(acc, parts[d])
        return acc.unsqueeze(0).expand_as(parts).clone()
    acc, x = parts.clone(), parts
    for _ in range(n - 1):
        x = torch.roll(x, 1, dims=0)
        acc = f(acc, x)
    return acc
