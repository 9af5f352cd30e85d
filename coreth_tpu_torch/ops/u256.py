"""256-bit integer arithmetic on 16-bit limbs held in int32 tensors.

Port of reference ``ops/u256.py``.  Values are int32 tensors of shape
(..., 16): limb i holds bits [16*i, 16*i+16) (little-endian limbs), each
in [0, 2^16).  The 16-bit-in-int32 layout gives headroom for segment sums
over up to 2^15 operands before one carry renormalization — the pattern
the replay engine uses for per-account debit/credit aggregation.  The
CUDA transfer-window kernel inlines the same carry and borrow chains as
device functions (``csrc/transfer_window.cu``).
"""

from __future__ import annotations

import numpy as np
import torch

LIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def pack_np(values) -> np.ndarray:
    """Python ints -> (n, 16) numpy int32 limb array."""
    blob = b"".join(v.to_bytes(32, "little") for v in values)
    return np.frombuffer(blob, dtype=np.uint16).reshape(
        len(values), LIMBS).astype(np.int32)


def from_ints(values, *, device) -> torch.Tensor:
    """Python ints -> (n, 16) int32 limb tensor on ``device`` (a
    required keyword: no entry point picks the CPU unasked)."""
    return torch.from_numpy(pack_np(values)).to(device)


def to_ints(arr) -> list:
    """(n, 16) limb array or tensor -> Python ints (host-side)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    a = np.asarray(arr, dtype=np.int64)
    if a.size == 0:
        return []
    blob = a.astype(np.uint16).tobytes()
    return [int.from_bytes(blob[i * 32:(i + 1) * 32], "little")
            for i in range(a.shape[0])]


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Propagate carries so every limb lands in [0, 2^16); the carry out
    of the top limb is dropped (mod 2^256).

    A sequential 16-step running carry: a fixed number of parallel
    passes is not enough, since 0xFFFF,...,0xFFFF + 1 ripples the full
    width.  Handles any nonnegative limb magnitude that fits int32."""
    out = []
    carry = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        v = x[..., i] + carry
        out.append(v & LIMB_MASK)
        carry = v >> LIMB_BITS
    return torch.stack(out, dim=-1)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod 2^256, both normalized."""
    return normalize(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod 2^(16*limbs) (the caller checks a >= b with gte)."""
    diff = a - b
    limbs = []
    borrow = torch.zeros(a.shape[:-1], dtype=torch.int32, device=a.device)
    for i in range(a.shape[-1]):
        limb = diff[..., i] - borrow
        borrow = (limb < 0).to(torch.int32)
        limbs.append(limb + (borrow << LIMB_BITS))
    return torch.stack(limbs, dim=-1)


def gte(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b elementwise over the last axis (both normalized):
    lexicographic compare from the most-significant limb."""
    decided = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    result = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for i in range(a.shape[-1] - 1, -1, -1):
        gt = a[..., i] > b[..., i]
        lt = a[..., i] < b[..., i]
        result = torch.where(~decided & gt, True, result)
        result = torch.where(~decided & lt, False, result)
        decided = decided | gt | lt
    return result


def mul_small(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """a * k for k < 2^15 (the per-limb product fits int32)."""
    return normalize(a * k[..., None])


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(a == 0, dim=-1)
