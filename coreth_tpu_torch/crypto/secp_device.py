"""Device-batched ECDSA recovery — host orchestration.

Port of reference ``crypto/secp_device.py``.  Recovery splits three ways:

  1. host: range checks and u1/u2 = (-z/r, s/r) mod n via one Montgomery
     batch inversion (C++ ``recover_prep``);
  2. device, one launch per chunk (``ops/secp.recover_kernel``):
     y = sqrt(x^3+7), parity select, the G+R table entry and the Shamir
     ladder u1*G + u2*R;
  3. host: Jacobian -> affine via one more batch inversion, then keccak
     (C++ ``recover_finish``).

``issue_recover`` uploads each chunk through pinned host buffers, launches
the kernel and starts the (B, 102) result's copy back into pinned memory,
recording a CUDA event — all without blocking, so the caller can queue
window executions behind it.  ``complete_recover`` waits on each chunk's
event before it reads the rows: reading earlier would see stale bytes.

Rows the ladder flags as doubling collisions (addend == accumulator:
statistically negligible, constructible adversarially) re-run on the
exact host path.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from coreth_tpu_torch.crypto import native
from coreth_tpu_torch.crypto import secp256k1 as _ref
from coreth_tpu_torch.ops import secp as S

# Largest single kernel launch: bigger batches are chunked so the pow2
# padding waste and the set of batch shapes stay bounded.
MAX_CHUNK = 4096


def _pad_pow2(n: int, floor: int = 64) -> int:
    b = max(n, floor)
    return 1 << (b - 1).bit_length()


def issue_recover(hashes: bytes, rs: bytes, ss: bytes, recids: bytes,
                  device: torch.device, kernel=None) -> list:
    """Host prep + asynchronous kernel launch for a packed signature
    batch on ``device``; pass the result to ``complete_recover``.
    ``kernel`` (default ``ops.secp.recover_kernel``) runs the ladder on a
    chunk: the engine passes the sharded ladder (``sharded_recover``)
    on a mesh."""
    n = len(recids)
    ctxs = []
    for lo in range(0, n, MAX_CHUNK):
        hi = min(lo + MAX_CHUNK, n)
        ctxs.append(_issue_chunk(
            hashes[32 * lo:32 * hi], rs[32 * lo:32 * hi],
            ss[32 * lo:32 * hi], recids[lo:hi], device,
            kernel or S.recover_kernel))
    return ctxs


def complete_recover(ctxs: list) -> Tuple[bytes, bytes]:
    """Wait for issued chunks; returns (addresses, ok) packed bytes."""
    addrs = bytearray()
    okb = bytearray()
    for ctx in ctxs:
        a, o = _complete_chunk(ctx)
        addrs += a
        okb += o
    return bytes(addrs), bytes(okb)


def _issue_chunk(hashes: bytes, rs: bytes, ss: bytes, recids: bytes,
                 device: torch.device, kernel) -> dict:
    n = len(recids)
    xs_le, u1_le, u2_le, okb = native.recover_prep(hashes, rs, ss, recids)
    pad = _pad_pow2(n)
    cuda = device.type == "cuda"
    x = torch.zeros((pad, 33), dtype=torch.uint8, pin_memory=cuda)
    parity = torch.zeros((pad,), dtype=torch.int32, pin_memory=cuda)
    u1 = torch.zeros((pad, 8), dtype=torch.int32, pin_memory=cuda)
    u2 = torch.zeros((pad, 8), dtype=torch.int32, pin_memory=cuda)
    x[:n] = torch.from_numpy(
        np.frombuffer(xs_le, dtype=np.uint8).reshape(n, 33).copy())
    parity[:n] = torch.from_numpy(
        np.frombuffer(recids, dtype=np.uint8).astype(np.int32) & 1)
    u1[:n] = torch.from_numpy(
        np.frombuffer(u1_le, dtype="<u4").reshape(n, 8).astype(np.int32))
    u2[:n] = torch.from_numpy(
        np.frombuffer(u2_le, dtype="<u4").reshape(n, 8).astype(np.int32))
    host = (x, parity, u1, u2)
    dev_in = [t.to(device, non_blocking=True) for t in host]
    out = kernel(*dev_in)
    event = None
    if cuda:
        rows = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
        rows.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    else:
        rows = out
    return dict(n=n, rows=rows, event=event, ok=okb, hashes=hashes, rs=rs,
                ss=ss, recids=recids, keep=(host, dev_in, out))


def _redo_collision(hashes, rs, ss, recids, i, addrs, okb) -> None:
    """Ladder doubling-collision row: exact host re-run (rare)."""
    try:
        addr = _ref.recover_address_py(
            hashes[32 * i:32 * i + 32],
            int.from_bytes(rs[32 * i:32 * i + 32], "big"),
            int.from_bytes(ss[32 * i:32 * i + 32], "big"), recids[i])
    except ValueError:
        return
    addrs[20 * i:20 * i + 20] = addr
    okb[i] = 1


def _complete_chunk(ctx: dict) -> Tuple[bytes, bytes]:
    n = ctx["n"]
    if ctx["event"] is not None:
        ctx["event"].synchronize()
    rows = ctx["rows"][:n].numpy().tobytes()
    addrs_b, okb_b = native.recover_finish(rows, n, ctx["ok"])
    addrs = bytearray(addrs_b)
    okb = bytearray(okb_b)
    collided: List[int] = [i for i in range(n) if okb[i] == 2]
    for i in collided:
        okb[i] = 0
        _redo_collision(ctx["hashes"], ctx["rs"], ctx["ss"],
                        ctx["recids"], i, addrs, okb)
    return bytes(addrs), bytes(okb)
