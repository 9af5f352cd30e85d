"""Batched keccak-256 — the plain PyTorch version of K3 and its wrapper.

Port of reference ``ops/keccak.py`` (``keccak_f1600`` and
``keccak256_blocks``).  The reference holds each 64-bit lane as a
(lo, hi) uint32 pair because the TPU has no 64-bit integer datapath;
the plain version here works on int64 lanes (torch has no full uint64
arithmetic, and int64 XOR/AND/NOT/shift give the same bits), and the
CUDA twin (``csrc/keccak.cuh``) on native ``uint64_t`` lanes.

Interface (as the reference): ``blocks`` (B, nb, 34) 32-bit words of
host-padded messages (pad10*1 already applied in the last real block),
``nblocks`` (B,) real block counts >= 1; returns (B, 8) digest words,
little-endian.  Words travel as int32 tensors holding the uint32 bit
patterns (``.numpy().view(np.uint32)`` reads them back).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from coreth_tpu_torch import kernels


def _derive_schedule():
    """Round constants (LFSR) and the rho rotations / pi permutation."""
    rc = []
    r = 1
    for _ in range(24):
        v = 0
        for j in range(7):
            r = ((r << 1) ^ ((r >> 7) * 0x71)) % 256
            if r & 2:
                v ^= 1 << ((1 << j) - 1)
        rc.append(v)
    rho = [0] * 25
    x, y = 1, 0
    for t in range(24):
        rho[x + 5 * y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    pi_src = [0] * 25
    for xx in range(5):
        for yy in range(5):
            pi_src[yy + 5 * ((2 * xx + 3 * yy) % 5)] = xx + 5 * yy
    return rc, rho, pi_src


_RC, _RHO, _PI_SRC = _derive_schedule()


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


_RC_S64 = [_signed64(v) for v in _RC]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """64-bit rotate left of int64 lanes by a constant amount."""
    r %= 64
    if r == 0:
        return x
    return (x << r) | ((x >> (64 - r)) & ((1 << r) - 1))


def keccak_f1600(state: torch.Tensor) -> torch.Tensor:
    """The keccak-f[1600] permutation over (..., 25) int64 lanes
    (lane index x + 5*y)."""
    a = [state[..., i] for i in range(25)]
    for rnd in range(24):
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [_rotl(a[_PI_SRC[i]], _RHO[_PI_SRC[i]]) for i in range(25)]
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)]
                     & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
             for i in range(25)]
        a[0] = a[0] ^ _RC_S64[rnd]
    return torch.stack(a, dim=-1)


def _words_to_lanes(words: torch.Tensor) -> torch.Tensor:
    """(..., 34) int32 words (uint32 bits) -> (..., 17) int64 lanes."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return w[..., 0::2] | (w[..., 1::2] << 32)


def keccak256_blocks_plain(blocks: torch.Tensor,
                           nblocks: torch.Tensor) -> torch.Tensor:
    """Plain version of ``keccak256_blocks`` (masked absorb: finished
    items keep their state frozen)."""
    batch, max_blocks = blocks.shape[0], blocks.shape[1]
    state = torch.zeros((batch, 25), dtype=torch.int64,
                        device=blocks.device)
    for i in range(max_blocks):
        absorbed = state.clone()
        absorbed[:, :17] ^= _words_to_lanes(blocks[:, i, :])
        absorbed = keccak_f1600(absorbed)
        keep = (i < nblocks)[:, None]
        state = torch.where(keep, absorbed, state)
    lanes = state[:, :4]
    lo = lanes & 0xFFFFFFFF
    hi = (lanes >> 32) & 0xFFFFFFFF
    out = torch.stack([lo, hi], dim=-1).reshape(batch, 8)
    # back to int32 bit patterns
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


LAUNCHES = 0


def keccak256_blocks(blocks: torch.Tensor,
                     nblocks: torch.Tensor) -> torch.Tensor:
    """keccak-256 of host-padded multi-block messages: the CUDA launch
    entry (``csrc/keccak256_blocks.cu``, two threads a message, each
    holding one 32-bit half of the state) for CUDA tensors, the plain
    version for CPU tensors."""
    dev = blocks.device
    if (blocks.dtype != torch.int32 or nblocks.dtype != torch.int32
            or nblocks.device != dev or blocks.dim() != 3
            or blocks.shape[2] != 34 or nblocks.shape != blocks.shape[:1]):
        raise ValueError("keccak256_blocks: blocks (B, nb, 34) int32 and "
                         f"nblocks (B,) int32 on one device, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}, "
                         f"{tuple(nblocks.shape)} {nblocks.dtype}")
    if dev.type == "cpu":
        return keccak256_blocks_plain(blocks, nblocks)
    if dev.type != "cuda":
        raise ValueError(f"keccak256_blocks: unsupported device {dev}")
    global LAUNCHES
    lib = kernels.load("keccak256_blocks")
    blocks, nblocks = blocks.contiguous(), nblocks.contiguous()
    out = torch.empty((blocks.shape[0], 8), dtype=torch.int32, device=dev)
    rc = lib.keccak256_blocks_launch(
        blocks.data_ptr(), nblocks.data_ptr(), out.data_ptr(),
        blocks.shape[0], blocks.shape[1],
        kernels.raw_stream(blocks.get_device()))
    kernels.check(rc, "keccak256_blocks")
    LAUNCHES += 1
    return out


# --------------------------------------------------- host-side packing

def pack_blocks(msgs: List[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Pack variable-length messages (keccak padding applied) as
    ((B, max_blocks, 34) int32 words, (B,) int32 block counts)."""
    nblocks = np.array([len(m) // 136 + 1 for m in msgs], dtype=np.int32)
    max_blocks = int(nblocks.max()) if len(msgs) else 1
    buf = np.zeros((len(msgs), max_blocks * 136), dtype=np.uint8)
    for i, m in enumerate(msgs):
        buf[i, :len(m)] = np.frombuffer(m, dtype=np.uint8)
        buf[i, len(m)] ^= 0x01
        buf[i, nblocks[i] * 136 - 1] ^= 0x80
    return (buf.view(np.int32).reshape(len(msgs), max_blocks, 34),
            nblocks)


def digests(words) -> List[bytes]:
    """(B, 8) digest words (tensor or array) -> 32-byte digests."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    w = np.ascontiguousarray(words).view(np.uint32)
    return [w[i].tobytes() for i in range(w.shape[0])]
