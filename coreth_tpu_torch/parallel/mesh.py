"""Shards on one card: the mesh, its collective reduce, and the
per-block sharded steps.

Port of reference ``parallel/mesh.py`` (``make_mesh``,
``collective_reduce``, ``sharded_transfer_step``, ``sharded_slot_step``).
The reference shards replay over a ``dp`` axis of devices; the port runs
the ``n`` shards on one GPU, as the CTAs of one thread-block cluster
(``csrc/sharded_window.cu``), so a mesh is only its width and the device
the shards' tensors live on.  A collective is
a reduction over the shards' tensors: ``collective_reduce_plain`` is its
plain version, the one the sharded window's plain version uses.  There
is no NCCL.

The per-block steps (K8s) are the reference's older mesh program, the
one its multichip dry run drives: each tx shard segment-sums its
effects over the full table width, one ``psum_scatter`` reduces them
onto the row sharding, nonces check against an ``all_gather`` of the
nonce row, and a ``psum`` ANDs the shards' flags.  Their plain versions
run shard by shard as the reference does; the result does not depend on
n (integer sums, an AND of the checks), so on the card each step is one
row-parallel launch of ``csrc/sharded_step.cu`` over every SM, the same
launch at every n.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from coreth_tpu_torch import kernels
from coreth_tpu_torch.ops import u256

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


# ---------------------------------------------- K8s: the per-block step
# a limb sum takes at most 2 * B adds of < 2^16 (values and fees at the
# coinbase row): B <= 16384 keeps it inside int32, as the reference's
# int32 segment sums need (engine.py:302)
MAX_STEP_TXS = 1 << 14
TRANSFER_STEP_LAUNCHES = 0
SLOT_STEP_LAUNCHES = 0


def segment_sum(vals: torch.Tensor, idx: torch.Tensor,
                num: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: int32 sums of vals at idx into ``num``
    rows, out-of-range indices dropped."""
    ok = (idx >= 0) & (idx < num)
    out = torch.zeros((num,) + tuple(vals.shape[1:]), dtype=torch.int32,
                      device=vals.device)
    return out.index_add_(0, idx[ok].long(), vals[ok])


def gather_index(idx: torch.Tensor, num: int) -> torch.Tensor:
    """The rows a jnp gather of ``num`` rows reads at ``idx`` (int64): a
    negative index counts from the end, then the index clamps to
    [0, num - 1]; -2 reads row num - 2, -(num + 3) row 0."""
    idx = idx.long()
    return torch.where(idx < 0, idx + num, idx).clamp(0, num - 1)


def _shard_rows(parts: torch.Tensor, n: int) -> torch.Tensor:
    """``psum_scatter(tiled=True)`` of the shards' full-width partials
    [n, R, ...]: the sum (``collective_reduce_plain``), shard d keeping
    rows [d*R/n, (d+1)*R/n); returns them in shard order, [R, ...]."""
    tot = collective_reduce_plain(parts)
    rows = parts.shape[1] // n
    return torch.cat([tot[d, d * rows:(d + 1) * rows] for d in range(n)])


def _check_step(what: str, n: int, rows: int, B: int, kind: str) -> None:
    if rows % n or B % n:
        raise ValueError(f"{what}: {rows} {kind} rows and {B} txs must "
                         f"divide by the mesh width {n}")
    if B > MAX_STEP_TXS:
        raise ValueError(f"{what}: {B} txs past the int32 segment-sum "
                         f"headroom ({MAX_STEP_TXS})")


def _coinbase_row(coinbase_idx, A: int) -> int:
    """The coinbase row as the reference's ``.at[coinbase_idx]`` takes
    it: a negative index counts from the end; out of range, no fee
    credit (the caller's in-range test drops it)."""
    cb = int(coinbase_idx)
    return cb + A if cb < 0 else cb


def sharded_transfer_step_plain(balances, nonces, sender_idx, recip_idx,
                                value16, fee16, required16, tx_nonce,
                                nonce_offset, mask, coinbase_idx,
                                n: int):
    """Plain PyTorch version of K8s's transfer half (reference
    ``sharded_transfer_step``'s body), shard by shard: shard d owns tx
    rows [d*B/n, (d+1)*B/n) and account rows [d*A/n, (d+1)*A/n).  Each
    shard forms full-width partial sums of its txs (its fees at the
    coinbase row before any normalize), the partials are reduced onto
    the account sharding, nonces check against the whole nonce row, and
    ``ok`` is the AND of every shard's flag."""
    A, B = balances.shape[0], sender_idx.shape[0]
    _check_step("sharded_transfer_step", n, A, B, "account")
    b = B // n
    cb = _coinbase_row(coinbase_idx, A)
    parts, nonce_ok = [], []
    for d in range(n):
        t = slice(d * b, (d + 1) * b)
        m = mask[t].bool()
        mask_i = m.to(torch.int32)[:, None]
        debit = u256.add(value16[t], fee16[t]) * mask_i
        debit_p = segment_sum(debit, sender_idx[t], A)
        req_p = segment_sum(required16[t] * mask_i, sender_idx[t], A)
        credit_p = segment_sum(value16[t] * mask_i, recip_idx[t], A)
        if 0 <= cb < A:
            credit_p[cb] += (fee16[t] * mask_i).sum(0, dtype=torch.int32)
        counts_p = segment_sum(mask_i, sender_idx[t], A)
        parts.append(torch.cat([debit_p, req_p, credit_p, counts_p], dim=1))
        expected = nonces[gather_index(sender_idx[t], A)] + nonce_offset[t]
        nonce_ok.append(bool(torch.all(torch.where(m, tx_nonce[t] == expected,
                                                   True))))
    tot = _shard_rows(torch.stack(parts), n)
    debit_t = u256.normalize(tot[:, 0:16])
    req_t = u256.normalize(tot[:, 16:32])
    credit_t = u256.normalize(tot[:, 32:48])
    counts = tot[:, 48]
    solvent = u256.gte(balances, req_t) | (counts == 0)
    rows = A // n
    ok = all(nonce_ok[d] and bool(torch.all(solvent[d * rows:(d + 1) * rows]))
             for d in range(n))
    new_balances = u256.sub(u256.add(balances, credit_t), debit_t)
    return new_balances, nonces + counts, torch.tensor(ok,
                                                       device=balances.device)


def sharded_slot_step_plain(slot_vals, from_slot, to_slot, amount16, mask,
                            n: int):
    """Plain PyTorch version of K8s's slot half (reference
    ``sharded_slot_step``'s body), shard by shard as
    ``sharded_transfer_step_plain``: full-width debit and credit partials
    per tx shard, reduced onto the slot sharding, solvency of every
    slot row."""
    S, B = slot_vals.shape[0], from_slot.shape[0]
    _check_step("sharded_slot_step", n, S, B, "slot")
    b = B // n
    parts = []
    for d in range(n):
        t = slice(d * b, (d + 1) * b)
        amt = amount16[t] * mask[t].to(torch.int32)[:, None]
        parts.append(torch.cat([segment_sum(amt, from_slot[t], S),
                                segment_sum(amt, to_slot[t], S)], dim=1))
    tot = _shard_rows(torch.stack(parts), n)
    debit_t = u256.normalize(tot[:, 0:16])
    credit_t = u256.normalize(tot[:, 16:32])
    ok = bool(torch.all(u256.gte(slot_vals, debit_t)))
    new_vals = u256.sub(u256.add(slot_vals, credit_t), debit_t)
    return new_vals, torch.tensor(ok, device=slot_vals.device)


def _step_device(mesh: ShardMesh, table) -> tuple:
    """The device a step runs on (the mesh's, else the table's) and the
    index ``Tensor.get_device()`` reports there (-1 on the CPU); another
    device type raises ``ValueError``."""
    dev = mesh.device or torch.as_tensor(table).device
    if dev.type == "cpu":
        return dev, -1
    if dev.type != "cuda":
        raise ValueError(f"sharded step: unsupported device {dev}")
    return dev, (torch.cuda.current_device() if dev.index is None
                 else dev.index)


def _as_i32(x, dev: torch.device, di: int) -> torch.Tensor:
    """``x`` as a contiguous int32 tensor on ``dev`` (index ``di``):
    itself when it is one already (the cheap checks first: a call's
    host work is most of its time on the card)."""
    if type(x) is torch.Tensor and x.dtype is torch.int32 \
            and x.get_device() == di and x.is_contiguous():
        return x
    return torch.as_tensor(x).to(dev, torch.int32).contiguous()


def _table(x, dev: torch.device, di: int) -> torch.Tensor:
    """A table for the kernel's 16-byte row loads: int32, contiguous, on
    ``dev``, at a 16-byte aligned address (a copy when it is not)."""
    t = _as_i32(x, dev, di)
    return t if t.data_ptr() % 16 == 0 else t.clone()


def step_design(rows: int, slot: bool = False) -> dict:
    """The launch K8s's kernel takes for a table of ``rows`` rows, the
    same at every mesh width: rows a CTA, CTAs, dynamic shared memory a
    CTA (bytes)."""
    import ctypes
    out = (ctypes.c_int * 3)()
    kernels.check(kernels.load("sharded_step").sharded_step_design(
        rows, int(slot), out), "sharded_step_design")
    return {"rows_per_cta": out[0], "ctas": out[1], "smem_bytes": out[2]}


def sharded_transfer_step(mesh: ShardMesh, num_accounts: int):
    """The mesh-sharded transfer step (reference ``sharded_transfer_step``):
    returns a function (balances [A,16], nonces [A], sender_idx,
    recip_idx, value16, fee16, required16, tx_nonce, nonce_offset, mask,
    coinbase_idx) -> (new_balances, new_nonces, ok), A = num_accounts,
    ok a 0-dim bool tensor.  It runs on the mesh's device, else on the
    device of ``balances``: on CUDA one launch of K8s's transfer kernel
    (``csrc/sharded_step.cu``, over every SM whatever n, asynchronous on
    the current stream), on the CPU the plain version.  A and the batch
    must divide by n."""
    n = mesh.n_shards
    if num_accounts % n:
        raise ValueError(f"sharded_transfer_step: {num_accounts} accounts "
                         f"do not divide by the mesh width {n}")

    def step(balances, nonces, sender_idx, recip_idx, value16, fee16,
             required16, tx_nonce, nonce_offset, mask, coinbase_idx):
        global TRANSFER_STEP_LAUNCHES
        dev, di = _step_device(mesh, balances)
        bal, non = _table(balances, dev, di), _as_i32(nonces, dev, di)
        cols = [_as_i32(x, dev, di) for x in (
            sender_idx, recip_idx, value16, fee16, required16, tx_nonce,
            nonce_offset, mask)]
        A, B = bal.shape[0], cols[0].shape[0]
        if A != num_accounts or bal.shape[1:] != (u256.LIMBS,) \
                or non.shape != (A,):
            raise ValueError(f"sharded_transfer_step: tables of {A} rows, "
                             f"built for {num_accounts}")
        _check_step("sharded_transfer_step", n, A, B, "account")
        if dev.type == "cpu":
            return sharded_transfer_step_plain(bal, non, *cols,
                                               coinbase_idx, n)
        new_bal, new_non = torch.empty_like(bal), torch.empty_like(non)
        ok = non.new_empty((), dtype=torch.bool)
        rc = kernels.load("sharded_step").sharded_transfer_step_launch(
            bal.data_ptr(), non.data_ptr(), *(c.data_ptr() for c in cols),
            _coinbase_row(coinbase_idx, A), A, B, new_bal.data_ptr(),
            new_non.data_ptr(), ok.data_ptr(), kernels.raw_stream(di))
        kernels.check(rc, "sharded_transfer_step")
        TRANSFER_STEP_LAUNCHES += 1
        return new_bal, new_non, ok
    return step


def sharded_slot_step(mesh: ShardMesh, num_slots: int):
    """The mesh-sharded ERC-20 slot step (reference ``sharded_slot_step``):
    returns a function (slot_vals [S,16], from_slot, to_slot, amount16,
    mask) -> (new_vals, ok), S = num_slots; devices, launch and ok as
    ``sharded_transfer_step`` (K8s's slot kernel on CUDA)."""
    n = mesh.n_shards
    if num_slots % n:
        raise ValueError(f"sharded_slot_step: {num_slots} slots do not "
                         f"divide by the mesh width {n}")

    def step(slot_vals, from_slot, to_slot, amount16, mask):
        global SLOT_STEP_LAUNCHES
        dev, di = _step_device(mesh, slot_vals)
        vals = _table(slot_vals, dev, di)
        cols = [_as_i32(x, dev, di) for x in (from_slot, to_slot, amount16,
                                              mask)]
        S, B = vals.shape[0], cols[0].shape[0]
        if S != num_slots or vals.shape[1:] != (u256.LIMBS,):
            raise ValueError(f"sharded_slot_step: a table of {S} rows, "
                             f"built for {num_slots}")
        _check_step("sharded_slot_step", n, S, B, "slot")
        if dev.type == "cpu":
            return sharded_slot_step_plain(vals, *cols, n)
        new_vals = torch.empty_like(vals)
        ok = vals.new_empty((), dtype=torch.bool)
        rc = kernels.load("sharded_step").sharded_slot_step_launch(
            vals.data_ptr(), *(c.data_ptr() for c in cols), S, B,
            new_vals.data_ptr(), ok.data_ptr(), kernels.raw_stream(di))
        kernels.check(rc, "sharded_slot_step")
        SLOT_STEP_LAUNCHES += 1
        return new_vals, ok
    return step
