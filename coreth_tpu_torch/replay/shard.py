"""Sharded transfer windows: shard-major state tables and one packed
effect reduce per block.

Port of reference ``replay/shard.py``, the sharded twin of the transfer
window (``engine._transfer_window``, K1):

- the balance, nonce and slot tables are shard-major: shard ``d`` owns
  rows ``[d*arena, (d+1)*arena)`` (``parallel/shard.py`` bucketing by
  keccak(address));
- one launch covers a window: each shard gathers the window rows it
  owns, and one add-reduce replicates the working set;
- per block, each shard sums the effects of its own slice of the
  interleaved tx axis (debit | buyGas requirement | credit | send count,
  and the slot debit | credit pair); ONE reduce of the packed effect
  tensor (psum, or a ring of n-1 ppermute steps) is the cross-shard
  exchange; validation runs on the replicated rows; the fetch tensor
  comes out in the single-device layout, so the engine's
  ``_complete_window_run`` is shared;
- every sum is an int32 add, so every width and both modes give
  bit-identical tables, fetches and roots.

On one card the shards are the CTAs of one thread-block cluster
(``csrc/sharded_window.cu``, K8); ``_sharded_window_plain`` is its plain
version, per shard exactly as the reference's ``_build_window``.
"""

from __future__ import annotations

import numpy as np
import torch

from coreth_tpu_torch import kernels
from coreth_tpu_torch.ops import u256
from coreth_tpu_torch.parallel.mesh import (
    MAX_SHARDS, collective_reduce_plain, gather_index,
)
from coreth_tpu_torch.replay.engine import (
    ACCW, _gather_fetch, check_window_args,
)

LAUNCHES = 0


def interleave_txs(P: int, n: int) -> np.ndarray:
    """Permutation putting txs d, d+n, d+2n, ... into shard d's block of
    the tx axis: real lanes sit in the padded prefix, so a contiguous
    split would starve the high shards."""
    return np.arange(P).reshape(-1, n).T.reshape(-1)


def _seg_sum(vals: torch.Tensor, idx: torch.Tensor, num: int) -> torch.Tensor:
    """Per-shard segment sums: vals [n, m, w] at idx [n, m] into
    [n, num, w] int32, out-of-range indices dropped."""
    n = vals.shape[0]
    ok = (idx >= 0) & (idx < num)
    flat = idx.long() + num * torch.arange(n, device=idx.device)[:, None]
    out = torch.zeros((n * num,) + tuple(vals.shape[2:]), dtype=torch.int32,
                      device=vals.device)
    out.index_add_(0, flat[ok], vals[ok])
    return out.view((n, num) + tuple(vals.shape[2:]))


def _same_on_every_shard(what: str, *tensors) -> None:
    for t in tensors:
        if not torch.equal(t, t[:1].expand_as(t)):
            raise AssertionError(f"sharded window: {what} differs between "
                                 "shards")


def _sharded_window_plain(balances, nonces, slot_vals, acct_rows, slot_rows,
                          txds, t_idxs, s_idxs, n: int, mode: str,
                          return_replicas: bool = False):
    """Plain PyTorch version of K8 (reference ``_build_window``), one
    working set per shard (the shard axis leads every tensor).  Returns
    new tables and the fetch tensor, plus each shard's final (balances,
    nonces, slots) working set with ``return_replicas``."""
    A, SA = balances.shape[0], slot_vals.shape[0]
    arena, sarena = A // n, SA // n
    L, SL = acct_rows.shape[0], slot_rows.shape[0]
    K, P = txds.shape[:2]
    dev = balances.device
    d = torch.arange(n, device=dev)[:, None]
    # gather the window rows each shard owns; one add-reduce replicates
    # them (one owner per row, none for pad rows: the sum IS the value)
    own_a = (acct_rows[None] >= d * arena) & (acct_rows[None] < (d + 1) * arena)
    own_s = (slot_rows[None] >= d * sarena) \
        & (slot_rows[None] < (d + 1) * sarena)
    ga = acct_rows.long().clamp(0, A - 1)
    gs = slot_rows.long().clamp(0, SA - 1)
    lb = collective_reduce_plain(
        torch.where(own_a[..., None], balances[ga][None], 0), mode)
    ln = collective_reduce_plain(torch.where(own_a, nonces[ga][None], 0),
                                 mode)
    ls = collective_reduce_plain(
        torch.where(own_s[..., None], slot_vals[gs][None], 0), mode)
    fetches = []
    for k in range(K):
        txd = txds[k].reshape(n, P // n, -1)   # shard d: its own lanes
        senders, recips = txd[..., 0], txd[..., 1]
        values, fees = txd[..., 6:22], txd[..., 22:38]
        required, amounts = txd[..., 38:54], txd[..., 56:72]
        mask = txd[..., 4] != 0
        mask_i = mask.to(torch.int32)[..., None]
        debit = u256.add(values, fees) * mask_i
        # full-working-set partials from each shard's own lanes
        debit_p = _seg_sum(debit, senders, L)
        req_p = _seg_sum(required * mask_i, senders, L)
        credit_p = _seg_sum(values * mask_i, recips, L)
        counts_p = _seg_sum(mask_i, senders, L)
        fee_local = (fees * mask_i).sum(1, dtype=torch.int32)
        coinbase = txd[:, 0, 5].long()
        cb_ok = (coinbase >= 0) & (coinbase < L)
        rows = torch.arange(n, device=dev)
        credit_p[rows[cb_ok], coinbase[cb_ok]] += fee_local[cb_ok]
        sdeb_p = _seg_sum(amounts * mask_i, txd[..., 54], SL)
        scred_p = _seg_sum(amounts * mask_i, txd[..., 55], SL)
        # nonce sequence on each shard's own lanes, against its
        # replicated pre-block nonces (a jnp gather: wrap, then clamp)
        expected = torch.gather(ln, 1, gather_index(senders, L)) \
            + txd[..., 3]
        nonce_ok = torch.all(torch.where(mask, txd[..., 2] == expected,
                                         True), dim=1)
        # THE exchange: one reduce of the packed effect tensors
        pack_a = collective_reduce_plain(
            torch.cat([debit_p, req_p, credit_p, counts_p], dim=2), mode)
        pack_s = collective_reduce_plain(
            torch.cat([sdeb_p, scred_p], dim=2), mode)
        nonce_n = collective_reduce_plain(nonce_ok.to(torch.int32), mode)
        debit_t = u256.normalize(pack_a[..., 0:16])
        req_t = u256.normalize(pack_a[..., 16:32])
        credit_t = u256.normalize(pack_a[..., 32:48])
        counts = pack_a[..., 48]
        sdeb_t = u256.normalize(pack_s[..., 0:16])
        scred_t = u256.normalize(pack_s[..., 16:32])
        # validation on the replicated rows: the same on every shard
        ok = (nonce_n == n) \
            & torch.all(u256.gte(lb, req_t) | (counts == 0), dim=1) \
            & torch.all(u256.gte(ls, sdeb_t), dim=1)
        lb = u256.sub(u256.add(lb, credit_t), debit_t)
        ln = ln + counts
        ls = u256.sub(u256.add(ls, scred_t), sdeb_t)
        _same_on_every_shard(f"block {k}", lb, ln, ls, ok)
        fetches.append(_gather_fetch(lb[0], ln[0], ls[0], ok[0], t_idxs[k],
                                     s_idxs[k]))
    # scatter each shard's rows back into its arena
    nb, nn, nsv = balances.clone(), nonces.clone(), slot_vals.clone()
    for s in range(n):
        nb[ga[own_a[s]]] = lb[s][own_a[s]]
        nn[ga[own_a[s]]] = ln[s][own_a[s]]
        nsv[gs[own_s[s]]] = ls[s][own_s[s]]
    out = (nb, nn, nsv, torch.stack(fetches))
    return out + ((lb, ln, ls),) if return_replicas else out


def sharded_transfer_window(balances, nonces, slot_vals, acct_rows,
                            slot_rows, txds, t_idxs, s_idxs, n: int,
                            mode: str = "psum",
                            return_replicas: bool = False):
    """One window of blocks over ``n`` shards: the CUDA kernel
    (``csrc/sharded_window.cu``, one cluster launch, asynchronous on the
    current stream) for CUDA tensors, the plain version for CPU tensors.

    The arguments are ``_transfer_window``'s, with shard-major tables,
    the device-table rows of the window locals (pad: the table size),
    and txds whose tx axis the caller interleaved (``interleave_txs``).
    ``mode`` is the exchange's collective ("psum" or "ppermute").  The
    input tables are not modified.  Returns (balances, nonces, slots,
    fetches), and with ``return_replicas`` each shard's final working
    set as a fifth element ([n, L, 16], [n, L], [n, SL, 16])."""
    args = (balances, nonces, slot_vals, acct_rows, slot_rows, txds, t_idxs,
            s_idxs)
    dev = check_window_args("sharded_transfer_window", args)
    if not isinstance(n, int) or n < 1 or n & (n - 1) or n > MAX_SHARDS:
        raise ValueError(f"sharded_transfer_window: {n!r} shards; the width "
                         f"must be a power of two in [1, {MAX_SHARDS}]")
    if mode not in ("psum", "ppermute"):
        raise ValueError(f"sharded_transfer_window: unknown mode {mode!r}")
    K, P = txds.shape[:2]
    A, SA = balances.shape[0], slot_vals.shape[0]
    if A % n or SA % n or P % n:
        raise ValueError(f"sharded_transfer_window: tables of {A} and {SA} "
                         f"rows and {P} tx lanes must divide by {n} shards")
    if dev.type == "cpu":
        return _sharded_window_plain(*args, n, mode, return_replicas)
    global LAUNCHES
    nb, nn, nsv, fetches, reps = _launch(args, n, mode,
                                         window_design(P)["layout"])
    LAUNCHES += 1
    out = (nb, nn, nsv, fetches)
    return out + (reps,) if return_replicas else out


def window_design(pad: int) -> dict:
    """K8's design at ``pad`` lanes a block (any width): the slab layout
    ("dsmem": each CTA's compact slabs in its shared memory, read by its
    peers through distributed shared memory; "global": the same slabs in
    device memory, read through L2, when two buffers do not fit the
    card's opt-in shared memory), the dynamic shared memory a CTA, and the
    barriers a block."""
    import ctypes
    lib = kernels.load("sharded_window")
    b = ctypes.c_int()
    dsmem = lib.sharded_window_layout(pad, ctypes.byref(b))
    return {"layout": "dsmem" if dsmem else "global", "smem_bytes": b.value,
            "cluster_barriers_a_block": 1, "cta_barriers_a_block": 2}


def _launch(args, n: int, mode: str, layout: str):
    """One launch of K8 on CUDA tensors in slab layout ``layout``; returns
    (balances, nonces, slots, fetches, each shard's working set)."""
    balances, nonces, slot_vals, acct_rows, slot_rows, txds, t_idxs, \
        s_idxs = args
    dev = balances.device
    K, P = txds.shape[:2]
    A, SA = balances.shape[0], slot_vals.shape[0]
    L, SL = acct_rows.shape[0], slot_rows.shape[0]
    lib = kernels.load("sharded_window")
    acct_rows, slot_rows, txds, t_idxs, s_idxs = (
        t.contiguous() for t in (acct_rows, slot_rows, txds, t_idxs, s_idxs))
    nb, nn, nsv = balances.clone(), nonces.clone(), slot_vals.clone()
    i32 = dict(dtype=torch.int32, device=dev)
    lb = torch.empty((n, L, u256.LIMBS), **i32)
    ln = torch.empty((n, L), **i32)
    ls = torch.empty((n, SL, u256.LIMBS), **i32)
    amap = torch.empty((n, L), **i32)
    smap = torch.empty((n, SL), **i32)
    ga = torch.empty((n, L, u256.LIMBS + 1), **i32)
    gs = torch.empty((n, SL, u256.LIMBS), **i32)
    slabs = layout == "global"
    xa = torch.empty((2, n, 2 * P + 1, ACCW) if slabs else (1,), **i32)
    xs = torch.empty((2, n, 2 * P, 2 * u256.LIMBS) if slabs else (1,), **i32)
    t_pad, s_pad = t_idxs.shape[1], s_idxs.shape[1]
    fetches = torch.empty((K, t_pad + s_pad + 1, u256.LIMBS + 1), **i32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.sharded_window_launch(
        n, int(not slabs), nb.data_ptr(), nn.data_ptr(), nsv.data_ptr(),
        A // n, SA // n, acct_rows.data_ptr(), L, slot_rows.data_ptr(), SL,
        txds.data_ptr(), K, P, t_idxs.data_ptr(), t_pad, s_idxs.data_ptr(),
        s_pad, int(mode == "ppermute"), lb.data_ptr(), ln.data_ptr(),
        ls.data_ptr(), amap.data_ptr(), smap.data_ptr(), ga.data_ptr(),
        gs.data_ptr(), xa.data_ptr(), xs.data_ptr(), fetches.data_ptr(),
        stream)
    if rc == -1:
        raise RuntimeError(f"sharded_window: no cluster of {n} CTAs x 1024 "
                           "threads fits on this card")
    if rc == -3:
        raise ValueError(f"sharded_window: {K} blocks of {P} lanes; K8 takes "
                         "fewer than 16384 blocks of at most 16384 lanes")
    kernels.check(rc, "sharded_window")
    return nb, nn, nsv, fetches, (lb, ln, ls)

