"""Batched block-replay engine — value-transfer and machine blocks.

Port of reference ``replay/engine.py``: the transfer fast path and, for
the blocks it rejects, general contract blocks on the device step
machine (``replay/machine_block``): runs of consecutive machine blocks in
fused OCC windows (``device_occ=True``, the reference's default), or one
block at a time (``device_occ=False``, its per-block OCC configuration).
The transfer path:

1. **Classify** (host): a block is device-replayable when every tx is a
   pure value transfer (``to`` set, empty calldata, no access list,
   21k gas, a callee with no code and no multicoin flag, not a
   precompile or prohibited address).
2. **Recover senders** (``_SenderPipeline``): look-ahead segments; on
   the card every segment of at least ``DEVICE_RECOVER_MIN`` signatures
   runs the hand-written secp256k1 kernel, smaller ones the native C++
   batch in a worker thread.
3. **Execute** (device): one launch of the hand-written transfer-window
   kernel per window of blocks (``_transfer_window``): per-sender debits
   and required balance, per-recipient credits plus the coinbase fee as
   segment sums over 16x16-bit limbs (ops/u256), with the nonce-sequence
   and solvency checks.  The solvency check ignores same-block credits,
   so ok implies the sequential result.
4. **Commit** (host-native): one deduped account fold per window in the
   C++ trie, root checked against the header (replay/commit.py).

A block the transfer classifier rejects goes to the machine path:
``MachineBlockExecutor.classify`` takes it when every tx is a transfer
or a call into device-eligible contract code.  With ``device_occ`` the
engine collects up to ``LOOKAHEAD`` consecutive such blocks and runs
them in windows of the fused OCC kernel (K6, with K5's lane interpreter,
the K4 ALU and K3 keccak inside, and with ``specialize`` the traced
programs of the contracts the tracer accepts, K7); without it, each
block runs on the step machine (K5) with miss-and-rerun storage rounds,
OCC validation on the host, and the conflict suffix on the native host
session.  A block
neither path takes — contract creation, host-only opcodes, a lane that
escapes the machine — or whose device ``ok`` flag is 0, or that fails a
consensus check, raises
``ReplayError`` with ``.block`` set: the host execution path (the
reference's ``Processor`` fallback) is not ported yet, and the engine
refuses loudly instead.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from coreth_tpu_torch import default_device, kernels, rlp
from coreth_tpu_torch.consensus.engine import ConsensusError, DummyEngine
from coreth_tpu_torch.crypto import keccak256, native
from coreth_tpu_torch.crypto import secp_device
from coreth_tpu_torch.crypto.secp256k1 import N as SECP_N
from coreth_tpu_torch.evm.precompiles import (
    is_prohibited, special_call_targets,
)
from coreth_tpu_torch.mpt import NativeSecureTrie
from coreth_tpu_torch.ops import u256
from coreth_tpu_torch.parallel.shard import (
    account_bucket, contract_bucket, remap_rows,
)
from coreth_tpu_torch.params import ChainConfig
from coreth_tpu_torch.params import protocol as P
from coreth_tpu_torch.state import StateStore
from coreth_tpu_torch.types import (
    Block, LatestSigner, Receipt, StateAccount,
)
from coreth_tpu_torch.types.account import EMPTY_CODE_HASH, EMPTY_ROOT_HASH


class ReplayError(Exception):
    """A block the engine cannot replay; ``.block`` is that block (None
    when the failure is not one block's, e.g. a window root mismatch)."""

    block: Optional[Block] = None


def _block_error(msg: str, block: Block) -> ReplayError:
    err = ReplayError(f"block {block.number}: {msg}")
    err.block = block
    return err


_NOT_PORTED = ("the host execution path (Processor fallback) is not "
               "ported yet")


@dataclass
class ReplayStats:
    blocks_device: int = 0
    txs: int = 0
    t_classify: float = 0.0
    t_sender: float = 0.0
    t_device: float = 0.0
    t_trie: float = 0.0
    # windows whose fetch download was started at issue time
    reads_prefetched: int = 0
    # where batched sender recovery ran: the device ladder vs the
    # native host batch
    sigs_device: int = 0
    sigs_host: int = 0
    # the mesh width, and the transfer windows each exchange mode carried
    n_shards: int = 1
    exchange_psum: int = 0
    exchange_ppermute: int = 0
    # max/mean lanes per shard of the sharded machine windows (1.0 flat,
    # n_shards all on one shard); 0.0 until such a window ran
    load_imbalance: float = 0.0

    def row(self) -> dict:
        return dict(self.__dict__)


# Packed tx-batch column layout — one host->device transfer per window:
#   0 sender_idx | 1 recip_idx | 2 tx_nonce | 3 nonce_offset | 4 mask
#   5 coinbase_idx (broadcast) | 6:22 value16 | 22:38 fee16
#   38:54 required16 | 54 from_slot | 55 to_slot | 56:72 amount16
# Native transfers carry amount16 = 0 / slots = 0 (the reserved dummy).
TXD_COLS = 72
# the kernel's uint32 limb sums take 2 * pad adds of < 2^16
MAX_PAD = 1 << 14
# a kernel accumulator row: debit | required | credit | send count
ACCW = 3 * u256.LIMBS + 1


def pack_txd(batch: dict, B: int, pad: int) -> np.ndarray:
    txd = np.zeros((pad, TXD_COLS), dtype=np.int32)
    txd[:B, 0] = batch["senders"]
    txd[:B, 1] = batch["recips"]
    txd[:B, 2] = batch["nonces"]
    txd[:B, 3] = batch["offsets"]
    txd[:B, 4] = 1
    txd[:, 5] = batch["coinbase"]
    txd[:B, 6:22] = u256.pack_np(batch["values"])
    txd[:B, 22:38] = u256.pack_np(batch["fees"])
    txd[:B, 38:54] = u256.pack_np(batch["required"])
    txd[:B, 54] = batch["from_slots"]
    txd[:B, 55] = batch["to_slots"]
    txd[:B, 56:72] = u256.pack_np(batch["amounts"])
    return txd


def txd_cols(txd):
    """Column views of a packed tx batch — the one decoder of the
    pack_txd layout.  Returns (senders, recips, values16, fees16,
    required16, tx_nonce, nonce_offset, mask, coinbase, from_slots,
    to_slots, amount16)."""
    return (txd[:, 0], txd[:, 1], txd[:, 6:22], txd[:, 22:38],
            txd[:, 38:54], txd[:, 2], txd[:, 3], txd[:, 4] != 0,
            txd[0, 5], txd[:, 54], txd[:, 55], txd[:, 56:72])


# ------------------------------------------------ plain transfer window
# The plain PyTorch version of K1, in the reference's structure.  Index
# semantics follow jnp: a gather clamps an out-of-range index, a segment
# sum or scatter drops it; the engine only ever produces in-range local
# indices, and pads global ids with ``capacity`` (gather 0, drop).

def _seg_sum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    ok = (idx >= 0) & (idx < n)
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=torch.int32,
                      device=vals.device)
    return out.index_add_(0, idx[ok].long(), vals[ok])


def _gather(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return arr[idx.long().clamp(0, arr.shape[0] - 1)]


def _transfer_step_plain(balances, nonces, sender_idx, recip_idx, value16,
                         fee16, required16, tx_nonce, nonce_offset, mask,
                         coinbase_idx: int, num_accounts: int):
    """One block of pure transfers (reference _transfer_step)."""
    mask_i = mask.to(torch.int32)[:, None]
    debit = u256.add(value16, fee16) * mask_i
    required = required16 * mask_i
    credit = value16 * mask_i
    expected = _gather(nonces, sender_idx) + nonce_offset
    nonce_ok = torch.all(torch.where(mask, tx_nonce == expected, True))
    debit_tot = u256.normalize(_seg_sum(debit, sender_idx, num_accounts))
    required_tot = u256.normalize(
        _seg_sum(required, sender_idx, num_accounts))
    credit_tot = u256.normalize(_seg_sum(credit, recip_idx, num_accounts))
    # an int32 sum, as jnp's (torch would widen to int64)
    fee_total = u256.normalize((fee16 * mask_i).sum(0, dtype=torch.int32))
    if 0 <= coinbase_idx < num_accounts:
        credit_tot[coinbase_idx] += fee_total
    credit_tot = u256.normalize(credit_tot)
    send_counts = _seg_sum(mask_i, sender_idx, num_accounts)[:, 0]
    solvent = u256.gte(balances, required_tot)
    ok = nonce_ok & torch.all(solvent | (send_counts == 0))
    new_balances = u256.sub(u256.add(balances, credit_tot), debit_tot)
    return new_balances, nonces + send_counts, ok


def _slot_step_plain(slot_vals, from_slot, to_slot, amount16, mask,
                     num_slots: int):
    """Batched ERC-20 mapping-slot debits/credits (reference _slot_step)."""
    amt = amount16 * mask.to(torch.int32)[:, None]
    debit_tot = u256.normalize(_seg_sum(amt, from_slot, num_slots))
    credit_tot = u256.normalize(_seg_sum(amt, to_slot, num_slots))
    ok = torch.all(u256.gte(slot_vals, debit_tot))
    return u256.sub(u256.add(slot_vals, credit_tot), debit_tot), ok


def _gather_fetch(balances, nonces, slot_vals, ok, t_idx, s_idx):
    """[t_pad+s_pad+1, 17] fetch rows: touched (balance, nonce) rows,
    touched storage-slot rows, and the ok flag."""
    g = torch.cat([_gather(balances, t_idx),
                   _gather(nonces, t_idx)[:, None]], dim=1)
    s = torch.cat([_gather(slot_vals, s_idx),
                   torch.zeros((s_idx.shape[0], 1), dtype=torch.int32,
                               device=slot_vals.device)], dim=1)
    ok_row = torch.zeros((1, u256.LIMBS + 1), dtype=torch.int32,
                         device=balances.device)
    ok_row[0, 0] = ok.to(torch.int32)
    return torch.cat([g, s, ok_row], dim=0)


def _transfer_window_plain(balances, nonces, slot_vals, acct_gids,
                           slot_gids, txds, t_idxs, s_idxs):
    """Plain PyTorch version of the transfer-window kernel (reference
    _transfer_window): gather the window-local rows, run the blocks in
    order, scatter back.  Returns new tables and the fetch tensor."""
    cap, scap = balances.shape[0], slot_vals.shape[0]
    av = (acct_gids >= 0) & (acct_gids < cap)
    sv_ok = (slot_gids >= 0) & (slot_gids < scap)
    ag = acct_gids.long().clamp(0, cap - 1)
    sg = slot_gids.long().clamp(0, scap - 1)
    lb = torch.where(av[:, None], balances[ag], 0)
    ln = torch.where(av, nonces[ag], 0)
    ls = torch.where(sv_ok[:, None], slot_vals[sg], 0)
    L, SL = acct_gids.shape[0], slot_gids.shape[0]
    fetches = []
    for k in range(txds.shape[0]):
        (senders, recips, values, fees, required, tx_nonce, offsets, mask,
         coinbase, from_slots, to_slots, amounts) = txd_cols(txds[k])
        lb, ln, ok = _transfer_step_plain(
            lb, ln, senders, recips, values, fees, required, tx_nonce,
            offsets, mask, int(coinbase), L)
        ls, ok_slots = _slot_step_plain(ls, from_slots, to_slots, amounts,
                                        mask, SL)
        fetches.append(_gather_fetch(lb, ln, ls, ok & ok_slots, t_idxs[k],
                                     s_idxs[k]))
    nb, nn, nsv = balances.clone(), nonces.clone(), slot_vals.clone()
    nb[ag[av]] = lb[av]
    nn[ag[av]] = ln[av]
    nsv[sg[sv_ok]] = ls[sv_ok]
    return nb, nn, nsv, torch.stack(fetches)


LAUNCHES = 0


def check_window_args(what: str, args) -> torch.device:
    """The checks every transfer-window wrapper makes on (balances,
    nonces, slot_vals, acct rows, slot rows, txds, t_idxs, s_idxs):
    int32 on one device, the pack_txd layout, consistent shapes, and on
    CUDA the kernel's limits.  Returns the device."""
    balances, nonces, slot_vals, acct_gids, slot_gids, txds, t_idxs, \
        s_idxs = args
    dev = balances.device
    for t in args:
        if t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"{what}: every input must be int32 on {dev}, "
                             f"got {t.dtype} on {t.device}")
    K, pad, cols = txds.shape
    if (cols != TXD_COLS or balances.shape[1:] != (u256.LIMBS,)
            or slot_vals.shape[1:] != (u256.LIMBS,)
            or nonces.shape != balances.shape[:1]
            or t_idxs.shape[0] != K or s_idxs.shape[0] != K):
        raise ValueError(f"{what}: malformed shapes")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if dev.type == "cuda" and (pad > MAX_PAD or acct_gids.shape[0] < 1
                               or slot_gids.shape[0] < 1):
        raise ValueError(f"{what}: pad {pad} > {MAX_PAD} or an empty local "
                         "table")
    return dev


def _transfer_window(balances, nonces, slot_vals, acct_gids, slot_gids,
                     txds, t_idxs, s_idxs):
    """One window of blocks: the CUDA kernel (``csrc/transfer_window.cu``)
    for CUDA tensors, asynchronous on the current stream; the plain
    version for CPU tensors.  The input tables are not modified."""
    args = (balances, nonces, slot_vals, acct_gids, slot_gids, txds,
            t_idxs, s_idxs)
    dev = check_window_args("_transfer_window", args)
    if dev.type == "cpu":
        return _transfer_window_plain(*args)
    global LAUNCHES
    K, pad = txds.shape[:2]
    L, SL = acct_gids.shape[0], slot_gids.shape[0]
    lib = kernels.load("transfer_window")
    (acct_gids, slot_gids, txds, t_idxs, s_idxs) = (
        t.contiguous() for t in (acct_gids, slot_gids, txds, t_idxs,
                                 s_idxs))
    nb, nn, nsv = balances.clone(), nonces.clone(), slot_vals.clone()
    i32 = dict(dtype=torch.int32, device=dev)
    lb = torch.empty((L, u256.LIMBS), **i32)
    ln = torch.empty((L,), **i32)
    ls = torch.empty((SL, u256.LIMBS), **i32)
    acc = torch.empty((L, ACCW), **i32)
    stamp = torch.empty((L,), **i32)
    sacc = torch.empty((SL, 2 * u256.LIMBS), **i32)
    sstamp = torch.empty((SL,), **i32)
    t_pad, s_pad = t_idxs.shape[1], s_idxs.shape[1]
    fetches = torch.empty((K, t_pad + s_pad + 1, u256.LIMBS + 1), **i32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.transfer_window_launch(
        nb.data_ptr(), nn.data_ptr(), nsv.data_ptr(), nb.shape[0],
        nsv.shape[0], acct_gids.data_ptr(), L, slot_gids.data_ptr(), SL,
        txds.data_ptr(), K, pad, t_idxs.data_ptr(), t_pad,
        s_idxs.data_ptr(), s_pad, lb.data_ptr(), ln.data_ptr(),
        ls.data_ptr(), acc.data_ptr(), stamp.data_ptr(), sacc.data_ptr(),
        sstamp.data_ptr(), fetches.data_ptr(), stream)
    kernels.check(rc, "transfer_window")
    LAUNCHES += 1
    return nb, nn, nsv, fetches


def _scatter_drop(arr: torch.Tensor, idx: torch.Tensor,
                  val: torch.Tensor) -> None:
    """In-place ``arr[idx] = val``, dropping out-of-range rows."""
    ok = (idx >= 0) & (idx < arr.shape[0])
    arr[idx[ok].long()] = val[ok]


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy -> device through a pinned host buffer, without blocking."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


class DeviceState:
    """Account- and storage-slot-indexed device tables (the flat-state /
    snapshot analog, resident in device memory).  Slot index 0 is a
    reserved dummy that native-transfer and padding rows target with
    amount 0.

    With ``n_shards > 1`` (a mesh engine) the tables are shard-major:
    host indices (gids) stay contiguous in discovery order, but each
    gid's device row lies in the arena of its owning shard, accounts
    bucketed by keccak(address)[0], contract storage by the contract's
    bucket (``parallel/shard.py``).  ``row_of``/``slot_row_of`` carry
    the gid -> row indirection (identity on one shard); every table
    scatter and gather goes through it."""

    def __init__(self, capacity: int = 1 << 14,
                 slot_capacity: int = 1 << 14, device="cuda",
                 n_shards: int = 1):
        self.device = torch.device(device)
        self.index: Dict[bytes, int] = {}
        self.addrs: List[bytes] = []
        self.capacity = capacity
        self.n_shards = n_shards
        self.row_of: List[int] = []
        self._arow = [0] * n_shards           # next local row per shard
        self.balances = torch.zeros((capacity, u256.LIMBS),
                                    dtype=torch.int32, device=self.device)
        self.nonces = torch.zeros((capacity,), dtype=torch.int32,
                                  device=self.device)
        # host-side metadata that gates device replay and fills the
        # non-device account fields at the trie fold
        self.has_code: List[bool] = []
        self.multicoin: List[bool] = []
        self.code_hashes: List[bytes] = []
        self.roots: List[bytes] = []
        self.addr_hashes: List[bytes] = []
        self._staged: List[Tuple[int, int, int]] = []
        # token slots: only the reserved dummy (shard 0, row 0) until the
        # token path is ported; the window kernels take the table
        # regardless
        self.slot_capacity = slot_capacity
        self.slot_row_of: List[int] = [0]
        self._srow = [1 if s == 0 else 0 for s in range(n_shards)]
        self._cbucket: Dict[bytes, int] = {}  # contract -> owning shard
        self.slot_vals = torch.zeros((slot_capacity, u256.LIMBS),
                                     dtype=torch.int32, device=self.device)

    @classmethod
    def from_arrays(cls, balances: np.ndarray, nonces: np.ndarray,
                    slot_vals: np.ndarray, index_meta: dict,
                    device="cuda") -> "DeviceState":
        """Tables carried over from another engine (e.g. the JAX
        reference's ``np.asarray(ref.state.balances)`` and friends) plus
        its host index lists: ``addrs``, ``row_of``, ``has_code``,
        ``multicoin``, ``code_hashes``, ``roots``, ``slot_row_of``, and
        ``n_shards`` (default 1) with the rows it laid out."""
        n = index_meta.get("n_shards", 1)
        st = cls(balances.shape[0], slot_vals.shape[0], device, n)
        st.balances = _upload(balances.astype(np.int32), st.device)
        st.nonces = _upload(nonces.astype(np.int32), st.device)
        st.slot_vals = _upload(slot_vals.astype(np.int32), st.device)
        st.addrs = list(index_meta["addrs"])
        st.index = {a: i for i, a in enumerate(st.addrs)}
        st.addr_hashes = [keccak256(a) for a in st.addrs]
        for key in ("row_of", "has_code", "multicoin", "code_hashes",
                    "roots", "slot_row_of"):
            setattr(st, key, list(index_meta[key]))
        arena, sarena = st.capacity // n, st.slot_capacity // n
        st._arow = [sum(1 for r in st.row_of if r // arena == s)
                    for s in range(n)]
        st._srow = [sum(1 for r in st.slot_row_of if r // sarena == s)
                    for s in range(n)]
        return st

    @staticmethod
    def _regrow(table: torch.Tensor, rows: int, src=None,
                dst=None) -> torch.Tensor:
        """``table`` copied into a zeroed table of ``rows`` rows on the
        device, in stream order: rows ``src`` to ``dst`` (index lists),
        or the old rows in place."""
        out = torch.zeros((rows,) + tuple(table.shape[1:]),
                          dtype=table.dtype, device=table.device)
        if src is None:
            out[:table.shape[0]] = table
        elif src:
            dev = table.device
            out.index_copy_(0, _upload(np.asarray(dst, np.int64), dev),
                            table.index_select(0, _upload(
                                np.asarray(src, np.int64), dev)))
        return out

    def _grow(self, need: int) -> None:
        while self.capacity < need:
            self.capacity *= 2
        self.balances = self._regrow(self.balances, self.capacity)
        self.nonces = self._regrow(self.nonces, self.capacity)

    def _grow_slots(self, need: int) -> None:
        while self.slot_capacity < need:
            self.slot_capacity *= 2
        self.slot_vals = self._regrow(self.slot_vals, self.slot_capacity)

    def _grow_sharded(self) -> None:
        """Double every shard's arena: shard-major rows all move (row =
        shard*arena + local), so the tables rebuild on the device through
        ``remap_rows`` — the only point where sharded rows are remapped."""
        old = self.capacity // self.n_shards
        self.capacity *= 2
        new_rows = remap_rows(self.row_of, old,
                              self.capacity // self.n_shards)
        self.balances = self._regrow(self.balances, self.capacity,
                                     self.row_of, new_rows)
        self.nonces = self._regrow(self.nonces, self.capacity,
                                   self.row_of, new_rows)
        self.row_of = new_rows

    def _grow_slots_sharded(self) -> None:
        old = self.slot_capacity // self.n_shards
        self.slot_capacity *= 2
        new_rows = remap_rows(self.slot_row_of, old,
                              self.slot_capacity // self.n_shards)
        self.slot_vals = self._regrow(self.slot_vals, self.slot_capacity,
                                      self.slot_row_of, new_rows)
        self.slot_row_of = new_rows

    def _alloc_row(self, addr_hash: bytes) -> int:
        """Device-table row for a new account gid (its bucket's arena on
        a mesh, the next row otherwise)."""
        if self.n_shards <= 1:
            row = len(self.row_of)
            if row >= self.capacity:
                self._grow(row + 1)
            return row
        s = account_bucket(addr_hash, self.n_shards)
        if self._arow[s] >= self.capacity // self.n_shards:
            self._grow_sharded()
        row = s * (self.capacity // self.n_shards) + self._arow[s]
        self._arow[s] += 1
        return row

    def _alloc_slot_row(self, contract: bytes) -> int:
        """Device-table row for a new storage slot of ``contract`` (the
        contract's bucket's arena on a mesh); the caller appends it to
        ``slot_row_of``."""
        if self.n_shards <= 1:
            row = len(self.slot_row_of)
            if row >= self.slot_capacity:
                self._grow_slots(row + 1)
            return row
        s = self._cbucket.get(contract)
        if s is None:
            s = contract_bucket(keccak256(contract), self.n_shards)
            self._cbucket[contract] = s
        if self._srow[s] >= self.slot_capacity // self.n_shards:
            self._grow_slots_sharded()
        row = s * (self.slot_capacity // self.n_shards) + self._srow[s]
        self._srow[s] += 1
        return row

    def ensure(self, addr: bytes, account: Optional[StateAccount]) -> int:
        idx = self.index.get(addr)
        if idx is not None:
            return idx
        idx = len(self.addrs)
        self.index[addr] = idx
        self.addrs.append(addr)
        self.addr_hashes.append(keccak256(addr))
        # two statements: _alloc_row may replace row_of (arena growth
        # remaps rows into a fresh list), so the append binds after it
        row = self._alloc_row(self.addr_hashes[idx])
        self.row_of.append(row)
        if account is None:
            self.has_code.append(False)
            self.multicoin.append(False)
            self.code_hashes.append(EMPTY_CODE_HASH)
            self.roots.append(EMPTY_ROOT_HASH)
        else:
            self.has_code.append(account.code_hash != EMPTY_CODE_HASH)
            self.multicoin.append(account.is_multi_coin)
            self.code_hashes.append(account.code_hash)
            self.roots.append(account.root)
            if account.balance or account.nonce:
                # staged: one scatter per window, not one per account
                self._staged.append((idx, account.balance, account.nonce))
        return idx

    def flush_staged(self) -> None:
        """Write the staged initial values of newly seen accounts."""
        if not self._staged:
            return
        idx = np.asarray([self.row_of[s[0]] for s in self._staged],
                         dtype=np.int64)
        bal = u256.pack_np([s[1] for s in self._staged])
        non = np.asarray([s[2] for s in self._staged], dtype=np.int32)
        didx = _upload(idx, self.device)
        _scatter_drop(self.balances, didx, _upload(bal, self.device))
        _scatter_drop(self.nonces, didx, _upload(non, self.device))
        self._staged = []

    def read_accounts(self, indices: List[int]) -> List[Tuple[int, int]]:
        """(balance, nonce) of the given gids, read back to the host."""
        idx = _upload(np.asarray([self.row_of[i] for i in indices],
                                 dtype=np.int64), self.device)
        balances = u256.to_ints(self.balances[idx])
        non = self.nonces[idx].cpu().numpy()
        return [(balances[i], int(non[i])) for i in range(len(indices))]

    def set_accounts(self, accounts: Dict[bytes, Tuple[int, int]]) -> None:
        """Write ``addr -> (balance, nonce)`` for indexed accounts, in
        place of any initial values still staged for them."""
        rows = {self.index[a]: v for a, v in accounts.items()}
        self._staged = [s for s in self._staged if s[0] not in rows]
        self._staged.extend((i, bal, nonce)
                            for i, (bal, nonce) in rows.items())
        self.flush_staged()


class _SenderPipeline:
    """Segmented, look-ahead sender recovery for replay().

    The input is cut into segments of up to ``MAX_CHUNK`` signatures, and
    ``AHEAD`` segments stay issued past the replay cursor: device
    segments launch into the same stream as the window kernels (so a
    window's senders recover on the card while the previous window
    executes); host segments run whole in the engine's worker thread
    (the ctypes C++ batch releases the GIL).  ``ensure(i)`` blocks only
    until block i's segment is applied."""

    AHEAD = 3

    def __init__(self, engine: "ReplayEngine", blocks: List[Block]):
        self.engine = engine
        self.block_seg: List[int] = []
        self.segments: List[List[Block]] = []
        cur: List[Block] = []
        count = 0
        for b in blocks:
            self.block_seg.append(len(self.segments))
            cur.append(b)
            count += len(b.transactions)
            if count >= secp_device.MAX_CHUNK:
                self.segments.append(cur)
                cur, count = [], 0
        if cur:
            self.segments.append(cur)
        self.issued: List[dict] = []
        self.done = 0

    def _issue(self, s: int) -> None:
        eng = self.engine
        t0 = time.monotonic()
        todo, hashes, rs, ss, recids = eng._pack_sigs(self.segments[s])
        h = {"todo": todo, "kind": "empty"}
        n = len(recids)
        if n and eng._device_recover(n):
            eng.stats.sigs_device += n
            h["kind"] = "device"
            h["ctxs"] = secp_device.issue_recover(
                hashes, rs, ss, recids, eng.device, eng._recover_kernel())
        elif n:
            eng.stats.sigs_host += n
            h["kind"] = "host"
            h["fut"] = eng._recover_pool_get().submit(
                native.recover_addresses_batch, hashes, rs, ss, recids)
        self.issued.append(h)
        eng.stats.t_sender += time.monotonic() - t0

    def _complete(self, s: int) -> None:
        eng = self.engine
        h = self.issued[s]
        t0 = time.monotonic()
        if h["kind"] == "host":
            out, ok = h["fut"].result()
        elif h["kind"] == "device":
            out, ok = secp_device.complete_recover(h["ctxs"])
        else:
            out = ok = None
        if out is not None:
            eng._apply_recovered(h["todo"], out, ok)
        eng.stats.t_sender += time.monotonic() - t0

    def ensure(self, block_idx: int) -> None:
        s = self.block_seg[block_idx]
        last = min(s + self.AHEAD, len(self.segments) - 1)
        while len(self.issued) <= last:
            self._issue(len(self.issued))
        while self.done <= s:
            self._complete(self.done)
            self.done += 1


class ReplayEngine:
    """Windowed replay of transfer and machine blocks over a state.

    ``state`` — a ``StateStore`` (account trie, storage tries, code
    store) — holds the state at the parent of the first block to replay (its account
    trie's hash is the starting root) and is advanced by every fold.
    ``device`` defaults to ``"cuda"`` and raises without a card;
    ``device="cpu"`` runs the kernels' plain versions.  ``device_occ``
    (the reference's ``CORETH_DEVICE_OCC``, default on) runs machine
    blocks in fused OCC windows; off, one block at a time.
    ``specialize`` (the reference's ``CORETH_SPECIALIZE``, default on)
    runs the lanes of traceable contracts in those windows on their
    straight-line programs; the per-block path has no specialisation,
    as in the reference.

    ``mesh`` (``parallel.make_mesh(n)``, n > 1) shards the state tables
    over n shards of the one card: transfer windows run on the sharded
    window kernel (K8, ``replay/shard.py``) over shard-major tables, and
    device sender recovery on the sharded ladder (K8r).  ``capacity``,
    ``slot_capacity`` and ``batch_pad`` must divide by n.  Machine
    windows run per shard in one cluster launch (K9, the reference's
    default ``CORETH_SHARD_OCC=1``, ``evm/device/shard.py``) with the
    flags reduce K9x behind each; ``shard_occ=False`` keeps the
    single-chip window runner over the sharded tables instead
    (``CORETH_SHARD_OCC=0``).  ``exchange`` ("psum" or "ppermute", the
    reference's ``CORETH_EXCHANGE``) forces the exchanges' collective;
    None picks it per window by density (``exchange_density``,
    ``CORETH_EXCHANGE_DENSITY``).  ``keyrange`` (``CORETH_KEYRANGE``)
    lets a contract with ``keyrange_threshold`` lanes in one block
    (``CORETH_KEYRANGE_THRESHOLD``) place its keys by key range, with
    the replica sync inside K9.  ``shard_recover``
    (``CORETH_SHARD_RECOVER``) sends every sender segment to the
    sharded ladder, however small, on any device."""

    # Below this many signatures a segment recovers on the native C++
    # batch instead of the device ladder.
    DEVICE_RECOVER_MIN = 1024

    def __init__(self, config: ChainConfig,
                 state: StateStore,
                 parent_header=None, batch_pad: int = 1024,
                 capacity: int = 1 << 14, window: int = 16,
                 slot_capacity: Optional[int] = None, device=None,
                 device_occ: bool = True, specialize: bool = True,
                 mesh=None, exchange: Optional[str] = None,
                 shard_recover: bool = False, shard_occ: bool = True,
                 keyrange: bool = True, keyrange_threshold: int = 16,
                 exchange_density: float = 0.25):
        self.device = default_device(device)
        self.device_occ = device_occ
        self.specialize = specialize
        self.shard_occ = shard_occ
        self.keyrange = keyrange
        self.keyrange_threshold = keyrange_threshold
        self.exchange_density = exchange_density
        self.config = config
        self.store = state
        self.trie = self.store.trie
        self.root = self.trie.hash()
        slot_capacity = slot_capacity or capacity
        if exchange not in (None, "psum", "ppermute"):
            raise ValueError(f"exchange={exchange!r}: None, 'psum' or "
                             "'ppermute'")
        self.exchange = exchange
        self.mesh = None
        self.n_shards = 1
        self._mesh_recover = None
        if mesh is not None and mesh.n_shards > 1:
            n = mesh.n_shards
            if mesh.device is not None \
                    and mesh.device.type != self.device.type:
                raise ValueError(f"mesh on {mesh.device}, engine on "
                                 f"{self.device}")
            for name, dim in (("capacity", capacity),
                              ("slot_capacity", slot_capacity),
                              ("batch_pad", batch_pad)):
                if dim % n:
                    raise ValueError(
                        f"{name}={dim} must divide by the mesh width {n} "
                        "(rows and txs shard over it; doubling keeps it)")
            self.mesh = mesh
            self.n_shards = n
            # the recover pad is a power of two of at least 64
            if 64 % n == 0:
                from coreth_tpu_torch.ops.secp import sharded_recover
                self._mesh_recover = sharded_recover(mesh)
        if shard_recover and self._mesh_recover is None:
            raise ValueError("shard_recover needs a mesh of more than one shard")
        self.shard_recover = shard_recover
        self.state = DeviceState(capacity, slot_capacity, self.device,
                                 self.n_shards)
        self.signer = LatestSigner(config.chain_id)
        self.engine = DummyEngine()
        self.stats = ReplayStats(n_shards=self.n_shards)
        self.batch_pad = batch_pad
        self.window = window
        self.parent_header = parent_header
        # the device ladder recovers senders when the engine runs on the
        # card (the whole share: no host/device split); on the CPU the
        # native batch does, unless a caller opts the plain ladder in
        self.recover_device = self.device.type == "cuda"
        from coreth_tpu_torch.replay.commit import CommitPipeline
        self.commit_pipe = CommitPipeline(self)
        self._recover_pool: Optional[ThreadPoolExecutor] = None
        self._machine = None

    def close(self) -> None:
        """Stop the recovery worker thread."""
        if self._recover_pool is not None:
            self._recover_pool.shutdown(wait=True)
            self._recover_pool = None

    # ---------------------------------------------------------------- index
    def _account(self, addr: bytes) -> int:
        idx = self.state.index.get(addr)
        if idx is not None:
            return idx
        raw = self.trie.get(addr)
        account = StateAccount.from_rlp(raw) if raw is not None else None
        return self.state.ensure(addr, account)

    def _storage_trie(self, contract: bytes) -> NativeSecureTrie:
        """The contract's storage trie in the engine's store (advanced in
        place by every fold, so it is at the account's current root)."""
        st = self.store.storage.get(contract)
        if st is None:
            root = self.state.roots[self._account(contract)]
            if root != EMPTY_ROOT_HASH:
                raise ReplayError(
                    f"storage trie of {contract.hex()} (root {root.hex()})"
                    " is not in the engine's state store")
            st = self.store.storage_trie(contract)
        return st

    def storage_value(self, contract: bytes, key: bytes) -> int:
        """Folded value of (normalized) slot ``key`` of ``contract``."""
        raw = self._storage_trie(contract).get(key)
        return int.from_bytes(rlp.decode(raw), "big") if raw else 0

    # -------------------------------------------------------------- senders
    def _pack_sigs(self, blocks):
        """Collect + pack uncached signatures for batched recovery; a
        malformed signature skips its tx (signer.sender rejects it)."""
        todo, hashes, rs, ss, recids = [], [], [], [], []
        for b in blocks:
            for tx in b.transactions:
                if tx.cached_sender() is not None:
                    continue
                try:
                    r, s, recid = tx.inner.raw_signature()
                    h = self.signer.sig_hash(tx)
                    rb, sb = r.to_bytes(32, "big"), s.to_bytes(32, "big")
                except (ValueError, OverflowError):
                    continue
                rs.append(rb)
                ss.append(sb)
                recids.append(recid if 0 <= recid <= 3 else 255)
                hashes.append(h)
                todo.append(tx)
        return todo, b"".join(hashes), b"".join(rs), b"".join(ss), \
            bytes(recids)

    def _apply_recovered(self, todo, out, ok) -> None:
        half_n = SECP_N // 2
        for i, tx in enumerate(todo):
            if ok[i]:
                # signer.sender re-validates chain id + low-s before
                # trusting the cache; prime it only
                r, s, recid = tx.inner.raw_signature()
                if recid in (0, 1) and 0 < s <= half_n:
                    tx.set_sender(out[i * 20:(i + 1) * 20])

    def _device_recover(self, n: int) -> bool:
        return self.shard_recover or (
            self.recover_device and n >= self.DEVICE_RECOVER_MIN)

    def _recover_kernel(self):
        """The device ladder: the sharded one (K8r) on a mesh, else None
        (``secp_device``'s default, K2)."""
        return self._mesh_recover

    def _recover_pool_get(self) -> ThreadPoolExecutor:
        if self._recover_pool is None:
            self._recover_pool = ThreadPoolExecutor(max_workers=1)
        return self._recover_pool

    def warm_senders(self, blocks) -> None:
        """Synchronous batched sender recovery over a block or a list."""
        if isinstance(blocks, Block):
            blocks = [blocks]
        t0 = time.monotonic()
        todo, hashes, rs, ss, recids = self._pack_sigs(blocks)
        n = len(recids)
        if n and self._device_recover(n):
            self.stats.sigs_device += n
            out, ok = secp_device.complete_recover(secp_device.issue_recover(
                hashes, rs, ss, recids, self.device, self._recover_kernel()))
        elif n:
            self.stats.sigs_host += n
            out, ok = native.recover_addresses_batch(hashes, rs, ss, recids)
        if n:
            self._apply_recovered(todo, out, ok)
        self.stats.t_sender += time.monotonic() - t0

    # ------------------------------------------------------------- classify
    def _classify(self, block: Block) -> Optional[dict]:
        """Batch inputs if every tx is a plain value transfer, else None."""
        if block.ext_data():
            return None
        base_fee = block.base_fee
        rules = self.config.rules(block.number, block.time)
        avoid = special_call_targets(rules)
        senders, recips, values, fees, required, nonces, offsets = \
            [], [], [], [], [], [], []
        gas_used = []
        seen_count: Dict[bytes, int] = {}
        state = self.state
        has_code, multicoin = state.has_code, state.multicoin
        acct_index = state.index
        account = self._account
        sender_of = self.signer.sender
        for tx in block.transactions:
            if tx.to is None or tx.access_list or tx.data:
                return None
            if tx.to in avoid or is_prohibited(tx.to):
                return None
            try:
                sender = sender_of(tx)
            except ValueError:
                return None
            s_idx = acct_index.get(sender)
            if s_idx is None:
                s_idx = account(sender)
            r_idx = acct_index.get(tx.to)
            if r_idx is None:
                r_idx = account(tx.to)
            if has_code[s_idx] or multicoin[s_idx]:
                return None
            gas_fee_cap = tx.gas_fee_cap
            if base_fee is not None:
                tip = tx.gas_tip_cap
                if gas_fee_cap < base_fee or gas_fee_cap < tip:
                    return None
                price = min(base_fee + tip, gas_fee_cap)
            else:
                price = tx.gas_price
            if tx.gas != P.TX_GAS:
                return None
            if has_code[r_idx] or multicoin[r_idx]:
                return None
            senders.append(s_idx)
            recips.append(r_idx)
            values.append(tx.value)
            gas_used.append(P.TX_GAS)
            fees.append(P.TX_GAS * price)
            # buyGas requirement (cap-based for typed txs)
            required.append(tx.gas * gas_fee_cap + tx.value)
            nonces.append(tx.nonce)
            prev = seen_count.get(sender, 0)
            offsets.append(prev)
            seen_count[sender] = prev + 1
        coinbase_idx = self._account(block.header.coinbase)
        n = len(senders)
        return dict(senders=senders, recips=recips, values=values,
                    fees=fees, required=required, nonces=nonces,
                    offsets=offsets, coinbase=coinbase_idx,
                    from_slots=[0] * n, to_slots=[0] * n,
                    amounts=[0] * n, gas_used=gas_used)

    # ---------------------------------------------------------------- replay
    def _prepare_window(self, items: List[Tuple[Block, dict]]):
        """Pack a run of classified blocks into stacked device inputs,
        over window-local index spaces (the kernel's cost scales with
        the window's touched set, not the table capacity).  The window
        pads to the next power of two of its length with all-masked
        batches."""
        self.state.flush_staged()
        K = 1
        while K < len(items):
            K *= 2
        pad = self.batch_pad
        t_pad = 256
        s_pad = 8
        touched_lists = []
        acct_local: Dict[int, int] = {}
        slot_local: Dict[int, int] = {0: 0}  # local slot 0 = the dummy

        def a_loc(g: int) -> int:
            l = acct_local.get(g)
            if l is None:
                l = len(acct_local)
                acct_local[g] = l
            return l

        local_batches = []
        for block, batch in items:
            B = len(block.transactions)
            while pad < B:
                pad *= 2
            lb = dict(batch)
            lb["senders"] = [a_loc(g) for g in batch["senders"]]
            lb["recips"] = [a_loc(g) for g in batch["recips"]]
            lb["coinbase"] = a_loc(batch["coinbase"])
            local_batches.append(lb)
            touched = sorted(set(batch["senders"]) | set(batch["recips"])
                             | {batch["coinbase"]})
            touched_lists.append(touched)
            while t_pad < len(touched):
                t_pad *= 2
        L = 256
        while L < len(acct_local):
            L *= 2
        SL = 8
        cap = self.state.capacity
        scap = self.state.slot_capacity
        acct_gids = np.full(L, cap, dtype=np.int32)
        for g, l in acct_local.items():
            acct_gids[l] = self.state.row_of[g]
        slot_gids = np.full(SL, scap, dtype=np.int32)
        for g, l in slot_local.items():
            slot_gids[l] = self.state.slot_row_of[g]
        txds = np.zeros((K, pad, TXD_COLS), dtype=np.int32)
        t_idxs = np.zeros((K, t_pad), dtype=np.int32)
        s_idxs = np.zeros((K, s_pad), dtype=np.int32)
        for k, (block, batch) in enumerate(items):
            txds[k] = pack_txd(local_batches[k], len(block.transactions),
                               pad)
            t_idxs[k, :len(touched_lists[k])] = \
                [acct_local[g] for g in touched_lists[k]]
        return txds, t_idxs, s_idxs, acct_gids, slot_gids, touched_lists

    def _issue_window_run(self, items: List[Tuple[Block, dict]]) -> dict:
        """One kernel launch for a whole run of transfer blocks: upload
        the stacked batches, launch, and start the fetch tensor's copy
        back into pinned memory (an event marks its arrival)."""
        if self.mesh is not None:
            return self._issue_window_mesh(items)
        t0 = time.monotonic()
        (txds, t_idxs, s_idxs, acct_gids, slot_gids,
         touched_lists) = self._prepare_window(items)
        st = self.state
        ups = [_upload(a, self.device)
               for a in (acct_gids, slot_gids, txds, t_idxs, s_idxs)]
        st.balances, st.nonces, st.slot_vals, fetches = _transfer_window(
            st.balances, st.nonces, st.slot_vals, *ups)
        return self._fetch_window(items, fetches, touched_lists, ups, t0)

    def _issue_window_mesh(self, items: List[Tuple[Block, dict]]) -> dict:
        """The window on the sharded kernel (K8, one cluster launch): the
        window locals' rows are already shard-major device rows
        (``row_of``), the tx axis is interleaved over the shards, and the
        exchange's collective follows ``exchange`` or the touched set's
        density against the tables.  The fetch tensor has the
        single-device layout, so ``_complete_window_run`` is shared."""
        from coreth_tpu_torch.parallel.shard import exchange_mode
        from coreth_tpu_torch.replay.shard import (
            interleave_txs, sharded_transfer_window)
        t0 = time.monotonic()
        (txds, t_idxs, s_idxs, acct_rows, slot_rows,
         touched_lists) = self._prepare_window(items)
        st = self.state
        n = self.n_shards
        mode = exchange_mode(acct_rows.shape[0] + slot_rows.shape[0],
                             st.capacity + st.slot_capacity, n,
                             forced=self.exchange,
                             density=self.exchange_density)
        perm = interleave_txs(txds.shape[1], n)
        ups = [_upload(a, self.device) for a in
               (acct_rows, slot_rows, txds[:, perm], t_idxs, s_idxs)]
        st.balances, st.nonces, st.slot_vals, fetches = \
            sharded_transfer_window(st.balances, st.nonces, st.slot_vals,
                                    *ups, n=n, mode=mode)
        if mode == "psum":
            self.stats.exchange_psum += 1
        else:
            self.stats.exchange_ppermute += 1
        return self._fetch_window(items, fetches, touched_lists, ups, t0)

    def _fetch_window(self, items, fetches, touched_lists, ups,
                      t0: float) -> dict:
        """Start the fetch tensor's copy into pinned memory with an
        event marking its arrival; the window handle for
        ``_complete_window_run``."""
        event = None
        if self.device.type == "cuda":
            host = torch.empty(fetches.shape, dtype=torch.int32,
                               pin_memory=True)
            host.copy_(fetches, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self.stats.reads_prefetched += 1
        else:
            host = fetches
        self.stats.t_device += time.monotonic() - t0
        return dict(items=items, fetches=host, event=event,
                    touched_lists=touched_lists, keep=(ups, fetches))

    def _complete_window_run(self, win: dict) -> None:
        """Validate a window from its fetched rows, stage every block,
        and fold the window once.  A block whose ok flag is 0, or that
        fails validation, raises ReplayError after the valid prefix
        before it is folded (so ``root`` is that prefix's)."""
        t0 = time.monotonic()
        if win["event"] is not None:
            win["event"].synchronize()   # the rows are in pinned memory
        arr = win["fetches"].numpy()
        self.stats.t_device += time.monotonic() - t0
        for k, (block, batch) in enumerate(win["items"]):
            if arr[k, -1, 0] != 1:
                self.commit_pipe.flush()
                raise _block_error(
                    "device execution rejected the block (nonce or "
                    f"solvency check failed); {_NOT_PORTED}", block)
            try:
                self._validate_and_advance(block, batch, arr[k],
                                           win["touched_lists"][k])
            except ReplayError:
                self.commit_pipe.flush()
                raise
        # ONE deduped fold + root check for the whole window
        self.commit_pipe.flush()

    def _validate_and_advance(self, block: Block, batch: dict,
                              fetched: np.ndarray,
                              touched: List[int]) -> None:
        """Host-side consensus checks + staged commit for one block."""
        gas_list = batch["gas_used"]
        cums = []
        cum = 0
        for g in gas_list:
            cum += g
            cums.append(cum)
        if cum != block.header.gas_used:
            raise _block_error(f"gas used mismatch; {_NOT_PORTED}", block)
        n = len(block.transactions)
        rec_root, bloom = native.receipt_root(
            cums, bytes(tx.tx_type for tx in block.transactions),
            bytes(n), b"")
        if rec_root != block.header.receipt_hash:
            raise _block_error(f"receipt root mismatch; {_NOT_PORTED}",
                               block)
        if bloom != block.header.bloom:
            raise _block_error(f"bloom mismatch; {_NOT_PORTED}", block)
        if self.config.is_apricot_phase4(block.time):
            try:
                self.engine.verify_block_fee(
                    block.base_fee, block.header.block_gas_cost,
                    block.transactions,
                    [Receipt(gas_used=g) for g in gas_list])
            except ConsensusError as exc:
                raise _block_error(f"block fee: {exc}", block) from exc
        t0 = time.monotonic()
        balances = u256.to_ints(fetched[:len(touched), :u256.LIMBS])
        nonces = fetched[:len(touched), u256.LIMBS]
        addrs = self.state.addrs
        self.commit_pipe.stage(block.header, {
            addrs[idx]: (balances[i], int(nonces[i]))
            for i, idx in enumerate(touched)})
        self.stats.t_trie += time.monotonic() - t0
        self.parent_header = block.header
        self.stats.blocks_device += 1
        self.stats.txs += n

    def _refuse(self, block: Block) -> ReplayError:
        return _block_error(
            "neither a value-transfer block nor a device-machine block; "
            f"{_NOT_PORTED}", block)

    # ------------------------------------------------------------- machine
    def _machine_executor(self):
        """Lazy general-bytecode block executor (machine_block.py)."""
        if self._machine is None:
            from coreth_tpu_torch.replay.machine_block import (
                MachineBlockExecutor)
            self._machine = MachineBlockExecutor(self)
        return self._machine

    def machine_counters(self) -> dict:
        """The machine path's counters (blocks, OCC rounds, conflict-
        suffix txs, step-machine launches and lane-steps)."""
        return self._machine_executor().counters()

    def _machine_run(self, blocks: List[Block], i: int,
                     ensure=None) -> int:
        """Run blocks the transfer classifier rejected, starting at
        ``i``: collect consecutive machine blocks (up to the executor's
        ``LOOKAHEAD`` with ``device_occ``, else one) into one run for
        ``MachineBlockExecutor.execute_run``.  A run stops at the first
        later block the transfer classifier takes, and at a fork change.
        Returns how many blocks were replayed (>= 1); raises ReplayError
        when the machine cannot take block ``i``."""
        mx = self._machine_executor()
        lookahead = mx.LOOKAHEAD if self.device_occ else 1
        items = []
        fork = None
        j = i
        while j < len(blocks) and len(items) < lookahead:
            if ensure is not None:
                ensure(j)
            t0 = time.monotonic()
            # blocks past the first stay with the cheaper transfer path
            # when it can take them (block i is here because it could
            # not); the outer loop classifies that block again
            if j > i and self._classify(blocks[j]) is not None:
                self.stats.t_classify += time.monotonic() - t0
                break
            plans = mx.classify(blocks[j])
            self.stats.t_classify += time.monotonic() - t0
            if plans is None or (fork is not None and mx._fork != fork):
                break
            fork = mx._fork
            items.append((blocks[j], plans))
            j += 1
        if not items:
            raise self._refuse(blocks[i])
        mx._fork = fork
        return mx.execute_run(items)

    def replay_block(self, block: Block) -> bytes:
        """Process one block synchronously."""
        self.warm_senders(block)
        t0 = time.monotonic()
        batch = self._classify(block)
        self.stats.t_classify += time.monotonic() - t0
        if batch is None:
            self._machine_run([block], 0)
            return self.root
        self._complete_window_run(self._issue_window_run([(block, batch)]))
        return self.root

    def replay(self, blocks: List[Block],
               window: Optional[int] = None) -> bytes:
        """Windowed, pipelined replay: window k+1 is classified (host)
        and launched (device) before window k is validated and folded,
        so the card runs while the host folds; sender recovery runs in
        look-ahead segments alongside."""
        window = window or self.window
        n = len(blocks)
        pipe = _SenderPipeline(self, blocks)
        i = 0
        pending: Optional[dict] = None
        while i < n or pending is not None:
            run: List[Tuple[Block, dict]] = []
            refused = None
            while i < n and len(run) < window:
                pipe.ensure(i)
                t0 = time.monotonic()
                batch = self._classify(blocks[i])
                self.stats.t_classify += time.monotonic() - t0
                if batch is None:
                    refused = blocks[i]
                    break
                run.append((blocks[i], batch))
                i += 1
            win = self._issue_window_run(run) if run else None
            if pending is not None:
                self._complete_window_run(pending)
            pending = win
            if refused is not None:
                if pending is not None:
                    self._complete_window_run(pending)
                    pending = None
                i += self._machine_run(blocks, i, ensure=pipe.ensure)
        return self.root

    def commit(self) -> bytes:
        """Fold anything staged; returns the state root."""
        self.commit_pipe.flush()
        return self.trie.hash()
