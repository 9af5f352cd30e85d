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
   precompile or prohibited address) or, with ``token_fastpath`` (the
   reference's default), an ERC-20 ``transfer()`` call on the known
   token runtime: exact gas from the measured exec-gas variants, the
   Transfer log, and the mapping slots' debit and credit for the
   kernel's slot half, their values simulated on the host.
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
4. **Commit** (host): one deduped fold per window, in the C++ trie or
   (``trie="py"``) in Python tries rehashed level by level on K3's
   entry, root checked against the header (replay/commit.py).

A block the transfer classifier rejects goes to the machine path:
``MachineBlockExecutor.classify`` takes it when every tx is a transfer
or a call into device-eligible contract code.  With ``device_occ`` the
engine collects up to ``LOOKAHEAD`` consecutive such blocks and runs
them in windows of the fused OCC kernel (K6, with K5's lane interpreter,
the K4 ALU and K3 keccak inside, and with ``specialize`` the traced
programs of the contracts the tracer accepts, K7); without it, each
block runs on the step machine (K5) with miss-and-rerun storage rounds,
OCC validation on the host, and the conflict suffix on the host
interpreter (``EVM.call``, served by the native session where it can).
With ``serial_shortcircuit`` provably serial blocks (one contract,
constant storage keys: the swap shape) skip the device and run on the
native session.

A block neither path takes — contract creation, host-only opcodes,
precompile calls (``nativeAssetCall`` too), atomic ExtData, a sender or
callee with multicoin balances, a lane that escapes the machine — runs
on the exact host path (``_fallback``: the ``Processor`` over a
journaled ``StateDB`` on the engine's store, finalized by the engine's
callbacks), and so does a transfer-window block
whose device ``ok`` flag is 0 or that fails a consensus check: the
window rewinds to its start, re-applies its valid prefix on the device
(``_recover_window``), and the block runs on the host path.  A block
that fails there too raises ``ReplayError`` with ``.block`` set, the
engine's root and the store's tries at the valid prefix
(``quarantine_block`` applies such a block tolerantly instead and
returns the checks it failed).

The flat-state layer (``state/flat``, ``flat=True``, the reference's
default ``CORETH_FLAT=1``) serves the cold reads: an account's row and
a slot's value are read from its raw-keyed dicts before the tries, and
filled on a miss; every flushed window and every host-path block seals
one generation of it, with its undo, so ``rollback_block`` can pop a
quarantined block again, and the checkpoint exporter
(``replay/checkpoint.py``) re-derives the tries from the generations
off the execute thread.  ``flat_check`` re-derives every flat hit from
the tries (``ReplayError("flat oracle ...")`` on a divergence).

Faults: the window launches go through the engine's
``BackendSupervisor`` (``replay/supervisor.py``) at the
``device/dispatch`` injection point, a run whose dispatch fails past
its retries replays on the host path, and a demoted ``device`` scope
sends every block there until its cooldown lapses; an injected
``recover/fault`` degrades a sender segment to per-tx recovery.  Only
injected faults (and the hostexec session's own errors) are caught: a
kernel's build error or a CUDA error propagates out of ``replay``.
Spans (``obs``) mark sender recovery, the window issue and completion,
the folds and the host path, and with ``device_spans`` the launches.
"""

from __future__ import annotations

import ctypes
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from coreth_tpu_torch import default_device, faults, kernels, obs, rlp
from coreth_tpu_torch.consensus.engine import ConsensusError, DummyEngine
from coreth_tpu_torch.crypto import keccak256, native
from coreth_tpu_torch.crypto import secp_device
from coreth_tpu_torch.crypto.secp256k1 import N as SECP_N
from coreth_tpu_torch.evm.precompiles import (
    is_prohibited, special_call_targets,
)
from coreth_tpu_torch.mpt import derive_hasher, native_trie
from coreth_tpu_torch.mpt.rehash import DEFAULT_MIN_BATCH
from coreth_tpu_torch.ops import u256
from coreth_tpu_torch.parallel.mesh import gather_index, segment_sum
from coreth_tpu_torch.parallel.shard import (
    account_bucket, contract_bucket, remap_rows,
)
from coreth_tpu_torch.params import ChainConfig
from coreth_tpu_torch.params import protocol as P
from coreth_tpu_torch.processor import Processor
from coreth_tpu_torch.replay.supervisor import BackendFault, BackendSupervisor
from coreth_tpu_torch.state import StateDB, StateStore, normalize_state_key
from coreth_tpu_torch.state.flat import (
    FlatStateView, FlatStore, flat_diff_from_statedb,
)
from coreth_tpu_torch.types import (
    Block, LatestSigner, Log, Receipt, StateAccount, derive_sha,
)
from coreth_tpu_torch.types.account import EMPTY_CODE_HASH, EMPTY_ROOT_HASH
from coreth_tpu_torch.workloads.erc20 import (
    TOKEN_CODE_HASH, TRANSFER_TOPIC, balance_slot, measure_transfer_exec_gas,
    parse_transfer_calldata,
)


class ReplayError(Exception):
    """A block the engine cannot replay; ``.block`` is that block (None
    when the failure is not one block's, e.g. a window root mismatch)."""

    block: Optional[Block] = None


def _block_error(msg: str, block: Block) -> ReplayError:
    err = ReplayError(f"block {block.number}: {msg}")
    err.block = block
    return err


# Injection points on the replay engine's failure seams (armed only by a
# FaultPlan, coreth_tpu_torch/faults; one None check unarmed):
PT_DISPATCH = faults.declare(
    "device/dispatch", "raise at window dispatch (transfer + fused OCC)")
PT_RECOVER = faults.declare(
    "recover/fault", "batched sender recovery failure (device or host)")


@dataclass
class ReplayStats:
    blocks_device: int = 0
    # blocks the exact host path (``_fallback``) replayed, and its seconds
    blocks_fallback: int = 0
    txs: int = 0
    t_classify: float = 0.0
    t_sender: float = 0.0
    t_device: float = 0.0
    t_trie: float = 0.0
    t_fallback: float = 0.0
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
    # blocks applied tolerantly by quarantine_block, and popped again
    # by rollback_block
    blocks_quarantined: int = 0
    blocks_rolled_back: int = 0

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
# semantics follow jnp: a gather wraps a negative index once and clamps
# the result (``gather_index``), a segment sum or scatter drops an
# out-of-range index; the engine only ever produces in-range local
# indices, and pads global ids with ``capacity`` (gather 0, drop).

def _gather(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return arr[gather_index(idx, arr.shape[0])]


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
    debit_tot = u256.normalize(segment_sum(debit, sender_idx, num_accounts))
    required_tot = u256.normalize(
        segment_sum(required, sender_idx, num_accounts))
    credit_tot = u256.normalize(segment_sum(credit, recip_idx, num_accounts))
    # an int32 sum, as jnp's (torch would widen to int64)
    fee_total = u256.normalize((fee16 * mask_i).sum(0, dtype=torch.int32))
    if 0 <= coinbase_idx < num_accounts:
        credit_tot[coinbase_idx] += fee_total
    credit_tot = u256.normalize(credit_tot)
    send_counts = segment_sum(mask_i, sender_idx, num_accounts)[:, 0]
    solvent = u256.gte(balances, required_tot)
    ok = nonce_ok & torch.all(solvent | (send_counts == 0))
    new_balances = u256.sub(u256.add(balances, credit_tot), debit_tot)
    return new_balances, nonces + send_counts, ok


def _slot_step_plain(slot_vals, from_slot, to_slot, amount16, mask,
                     num_slots: int):
    """Batched ERC-20 mapping-slot debits/credits (reference _slot_step)."""
    amt = amount16 * mask.to(torch.int32)[:, None]
    debit_tot = u256.normalize(segment_sum(amt, from_slot, num_slots))
    credit_tot = u256.normalize(segment_sum(amt, to_slot, num_slots))
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


# K1's scratch cap (int32 words; csrc/transfer_window.cu's header gives
# its size by shape)
MAX_WINDOW_SCRATCH = 1 << 30
# (device index, K, pad, L, SL, t_pad, s_pad) -> transfer_window_plan's
# (scratch words, shared bytes, layout, compact rows)
_PLANS: Dict[tuple, tuple] = {}


def window_plan(dev: torch.device, K: int, pad: int, L: int, SL: int,
                t_pad: int, s_pad: int) -> tuple:
    """K1's plan for a window shape on ``dev``: (scratch int32 words,
    shared bytes of phase (a)'s accumulators, layout: 1 sums in shared
    memory / 0 in device memory, compact account rows a block)."""
    key = (dev.index, K, pad, L, SL, t_pad, s_pad)
    plan = _PLANS.get(key)
    if plan is None:
        out = (ctypes.c_longlong * 4)()
        with torch.cuda.device(dev):
            rc = kernels.load("transfer_window").transfer_window_plan(
                K, pad, L, SL, t_pad, s_pad, -1, out)
        kernels.check(rc, "transfer_window_plan")
        plan = _PLANS[key] = tuple(out)
    return plan


def _transfer_window(balances, nonces, slot_vals, acct_gids, slot_gids,
                     txds, t_idxs, s_idxs, split_ms=None):
    """One window of blocks: the CUDA kernel (``csrc/transfer_window.cu``,
    three launches on the current stream, asynchronous) for CUDA
    tensors; the plain version for CPU tensors.  The input tables are not
    modified.  ``split_ms`` (a list, CUDA only) receives the milliseconds
    of the kernel's phases (a), (b), (c); the call then waits for them."""
    args = (balances, nonces, slot_vals, acct_gids, slot_gids, txds,
            t_idxs, s_idxs)
    dev = check_window_args("_transfer_window", args)
    if dev.type == "cpu":
        return _transfer_window_plain(*args)
    global LAUNCHES
    K, pad = txds.shape[:2]
    L, SL = acct_gids.shape[0], slot_gids.shape[0]
    t_pad, s_pad = t_idxs.shape[1], s_idxs.shape[1]
    words, _smem, layout, _ca = window_plan(dev, K, pad, L, SL, t_pad,
                                            s_pad)
    if words > MAX_WINDOW_SCRATCH:
        raise ValueError(f"_transfer_window: the kernel's scratch of {words} "
                         f"words is past {MAX_WINDOW_SCRATCH}")
    lib = kernels.load("transfer_window")
    (acct_gids, slot_gids, txds, t_idxs, s_idxs) = (
        t.contiguous() for t in (acct_gids, slot_gids, txds, t_idxs,
                                 s_idxs))
    nb, nn, nsv = balances.clone(), nonces.clone(), slot_vals.clone()
    i32 = dict(dtype=torch.int32, device=dev)
    scratch = torch.empty((words,), **i32)
    fetches = torch.empty((K, t_pad + s_pad + 1, u256.LIMBS + 1), **i32)
    split = (ctypes.c_float * 3)() if split_ms is not None else None
    rc = lib.transfer_window_launch(
        nb.data_ptr(), nn.data_ptr(), nsv.data_ptr(), nb.shape[0],
        nsv.shape[0], acct_gids.data_ptr(), L, slot_gids.data_ptr(), SL,
        txds.data_ptr(), K, pad, t_idxs.data_ptr(), t_pad,
        s_idxs.data_ptr(), s_pad, layout, scratch.data_ptr(), words,
        fetches.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        split)
    kernels.check(rc, "transfer_window")
    LAUNCHES += 1
    if split is not None:
        split_ms[:] = list(split)
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
        # storage slots of the token fast path: (contract, key) -> slot
        # index (sid); sid 0 is the reserved dummy (shard 0, row 0)
        self.slot_capacity = slot_capacity
        self.slot_index: Dict[Tuple[bytes, bytes], int] = {}
        self.slot_keys: List[Tuple[bytes, bytes]] = [(b"", b"")]
        self.slots_by_contract: Dict[bytes, List[int]] = {}
        self.slot_row_of: List[int] = [0]
        self._srow = [1 if s == 0 else 0 for s in range(n_shards)]
        self._cbucket: Dict[bytes, int] = {}  # contract -> owning shard
        self.slot_vals = torch.zeros((slot_capacity, u256.LIMBS),
                                     dtype=torch.int32, device=self.device)
        # host mirror of slot values as of the last validated block: the
        # classifier's gas-variant simulation reads it
        self.slot_host: List[int] = [0]
        self._staged_slots: List[Tuple[int, int]] = []

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

    def ensure_slot(self, contract: bytes, key: bytes, value: int) -> int:
        """Slot index of (contract, normalized key), allocating its device
        row (the contract's bucket's arena on a mesh) and staging its
        current ``value`` on first touch."""
        sid = self.slot_index.get((contract, key))
        if sid is not None:
            return sid
        sid = len(self.slot_keys)
        self.slot_index[(contract, key)] = sid
        self.slot_keys.append((contract, key))
        self.slots_by_contract.setdefault(contract, []).append(sid)
        row = self._alloc_slot_row(contract)  # may replace slot_row_of
        self.slot_row_of.append(row)
        self.slot_host.append(value)
        if value:
            self._staged_slots.append((sid, value))
        return sid

    def flush_staged(self):
        """Write the staged values of accounts and slots (the last staged
        value of a slot wins).  Returns the (accounts, slots) lists it
        wrote, so a speculative window can re-stage them if its tables
        are discarded after a rewind."""
        flushed = (self._staged, self._staged_slots)
        if self._staged:
            idx = np.asarray([self.row_of[s[0]] for s in self._staged],
                             dtype=np.int64)
            bal = u256.pack_np([s[1] for s in self._staged])
            non = np.asarray([s[2] for s in self._staged], dtype=np.int32)
            didx = _upload(idx, self.device)
            _scatter_drop(self.balances, didx, _upload(bal, self.device))
            _scatter_drop(self.nonces, didx, _upload(non, self.device))
            self._staged = []
        if self._staged_slots:
            last = dict(self._staged_slots)
            idx = np.asarray([self.slot_row_of[sid] for sid in last],
                             dtype=np.int64)
            vals = u256.pack_np(list(last.values()))
            _scatter_drop(self.slot_vals, _upload(idx, self.device),
                          _upload(vals, self.device))
            self._staged_slots = []
        return flushed

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
        obs.instant("replay/sender_issue", seg=s)
        t0 = time.monotonic()
        try:
            faults.fire(PT_RECOVER)
        except faults.FaultInjected:
            # degrade: the segment's senders recover per tx, lazily
            self.issued.append({"todo": [], "kind": "empty"})
            eng.stats.t_sender += time.monotonic() - t0
            return
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
    as in the reference.  ``token_fastpath`` (default on; off is the
    reference's ``CORETH_NO_TOKEN_FASTPATH=1``) classifies ERC-20
    ``transfer()`` calls onto the transfer windows instead of the
    machine.  ``serial_shortcircuit`` (default on, the reference's
    ``CORETH_SERIAL_SHORTCIRCUIT=1``) sends provably serial machine
    blocks (``MachineBlockExecutor._serial_eligible``) straight to the
    native host session.  A block no device path takes runs on the
    exact host path (``Processor``), finalized by ``engine``: a
    ``DummyEngine`` whose callbacks (``atomic.make_callbacks``) apply
    ExtData blocks' atomic txs there (the reference's
    onExtraStateChange, plugin/evm/vm.go:986); by default one without
    callbacks, which refuses a block with ExtData gas.

    ``mesh`` (``parallel.make_mesh(n)``, n > 1) shards the state tables
    over n shards of the one card: transfer windows run on the sharded
    window kernel (K8, ``replay/shard.py``) over shard-major tables, and
    device sender recovery on the sharded ladder (K8r).  ``capacity``,
    ``slot_capacity`` and ``batch_pad`` must divide by n.  Machine
    windows run per shard in one cluster launch (K9, the reference's
    default ``CORETH_SHARD_OCC=1``, ``evm/device/shard.py``), each with
    its flags reduce inside; ``shard_occ=False`` keeps the
    single-chip window runner over the sharded tables instead
    (``CORETH_SHARD_OCC=0``).  ``exchange`` ("psum" or "ppermute", the
    reference's ``CORETH_EXCHANGE``) forces the exchanges' collective;
    None picks it per window by density (``exchange_density``,
    ``CORETH_EXCHANGE_DENSITY``).  ``keyrange`` (``CORETH_KEYRANGE``)
    lets a contract with ``keyrange_threshold`` lanes in one block
    (``CORETH_KEYRANGE_THRESHOLD``) place its keys by key range, with
    the replica sync inside K9.  ``shard_recover``
    (``CORETH_SHARD_RECOVER``) sends every sender segment to the
    sharded ladder, however small, on any device.

    ``trie`` picks the state's tries (the reference's ``CORETH_TRIE``):
    ``"native"`` (default) folds each window in the C++ trie, and raises
    here when the library does not load; ``"py"`` folds it in Python
    tries (``mpt/trie.py``) and rehashes each trie level by level with
    ``mpt/rehash.py device_rehash`` — K3's entry on every level of at
    least ``rehash_min_batch`` encodings (the reference's
    ``CORETH_REHASH_MIN_BATCH``; the default keeps the host).  The
    store must hold tries of that backend (``StateStore(backend=,
    check=)``); another raises ``ValueError``.
    ``trie_check`` (``CORETH_TRIE_CHECK``, native only) keeps a Python
    twin of every C++ trie and re-derives each window root on it
    (``TrieOracleError`` on a divergence).  ``supervisor`` is the
    ``BackendSupervisor`` of the fault ladder (default: one with the
    reference's settings).  ``host_exec_check``
    (``CORETH_HOST_EXEC_CHECK``) re-runs every native hostexec call on
    the interpreter and compares.

    ``flat`` (default on, the reference's ``CORETH_FLAT=1``) keeps the
    flat-state layer (``self.flat``, a ``FlatStore``): the account and
    slot cold reads that fill the device rows and the slot table, and
    every host StateDB, read it before the tries; off, they walk the
    tries only.  ``flat_check`` (``CORETH_FLAT_CHECK``) re-derives every
    flat hit from the tries and raises on a divergence."""

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
                 exchange_density: float = 0.25,
                 token_fastpath: bool = True,
                 serial_shortcircuit: bool = True,
                 engine: Optional[DummyEngine] = None,
                 trie: str = "native", trie_check: bool = False,
                 rehash_min_batch: int = DEFAULT_MIN_BATCH,
                 supervisor: Optional[BackendSupervisor] = None,
                 host_exec_check: bool = False, flat: bool = True,
                 flat_check: bool = False):
        self.device = default_device(device)
        self.token_fastpath = token_fastpath
        self.serial_shortcircuit = serial_shortcircuit
        self.device_occ = device_occ
        self.specialize = specialize
        self.shard_occ = shard_occ
        self.keyrange = keyrange
        self.keyrange_threshold = keyrange_threshold
        self.exchange_density = exchange_density
        self.config = config
        if trie == "native":
            native_trie.require()
        if (state.backend, state.check) != (trie, trie_check):
            raise ValueError(
                f"engine trie={trie!r}, trie_check={trie_check} over a "
                f"store of backend={state.backend!r}, "
                f"check={state.check}: build the store with "
                "StateStore(backend=, check=)")
        self.trie_backend = trie
        self.trie_check = trie_check
        self.rehash_min_batch = rehash_min_batch
        self.store = state
        self.trie = self.store.trie
        self.root = self.trie.hash()
        # CORETH_FAULT_PLAN / CORETH_TRACE arm the fault registry and the
        # span tracer for this process if nothing armed them yet
        faults.arm_from_env()
        obs.arm_from_env()
        self.supervisor = supervisor if supervisor is not None \
            else BackendSupervisor(self)
        # the hostexec bridge finds this engine's supervisor and oracle
        # switch through the store its StateDBs share
        state.fault_observer = self.supervisor
        state.host_exec_check = host_exec_check
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
        self.engine = engine or DummyEngine()
        self.engine.set_config(config)
        self.processor = Processor(config, engine=self.engine)
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
        # the classifier's view of slot values of blocks classified but
        # not yet validated (sequential sim across a pending window)
        self._slot_overlay: Dict[int, int] = {}
        # token gas variants per fork schedule, and (contract, address)
        # -> slot index shortcuts: the classifier runs per tx
        self._vg_cache: Dict[tuple, dict] = {}
        self._addr_slot: Dict[Tuple[bytes, bytes], int] = {}
        # bumped whenever the token path writes contract storage: the
        # machine executor's window runner rebuilds when it sees a bump
        # (its mirror and device table can no longer be trusted)
        self.storage_epoch = 0
        # the flat-state layer: O(1) cold reads, one generation per
        # commit unit (the rollback and checkpoint-export unit)
        self.flat = FlatStore() if flat else None
        self._flat_check = flat_check
        self._flat_view_memo = None
        # the StateDB of the newest quarantined block, its undo log kept
        # for rollback_block
        self._quarantine_sdb = None

    def close(self) -> None:
        """Stop the recovery worker thread."""
        if self._recover_pool is not None:
            self._recover_pool.shutdown(wait=True)
            self._recover_pool = None

    # ---------------------------------------------------------------- index
    def _flat_view(self) -> Optional[FlatStateView]:
        """The StateDB-facing flat adapter (the host path's and the
        machine executor's scratch StateDBs read flat-first too); None
        when the layer is off."""
        if self.flat is None:
            return None
        if self._flat_view_memo is None:
            self._flat_view_memo = FlatStateView(self.flat,
                                                 self._flat_check)
        return self._flat_view_memo

    def _flat_oracle_fail(self, what: str, addr: bytes, got, want) -> None:
        raise ReplayError(
            f"flat oracle divergence ({what}) at {addr.hex()}: "
            f"flat={got!r} trie={want!r}")

    def _account(self, addr: bytes) -> int:
        idx = self.state.index.get(addr)
        if idx is not None:
            return idx
        view = self._flat_view()
        if view is None:
            raw = self.trie.get(addr)
            account = StateAccount.from_rlp(raw) if raw is not None \
                else None
        else:
            account = view.load_account(addr, self.trie, ReplayError)
        return self.state.ensure(addr, account)

    def _storage_trie(self, contract: bytes):
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

    def committed_value(self, contract: bytes, key: bytes,
                        what: str = "slot") -> int:
        """Committed value of (normalized) slot ``key``: staged-but-
        unfolded writes first (they have not folded yet), then the flat
        layer (``what`` names the reader in an oracle failure), then the
        storage trie, whose value fills the flat layer."""
        value = self.commit_pipe.base_value(contract, key)
        if value is not None:
            return value
        flat = self.flat
        if flat is not None:
            value = flat.storage_value(contract, key)
            if value is not None:
                if self._flat_check:
                    want = self.storage_value(contract, key)
                    if want != value:
                        self._flat_oracle_fail(what, contract, value, want)
                return value
        value = self.storage_value(contract, key)
        if flat is not None:
            flat.fill_storage(contract, key, value)
        return value

    def _slot(self, contract: bytes, key: bytes) -> int:
        """Slot index of (contract, EVM storage key), loading its current
        value on first touch (``committed_value``).  Keys are normalized
        as the state writes them."""
        key = normalize_state_key(key)
        sid = self.state.slot_index.get((contract, key))
        if sid is not None:
            return sid
        return self.state.ensure_slot(contract, key,
                                      self.committed_value(contract, key))

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
        """Synchronous batched sender recovery over a block or a list;
        an injected ``recover/fault`` leaves the senders to per-tx
        recovery."""
        if isinstance(blocks, Block):
            blocks = [blocks]
        with obs.span("replay/sender_recover", blocks=len(blocks)):
            try:
                faults.fire(PT_RECOVER)
            except faults.FaultInjected:
                return
            self._warm_senders_run(blocks)

    def _warm_senders_run(self, blocks) -> None:
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
        """Batch inputs if the block is device-replayable, else None.

        Two tx shapes replay on the window kernels, mixed freely within a
        block: pure value transfers, and (with ``token_fastpath``, from
        Apricot Phase 1 on) ERC-20 ``transfer()`` calls on contracts whose
        runtime is
        the known token (``workloads/erc20``).  For token calls
        the classifier derives each tx's exact gas by simulating the
        mapping-slot values on the host and builds the Transfer log; the
        u256 slot arithmetic runs batched on the device (the kernels'
        slot half).  A block's slot simulation becomes visible to the
        next block's only once the whole block classified clean."""
        if block.ext_data():
            return None
        if not self.supervisor.allows("device"):
            # the supervisor demoted the device scope: every block takes
            # the host path until the cooldown lapses (the first allowed
            # classify after that is the probe)
            return None
        base_fee = block.base_fee
        rules = self.config.rules(block.number, block.time)
        avoid = special_call_targets(rules)
        token_ctx = self._token_block_ctx(rules, block) \
            if rules.is_apricot_phase1 and self.token_fastpath else None
        senders, recips, values, fees, required, nonces, offsets = \
            [], [], [], [], [], [], []
        from_slots, to_slots, amounts, gas_used, tx_logs = \
            [], [], [], [], []
        seen_count: Dict[bytes, int] = {}
        overlay: Dict[int, int] = {}  # this block's slot sim, uncommitted
        state = self.state
        has_code, multicoin = state.has_code, state.multicoin
        acct_index = state.index
        account = self._account
        sender_of = self.signer.sender
        for tx in block.transactions:
            if tx.to is None or tx.access_list:
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
            if tx.data:
                if token_ctx is None:
                    return None
                out = self._classify_token(tx, sender, r_idx, token_ctx,
                                           overlay)
                if out is None:
                    return None
                f_s, t_s, amt, used, log = out
                values.append(0)
                from_slots.append(f_s)
                to_slots.append(t_s)
                amounts.append(amt)
                tx_logs.append(log)
            else:
                if tx.gas != P.TX_GAS:
                    return None
                if has_code[r_idx] or multicoin[r_idx]:
                    return None
                used = P.TX_GAS
                values.append(tx.value)
                from_slots.append(0)
                to_slots.append(0)
                amounts.append(0)
                tx_logs.append(None)
            senders.append(s_idx)
            recips.append(r_idx)
            gas_used.append(used)
            fees.append(used * price)
            # buyGas requirement (cap-based for typed txs)
            required.append(tx.gas * gas_fee_cap + tx.value)
            nonces.append(tx.nonce)
            prev = seen_count.get(sender, 0)
            offsets.append(prev)
            seen_count[sender] = prev + 1
        coinbase_idx = self._account(block.header.coinbase)
        # the block classified clean: its slot writes become visible to
        # the next block's classification within this pending window
        self._slot_overlay.update(overlay)
        return dict(senders=senders, recips=recips, values=values,
                    fees=fees, required=required, nonces=nonces,
                    offsets=offsets, coinbase=coinbase_idx,
                    from_slots=from_slots, to_slots=to_slots,
                    amounts=amounts, gas_used=gas_used, logs=tx_logs)

    def _slot_view(self, sid: int, overlay: Dict[int, int]) -> int:
        """Sequential slot value at the classification point: this
        block's sim, then the pending window's, then the validated
        mirror."""
        v = overlay.get(sid)
        if v is not None:
            return v
        v = self._slot_overlay.get(sid)
        if v is not None:
            return v
        return self.state.slot_host[sid]

    def _token_block_ctx(self, rules, block: Block) -> dict:
        """Per-block constants of the token fast path: the three exec-gas
        variants (measured once per fork schedule,
        ``measure_transfer_exec_gas``) and the calldata gas constants."""
        key = tuple(v for f, v in sorted(vars(rules).items())
                    if f.startswith("is_"))
        vg = self._vg_cache.get(key)
        if vg is None:
            vg = self._vg_cache[key] = {
                v: measure_transfer_exec_gas(self.config, block.number,
                                             block.time, v)
                for v in ("noop", "set", "reset")}
        nz_gas = (P.TX_DATA_NON_ZERO_GAS_EIP2028 if rules.is_istanbul
                  else P.TX_DATA_NON_ZERO_GAS_FRONTIER)
        return dict(vg=vg, nz_gas=nz_gas, z_gas=P.TX_DATA_ZERO_GAS)

    def _classify_token(self, tx, sender: bytes, r_idx: int,
                        token_ctx: dict, overlay: Dict[int, int]):
        """One ERC-20 ``transfer()`` call: (from_slot, to_slot, amount,
        gas_used, Log), or None when the fast path cannot take it (not
        the token, a self-transfer, a transfer that would revert or run
        out of gas).  Gas is exact: the intrinsic calldata gas plus the
        measured exec gas of the variant this tx hits."""
        if self.state.code_hashes[r_idx] != TOKEN_CODE_HASH:
            return None
        if tx.value != 0:
            return None
        data = tx.data
        parsed = parse_transfer_calldata(data)
        if parsed is None:
            return None
        to_addr, amt = parsed
        if to_addr == sender:
            return None  # self-transfer: another SSTORE sequence
        token = tx.to
        addr_slot = self._addr_slot
        f_s = addr_slot.get((token, sender))
        if f_s is None:
            f_s = addr_slot[(token, sender)] = self._slot(
                token, balance_slot(sender))
        t_s = addr_slot.get((token, to_addr))
        if t_s is None:
            t_s = addr_slot[(token, to_addr)] = self._slot(
                token, balance_slot(to_addr))
        fv = self._slot_view(f_s, overlay)
        tv = self._slot_view(t_s, overlay)
        if fv < amt:
            return None  # would revert: the machine path's block
        vg = token_ctx["vg"]
        exec_gas = vg["noop"] if amt == 0 else (
            vg["set"] if tv == 0 else vg["reset"])
        nz = 68 - data.count(0)
        used = (P.TX_GAS + nz * token_ctx["nz_gas"]
                + (68 - nz) * token_ctx["z_gas"] + exec_gas)
        if tx.gas < used:
            return None  # would run out of gas: a status-0 receipt
        overlay[f_s] = fv - amt
        overlay[t_s] = (tv + amt) & ((1 << 256) - 1)  # unchecked ADD wraps
        log = Log(address=token,
                  topics=[TRANSFER_TOPIC, b"\x00" * 12 + sender,
                          b"\x00" * 12 + to_addr],
                  data=amt.to_bytes(32, "big"))
        return f_s, t_s, amt, used, log

    # ---------------------------------------------------------------- replay
    def _prepare_window(self, items: List[Tuple[Block, dict]]):
        """Pack a run of classified blocks into stacked device inputs,
        over window-local index spaces (the kernel's cost scales with
        the window's touched set, not the table capacity).  The window
        pads to the next power of two of its length with all-masked
        batches."""
        flushed = self.state.flush_staged()
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

        def s_loc(g: int) -> int:
            l = slot_local.get(g)
            if l is None:
                l = len(slot_local)
                slot_local[g] = l
            return l

        slot_lists = []
        local_batches = []
        for block, batch in items:
            B = len(block.transactions)
            while pad < B:
                pad *= 2
            lb = dict(batch)
            lb["senders"] = [a_loc(g) for g in batch["senders"]]
            lb["recips"] = [a_loc(g) for g in batch["recips"]]
            lb["coinbase"] = a_loc(batch["coinbase"])
            lb["from_slots"] = [s_loc(g) for g in batch["from_slots"]]
            lb["to_slots"] = [s_loc(g) for g in batch["to_slots"]]
            local_batches.append(lb)
            touched = sorted(set(batch["senders"]) | set(batch["recips"])
                             | {batch["coinbase"]})
            touched_lists.append(touched)
            while t_pad < len(touched):
                t_pad *= 2
            slots = sorted((set(batch["from_slots"])
                            | set(batch["to_slots"])) - {0})
            slot_lists.append(slots)
            while s_pad < len(slots):
                s_pad *= 2
        L = 256
        while L < len(acct_local):
            L *= 2
        SL = 8
        while SL < len(slot_local):
            SL *= 2
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
            s_idxs[k, :len(slot_lists[k])] = \
                [slot_local[g] for g in slot_lists[k]]
        return (txds, t_idxs, s_idxs, acct_gids, slot_gids, touched_lists,
                slot_lists, flushed)

    def _issue_window(self, items: List[Tuple[Block, dict]]) -> dict:
        """Supervised window dispatch at the ``device/dispatch`` point:
        transient faults retry with backoff, persistent ones strike
        toward device demotion and surface as ``BackendFault`` (replay
        sends the run to the exact host path)."""
        with obs.span("replay/issue_window", blocks=len(items)):
            return self.supervisor.run("device", PT_DISPATCH,
                                       self._issue_window_run, items)

    def _issue_window_run(self, items: List[Tuple[Block, dict]],
                          fetch: bool = True) -> Optional[dict]:
        """One kernel launch for a whole run of transfer blocks: upload
        the stacked batches, launch, and start the fetch tensor's copy
        back into pinned memory (an event marks its arrival).  The
        window handle keeps the tables the launch started from (the
        kernel writes into clones), for a rewind.  ``fetch=False``
        launches for the tables alone (a rewind's prefix re-apply) and
        returns None."""
        if self.mesh is not None:
            return self._issue_window_mesh(items, fetch)
        t0 = time.monotonic()
        (txds, t_idxs, s_idxs, acct_gids, slot_gids, touched_lists,
         slot_lists, flushed) = self._prepare_window(items)
        st = self.state
        prev = (st.balances, st.nonces, st.slot_vals)
        ups = [_upload(a, self.device)
               for a in (acct_gids, slot_gids, txds, t_idxs, s_idxs)]
        with obs.device_span("coreth/transfer_window"):
            st.balances, st.nonces, st.slot_vals, fetches = \
                _transfer_window(st.balances, st.nonces, st.slot_vals, *ups)
        if not fetch:
            self.stats.t_device += time.monotonic() - t0
            return None
        return self._fetch_window(items, fetches, touched_lists, slot_lists,
                                  ups, t0, prev, flushed)

    def _issue_window_mesh(self, items: List[Tuple[Block, dict]],
                           fetch: bool = True) -> Optional[dict]:
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
        (txds, t_idxs, s_idxs, acct_rows, slot_rows, touched_lists,
         slot_lists, flushed) = self._prepare_window(items)
        st = self.state
        prev = (st.balances, st.nonces, st.slot_vals)
        n = self.n_shards
        mode = exchange_mode(acct_rows.shape[0] + slot_rows.shape[0],
                             st.capacity + st.slot_capacity, n,
                             forced=self.exchange,
                             density=self.exchange_density)
        perm = interleave_txs(txds.shape[1], n)
        ups = [_upload(a, self.device) for a in
               (acct_rows, slot_rows, txds[:, perm], t_idxs, s_idxs)]
        with obs.device_span("coreth/transfer_window"):
            st.balances, st.nonces, st.slot_vals, fetches = \
                sharded_transfer_window(st.balances, st.nonces,
                                        st.slot_vals, *ups, n=n, mode=mode)
        if mode == "psum":
            self.stats.exchange_psum += 1
        else:
            self.stats.exchange_ppermute += 1
        if not fetch:
            self.stats.t_device += time.monotonic() - t0
            return None
        return self._fetch_window(items, fetches, touched_lists, slot_lists,
                                  ups, t0, prev, flushed)

    def _fetch_window(self, items, fetches, touched_lists, slot_lists, ups,
                      t0: float, prev, flushed) -> dict:
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
                    touched_lists=touched_lists, slot_lists=slot_lists,
                    t_pad=ups[3].shape[1], keep=(ups, fetches), prev=prev,
                    flushed=flushed)

    def _discard_window(self, win: dict) -> None:
        """Drop a speculatively issued window whose base state a rewind
        invalidated.  The tables are already back at the failed window's
        start plus its re-applied prefix and the host path's refresh;
        what would be lost are the rows FIRST written by the discarded
        window's issue (its flushed staged rows).  Re-stage them from
        the current host state (the trie and ``slot_host``, which the
        host path already refreshed), not from the values captured
        then: the host-path block may have touched those rows."""
        fa, fs = win["flushed"]
        st = self.state
        for idx, _bal, _non in fa:
            raw = self.trie.get(st.addrs[idx])
            acct = StateAccount.from_rlp(raw) if raw else StateAccount()
            st._staged.append((idx, acct.balance, acct.nonce))
        for sid, _v in fs:
            st._staged_slots.append((sid, st.slot_host[sid]))

    def _complete_window(self, win: dict, blocks: List[Block],
                         start_idx: int) -> Optional[int]:
        with obs.span("replay/complete_window", blocks=len(win["items"])):
            return self._complete_window_run(win, blocks, start_idx)

    def _complete_window_run(self, win: dict, blocks: List[Block],
                             start_idx: int) -> Optional[int]:
        """Validate a window from its fetched rows, stage every block,
        and fold the window once.  Returns None on full success, else
        the index (into ``blocks``, where the window's first block is
        ``start_idx``) to resume from after the rewind and the host
        path (``_recover_window``): a block whose ok flag is 0, or that
        fails validation, is taken by the host path after the valid
        prefix before it is folded.  A clean window leaves the
        classifier's slot overlay: the next window, already classified,
        may hold sims on it, and a validated value equals its sim (a
        difference would have failed the root check)."""
        t0 = time.monotonic()
        if win["event"] is not None:
            win["event"].synchronize()   # the rows are in pinned memory
        arr = win["fetches"].numpy()
        self.stats.t_device += time.monotonic() - t0
        for k, (block, batch) in enumerate(win["items"]):
            if arr[k, -1, 0] != 1:
                # fold the staged valid prefix [0, k) before the rewind:
                # the host path opens its StateDB on the folded store
                self.commit_pipe.flush()
                return self._recover_window(win, k, blocks, start_idx)
            try:
                self._validate_and_advance(
                    block, batch, arr[k], win["touched_lists"][k],
                    win["slot_lists"][k], win["t_pad"])
            except ReplayError:
                # validation (gas, receipts, bloom, block fee) failed:
                # the host path retries the block.  _validate_and_advance
                # raises before staging, so the staged set is exactly
                # the valid prefix [0, k)
                self.commit_pipe.flush()
                return self._recover_window(win, k, blocks, start_idx)
        # ONE deduped fold + root check for the whole window
        self.commit_pipe.flush()
        return None

    def _rebuild_device_rows(self) -> None:
        """Rebuild every table row from the host state (the engine trie
        and ``slot_host``): the rewind's route when a table grew while a
        window was in flight (the failed window's tables then have a
        stale shape, and on a mesh stale arena rows, which move on
        growth)."""
        st = self.state
        st._staged = []
        st._staged_slots = []
        bal = np.zeros((st.capacity, u256.LIMBS), dtype=np.int32)
        non = np.zeros((st.capacity,), dtype=np.int32)
        for idx, addr in enumerate(st.addrs):
            raw = self.trie.get(addr)
            if raw is None:
                continue
            a = StateAccount.from_rlp(raw)
            if a.balance or a.nonce:
                bal[st.row_of[idx]] = u256.pack_np([a.balance])[0]
                non[st.row_of[idx]] = a.nonce
        st.balances = _upload(bal, st.device)
        st.nonces = _upload(non, st.device)
        sv = np.zeros((st.slot_capacity, u256.LIMBS), dtype=np.int32)
        for sid in range(1, len(st.slot_keys)):
            v = st.slot_host[sid]
            if v:
                sv[st.slot_row_of[sid]] = u256.pack_np([v])[0]
        st.slot_vals = _upload(sv, st.device)

    def _recover_window(self, win: dict, k: int, blocks: List[Block],
                        start_idx: int) -> int:
        """Block k of the window failed on the device: its valid prefix
        [0, k) is already folded.  Put the tables back at the window's
        start, re-apply the prefix on the device (K1, or K8 on a mesh),
        then run block k on the exact host path.  Returns the index to
        resume issuing from."""
        self._slot_overlay.clear()  # the pending window's sims are void
        st = self.state
        prev = win["prev"]
        if (prev[0].shape[0] != st.capacity
                or prev[2].shape[0] != st.slot_capacity):
            self._rebuild_device_rows()
        else:
            st.balances, st.nonces, st.slot_vals = prev
            if k > 0:
                self._issue_window_run(win["items"][:k], fetch=False)
        self._fallback(blocks[start_idx + k])
        return start_idx + k + 1

    def _validate_and_advance(self, block: Block, batch: dict,
                              fetched: np.ndarray, touched: List[int],
                              touched_slots: List[int], t_pad: int) -> None:
        """Host-side consensus checks + staged commit for one block: the
        fetched slot values go into ``slot_host`` and stage as storage
        writes, and ``storage_epoch`` moves."""
        gas_list = batch["gas_used"]
        logs = batch["logs"]
        cums = []
        cum = 0
        for g in gas_list:
            cum += g
            cums.append(cum)
        if cum != block.header.gas_used:
            raise _block_error("gas used mismatch", block)
        # every log is the uniform Transfer shape (address, three 32-byte
        # topics, 32 data bytes): one C++ call derives root and bloom
        rec_root, bloom = native.receipt_root(
            cums, bytes(tx.tx_type for tx in block.transactions),
            bytes(0 if lg is None else 1 for lg in logs),
            b"".join(lg.address + b"".join(lg.topics) + lg.data
                     for lg in logs if lg is not None))
        if rec_root != block.header.receipt_hash:
            raise _block_error("receipt root mismatch", block)
        if bloom != block.header.bloom:
            raise _block_error("bloom mismatch", block)
        if self.config.is_apricot_phase4(block.time):
            try:
                self.engine.verify_block_fee(
                    block.base_fee, block.header.block_gas_cost,
                    block.transactions,
                    [Receipt(gas_used=g) for g in gas_list])
            except ConsensusError as exc:
                raise _block_error(f"block fee: {exc}", block) from exc
        t0 = time.monotonic()
        writes: Dict[Tuple[bytes, bytes], int] = {}
        if touched_slots:
            self.storage_epoch += 1
            slot_vals = u256.to_ints(
                fetched[t_pad:t_pad + len(touched_slots), :u256.LIMBS])
            st = self.state
            for i, sid in enumerate(touched_slots):
                st.slot_host[sid] = slot_vals[i]
                writes[st.slot_keys[sid]] = slot_vals[i]
        balances = u256.to_ints(fetched[:len(touched), :u256.LIMBS])
        nonces = fetched[:len(touched), u256.LIMBS]
        addrs = self.state.addrs
        self.commit_pipe.stage(block.header, {
            addrs[idx]: (balances[i], int(nonces[i]))
            for i, idx in enumerate(touched)}, writes)
        self.stats.t_trie += time.monotonic() - t0
        self.parent_header = block.header
        self.stats.blocks_device += 1
        self.stats.txs += len(block.transactions)

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
        Returns how many blocks were replayed (>= 1); block ``i`` runs on
        the exact host path when no machine run forms, or when
        ``execute_run`` hands it back (returns 0)."""
        if not self.supervisor.allows("device"):
            self._fallback(blocks[i])
            return 1
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
            self._fallback(blocks[i])
            return 1
        mx._fork = fork
        try:
            consumed = self.supervisor.run("device", None, mx.execute_run,
                                           items)
        except BackendFault:
            # a persistent device fault with no progress: the run's first
            # block takes the exact host path, the rest re-enter the loop
            # (and re-route while the scope is demoted)
            self._fallback(blocks[i])
            return 1
        if consumed == 0:
            self._fallback(blocks[i])
            consumed = 1
        return consumed

    def replay_block(self, block: Block) -> bytes:
        """Process one block synchronously."""
        self.warm_senders(block)
        t0 = time.monotonic()
        batch = self._classify(block)
        self.stats.t_classify += time.monotonic() - t0
        if batch is None:
            self._machine_run([block], 0)
            return self.root
        try:
            win = self._issue_window([(block, batch)])
        except BackendFault:
            return self._fallback(block)
        self._complete_window(win, [block], 0)
        return self.root

    def replay(self, blocks: List[Block],
               window: Optional[int] = None) -> bytes:
        """Windowed, pipelined replay: window k+1 is classified (host)
        and launched (device) before window k is validated and folded,
        so the card runs while the host folds; sender recovery runs in
        look-ahead segments alongside.  When window k rewinds (a block
        taken by the host path), the speculative window k+1, launched
        on a now-stale base, is discarded and its blocks classified
        again from the resume point.  A run whose launch fails past the
        supervisor's retries (``BackendFault``) replays on the host
        path."""
        window = window or self.window
        n = len(blocks)
        pipe = _SenderPipeline(self, blocks)
        i = 0
        pending: Optional[Tuple[dict, int]] = None
        while i < n or pending is not None:
            run: List[Tuple[Block, dict]] = []
            run_start = i
            refused = False
            while i < n and len(run) < window:
                pipe.ensure(i)
                t0 = time.monotonic()
                batch = self._classify(blocks[i])
                self.stats.t_classify += time.monotonic() - t0
                if batch is None:
                    refused = True
                    break
                run.append((blocks[i], batch))
                i += 1
            win = failed_run = None
            if run:
                try:
                    win = self._issue_window(run)
                except BackendFault:
                    # the supervisor struck (and maybe demoted) the device
                    # scope: the run replays on the exact host path once
                    # the pending window retires
                    failed_run = run
            if pending is not None:
                p_win, p_start = pending
                pending = None
                resume = self._complete_window(p_win, blocks, p_start)
                if resume is not None:
                    if win is not None:
                        self._discard_window(win)
                    i = resume  # a failed run's blocks re-enter from here
                    continue
            if failed_run is not None:
                for b, _batch in failed_run:
                    self._fallback(b)
                continue
            if win is not None and refused:
                # nothing may stay in flight past a machine or host block
                resume = self._complete_window(win, blocks, run_start)
                if resume is not None:
                    i = resume
                    continue
            elif win is not None:
                pending = (win, run_start)
            if refused:
                i += self._machine_run(blocks, i, ensure=pipe.ensure)
        return self.root

    # ------------------------------------------------------------ host path
    def quarantine_block(self, block: Block) -> List[str]:
        """Tolerant host application of a poison block — one that fails
        validation on every backend: the state transition still applies
        (the computed post-state is the only base later blocks can build
        on), but the failed consensus checks are returned instead of
        raised.  The forensics bundle the reference freezes here is not
        part of the port."""
        reasons: List[str] = []
        self._fallback(block, strict=False, reasons=reasons)
        self.supervisor.note_quarantined()
        self.stats.blocks_quarantined += 1
        return reasons

    def rollback_block(self, block: Block) -> bytes:
        """Reorg primitive: pop a quarantined block's generation and
        re-converge the engine to the pre-block (strict-mode) state.

        The flat layer's undo log restores the flat view; the store's
        tries, advanced in place by the quarantined block's StateDB, are
        put back by that StateDB's kept undo log (the reference reopens
        them at the generation's ``prev_root`` instead) and must hash to
        it; the device rows, the account metadata and the slot mirror
        are refreshed from them for the accounts the block touched.
        Only the NEWEST generation, a quarantined block, is revertible:
        strict blocks validated against their headers."""
        if self.flat is None:
            raise ReplayError("rollback requires the flat layer (flat=True)")
        if self.commit_pipe.pending():
            raise ReplayError(
                "rollback with staged commits pending (flush first)")
        # checkpoint markers stamped on the doomed tip carry no diff;
        # discard them so the quarantine generation is the target
        gen = self.flat.last_generation()
        while gen is not None and gen.kind == "checkpoint" \
                and not gen.exported:
            self.flat.rollback_last()
            gen = self.flat.last_generation()
        sdb = self._quarantine_sdb
        if gen is None or gen.kind != "quarantine" \
                or gen.number != block.number \
                or gen.block_hash != block.hash() or sdb is None:
            raise ReplayError(
                "rollback target is not the newest quarantined generation")
        gen = self.flat.rollback_last()
        self._quarantine_sdb = None
        sdb.restore()
        if self.trie.hash() != gen.prev_root:
            raise ReplayError(
                "rollback: trie did not re-converge to the pre-block root")
        self._refresh_from_host(sdb)
        self.root = gen.prev_root
        self.parent_header = gen.prev_header
        self.stats.blocks_rolled_back += 1
        return gen.prev_root

    def publish_metrics(self, registry=None, prefix: str = "replay") -> None:
        """Feed the ``ReplayStats`` split into a metrics registry, one
        gauge a field (the engine-side analog of the blockchain.go timer
        metrics)."""
        from coreth_tpu_torch.metrics import Gauge, get_or_register
        for name, value in self.stats.row().items():
            get_or_register(f"{prefix}/{name}", Gauge,
                            registry).update(value)
        if self.flat is not None:
            for name, value in self.flat.snapshot().items():
                get_or_register(f"flat/{name}", Gauge,
                                registry).update(value)

    def _fallback(self, block: Block, strict: bool = True,
                  reasons: Optional[List[str]] = None) -> bytes:
        """The exact host path: the block runs on the ``Processor`` over
        a ``StateDB`` on the engine's store, its gas, receipts and root
        are checked against the header, and the device tables and the
        slot mirror are refreshed from what it wrote.  A check that
        fails (or an invalid tx) raises with the store restored, so the
        engine's root and tries stay at the previous block.
        ``strict=False`` is the quarantine mode: a failed check is
        appended to ``reasons`` and the computed state commits.  With the
        flat layer the block reads flat-first and seals one generation
        (a quarantined block's held, its StateDB's undo log kept for
        ``rollback_block``)."""
        with obs.span("replay/host_fallback", number=block.number,
                      strict=strict):
            return self._fallback_run(block, strict, reasons)

    def _fallback_run(self, block: Block, strict: bool,
                      reasons: Optional[List[str]]) -> bytes:
        self.commit_pipe.flush()  # staged windows precede this block
        self._quarantine_sdb = None
        prev_root = self.root
        prev_header = self.parent_header
        t0 = time.monotonic()
        if (self.parent_header is None
                and self.config.is_apricot_phase4(block.time)):
            # the shim cannot supply parent block_gas_cost/time, which
            # AP4+ fee validation needs — refuse rather than mis-validate
            raise ReplayError(
                "ReplayEngine needs parent_header for AP4+ blocks; "
                "construct it with parent_header=...")
        parent = self.parent_header or _HeaderShim(block)
        statedb = StateDB(self.store, flat=self._flat_view())

        def mismatch(what: str) -> None:
            if strict:
                raise _block_error(f"{what} (fallback)", block)
            reasons.append(what)

        try:
            receipts, _logs, used_gas = self.processor.process(
                block, parent, statedb)
            if used_gas != block.header.gas_used:
                mismatch("gas used mismatch")
            if derive_sha(receipts, derive_hasher()) \
                    != block.header.receipt_hash:
                mismatch("receipt root mismatch")
            root = statedb.intermediate_root(True)
            if root != block.header.root:
                mismatch("state root mismatch")
        except BaseException:
            statedb.restore()
            raise
        statedb.commit(delete_empty_objects=True, keep_undo=not strict)
        self._refresh_from_host(statedb)
        if self.flat is not None:
            # one generation per host-path block: the flat view learns
            # the block's diff, and its undo makes a QUARANTINED block
            # revertible (held, so the exporter cannot make it durable
            # before the chain accepts past it)
            accounts, storage, destructs = flat_diff_from_statedb(statedb)
            self.flat.apply_generation(
                number=block.number, block_hash=block.hash(), root=root,
                header=block.header, prev_root=prev_root,
                prev_header=prev_header, accounts=accounts,
                storage=storage, destructs=destructs,
                kind="fallback" if strict else "quarantine",
                hold=not strict)
            if not strict:
                self._quarantine_sdb = statedb
        self.root = root
        self.parent_header = block.header
        self.stats.blocks_fallback += 1
        self.stats.txs += len(block.transactions)
        self.stats.t_fallback += time.monotonic() - t0
        return root

    def _refresh_from_host(self, statedb: StateDB) -> None:
        """Bring the device tables, the account metadata and the slot
        mirror up to what a host-path block wrote: every indexed account
        it touched is staged from the trie, and every tracked slot of a
        contract whose storage root moved is reloaded from its trie."""
        self._slot_overlay.clear()
        self.storage_epoch += 1
        st = self.state
        st.flush_staged()
        for addr in statedb._objects:
            idx = st.index.get(addr)
            if idx is None:
                continue
            raw = self.trie.get(addr)
            account = StateAccount.from_rlp(raw) if raw else StateAccount()
            st._staged.append((idx, account.balance, account.nonce))
            st.has_code[idx] = account.code_hash != EMPTY_CODE_HASH
            st.multicoin[idx] = account.is_multi_coin
            st.code_hashes[idx] = account.code_hash
            old_root = st.roots[idx]
            st.roots[idx] = account.root
            if account.root == old_root:
                continue
            trie = self.store.storage.get(addr)
            for sid in st.slots_by_contract.get(addr, []):
                raw_v = trie.get(st.slot_keys[sid][1]) \
                    if trie is not None else None
                v = int.from_bytes(rlp.decode(raw_v), "big") if raw_v else 0
                if v != st.slot_host[sid]:
                    st.slot_host[sid] = v
                    st._staged_slots.append((sid, v))
        st.flush_staged()

    def commit(self) -> bytes:
        """Fold anything staged and write the tries' nodes into the
        store's node store (a store over ``kv``; an in-memory store has
        none); returns the state root."""
        self.commit_pipe.flush()
        return self.store.commit()


class _HeaderShim:
    """Minimal parent-header stand-in when the true parent header was
    not supplied to the engine — correct only before Apricot Phase 4
    (the AP4 block-gas-cost check needs the real parent's
    block_gas_cost and time)."""

    def __init__(self, block: Block):
        self.time = block.header.time
        self.number = block.header.number - 1
        self.block_gas_cost = None
        self.base_fee = None
        self.ext_data_gas_used = None
