"""Host adapter for the device step machine.

Port of reference ``evm/device/adapter.py``, cut to what the port runs:

- ``MachineRunner`` packs a batch of same-block calls into machine
  inputs, runs the miss-and-rerun storage rounds on K5, and unpacks
  per-tx results (status / gas left / refund / logs / storage read- and
  write-sets); cross-tx ordering inside a block is the caller's
  (``replay/machine_block``);
- ``MachineWindowRunner`` drives the fused OCC window (K6): it premaps
  each lane's storage keys onto rows of a slot table that stays on the
  device, predicting keccak-derived keys from learned recipes, gives
  each lane whose contract traces (``specialize``) its program id and
  host-evaluated keccak digests (K7), launches one window of blocks,
  and resolves the keys lanes still missed by re-launching the window
  from its host mirror.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from coreth_tpu_torch import default_device, faults, obs
from coreth_tpu_torch.crypto import keccak256, keccak256_many
from coreth_tpu_torch.evm.census import static_storage_keys
from coreth_tpu_torch.evm.device import machine as M
from coreth_tpu_torch.evm.device import specialize as SP
from coreth_tpu_torch.evm.device import tables as T
from coreth_tpu_torch.ops import u256

# The seam the transfer path's supervised window dispatch fires too
# (replay/engine.py): a fused-OCC window dispatch raising mid-run.  Fired
# BEFORE any packing mutates the runner, so a faulted issue() is safe to
# retry.
PT_DISPATCH = faults.declare(
    "device/dispatch", "raise at window dispatch (transfer + fused OCC)")

# miss-and-rerun rounds of one MachineRunner.run before a lane still
# missing storage goes to the host (the reference's max_rounds default)
MISS_ROUNDS = 6
# launches of one MachineWindowRunner window (the first and its
# discovery re-launches) before keys still missed dirty their blocks
# (the reference's max_attempts default)
MAX_WINDOW_ATTEMPTS = 6
# contracts one window runner specialises (its sticky program set);
# lanes of later eligible contracts stay on the generic interpreter
SPEC_SET_CAP = 8


def addr_word(addr: bytes) -> int:
    return int.from_bytes(addr, "big")


def word16(v: int) -> np.ndarray:
    """u256 int -> 16 little-endian int32 limbs (the machine layout)."""
    return np.frombuffer(
        v.to_bytes(32, "little"), dtype=np.uint16).astype(np.int32)


_WORD16_CACHE: Dict[int, np.ndarray] = {}


def word16c(v: int) -> np.ndarray:
    """Cached, read-only word16: the window packer converts the same
    caller / contract / gas-price words every window (senders recur all
    chain).  Callers assign the result into batch arrays (a copy)."""
    w = _WORD16_CACHE.get(v)
    if w is None:
        if len(_WORD16_CACHE) > (1 << 16):
            _WORD16_CACHE.clear()  # unbounded value streams: reset
        w = word16(v)
        w.setflags(write=False)
        _WORD16_CACHE[v] = w
    return w


def _norm_slot_key(key: bytes) -> bytes:
    """Normal-storage partition of a raw 32-byte slot key: bit 0 of
    byte 0 cleared — the machine's limb-15 ``& 0xFEFF`` mask, applied on
    the host to predicted keccak keys so they compare equal to the keys
    the kernel reports."""
    return bytes([key[0] & 0xFE]) + key[1:]


def _cd_word(data: bytes, w: int) -> bytes:
    """ABI calldata word ``w`` (32 bytes past the 4-byte selector),
    zero-padded exactly like CALLDATALOAD past the end."""
    word = data[4 + 32 * w:4 + 32 * w + 32]
    return word + b"\x00" * (32 - len(word))


_ARR_BASE: Dict[int, int] = {}


def _arr_base(slot: int) -> int:
    """keccak(pad32(slot)) as an int — the Solidity dynamic-array data
    base; element i lives at base + i (cached per slot index)."""
    v = _ARR_BASE.get(slot)
    if v is None:
        v = int.from_bytes(keccak256(slot.to_bytes(32, "big")), "big")
        _ARR_BASE[slot] = v
    return v


# Process-wide learned-recipe store (see MachineWindowRunner): a recipe
# is a fact about a bytecode's keccak structure, not state, so runners
# and engines share it.
RECIPES: Dict[bytes, Dict[tuple, None]] = {}


_STATIC_PREMAP: Dict[bytes, Tuple[bytes, ...]] = {}


def _static_premap(code: bytes) -> Tuple[bytes, ...]:
    """PUSH-constant storage footprint of ``code`` as normalized premap
    keys (``census.static_storage_keys`` — the swap pool's reserve
    slots), () when any key is computed."""
    cached = _STATIC_PREMAP.get(code)
    if cached is None:
        ks = static_storage_keys(code)
        out: Dict[bytes, None] = {}
        if ks is not None:
            for k in ks[0] + ks[1]:
                out[_norm_slot_key(k)] = None
        cached = _STATIC_PREMAP[code] = tuple(out)
    return cached


@dataclass
class TxSpec:
    """One machine transaction: a plain call into device-eligible code."""
    code: bytes
    calldata: bytes
    gas: int                      # gas available for execution
    value: int
    caller: bytes                 # 20-byte address
    address: bytes                # 20-byte contract address
    origin: bytes
    gas_price: int
    # (key32 -> (current, original)) pre-resolved storage view
    storage: Dict[bytes, Tuple[int, int]] = field(default_factory=dict)
    # access-list pre-warmed slots (EIP-2930); also marked warm
    warm_slots: Tuple[bytes, ...] = ()


@dataclass
class BlockEnv:
    coinbase: bytes
    timestamp: int
    number: int
    gas_limit: int
    chain_id: int
    base_fee: int = 0


@dataclass
class TxResult:
    status: int                   # machine status code (M.STOP, ...)
    gas_left: int
    refund: int
    logs: List[Tuple[List[bytes], bytes]]   # (topics, data)
    reads: Dict[bytes, int]       # key -> observed pre-tx value
    writes: Dict[bytes, int]      # key -> final value (uncommitted)
    host_reason: int = 0

    @property
    def ok(self) -> bool:
        return self.status == M.STOP

    @property
    def needs_host(self) -> bool:
        return self.status == M.HOST


def _pow2(n: int, floor: int) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


class MachineRunner:
    """Executes batches of TxSpecs under one fork + block env on
    ``device`` (``"cuda"`` by default: the K5 kernel; ``"cpu"``: its
    plain version).

    storage_resolver(address, key32) -> int supplies committed values
    for keys the machine discovered (miss rounds).  ``launches`` counts
    machine runs (one per miss round), ``steps`` the lane-steps they
    executed; ``t_pack`` (host packing and upload), ``t_machine`` (the
    run, the wait for it and the download of the packed rows) and
    ``t_unpack`` (miss collection, resolver calls and results) are
    seconds on the host clock."""

    def __init__(self, fork: str, env: BlockEnv,
                 storage_resolver: Callable[[bytes, bytes], int],
                 device=None):
        self.fork = fork
        self.env = env
        self.resolver = storage_resolver
        self.device = default_device(device)
        self.launches = 0
        self.steps = 0
        self.t_pack = self.t_machine = self.t_unpack = 0.0

    def _params(self, txs: List[TxSpec]) -> M.MachineParams:
        max_code = 64
        max_data = 64
        max_slots = 4
        for t in txs:
            max_code = max(max_code, len(t.code))
            max_data = max(max_data, len(t.calldata))
            max_slots = max(max_slots, len(t.storage) + 8)
        return M.MachineParams(
            fork=self.fork,
            batch=_pow2(len(txs), 8),
            code_cap=_pow2(max_code, 256),
            data_cap=_pow2(max_data, 128),
            scache_cap=_pow2(max_slots, 8),
        )

    def pack(self, txs: List[TxSpec], p: M.MachineParams) -> dict:
        """Machine inputs for ``txs`` as tensors on the runner's device
        (padding lanes inactive)."""
        S = p.scache_cap
        # one block of a window, without the block axis
        arrays = {k: v if k == "chainid_w" else v[0] for k, v in
                  window_arrays(p, 1, [(self.env, txs)]).items()}
        arrays.update({k: v[0] for k, v in code_arrays(
            p, 1, [(self.env, txs)],
            lambda c: code_rows(c, p.code_cap, self.fork)).items()})
        skey = np.zeros((p.batch, S, u256.LIMBS), dtype=np.int32)
        sval = np.zeros((p.batch, S, u256.LIMBS), dtype=np.int32)
        sorig = np.zeros((p.batch, S, u256.LIMBS), dtype=np.int32)
        sflag = np.zeros((p.batch, S), dtype=np.int32)
        scnt = np.zeros((p.batch,), dtype=np.int32)
        for i, t in enumerate(txs):
            for j, (key, (cur, orig)) in enumerate(t.storage.items()):
                skey[i, j] = word16(int.from_bytes(key, "big"))
                sval[i, j] = word16(cur)
                sorig[i, j] = word16(orig)
                sflag[i, j] = M.F_VALID | (
                    M.F_WARM if key in t.warm_slots else 0)
            scnt[i] = len(t.storage)
        scalars = {k: int(arrays.pop(k)) for k in ("timestamp", "number",
                                                   "gaslimit")}
        arrays.update(skey=skey, sval=sval, sorig=sorig, sflag=sflag,
                      scnt=scnt)
        inputs = {k: _upload(v, self.device) for k, v in arrays.items()}
        inputs.update(scalars)
        return inputs

    def run(self, txs: List[TxSpec]) -> List[TxResult]:
        """Execute txs (independently, against their given pre-states),
        resolving storage misses through rerun rounds.

        Raises ValueError when a TxSpec's code is not device-eligible:
        a taken JUMP into ineligible code would silently become a
        bad-jump ERR instead of a HOST escape, so callers route such txs
        elsewhere themselves (machine_block.classify does)."""
        txs = list(txs)
        for t in txs:
            info = T.scan_code(t.code, self.fork)
            if not info.eligible:
                raise ValueError(
                    f"TxSpec code not device-eligible: {info.reason}")
        for _ in range(MISS_ROUNDS):
            t0 = time.monotonic()
            p = self._params(txs)
            inputs = self.pack(txs, p)
            t1 = time.monotonic()
            packed, steps = M.run_machine(p, inputs)
            self.launches += 1
            out = PackedOut(packed.cpu().numpy(), p)
            self.steps += int(steps.sum())
            t2 = time.monotonic()
            self.t_pack += t1 - t0
            self.t_machine += t2 - t1
            missing = self._collect_misses(out, txs)
            if not missing:
                res = self._unpack(out, txs)
                self.t_unpack += time.monotonic() - t2
                return res
            for i, keys in missing.items():
                t = txs[i]
                for key in keys:
                    v = self.resolver(t.address, key)
                    t.storage[key] = (v, v)
            self.t_unpack += time.monotonic() - t2
        # rounds exhausted: anything still missing goes to host
        out_res = self._unpack(out, txs)
        for i in self._collect_misses(out, txs):
            out_res[i].status = M.HOST
            out_res[i].host_reason = M.R_SCACHE
        return out_res

    def _collect_misses(self, out: "PackedOut",
                        txs) -> Dict[int, List[bytes]]:
        missing: Dict[int, List[bytes]] = {}
        for i, t in enumerate(txs):
            # ERR lanes may have mispriced on a speculative miss value,
            # so they resolve and rerun too
            keys = [key for key in miss_keys(out, i)
                    if key not in t.storage]
            if keys:
                missing[i] = keys
        return missing

    def _unpack(self, out: "PackedOut", txs) -> List[TxResult]:
        return results_for_rows(out, np.arange(len(txs)))


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without waiting for the card: a copy
    from pinned memory, queued on the current stream behind any kernel
    still running (a pageable copy may wait for that stream first)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


# ------------------------------------------------------------ unpack
def _be_blob(arr: np.ndarray) -> bytes:
    """Little-endian 16-limb words -> one flat blob of 32-byte
    big-endian values (limb order reversed, each limb a big-endian
    u16), converted once per packed tensor."""
    return np.ascontiguousarray(arr[..., ::-1]).astype(">u2").tobytes()


class PackedOut:
    """View over the machine's packed output rows (``pack_result``).
    Byte-level views (storage keys/values, log topics/data) convert ONCE
    per run via numpy and are sliced per entry."""

    def __init__(self, blob: np.ndarray, p: M.MachineParams):
        S, LC, LD = p.scache_cap, p.log_cap, p.log_data_cap
        self.S, self.LC, self.LD = S, LC, LD
        o = 0

        def take(n, shape=None):
            nonlocal o
            v = blob[:, o:o + n]
            o += n
            return v if shape is None else v.reshape(
                (blob.shape[0],) + shape)

        self.status = take(1)[:, 0]
        self.gas = take(1)[:, 0]
        self.refund = take(1)[:, 0]
        self.host_reason = take(1)[:, 0]
        self.scnt = take(1)[:, 0]
        self.sflag = take(S)
        self.skey = take(S * 16, (S, 16))
        self.sval = take(S * 16, (S, 16))
        self.sorig = take(S * 16, (S, 16))
        self.log_nt = take(LC)
        self.log_dlen = take(LC)
        self.log_cnt = take(1)[:, 0]
        self.log_top = take(LC * 4 * 16, (LC, 4, 16))
        self.log_data = take(LC * LD, (LC, LD))
        self._kb = self._vb = self._ob = None
        self._tb = self._db = None

    def key_blob(self) -> bytes:
        if self._kb is None:
            self._kb = _be_blob(self.skey)
        return self._kb

    def val_blob(self) -> bytes:
        if self._vb is None:
            self._vb = _be_blob(self.sval)
        return self._vb

    def orig_blob(self) -> bytes:
        if self._ob is None:
            self._ob = _be_blob(self.sorig)
        return self._ob

    def topic_blob(self) -> bytes:
        if self._tb is None:
            self._tb = _be_blob(self.log_top)
        return self._tb

    def data_blob(self) -> bytes:
        if self._db is None:
            self._db = self.log_data.astype(np.uint8).tobytes()
        return self._db


def miss_keys(out: PackedOut, i: int) -> List[bytes]:
    """Storage keys lane i touched that were NOT in its seeded cache
    (F_MISS entries — executed against a speculative zero)."""
    keys = []
    n = int(out.scnt[i])
    if not n:
        return keys
    kb = out.key_blob()
    flags = out.sflag[i]
    for j in range(n):
        if flags[j] & M.F_MISS:
            off = (i * out.S + j) * 32
            keys.append(kb[off:off + 32])
    return keys


def _kreq_ctx_bytes(op: int, t: TxSpec, env: BlockEnv) -> bytes:
    """The 32-byte context word a lane's traced keccak request reads —
    equal to the device input word bit for bit (``specialize.HOST_CTX``
    admits only full-width words, so these are plain paddings)."""
    if op == 0x33:
        return b"\x00" * 12 + t.caller
    if op == 0x30:
        return b"\x00" * 12 + t.address
    if op == 0x32:
        return b"\x00" * 12 + t.origin
    if op == 0x34:
        return t.value.to_bytes(32, "big")
    if op == 0x3A:
        return t.gas_price.to_bytes(32, "big")
    if op == 0x41:
        return b"\x00" * 12 + env.coinbase
    if op == 0x46:
        return env.chain_id.to_bytes(32, "big")
    if op == 0x48:
        return env.base_fee.to_bytes(32, "big")
    # a HOST_CTX opcode this function does not know would hand the kernel
    # a wrong keccak input that it trusts
    raise ValueError(f"unhandled kdig ctx opcode {op:#04x}")


def fill_kdig(kdig: np.ndarray, jobs) -> None:
    """Evaluate collected keccak requests and write their digest limbs.

    jobs: (bi, li, t, env, reqs) per specialised lane.  Requests nest
    (("kdig", j) words reference earlier slots), so evaluation batches
    by readiness level — one keccak256_many call per level, one
    vectorized limb scatter at the end."""
    if not jobs:
        return
    done: List[List[Optional[bytes]]] = [
        [None] * len(reqs) for (_bi, _li, _t, _env, reqs) in jobs]
    while True:
        msgs, where = [], []
        pending = False
        for ji, (_bi, _li, t, env, reqs) in enumerate(jobs):
            for k, desc in enumerate(reqs):
                if done[ji][k] is not None:
                    continue
                parts, ready = [], True
                for d in desc:
                    kind = d[0]
                    if kind == "const":
                        parts.append(d[1].to_bytes(32, "big"))
                    elif kind == "ctx":
                        parts.append(_kreq_ctx_bytes(d[1], t, env))
                    elif kind == "data":
                        b = t.calldata[d[1]:d[1] + 32]
                        parts.append(b + b"\x00" * (32 - len(b)))
                    else:  # ("kdig", j): an earlier slot's digest
                        dj = done[ji][d[1]]
                        if dj is None:
                            ready = False
                            break
                        parts.append(dj)
                if not ready:
                    pending = True
                    continue
                msgs.append(b"".join(parts))
                where.append((ji, k))
        if not msgs:
            break
        for (ji, k), dg in zip(where, keccak256_many(msgs)):
            done[ji][k] = dg
        if not pending:
            break
    fills = [(jobs[ji][0], jobs[ji][1], k, dg)
             for ji, row in enumerate(done)
             for k, dg in enumerate(row) if dg is not None]
    if fills:
        idx = np.array([(bi, li, k) for bi, li, k, _ in fills],
                       dtype=np.int64)
        blob = b"".join(dg[::-1] for _bi, _li, _k, dg in fills)
        limbs = np.frombuffer(blob, dtype=np.uint16).reshape(
            -1, u256.LIMBS).astype(np.int32)
        kdig[idx[:, 0], idx[:, 1], idx[:, 2]] = limbs


def result_from_row(out: PackedOut, i: int) -> TxResult:
    """One lane's TxResult from a PackedOut row."""
    return results_for_rows(out, [i])[0]


def results_for_rows(out: PackedOut, rows) -> List[TxResult]:
    """TxResults for many PackedOut rows in one pass: validity masks,
    flag tests and int conversions run once per call as array ops; the
    Python loop touches only entries that exist."""
    rows = np.asarray(rows, dtype=np.int64)
    n = rows.shape[0]
    if not n:
        return []
    status = out.status[rows].tolist()
    gas = out.gas[rows].tolist()
    refund = out.refund[rows].tolist()
    hreason = out.host_reason[rows].tolist()
    reads_l: List[Dict[bytes, int]] = [{} for _ in range(n)]
    writes_l: List[Dict[bytes, int]] = [{} for _ in range(n)]
    logs_l: List[list] = [[] for _ in range(n)]
    scnt = out.scnt[rows]
    if scnt.any():
        S = out.S
        sf = out.sflag[rows]
        valid = (np.arange(S)[None, :] < scnt[:, None]) \
            & ((sf & M.F_VALID) != 0)
        ki, si = np.nonzero(valid)
        if ki.size:
            kb, vb, ob = out.key_blob(), out.val_blob(), out.orig_blob()
            fl = sf[ki, si]
            rd = ((fl & M.F_READ) != 0).tolist()
            wr = ((fl & M.F_WRITTEN) != 0).tolist()
            offs = ((rows[ki] * S + si) * 32).tolist()
            which = ki.tolist()
            for t, o in enumerate(offs):
                key = kb[o:o + 32]
                k = which[t]
                if rd[t]:
                    reads_l[k][key] = int.from_bytes(ob[o:o + 32], "big")
                if wr[t]:
                    writes_l[k][key] = int.from_bytes(vb[o:o + 32], "big")
    lc = out.log_cnt[rows]
    if lc.any():
        LC, LD = out.LC, out.LD
        li, lj = np.nonzero(np.arange(LC)[None, :] < lc[:, None])
        if li.size:
            tb, db = out.topic_blob(), out.data_blob()
            nt = out.log_nt[rows][li, lj].tolist()
            dl = out.log_dlen[rows][li, lj].tolist()
            base = (((rows[li] * LC + lj) * 4) * 32).tolist()
            doff = ((rows[li] * LC + lj) * LD).tolist()
            which = li.tolist()
            for t, b in enumerate(base):
                topics = [tb[b + 32 * k:b + 32 * (k + 1)]
                          for k in range(nt[t])]
                d = doff[t]
                logs_l[which[t]].append((topics, db[d:d + dl[t]]))
    return [TxResult(status=status[k], gas_left=gas[k],
                     refund=refund[k], logs=logs_l[k],
                     reads=reads_l[k], writes=writes_l[k],
                     host_reason=hreason[k])
            for k in range(n)]


# ----------------------------------------------------------- OCC window
@dataclass
class WindowResult:
    """Per-block outcome of one fused OCC window (machine.run_occ_window).
    ``clean[k]`` means every lane of block k committed on the device; a
    dirty block (and every block after it, whose base table was
    speculative) is the caller's to redo."""
    results: List[List[TxResult]]       # per block, per call lane
    committed: List[np.ndarray]         # (lanes,) bool per block
    escape: List[np.ndarray]            # (lanes,) bool per block
    clean: List[bool]
    rounds: List[int]                   # device OCC rounds per block
    attempts: int                       # launches this window took


def window_arrays(p: M.MachineParams, W: int, items,
                  lanes: Optional[Tuple] = None) -> Dict[str, np.ndarray]:
    """The per-lane and per-block inputs of one window (numpy, padding
    lanes and blocks inactive), the code rows excepted (``code_arrays``).
    ``items`` is [(BlockEnv, [TxSpec, ...]), ...] in chain order.  Tx li
    of block bi sits at lane li of ``p.batch`` lanes, or with ``lanes`` =
    (L, lane_map) at lane ``lane_map[bi][li]`` of L (the sharded
    runner's placement)."""
    L, lane_map = lanes or (p.batch, None)
    calldata = np.zeros((W, L, p.data_cap), dtype=np.int32)
    data_len = np.zeros((W, L), dtype=np.int32)
    start_gas = np.zeros((W, L), dtype=np.int32)
    active = np.zeros((W, L), dtype=np.int32)
    words = {k: np.zeros((W, L, u256.LIMBS), dtype=np.int32)
             for k in ("callvalue", "caller_w", "address_w", "origin_w",
                       "gasprice_w")}
    block = {k: np.zeros((W,), dtype=np.int32)
             for k in ("timestamp", "number", "gaslimit")}
    coinbase_w = np.zeros((W, u256.LIMBS), dtype=np.int32)
    basefee_w = np.zeros((W, u256.LIMBS), dtype=np.int32)
    chain_id = 0
    for bi, (env, specs) in enumerate(items):
        block["timestamp"][bi] = env.timestamp
        block["number"][bi] = env.number
        block["gaslimit"][bi] = min(env.gas_limit, (1 << 31) - 1)
        coinbase_w[bi] = word16(addr_word(env.coinbase))
        basefee_w[bi] = word16(env.base_fee)
        chain_id = env.chain_id
        for li, t in enumerate(specs):
            fl = li if lane_map is None else lane_map[bi][li]
            db = np.frombuffer(t.calldata, dtype=np.uint8)
            calldata[bi, fl, :len(db)] = db
            data_len[bi, fl] = len(db)
            start_gas[bi, fl] = t.gas
            active[bi, fl] = 1
            words["callvalue"][bi, fl] = word16c(t.value)
            words["caller_w"][bi, fl] = word16c(addr_word(t.caller))
            words["address_w"][bi, fl] = word16c(addr_word(t.address))
            words["origin_w"][bi, fl] = word16c(addr_word(t.origin))
            words["gasprice_w"][bi, fl] = word16c(t.gas_price)
    return dict(calldata=calldata, data_len=data_len, start_gas=start_gas,
                active=active, coinbase_w=coinbase_w, basefee_w=basefee_w,
                chainid_w=word16(chain_id), **words, **block)


def code_rows(code: bytes, code_cap: int, fork: str) -> Tuple:
    """Dense (code row, jdest row, code_len) of one bytecode."""
    cb = np.zeros((code_cap + 33,), dtype=np.int32)
    arr = np.frombuffer(code, dtype=np.uint8)
    cb[:len(arr)] = arr
    jd = np.zeros((code_cap,), dtype=np.int32)
    for d in T.scan_code(code, fork).jumpdests:
        if d < code_cap:
            jd[d] = 1
    return cb, jd, len(arr)


def code_arrays(p: M.MachineParams, W: int, items,
                rows_of: Callable[[bytes], Tuple],
                lanes: Optional[Tuple] = None) -> Dict[str, np.ndarray]:
    """The window's code, jdest and code_len arrays; ``rows_of(code)``
    gives one bytecode's ``code_rows``; ``lanes`` as ``window_arrays``."""
    L, lane_map = lanes or (p.batch, None)
    code = np.zeros((W, L, p.code_cap + 33), dtype=np.int32)
    code_len = np.zeros((W, L), dtype=np.int32)
    jdest = np.zeros((W, L, p.code_cap), dtype=np.int32)
    for bi, (_env, specs) in enumerate(items):
        for li, t in enumerate(specs):
            fl = li if lane_map is None else lane_map[bi][li]
            cb, jd, ln = rows_of(t.code)
            code[bi, fl] = cb
            jdest[bi, fl] = jd
            code_len[bi, fl] = ln
    return dict(code=code, jdest=jdest, code_len=code_len)


def _scatter_rows(tab: torch.Tensor, idx: np.ndarray,
                  rows: np.ndarray) -> None:
    """tab[idx] = rows in place, rows whose index falls outside the
    table dropped."""
    keep = (idx >= 0) & (idx < tab.shape[0])
    if keep.any():
        tab[_upload(idx[keep].astype(np.int64), tab.device)] = \
            _upload(rows[keep], tab.device)


class MachineWindowRunner:
    """Device-resident OCC over WINDOWS of machine blocks (K6).

    One launch executes up to ``occ.blocks`` machine blocks: the
    Block-STM round loop, read-set validation and the cross-block state
    fold run inside the kernel against a global slot-value table that
    stays on the device.  The host supplies per-lane inputs and the
    premapped table row of each lane's storage-cache entries, and
    fetches one packed result tensor per window.

    Persistent across windows:
    - ``slot_gid``: (contract, key32) -> table row;
    - ``vals``: host mirror of committed slot values at the last fold
      point (the rebuild source when the device table is invalidated);
    - ``table`` / ``key_tab``: the device-resident value and key tables;
      each launch returns a new value table, which replaces the old one
      without the host waiting for it;
    - ``recipes``: per-contract, selector-scoped premap predictors learned
      from misses — (selector, "caller" | "data" + word, slot) says lanes
      calling ``selector`` touch ``keccak(pad32(source) || pad32(slot))``
      (the Solidity mapping rule), with second-level ("nest", the
      allowance shape) and array-element ("arr", ``keccak(slot) + i``)
      forms; PUSH-constant footprints (the swap reserves) premap with no
      learning at all;
    - ``common``: per-contract keys every lane touched so far (the
      residue prediction cannot derive).  A key still outside the premap
      surfaces as an F_MISS escape and resolves through the bounded
      re-launch loop, counted in ``discovery_dispatches``;
    - ``_spec_progs``: with ``specialize`` (the reference's
      ``CORETH_SPECIALIZE``, default on) the sticky program set — each
      bytecode the tracer accepts gets the next program index at first
      sighting, up to ``SPEC_SET_CAP``; its lanes run that traced
      program inside K6 (K7), fed the host-evaluated keccak digests of
      its ``spec_requests``.  Other lanes stay on the interpreter.

    ``launches`` / ``steps`` count K6 launches and the lane-steps they
    ran; ``lanes_specialized`` / ``specialize_escapes`` the lanes of
    first attempts that ran a traced program / stayed on the
    interpreter, ``programs_traced`` the program set's size; ``t_pack``
    (premaps, packing, upload), ``t_machine`` (launch, and the wait for
    and download of the packed rows; a new program set's nvcc build
    included) and ``t_unpack`` (miss resolution, recipe learning,
    results) are host-clock seconds.
    """

    COMMON_CAP = 8   # premapped common keys per contract
    RECIPE_CAP = 8   # learned keccak recipes per contract
    SLOT_SCAN = 4    # mapping slot indices a miss is explained against
    DATA_WORDS = 4   # calldata words considered as mapping sources
    ARRAY_SPAN = 1 << 32  # max index an array recipe explains with

    def __init__(self, fork: str,
                 storage_resolver: Callable[[bytes, bytes], int],
                 device=None, specialize: bool = True):
        self.fork = fork
        self.resolver = storage_resolver
        self.device = default_device(device)
        self.specialize = specialize
        # code -> program index (sticky: the set only grows); codes the
        # tracer rejected; code -> its host-evaluated keccak requests
        self._spec_progs: Dict[bytes, int] = {}
        self._spec_bad: set = set()
        self._spec_reqs: Dict[bytes, Tuple] = {}
        self._kdig_zero: Optional[torch.Tensor] = None
        self.slot_gid: Dict[Tuple[bytes, bytes], int] = {}
        self.gid_keys: List[Tuple[bytes, bytes]] = []
        self.vals: List[int] = []
        # contract -> {key32: None} (dict as an ordered set)
        self.common: Dict[bytes, Dict[bytes, None]] = {}
        # bytecode -> {recipe: None}; recipe =
        # (selector, "caller", slot) | (selector, "data", word, slot) |
        # (selector, "nest", outer_tag, inner_tag, slot) |
        # (selector, "arr", tag, slot)
        self.recipes = RECIPES
        self.table: Optional[torch.Tensor] = None
        self.key_tab: Optional[torch.Tensor] = None
        self.table_cap = 0
        self._synced = 0          # rows present in the device tables
        self._stale = True        # device table != mirror: full rebuild
        # (code, code_cap) -> (code row, jdest row, len)
        self._code_rows: Dict[Tuple[bytes, int], Tuple] = {}
        # window code-assignment signature -> device (code, jdest,
        # code_len); at most 2 entries (see issue())
        self._win_code_cache: Dict[Tuple, Tuple] = {}
        self._hw: Dict[str, int] = {}   # sticky pow2 shape high-water
        self.premap_predicted = 0   # predicted keys seeded into premaps
        self.premap_hits = 0        # predicted keys lanes then touched
        self.premap_nested = 0      # keys derived via 2nd-level recipes
        self.premap_array = 0       # keys derived via array recipes
        self.discovery_dispatches = 0  # re-launches for missed keys
        self.lanes_specialized = 0  # lanes run on a traced program
        self.specialize_escapes = 0  # lanes kept on the interpreter
        self.programs_traced = 0    # contracts traced into programs
        # the sharded runner's placement and exchange counters (0 here)
        self.kr_lanes = 0           # lanes placed by key-range bucket
        self.cross_shard = 0        # lanes whose caller's account bucket
        #                             is not their contract's shard
        self.load_imb_sum = 0       # per-window max/mean shard lanes,
        self.load_imb_windows = 0   # permille, and the windows summed
        self.exchange_psum = 0      # key-range windows by sync mode
        self.exchange_ppermute = 0
        self.launches = 0
        self.steps = 0
        self.t_pack = self.t_machine = self.t_unpack = 0.0

    # ------------------------------------------------------------ state
    def poll_clean(self, handle: dict) -> bool:
        """Whether the window is known clean before its packed rows are
        fetched, so that the next window may launch first: never here,
        since one card's window has no flags reduce (the sharded runner
        fetches K9's)."""
        return False

    def invalidate(self) -> None:
        """The device table no longer matches the committed state (a
        dirty window left partial writes in it); the next issue()
        rebuilds it from the host mirror."""
        self._stale = True

    def commit_block(self,
                     writes: Dict[Tuple[bytes, bytes], int]) -> None:
        """Fold one committed block's storage writes into the host mirror
        (blocks the device committed already carry them in the resident
        table; blocks run elsewhere also need invalidate())."""
        for (contract, key), v in writes.items():
            g = self.slot_gid.get((contract, key))
            if g is None:
                g = len(self.vals)
                self.slot_gid[(contract, key)] = g
                self.gid_keys.append((contract, key))
                self.vals.append(v)
            else:
                self.vals[g] = v

    def _gid(self, contract: bytes, key: bytes) -> int:
        g = self.slot_gid.get((contract, key))
        if g is None:
            g = len(self.vals)
            self.slot_gid[(contract, key)] = g
            self.gid_keys.append((contract, key))
            self.vals.append(self.resolver(contract, key))
        return g

    def _key_mapped(self, contract: bytes, key: bytes) -> bool:
        return (contract, key) in self.slot_gid

    # ----------------------------------------------------- specialisation
    def _spec_id(self, code: bytes) -> int:
        """Program index for `code` (-1: the generic interpreter).  The
        first sighting of eligible code ADDS it to the sticky program
        set; workloads settle their hot-contract set in the first
        window, so steady state adds nothing (and builds no variant)."""
        if not self.specialize:
            return -1
        idx = self._spec_progs.get(code)
        if idx is not None:
            return idx
        if code in self._spec_bad \
                or len(self._spec_progs) >= SPEC_SET_CAP:
            return -1
        ok, _reason = SP.trace_eligible(code, self.fork)
        if not ok:
            self._spec_bad.add(code)
            return -1
        idx = len(self._spec_progs)
        self._spec_progs[code] = idx
        self._spec_reqs[code] = SP.spec_requests(code, self.fork)
        self.programs_traced += 1
        return idx

    def _zero_kdig(self, W: int, L: int) -> torch.Tensor:
        """The kdig input of a window with no keccak request (generic
        lanes, or programs without requests): a device zero tensor kept
        per shape, since the kernel only reads it."""
        z = self._kdig_zero
        if z is None or tuple(z.shape[:2]) != (W, L):
            z = self._kdig_zero = torch.zeros(
                (W, L, SP.KDIG_CAP, u256.LIMBS), dtype=torch.int32,
                device=self.device)
        return z

    def _spec_key(self) -> Tuple:
        """The program set: SpecProgram descriptors in program-index
        order (selects K6's variant)."""
        return tuple(SP.SpecProgram(code=c, fork=self.fork)
                     for c, _i in sorted(self._spec_progs.items(),
                                         key=lambda kv: kv[1]))

    def _code_pack(self, code: bytes, code_cap: int) -> Tuple:
        """``code_rows`` of one bytecode under one code_cap (memoized;
        the rows are read-only and copied whole into the batch)."""
        key = (code, code_cap)
        rows = self._code_rows.get(key)
        if rows is None:
            cb, jd, n = code_rows(code, code_cap, self.fork)
            cb.setflags(write=False)
            jd.setflags(write=False)
            rows = self._code_rows[key] = (cb, jd, n)
        return rows

    # -------------------------------------------------------- prediction
    def _rc_src(self, t: TxSpec, tag: tuple) -> bytes:
        """A recipe source tag's padded 32-byte value for THIS lane."""
        if tag[0] == "caller":
            return b"\x00" * 12 + t.caller
        return _cd_word(t.calldata, tag[1])

    def _learn_recipes(self, t: TxSpec, missed: List[bytes]) -> None:
        """Explain a lane's missed keys as
        ``keccak(pad32(source) || pad32(slot))`` over the lane's caller
        and calldata words (the Solidity mapping rule); each match
        becomes a recipe that derives later lanes' keys from their own
        inputs before launch.  A miss no first-level derivation explains
        is tried one level deeper — ``keccak(pad32(src2) || inner)``
        with ``inner`` a first-level digest (the nested-mapping rule,
        the allowance shape) — and then as an array element
        ``keccak(pad32(slot)) + v`` for a small source word ``v``."""
        if not missed:
            return
        recipes = self.recipes.setdefault(t.code, {})
        if len(recipes) >= self.RECIPE_CAP:
            return
        # scoped to the calldata selector they were learned from: a
        # transfer()-derived recipe must not predict keys for another
        # function's lanes (each wrong prediction claims a table row)
        sel = bytes(t.calldata[:4])
        srcs: List[Tuple[tuple, bytes]] = [
            (("caller",), b"\x00" * 12 + t.caller)]
        n_words = min(self.DATA_WORDS,
                      max(0, (len(t.calldata) - 4 + 31) // 32))
        for w in range(n_words):
            srcs.append((("data", w), _cd_word(t.calldata, w)))
        msgs = [src + slot.to_bytes(32, "big")
                for _tag, src in srcs
                for slot in range(self.SLOT_SCAN)]
        digs = keccak256_many(msgs)
        want = dict.fromkeys(missed)
        explained: Dict[bytes, None] = {}
        i = 0
        for tag, _src in srcs:
            for slot in range(self.SLOT_SCAN):
                if _norm_slot_key(digs[i]) in want \
                        and len(recipes) < self.RECIPE_CAP:
                    recipes[(sel,) + tag + (slot,)] = None
                    explained[_norm_slot_key(digs[i])] = None
                i += 1
        if len(recipes) < self.RECIPE_CAP:
            leftover = dict.fromkeys(
                k for k in want if k not in explained)
            if leftover:
                # second level: outer keccaks over every first-level
                # digest as the candidate inner hash, one batched call
                msgs2 = [src2 + digs[i]
                         for _tag2, src2 in srcs
                         for i in range(len(digs))]
                digs2 = keccak256_many(msgs2)
                j = 0
                for tag2, _src2 in srcs:
                    for i in range(len(digs)):
                        k2 = _norm_slot_key(digs2[j])
                        if k2 in leftover \
                                and len(recipes) < self.RECIPE_CAP:
                            tag1 = srcs[i // self.SLOT_SCAN][0]
                            slot = i % self.SLOT_SCAN
                            recipes[(sel, "nest", tag2, tag1,
                                     slot)] = None
                            explained[k2] = None
                        j += 1
        # third shape: a leftover miss equal to base(slot) + v for a
        # small source word v (an index argument, never an address)
        if len(recipes) >= self.RECIPE_CAP:
            return
        left2 = dict.fromkeys(k for k in want if k not in explained)
        if not left2:
            return
        for tag, src in srcs:
            v = int.from_bytes(src, "big")
            if v >= self.ARRAY_SPAN:
                continue
            for slot in range(self.SLOT_SCAN):
                cand = _norm_slot_key((
                    (_arr_base(slot) + v) % (1 << 256)
                ).to_bytes(32, "big"))
                if cand in left2 and len(recipes) < self.RECIPE_CAP:
                    recipes[(sel, "arr", tag, slot)] = None
                    # a second source word carrying the same value must
                    # not burn another recipe on the same key
                    del left2[cand]
                    explained[cand] = None
            if not left2:
                return

    def _premaps(self, items, discovered):
        """Per-lane premapped key lists: PREDICTED keys first (the static
        PUSH-constant footprint and the learned recipes applied to the
        lane's own caller and calldata), then the common-key residue,
        the seeded storage view, and keys discovered by earlier
        attempts.  Recipe keccaks batch across the whole window: one
        native call for every first-level digest (which doubles as the
        inner hash of the nested recipes), one for the nested recipes'
        outer keccaks.  Returns (premaps, predicted), ``predicted[bi][li]``
        the prediction-only key set (hit accounting in _update_common)."""
        msgs: List[bytes] = []
        meta: List[List[List[tuple]]] = []
        for _env, specs in items:
            block_meta = []
            for t in specs:
                sel = bytes(t.calldata[:4])
                lane = []
                for rc in self.recipes.get(t.code, ()):
                    if rc[0] != sel:
                        continue
                    if rc[1] == "nest":
                        _sel, _n, tag2, tag1, slot = rc
                        msgs.append(self._rc_src(t, tag1)
                                    + slot.to_bytes(32, "big"))
                        lane.append(("nest", self._rc_src(t, tag2)))
                    elif rc[1] == "arr":
                        _sel, _a, tag, slot = rc
                        v = int.from_bytes(self._rc_src(t, tag), "big")
                        if v >= self.ARRAY_SPAN:
                            continue
                        lane.append(("key", _norm_slot_key((
                            (_arr_base(slot) + v) % (1 << 256)
                        ).to_bytes(32, "big"))))
                    elif rc[1] == "caller":
                        msgs.append(b"\x00" * 12 + t.caller
                                    + rc[2].to_bytes(32, "big"))
                        lane.append(("flat",))
                    else:
                        msgs.append(_cd_word(t.calldata, rc[2])
                                    + rc[3].to_bytes(32, "big"))
                        lane.append(("flat",))
                block_meta.append(lane)
            meta.append(block_meta)
        digs = keccak256_many(msgs)
        # the nested recipes' outer keccaks consume the RAW inner digests
        # (only the final key normalizes)
        msgs2: List[bytes] = []
        di = 0
        for block_meta in meta:
            for lane in block_meta:
                for entry in lane:
                    if entry[0] == "key":
                        continue  # host-derived; no digest consumed
                    if entry[0] == "nest":
                        msgs2.append(entry[1] + digs[di])
                    di += 1
        digs2 = keccak256_many(msgs2)
        di = dj = 0
        premaps = []
        predicted = []
        for bi, ((_env, specs), disc) in enumerate(zip(items, discovered)):
            block_pre = []
            block_predicted = []
            for li, t in enumerate(specs):
                keys: Dict[bytes, None] = {}
                pred: Dict[bytes, None] = {}
                for k in _static_premap(t.code):
                    keys[k] = None
                    pred[k] = None
                for entry in meta[bi][li]:
                    if entry[0] == "key":
                        k = entry[1]
                        self.premap_array += 1
                    elif entry[0] == "nest":
                        k = _norm_slot_key(digs2[dj])
                        dj += 1
                        self.premap_nested += 1
                        di += 1
                    else:
                        k = _norm_slot_key(digs[di])
                        di += 1
                    keys[k] = None
                    pred[k] = None
                for k in self.common.get(t.address, ()):
                    keys[k] = None
                for k in t.storage:
                    keys[k] = None
                    pred.pop(k, None)
                for k in disc[li]:
                    keys[k] = None
                    pred.pop(k, None)
                block_pre.append(list(keys))
                block_predicted.append(pred)
            premaps.append(block_pre)
            predicted.append(block_predicted)
        return premaps, predicted

    # ------------------------------------------------------------- shape
    def _occ_params(self, items, premaps):
        max_code = 64
        max_data = 64
        max_lanes = 1
        max_slots = 4
        unmapped = 0  # premap keys that will claim rows during packing
        for (_env, specs), block_pre in zip(items, premaps):
            max_lanes = max(max_lanes, len(specs))
            for t, pre in zip(specs, block_pre):
                info = T.scan_code(t.code, self.fork)
                if not info.eligible:
                    raise ValueError(
                        f"TxSpec code not device-eligible: {info.reason}")
                self._spec_id(t.code)  # the program set settles first
                max_code = max(max_code, len(t.code))
                max_data = max(max_data, len(t.calldata))
                max_slots = max(max_slots, len(pre) + 8)
                for k in pre:
                    if (t.address, k) not in self.slot_gid:
                        unmapped += 1
        p = M.MachineParams(
            fork=self.fork,
            batch=_pow2(max_lanes, 8),
            code_cap=_pow2(max_code, 256),
            data_cap=_pow2(max_data, 128),
            scache_cap=_pow2(max_slots, 8))
        occ = M.OccParams(
            blocks=_pow2(len(items), 1),
            table_cap=_pow2(len(self.vals) + unmapped + 1, 64),
            rounds=p.batch + 1)
        return self._apply_buckets(p, occ)

    def _apply_buckets(self, p: M.MachineParams,
                       occ: M.OccParams) -> Tuple:
        """Sticky pow2 shape buckets: every dimension only ratchets UP
        over the runner's life, and the table never shrinks (growth pads
        it on the device, see _device_tables).  This decides
        ``scache_cap`` and with it which lanes escape on cache capacity,
        exactly as the reference's bucketing does.  Inactive lanes and
        blocks cost nothing: they never run."""
        hw = self._hw
        p = M.MachineParams(
            fork=p.fork,
            batch=max(p.batch, hw.get("batch", 0)),
            code_cap=max(p.code_cap, hw.get("code_cap", 0)),
            data_cap=max(p.data_cap, hw.get("data_cap", 0)),
            scache_cap=max(p.scache_cap, hw.get("scache_cap", 0)))
        occ = M.OccParams(
            blocks=max(occ.blocks, hw.get("blocks", 0)),
            table_cap=max(occ.table_cap, self.table_cap),
            rounds=p.batch + 1)
        hw.update(batch=p.batch, code_cap=p.code_cap,
                  data_cap=p.data_cap, scache_cap=p.scache_cap,
                  blocks=occ.blocks)
        return p, occ

    def seed_window_hint(self, blocks: int) -> None:
        """Steady-state windows hold ``blocks`` machine blocks: size the
        block axis there from the first launch (inactive trailing blocks
        leave the kernel's loop at once)."""
        self._hw["blocks"] = max(self._hw.get("blocks", 0),
                                 _pow2(max(1, blocks), 1))

    def _device_tables(self, G: int):
        n = len(self.vals)
        if self.table is not None and not self._stale \
                and G > self.table_cap:
            # pad the resident tables on the device: no host-mirror trip
            pad = G - self.table_cap
            z = torch.zeros((pad, u256.LIMBS), dtype=torch.int32,
                            device=self.device)
            self.table = torch.cat([self.table, z])
            self.key_tab = torch.cat([self.key_tab, z])
            self.table_cap = G
        if self.table is None or self.table_cap != G or self._stale:
            tv = np.zeros((G, u256.LIMBS), dtype=np.int32)
            tk = np.zeros((G, u256.LIMBS), dtype=np.int32)
            if n:
                tv[:n] = u256.pack_np(self.vals)
                tk[:n] = u256.pack_np([int.from_bytes(k, "big")
                                       for _c, k in self.gid_keys])
            self.table = _upload(tv, self.device)
            self.key_tab = _upload(tk, self.device)
            self.table_cap = G
            self._synced = n
            self._stale = False
        elif self._synced < n:
            # append newly mapped rows; already-synced rows are live on
            # the device (committed by the kernel itself)
            idx = np.arange(self._synced, n, dtype=np.int64)
            _scatter_rows(self.table, idx,
                          u256.pack_np(self.vals[self._synced:]))
            _scatter_rows(self.key_tab, idx, u256.pack_np(
                [int.from_bytes(k, "big")
                 for _c, k in self.gid_keys[self._synced:]]))
            self._synced = n
        return self.table, self.key_tab

    # ------------------------------------------------------------- issue
    def pack(self, items, discovered=None, attempt: int = 1) -> dict:
        """Premap, pack and upload one window: returns the launch's
        arguments (``p``, ``occ``, ``table``, ``key_tab``, ``inputs``,
        ``spec``) with the premaps and their predicted subsets.  Maps
        every premapped key to a table row (resolving new ones), gives
        every lane its program id and keccak digests (counted on the
        window's first ``attempt``) and brings the device tables up to
        date; launches nothing.

        items: [(BlockEnv, [TxSpec, ...]), ...] in chain order."""
        discovered, premaps, predicted, p, occ = self._prepare(
            items, discovered)
        W, S, G = occ.blocks, p.scache_cap, occ.table_cap
        L = self._lane_count(p)
        lane_map = self._lane_map(items, premaps, p, attempt)
        lanes = None if lane_map is None else (L, lane_map)
        arrays = window_arrays(p, W, items, lanes)
        sgid = np.full((W, L, S), G, dtype=np.int32)
        for bi, ((_env, specs), block_pre) in enumerate(
                zip(items, premaps)):
            for li, t in enumerate(specs):
                fl = li if lane_map is None else lane_map[bi][li]
                for j, key in enumerate(block_pre[li]):
                    sgid[bi, fl, j] = self._lane_gid(t.address, key, fl, p)
        arrays["sgid"] = sgid
        prog_id = np.full((W, L), -1, dtype=np.int32)
        kjobs: List[Tuple] = []
        for bi, (env, specs) in enumerate(items):
            for li, t in enumerate(specs):
                fl = li if lane_map is None else lane_map[bi][li]
                pid = self._spec_progs.get(t.code, -1)
                prog_id[bi, fl] = pid
                if pid >= 0 and self._spec_reqs.get(t.code):
                    kjobs.append((bi, fl, t, env, self._spec_reqs[t.code]))
                if attempt == 1:
                    if pid >= 0:
                        self.lanes_specialized += 1
                    elif self.specialize:
                        self.specialize_escapes += 1
        arrays["prog_id"] = prog_id
        if kjobs:
            kdig = np.zeros((W, L, SP.KDIG_CAP, u256.LIMBS), dtype=np.int32)
            fill_kdig(kdig, kjobs)
            arrays["kdig"] = kdig
        table, key_tab = self._device_tables(G)
        # the lane -> bytecode assignment recurs window after window, and
        # the code / jump-table rows are the largest window inputs: keep
        # them on the device while the assignment signature repeats
        code_sig = (W, L, p.code_cap,
                    tuple(tuple(t.code for t in specs)
                          for _env, specs in items),
                    lane_map and tuple(map(tuple, lane_map)))
        code_dev = self._win_code_cache.get(code_sig)
        if code_dev is None:
            ca = code_arrays(p, W, items,
                             lambda c: self._code_pack(c, p.code_cap), lanes)
            code_dev = tuple(_upload(ca[k], self.device)
                             for k in ("code", "jdest", "code_len"))
            if len(self._win_code_cache) >= 2:
                # steady state needs two signatures at most (a short lead
                # window and the full window); a shifting workload rebuilds
                self._win_code_cache.clear()
            self._win_code_cache[code_sig] = code_dev
        inputs = {k: _upload(v, self.device)
                  for k, v in arrays.items()}
        if not kjobs:
            inputs["kdig"] = self._zero_kdig(W, L)
        inputs.update(zip(("code", "jdest", "code_len"), code_dev))
        return dict(p=p, occ=occ, table=table, key_tab=key_tab,
                    inputs=inputs, spec=self._spec_key(), items=items,
                    discovered=discovered, premaps=premaps,
                    predicted=predicted, lane_map=lane_map)

    # ------------------------------------------------ sharding hooks
    # The identities of one card; the sharded runner (evm/device/shard.py
    # ShardedWindowRunner) places lanes on shards through them.
    def _prepare(self, items, discovered):
        """(discovered, premaps, predicted, p, occ) of a window."""
        if discovered is None:
            discovered = [[{} for _t in specs] for _env, specs in items]
        premaps, predicted = self._premaps(items, discovered)
        p, occ = self._occ_params(items, premaps)
        return discovered, premaps, predicted, p, occ

    def _lane_count(self, p: M.MachineParams) -> int:
        """Lanes of one block row of the window's lane tensors."""
        return p.batch

    def _lane_map(self, items, premaps, p: M.MachineParams,
                  attempt: int) -> Optional[List[List[int]]]:
        """Lane of each tx (``[bi][li]``); None: tx li at lane li."""
        return None

    def _lane_gid(self, contract: bytes, key: bytes, lane: int,
                  p: M.MachineParams) -> int:
        """Table row lane ``lane`` reads ``key`` at."""
        return self._gid(contract, key)

    def _block_stride(self, handle: dict) -> int:
        """Packed rows per block (the lane axis's width)."""
        return handle["p"].batch

    def _lane_idx(self, handle: dict, bi: int, li: int) -> int:
        """Lane of tx li of block bi."""
        return li

    def _on_result_fetch(self, handle: dict) -> None:
        """Called once the packed rows of a launch are on the host."""

    def _discover_key(self, handle: dict, bi: int, li: int,
                      contract: bytes, key: bytes) -> None:
        """Map a key the F_MISS escape of tx li of block bi found."""
        self._gid(contract, key)

    def issue(self, items, discovered=None, attempt: int = 1) -> dict:
        """Pack and launch one window; returns a handle for complete().
        The launch is asynchronous and nothing here waits for the card:
        callers fold the previous window's tries while this one runs,
        and block only in complete()'s fetch.  The ``device/dispatch``
        injection point fires first, before any packing."""
        faults.fire(PT_DISPATCH)
        t0 = time.monotonic()
        handle = self.pack(items, discovered, attempt)
        t1 = time.monotonic()
        with obs.device_span("coreth/occ_window"):
            handle["out"] = M.run_occ_window(
                handle["p"], handle["occ"], handle.pop("table"),
                handle.pop("key_tab"), handle.pop("inputs"),
                handle["spec"])
        # the launch's output table (the post-window committed state)
        # replaces the resident one; the stream orders its later uses
        self.table = handle["out"]["table"]
        self.launches += 1
        self.t_pack += t1 - t0
        self.t_machine += time.monotonic() - t1
        handle["attempt"] = attempt
        return handle

    # ---------------------------------------------------------- complete
    def complete(self, handle: dict) -> WindowResult:
        """Fetch a window's results; resolve the storage keys lanes
        missed, learn recipes from them, and re-launch the whole window
        from the host mirror (bounded attempts, counted in
        ``discovery_dispatches``) until no key is left to resolve."""
        while True:
            t0 = time.monotonic()
            p = handle["p"]
            Lp = self._block_stride(handle)
            packed = handle["out"]["packed"].cpu().numpy()
            self.steps += int(handle["out"]["steps"].sum())
            self._on_result_fetch(handle)
            t1 = time.monotonic()
            self.t_machine += t1 - t0
            pw = packed.shape[2] - 4
            pout = PackedOut(packed[:, :, :pw].reshape(-1, pw), p)
            extra = packed[:, :, pw:]
            missing = False
            for bi, (_env, specs) in enumerate(handle["items"]):
                for li, t in enumerate(specs):
                    fl = self._lane_idx(handle, bi, li)
                    if not extra[bi, fl, 1]:
                        continue  # escaped lanes only carry misses
                    disc = handle["discovered"][bi][li]
                    fresh: List[bytes] = []
                    for key in miss_keys(pout, bi * Lp + fl):
                        if not self._key_mapped(t.address, key):
                            self._discover_key(handle, bi, li, t.address,
                                               key)
                        if key not in disc:
                            disc[key] = None
                            fresh.append(key)
                            missing = True
                    self._learn_recipes(t, fresh)
            self.t_unpack += time.monotonic() - t1
            if missing and handle["attempt"] < MAX_WINDOW_ATTEMPTS:
                # re-run the WHOLE window from the host mirror (the
                # failed attempt's device table holds partial commits)
                self.discovery_dispatches += 1
                self._stale = True
                handle = self.issue(handle["items"], handle["discovered"],
                                    attempt=handle["attempt"] + 1)
                continue
            break
        t2 = time.monotonic()
        results, committed, escape, clean, rounds = [], [], [], [], []
        for bi, (_env, specs) in enumerate(handle["items"]):
            n = len(specs)
            lanes = np.array([self._lane_idx(handle, bi, li)
                              for li in range(n)], dtype=np.int64)
            res = results_for_rows(pout, lanes + bi * Lp)
            com = extra[bi, lanes, 0].astype(bool)
            esc = (extra[bi, lanes, 1] | extra[bi, lanes, 2]).astype(bool)
            results.append(res)
            committed.append(com)
            escape.append(esc)
            clean.append(bool(com.all()))
            # per-shard round counts may differ: the block's is the max
            rounds.append(int(extra[bi, lanes, 3].max()) if n else 0)
        self._update_common(handle, pout, clean)
        self.t_unpack += time.monotonic() - t2
        return WindowResult(results=results, committed=committed,
                            escape=escape, clean=clean, rounds=rounds,
                            attempts=handle["attempt"])

    def _update_common(self, handle, pout: PackedOut,
                       clean: List[bool]) -> None:
        """Count predicted-premap keys and hits (against the final
        attempt's prediction sets), and narrow each contract's
        common-key residue to the keys EVERY lane touched."""
        Lp = self._block_stride(handle)
        predicted = handle["predicted"]
        kb = pout.key_blob()
        for bi, (_env, specs) in enumerate(handle["items"]):
            if not clean[bi]:
                continue
            for li, t in enumerate(specs):
                row = bi * Lp + self._lane_idx(handle, bi, li)
                touched: Dict[bytes, None] = {}
                flags = pout.sflag[row]
                for j in range(int(pout.scnt[row])):
                    if flags[j] & (M.F_READ | M.F_WRITTEN):
                        off = (row * pout.S + j) * 32
                        touched[kb[off:off + 32]] = None
                self.premap_predicted += len(predicted[bi][li])
                self.premap_hits += sum(
                    1 for k in predicted[bi][li] if k in touched)
                cur = self.common.get(t.address)
                if cur is None:
                    keep = list(touched)[:self.COMMON_CAP]
                    self.common[t.address] = dict.fromkeys(keep)
                else:
                    self.common[t.address] = {
                        k: None for k in cur if k in touched}
