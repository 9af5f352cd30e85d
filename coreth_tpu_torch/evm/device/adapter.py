"""Host adapter for the device step machine.

Port of reference ``evm/device/adapter.py``, cut to the single-shot
runner (``MachineRunner``) and the packed-row readers: it packs a batch
of same-block calls into machine inputs, runs the miss-and-rerun
storage rounds, and unpacks per-tx results (status / gas left / refund
/ logs / storage read- and write-sets).  Cross-tx ordering inside a
block is the caller's (``replay/machine_block``): this module only
executes a batch against the pre-states it is handed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from coreth_tpu_torch import default_device
from coreth_tpu_torch.evm.device import machine as M
from coreth_tpu_torch.evm.device import tables as T
from coreth_tpu_torch.ops import u256

# miss-and-rerun rounds of one MachineRunner.run before a lane still
# missing storage goes to the host (the reference's max_rounds default)
MISS_ROUNDS = 6


def addr_word(addr: bytes) -> int:
    return int.from_bytes(addr, "big")


def word16(v: int) -> np.ndarray:
    """u256 int -> 16 little-endian int32 limbs (the machine layout)."""
    return np.frombuffer(
        v.to_bytes(32, "little"), dtype=np.uint16).astype(np.int32)


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
        B = p.batch
        S = p.scache_cap
        code = np.zeros((B, p.code_cap + 33), dtype=np.int32)
        code_len = np.zeros((B,), dtype=np.int32)
        jdest = np.zeros((B, p.code_cap), dtype=np.int32)
        calldata = np.zeros((B, p.data_cap), dtype=np.int32)
        data_len = np.zeros((B,), dtype=np.int32)
        start_gas = np.zeros((B,), dtype=np.int32)
        active = np.zeros((B,), dtype=np.int32)
        skey = np.zeros((B, S, u256.LIMBS), dtype=np.int32)
        sval = np.zeros((B, S, u256.LIMBS), dtype=np.int32)
        sorig = np.zeros((B, S, u256.LIMBS), dtype=np.int32)
        sflag = np.zeros((B, S), dtype=np.int32)
        scnt = np.zeros((B,), dtype=np.int32)
        words = {k: np.zeros((B, u256.LIMBS), dtype=np.int32)
                 for k in ("callvalue", "caller_w", "address_w",
                           "origin_w", "gasprice_w")}
        for i, t in enumerate(txs):
            cb = np.frombuffer(t.code, dtype=np.uint8)
            code[i, :len(cb)] = cb
            code_len[i] = len(cb)
            dests = [d for d in T.scan_code(t.code, self.fork).jumpdests
                     if d < p.code_cap]
            jdest[i, dests] = 1
            db = np.frombuffer(t.calldata, dtype=np.uint8)
            calldata[i, :len(db)] = db
            data_len[i] = len(db)
            start_gas[i] = t.gas
            active[i] = 1
            words["callvalue"][i] = word16(t.value)
            words["caller_w"][i] = word16(addr_word(t.caller))
            words["address_w"][i] = word16(addr_word(t.address))
            words["origin_w"][i] = word16(addr_word(t.origin))
            words["gasprice_w"][i] = word16(t.gas_price)
            for j, (key, (cur, orig)) in enumerate(t.storage.items()):
                skey[i, j] = word16(int.from_bytes(key, "big"))
                sval[i, j] = word16(cur)
                sorig[i, j] = word16(orig)
                sflag[i, j] = M.F_VALID | (
                    M.F_WARM if key in t.warm_slots else 0)
            scnt[i] = len(t.storage)
        env = self.env
        arrays = dict(
            code=code, jdest=jdest, code_len=code_len, calldata=calldata,
            data_len=data_len, start_gas=start_gas, active=active,
            skey=skey, sval=sval, sorig=sorig, sflag=sflag, scnt=scnt,
            coinbase_w=word16(addr_word(env.coinbase)),
            chainid_w=word16(env.chain_id),
            basefee_w=word16(env.base_fee), **words)
        inputs = {k: _upload(v, self.device) for k, v in arrays.items()}
        inputs.update(timestamp=env.timestamp, number=env.number,
                      gaslimit=min(env.gas_limit, (1 << 31) - 1))
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
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device) if device.type != "cpu" else t


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
