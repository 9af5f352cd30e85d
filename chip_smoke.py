#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``coreth_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card's name and power limit (nvidia-smi) and torch's view;
2. build  — ``make -C native`` and one ``nvcc`` per kernel source, all
   started together; build seconds;
3. K1     — the transfer-window kernel against its plain PyTorch version on
   the card, at main-path shapes (128 blocks x 128 txs, ~9.4k window
   locals), on a window with token slot amounts, an insolvent block, a
   nonce-mismatch block and out-of-bounds pad gids: tables and fetch rows
   must be equal exactly (tolerance 0: integer results);
4. K2     — the secp256k1 recovery kernel against its plain version on 4096
   signatures made with the port's ``sign`` plus malformed rows (r or s out
   of range, recid 2/3, x >= p): the 102-byte rows must be equal exactly,
   and the addresses recovered through the kernel must equal the native
   C++ ``recover_addresses_batch``;
5. main   — the benchmark's transfer shape (1024 keys, 128 txs/block, every
   other recipient fresh, TEST_CHAIN_CONFIG, gap 10), cut to 256 blocks,
   built by the port's sequential chain builder and replayed through
   ``ReplayEngine(device="cuda", window=128)``: every block must take the
   device path, the final root must equal the last header's, and both
   kernels' launch counters must rise during the replay;
6. k3     — the keccak-256 launch entry against its plain version on 4096
   messages of 0..271 bytes plus the 135/136-byte padding edges
   (tolerance 0), and against the native C++ ``coreth_keccak256``;
7. k4     — the 256-bit ALU launch entry, every op, against its plain
   version on 4096 random operand rows plus every pair of edge operands
   (0, 1, 2^255, 2^256 - 1 = -1 signed, shift edges): tolerance 0;
8. k5     — the step machine at main-path shapes (batch 256): ERC-20
   ``transfer()`` lanes with the storage cache seeded and unseeded (miss
   rows), lanes that REVERT (insufficient balance), run out of gas, hit
   INVALID or escape HOST: packed rows and step counts equal to the plain
   version's (tolerance 0); then the launch's time split: the same batch
   with every lane a lone STOP (wrapper and lane set-up only), and the
   kernel's device time from a ``torch.profiler`` trace of both;
9. machine — the benchmark's ERC-20 shape (1024 keys, 256 txs/block, every
   third recipient the next key, TEST_CHAIN_CONFIG, the bench genesis),
   cut from 256 to 128 blocks because the chain is built with pure-Python
   signing within the script's run-time budget, replayed through
   ``ReplayEngine(device="cuda", device_occ=False)`` (per-block OCC on the
   step machine): every block on the machine path, OCC rounds > 0, the
   final root equal to the last header's, and the step machine's launch
   counter rising during the replay; txs/s over the whole replay and
   after the first fold (``steady_txs_per_s``);
10. k6    — the fused OCC window against its plain version (tolerance 0:
   table, packed rows, lane-steps) on three windows: (a) the ERC-20
   chain's first 8 blocks x 256 lanes with the premaps the window runner
   learns from them, (b) two blocks of 8 swaps (full conflict, one lane
   per round), (c) three blocks of 16 ERC-20 transfers with a HOST lane,
   an unpremapped lane and five trailing inactive blocks; per-launch ms
   (CUDA events), device ms (``torch.profiler``), rounds per block,
   lane-steps, and the bound from the bytes this window's lanes need
   (``_window_bound``);
11. k7    — K6+K7, the variants generated for each window's program set
   (built by nvcc in parallel first; build seconds and ``ptxas`` lines),
   against the plain version with the same plain programs (tolerance 0:
   table, packed rows, lane-steps) on five windows: (a) window (a) of
   phase k6 with every lane traced, also run through the generic library
   with every prog_id -1 (its time beside; equal results), (b) the swap
   window, (c) two blocks of 16 lanes mixing token transfers, a transfer
   over the balance (REVERT), swaps and computed-jump lanes that stay on
   the interpreter, (d) 16 lanes of the keccak fan (ten host-evaluable
   keccaks, two past the kdig slots, and a device keccak), (e) lanes
   whose storage cache fills (HOST) and lanes out of gas at the first
   lumped flush; per-launch ms, device ms, bound, plain ms;
12. window, spec — the same ERC-20 chain through ``ReplayEngine(device=
   "cuda", device_occ=True)`` four times, in the order window, spec,
   spec, window: without K7 (``specialize=False``, phase window) and
   with it (``specialize=True``, phase spec, the reference's default
   machine path).  Each run: the final root equal to the last header's,
   no dirty block, K6 launched at least once per window and the step
   machine never, no kernel built inside the timed replay; without K7 no
   variant launch, with it every lane traced (``lanes_specialized`` =
   blocks x txs, no escape, one program) and every window launch on the
   variant.  Each prints txs/s, ``steady_txs_per_s`` (after the first
   window's fold, which holds the discovery re-launches) and the host
   spans of ``HostSpans``: seconds and calls of the window path's host
   functions and the garbage collector's pauses, up to the first fold
   and over the replay.  A last line ``ab`` lists the four first-fold
   times and steady rates in order.

Beside them, for the sharded transfer path (n = 2, 4 and 8 shards on
the one card):

3b. k8     — the sharded window (one cluster launch of n CTAs) against its
   plain version on phase k1's window, in both exchange modes: tables,
   fetch rows and every shard's working set equal (tolerance 0), the n
   working sets equal, the fetch rows equal to K1's; ms beside K1's on
   the same window, the exchange bytes, and K1's bound;
4b. k8r    — the sharded ladder (K2 on each of n slices, each on its own
   stream) against K2 on phase k2's signatures: rows equal;
5b. shard  — phase main's chain (fresh decodes from the wire) through
   ``ReplayEngine(mesh=make_mesh(n))``: root equal to the header, every
   block on the device, K8 and K8r launched and K1 not; txs/s, the
   ``ReplayStats`` and the real txs per shard per block;
12b. k9    — the sharded OCC window (one cluster launch of n CTAs) against
   its plain version on phase k6's window (a) packed by sharded runners at
   n = 2, 4 and 8, with key-range placement off (the token on its
   contract bucket, no sync set) and on (the token hot, with the sync
   set), in both modes, through the token's K7 variant and through the
   generic library: tables and packed rows equal (tolerance 0), lane-steps
   too on the variant; ms per window, the bound over the shards' lanes
   and arenas (``_window_bound``), plain ms;
12c. k9x   — the flags reduce against its plain version on every phase-k9
   output: (W, 2) flags equal; ms and the byte bound;
13. shard_erc20 — the ERC-20 chain through the window path with K7 on a
   4-shard engine four times, in the order sharded, single, single,
   sharded: the sharded runner (the reference default: K9 at least once
   a window, K9x, the single-chip K6/K7 never, ``kr_lanes`` > 0) and the
   single-chip runner over the sharded tables (``shard_occ=False``: K6+K7,
   K9 never); root equal, no dirty block, nothing built inside the timed
   replay; then a closing ``shard_erc20_ab`` line;
14. hot    — the single-hot-contract chain at the reference bench's shape
   (64 blocks x 128 txs, 256 keys, Zipf alpha 1.1, seed 20260804; one
   ERC-20-shaped contract takes every tx) replayed as the bench does on
   one shard and at n = 2 and 4: root equal, every block on the machine
   path with no dirty block; txs/s, ``load_imbalance``, ``kr_lanes``,
   ``cross_shard`` and the exchange counts.

Then one JSON line with every kernel's numbers, the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
nonzero; without a card, or without the package beside this script, it
exits nonzero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 20261017
GWEI = 10**9
H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
# 32-bit integer multiply-adds: 64 per SM per clock (half the FP32 lanes),
# 132 SMs at the 1.98 GHz boost clock
H100_IMAD_PER_S = 64 * 132 * 1.98e9
H100_INT32_OPS_PER_S = 2 * H100_IMAD_PER_S


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_ms(fn, name: str, reps: int = 10):
    """Mean device milliseconds per launch of the kernels whose name
    holds ``name``, from a ``torch.profiler`` trace of ``reps`` calls of
    ``fn``; None when the trace shows no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            us += getattr(ev, "device_time_total",
                          getattr(ev, "cuda_time_total", 0.0))
            n += ev.count
    return us / n / 1000 if n and us else None


def max_abs_err(got, want) -> int:
    """Largest absolute difference over paired integer tensors."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def once_ms(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1000 * (time.perf_counter() - t0)


# ------------------------------------------------------------ K1 inputs

def random_window(rng, K: int, pad: int, B: int, cap: int, scap: int,
                  n_acct: int, n_slot: int, L: int, SL: int,
                  t_pad: int, s_pad: int):
    """A random transfer window in the engine's packed layout (numpy):
    (balances, nonces, slot_vals, acct_gids, slot_gids, txds, t_idxs,
    s_idxs).  Senders are funded and nonces follow the sequence, except:
    block 1 has an insolvent sender, block 2 a nonce mismatch.  Token
    slot amounts are nonzero; acct/slot gids past the touched set are the
    out-of-bounds pad (``cap`` / ``scap``)."""
    from coreth_tpu_torch.ops import u256
    from coreth_tpu_torch.replay.engine import TXD_COLS
    big = [int(v) << 96 for v in rng.integers(1, 1 << 60, size=cap)]
    balances = u256.pack_np(big)
    nonces = rng.integers(0, 1000, size=cap).astype(np.int32)
    slot_vals = u256.pack_np(
        [int(v) << 100 for v in rng.integers(1, 1 << 60, size=scap)])
    rows = rng.choice(cap, size=n_acct, replace=False).astype(np.int32)
    acct_gids = np.full(L, cap, dtype=np.int32)
    acct_gids[:n_acct] = rows
    srows = rng.choice(scap, size=n_slot, replace=False).astype(np.int32)
    slot_gids = np.full(SL, scap, dtype=np.int32)
    slot_gids[:n_slot] = srows
    local_nonce = nonces[rows].astype(np.int64)
    txds = np.zeros((K, pad, TXD_COLS), dtype=np.int32)
    t_idxs = np.zeros((K, t_pad), dtype=np.int32)
    s_idxs = np.zeros((K, s_pad), dtype=np.int32)
    for k in range(K):
        n_senders = max(1, min(B // 2, n_acct // 4))
        senders = rng.integers(0, n_senders, size=B)
        recips = rng.integers(0, n_acct, size=B)
        coinbase = int(rng.integers(0, n_acct))
        offsets = np.zeros(B, dtype=np.int64)
        seen = {}
        for i, s in enumerate(senders):
            offsets[i] = seen.get(int(s), 0)
            seen[int(s)] = offsets[i] + 1
        values = [int(v) for v in rng.integers(0, 1 << 40, size=B)]
        fees = [21000 * int(p) for p in rng.integers(1, 1 << 38, size=B)]
        required = [21000 * (1 << 40) + v for v in values]
        if k == 1:
            required[0] = 1 << 250           # insolvent
        tx_nonce = local_nonce[senders] + offsets
        if k == 2:
            tx_nonce[B // 2] += 1            # nonce mismatch
        fs = rng.integers(0, n_slot, size=B)
        ts = rng.integers(0, n_slot, size=B)
        amounts = [int(v) for v in rng.integers(0, 1 << 50, size=B)]
        txd = txds[k]
        txd[:B, 0] = senders
        txd[:B, 1] = recips
        txd[:B, 2] = tx_nonce
        txd[:B, 3] = offsets
        txd[:B, 4] = 1
        txd[:, 5] = coinbase
        txd[:B, 6:22] = u256.pack_np(values)
        txd[:B, 22:38] = u256.pack_np(fees)
        txd[:B, 38:54] = u256.pack_np(required)
        txd[:B, 54] = fs
        txd[:B, 55] = ts
        txd[:B, 56:72] = u256.pack_np(amounts)
        for s in seen:
            local_nonce[s] += seen[s]
        touched = sorted(set(senders.tolist()) | set(recips.tolist())
                         | {coinbase})[:t_pad]
        t_idxs[k, :len(touched)] = touched
        stouched = sorted(set(fs.tolist()) | set(ts.tolist()))[:s_pad]
        s_idxs[k, :len(stouched)] = stouched
    return (balances, nonces, slot_vals, acct_gids, slot_gids, txds,
            t_idxs, s_idxs)


# ------------------------------------------------------------ K2 inputs

def signature_batch(n: int, seed: int):
    """n signatures made with the port's ``sign`` plus malformed rows:
    r = 0, s = n (out of range), recid 2 and 3 (x = r + n), and x >= p
    crafted straight into the kernel input.  Returns the packed
    (hashes, rs, ss, recids) and the kernel inputs."""
    import random
    from coreth_tpu_torch.crypto import native
    from coreth_tpu_torch.crypto.secp256k1 import N, sign
    from coreth_tpu_torch.ops.secp import P
    rnd = random.Random(seed)
    hashes, rs, ss, recids = [], [], [], []
    for _ in range(n):
        h = rnd.randbytes(32)
        r, s, v = sign(h, rnd.randrange(1, N))
        hashes.append(h)
        rs.append(r)
        ss.append(s)
        recids.append(v)
    # malformed rows overwrite the tail
    rs[-1] = 0
    ss[-2] = N
    recids[-3] = 2
    recids[-4] = 3
    rs[-5] = N - 1
    packed = (b"".join(hashes),
              b"".join(r.to_bytes(32, "big") for r in rs),
              b"".join(s.to_bytes(32, "big") for s in ss),
              bytes(recids))
    xs, u1, u2, _ok = native.recover_prep(*packed)
    x = np.frombuffer(xs, dtype=np.uint8).reshape(n, 33).copy()
    x[-6] = np.frombuffer((P + 12345).to_bytes(33, "little"), np.uint8)
    x[-7] = np.frombuffer((2**256 - 1).to_bytes(33, "little"), np.uint8)
    parity = np.frombuffer(packed[3], np.uint8).astype(np.int32) & 1
    u1w = np.frombuffer(u1, "<u4").reshape(n, 8).astype(np.int32)
    u2w = np.frombuffer(u2, "<u4").reshape(n, 8).astype(np.int32)
    return packed, (x, parity, u1w, u2w)


def ladder_imads(u1w: np.ndarray, u2w: np.ndarray) -> int:
    """32-bit multiply-adds the recovery kernel does on these inputs:
    128 per field multiply (64 word products, lo and hi halves); per row
    the two exponentiations, 7 multiplies per doubling, and 11 per ladder
    step that adds (a set bit of u1 or u2, after the first)."""
    from coreth_tpu_torch.ops.secp import P
    pow_muls = 512 + bin((P + 1) // 4).count("1") + bin(P - 2).count("1")
    fixed = 4 + 6 + pow_muls + 7 * 256      # y^2 check, G+R entry
    bits = np.unpackbits(
        (u1w.view(np.uint32) | u2w.view(np.uint32)).view(np.uint8),
        axis=1).sum(axis=1)
    adds = np.maximum(bits.astype(np.int64) - 1, 0)
    return int(128 * (fixed * u1w.shape[0] + 11 * adds.sum()))


# ------------------------------------------------------------ K4 inputs

ALU_EDGES = [0, 1, 2, 30, 31, 32, 255, 256, (1 << 255) - 1, 1 << 255,
             (1 << 255) + 1, (1 << 256) - 2, (1 << 256) - 1]


def alu_operands(rng, n: int):
    """(a, b, c) as (n + edges^2 rows, 16) int32 limb arrays: random
    256-, 64- and 8-bit values and powers of two, then every pair of
    edge values (0, 1, 2^255, 2^256 - 1 = -1 signed, shift edges) in
    (a, b) with c cycling through the edges."""
    from coreth_tpu_torch.ops import u256

    def rand(k):
        kinds = rng.integers(0, 4, size=k)
        out = []
        for kind in kinds:
            if kind == 0:
                out.append(int.from_bytes(rng.bytes(32), "big"))
            elif kind == 1:
                out.append(int.from_bytes(rng.bytes(8), "big"))
            elif kind == 2:
                out.append(int(rng.integers(0, 256)))
            else:
                out.append(1 << int(rng.integers(0, 256)))
        return out
    a, b, c = rand(n), rand(n), rand(n)
    for i, x in enumerate(ALU_EDGES):
        for j, y in enumerate(ALU_EDGES):
            a.append(x)
            b.append(y)
            c.append(ALU_EDGES[(i + j) % len(ALU_EDGES)])
    return u256.pack_np(a), u256.pack_np(b), u256.pack_np(c)


# ------------------------------------------------------------ main path

def build_chain(n_blocks: int, txs: int, n_keys: int):
    from coreth_tpu_torch.chain import Genesis, GenesisAccount, generate_chain
    from coreth_tpu_torch.crypto.secp256k1 import priv_to_address
    from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import DynamicFeeTx, sign_tx
    keys = [0xC0FFEE + i for i in range(n_keys)]
    addrs = [priv_to_address(k) for k in keys]
    genesis = Genesis(config=CFG, gas_limit=8_000_000,
                      alloc={a: GenesisAccount(balance=10**27)
                             for a in addrs})
    store = StateStore()
    gblock = genesis.to_block(store)
    nonces = [0] * n_keys

    def gen(i, bg):
        for j in range(txs):
            n = i * txs + j
            k = n % n_keys
            if j % 2 == 0:
                # fresh recipient: the account table grows all chain
                to = b"\xf0" + n.to_bytes(4, "big") * 4 + b"\xf0" * 3
            else:
                to = bytes([0x10 + (j % 199)]) * 20
            bg.add_tx(sign_tx(DynamicFeeTx(
                chain_id_=CFG.chain_id, nonce=nonces[k],
                gas_tip_cap_=GWEI, gas_fee_cap_=2000 * GWEI, gas=21_000,
                to=to, value=10**12 + j), keys[k], CFG.chain_id))
            nonces[k] += 1

    blocks, _ = generate_chain(CFG, gblock, store, n_blocks, gen, gap=10)
    return genesis, blocks


def alu_ops(op: str, a: list, b: list, c: list) -> int:
    """32-bit integer operations ``u256x_eval`` does for ``op`` on these
    rows (csrc/u256x.cuh): 24 for add/sub (8 words x add, carry,
    store), 32 for a compare, shift, BYTE or SIGNEXTEND, 144 for MUL
    (36 word products x lo, hi and two adds), 256 for the wide product,
    and 40 per dividend bit for the bit-serial divisions (a 256-bit
    shift, compare and subtract); EXP is one squaring per exponent bit
    plus a multiply per set bit."""
    if op in ("add", "sub"):
        return 24 * len(a)
    if op == "mul":
        return 144 * len(a)
    if op in ("mul_wide_lo", "mul_wide_hi"):
        return 256 * len(a)
    if op in ("div", "mod"):
        return 40 * sum(x.bit_length() for x in a)
    if op in ("sdiv", "smod"):
        return 40 * sum(min(x, (1 << 256) - x).bit_length() for x in a)
    if op == "addmod":
        return 40 * sum((x + y).bit_length() for x, y in zip(a, b))
    if op == "mulmod":
        return sum(256 + 40 * (x * y).bit_length() for x, y in zip(a, b))
    if op == "exp":
        return sum(144 * (y.bit_length() + bin(y).count("1")) for y in b)
    if op == "bit_length":
        return 16 * len(a)
    return 32 * len(a)


# 64-bit operations of one keccak-f[1600] round (theta 55, rho+pi 24,
# chi 75, iota 1), each counted as two 32-bit operations, plus the 17
# lane XORs of absorbing a block
KECCAK_OPS_PER_BLOCK = 2 * (24 * 155 + 17)


# ------------------------------------------------------------ K5 inputs

def machine_lanes(rng, n: int):
    """n ERC-20 ``transfer()`` lanes of the main path's shape, with the
    outcomes the replay meets: the storage cache seeded (both balance
    slots) on even lanes and unseeded (miss rows) on odd ones; every
    16th lane sends more than its balance (REVERT) and every 16th + 6
    gets too little gas (ERR); the last three run INVALID, a stack underflow
    and a memory-cap HOST escape.  Returns (TxSpecs, their committed
    storage resolver)."""
    from coreth_tpu_torch.evm.device.adapter import TxSpec
    from coreth_tpu_torch.workloads.erc20 import (
        TOKEN_RUNTIME, balance_slot, transfer_calldata)
    from coreth_tpu_torch.state import normalize_state_key
    token = bytes([0x77]) * 20
    committed = {}
    txs = []
    for i in range(n):
        sender = (0x1000 + i).to_bytes(2, "big") * 10
        to = (0x3000 + int(rng.integers(0, 4096))).to_bytes(2, "big") * 10
        # the machine reports (and looks up) normalized slot keys
        s_key = normalize_state_key(balance_slot(sender))
        t_key = normalize_state_key(balance_slot(to))
        bal = int(rng.integers(10**6, 10**12))
        committed[s_key] = bal
        committed.setdefault(t_key, int(rng.integers(0, 10**9)))
        amount = bal + 1 if i % 16 == 0 else int(rng.integers(1, 10**6))
        gas = 10_000 if i % 16 == 6 else 100_000
        storage = {}
        if i % 2 == 0:
            storage = {k: (committed[k], committed[k])
                       for k in (s_key, t_key)}
        txs.append(TxSpec(code=TOKEN_RUNTIME,
                          calldata=transfer_calldata(to, amount), gas=gas,
                          value=0, caller=sender, address=token,
                          origin=sender, gas_price=25 * GWEI,
                          storage=storage))
    for k, code in enumerate(("6001fe", "01", "6001620186a05200")):
        txs[n - 1 - k].code = bytes.fromhex(code)
        txs[n - 1 - k].storage = {}

    def resolve(addr, key):
        return committed.get(key, 0)
    return txs, resolve


# ------------------------------------------------------------ machine

TOKEN = bytes([0x77]) * 20


def build_erc20_chain(n_blocks: int, txs: int, n_keys: int):
    """The benchmark's ERC-20 chain (bench.py gen_erc20 and _genesis):
    every third recipient the next key, the rest a rotating pool of
    1999 holders; 100k gas per call, fee cap 2000 gwei."""
    from coreth_tpu_torch.chain import Genesis, GenesisAccount, generate_chain
    from coreth_tpu_torch.crypto.secp256k1 import priv_to_address
    from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import DynamicFeeTx, sign_tx
    from coreth_tpu_torch.workloads.erc20 import (
        token_genesis_account, transfer_calldata)
    token = TOKEN
    keys = [0xC0FFEE + i for i in range(n_keys)]
    addrs = [priv_to_address(k) for k in keys]
    alloc = {a: GenesisAccount(balance=10**27) for a in addrs}
    alloc[token] = token_genesis_account({a: 10**24 for a in addrs})
    genesis = Genesis(config=CFG, gas_limit=8_000_000, alloc=alloc)
    store = StateStore()
    gblock = genesis.to_block(store)
    nonces = [0] * n_keys

    def gen(i, bg):
        for j in range(txs):
            k = (i * txs + j) % n_keys
            if j % 3 == 0:
                to = addrs[(k + 1) % n_keys]
            else:
                to = (0x5000 + (i * 7 + j) % 1999).to_bytes(2, "big") * 10
            bg.add_tx(sign_tx(DynamicFeeTx(
                chain_id_=CFG.chain_id, nonce=nonces[k],
                gas_tip_cap_=GWEI, gas_fee_cap_=2000 * GWEI, gas=100_000,
                to=token, value=0, data=transfer_calldata(to, 10 + j)),
                keys[k], CFG.chain_id))
            nonces[k] += 1

    blocks, _ = generate_chain(CFG, gblock, store, n_blocks, gen, gap=10)
    return genesis, blocks


def bound(n_bytes: int, n_ops: int):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    32-bit integer operations over the int32 rate."""
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = n_ops / H100_INT32_OPS_PER_S
    return 1000 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def phase_k3(dev, rng):
    import torch
    from coreth_tpu_torch.crypto import native
    from coreth_tpu_torch.ops import keccak as K
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 272, 4090)]
    msgs += [rng.bytes(n) for n in (135, 136, 135, 136, 0, 271)]
    blocks, nblocks = K.pack_blocks(msgs)
    b = torch.from_numpy(blocks).to(dev)
    nb = torch.from_numpy(nblocks).to(dev)
    got = K.keccak256_blocks(b, nb)
    want = K.keccak256_blocks_plain(b, nb)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = (got != want).any(dim=1).nonzero()[:5].flatten().tolist()
        raise AssertionError(f"K3 digests differ from the plain version "
                             f"at {bad}")
    if K.digests(got) != [native.keccak256_native(m) for m in msgs]:
        raise AssertionError("K3 digests differ from coreth_keccak256")
    ms = cuda_ms(lambda: K.keccak256_blocks(b, nb))
    plain_ms = once_ms(lambda: K.keccak256_blocks_plain(b, nb))
    n_bytes = blocks.nbytes + nblocks.nbytes + got.numel() * 4
    bound_ms, bound_by = bound(n_bytes,
                               KECCAK_OPS_PER_BLOCK * int(nblocks.sum()))
    k3 = {"name": "keccak256_blocks", "route": "cuda",
          "source": "coreth_tpu_torch/csrc/keccak256_blocks.cu",
          "replaces": "coreth_tpu/ops/keccak.py:186",
          "max_abs_err": max_abs_err([got], [want]), "ms": round(ms, 4),
          "plain_ms": round(plain_ms, 2), "bound_ms": round(bound_ms, 5),
          "bound_by": bound_by, "library_ms": None}
    emit({"phase": "k3", "equal": True, "messages": len(msgs),
          "blocks_absorbed": int(nblocks.sum()), "native_equal": True,
          **k3})
    return k3


def phase_k4(dev, rng):
    import torch
    from coreth_tpu_torch.ops import u256, u256x
    rows = alu_operands(rng, 4096)
    a, b, c = (torch.from_numpy(x).to(dev) for x in rows)
    ints = [u256.to_ints(x) for x in rows]
    errs, ms, plain_ms, n_ops = [], 0.0, 0.0, 0
    for op in u256x.OPS:
        got = u256x.eval_ops(op, a, b, c)
        want = u256x.eval_plain(op, a, b, c)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).any(dim=1).nonzero()[:5].flatten().tolist()
            raise AssertionError(f"K4 {op} differs from the plain version "
                                 f"at rows {bad}")
        errs.append(max_abs_err([got], [want]))
        ms += cuda_ms(lambda: u256x.eval_ops(op, a, b, c), reps=5)
        plain_ms += once_ms(lambda: u256x.eval_plain(op, a, b, c))
        n_ops += alu_ops(op, *ints)
    n_bytes = len(u256x.OPS) * 4 * rows[0].nbytes
    bound_ms, bound_by = bound(n_bytes, n_ops)
    k4 = {"name": "u256x_eval", "route": "cuda",
          "source": "coreth_tpu_torch/csrc/u256x_eval.cu",
          "replaces": "coreth_tpu/ops/u256x.py:30",
          "max_abs_err": max(errs), "ms": round(ms, 4),
          "plain_ms": round(plain_ms, 1), "bound_ms": round(bound_ms, 5),
          "bound_by": bound_by, "library_ms": None}
    emit({"phase": "k4", "equal": True, "rows": int(a.shape[0]),
          "ops": len(u256x.OPS), "int32_ops": n_ops,
          "ms_is": "one launch of every op, summed", **k4})
    return k4


def phase_k5(dev, rng):
    import torch
    from coreth_tpu_torch.evm.device import machine as M
    from coreth_tpu_torch.evm.device.adapter import (
        BlockEnv, MachineRunner, PackedOut)
    from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
    txs, resolve = machine_lanes(rng, 256)
    env = BlockEnv(coinbase=b"\x01" + b"\x00" * 19, timestamp=3000,
                   number=5, gas_limit=15_000_000, chain_id=CFG.chain_id,
                   base_fee=25 * GWEI)
    runner = MachineRunner("durango", env, resolve, device=dev)
    p = runner._params(txs)
    inputs = runner.pack(txs, p)
    packed, steps = M.run_machine(p, inputs)
    plain = M.run_plain(p, inputs)
    torch.cuda.synchronize()
    for what, g, w in (("packed rows", packed, plain["packed"]),
                       ("step counts", steps, plain["steps"])):
        if not torch.equal(g, w):
            bad = (g != w).nonzero()[:5].tolist()
            raise AssertionError(f"K5 {what} differ from the plain version "
                                 f"at {bad}")
    out = PackedOut(packed.cpu().numpy(), p)
    statuses = {int(v): int((out.status == v).sum())
                for v in np.unique(out.status)}
    misses = int(((out.sflag & M.F_MISS) != 0).any(axis=1).sum())
    need = {M.STOP, M.REVERT, M.ERR, M.HOST}
    if not need <= set(statuses) or misses == 0:
        raise AssertionError(f"K5 lanes do not cover the outcomes: "
                             f"{statuses}, {misses} miss rows")
    ms = cuda_ms(lambda: M.run_machine(p, inputs))
    plain_ms = once_ms(lambda: M.run_plain(p, inputs))
    # where the launch's time goes: the same batch with every lane's
    # code a lone STOP runs the wrapper, the lane set-up (arena and row
    # initialisation, storage-cache copy) and one step per lane
    stop = dict(inputs, code=inputs["code"].clone())
    stop["code"][:, 0] = 0
    split = {"stop_ms": cuda_ms(lambda: M.run_machine(p, stop)),
             "kernel_ms": kernel_ms(lambda: M.run_machine(p, inputs),
                                    "step_machine"),
             "stop_kernel_ms": kernel_ms(lambda: M.run_machine(p, stop),
                                         "step_machine")}
    n_bytes = sum(t.numel() * t.element_size() for t in inputs.values()
                  if isinstance(t, torch.Tensor)) \
        + packed.numel() * 4 + steps.numel() * 4
    n_steps = int(steps.sum())
    bound_ms, bound_by = bound(n_bytes, n_steps * M.OPS_PER_STEP)
    k5 = {"name": "step_machine", "route": "cuda",
          "source": "coreth_tpu_torch/csrc/step_machine.cu",
          "replaces": "coreth_tpu/evm/device/machine.py:884",
          "max_abs_err": max_abs_err([packed, steps],
                                     [plain["packed"], plain["steps"]]),
          "ms": round(ms, 4), "plain_ms": round(plain_ms, 1),
          "bound_ms": round(bound_ms, 5), "bound_by": bound_by,
          "library_ms": None}
    emit({"phase": "k5", "equal": True, "batch": p.batch,
          "code_cap": p.code_cap, "scache_cap": p.scache_cap,
          "width": p.width, "statuses": statuses, "miss_rows": misses,
          "lane_steps": n_steps, "max_lane_steps": int(steps.max()),
          **split, **k5})
    return k5


def _zero_launches() -> None:
    from coreth_tpu_torch.evm.device import machine as M
    from coreth_tpu_torch.ops import keccak as K
    from coreth_tpu_torch.ops import secp as S
    from coreth_tpu_torch.ops import u256x
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.replay import shard as SH
    E.LAUNCHES = S.LAUNCHES = M.LAUNCHES = M.OCC_LAUNCHES = 0
    M.SPEC_LAUNCHES = K.LAUNCHES = u256x.LAUNCHES = 0
    SH.LAUNCHES = S.SHARD_LAUNCHES = 0
    M.OCC_SHARDED_LAUNCHES = M.SHARD_FLAGS_LAUNCHES = 0


def _read_launches() -> dict:
    from coreth_tpu_torch.evm.device import machine as M
    from coreth_tpu_torch.ops import keccak as K
    from coreth_tpu_torch.ops import secp as S
    from coreth_tpu_torch.ops import u256x
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.replay import shard as SH
    return {"step_machine": M.LAUNCHES, "occ_window": M.OCC_LAUNCHES,
            "occ_window_spec": M.SPEC_LAUNCHES,
            "secp_recover": S.LAUNCHES, "transfer_window": E.LAUNCHES,
            "keccak256_blocks": K.LAUNCHES, "u256x_eval": u256x.LAUNCHES,
            "sharded_window": SH.LAUNCHES,
            "sharded_recover": S.SHARD_LAUNCHES,
            "occ_sharded": M.OCC_SHARDED_LAUNCHES,
            "shard_flags": M.SHARD_FLAGS_LAUNCHES}


def _timed_folds(pipe, on_first=None) -> list:
    """Wrap a commit pipeline's flush to record (monotonic time, blocks
    folded) for every fold that folds blocks; ``on_first`` is called
    right after the first such fold."""
    folds = []
    flush = pipe.flush

    def timed():
        n = pipe.staged_blocks
        root = flush()
        if n:
            folds.append((time.monotonic(), n))
            if len(folds) == 1 and on_first is not None:
                on_first()
        return root
    pipe.flush = timed
    return folds


class HostSpans:
    """Wall seconds and calls of named host functions of the window
    path, and the garbage collector's pauses, over one replay, with a
    snapshot taken at the first fold (``mark``): what the first window
    spends where.  Each function is wrapped in place for the replay
    (nested functions count in each of their callers too) and restored
    by ``close``."""

    def __init__(self):
        import gc
        from coreth_tpu_torch import kernels
        from coreth_tpu_torch.evm.device import adapter as A
        from coreth_tpu_torch.evm.device import machine as M
        from coreth_tpu_torch.evm.device import shard as SHR
        from coreth_tpu_torch.evm.device import specialize as SP
        from coreth_tpu_torch.replay import engine as E
        from coreth_tpu_torch.replay import machine_block as MB
        targets = [(MB.MachineBlockExecutor, n) for n in
                   ("classify", "_window_items", "_finish_block", "execute")]
        targets += [(A.MachineWindowRunner, n) for n in
                    ("pack", "issue", "complete", "_premaps", "_spec_id")]
        targets += [(SHR.ShardedWindowRunner, n) for n in
                    ("pack", "issue", "poll_clean", "can_pipeline",
                     "_placements")]
        targets += [(M, "run_occ_sharded"), (M, "shard_flags")]
        targets += [(A, "fill_kdig"), (M, "run_occ_window"),
                    (SP, "occ_library"), (SP, "trace_eligible"),
                    (SP, "spec_requests"), (kernels, "load"),
                    (E.ReplayEngine, "_classify"),
                    (E.ReplayEngine, "warm_senders")]
        self.tot, self.first, self._undo = {}, None, []
        for owner, attr in targets:
            fn = getattr(owner, attr)
            label = f"{getattr(owner, '__name__', '?').split('.')[-1]}." \
                f"{attr}"
            setattr(owner, attr, self._wrap(fn, label))
            self._undo.append((owner, attr, fn))
        self._gc_t0 = 0.0
        self._gc = gc
        gc.callbacks.append(self._on_gc)

    def _wrap(self, fn, label):
        tot = self.tot

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                s = tot.setdefault(label, [0.0, 0])
                s[0] += time.perf_counter() - t0
                s[1] += 1
        return timed

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            s = self.tot.setdefault(f"gc.gen{info['generation']}", [0.0, 0])
            s[0] += time.perf_counter() - self._gc_t0
            s[1] += 1

    def mark(self) -> None:
        self.first = {k: list(v) for k, v in self.tot.items()}

    def close(self) -> None:
        for owner, attr, fn in self._undo:
            setattr(owner, attr, fn)
        self._gc.callbacks.remove(self._on_gc)

    def row(self) -> dict:
        def fmt(d):
            return {k: [round(v[0], 4), v[1]] for k, v in sorted(d.items())}
        return {"first_window": fmt(self.first or {}),
                "whole_replay": fmt(self.tot)}


def _steady(folds, t0: float, txs: int) -> dict:
    """The first fold's time from ``t0`` (the first window's discovery
    re-launches on the window path), and txs/s after it: the blocks
    folded later over the time from the first fold to the last."""
    (t_first, n_first), t_last = folds[0], folds[-1][0]
    later = sum(n for _t, n in folds[1:])
    return {"folds": len(folds), "first_fold_blocks": n_first,
            "first_fold_s": round(t_first - t0, 4),
            "steady_txs_per_s": round(later * txs / (t_last - t_first), 1)
            if later else None}


def _replay_erc20(dev, genesis, blocks, txs: int, device_occ: bool,
                  specialize: bool = False, mesh=None, shard_occ=True):
    """Replay the ERC-20 chain from fresh decodes (no cached senders),
    the launch counters zeroed just before and read just after; returns
    the engine, the root, the replay's seconds, the launches and the
    steady-state split of ``_steady`` (on the window path with the host
    spans of ``HostSpans``)."""
    import torch
    from coreth_tpu_torch.evm.device import adapter as A
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    fresh = [Block.decode(b.encode()) for b in blocks]
    store = StateStore()
    gblock = genesis.to_block(store)
    eng = E.ReplayEngine(genesis.config, store, parent_header=gblock.header,
                         batch_pad=txs, window=16, device=dev,
                         device_occ=device_occ, specialize=specialize,
                         mesh=mesh, shard_occ=shard_occ)
    A.RECIPES.clear()      # learned premaps start empty: discovery counts
    spans = HostSpans() if device_occ else None
    folds = _timed_folds(eng.commit_pipe, spans and spans.mark)
    _zero_launches()
    t0 = time.monotonic()
    try:
        root = eng.replay(fresh)
        torch.cuda.synchronize()
    finally:
        if spans is not None:
            spans.close()
    dt = time.monotonic() - t0
    launches = _read_launches()
    eng.close()
    steady = _steady(folds, t0, txs)
    if spans is not None:
        steady["host_spans"] = spans.row()
    return eng, root, dt, launches, steady


def phase_machine(dev, smi, genesis, blocks, t_build: float, txs: int,
                  n_keys: int):
    n_blocks = len(blocks)
    eng, root, dt, launches, steady = _replay_erc20(
        dev, genesis, blocks, txs, device_occ=False)
    mc = eng.machine_counters()
    if root != blocks[-1].header.root:
        raise AssertionError("machine path: final root differs from the "
                             "header")
    if mc["blocks"] != n_blocks:
        raise AssertionError(f"machine path: {mc['blocks']} of {n_blocks} "
                             "blocks on the machine path")
    if mc["rounds"] < 1:
        raise AssertionError("machine path: no OCC round was exercised")
    if launches["step_machine"] < 1 or launches["occ_window"] != 0:
        raise AssertionError(f"machine path: the step machine never "
                             f"launched, or K6 did: {launches}")
    emit({"phase": "machine", "blocks": n_blocks, "txs_per_block": txs,
          "keys": n_keys, "chain_build_s": round(t_build, 2),
          "replay_s": round(dt, 4),
          "txs_per_s": round(n_blocks * txs / dt, 1), **steady,
          "root_matches_header": True, "launches": launches,
          "k5_launches_per_block": launches["step_machine"] / n_blocks,
          "machine": mc, "stats": eng.stats.row(), "card": smi})
    return launches


# ------------------------------------------------------------ K7 inputs

def _push(v: int) -> str:
    raw = v.to_bytes((max(v.bit_length(), 1) + 7) // 8, "big")
    return f"{0x5F + len(raw):02x}" + raw.hex()


def _keccak_fan_code() -> bytes:
    """The sum of ten keccak(caller || k) stored at slot 0 — ten
    host-evaluable requests, two more than KDIG_CAP, so the last two run
    on the device — then keccak(calldata word 0 + 1) (an arithmetic
    result: a device keccak) stored at slot 1 and logged as LOG1's topic
    over that word."""
    code = _push(0)
    for k in range(10):
        code += "33" + _push(0) + "52" + _push(k) + _push(32) + "52"
        code += _push(64) + _push(0) + "20" + "01"
    code += _push(0) + "55"
    code += _push(1) + _push(4) + "35" + "01" + _push(0) + "52"
    code += _push(32) + _push(0) + "20" + "80" + _push(1) + "55"
    code += _push(32) + _push(0) + "a1" + "00"
    return bytes.fromhex(code)


def _slot_fan_code(n: int = 40) -> bytes:
    """SSTOREs of 1 to ``n`` slots computed from calldata word 0 (no
    static premap): every one a fresh cache entry, so the lane escapes
    HOST (R_SCACHE) once its storage cache is full."""
    code = "".join(_push(1) + _push(k) + _push(4) + "35" + "01" + "55"
                   for k in range(n))
    return bytes.fromhex(code + "00")


KECCAK_FAN_CODE = _keccak_fan_code()
SLOT_FAN_CODE = _slot_fan_code()
# PUSH1 0; CALLDATALOAD; JUMP; JUMPDEST; STOP: a computed jump, so the
# tracer rejects it and its lanes stay on the interpreter
JUMPER_CODE = bytes.fromhex("600035565b00")


# ------------------------------------------------------------ K6 inputs

def _block_env(i: int):
    from coreth_tpu_torch.evm.device.adapter import BlockEnv
    from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
    return BlockEnv(coinbase=bytes([0x01 + i]) + b"\x00" * 19,
                    timestamp=3000 + 10 * i, number=5 + i,
                    gas_limit=15_000_000, chain_id=CFG.chain_id,
                    base_fee=25 * GWEI + i)


def window_from_chain(dev, genesis, blocks, specialize: bool = False):
    """K6 window (a): the chain's first 8 blocks as a window runner
    packs them, with the premaps learned from one discovery pass of
    generic K6 over them; with ``specialize`` the packing runner gives
    the token lanes their traced program (K7 window (a))."""
    from coreth_tpu_torch.evm.device.adapter import MachineWindowRunner
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    store = StateStore()
    gblock = genesis.to_block(store)
    fresh = [Block.decode(b.encode()) for b in blocks[:8]]
    eng = E.ReplayEngine(genesis.config, store, parent_header=gblock.header,
                         batch_pad=256, device=dev, specialize=False)
    eng.warm_senders(fresh)
    mx = eng._machine_executor()
    items = mx._window_items([(b, mx.classify(b)) for b in fresh])
    runner = mx._window_runner()
    runner.complete(runner.issue(items))
    # the learned premaps are process-wide (adapter.RECIPES): a fresh
    # runner over the same (still genesis) state packs with them
    runner = MachineWindowRunner(runner.fork, mx._base_value, device=dev,
                                 specialize=specialize)
    runner.seed_window_hint(8)
    pk = runner.pack(items)
    eng.close()
    return pk


def swap_window(dev, n_blocks: int = 2, lanes: int = 8,
                specialize: bool = False):
    """K6 window (b): blocks of swaps into one pool, every pair in
    conflict through the two reserve slots."""
    from coreth_tpu_torch.evm.device.adapter import (
        MachineWindowRunner, TxSpec)
    from coreth_tpu_torch.workloads.swap import POOL_RUNTIME, swap_calldata
    pool = b"\x74" * 20
    reserves = {(0).to_bytes(32, "big"): 10**15,
                (1).to_bytes(32, "big"): 10**15}
    runner = MachineWindowRunner("durango",
                                 lambda a, k: reserves.get(k, 0),
                                 device=dev, specialize=specialize)
    items = []
    for i in range(n_blocks):
        specs = []
        for j in range(lanes):
            caller = (0x6000 + 64 * i + j).to_bytes(2, "big") * 10
            specs.append(TxSpec(
                code=POOL_RUNTIME, calldata=swap_calldata(1000 + 17 * j + i),
                gas=200_000, value=0, caller=caller, address=pool,
                origin=caller, gas_price=25 * GWEI))
        items.append((_block_env(i), specs))
    return runner.pack(items)


def escape_window(dev, rng, lanes: int = 16):
    """K6 window (c): three blocks of ERC-20 transfers (both balance
    slots premapped; every fourth lane pays the next lane's sender, the
    rest fresh holders) in an 8-block window; in block 0 lane 5 escapes
    HOST (memory past mem_cap) and lane 9 has no premap (an F_MISS
    escape), so blocks 1 and 2 run on a speculative table, and blocks
    3-7 are inactive."""
    from coreth_tpu_torch.evm.device.adapter import (
        RECIPES, MachineWindowRunner, TxSpec)
    from coreth_tpu_torch.state import normalize_state_key
    from coreth_tpu_torch.workloads.erc20 import (
        TOKEN_RUNTIME, balance_slot, transfer_calldata)
    RECIPES.clear()       # no learned prediction premaps lane 9's keys
    committed = {}
    items = []
    for i in range(3):
        specs = []
        for j in range(lanes):
            sender = (0x7000 + j).to_bytes(2, "big") * 10
            to = (0x7000 + j + 1 if j % 4 == 0
                  else 0x7100 + 16 * i + j).to_bytes(2, "big") * 10
            keys = [normalize_state_key(balance_slot(a))
                    for a in (sender, to)]
            for k in keys:
                committed.setdefault(k, int(rng.integers(10**6, 10**9)))
            t = TxSpec(code=TOKEN_RUNTIME,
                       calldata=transfer_calldata(to, 10 + j), gas=100_000,
                       value=0, caller=sender, address=TOKEN, origin=sender,
                       gas_price=25 * GWEI,
                       storage={k: (0, 0) for k in keys})
            if i == 0 and j == 5:
                t.code, t.calldata = bytes.fromhex("600061138852" + "00"), b""
            if i == 0 and j == 9:
                t.storage = {}
            specs.append(t)
        items.append((_block_env(i), specs))
    runner = MachineWindowRunner("durango",
                                 lambda a, k: committed.get(k, 0),
                                 device=dev, specialize=False)
    runner.seed_window_hint(8)
    return runner.pack(items)


def _token_lane(rng, committed, sender, to, amount, gas=100_000):
    """An ERC-20 transfer() TxSpec with both balance slots premapped
    (their committed balances drawn once)."""
    from coreth_tpu_torch.evm.device.adapter import TxSpec
    from coreth_tpu_torch.state import normalize_state_key
    from coreth_tpu_torch.workloads.erc20 import (
        TOKEN_RUNTIME, balance_slot, transfer_calldata)
    keys = [normalize_state_key(balance_slot(a)) for a in (sender, to)]
    for k in keys:
        committed.setdefault((TOKEN, k), int(rng.integers(10**6, 10**9)))
    return TxSpec(code=TOKEN_RUNTIME, calldata=transfer_calldata(to, amount),
                  gas=gas, value=0, caller=sender, address=TOKEN,
                  origin=sender, gas_price=25 * GWEI,
                  storage={k: (0, 0) for k in keys})


def _call_lane(code, data, gas, address, caller):
    from coreth_tpu_torch.evm.device.adapter import TxSpec
    return TxSpec(code=code, calldata=data, gas=gas, value=0,
                  caller=caller, address=address, origin=caller,
                  gas_price=25 * GWEI)


def _spec_runner(dev, committed):
    from coreth_tpu_torch.evm.device.adapter import MachineWindowRunner
    runner = MachineWindowRunner(
        "durango", lambda a, k: committed.get((a, k), 0), device=dev)
    runner.seed_window_hint(8)
    return runner


def mixed_window(dev, rng, lanes: int = 16):
    """K7 window (c): two blocks of 16 lanes mixing token transfers, one
    transfer whose amount exceeds the balance (the traced REVERT leaf),
    swaps into one pool, and lanes of a computed-jump contract (trace-
    ineligible: K5's interpreter in the same window)."""
    from coreth_tpu_torch.workloads.swap import POOL_RUNTIME, swap_calldata
    pool, jumper = b"\x74" * 20, b"\x79" * 20
    committed = {(pool, (0).to_bytes(32, "big")): 10**15,
                 (pool, (1).to_bytes(32, "big")): 10**15}
    items = []
    for i in range(2):
        specs = []
        for j in range(lanes):
            who = (0x7400 + 32 * i + j).to_bytes(2, "big") * 10
            to = (0x7500 + 32 * i + j).to_bytes(2, "big") * 10
            kind = j % 8
            if kind in (1, 6):
                specs.append(_call_lane(POOL_RUNTIME,
                                        swap_calldata(1000 + 7 * j + i),
                                        200_000, pool, who))
            elif kind == 7:
                specs.append(_call_lane(JUMPER_CODE,
                                        (4).to_bytes(32, "big"), 50_000,
                                        jumper, who))
            else:
                amount = 10**12 if kind == 3 else 10 + j
                specs.append(_token_lane(rng, committed, who, to, amount))
        items.append((_block_env(i), specs))
    return _spec_runner(dev, committed).pack(items)


def keccak_fan_window(dev, rng, lanes: int = 16):
    """K7 window (d): one block of the keccak fan (ten host-evaluable
    keccaks, two past the kdig slots, and a device keccak of an
    arithmetic result); every lane writes the same two slots, so the
    block converges one lane per round."""
    fan = b"\x7b" * 20
    specs = [_call_lane(KECCAK_FAN_CODE,
                        int(rng.integers(0, 1 << 62)).to_bytes(32, "big"),
                        200_000, fan,
                        (0x7600 + j).to_bytes(2, "big") * 10)
             for j in range(lanes)]
    return _spec_runner(dev, {}).pack([(_block_env(0), specs)])


def escape_lanes_window(dev, rng, lanes: int = 8):
    """K7 window (e): one block with slot-fan lanes (their storage cache
    fills: HOST, R_SCACHE) and token transfers out of gas at the first
    lumped flush (40 gas), between ordinary transfers."""
    fan = b"\x7c" * 20
    committed = {}
    specs = []
    for j in range(lanes):
        who = (0x7700 + j).to_bytes(2, "big") * 10
        to = (0x7780 + j).to_bytes(2, "big") * 10
        if j in (1, 5):
            specs.append(_call_lane(SLOT_FAN_CODE,
                                    (1000 * j).to_bytes(32, "big"),
                                    1_000_000, fan, who))
        else:
            specs.append(_token_lane(rng, committed, who, to, 10 + j,
                                     gas=40 if j in (2, 6) else 100_000))
    return _spec_runner(dev, committed).pack([(_block_env(0), specs)])


def phase_k6(dev, genesis, blocks):
    import torch
    from coreth_tpu_torch.evm.device import machine as M
    rng = np.random.default_rng(SEED + 6)
    windows = {"a_erc20_chain": window_from_chain(dev, genesis, blocks),
               "b_swap_conflict": swap_window(dev),
               "c_escape_trailing": escape_window(dev, rng)}
    rows, k6 = {}, None
    for name, pk in windows.items():
        p, occ = pk["p"], pk["occ"]
        args = (p, occ, pk["table"], pk["key_tab"], pk["inputs"])
        got = M.run_occ_window(*args)
        t0 = time.perf_counter()
        want = M.occ_run_plain(*args)
        torch.cuda.synchronize()
        plain_ms = 1000 * (time.perf_counter() - t0)
        for k in ("table", "packed", "steps"):
            if not torch.equal(got[k], want[k]):
                bad = (got[k] != want[k]).nonzero()[:5].tolist()
                raise AssertionError(f"K6 {name} {k} differs from the "
                                     f"plain version at {bad}")
        err = max_abs_err([got[k] for k in ("table", "packed", "steps")],
                          [want[k] for k in ("table", "packed", "steps")])
        ms = cuda_ms(lambda: M.run_occ_window(*args), reps=5, warmup=1)
        dev_ms = kernel_ms(lambda: M.run_occ_window(*args), "occ_window",
                           reps=5)
        extra = got["packed"][:, :, -4:].cpu().numpy()
        bound_ms, bound_by, lane_steps, rounds = _window_bound(pk, got)
        n_active = int(pk["inputs"]["active"].sum())
        if name == "b_swap_conflict" and rounds[:2] != [8, 8]:
            raise AssertionError(f"K6 swap window rounds {rounds}")
        if name == "c_escape_trailing" and (
                extra[0, :, 1].sum() != 2 or any(rounds[3:])):
            raise AssertionError(f"K6 escape window: escapes "
                                 f"{extra[0, :, 1].sum()}, rounds {rounds}")
        rows[name] = {"blocks": occ.blocks, "batch": p.batch,
                      "scache_cap": p.scache_cap, "table_cap": occ.table_cap,
                      "active_lanes": n_active, "rounds": rounds,
                      "committed": int(extra[..., 0].sum()),
                      "escaped": int(extra[..., 1].sum()),
                      "pending": int(extra[..., 2].sum()),
                      "lane_steps": lane_steps, "max_abs_err": err,
                      "ms": round(ms, 4), "device_ms": dev_ms,
                      "plain_ms": round(plain_ms, 1),
                      "bound_ms": round(bound_ms, 5), "bound_by": bound_by}
        if k6 is None:
            k6 = {"name": "occ_window", "route": "cuda",
                  "source": "coreth_tpu_torch/csrc/occ_window.cu",
                  "replaces": "coreth_tpu/evm/device/machine.py:948",
                  "max_abs_err": err, "ms": round(ms, 4),
                  "plain_ms": round(plain_ms, 1),
                  "bound_ms": round(bound_ms, 5), "bound_by": bound_by,
                  "library_ms": None}
    k6["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    emit({"phase": "k6", "equal": True, "windows": rows,
          "ms_is": "window (a), CUDA events around the wrapper", **k6})
    return k6


def phase_window(dev, smi, genesis, blocks, txs: int, specialize: bool,
                 order: int):
    """The ERC-20 chain through the window path: without K7 (phase
    window) or with it (phase spec, the reference's default machine
    configuration; its variant was built by phase k7).  ``order`` is the
    run's place in the window/spec A/B."""
    from coreth_tpu_torch import kernels
    n_blocks = len(blocks)
    name = "spec" if specialize else "window"
    built = dict(kernels.BUILD_SECONDS)
    eng, root, dt, launches, steady = _replay_erc20(
        dev, genesis, blocks, txs, device_occ=True, specialize=specialize)
    mc = eng.machine_counters()
    if root != blocks[-1].header.root:
        raise AssertionError(f"{name} path: final root differs from the "
                             "header")
    if mc["blocks"] != n_blocks or mc["dirty_blocks"] != 0:
        raise AssertionError(f"{name} path: {mc['blocks']} of {n_blocks} "
                             f"blocks, {mc['dirty_blocks']} dirty")
    if launches["occ_window"] < mc["windows"] or mc["windows"] < 1 \
            or launches["step_machine"] != 0:
        raise AssertionError(f"{name} path: K6 launches "
                             f"{launches['occ_window']} for {mc['windows']} "
                             f"windows, K5 {launches['step_machine']}")
    if specialize:
        if mc["lanes_specialized"] != n_blocks * txs \
                or mc["specialize_escapes"] != 0 \
                or mc["programs_traced"] != 1:
            raise AssertionError(f"spec path counters: {mc}")
        if launches["occ_window_spec"] != launches["occ_window"]:
            raise AssertionError(f"spec path launches: {launches}")
    elif launches["occ_window_spec"] != 0 or mc["lanes_specialized"] != 0:
        raise AssertionError("window path without specialisation ran "
                             f"traced lanes: {launches}")
    if kernels.BUILD_SECONDS != built:
        raise AssertionError(f"{name} path: a kernel was built inside the "
                             "timed replay")
    emit({"phase": name, "order": order, "blocks": n_blocks,
          "txs_per_block": txs, "replay_s": round(dt, 4),
          "txs_per_s": round(n_blocks * txs / dt, 1), **steady,
          "root_matches_header": True, "launches": launches,
          "k6_launches_per_block": launches["occ_window"] / n_blocks,
          "machine": mc, "stats": eng.stats.row(), "card": smi})
    return launches, steady


def _window_bound(pk, got, n: int = 1):
    """(bound_ms, bound_by, lane_steps, rounds) of one window launch; with
    ``n`` shards (K9) over the union of the shards' lanes and arenas.

    Bytes: what this window's lanes need moved.  An inactive lane reads
    only its ``active`` flag.  An active lane reads its scalar and word
    inputs, its storage-cache row of table ids and its calldata up to
    ``data_len``; on the interpreter (prog_id -1) also its code and
    jump-table rows up to ``code_len``; on a traced program instead its
    program's kdig slots (the generated code reads no bytecode).  Then
    the block inputs, the table read and written whole (the output is a
    full copy), the key-table rows the lanes reference, and the packed
    rows and step counts written.  Operations: the interpreted lanes'
    steps x ``OPS_PER_STEP`` and the sweeps' entries x
    ``OPS_PER_SWEEP_ENTRY`` (each shard's sweep walks its B lanes each
    round of its own); a traced lane's steps are left out (its ALU work
    is not counted, which can only lower the bound).  ``rounds``: per
    block, the largest of the shards'."""
    from coreth_tpu_torch.evm.device import machine as M
    from coreth_tpu_torch.evm.device import specialize as SP
    p, occ, inp = pk["p"], pk["occ"], pk["inputs"]
    W, B, G = occ.blocks, p.batch, occ.table_cap
    extra = got["packed"][:, :, -4:].cpu().numpy()
    shard_rounds = extra[:, ::B, 3]                            # (W, n)
    rounds = shard_rounds.max(axis=1).tolist()
    host = {k: inp[k].cpu().numpy() for k in
            ("active", "prog_id", "code_len", "data_len", "sgid")}
    act = host["active"].astype(bool)
    pid = np.where(act, host["prog_id"], -2)
    traced, interp = pid >= 0, pid == -1
    n_req = np.array([len(SP.spec_requests(prog.code, prog.fork))
                      for prog in pk["spec"]] + [0], dtype=np.int64)
    n_bytes = 0
    for k, t in inp.items():
        if k not in M._OCC_LANE_INPUTS:
            n_bytes += t.numel() * t.element_size()      # block inputs
            continue
        es = t.element_size()
        per_lane = t[0, 0].numel() * es
        if k == "active":
            n_bytes += W * n * B * per_lane
        elif k in ("code", "jdest"):
            n_bytes += int(host["code_len"][interp].sum()) * es
        elif k == "code_len":
            n_bytes += int(interp.sum()) * per_lane
        elif k == "calldata":
            n_bytes += int(host["data_len"][act].sum()) * es
        elif k == "kdig":
            n_bytes += int(n_req[pid[traced]].sum()) * M.LIMBS * es
        else:
            n_bytes += int(act.sum()) * per_lane
    # the key-table rows the lanes reference, each shard in its arena
    shard = np.broadcast_to((np.arange(n * B) // B)[None, :, None],
                            host["sgid"].shape)
    gids, shards = host["sgid"][act], shard[act]
    rows = (shards * G + gids)[gids < G]
    n_bytes += 2 * pk["table"].numel() * 4 \
        + np.unique(rows).size * M.LIMBS * 4 \
        + got["packed"].numel() * 4 + got["steps"].numel() * 4
    steps = got["steps"].cpu().numpy()
    lane_steps = int(steps.sum())
    sweep_ops = int(shard_rounds.sum()) * B * p.scache_cap \
        * M.OPS_PER_SWEEP_ENTRY
    bound_ms, bound_by = bound(
        n_bytes, int(steps[interp].sum()) * M.OPS_PER_STEP + sweep_ops)
    return bound_ms, bound_by, lane_steps, rounds


def _kernel_ptxas(path: str):
    """The ``-Xptxas -v`` lines of a K6 library's kernel entry: its
    stack frame and spills, and its registers."""
    out, take = [], False
    with open(path) as f:
        for ln in f:
            if take or "registers" in ln:
                out.append(ln.strip())
            take = "Function properties for" in ln \
                and "occ_window_kernel" in ln
    return out


def phase_k7(dev, genesis, blocks):
    """K6+K7 (the specialised variants) against the plain version with
    the same plain programs, tolerance 0, on five windows; window (a)
    also through the generic library with every prog_id -1."""
    import torch
    from coreth_tpu_torch import kernels
    from coreth_tpu_torch.evm.device import machine as M
    from coreth_tpu_torch.evm.device import specialize as SP
    rng = np.random.default_rng(SEED + 7)
    windows = {"a_erc20_chain": window_from_chain(dev, genesis, blocks,
                                                  specialize=True),
               "b_swap_conflict": swap_window(dev, specialize=True),
               "c_mixed": mixed_window(dev, rng),
               "d_keccak_fan": keccak_fan_window(dev, rng),
               "e_escapes": escape_lanes_window(dev, rng)}
    sets = {name: pk["spec"] for name, pk in windows.items()}
    t0 = time.monotonic()
    took = kernels.build_generated(dict(SP.variant(s)
                                        for s in set(sets.values())))
    build_s = time.monotonic() - t0
    variants = {name: SP.variant(spec)[0] for name, spec in sets.items()}
    ptxas = {v: _kernel_ptxas(kernels.log_path(v))
             for v in set(variants.values())}
    rows, k7 = {}, None
    for name, pk in windows.items():
        spec = pk["spec"]
        args = (pk["p"], pk["occ"], pk["table"], pk["key_tab"], pk["inputs"])
        got = M.run_occ_window(*args, spec)
        t0 = time.perf_counter()
        want = M.occ_run_plain(*args, spec)
        torch.cuda.synchronize()
        plain_ms = 1000 * (time.perf_counter() - t0)
        for k in ("table", "packed", "steps"):
            if not torch.equal(got[k], want[k]):
                bad = (got[k] != want[k]).nonzero()[:5].tolist()
                raise AssertionError(f"K7 {name} {k} differs from the "
                                     f"plain version at {bad}")
        err = max_abs_err([got[k] for k in ("table", "packed", "steps")],
                          [want[k] for k in ("table", "packed", "steps")])
        ms = cuda_ms(lambda: M.run_occ_window(*args, spec), reps=5, warmup=1)
        dev_ms = kernel_ms(lambda: M.run_occ_window(*args, spec),
                           "occ_window", reps=5)
        bound_ms, bound_by, lane_steps, rounds = _window_bound(pk, got)
        prog = pk["inputs"]["prog_id"][pk["inputs"]["active"].bool()]
        extra = got["packed"][:, :, -4:].cpu().numpy()
        status = got["packed"][:, :, 0][pk["inputs"]["active"].bool()]
        row = {"blocks": pk["occ"].blocks, "batch": pk["p"].batch,
               "scache_cap": pk["p"].scache_cap,
               "programs": len(spec), "variant": variants[name],
               "traced_lanes": int((prog >= 0).sum()),
               "generic_lanes": int((prog < 0).sum()),
               "statuses": {int(k): int(v) for k, v in zip(
                   *np.unique(status.cpu().numpy(), return_counts=True))},
               "rounds": rounds, "committed": int(extra[..., 0].sum()),
               "escaped": int(extra[..., 1].sum()),
               "lane_steps": lane_steps, "max_abs_err": err,
               "ms": round(ms, 4), "device_ms": dev_ms,
               "plain_ms": round(plain_ms, 1),
               "bound_ms": round(bound_ms, 5), "bound_by": bound_by}
        if name == "a_erc20_chain":
            # the same inputs through generic K6: every lane interpreted
            gen_in = dict(pk["inputs"], prog_id=torch.full_like(
                pk["inputs"]["prog_id"], -1))
            gargs = args[:4] + (gen_in,)
            gen = M.run_occ_window(*gargs)
            for k in ("table", "packed"):
                if not torch.equal(gen[k], got[k]):
                    raise AssertionError(f"K7 window (a): generic K6 {k} "
                                         "differs from K6+K7")
            row["generic_ms"] = round(cuda_ms(
                lambda: M.run_occ_window(*gargs), reps=5, warmup=1), 4)
            row["generic_device_ms"] = kernel_ms(
                lambda: M.run_occ_window(*gargs), "occ_window", reps=5)
            row["generic_lane_steps"] = int(gen["steps"].sum())
            k7 = {"name": "occ_window_spec", "route": "cuda",
                  "source": "coreth_tpu_torch/evm/device/specialize.py",
                  "replaces": "coreth_tpu/evm/device/specialize.py:1152",
                  "max_abs_err": err, "ms": round(ms, 4),
                  "plain_ms": round(plain_ms, 1),
                  "bound_ms": round(bound_ms, 5), "bound_by": bound_by,
                  "library_ms": None}
        if name == "c_mixed" and row["generic_lanes"] == 0:
            raise AssertionError("K7 mixed window has no generic lane")
        if name == "e_escapes" and (M.HOST not in row["statuses"]
                                    or M.ERR not in row["statuses"]):
            raise AssertionError(f"K7 escape window: {row['statuses']}")
        rows[name] = row
    k7["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    emit({"phase": "k7", "equal": True, "windows": rows,
          "variant_build_s": round(build_s, 3), "nvcc_seconds": took,
          "ptxas": ptxas,
          "ptxas_generic": _kernel_ptxas(kernels.log_path("occ_window")),
          "ms_is": "window (a), CUDA events around the wrapper", **k7})
    return k7


# ------------------------------------------------------------ K8, K8r

SHARD_WIDTHS = (2, 4, 8)
# the width whose numbers stand in the kernels line
HEADLINE_WIDTH = 4


def exchange_bytes(n: int, K: int, L: int, SL: int) -> int:
    """Bytes a sharded window's reduces carry in the reference: every
    shard's contribution to the gather's replicating reduce (L x 17 and
    SL x 16 words) and, per block, to the packed effect reduce (L x 49
    and SL x 32 words and the nonce flag)."""
    gather = L * 17 + SL * 16
    per_block = L * 49 + SL * 32 + 1
    return 4 * n * (gather + K * per_block)


def phase_k8(dev, win, k1, k1_fetches):
    """K8 against its plain version on phase k1's window (128 blocks x
    128 lanes, 16,384 window locals; the rows lie uniformly over the
    table, so every shard owns about 1/n of them), at every width in
    both modes: tables, fetches and each shard's working set equal
    (tolerance 0), and the n working sets equal.  Times beside K1's on
    the same window, un-sharded; the bound is K1's (the same function:
    on one card no exchange is necessary work)."""
    import torch
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.replay import shard as SH
    args = [torch.from_numpy(a).to(dev) for a in win]
    K, pad = win[5].shape[:2]
    L, SL = win[3].shape[0], win[4].shape[0]
    k1_ms = cuda_ms(lambda: E._transfer_window(*args))
    rows, k8 = {}, None
    for n in SHARD_WIDTHS:
        perm = torch.from_numpy(SH.interleave_txs(pad, n)).to(dev)
        sargs = args[:5] + [args[5][:, perm].contiguous()] + args[6:]
        for mode in ("psum", "ppermute"):
            got = SH.sharded_transfer_window(*sargs, n=n, mode=mode,
                                             return_replicas=True)
            t0 = time.perf_counter()
            want = SH._sharded_window_plain(*sargs, n, mode,
                                            return_replicas=True)
            torch.cuda.synchronize()
            plain_ms = 1000 * (time.perf_counter() - t0)
            for g, w, what in zip(got[:4] + got[4], want[:4] + want[4],
                                  ("balances", "nonces", "slot_vals",
                                   "fetches", "replica balances",
                                   "replica nonces", "replica slots")):
                if not torch.equal(g, w):
                    bad = (g != w).nonzero()[:5].tolist()
                    raise AssertionError(f"K8 n={n} {mode}: {what} differ "
                                         f"from the plain version at {bad}")
            for g in got[4]:
                if not torch.equal(g, g[:1].expand_as(g)):
                    raise AssertionError(f"K8 n={n} {mode}: the shards' "
                                         "working sets differ")
            if not torch.equal(got[3], k1_fetches):
                raise AssertionError(f"K8 n={n} {mode}: fetches differ from "
                                     "K1's")
            err = max_abs_err(got[:4] + got[4], want[:4] + want[4])
            ms = cuda_ms(lambda: SH.sharded_transfer_window(
                *sargs, n=n, mode=mode))
            row = {"ms": round(ms, 4), "plain_ms": round(plain_ms, 1),
                   "max_abs_err": err,
                   "exchange_bytes": exchange_bytes(n, K, L, SL)}
            rows[f"n{n}_{mode}"] = row
            if n == HEADLINE_WIDTH and mode == "psum":
                k8 = {"name": "sharded_window", "route": "cuda",
                      "source": "coreth_tpu_torch/csrc/sharded_window.cu",
                      "replaces": "coreth_tpu/replay/shard.py:85",
                      "max_abs_err": err, "ms": round(ms, 4),
                      "plain_ms": round(plain_ms, 1),
                      "bound_ms": k1["bound_ms"],
                      "bound_by": k1["bound_by"], "library_ms": None}
    k8["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    emit({"phase": "k8", "equal": True, "K": K, "pad": pad, "L": L,
          "SL": SL, "k1_ms_same_window": round(k1_ms, 4), "widths": rows,
          "ms_is": f"n={HEADLINE_WIDTH}, psum, CUDA events around the "
          "wrapper", "bound_is": "K1's on the same window", **k8})
    return k8


def phase_k8r(dev, dargs, k2):
    """K8r (K2 on each of n slices, each on its own stream) against K2
    on phase k2's 4096 signatures at every width: rows equal
    (tolerance 0).  The plain version (the plain ladder per slice) is
    timed at the headline width; the bound is K2's (the same work)."""
    import torch
    from coreth_tpu_torch.ops import secp as S
    from coreth_tpu_torch.parallel import make_mesh
    want = S.recover_kernel(*dargs)
    rows, k8r = {}, None
    for n in SHARD_WIDTHS:
        fn = S.sharded_recover(make_mesh(n))
        got = fn(*dargs)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).any(dim=1).nonzero()[:5].flatten().tolist()
            raise AssertionError(f"K8r n={n} rows differ from K2's at {bad}")
        rows[f"n{n}"] = {"ms": round(cuda_ms(lambda: fn(*dargs)), 4)}
        if n == HEADLINE_WIDTH:
            plain_ms = once_ms(lambda: S.sharded_recover_plain(*dargs, n))
            k8r = {"name": "sharded_recover", "route": "cuda",
                   "source": "coreth_tpu_torch/ops/secp.py (K2's "
                   "csrc/secp_recover.cu per shard)",
                   "replaces": "coreth_tpu/parallel/mesh.py:202",
                   "max_abs_err": max_abs_err([got], [want]),
                   "ms": rows[f"n{n}"]["ms"], "plain_ms": round(plain_ms, 1),
                   "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
                   "library_ms": None}
    emit({"phase": "k8r", "equal": True, "rows": int(dargs[0].shape[0]),
          "k2_ms": k2["ms"], "widths": rows,
          "ms_is": f"n={HEADLINE_WIDTH}, CUDA events around the wrapper",
          "bound_is": "K2's on the same batch", **k8r})
    return k8r


def phase_shard(dev, smi, genesis, wire, txs: int, capacity: int):
    """The main path's transfer chain through ``ReplayEngine(mesh=
    make_mesh(n))`` at every width, from fresh decodes, the first block
    alone before the timed replay as in phase main; the launch counters
    zeroed just before each engine's first block and read after its
    last.  Returns {width: launches}."""
    import torch
    from coreth_tpu_torch.parallel import make_mesh
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    out = {}
    for n in SHARD_WIDTHS:
        fresh = [Block.decode(w) for w in wire]
        store = StateStore()
        gblock = genesis.to_block(store)
        eng = E.ReplayEngine(genesis.config, store,
                             parent_header=gblock.header, batch_pad=txs,
                             capacity=capacity, window=128, device=dev,
                             mesh=make_mesh(n))
        _zero_launches()
        eng.replay_block(fresh[0])
        t1 = time.monotonic()
        root = eng.replay(fresh[1:])
        torch.cuda.synchronize()
        dt = time.monotonic() - t1
        launches = _read_launches()
        eng.close()
        if root != fresh[-1].header.root:
            raise AssertionError(f"shard n={n}: final root differs from "
                                 "the header")
        if eng.stats.blocks_device != len(fresh):
            raise AssertionError(f"shard n={n}: {eng.stats.blocks_device} "
                                 f"of {len(fresh)} blocks on the device")
        if launches["sharded_window"] < 1 or launches["transfer_window"] \
                or launches["sharded_recover"] < 1:
            raise AssertionError(f"shard n={n}: launches {launches}")
        per_shard = [sum(len(range(d, len(b.transactions), n))
                         for b in fresh) / len(fresh) for d in range(n)]
        replayed = sum(len(b.transactions) for b in fresh[1:])
        emit({"phase": "shard", "n_shards": n, "blocks": len(fresh),
              "txs_per_block": txs, "replay_s": round(dt, 4),
              "txs_per_s": round(replayed / dt, 1),
              "real_txs_per_shard_per_block": round(
                  sum(per_shard) / n, 2),
              "real_txs_per_shard_per_block_min_max": [min(per_shard),
                                                       max(per_shard)],
              "root_matches_header": True, "launches": launches,
              "stats": eng.stats.row(), "card": smi})
        out[n] = launches
    return out


# ------------------------------------------------------------ K9, K9x

def sharded_windows(dev, genesis, blocks):
    """K9 windows: phase k6's window (a) (the ERC-20 chain's first 8
    blocks x 256 lanes) packed by fresh sharded runners at n = 2, 4 and
    8, with key-range placement off (the token's 256 lanes on its
    contract bucket, no sync set) and on (the token hot: its lanes spread
    by conflict component, the keys of several shards in the sync set),
    every lane traced (K7), with the premap recipes one discovery pass of
    K6 learns.  Returns {(n, keyrange): pack}."""
    from coreth_tpu_torch.evm.device.shard import ShardedWindowRunner
    from coreth_tpu_torch.parallel import make_mesh
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    store = StateStore()
    gblock = genesis.to_block(store)
    fresh = [Block.decode(b.encode()) for b in blocks[:8]]
    eng = E.ReplayEngine(genesis.config, store, parent_header=gblock.header,
                         batch_pad=256, device=dev, specialize=False)
    eng.warm_senders(fresh)
    mx = eng._machine_executor()
    items = mx._window_items([(b, mx.classify(b)) for b in fresh])
    runner = mx._window_runner()
    runner.complete(runner.issue(items))
    out = {}
    for n in SHARD_WIDTHS:
        for keyrange in (False, True):
            r = ShardedWindowRunner(runner.fork, mx._base_value, make_mesh(n),
                                    device=dev, specialize=True,
                                    keyrange=keyrange)
            r.seed_window_hint(8)
            out[(n, keyrange)] = r.pack(items)
    eng.close()
    return out


def phase_k9(dev, windows):
    """K9 against its plain version on every window of
    ``sharded_windows``, in both modes, through the variant (K7 inside)
    and the generic library (every prog_id -1): tables and packed rows
    equal (tolerance 0), lane-steps too on the variant.  The plain
    version runs once per window: its result does not depend on the mode
    (integer sums and maxes; tests/test_torch_shard_occ.py holds both
    modes against the reference).  Returns (the kernels-line entry, the
    K9 outputs for phase k9x)."""
    import torch
    from coreth_tpu_torch.evm.device import machine as M
    rows, k9, outs = {}, None, {}
    for (n, keyrange), pk in windows.items():
        args = (pk["p"], pk["occ"], pk["table"], pk["key_tab"], pk["inputs"])
        spec, sync = pk["spec"], pk["sync_rows"]
        t0 = time.perf_counter()
        want = M.occ_sharded_plain(*args, spec, n, sync, "psum")
        torch.cuda.synchronize()
        plain_ms = 1000 * (time.perf_counter() - t0)
        gen_in = dict(pk["inputs"], prog_id=torch.full_like(
            pk["inputs"]["prog_id"], -1))
        gargs = args[:4] + (gen_in,)
        occupancy = pk["inputs"]["active"].reshape(
            pk["occ"].blocks, n, -1).sum(dim=(0, 2)).tolist()
        for mode in ("psum", "ppermute"):
            got = M.run_occ_sharded(*args, spec, n, sync, mode)
            gen = M.run_occ_sharded(*gargs, (), n, sync, mode)
            for what, g, keys in (("variant", got, ("table", "packed",
                                                    "steps")),
                                  ("generic", gen, ("table", "packed"))):
                for k in keys:
                    if not torch.equal(g[k], want[k]):
                        bad = (g[k] != want[k]).nonzero()[:5].tolist()
                        raise AssertionError(
                            f"K9 n={n} keyrange={keyrange} {mode} {what}: "
                            f"{k} differs from the plain version at {bad}")
            err = max_abs_err([got[k] for k in ("table", "packed", "steps")],
                              [want[k] for k in ("table", "packed", "steps")])
            ms = cuda_ms(lambda: M.run_occ_sharded(*args, spec, n, sync, mode),
                         reps=5, warmup=1)
            gen_ms = cuda_ms(lambda: M.run_occ_sharded(*gargs, (), n, sync,
                                                       mode),
                             reps=5, warmup=1)
            bound_ms, bound_by, lane_steps, rounds = _window_bound(pk, got, n)
            extra = got["packed"][:, :, -4:].cpu().numpy()
            key = f"n{n}_{'keyrange' if keyrange else 'bucket'}_{mode}"
            rows[key] = {
                "batch_per_shard": pk["p"].batch,
                "table_cap_per_shard": pk["occ"].table_cap,
                "sync_rows": 0 if sync is None else int(sync.shape[0]),
                "sync_keys": pk["sync"], "lanes_per_shard": occupancy,
                "rounds": rounds, "committed": int(extra[..., 0].sum()),
                "lane_steps": lane_steps,
                "generic_lane_steps": int(gen["steps"].sum()),
                "max_abs_err": err, "ms": round(ms, 4),
                "generic_ms": round(gen_ms, 4),
                "plain_ms": round(plain_ms, 1),
                "bound_ms": round(bound_ms, 5), "bound_by": bound_by}
            outs[(n, keyrange, mode)] = (got["packed"], pk["inputs"]["active"])
            if n == HEADLINE_WIDTH and keyrange and mode == "psum":
                k9 = {"name": "occ_sharded", "route": "cuda",
                      "source": "coreth_tpu_torch/csrc/occ_window.cu",
                      "replaces": "coreth_tpu/evm/device/shard.py:151",
                      "max_abs_err": err, "ms": round(ms, 4),
                      "plain_ms": round(plain_ms, 1),
                      "bound_ms": round(bound_ms, 5), "bound_by": bound_by,
                      "library_ms": None}
                rows[key]["device_ms"] = kernel_ms(
                    lambda: M.run_occ_sharded(*args, spec, n, sync, mode),
                    "occ_sharded", reps=5)
            if keyrange == (sync is None):
                raise AssertionError(f"K9 n={n} keyrange={keyrange}: sync "
                                     f"rows {sync is not None}")
    k9["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    emit({"phase": "k9", "equal": True, "windows": rows,
          "ms_is": f"n={HEADLINE_WIDTH}, key range, psum, K7 variant, CUDA "
          "events around the wrapper", "bound_is": "K6's over the union of "
          "the shards' lanes and arenas", **k9})
    return k9, outs


def phase_k9x(dev, outs):
    """K9x against its plain version on every K9 output of phase k9, in
    its mode: (W, 2) flags equal.  Bound: bytes, ``active`` read once,
    the packed rows' three flag columns of the active lanes only (an
    inactive lane reads nothing more), the flags written."""
    import torch
    from coreth_tpu_torch.evm.device import machine as M
    rows, k9x = {}, None
    for (n, keyrange, mode), (packed, active) in outs.items():
        got = M.shard_flags(packed, active, n, mode)
        t0 = time.perf_counter()
        want = M.shard_flags_plain(packed, active, n, mode)
        torch.cuda.synchronize()
        plain_ms = 1000 * (time.perf_counter() - t0)
        if not torch.equal(got, want):
            raise AssertionError(f"K9x n={n} {mode}: {got.tolist()} != "
                                 f"{want.tolist()}")
        W, NB = active.shape
        ms = cuda_ms(lambda: M.shard_flags(packed, active, n, mode))
        n_act = int((active != 0).sum())
        bound_ms, bound_by = bound(active.numel() * 4 + n_act * 3 * 4
                                   + W * 2 * 4, active.numel() + n_act * 3)
        key = f"n{n}_{'keyrange' if keyrange else 'bucket'}_{mode}"
        rows[key] = {"flags": got.tolist(), "ms": round(ms, 4),
                     "plain_ms": round(plain_ms, 3),
                     "bound_ms": round(bound_ms, 6), "bound_by": bound_by}
        if n == HEADLINE_WIDTH and keyrange and mode == "psum":
            k9x = {"name": "shard_flags", "route": "cuda",
                   "source": "coreth_tpu_torch/csrc/occ_window.cu",
                   "replaces": "coreth_tpu/evm/device/shard.py:267",
                   "max_abs_err": max_abs_err([got], [want]),
                   "ms": round(ms, 4), "plain_ms": round(plain_ms, 3),
                   "bound_ms": round(bound_ms, 6), "bound_by": bound_by,
                   "library_ms": None}
    emit({"phase": "k9x", "equal": True, "windows": rows,
          "ms_is": f"n={HEADLINE_WIDTH}, key range, psum, CUDA events "
          "around the wrapper", **k9x})
    return k9x


def phase_shard_erc20(dev, smi, genesis, blocks, txs: int, shard_occ: bool,
                      order: int):
    """The ERC-20 chain through the window path with K7 on a 4-shard
    engine: with ``shard_occ`` (the default) on the sharded runner (K9
    launched at least once a window, K9x too, the single-chip K6/K7
    never, the token hot: ``kr_lanes`` > 0), without it on the
    single-chip runner over the sharded tables (K9 never).  Root equal,
    no dirty block, no kernel built inside the timed replay.  ``order``:
    the run's place in the sharded/single A/B."""
    from coreth_tpu_torch import kernels
    from coreth_tpu_torch.parallel import make_mesh
    built = dict(kernels.BUILD_SECONDS)
    eng, root, dt, launches, steady = _replay_erc20(
        dev, genesis, blocks, txs, device_occ=True, specialize=True,
        mesh=make_mesh(HEADLINE_WIDTH), shard_occ=shard_occ)
    mc = eng.machine_counters()
    name = "sharded" if shard_occ else "single"
    if root != blocks[-1].header.root:
        raise AssertionError(f"shard_erc20 {name}: final root differs from "
                             "the header")
    if mc["blocks"] != len(blocks) or mc["dirty_blocks"] != 0:
        raise AssertionError(f"shard_erc20 {name}: {mc['blocks']} blocks, "
                             f"{mc['dirty_blocks']} dirty")
    if shard_occ:
        ok = (launches["occ_sharded"] >= mc["windows"] >= 1
              and launches["shard_flags"] >= 1
              and launches["occ_window_spec"] == 0
              and launches["occ_window"] == 0 and mc["kr_lanes"] > 0)
    else:
        ok = (launches["occ_window_spec"] >= mc["windows"] >= 1
              and launches["occ_sharded"] == 0
              and launches["shard_flags"] == 0)
    if not ok or launches["sharded_recover"] < 1 \
            or launches["step_machine"] != 0:
        raise AssertionError(f"shard_erc20 {name}: launches {launches}, "
                             f"counters {mc}")
    if kernels.BUILD_SECONDS != built:
        raise AssertionError(f"shard_erc20 {name}: a kernel was built "
                             "inside the timed replay")
    emit({"phase": "shard_erc20", "runner": name, "order": order,
          "n_shards": HEADLINE_WIDTH, "blocks": len(blocks),
          "txs_per_block": txs, "replay_s": round(dt, 4),
          "txs_per_s": round(len(blocks) * txs / dt, 1), **steady,
          "root_matches_header": True, "launches": launches, "machine": mc,
          "stats": eng.stats.row(), "card": smi})
    return launches, steady


# the reference bench's hot-contract shape (bench.py:1375-1380)
HOT_BLOCKS, HOT_TXS, HOT_KEYS, HOT_SEED, HOT_ALPHA = 64, 128, 256, \
    20260804, 1.1


def phase_hot(dev, smi):
    """The single-hot-contract chain (one ERC-20-shaped contract takes
    every tx, Zipf senders and recipients) at the reference bench's
    shape, replayed as the bench does (capacity 8192, batch_pad = txs,
    window 16, the first block alone before the timed replay) on one
    shard and at n = 2 and 4: root equal to the header, every block on
    the machine path, no dirty block; on the mesh the token hot (key
    range), K9 and K9x launched and the single-chip K6/K7 not.  Returns
    {n: launches}."""
    import torch
    from coreth_tpu_torch.evm.device import adapter as A
    from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
    from coreth_tpu_torch.parallel import make_mesh
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    from coreth_tpu_torch.workloads.hot_contract import build_hot_chain
    t0 = time.monotonic()
    genesis, blocks = build_hot_chain(CFG, HOT_BLOCKS, HOT_TXS,
                                      n_keys=HOT_KEYS, alpha=HOT_ALPHA,
                                      seed=HOT_SEED)
    t_build = time.monotonic() - t0
    wire = [b.encode() for b in blocks]
    out = {}
    for n in (1, 2, 4):
        fresh = [Block.decode(w) for w in wire]
        store = StateStore()
        gblock = genesis.to_block(store)
        eng = E.ReplayEngine(CFG, store, parent_header=gblock.header,
                             capacity=1 << 13, slot_capacity=1 << 13,
                             batch_pad=HOT_TXS, window=16, device=dev,
                             mesh=make_mesh(n) if n > 1 else None)
        A.RECIPES.clear()
        _zero_launches()
        eng.replay_block(fresh[0])
        t1 = time.monotonic()
        root = eng.replay(fresh[1:])
        torch.cuda.synchronize()
        dt = time.monotonic() - t1
        launches = _read_launches()
        eng.close()
        mc = eng.machine_counters()
        if root != fresh[-1].header.root:
            raise AssertionError(f"hot n={n}: final root differs from the "
                                 "header")
        if mc["blocks"] != len(fresh) or mc["dirty_blocks"]:
            raise AssertionError(f"hot n={n}: {mc['blocks']} machine "
                                 f"blocks, {mc['dirty_blocks']} dirty")
        if n > 1:
            ok = (launches["occ_sharded"] >= mc["windows"] >= 1
                  and launches["shard_flags"] >= 1 and mc["kr_lanes"] > 0
                  and launches["occ_window"] + launches["occ_window_spec"]
                  == 0)
        else:
            ok = launches["occ_window_spec"] >= mc["windows"] >= 1
        if not ok:
            raise AssertionError(f"hot n={n}: launches {launches}, "
                                 f"counters {mc}")
        replayed = sum(len(b.transactions) for b in fresh[1:])
        emit({"phase": "hot", "n_shards": n, "blocks": len(fresh),
              "txs_per_block": HOT_TXS, "keys": HOT_KEYS,
              "alpha": HOT_ALPHA, "seed": HOT_SEED,
              "chain_build_s": round(t_build, 2), "replay_s": round(dt, 4),
              "txs_per_s": round(replayed / dt, 1),
              "load_imbalance": eng.stats.load_imbalance,
              "kr_lanes": mc["kr_lanes"], "cross_shard": mc["cross_shard"],
              "exchange_psum": mc["exchange_psum"],
              "exchange_ppermute": mc["exchange_ppermute"],
              "root_matches_header": True, "launches": launches,
              "machine": mc, "stats": eng.stats.row(), "card": smi})
        out[n] = launches
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import coreth_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the coreth_tpu_torch package is not beside this "
              "script; run it from a checkout", file=sys.stderr)
        return 2
    from coreth_tpu_torch import kernels, nativebuild
    from coreth_tpu_torch.crypto import native, secp_device
    from coreth_tpu_torch.ops import secp as S
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.types import Block

    dev = torch.device("cuda")
    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch_name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build: native library and both kernels, all at once
    t0 = time.monotonic()
    native_box = {}

    def build_native():
        native_box["path"] = nativebuild.ensure_built()
        native_box["seconds"] = round(time.monotonic() - t0, 3)

    th = threading.Thread(target=build_native)
    th.start()
    took = kernels.build()
    th.join()
    if native_box.get("path") is None or native.load() is None:
        raise RuntimeError("make -C native failed")
    ptxas = {}
    for name in kernels.SOURCES:
        with open(kernels.log_path(name)) as f:
            ptxas[name] = [ln.strip() for ln in f
                           if "registers" in ln or "spill" in ln][-4:]
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 3),
          "nvcc_seconds": took, "native_seconds": native_box["seconds"],
          "ptxas": ptxas})

    rng = np.random.default_rng(SEED)

    # ---- 3. K1 against its plain version, main-path shapes
    K, pad, B = 128, 128, 128
    cap, scap, L, SL = 32768, 1024, 16384, 64
    win = random_window(rng, K, pad, B, cap, scap, n_acct=9400, n_slot=40,
                        L=L, SL=SL, t_pad=512, s_pad=64)
    args = [torch.from_numpy(a).to(dev) for a in win]
    got = E._transfer_window(*args)
    want = E._transfer_window_plain(*args)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("balances", "nonces", "slot_vals",
                                      "fetches")):
        if not torch.equal(g, w):
            bad = (g != w).nonzero()[:5].tolist()
            raise AssertionError(f"K1 {what} differ from the plain "
                                 f"version at {bad}")
    oks = got[3][:, -1, 0].cpu().numpy()
    if oks[1] != 0 or oks[2] != 0 or oks.sum() != K - 2:
        raise AssertionError(f"K1 ok flags unexpected: {oks[:4]}")
    k1_ms = cuda_ms(lambda: E._transfer_window(*args))
    k1_plain_ms = once_ms(lambda: E._transfer_window_plain(*args))
    k1_bytes = sum(a.nbytes for a in win) + sum(
        t.numel() * 4 for t in got)
    k1_ops = K * B * 400     # ~400 int32 ops per tx: limb sums + chains
    k1_bound = 1000 * max(k1_bytes / H100_BYTES_PER_S,
                          k1_ops / H100_INT32_OPS_PER_S)
    k1 = {"name": "transfer_window", "route": "cuda",
          "source": "coreth_tpu_torch/csrc/transfer_window.cu",
          "replaces": "coreth_tpu/replay/engine.py:245",
          "max_abs_err": max_abs_err(got, want), "ms": round(k1_ms, 4),
          "plain_ms": round(k1_plain_ms, 3),
          "bound_ms": round(k1_bound, 5),
          "bound_by": "bytes" if k1_bytes / H100_BYTES_PER_S
          >= k1_ops / H100_INT32_OPS_PER_S else "operations",
          "library_ms": None}
    emit({"phase": "k1", "equal": True, "K": K, "pad": pad, "L": L,
          "ok_flags_0_4": oks[:4].tolist(), **k1})

    # ---- 3b. K8 against its plain version on the same window
    k8 = phase_k8(dev, win, k1, got[3])

    # ---- 4. K2 against its plain version, 4096 signatures
    n_sig = 4096
    packed, kin = signature_batch(n_sig, SEED)
    dargs = [torch.from_numpy(a).to(dev) for a in kin]
    rows = S.recover_kernel(*dargs)
    rows_plain = S.recover_kernel_plain(*dargs)
    torch.cuda.synchronize()
    if not torch.equal(rows, rows_plain):
        bad = (rows != rows_plain).any(dim=1).nonzero()[:5].flatten()
        raise AssertionError(f"K2 rows differ from the plain version at "
                             f"{bad.tolist()}")
    addrs, okb = secp_device.complete_recover(secp_device.issue_recover(
        *packed, dev))
    addrs_n, okb_n = native.recover_addresses_batch(*packed)
    if okb != okb_n or any(
            okb[i] and addrs[20 * i:20 * i + 20] != addrs_n[20 * i:20 * i + 20]
            for i in range(n_sig)):
        raise AssertionError("K2 addresses differ from the native batch")
    k2_ms = cuda_ms(lambda: S.recover_kernel(*dargs))
    k2_plain_ms = once_ms(lambda: S.recover_kernel_plain(*dargs))
    k2_bytes = sum(a.nbytes for a in kin) + n_sig * 102
    k2_imads = ladder_imads(kin[2], kin[3])
    k2_bound = 1000 * max(k2_bytes / H100_BYTES_PER_S,
                          k2_imads / H100_IMAD_PER_S)
    k2 = {"name": "secp_recover", "route": "cuda",
          "source": "coreth_tpu_torch/csrc/secp_recover.cu",
          "replaces": "coreth_tpu/ops/secp.py:384",
          "max_abs_err": max_abs_err([rows], [rows_plain]),
          "ms": round(k2_ms, 4),
          "plain_ms": round(k2_plain_ms, 1),
          "bound_ms": round(k2_bound, 5),
          "bound_by": "operations" if k2_imads / H100_IMAD_PER_S
          >= k2_bytes / H100_BYTES_PER_S else "bytes",
          "library_ms": None}
    emit({"phase": "k2", "equal": True, "rows": n_sig,
          "valid_sigs": sum(okb), "imads": k2_imads, **k2})

    # ---- 4b. K8r against K2 on the same signatures
    k8r = phase_k8r(dev, dargs, k2)

    # ---- 5. the main path
    n_blocks, txs, n_keys = 256, 128, 1024
    t0 = time.monotonic()
    genesis, blocks = build_chain(n_blocks, txs, n_keys)
    t_build = time.monotonic() - t0
    wire = [b.encode() for b in blocks]
    fresh = [Block.decode(w) for w in wire]      # no cached senders
    from coreth_tpu_torch.state import StateStore
    store = StateStore()
    gblock = genesis.to_block(store)
    need = n_keys + n_blocks * txs // 2 + 1024
    capacity = 1 << max(14, (need - 1).bit_length())
    eng = E.ReplayEngine(genesis.config, store, parent_header=gblock.header,
                         batch_pad=txs, capacity=capacity, window=128,
                         device="cuda")
    E.LAUNCHES = 0
    S.LAUNCHES = 0
    t0 = time.monotonic()
    eng.replay_block(fresh[0])
    t1 = time.monotonic()
    root = eng.replay(fresh[1:])
    torch.cuda.synchronize()
    dt = time.monotonic() - t1
    launches = {"transfer_window": E.LAUNCHES, "secp_recover": S.LAUNCHES}
    eng.close()
    if root != blocks[-1].header.root:
        raise AssertionError("main path: final root differs from the header")
    if eng.stats.blocks_device != n_blocks:
        raise AssertionError(f"main path: {eng.stats.blocks_device} of "
                             f"{n_blocks} blocks on the device path")
    if min(launches.values()) < 1:
        raise AssertionError(f"main path: a kernel never launched: "
                             f"{launches}")
    replayed = sum(len(b.transactions) for b in fresh[1:])
    emit({"phase": "main", "blocks": n_blocks, "txs_per_block": txs,
          "keys": n_keys, "chain_build_s": round(t_build, 2),
          "first_block_s": round(t1 - t0, 4),
          "replay_s": round(dt, 4), "txs_per_s": round(replayed / dt, 1),
          "root_matches_header": True, "launches": launches,
          "stats": eng.stats.row(), "card": smi})

    # ---- 5b. the same chain on 2, 4 and 8 shards (K8, K8r)
    shard_launches = phase_shard(dev, smi, genesis, wire, txs, capacity)

    # ---- 6.-8. K3, K4, K5 against their plain versions
    k3 = phase_k3(dev, rng)
    k4 = phase_k4(dev, rng)
    k5 = phase_k5(dev, rng)

    # ---- 9. the machine path (per-block OCC, K5), on the ERC-20 chain
    m_txs, m_keys = 256, 1024
    t0 = time.monotonic()
    m_genesis, m_blocks = build_erc20_chain(128, m_txs, m_keys)
    t_build = time.monotonic() - t0
    m_launches = phase_machine(dev, smi, m_genesis, m_blocks, t_build,
                               m_txs, m_keys)

    # ---- 10.-11. K6, then K6+K7, against their plain versions
    k6 = phase_k6(dev, m_genesis, m_blocks)
    k7 = phase_k7(dev, m_genesis, m_blocks)

    # ---- 12. the window path without K7 (window) and with it (spec,
    # the reference's default), in the order window, spec, spec, window
    runs = []
    for order, specialize in enumerate((False, True, True, False), 1):
        runs.append((specialize, *phase_window(
            dev, smi, m_genesis, m_blocks, m_txs, specialize, order)))
    w_launches = next(ln for sp, ln, _s in runs if not sp)
    s_launches = next(ln for sp, ln, _s in runs if sp)
    emit({"phase": "ab", "order": ["window", "spec", "spec", "window"],
          "first_fold_s": [st["first_fold_s"] for _sp, _ln, st in runs],
          "steady_txs_per_s": [st["steady_txs_per_s"]
                               for _sp, _ln, st in runs]})

    # ---- 12b. K9 and K9x against their plain versions (phase k7 built
    # the token's variant, which holds K9 too)
    k9, k9_outs = phase_k9(dev, sharded_windows(dev, m_genesis, m_blocks))
    k9x = phase_k9x(dev, k9_outs)
    del k9_outs

    # ---- 13. the window path with K7 on a 4-shard engine: the sharded
    # runner (the reference default) against the single-chip one, in the
    # order sharded, single, single, sharded
    ab = []
    for order, shard_occ in enumerate((True, False, False, True), 1):
        ab.append((shard_occ, *phase_shard_erc20(
            dev, smi, m_genesis, m_blocks, m_txs, shard_occ, order)))
    sh_launches = next(ln for so, ln, _s in ab if so)
    emit({"phase": "shard_erc20_ab",
          "order": ["sharded", "single", "single", "sharded"],
          "first_fold_s": [st["first_fold_s"] for _so, _ln, st in ab],
          "steady_txs_per_s": [st["steady_txs_per_s"]
                               for _so, _ln, st in ab]})

    # ---- 14. the hot-contract chain on one shard and on 2 and 4
    phase_hot(dev, smi)

    k1["launches"] = launches["transfer_window"]
    k2["launches"] = launches["secp_recover"]
    k5["launches"] = m_launches["step_machine"]
    k6["launches"] = w_launches["occ_window"]
    k7["launches"] = s_launches["occ_window_spec"]
    k3["launches"] = k4["launches"] = "in K5, K6 and K7"
    k8["launches"] = shard_launches[HEADLINE_WIDTH]["sharded_window"]
    k8r["launches"] = shard_launches[HEADLINE_WIDTH]["sharded_recover"]
    k9["launches"] = sh_launches["occ_sharded"]
    k9x["launches"] = sh_launches["shard_flags"]
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6, k7, k8, k8r, k9,
                                  k9x]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
