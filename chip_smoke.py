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
   nonce-mismatch block and out-of-bounds pad gids, and on the "hot",
   "pad_rows" and "negative" shapes of ``shaped_window`` (the last a
   sender and fetch indices below zero, which wrap as a jnp gather
   does): tables and fetch rows must be
   equal exactly (tolerance 0: integer results); ms on each window, the
   launch's time by phase (blocks, rows, fetch), the scratch and phase
   (a)'s layout;
4. K2     — the secp256k1 recovery kernel against its plain version on 4096
   signatures made with the port's ``sign`` plus malformed rows (r or s out
   of range, recid 2/3, x >= p) and on the ladder's corner rows
   (``corner_batch``): the 102-byte rows must be equal exactly, and the
   addresses recovered through the kernel must equal the native C++
   ``recover_addresses_batch``; the design's group width (threads a
   signature), block size and warps an SM at 4096 and 1024 rows;
5. main   — the benchmark's transfer shape (1024 keys, 128 txs/block, every
   other recipient fresh, TEST_CHAIN_CONFIG, gap 10), cut to 256 blocks,
   built by the port's sequential chain builder and replayed through
   ``ReplayEngine(device="cuda", window=128)``: every block must take the
   device path, the final root must equal the last header's, and both
   kernels' launch counters must rise during the replay;
6. k3     — the keccak-256 launch entry against its plain version on 4096
   messages of 0..271 bytes plus the 135/136-byte padding edges
   (tolerance 0), and against the native C++ ``coreth_keccak256``; ms
   around the wrapper and the kernel's device ms (``torch.profiler``);
7. k4     — the 256-bit ALU launch entry, every op, against its plain
   version on 4096 random operand rows plus every pair of edge operands
   (0, 1, 2^255, 2^256 - 1 = -1 signed, shift edges), the division
   family also on ``division_operands`` (its rare paths): tolerance 0;
   per op the wrapper's ms, the kernel's device ms, the wrapper's host
   ms and the bound of the op's least work (``alu_ops``: word-wise
   division's digit products, squarings' halves; ``alu_bytes``: the
   rows the op reads and writes); the entry's bound is their sum;
8. k5     — the step machine at main-path shapes (batch 256): ERC-20
   ``transfer()`` lanes with the storage cache seeded and unseeded (miss
   rows), lanes that REVERT (insufficient balance), run out of gas, hit
   INVALID or escape HOST: packed rows and step counts equal to the plain
   version's (tolerance 0); then the launch's time split: the same batch
   with every lane a lone STOP (wrapper and lane set-up only), and the
   kernel's device time from a ``torch.profiler`` trace of both; the
   group the batch ran on (lanes a CTA, CTAs, shared memory a CTA, the
   lane slots' layout);
9. machine — the benchmark's ERC-20 shape (1024 keys, 256 txs/block, every
   third recipient the next key, TEST_CHAIN_CONFIG, the bench genesis),
   cut from 256 to 128 blocks because the chain is built with pure-Python
   signing within the script's run-time budget; its first 64 blocks
   (``MACHINE_BLOCKS``: the per-block path is the script's slowest replay)
   replayed through
   ``ReplayEngine(device="cuda", device_occ=False)`` (per-block OCC on the
   step machine): every block on the machine path, OCC rounds > 0, the
   final root equal to the last header's, and the step machine's launch
   counter rising during the replay; txs/s over the whole replay and
   after the first fold (``steady_txs_per_s``);
10. k6    — the fused OCC window against its plain version (tolerance 0:
   table, packed rows, lane-steps) on four windows: (a) the ERC-20
   chain's first 8 blocks x 256 lanes with the premaps the window runner
   learns from them, (b) two blocks of 8 swaps (full conflict, one lane
   per round), (c) three blocks of 16 ERC-20 transfers with a HOST lane,
   an unpremapped lane and five trailing inactive blocks, (d) the
   chain's first 2 blocks at 256 lanes x 256 cache entries (the sticky
   bucket after a tx with over 120 premapped keys: B*S past 32768, so
   the sweep's index columns are int32); per-launch ms
   (CUDA events), device ms (``torch.profiler``), rounds per block,
   lane-steps, and the bound from the bytes this window's lanes need
   (``_window_bound``); for window (a) the launch's init / exec / sweep /
   write-back split (``occ_split.py``'s instrumented copy of the source,
   built beside the kernels in phase build), the group it runs on (CTAs,
   lanes a CTA, lane slots, staged lanes, shared memory a CTA), its
   cluster barriers (by the kernel's formula, not counted), and the
   generic library's ``ptxas`` lines;
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
   lumped flush; per-launch ms, device ms, bound, plain ms; window (a)'s
   split, group and barriers as in phase k6 (its variant instrumented);
   then a ``ptxas`` line: registers, stack frame and spill bytes of the
   K4 and K3 entries, K5, generic K6 and window (a)'s variant;
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
   working sets equal, the fetch rows equal to K1's; the same on 8-block
   windows of the hot shape (every lane of a block pays one recipient and
   one token slot), with out-of-range pad rows and with negative indices
   (``shaped_window``);
   ms beside K1's on the same window, the exchange bytes, K1's bound, and
   the design: the slab layout the launches took, shared memory a CTA,
   barriers a block;
4b. k8r    — the sharded ladder (K2 on each of n slices, each on its own
   stream) against K2 on phase k2's signatures: rows equal;
5b. shard  — phase main's chain (fresh decodes from the wire) through
   ``ReplayEngine(mesh=make_mesh(n))``: root equal to the header, every
   block on the device, K8 and K8r launched and K1 not; txs/s, the
   ``ReplayStats`` and the real txs per shard per block;
12a. token — the ERC-20 chain of phase machine through the token fast
   path (the reference's default for ``transfer()`` calls: classified on
   the host with exact gas and the Transfer log, the slot arithmetic on
   the window kernels' slot half), ``slot_capacity`` 1 << 14, on one
   shard (K1) and at n = 4 (K8): root equal, every block on the window
   path, K5, K6, K7 and K9 never launched; txs/s beside phase window's;
12a'. k8s  — the per-block sharded steps (K8s, ``parallel/mesh.py``
   ``sharded_transfer_step`` / ``sharded_slot_step``, one row-parallel
   launch each over every SM, the same at every n) against their plain
   versions on random inputs at A = S = 16384, B = 512, n = 2, 4, 8, and
   on them reshaped by ``k8s_shaped`` (one sender paying the coinbase,
   every tx masked, sender -2): tolerance 0; the split by phase at n = 4
   (``window_split.py``'s instrumented copy, built beside the kernels in
   phase build) and the wrapper's host ms; then on the path: the
   counters zeroed, one call of each at n = 4 fed by the chain's first
   block as the token-path engine classifies it, the counters read, the
   results equal to the single-chip plain steps; ms, plain ms, bound,
   the launch's design (rows a CTA, CTAs, shared memory);
12b. k9    — the sharded OCC window (one cluster launch of n x c CTAs)
   against its plain version on phase k6's window (a) packed by sharded
   runners at n = 2, 4 and 8, with key-range placement off (the token on its
   contract bucket, no sync set) and on (the token hot, with the sync
   set), in both modes, through the token's K7 variant and through the
   generic library: tables and packed rows equal (tolerance 0), lane-steps
   too on the variant; ms per window, the bound over the shards' lanes
   and arenas (``_window_bound``), plain ms; at n = 4 with the sync set
   the split, group and barriers as in phase k6;
12c. k9x   — the shards' flags reduce (the reference's K9x), K9's
   epilogue with no launch of its own: K9's (W, 2) flags of every
   phase-k9 output equal to the plain version's; the byte bound, ms
   null, and K9's write-back split beside; in the kernels line its
   launches are phase shard_erc20's launches of ``flags_fill_kernel``
   (the only kernel whose work is the flags alone: a window without
   lanes) and ``carried_by_k9`` that phase's K9 launches;
13. shard_erc20 — the ERC-20 chain through the window path with K7 on a
   4-shard engine four times, in the order sharded, single, single,
   sharded: the sharded runner (the reference default: K9 at least once
   a window, its last window's flags equal to the plain version's, the
   single-chip K6/K7 never, ``kr_lanes`` > 0) and the
   single-chip runner over the sharded tables (``shard_occ=False``: K6+K7,
   K9 never); root equal, no dirty block, nothing built inside the timed
   replay; then a closing ``shard_erc20_ab`` line;
14. hot    — the single-hot-contract chain at the reference bench's shape
   (64 blocks x 128 txs, 256 keys, Zipf alpha 1.1, seed 20260804; one
   ERC-20-shaped contract takes every tx) replayed as the bench does on
   one shard and at n = 2 and 4: root equal, every block on the machine
   path with no dirty block, on the mesh K9's last window's flags equal
   to the plain version's; txs/s, ``load_imbalance``, ``kr_lanes``,
   ``cross_shard`` and the exchange counts;
15. host   — the exact host path under the device paths, on three chains
   of the port's own builder from one genesis (``build_host_chains``),
   replayed one after another on one store: transfers (64 blocks x 128
   txs, 1024 keys, ``window=128``) with two blocks that spend credits
   received earlier in the same block (the device rejects them: each
   rewinds its window, K1 re-applies the valid prefix, timed with the
   card synchronised around it, and the block runs on the Processor;
   ``blocks_fallback`` 2, K1 launched 5 times); the ERC-20 shape (24
   blocks x 256, K7 on, token calls on the machine) with a call into a
   contract that stores past the lanes' 4096 bytes of memory (its
   block goes dirty, K5 meets the same escape, the Processor takes it;
   K7 windows launch before and after); swap blocks (8 x 256) on the
   serial short-circuit (no K5, K6 or K7 launch).  Each run: root equal
   to the last header's and to the store's, counters, launches (also
   at each host-path block), seconds per host-path block, the card;
16. mixed  — the Avalanche-semantics segment (BASELINE config 4, the
   reference bench's ``mixed``: ``TEST_APRICOT_PHASE5_CONFIG``, 64 keys,
   128 blocks x 32 txs, an atomic ExtData import every 8th block, a
   nativeAssetCall block at i % 8 == 1, i > 1), built by the port's
   builder with the atomic callbacks and replayed with
   ``ReplayEngine(engine=...)`` over a reseeded hub (``window=128``):
   root equal to the last header's, 31 host-path and 97 device blocks,
   K1 and K2 launched, the asset recipient's multicoin balance and the
   16 pending import blocks; txs/s, ``t_fallback``, seconds a host-path
   block of each kind;
17. rehash — ``mpt/rehash.py device_rehash`` on K3's entry: two
   SecureTries of 65,536 keys, rehash against ``trie.hash()``, again
   after 8,192 keys change (K3 launches, device and host ms, dirty
   nodes a level); K3 against its plain version on every encoding
   hashed (tolerance 0); the host-against-device crossover at 256,
   1,024, 4,096, 16,384 and 65,536 keys.  K3's ``launches`` in the
   kernels line are this phase's (its device functions also run inside
   K5, K6 and K7).
18.-20. trie, faults, trace — the Python-trie fold with K3 inside the
   replay, the fault ladder, the span tracer (see each phase's
   docstring).
21. flat   — the flat-state layer, on by default in every phase above
   (``ReplayEngine(flat=True)``, the reference's ``CORETH_FLAT=1``),
   on the chains already signed: (a) phase main's transfer chain and
   the ERC-20 window chain each replayed with ``flat=False`` and with
   ``flat=True`` (roots the headers', K1/K2 and K6+K7 launched, counters
   zeroed before each replay; txs/s, ``t_classify``, ``t_device`` and
   the flat snapshot: fills, hits, generations); (b) the ERC-20 chain
   with ``flat_check=True``, its second half on an engine resumed from
   a checkpoint at the halfway block (one engine's cold reads only fill
   the layer; the resumed one's hit the loaded base), every flat hit
   re-derived from the tries, no divergence, hits > 0; (c) a 16-block prefix of the transfer chain: a block
   whose last tx was dropped quarantined, ``rollback_block``, then the
   true tail to the header's root; (d) the transfer chain over a
   ``FileDB`` in a temporary directory with a background
   ``CheckpointManager``, the record written halfway and the store
   closed, ``resume_engine`` on the card from it and the rest replayed
   to the last header's root (the record's number, the stamp cost, the
   exporter's counters, the resume's seconds).

Phases machine, window, spec, shard_erc20 and hot measure the machine
path, so their engines take ``token_fastpath=False`` (``bench.py``'s
erc20-machine, specialisation and hot-contract sections set
``CORETH_NO_TOKEN_FASTPATH=1``); their K5/K6/K7/K9 launch checks fail if
a token block slipped onto the fast path.

Then one JSON line with every kernel's numbers, the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
nonzero; without a card, or without the package beside this script, it
exits nonzero before printing any result.
"""

from __future__ import annotations

import concurrent.futures
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


def shaped_window(rng, shape: str, K: int, pad: int, B: int, **kw):
    """``random_window`` reshaped for the window kernels' corners.  "hot":
    every lane of a block pays one recipient and one token slot (the hot
    chain's shape; blocks 1 and 2 keep their insolvent sender and nonce
    mismatch); "pad_rows": the masked pad lanes' accounts and slots out
    of range (past the locals and negative) and block 3's coinbase past
    the locals; "wrap": block 0's first sender with two lanes requires
    2^255 more on each, so its required total wraps past 2^256 (and
    passes), and block 1's insolvent lane sends 2^255, so its sender's
    balance wraps below zero for the blocks on top; "untouched": each
    block's fetch rows also list rows the block does not touch (the
    previous block's, a local past the touched set, an index past the
    end, which clamps) and slots likewise; "negative": block 0's first pad
    lane unmasked, sending nothing from account -2 with the nonce of
    local row L - 2 (a jnp gather wraps -2 to L - 2), and every block's
    fetch rows also list accounts -2 and -(L + 3) and slots -2 and
    -(SL + 3) (rows L - 2 and 0, SL - 2 and 0).  The fetch rows list each
    block's touched rows first."""
    from coreth_tpu_torch.ops import u256
    win = list(random_window(rng, K, pad, B, **kw))
    txds, t_idxs, s_idxs = win[5], win[6], win[7]
    L, SL = win[3].shape[0], win[4].shape[0]
    n_acct = int((win[3] < kw["cap"]).sum())
    n_slot = int((win[4] < kw["scap"]).sum())
    for k in range(K):
        txd = txds[k]
        if shape == "hot":
            txd[:B, 1] = int(rng.integers(0, n_acct))
            txd[:B, 55] = int(rng.integers(0, n_slot))
        elif shape == "pad_rows":
            txd[B:, 0] = L + 5
            txd[B:, 1] = -3
            txd[B:, 54] = SL + 1
            txd[B:, 55] = -1
            if k == 3:
                txd[:, 5] = L
        elif shape == "wrap":
            if k == 0:
                s, n = np.unique(txd[:B, 0], return_counts=True)
                lanes = np.flatnonzero(txd[:B, 0] == s[n >= 2][0])[:2]
                for i in lanes:
                    req = sum(int(v) << 16 * j
                              for j, v in enumerate(txd[i, 38:54]))
                    txd[i, 38:54] = u256.pack_np([(1 << 255) + req])
            if k == 1:
                txd[0, 6:22] = u256.pack_np([1 << 255])
        elif shape == "negative":
            if k == 0:
                if txd.shape[0] <= B:
                    raise ValueError("shaped_window: 'negative' needs a pad "
                                     "lane (pad > B)")
                gids, cap = win[3], win[0].shape[0]
                lnon = [int(win[1][g]) if g < cap else 0
                        for g in (gids[L - 2], gids[0])]
                if lnon[0] == lnon[1]:
                    raise ValueError("shaped_window: local rows L - 2 and 0 "
                                     "hold one nonce")
                txd[B, :5] = (-2, 0, lnon[0], 0, 1)
        elif shape != "untouched":
            raise ValueError(f"shaped_window: unknown shape {shape!r}")
        touched = sorted({int(v) for v in txd[:B, :2].ravel()}
                         | {int(txd[0, 5])} & set(range(L)))
        stouched = sorted({int(v) for v in txd[:B, 54:56].ravel()})
        if shape == "untouched":
            prev = {int(v) for v in txds[k - 1][:B, :2].ravel()} if k else set()
            touched += sorted(prev - set(touched))[:3] + [
                n_acct + k % max(L - n_acct, 1), L + 7]
            stouched += [n_slot + k % max(SL - n_slot, 1), SL + 3]
        elif shape == "negative":
            touched += [-2, -(L + 3)]
            stouched += [-2, -(SL + 3)]
        t_idxs[k] = 0
        t_idxs[k, :min(len(touched), t_idxs.shape[1])] = \
            touched[:t_idxs.shape[1]]
        s_idxs[k] = 0
        s_idxs[k, :min(len(stouched), s_idxs.shape[1])] = \
            stouched[:s_idxs.shape[1]]
    return tuple(win)


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


def corner_batch(seed: int):
    """Kernel inputs (x, parity, u1w, u2w) built straight from field
    values, one row per corner of the ladder: R = G (the 2G entry),
    R = -G (the infinite G+R entry, so the steps with both bits set add
    nothing), a doubling collision (R = 2G with u1 = 2, u2 = 1), u1 = 0,
    u2 = 0, u1 = u2 = 0, and both scalars with only their top bit set.
    The free rows take x from signatures of ``signature_batch``."""
    import random
    from coreth_tpu_torch.ops.secp import G2X, G2Y, GX, GY
    rnd = random.Random(seed)
    _packed, (sx, spar, _u1, _u2) = signature_batch(12, seed)
    free = [(int.from_bytes(sx[i].tobytes(), "little"), int(spar[i]))
            for i in range(3)]          # rows past 4 are the malformed ones
    top = 1 << 255
    rows = [(GX, GY & 1, rnd.getrandbits(256), rnd.getrandbits(256)),
            (GX, 1 - (GY & 1), rnd.getrandbits(256), rnd.getrandbits(256)),
            (G2X, G2Y & 1, 2, 1),
            (*free[0], 0, rnd.getrandbits(256)),
            (*free[1], rnd.getrandbits(256), 0),
            (*free[2], 0, 0),
            (*free[0], top, top)]
    x = np.array([np.frombuffer(v.to_bytes(33, "little"), np.uint8)
                  for v, _p, _a, _b in rows])
    parity = np.array([p for _v, p, _a, _b in rows], dtype=np.int32)

    def words(v):
        return np.frombuffer(v.to_bytes(32, "little"), "<u4").astype(np.int32)
    u1w = np.array([words(a) for _v, _p, a, _b in rows])
    u2w = np.array([words(b) for _v, _p, _a, b in rows])
    return x, parity, u1w, u2w


# the function's squarings and multiplies per row outside the ladder: x^3
# and the y^2 check (2 squarings, 1 multiply), the G+R entry (1, 2), and
# the addition chains of the square root ((p + 1) / 4: 253 squarings, 13
# multiplies) and the inversion (p - 2: 255, 15)
FIXED_SQRS = 2 + 1 + 253 + 255
FIXED_MULS = 1 + 2 + 13 + 15
# 32-bit multiply-adds of one multiply (64 word products, lo and hi
# halves) and of one squaring (36 products: 8 squares, 28 doubled cross
# products); the fold by 2^256 = 2^32 + 977 is left out (shifts and adds
# can do it)
MUL_IMADS, SQR_IMADS = 128, 72


def ladder_imads(u1w: np.ndarray, u2w: np.ndarray) -> int:
    """32-bit multiply-adds the recovery kernel's function needs on these
    inputs: per row the products outside the ladder, 5 squarings and 2
    multiplies per doubling, and 3 squarings and 8 multiplies per ladder
    step that adds (a set bit of u1 or u2, after the first)."""
    rows = u1w.shape[0]
    bits = np.unpackbits(
        (u1w.view(np.uint32) | u2w.view(np.uint32)).view(np.uint8),
        axis=1).sum(axis=1)
    adds = int(np.maximum(bits.astype(np.int64) - 1, 0).sum())
    sqrs = (FIXED_SQRS + 5 * 256) * rows + 3 * adds
    muls = (FIXED_MULS + 2 * 256) * rows + 8 * adds
    return SQR_IMADS * sqrs + MUL_IMADS * muls


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


def _word(*ws) -> int:
    """An integer from 32-bit words, least significant first."""
    return sum(w << (32 * i) for i, w in enumerate(ws))


U256_MAX = (1 << 256) - 1
# (a, b, c) built to reach K4's rare division paths, for every op of the
# division family: Knuth's add-back (Hacker's Delight divmnu64's test
# vectors, lifted into 256 bits), estimates corrected once and twice, a
# dividend top word equal to the divisor's, normalisation shifts of 0,
# one-word divisors, dividends below the divisor, -2^255 / -1, MULMOD by
# 1, ADDMOD sums past 2^256 and a zero divisor
DIV_CASES = [
    (_word(0, 0xFFFE, 0x80000000), _word(1, 0, 0x80000000), 7),
    (_word(3, 0, 0x80000000), _word(1, 0, 0x20000000), 5),
    (_word(0, 0, 0x8000, 0x7FFF), _word(1, 0, 0x8000), 3),
    (_word(0, 0xFFFE, 0, 0x8000), _word(0xFFFF, 0, 0x8000), 9),
    (_word(0, 0xFFFFFFFE, 0, 0x80000000), _word(0xFFFF, 0, 0x80000000), 11),
    (_word(0, 0xFFFFFFFE, 0, 0x80000000),
     _word(0xFFFFFFFF, 0, 0x80000000), 13),
    (_word(0, 0, 0, 0, 0, 0, 0xFFFE, 0x80000000),
     _word(0, 0, 0, 0, 1, 0, 0x80000000), 17),
    (_word(0, 0, 0, 0, 0, 0, 0, 0x80000000),
     _word(0, 0, 0, 0, 0, 1, 0x80000000), 19),
    (_word(*[0xFFFFFFFF] * 8), _word(*[0xFFFFFFFF] * 7, 0x80000000), 23),
    (_word(*[0xFFFFFFFF] * 8), 0x80000000, 1),
    (_word(*[0xFFFFFFFF] * 8), 0xFFFFFFFF, U256_MAX),
    (_word(*[0xFFFFFFFF] * 8), 10, U256_MAX - 1),
    (12345, 1 << 200, 1),
    (1 << 255, U256_MAX, 1),                          # -2^255 / -1
    (U256_MAX, U256_MAX, 1),                          # MULMOD by 1
    (U256_MAX, U256_MAX - 5, (1 << 255) + 3),         # ADDMOD past 2^256
    ((1 << 255) + 7, (1 << 255) + 9, 1 << 255),
    (5, 0, 0),                                        # zero divisor
]


def division_operands(seed: int = 31, n: int = 400):
    """(a, b, c) integer lists: DIV_CASES, then n dividends q * v + r
    whose top words share the divisor's (so digit estimates run close:
    the corrections), with c = v."""
    rng = np.random.default_rng(seed)
    a, b, c = (list(col) for col in zip(*DIV_CASES))
    for _ in range(n):
        kind = int(rng.integers(3))
        if kind == 0:
            v = int.from_bytes(rng.bytes(32), "big") >> int(
                rng.integers(0, 200))
        elif kind == 1:
            v = ((1 << int(rng.integers(33, 256)))
                 + int(rng.integers(-2, 3))) & U256_MAX
        else:
            v = _word(*(int(w) for w in rng.choice(
                [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], size=8)))
        v |= 1
        q = int(rng.integers(1, 1 << 32))
        a.append((q * v + int(rng.integers(0, 1 << 63)) % v) & U256_MAX)
        b.append(v)
        c.append(v)
    return a, b, c


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


def _words(x: int) -> int:
    return (x.bit_length() + 31) // 32


def _div_products(u: int, v: int) -> int:
    """Word products of dividing u by v word-wise (Knuth D): one digit
    a word of the quotient, each the divisor's words times the digit."""
    if v == 0 or u < v:
        return 0
    return (_words(u) - _words(v) + 1) * _words(v)


# 32-bit multiply-add halves (a product's low or high word) of a
# product mod 2^256 (the 36 word products of i + j <= 7, the 8 of i + j
# = 7 low half only: 36 low, 28 high), of a squaring mod 2^256 (16 cross
# products, 4 of them low half only, and 4 squares: 20 low, 16 high)
# and of the full 512-bit product (64 each)
MUL_HALVES, SQR_HALVES, WIDE_HALVES = 36 + 28, 20 + 16, 128
# inputs each op reads (its output row written once besides)
ALU_ARITY = {"addmod": 3, "mulmod": 3, "not": 1, "bit_length": 1}


def alu_ops(op: str, a: list, b: list, c: list) -> int:
    """The least 32-bit integer operations ``op`` needs on these rows,
    a multiply-add half counted as 2 (half the int32 rate) and a word
    product needing both halves as 4: 8 for add, sub, a compare, NOT,
    a shift, BYTE, SIGNEXTEND and the bit length (one a word); MUL
    ``MUL_HALVES``, the wide product ``WIDE_HALVES``; DIV, MOD, SDIV
    and SMOD the digit products of word-wise long division of the
    (absolute) operands, ADDMOD of the sum, MULMOD the wide product and
    its division; EXP ``SQR_HALVES`` a squaring (one per exponent bit
    past the top) and ``MUL_HALVES`` a multiply (one per set bit past
    the first)."""
    n = len(a)
    if op == "mul":
        return 2 * MUL_HALVES * n
    if op in ("mul_wide_lo", "mul_wide_hi"):
        return 2 * WIDE_HALVES * n
    if op in ("div", "mod"):
        return 4 * sum(_div_products(x, y) for x, y in zip(a, b))
    if op in ("sdiv", "smod"):
        def mag(x):
            return min(x, (1 << 256) - x)
        return 4 * sum(_div_products(mag(x), mag(y)) for x, y in zip(a, b))
    if op == "addmod":
        return 4 * sum(_div_products(x + y, z) for x, y, z in zip(a, b, c))
    if op == "mulmod":
        return sum(2 * WIDE_HALVES + 4 * _div_products(x * y, z)
                   for x, y, z in zip(a, b, c))
    if op == "exp":
        return 2 * sum(SQR_HALVES * max(y.bit_length() - 1, 0)
                       + MUL_HALVES * max(bin(y).count("1") - 1, 0)
                       for y in b)
    return 8 * n


def alu_bytes(op: str, rows: int) -> int:
    """Bytes ``op`` must move on ``rows`` rows of 16 int32 limbs: each
    input it reads (``ALU_ARITY``, else 2) once, the output once."""
    return (ALU_ARITY.get(op, 2) + 1) * rows * 64


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


def phase_k1(dev, rng):
    """K1 against its plain version at main-path shapes (128 blocks x 128
    txs, ~9.4k window locals) on ``random_window`` and on the "hot",
    "pad_rows" and "negative" shapes of ``shaped_window`` (the last with
    120 txs a block, so a pad lane is free): tables and fetch rows equal
    (tolerance 0).  ms per window on each, the launch's time by phase
    ((a) blocks with M's reset, (b) rows, (c) fetch: CUDA events between
    its launches, medians of 5), the scratch and phase (a)'s layout.
    Returns the random window, K1's kernels-line entry and its fetch
    rows."""
    import torch
    from coreth_tpu_torch.replay import engine as E
    K, pad, B, t_pad, s_pad = 128, 128, 128, 512, 64
    cap, scap, L, SL = 32768, 1024, 16384, 64
    kw = dict(cap=cap, scap=scap, n_acct=9400, n_slot=40, L=L, SL=SL,
              t_pad=t_pad, s_pad=s_pad)
    wins = {"random": random_window(rng, K, pad, B, **kw)}
    for i, shape in enumerate(("hot", "pad_rows", "negative"), 1):
        wins[shape] = shaped_window(np.random.default_rng(SEED + i), shape,
                                    K, pad, B - 8 * (shape == "negative"),
                                    **kw)
    rows, errs = {}, []
    for name, win in wins.items():
        args = [torch.from_numpy(a).to(dev) for a in win]
        got = E._transfer_window(*args)
        want = E._transfer_window_plain(*args)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("balances", "nonces", "slot_vals",
                                          "fetches")):
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:5].tolist()
                raise AssertionError(f"K1 {what} differ from the plain "
                                     f"version on the {name} window at "
                                     f"{bad}")
        oks = got[3][:, -1, 0].cpu().numpy()
        if oks[1] != 0 or oks[2] != 0 or oks.sum() != K - 2:
            raise AssertionError(f"K1 ok flags unexpected on the {name} "
                                 f"window: {oks[:4]}")
        errs.append(max_abs_err(got, want))
        splits = []
        for _ in range(5):
            split = []
            E._transfer_window(*args, split_ms=split)
            splits.append(split)
        rows[name] = {
            "ms": round(cuda_ms(lambda: E._transfer_window(*args)), 4),
            "split_ms": dict(zip(("a_blocks", "b_rows", "c_fetch"), (
                round(float(v), 4) for v in np.median(splits, axis=0)))),
            "ok_flags_0_4": oks[:4].tolist()}
        if name == "random":
            plain_ms = once_ms(lambda: E._transfer_window_plain(*args))
            n_bytes = sum(a.nbytes for a in win) + sum(
                t.numel() * 4 for t in got)
            fetches = got[3]
    n_ops = K * B * 400     # ~400 int32 ops per tx: limb sums + chains
    bound_ms = 1000 * max(n_bytes / H100_BYTES_PER_S,
                          n_ops / H100_INT32_OPS_PER_S)
    words, smem, layout, ca = E.window_plan(dev, K, pad, L, SL, t_pad, s_pad)
    k1 = {"name": "transfer_window", "route": "cuda",
          "source": "coreth_tpu_torch/csrc/transfer_window.cu",
          "replaces": "coreth_tpu/replay/engine.py:245",
          "max_abs_err": max(errs), "ms": rows["random"]["ms"],
          "plain_ms": round(plain_ms, 3), "bound_ms": round(bound_ms, 5),
          "bound_by": "bytes" if n_bytes / H100_BYTES_PER_S
          >= n_ops / H100_INT32_OPS_PER_S else "operations",
          "library_ms": None}
    emit({"phase": "k1", "equal": True, "K": K, "pad": pad, "L": L,
          "SL": SL, "windows": rows, "scratch_bytes": 4 * words,
          "compact_rows_a_block": ca, "a_shared_bytes": smem,
          "a_layout": "shared" if layout else "device", **k1})
    return wins["random"], k1, fetches


def k3_messages(rng) -> list:
    """Phase k3's 4096 messages: random lengths 0-271, then one block's
    edges (135, 136 bytes), the empty message and two blocks' last."""
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 272, 4090)]
    return msgs + [rng.bytes(n) for n in (135, 136, 135, 136, 0, 271)]


def phase_k3(dev):
    """K3 against its plain version and the native keccak on
    ``k3_messages``; ms around the wrapper and the kernel's device ms
    (``torch.profiler``)."""
    import torch
    from coreth_tpu_torch.crypto import native
    from coreth_tpu_torch.ops import keccak as K
    msgs = k3_messages(np.random.default_rng(SEED + 3))
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
    k_ms = kernel_ms(lambda: K.keccak256_blocks(b, nb), "keccak256_blocks")
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
          "kernel_ms": k_ms,
          **k3})
    return k3


def k4_operands(dev):
    """Phase k4's operands (``alu_operands``: 4096 random rows and every
    pair of edge values) as (a, b, c) on ``dev``, and their integers."""
    import torch
    from coreth_tpu_torch.ops import u256
    rows = alu_operands(np.random.default_rng(SEED + 4), 4096)
    return (tuple(torch.from_numpy(x).to(dev) for x in rows),
            [u256.to_ints(x) for x in rows])


def k4_op_times(a, b, c, reps: int = 10) -> dict:
    """Per K4 op on (a, b, c): the wrapper's ms (CUDA events, median of
    3 x ``reps``), the kernel's device ms a launch (``torch.profiler``)
    and the wrapper's host ms a call (``reps`` calls on the host's
    clock)."""
    import torch
    from coreth_tpu_torch.ops import u256x
    out = {}
    for op in u256x.OPS:
        fn = (lambda op=op: u256x.eval_ops(op, a, b, c))
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = 1000 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
        out[op] = {"ms": float(np.median([cuda_ms(fn, reps=reps, warmup=1)
                                          for _ in range(3)])),
                   "kernel_ms": kernel_ms(fn, "u256x_eval", reps=reps),
                   "host_ms": host_ms}
    return out


def phase_k4(dev):
    """K4 against its plain version, every op, on ``k4_operands`` and
    the division family also on ``division_operands`` (the rare paths):
    tolerance 0.  Per op ``k4_op_times`` and the bound of this op's
    least work (``alu_ops``, ``alu_bytes``); the entry's ms and bound
    are the 24 ops' sums."""
    import torch
    from coreth_tpu_torch.ops import u256, u256x
    (a, b, c), ints = k4_operands(dev)
    dv = [u256.pack_np(x) for x in division_operands()]
    da, db, dc = (torch.from_numpy(x).to(dev) for x in dv)
    errs, plain_ms, n_ops = [], 0.0, 0
    for op in u256x.OPS:
        checks = [(a, b, c)] + ([(da, db, dc)] if op in (
            "div", "mod", "sdiv", "smod", "addmod", "mulmod") else [])
        for x, y, z in checks:
            got = u256x.eval_ops(op, x, y, z)
            want = u256x.eval_plain(op, x, y, z)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = (got != want).any(dim=1).nonzero()[:5].flatten()
                raise AssertionError(f"K4 {op} differs from the plain "
                                     f"version at rows {bad.tolist()}")
            errs.append(max_abs_err([got], [want]))
        plain_ms += once_ms(lambda: u256x.eval_plain(op, a, b, c))
    per_op = k4_op_times(a, b, c)
    by_sum = {"bytes": 0.0, "operations": 0.0}
    for op, r in per_op.items():
        ops = alu_ops(op, *ints)
        r["bound_ms"], r["bound_by"] = bound(alu_bytes(op, a.shape[0]), ops)
        by_sum[r["bound_by"]] += r["bound_ms"]
        n_ops += ops
    ms = sum(r["ms"] for r in per_op.values())
    kernel_sum = (None if any(r["kernel_ms"] is None
                              for r in per_op.values())
                  else round(sum(r["kernel_ms"] for r in per_op.values()),
                             4))
    for r in per_op.values():
        r.update((k, round(r[k], 6)) for k in ("ms", "kernel_ms",
                                               "host_ms", "bound_ms")
                 if r[k] is not None)
    k4 = {"name": "u256x_eval", "route": "cuda",
          "source": "coreth_tpu_torch/csrc/u256x_eval.cu",
          "replaces": "coreth_tpu/ops/u256x.py:30",
          "max_abs_err": max(errs), "ms": round(ms, 4),
          "plain_ms": round(plain_ms, 1),
          "bound_ms": round(sum(by_sum.values()), 5),
          "bound_by": max(by_sum, key=by_sum.get), "library_ms": None}
    emit({"phase": "k4", "equal": True, "rows": int(a.shape[0]),
          "division_rows": int(da.shape[0]), "ops": len(u256x.OPS),
          "int32_ops": n_ops, "per_op": per_op, "kernel_ms_sum": kernel_sum,
          "bound_ms_by": {k: round(v, 6) for k, v in by_sum.items()},
          "ms_is": "one launch of every op, summed; bound_ms the ops' "
          "bounds summed", **k4})
    return k4


def k5_batch(dev):
    """Phase k5's batch: 256 ``machine_lanes`` packed for K5 on
    ``dev``, as (params, inputs) of ``machine.run_machine``."""
    from coreth_tpu_torch.evm.device.adapter import BlockEnv, MachineRunner
    from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
    txs, resolve = machine_lanes(np.random.default_rng(SEED + 5), 256)
    env = BlockEnv(coinbase=b"\x01" + b"\x00" * 19, timestamp=3000,
                   number=5, gas_limit=15_000_000, chain_id=CFG.chain_id,
                   base_fee=25 * GWEI)
    runner = MachineRunner("durango", env, resolve, device=dev)
    p = runner._params(txs)
    return p, runner.pack(txs, p)


def phase_k5(dev):
    import torch
    from coreth_tpu_torch.evm.device import machine as M
    from coreth_tpu_torch.evm.device.adapter import PackedOut
    p, inputs = k5_batch(dev)
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
    lpc, ctas, smem, layout = M.machine_group(p, dev)
    emit({"phase": "k5", "equal": True, "batch": p.batch,
          "group": {"lanes_a_cta": lpc, "ctas": ctas,
                    "shared_bytes_a_cta": smem,
                    "layout": "shared" if layout else "device"},
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
    from coreth_tpu_torch.parallel import mesh as PM
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.replay import shard as SH
    E.LAUNCHES = S.LAUNCHES = M.LAUNCHES = M.OCC_LAUNCHES = 0
    M.SPEC_LAUNCHES = K.LAUNCHES = u256x.LAUNCHES = 0
    SH.LAUNCHES = S.SHARD_LAUNCHES = 0
    M.OCC_SHARDED_LAUNCHES = M.FLAGS_FILL_LAUNCHES = 0
    PM.TRANSFER_STEP_LAUNCHES = PM.SLOT_STEP_LAUNCHES = 0


def _read_launches() -> dict:
    from coreth_tpu_torch.evm.device import machine as M
    from coreth_tpu_torch.ops import keccak as K
    from coreth_tpu_torch.ops import secp as S
    from coreth_tpu_torch.ops import u256x
    from coreth_tpu_torch.parallel import mesh as PM
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.replay import shard as SH
    return {"step_machine": M.LAUNCHES, "occ_window": M.OCC_LAUNCHES,
            "occ_window_spec": M.SPEC_LAUNCHES,
            "secp_recover": S.LAUNCHES, "transfer_window": E.LAUNCHES,
            "keccak256_blocks": K.LAUNCHES, "u256x_eval": u256x.LAUNCHES,
            "sharded_window": SH.LAUNCHES,
            "sharded_recover": S.SHARD_LAUNCHES,
            "occ_sharded": M.OCC_SHARDED_LAUNCHES,
            "flags_fill": M.FLAGS_FILL_LAUNCHES,
            "sharded_transfer_step": PM.TRANSFER_STEP_LAUNCHES,
            "sharded_slot_step": PM.SLOT_STEP_LAUNCHES}


def close_engine(eng) -> None:
    """Close a replay engine and check that its supervisor never struck
    nor demoted a scope: outside phase faults no path may have reached
    the host by a fault."""
    eng.close()
    sup = eng.supervisor
    if sup.strikes or sup.demotions:
        caller = sys._getframe(1).f_code.co_name
        raise AssertionError(f"{caller}: the supervisor struck "
                             f"{sup.strikes} times, demoted "
                             f"{sup.demotions}: {sup.snapshot()}")


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
        targets += [(M, "run_occ_sharded")]
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
                  specialize: bool = False, mesh=None, shard_occ=True,
                  token_fastpath: bool = False,
                  slot_capacity: int = None):
    """Replay the ERC-20 chain from fresh decodes (no cached senders),
    the launch counters zeroed just before and read just after; returns
    the engine, the root, the replay's seconds, the launches and the
    steady-state split of ``_steady`` (on the window path with the host
    spans of ``HostSpans``).  The machine phases keep every token call
    on the machine (``token_fastpath=False``, as ``bench.py``'s
    erc20-machine sections set ``CORETH_NO_TOKEN_FASTPATH=1``); phase
    token takes the fast path."""
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
                         mesh=mesh, shard_occ=shard_occ,
                         token_fastpath=token_fastpath,
                         slot_capacity=slot_capacity)
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
    close_engine(eng)
    steady = _steady(folds, t0, txs)
    if spans is not None:
        steady["host_spans"] = spans.row()
    return eng, root, dt, launches, steady


# blocks of the ERC-20 chain phase machine replays per block on K5 (the
# window phases replay all 128)
MACHINE_BLOCKS = 64


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


def window_from_chain(dev, genesis, blocks, specialize: bool = False,
                      scache_cap: int = 0):
    """K6 window (a): the chain's first 8 blocks as a window runner
    packs them, with the premaps learned from one discovery pass of
    generic K6 over them; with ``specialize`` the packing runner gives
    the token lanes their traced program (K7 window (a)); with
    ``scache_cap`` the runner's sticky cache bucket starts there, as
    after an earlier tx whose premapped keys reached that bucket."""
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
    if scache_cap:
        runner._hw["scache_cap"] = scache_cap
    pk = runner.pack(items)
    close_engine(eng)
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


# where chip_smoke builds its instrumented copies of occ_window.cu
SPLIT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "coreth_tpu_torch", "csrc", "build", "split")


def start_split_builds():
    """``occ_split.py``'s instrumented copy of the generic K6 library
    (counters at the phase boundaries of occ_window.cu), its nvcc
    started now, beside the kernels' own builds."""
    from coreth_tpu_torch import kernels
    occ_split.instrument(kernels.CSRC, SPLIT_DIR)
    return occ_split.start(SPLIT_DIR, {
        "generic": os.path.join(SPLIT_DIR, "occ_window.cu")})


def window_split(lib, info_lib, pk, spec, got, n=1, sync=None) -> dict:
    """The launch's time split (instrumented copy, ``occ_split.split``),
    the group it runs on (``occ_group_info`` of the real library) and
    its cluster barriers by the kernel's formula (not counted)."""
    _b, _by, _steps, rounds = _window_bound(pk, got, n)
    return {"split_ms": occ_split.split(lib, pk, spec, n, sync),
            "group": occ_split.group(info_lib, pk, n),
            "barriers_per_window_formula": occ_split.barriers(
                rounds, 0 if sync is None else int(sync.shape[0]))}


def phase_k6(dev, genesis, blocks, split_lib):
    import torch
    from coreth_tpu_torch import kernels
    from coreth_tpu_torch.evm.device import machine as M
    rng = np.random.default_rng(SEED + 6)
    windows = {"a_erc20_chain": window_from_chain(dev, genesis, blocks),
               "b_swap_conflict": swap_window(dev),
               "c_escape_trailing": escape_window(dev, rng),
               # 256 lanes x 256 cache entries: the sweep's index
               # columns int32 and its area in device memory
               "d_wide_index": window_from_chain(dev, genesis, blocks[:2],
                                                 scache_cap=256)}
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
        if name == "d_wide_index" and (
                p.batch * p.scache_cap <= 32768 or rounds[:2] != [2, 2]):
            raise AssertionError(f"K6 wide window: {p.batch} x "
                                 f"{p.scache_cap}, rounds {rounds}")
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
    pk = windows["a_erc20_chain"]
    args = (pk["p"], pk["occ"], pk["table"], pk["key_tab"], pk["inputs"])
    split = window_split(split_lib, kernels.load("occ_window"), pk, (),
                         M.run_occ_window(*args))
    emit({"phase": "k6", "equal": True, "windows": rows,
          "window_a": split,
          "ptxas_generic": occ_split.ptxas_lines(
              kernels.log_path("occ_window")),
          "ms_is": "window (a), CUDA events around the wrapper", **k6})
    return k6


def phase_ptxas(spec) -> None:
    """``ptxas``'s registers, stack frame and spill bytes of the K4 and
    K3 entries, K5, generic K6 and window (a)'s K7 variant (``spec``),
    from their build logs (``occ_split.ptxas_report``)."""
    from coreth_tpu_torch.evm.device import specialize as SP
    emit({"phase": "ptxas",
          "kernels": occ_split.ptxas_report(SP.variant(spec)[0])})


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
    steady["txs_per_s"] = round(n_blocks * txs / dt, 1)
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
    # window (a)'s variant, instrumented, beside the variants' builds
    with open(os.path.join(SPLIT_DIR, "variant.cu"), "w") as f:
        f.write(SP.variant(sets["a_erc20_chain"])[1])
    split_build = occ_split.start(SPLIT_DIR, {
        "variant": os.path.join(SPLIT_DIR, "variant.cu")})
    t0 = time.monotonic()
    took = kernels.build_generated(dict(SP.variant(s)
                                        for s in set(sets.values())))
    build_s = time.monotonic() - t0
    split_lib = occ_split.finish(split_build)["variant"]
    variants = {name: SP.variant(spec)[0] for name, spec in sets.items()}
    ptxas = {v: occ_split.ptxas_lines(kernels.log_path(v))
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
            row.update(window_split(split_lib, SP.occ_library(spec), pk,
                                    spec, got))
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
          "ptxas_generic": occ_split.ptxas_lines(
              kernels.log_path("occ_window")),
          "ms_is": "window (a), CUDA events around the wrapper", **k7})
    return k7, split_lib, sets["a_erc20_chain"]


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
    design = SH.window_design(pad)
    shapes = {}
    for shape in ("hot", "pad_rows", "negative"):
        swin = shaped_window(np.random.default_rng(SEED + 8), shape, 8, pad,
                             pad * 3 // 4, cap=32768, scap=1024, n_acct=1500,
                             n_slot=40, L=2048, SL=64, t_pad=512, s_pad=64)
        for n in SHARD_WIDTHS:
            perm = SH.interleave_txs(pad, n)
            sw = swin[:5] + (np.ascontiguousarray(swin[5][:, perm]),) \
                + swin[6:]
            sargs = [torch.from_numpy(a).to(dev) for a in sw]
            for mode in ("psum", "ppermute"):
                got = SH.sharded_transfer_window(*sargs, n=n, mode=mode,
                                                 return_replicas=True)
                want = SH._sharded_window_plain(*sargs, n, mode,
                                                return_replicas=True)
                if not all(torch.equal(g, w) for g, w in
                           zip(got[:4] + got[4], want[:4] + want[4])):
                    raise AssertionError(f"K8 n={n} {mode} {shape}: differs "
                                         "from the plain version")
        shapes[shape] = {"K": 8, "pad": pad, "layout":
                         SH.window_design(pad)["layout"], "equal": True}
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
          "SL": SL, "design": design, "shapes": shapes,
          "k1_ms_same_window": round(k1_ms, 4), "widths": rows,
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
        close_engine(eng)
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
    close_engine(eng)
    return out


def phase_k9(dev, windows, split_libs):
    """K9 against its plain version on every window of
    ``sharded_windows``, in both modes, through the variant (K7 inside)
    and the generic library (every prog_id -1): tables and packed rows
    equal (tolerance 0), lane-steps too on the variant.  The plain
    version runs once per window: its result does not depend on the mode
    (integer sums and maxes; tests/test_torch_shard_occ.py holds both
    modes against the reference).  Returns (the kernels-line entry, the
    K9 outputs for phase k9x, the headline window's split).
    ``split_libs``: phase k6's and k7's
    instrumented libraries (the variant's program set under "spec"); the
    headline window's split runs on the variant when the window has that
    program set, else on the generic library with every prog_id -1."""
    import torch
    from coreth_tpu_torch.evm.device import machine as M
    from coreth_tpu_torch import kernels
    from coreth_tpu_torch.evm.device import specialize as SP
    rows, k9, outs, split = {}, None, {}, None
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
            outs[(n, keyrange, mode)] = (got["packed"], pk["inputs"]["active"],
                                         got["flags"], gen["flags"])
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
                if spec == split_libs["spec"]:
                    rows[key].update(window_split(
                        split_libs["variant"], SP.occ_library(spec), pk,
                        spec, got, n, sync))
                else:
                    rows[key].update(window_split(
                        split_libs["generic"], kernels.load("occ_window"),
                        dict(pk, inputs=gen_in), (), gen, n, sync))
                rows[key]["split_on"] = ("variant" if spec ==
                                         split_libs["spec"] else "generic")
                split = rows[key]["split_ms"]
            if keyrange == (sync is None):
                raise AssertionError(f"K9 n={n} keyrange={keyrange}: sync "
                                     f"rows {sync is not None}")
    k9["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    emit({"phase": "k9", "equal": True, "windows": rows,
          "ms_is": f"n={HEADLINE_WIDTH}, key range, psum, K7 variant, CUDA "
          "events around the wrapper", "bound_is": "K6's over the union of "
          "the shards' lanes and arenas", **k9})
    return k9, outs, split


def phase_k9x(dev, outs, k9_split):
    """The shards' flags reduce (the reference's K9x), K9's epilogue
    since it has no launch of its own: the (W, 2) flags of every K9
    output of phase k9 (n = 2, 4, 8; key range and bucket; psum and
    ppermute; the variant and the generic library) equal to
    ``shard_flags_plain`` of its packed rows (tolerance 0).  Its
    kernels-line entry keeps the bound (bytes: ``active`` read once, the
    active lanes' three flag columns, the flags written), with ms null;
    ``main`` sets its launches to the main path's launches of the one
    kernel whose only work is the flags (``flags_fill_kernel``, a window
    without lanes) and ``carried_by_k9`` to the main path's K9 launches,
    whose epilogue reduced the flags, both counted by the K9 wrapper;
    beside it K9's write-back split on phase k9's headline window (the
    epilogue's part of K9's time)."""
    import torch
    from coreth_tpu_torch.evm.device import machine as M
    rows, k9x, errs = {}, None, []
    for (n, keyrange, mode), (packed, active, flags, gen_flags) in \
            outs.items():
        t0 = time.perf_counter()
        want = M.shard_flags_plain(packed, active, n, mode)
        torch.cuda.synchronize()
        plain_ms = 1000 * (time.perf_counter() - t0)
        for what, got in (("variant", flags), ("generic", gen_flags)):
            if not torch.equal(got, want):
                raise AssertionError(f"K9's flags n={n} {mode} {what}: "
                                     f"{got.tolist()} != {want.tolist()}")
            errs.append(max_abs_err([got], [want]))
        W, NB = active.shape
        n_act = int((active != 0).sum())
        bound_ms, bound_by = bound(active.numel() * 4 + n_act * 3 * 4
                                   + W * 2 * 4, active.numel() + n_act * 3)
        key = f"n{n}_{'keyrange' if keyrange else 'bucket'}_{mode}"
        rows[key] = {"flags": flags.tolist(), "plain_ms": round(plain_ms, 3),
                     "bound_ms": round(bound_ms, 6), "bound_by": bound_by}
        if n == HEADLINE_WIDTH and keyrange and mode == "psum":
            k9x = {"name": "shard_flags", "route": "cuda",
                   "source": "coreth_tpu_torch/csrc/occ_window.cu",
                   "in": "K9 (occ_sharded_launch), the epilogue blk_flags",
                   "replaces": "coreth_tpu/evm/device/shard.py:267",
                   "ms": None, "plain_ms": round(plain_ms, 3),
                   "bound_ms": round(bound_ms, 6), "bound_by": bound_by,
                   "library_ms": None}
    k9x["max_abs_err"] = max(errs)
    emit({"phase": "k9x", "equal": True, "windows": rows,
          "ms_is": "none: K9's epilogue, no launch of its own",
          "k9_writeback_split_ms": None if k9_split is None
          else k9_split.get("writeback"), **k9x})
    return k9x


def check_last_window(eng, what: str) -> list:
    """The flags of the last window ``eng``'s sharded runner issued (K9's
    epilogue), equal to ``shard_flags_plain`` of its packed rows."""
    import torch
    from coreth_tpu_torch.evm.device import machine as M
    runner = eng._machine_executor()._runner
    h = getattr(runner, "last_handle", None)
    if h is None:
        raise AssertionError(f"{what}: no K9 launch")
    want = M.shard_flags_plain(h["out"]["packed"], h["active"],
                               runner.n_shards, h["xchg_mode"])
    if not torch.equal(h["ex"], want):
        raise AssertionError(f"{what}: the last window's flags "
                             f"{h['ex'].tolist()} != the plain version's "
                             f"{want.tolist()}")
    return want.tolist()


def phase_shard_erc20(dev, smi, genesis, blocks, txs: int, shard_occ: bool,
                      order: int):
    """The ERC-20 chain through the window path with K7 on a 4-shard
    engine: with ``shard_occ`` (the default) on the sharded runner (K9
    launched at least once a window, the flags of its last window equal
    to the plain version's, the single-chip K6/K7 never, the token hot:
    ``kr_lanes`` > 0), without it on the single-chip runner over the
    sharded tables (K9 never).  Root equal, no dirty block, no kernel
    built inside the timed replay.  ``order``: the run's place in the
    sharded/single A/B."""
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
    last_flags = None
    if shard_occ:
        ok = (launches["occ_sharded"] >= mc["windows"] >= 1
              and launches["occ_window_spec"] == 0
              and launches["occ_window"] == 0 and mc["kr_lanes"] > 0)
        last_flags = check_last_window(eng, f"shard_erc20 {name}")
    else:
        ok = (launches["occ_window_spec"] >= mc["windows"] >= 1
              and launches["occ_sharded"] == 0)
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
          "root_matches_header": True, "launches": launches,
          "last_window_flags": last_flags, "machine": mc,
          "stats": eng.stats.row(), "card": smi})
    return launches, steady


# ------------------------------------------------------ token fast path

def phase_token(dev, smi, genesis, blocks, txs: int, window_txs_per_s):
    """The ERC-20 chain through the token fast path (the reference's
    default for ``transfer()`` calls): every block classified on the host
    and replayed on the window kernels' slot half, on one shard (K1) and
    at n = 4 (K8), ``slot_capacity`` 1 << 14.  Root equal to the header,
    every block on the window path, the machine's kernels (K5, K6, K7,
    K9) never launched.  Prints txs/s beside phase window's on the same
    chain.  Returns {width: launches}."""
    from coreth_tpu_torch.parallel import make_mesh
    out = {}
    for n in (1, HEADLINE_WIDTH):
        eng, root, dt, launches, steady = _replay_erc20(
            dev, genesis, blocks, txs, device_occ=True, specialize=True,
            mesh=make_mesh(n) if n > 1 else None, token_fastpath=True,
            slot_capacity=1 << 14)
        if root != blocks[-1].header.root:
            raise AssertionError(f"token n={n}: final root differs from the "
                                 "header")
        if eng.stats.blocks_device != len(blocks) \
                or eng._machine is not None:
            raise AssertionError(f"token n={n}: {eng.stats.blocks_device} of "
                                 f"{len(blocks)} blocks on the window path")
        window_kernel = "transfer_window" if n == 1 else "sharded_window"
        machine = sum(launches[k] for k in (
            "step_machine", "occ_window", "occ_window_spec", "occ_sharded"))
        if launches[window_kernel] < 1 or machine:
            raise AssertionError(f"token n={n}: launches {launches}")
        emit({"phase": "token", "n_shards": n, "blocks": len(blocks),
              "txs_per_block": txs, "replay_s": round(dt, 4),
              "txs_per_s": round(len(blocks) * txs / dt, 1),
              "window_phase_txs_per_s": window_txs_per_s, **steady,
              "slots": len(eng.state.slot_keys) - 1,
              "storage_epoch": eng.storage_epoch,
              "root_matches_header": True, "launches": launches,
              "stats": eng.stats.row(), "card": smi})
        out[n] = launches
    return out


# ------------------------------------------------------------ K8s

def k8s_bound(rows: int, B: int, slot: bool):
    """(bound_ms, bound_by) of one K8s call: the table read and written
    once, each tx column read once; ~120 int32 operations a tx (the
    debit chain, the limb sums) and ~250 a row (three or two normalizes,
    the compare, the add and subtract chains)."""
    if slot:
        n_bytes = 4 * (2 * rows * 16 + B * (2 + 16 + 1)) + 4
    else:
        n_bytes = 4 * (2 * rows * 17 + B * (2 + 3 * 16 + 3)) + 4
    return bound(n_bytes, B * 120 + rows * 250)


def k8s_inputs(rng, A: int, S: int, B: int):
    """Random K8s inputs at the engine's table sizes: funded senders with
    nonces in sequence, fresh recipients, a coinbase, one masked tx in
    eight; token amounts between existing slots (slot 0 the dummy)."""
    from coreth_tpu_torch.ops import u256
    bal = u256.pack_np([int(v) << 80 for v in rng.integers(1, 1 << 60, A)])
    nonces = rng.integers(0, 1000, A).astype(np.int32)
    sender = rng.integers(0, A // 2, B).astype(np.int32)
    recip = rng.integers(0, A, B).astype(np.int32)
    value = [int(v) for v in rng.integers(0, 1 << 40, B)]
    fee = [21000 * int(p) for p in rng.integers(1, 1 << 38, B)]
    required = [21000 * (1 << 40) + v for v in value]
    offsets = np.zeros(B, dtype=np.int32)
    tx_nonce = np.zeros(B, dtype=np.int32)
    seen = {}
    for i, s in enumerate(sender):
        offsets[i] = seen.get(int(s), 0)
        tx_nonce[i] = nonces[s] + offsets[i]
        seen[int(s)] = offsets[i] + 1
    mask = (np.arange(B) % 8 != 7).astype(np.int32)
    transfer = (bal, nonces, sender, recip, u256.pack_np(value),
                u256.pack_np(fee), u256.pack_np(required), tx_nonce,
                offsets, mask)
    vals = u256.pack_np([int(v) << 60 for v in rng.integers(1, 1 << 60, S)])
    slot = (vals, rng.integers(1, S, B).astype(np.int32),
            rng.integers(1, S, B).astype(np.int32),
            u256.pack_np([int(v) for v in rng.integers(0, 1 << 50, B)]),
            mask)
    return transfer, int(rng.integers(0, A)), slot


K8S_SHAPES = ("same_sender", "all_masked", "negative")


def k8s_shaped(transfer, coinbase: int, slot, shape: str):
    """K8s's inputs (``k8s_inputs``' layout) reshaped for the kernel's
    corners.  "same_sender": every tx from one sender to the coinbase
    (one row takes every debit, the coinbase every credit and fee;
    nonces in sequence, the sender funded), every slot tx from one slot
    to another; "all_masked": every tx masked out, so no row is touched;
    "negative": the first tx, unmasked, sends from account -2 with the
    nonce of row A - 2, which differs from row 0's (a jnp gather wraps
    -2 to A - 2).  Returns copies (transfer, coinbase, slot)."""
    from coreth_tpu_torch.ops import u256
    t = [np.array(a, copy=True) for a in transfer]
    s = [np.array(a, copy=True) for a in slot]
    bal, nonces, sender, recip, _v, _f, _r, tx_nonce, offsets, mask = t
    A = bal.shape[0]
    if shape == "same_sender":
        s0 = int(sender[0])
        sender[:] = s0
        recip[:] = coinbase
        bal[s0] = u256.pack_np([1 << 200])[0]
        offsets[:] = np.cumsum(mask != 0) - (mask != 0)
        tx_nonce[:] = nonces[s0] + offsets
        f0, t0 = int(s[1][0]), int(s[2][0])
        s[1][:], s[2][:] = f0, t0
        s[0][f0] = u256.pack_np([1 << 200])[0]
    elif shape == "all_masked":
        mask[:] = 0
        s[4][:] = 0
    elif shape == "negative":
        nonces[A - 2] = nonces[0] + 3
        sender[0], offsets[0], mask[0] = -2, 0, 1
        tx_nonce[0] = nonces[A - 2]
    else:
        raise ValueError(f"k8s_shaped: unknown shape {shape!r}")
    return t, coinbase, s


def classified_step_inputs(dev, genesis, blocks, txs: int):
    """K8s's inputs from a real block: the ERC-20 chain's first block
    classified by a token-path engine on the card, in global rows over
    the engine's tables (A = capacity, S = slot_capacity, B = the block's
    txs)."""
    import torch
    from coreth_tpu_torch.ops import u256
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    block = Block.decode(blocks[0].encode())
    store = StateStore()
    gblock = genesis.to_block(store)
    eng = E.ReplayEngine(genesis.config, store, parent_header=gblock.header,
                         batch_pad=txs, slot_capacity=1 << 14, device=dev)
    eng.warm_senders(block)
    batch = eng._classify(block)
    close_engine(eng)
    if batch is None or not any(batch["amounts"]):
        raise AssertionError("k8s: the chain's first block is not a token "
                             "fast-path block")
    st = eng.state
    st.flush_staged()
    rows = np.asarray(st.row_of, dtype=np.int32)
    srows = np.asarray(st.slot_row_of, dtype=np.int32)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    B = len(block.transactions)
    transfer = [st.balances, st.nonces] + [up(a) for a in (
        rows[batch["senders"]], rows[batch["recips"]],
        u256.pack_np(batch["values"]), u256.pack_np(batch["fees"]),
        u256.pack_np(batch["required"]),
        np.asarray(batch["nonces"], np.int32),
        np.asarray(batch["offsets"], np.int32), np.ones(B, bool))]
    slot = [st.slot_vals] + [up(a) for a in (
        srows[batch["from_slots"]], srows[batch["to_slots"]],
        u256.pack_np(batch["amounts"]), np.ones(B, bool))]
    return transfer, int(rows[batch["coinbase"]]), slot


def phase_k8s(dev, smi, genesis, blocks, txs: int, rng, split_lib):
    """K8s (the per-block sharded transfer and slot steps, one row-parallel
    launch each over every SM, the same launch at every n) against their
    plain versions (which run shard by shard) on random inputs at A = S =
    16384 (the capacity and slot_capacity floor of bench.py:570-575) and
    B = 512 (the largest protocol-valid transfer block) at n = 2, 4 and
    8, bit for bit, and on the same inputs reshaped by ``k8s_shaped``
    (one sender paying the coinbase, every tx masked, sender -2); the
    split by phase of each step at n = 4 (``window_split.k8s_split``'s
    instrumented copy, ``split_lib``: the longest CTA's load, sums, rows
    and store, the launch's span) beside the wrapper's host ms a call;
    then the path: the launch counters zeroed, one call of each at n = 4
    through ``sharded_transfer_step(make_mesh(4), A)`` /
    ``sharded_slot_step`` fed by a real classified block of the ERC-20
    chain, the counters read, the results equal to the single-chip plain
    steps (``_transfer_step_plain``, ``_slot_step_plain``).  ms (CUDA
    events around the wrapper) at every n and on each shape, plain ms,
    bound, the launch's design."""
    import torch
    import window_split
    from coreth_tpu_torch import parallel as P
    from coreth_tpu_torch.replay import engine as E
    A = S = 1 << 14
    B = 512
    t_np, coinbase, s_np = k8s_inputs(rng, A, S, B)
    inputs = {"random": (t_np, coinbase, s_np)}
    for shape in K8S_SHAPES:
        inputs[shape] = k8s_shaped(t_np, coinbase, s_np, shape)
    rows, errs, heads, split = {}, {"transfer": 0, "slot": 0}, {}, {}
    for shape, (tn, cb, sn) in inputs.items():
        targs = [torch.from_numpy(a).to(dev) for a in tn] + [cb]
        sargs = [torch.from_numpy(a).to(dev) for a in sn]
        for n in SHARD_WIDTHS:
            mesh = P.make_mesh(n)
            for name, fn, plain, args in (
                    ("transfer", P.sharded_transfer_step(mesh, A),
                     P.sharded_transfer_step_plain, targs),
                    ("slot", P.sharded_slot_step(mesh, S),
                     P.sharded_slot_step_plain, sargs)):
                got = fn(*args)
                t0 = time.perf_counter()
                want = plain(*args, n)
                torch.cuda.synchronize()
                plain_ms = 1000 * (time.perf_counter() - t0)
                for g, w in zip(got, want):
                    if not torch.equal(g, w):
                        bad = (g != w).nonzero()[:5].tolist()
                        raise AssertionError(
                            f"K8s {name} n={n} {shape}: differs from the "
                            f"plain version at {bad}")
                if not bool(got[-1]):
                    raise AssertionError(f"K8s {name} n={n} {shape}: ok is "
                                         "False on valid inputs")
                errs[name] = max(errs[name], max_abs_err(got, want))
                if shape != "random" and n != HEADLINE_WIDTH:
                    continue
                ms = cuda_ms(lambda: fn(*args), reps=20)
                rows[f"{name}_{shape}_n{n}"] = {
                    "ms": round(ms, 4), "plain_ms": round(plain_ms, 2)}
                if n == HEADLINE_WIDTH and shape == "random":
                    heads[name] = (ms, plain_ms)
                    split[name] = window_split.k8s_split(
                        split_lib, fn, args, plain, n)
                    split[name]["host_ms"] = round(
                        window_split.host_ms(lambda: fn(*args)), 4)
    # the path: a real classified block through the entry points at n = 4
    tr, cb, sl = classified_step_inputs(dev, genesis, blocks, txs)
    mesh = P.make_mesh(HEADLINE_WIDTH)
    _zero_launches()
    got_t = P.sharded_transfer_step(mesh, tr[0].shape[0])(*tr, cb)
    got_s = P.sharded_slot_step(mesh, sl[0].shape[0])(*sl)
    torch.cuda.synchronize()
    launches = _read_launches()
    want_t = E._transfer_step_plain(*tr, cb, tr[0].shape[0])
    want_s = E._slot_step_plain(*sl, sl[0].shape[0])
    for g, w, what in zip(got_t + got_s, want_t + want_s,
                          ("balances", "nonces", "ok", "slot values",
                           "slot ok")):
        if not torch.equal(g, w):
            raise AssertionError(f"K8s on the classified block: {what} "
                                 "differ from the single-chip plain step")
    if not (bool(got_t[2]) and bool(got_s[1])):
        raise AssertionError("K8s on the classified block: ok is False")
    if launches["sharded_transfer_step"] != 1 \
            or launches["sharded_slot_step"] != 1:
        raise AssertionError(f"K8s path launches: {launches}")
    errs["transfer"] = max(errs["transfer"], max_abs_err(got_t, want_t))
    errs["slot"] = max(errs["slot"], max_abs_err(got_s, want_s))
    out = []
    for name, src_line, slot in (("transfer", 93, False),
                                 ("slot", 166, True)):
        ms, plain_ms = heads[name]
        b_ms, b_by = k8s_bound(A, B, slot)
        out.append({
            "name": f"sharded_{name}_step", "route": "cuda",
            "source": "coreth_tpu_torch/csrc/sharded_step.cu",
            "replaces": f"coreth_tpu/parallel/mesh.py:{src_line}",
            "launches": launches[f"sharded_{name}_step"],
            "max_abs_err": errs[name], "ms": round(ms, 4),
            "plain_ms": round(plain_ms, 2), "bound_ms": round(b_ms, 6),
            "bound_by": b_by, "library_ms": None})
    emit({"phase": "k8s", "equal": True, "A": A, "S": S, "B": B,
          "shapes": ["random", *K8S_SHAPES], "calls": rows,
          "split_n4": split,
          "design": {"transfer": P.step_design(A),
                     "slot": P.step_design(S, slot=True)},
          "classified_block_txs": int(tr[2].shape[0]),
          "classified_block_equal_to_single_chip": True,
          "launches": launches,
          "ms_is": f"n={HEADLINE_WIDTH}, random, CUDA events around the "
          "wrapper, median of 20", "kernels": out, "card": smi})
    return out


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
    range), K9 launched (the flags of its last window equal to the plain
    version's) and the single-chip K6/K7 not.  Returns ({n: launches},
    (genesis, the blocks' encodings)) for phase faults."""
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
                             mesh=make_mesh(n) if n > 1 else None,
                             token_fastpath=False)
        A.RECIPES.clear()
        _zero_launches()
        eng.replay_block(fresh[0])
        t1 = time.monotonic()
        root = eng.replay(fresh[1:])
        torch.cuda.synchronize()
        dt = time.monotonic() - t1
        launches = _read_launches()
        close_engine(eng)
        mc = eng.machine_counters()
        if root != fresh[-1].header.root:
            raise AssertionError(f"hot n={n}: final root differs from the "
                                 "header")
        if mc["blocks"] != len(fresh) or mc["dirty_blocks"]:
            raise AssertionError(f"hot n={n}: {mc['blocks']} machine "
                                 f"blocks, {mc['dirty_blocks']} dirty")
        last_flags = None
        if n > 1:
            ok = (launches["occ_sharded"] >= mc["windows"] >= 1
                  and mc["kr_lanes"] > 0
                  and launches["occ_window"] + launches["occ_window_spec"]
                  == 0)
            last_flags = check_last_window(eng, f"hot n={n}")
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
              "last_window_flags": last_flags, "machine": mc,
              "stats": eng.stats.row(), "card": smi})
        out[n] = launches
    return out, (genesis, wire)


# ------------------------------------------------------ the host path
# phase host: the transfer chain with two rewinds, the ERC-20 chain with
# a dirty block, the swap chain on the serial short-circuit
HOST_XFER_BLOCKS, HOST_XFER_TXS, HOST_XFER_KEYS = 64, 128, 1024
HOST_REWIND_BLOCKS = (20, 40)
HOST_ERC20_BLOCKS, HOST_ERC20_TXS, HOST_DIRTY_BLOCK = 24, 256, 10
HOST_SWAP_BLOCKS, HOST_SWAP_TXS = 8, 256
ESCAPER = bytes([0x76]) * 20
# MSTORE at 5000: past the window lanes' 4096 bytes of memory, so the
# lane escapes (HOST) on the device; the native session runs it
ESCAPER_CODE = bytes.fromhex("600061138852" + "00")
POOL = bytes([0x74]) * 20


def build_host_chains(xfer=(HOST_XFER_BLOCKS, HOST_XFER_TXS, HOST_XFER_KEYS),
                      erc20=(HOST_ERC20_BLOCKS, HOST_ERC20_TXS),
                      swap=(HOST_SWAP_BLOCKS, HOST_SWAP_TXS),
                      rewinds=HOST_REWIND_BLOCKS,
                      dirty=HOST_DIRTY_BLOCK):
    """The three chains of phase host, all built by the port's chain
    builder (sequential semantics on Python ints and the native session,
    never the Processor the replay falls back to), from one genesis:
    ``xfer[2]`` funded keys, two poorly funded ones, the token, the pool
    and the escaper.  Returns (genesis, {name: blocks}).

    - transfers: each key pays fresh recipients; in each block of
      ``rewinds`` a rich key pays a poor one 3e23 and the poor one pays
      out 1.5e23 in the same block (valid in order, past its
      pre-block balance, so the device rejects the block);
    - erc20: the benchmark's ERC-20 shape, with one call into the
      escaper replacing the last tx of block ``dirty``;
    - swap: every tx a swap into the one pool (constant storage keys)."""
    from coreth_tpu_torch.chain import Genesis, GenesisAccount, generate_chain
    from coreth_tpu_torch.crypto.secp256k1 import priv_to_address
    from coreth_tpu_torch.params import TEST_CHAIN_CONFIG as CFG
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import DynamicFeeTx, sign_tx
    from coreth_tpu_torch.workloads.erc20 import (
        token_genesis_account, transfer_calldata)
    from coreth_tpu_torch.workloads.swap import (
        pool_genesis_account, swap_calldata)
    n_keys = xfer[2]
    keys = [0xB0B000 + i for i in range(n_keys)]
    poor_keys = [0xB0A000 + i for i in range(len(rewinds))]
    addrs = [priv_to_address(k) for k in keys]
    poor = [priv_to_address(k) for k in poor_keys]
    alloc = {a: GenesisAccount(balance=10**27) for a in addrs}
    for a in poor:
        alloc[a] = GenesisAccount(balance=10**17)
    alloc[TOKEN] = token_genesis_account({a: 10**24 for a in addrs})
    alloc[POOL] = pool_genesis_account(10**30, 10**30)
    alloc[ESCAPER] = GenesisAccount(balance=0, nonce=1, code=ESCAPER_CODE)
    genesis = Genesis(config=CFG, gas_limit=8_000_000, alloc=alloc)
    store = StateStore()
    parent = genesis.to_block(store)
    nonces = {k: 0 for k in keys + poor_keys}
    big = 3 * 10**23

    def add(bg, key, to, value=0, data=b"", gas=21_000):
        bg.add_tx(sign_tx(DynamicFeeTx(
            chain_id_=CFG.chain_id, nonce=nonces[key], gas_tip_cap_=GWEI,
            gas_fee_cap_=2000 * GWEI, gas=gas, to=to, value=value,
            data=data), key, CFG.chain_id))
        nonces[key] += 1

    def gen_xfer(i, bg):
        txs = xfer[1]
        if i in rewinds:
            p = rewinds.index(i)
            add(bg, keys[p], poor[p], big)
            add(bg, poor_keys[p], addrs[(p + 7) % n_keys], big // 2)
            txs -= 2
        for j in range(txs):
            n = i * xfer[1] + j
            add(bg, keys[n % n_keys],
                b"\xe0" + n.to_bytes(4, "big") * 4 + b"\xe0" * 3,
                10**12 + j)

    def gen_erc20(i, bg):
        txs = erc20[1]
        for j in range(txs):
            k = keys[(i * txs + j) % n_keys]
            if i == dirty and j == txs - 1:
                add(bg, k, ESCAPER, gas=100_000)
                continue
            to = addrs[(keys.index(k) + 1) % n_keys] if j % 3 == 0 \
                else (0x5000 + (i * 7 + j) % 1999).to_bytes(2, "big") * 10
            add(bg, k, TOKEN, data=transfer_calldata(to, 10 + j),
                gas=100_000)

    def gen_swap(i, bg):
        for j in range(swap[1]):
            add(bg, keys[(i * swap[1] + j) % n_keys], POOL,
                data=swap_calldata(10**6 + 31 * i + j), gas=200_000)

    chains = {}
    for name, n, gen in (("transfers", xfer[0], gen_xfer),
                         ("erc20", erc20[0], gen_erc20),
                         ("swap", swap[0], gen_swap)):
        blocks, _ = generate_chain(CFG, parent, store, n, gen, gap=10)
        chains[name] = blocks
        parent = blocks[-1]
    return genesis, chains


def _host_engine(dev, genesis, parent, store, txs: int, **kw):
    from coreth_tpu_torch.replay import engine as E
    return E.ReplayEngine(genesis.config, store, parent_header=parent,
                          batch_pad=txs, capacity=1 << 14, device=dev, **kw)


def phase_host(dev, smi, sizes=None):
    """The exact host path under the device paths, on chains of the
    port's own builder (``build_host_chains``), each replayed from fresh
    decodes with the launch counters zeroed just before and read just
    after, the root held to the last header's:

    - transfers (128 txs a block, 1,024 keys, ``window=128``): the two
      rewind blocks fail the device's solvency check; each rewinds its
      window, re-applies the valid prefix on K1 (a launch with no
      fetch, timed with the card synchronised around it) and runs on
      the Processor: ``blocks_fallback`` = 2, K1 launched for the
      windows and for each re-apply;
    - erc20 (256 txs a block, ``specialize=True``, the token on the
      machine): the escaper's lane dirties its block, the per-block path
      (K5) meets the same escape, and the block runs on the Processor;
      K7 windows launch before the host path takes it and after;
    - swap (256 txs a block, the engine's defaults): every block on the
      serial short-circuit, no step-machine or window launch.

    Each run prints its counters, launches, seconds and the card.
    ``sizes`` (keyword arguments of ``build_host_chains``) shrinks the
    chains for a check of the phase off the card."""
    import torch
    from coreth_tpu_torch.evm.device import adapter as A
    from coreth_tpu_torch.evm.device import machine as M
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    sizes = sizes or {}
    dev = torch.device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.monotonic()
    genesis, chains = build_host_chains(**sizes)
    t_build = round(time.monotonic() - t0, 2)
    store = StateStore()
    parent = genesis.to_block(store).header
    out = {}
    for name in ("transfers", "erc20", "swap"):
        blocks = chains[name]
        fresh = [Block.decode(b.encode()) for b in blocks]
        txs = len(blocks[0].transactions)
        if name == "transfers":
            eng = _host_engine(dev, genesis, parent, store, txs, window=128)
        elif name == "erc20":
            eng = _host_engine(dev, genesis, parent, store, txs, window=16,
                               specialize=True, token_fastpath=False)
        else:
            eng = _host_engine(dev, genesis, parent, store, txs, window=16)
        reapply_ms, at_fallback = [], []
        issue, fallback = eng._issue_window_run, eng._fallback

        def spy_issue(items, fetch=True):
            if fetch:
                return issue(items, fetch)
            sync()
            t1 = time.monotonic()
            r = issue(items, fetch)
            sync()
            reapply_ms.append(round(1000 * (time.monotonic() - t1), 4))
            return r

        def spy_fallback(block):
            at_fallback.append(dict(_read_launches()))
            return fallback(block)

        eng._issue_window_run, eng._fallback = spy_issue, spy_fallback
        A.RECIPES.clear()
        _zero_launches()
        t1 = time.monotonic()
        root = eng.replay(fresh)
        sync()
        dt = time.monotonic() - t1
        launches = _read_launches()
        close_engine(eng)
        st = eng.stats
        mc = eng.machine_counters() if eng._machine is not None else {}
        if root != blocks[-1].header.root or store.trie.hash() != root:
            raise AssertionError(f"host {name}: final root differs from the "
                                 "header")
        if name == "transfers":
            ok = (st.blocks_fallback == len(HOST_REWIND_BLOCKS)
                  == len(reapply_ms)
                  and launches["transfer_window"] == 1 + 2 * len(reapply_ms)
                  and st.blocks_device == len(blocks) - st.blocks_fallback)
        elif name == "erc20":
            before = at_fallback[0]["occ_window_spec"] if at_fallback else 0
            ok = (st.blocks_fallback == 1 and mc["dirty_blocks"] == 1
                  and mc["blocks"] == len(blocks) - 1
                  and before >= 1
                  and launches["occ_window_spec"] > before
                  and launches["step_machine"] >= 1)
        else:
            ok = (mc["serial_blocks"] == len(blocks) == mc["blocks"]
                  and st.blocks_fallback == 0
                  and launches["occ_window"] == 0
                  and launches["occ_window_spec"] == 0
                  and launches["step_machine"] == 0)
        row = {"phase": "host", "chain": name, "blocks": len(blocks),
               "txs_per_block": txs, "chain_build_s": t_build,
               "replay_s": round(dt, 4),
               "txs_per_s": round(len(blocks) * txs / dt, 1),
               "blocks_fallback": st.blocks_fallback,
               "t_fallback": round(st.t_fallback, 4),
               "fallback_s_per_block": round(
                   st.t_fallback / st.blocks_fallback, 4)
               if st.blocks_fallback else None,
               "reapply_ms": reapply_ms,
               "launches_at_fallback": at_fallback,
               "root_matches_header": True, "launches": launches,
               "machine": {k: mc[k] for k in (
                   "blocks", "dirty_blocks", "host_txs", "native_txs",
                   "serial_blocks", "windows", "rounds")} if mc else None,
               "stats": st.row(), "card": smi}
        emit(row)
        if not ok:
            raise AssertionError(f"host {name}: {row}")
        out[name] = row
        parent = blocks[-1].header
    return out


MIXED_BLOCKS, MIXED_TXS, MIXED_KEYS = 128, 32, 64


def phase_mixed(dev, smi, n_blocks=MIXED_BLOCKS, txs=MIXED_TXS,
                n_keys=MIXED_KEYS):
    """The Avalanche-semantics segment (BASELINE config 4, the bench's
    ``mixed`` shape: ``TEST_APRICOT_PHASE5_CONFIG``, 64 keys, 128 blocks
    x 32 txs, an atomic ExtData import every 8th block, a
    ``nativeAssetCall`` block at i % 8 == 1, i > 1), built by the port's
    builder with the atomic callbacks (``workloads/mixed.py``) and
    replayed from fresh decodes by a ``ReplayEngine(engine=...)`` over
    a freshly seeded hub (``window=128``), the launch counters zeroed
    just before and read just after.  The root must equal the last
    header's, the import and nativeAssetCall blocks (16 + 15) take the
    host path and the other 97 the device, K1 and K2 launch, the asset
    recipient holds the nativeAssetCall amounts and the backend holds
    each import block pending.  Prints txs/s, ``t_fallback``, seconds a
    host-path block of each kind and the launches.  The sizes shrink
    for a check off the card."""
    import torch
    from coreth_tpu_torch.params import TEST_APRICOT_PHASE5_CONFIG as CFG
    from coreth_tpu_torch.state import StateDB
    from coreth_tpu_torch.types import Block
    from coreth_tpu_torch.workloads import mixed as MX
    dev = torch.device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    keys = [0xB0B + i for i in range(n_keys)]
    t0 = time.monotonic()
    genesis, blocks = MX.build_mixed_chain(CFG, n_blocks, txs, keys)
    t_build = time.monotonic() - t0
    fresh = [Block.decode(b.encode()) for b in blocks]
    imports = [i for i in range(n_blocks) if i % MX.IMPORT_EVERY == 0]
    nacs = [i for i in range(n_blocks) if i % MX.NAC_EVERY == 1 and i > 1]
    eng, _gb, backend = MX.replay_engine(genesis, n_blocks, keys[0],
                                         device=dev, window=128,
                                         batch_pad=txs)
    host_s = {"import": [], "nativeAssetCall": []}
    fallback = eng._fallback

    def timed_fallback(block):
        t1 = time.monotonic()
        root = fallback(block)
        host_s["import" if block.ext_data() else
               "nativeAssetCall"].append(time.monotonic() - t1)
        return root

    eng._fallback = timed_fallback
    _zero_launches()
    t1 = time.monotonic()
    root = eng.replay(fresh)
    sync()
    dt = time.monotonic() - t1
    launches = _read_launches()
    close_engine(eng)
    st = eng.stats
    asset = StateDB(eng.store).get_balance_multi_coin(MX.ASSET_RECIPIENT,
                                                      MX.ASSET)
    n_txs = sum(len(b.transactions) for b in blocks)
    row = {"phase": "mixed", "blocks": n_blocks, "txs_per_block": txs,
           "keys": n_keys, "txs": n_txs, "chain_build_s": round(t_build, 2),
           "replay_s": round(dt, 4), "txs_per_s": round(n_txs / dt, 1),
           "blocks_fallback": st.blocks_fallback,
           "blocks_device": st.blocks_device,
           "t_fallback": round(st.t_fallback, 4),
           "host_s_per_block": {k: round(sum(v) / len(v), 4) if v else None
                                for k, v in host_s.items()},
           "host_blocks": {k: len(v) for k, v in host_s.items()},
           "launches": {k: launches[k] for k in ("transfer_window",
                                                 "secp_recover")},
           "asset_recipient_balance": asset,
           "pending_blocks": len(backend._pending),
           "stats": st.row(), "card": smi}
    emit(row)
    ok = (root == blocks[-1].header.root == eng.store.trie.hash()
          and st.blocks_fallback == len(imports) + len(nacs)
          and st.blocks_device == n_blocks - st.blocks_fallback
          and len(host_s["import"]) == len(imports)
          and len(host_s["nativeAssetCall"]) == len(nacs)
          and launches["transfer_window"] >= 1
          and launches["secp_recover"] >= 1
          and asset == sum(100 + i for i in nacs)
          and len(backend._pending) == len(imports))
    if not ok:
        raise AssertionError(f"mixed: {row}")
    return row


REHASH_KEYS, REHASH_UPDATES = 65_536, 8_192
REHASH_CROSSOVER = (256, 1_024, 4_096, 16_384, 65_536)


def _rehash_trie(n: int, seed: int = 0):
    """A SecureTrie of ``n`` keys filled as tests/test_replay.py:201
    fills its 3,000 (``seed`` shifts the keys)."""
    from coreth_tpu_torch.mpt import SecureTrie
    t = SecureTrie()
    for i in range(seed, seed + n):
        t.update(i.to_bytes(20, "big"), (b"\x01" + i.to_bytes(8, "big")) * 4)
    return t


def _hashed_encodings(trie) -> dict:
    """{depth: the memoized encodings of 32 bytes or more of ``trie``'s
    resident nodes at that depth}: every message its last rehash
    hashed, a level a list."""
    out, stack = {}, [(trie.root, 0)]
    while stack:
        node, depth = stack.pop()
        if node is None or node[0] == "H" or node[3] is None:
            continue
        if len(node[3][0]) >= 32:
            out.setdefault(depth, []).append(node[3][0])
        if node[0] == "E":
            stack.append((node[2], depth + 1))
        elif node[0] == "B":
            stack.extend((c, depth + 1) for c in node[1])
    return out


def phase_rehash(dev, smi, n_keys=REHASH_KEYS, n_update=REHASH_UPDATES,
                 crossover=REHASH_CROSSOVER):
    """The batched trie rehash (``mpt/rehash.py device_rehash``) on K3's
    entry: two SecureTries of ``n_keys`` keys; ``device_rehash(t1,
    min_batch=64)`` must equal ``t2.hash()``, then again after
    ``n_update`` keys change in both, the counters zeroed and read
    around each.  Then K3 against its plain version on every encoding
    the rehash hashed, a level a call (tolerance 0); on the largest
    level its ms, kernel ms, plain ms and bound.
    Prints the entry's launches, device and host milliseconds and the
    dirty nodes a level; then the host-against-device crossover: tries of
    ``crossover`` keys, ``trie.hash()`` (the host's C++ keccak) against
    ``device_rehash(min_batch=0)`` (every level on the card), the best
    of two fresh tries each."""
    import torch
    from coreth_tpu_torch.mpt.rehash import collect_dirty, device_rehash
    from coreth_tpu_torch.ops import keccak as K
    dev = torch.device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t1, t2 = _rehash_trie(n_keys), _rehash_trie(n_keys)
    per_level = {}
    for _n, d in collect_dirty(t1):
        per_level[d] = per_level.get(d, 0) + 1
    rounds = []
    for label in ("full", "update"):
        if label == "update":
            for i in range(n_update):
                for t in (t1, t2):
                    t.update(i.to_bytes(20, "big"), b"\x99" * 40)
        n_dirty = len(collect_dirty(t1))
        _zero_launches()
        sync()
        t0 = time.perf_counter()
        root = device_rehash(t1, min_batch=64, device=dev)
        sync()
        device_ms = 1000 * (time.perf_counter() - t0)
        launches = _read_launches()["keccak256_blocks"]
        t0 = time.perf_counter()
        want_root = t2.hash()
        host_ms = 1000 * (time.perf_counter() - t0)
        if root != want_root or launches < 1:
            raise AssertionError(f"rehash {label}: root equal "
                                 f"{root == want_root}, {launches} launches")
        rounds.append({"round": label, "dirty": n_dirty,
                       "k3_launches": launches,
                       "device_ms": round(device_ms, 3),
                       "host_ms": round(host_ms, 3)})
    # K3 against its plain version on every level the rehash hashed;
    # timed on the largest, the path's largest launch
    levels = _hashed_encodings(t1)
    largest = max(levels, key=lambda d: len(levels[d]))
    for depth in levels:
        row = k3_on_messages(dev, levels[depth], f"rehash depth {depth}",
                             timed=depth == largest)
        if depth == largest:
            k3_level = dict(row, depth=depth)
    cross = []
    device_rehash(_rehash_trie(256, seed=1 << 30), min_batch=0, device=dev)
    for n in crossover:
        host, device, n_dirty = [], [], 0
        for rep in range(2):
            t = _rehash_trie(n, seed=(rep + 1) << 24)
            t0 = time.perf_counter()
            t.hash()
            host.append(time.perf_counter() - t0)
            t = _rehash_trie(n, seed=(rep + 1) << 24)
            n_dirty = len(collect_dirty(t))
            sync()
            t0 = time.perf_counter()
            device_rehash(t, min_batch=0, device=dev)
            sync()
            device.append(time.perf_counter() - t0)
        cross.append({"keys": n, "dirty": n_dirty,
                      "host_s": round(min(host), 4),
                      "device_s": round(min(device), 4),
                      "winner": "device" if min(device) < min(host)
                      else "host"})
    row = {"phase": "rehash", "keys": n_keys, "updated": n_update,
           "k3_equal_messages": sum(len(v) for v in levels.values()),
           "k3_largest_level": k3_level, "dirty_per_level": [
               per_level[d] for d in sorted(per_level)],
           "rounds": rounds, "crossover": cross, "card": smi}
    emit(row)
    return sum(r["k3_launches"] for r in rounds), k3_level


def k3_on_messages(dev, msgs, what: str, timed: bool = True) -> dict:
    """K3's entry against its plain version on ``msgs`` (one call each,
    tolerance 0); on the card with ``timed`` also its ms (CUDA events),
    kernel ms (``torch.profiler``), plain ms and bound."""
    import torch
    from coreth_tpu_torch.ops import keccak as K
    blocks, nblocks = K.pack_blocks(msgs)
    b = torch.from_numpy(blocks).to(dev)
    nb = torch.from_numpy(nblocks).to(dev)
    got, want = K.keccak256_blocks(b, nb), K.keccak256_blocks_plain(b, nb)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: K3 differs from its plain version")
    row = {"messages": len(msgs), "blocks": int(nblocks.sum()),
           "max_abs_err": max_abs_err([got], [want])}
    if timed and dev.type == "cuda":
        bound_ms, bound_by = bound(
            blocks.nbytes + nblocks.nbytes + got.numel() * 4,
            KECCAK_OPS_PER_BLOCK * int(nblocks.sum()))
        row.update(
            ms=round(cuda_ms(lambda: K.keccak256_blocks(b, nb)), 4),
            kernel_ms=kernel_ms(lambda: K.keccak256_blocks(b, nb),
                                "keccak256_blocks"),
            plain_ms=round(once_ms(
                lambda: K.keccak256_blocks_plain(b, nb)), 2),
            bound_ms=round(bound_ms, 5), bound_by=bound_by)
    return row


# ------------------------------------------- the Python-trie fold (18)

class LevelRecorder:
    """Records, over one replay, every level ``mpt/rehash.py`` hashes on
    K3's entry (``hash_on_device`` wrapped in place until ``close``):
    the calls, messages, and the largest level's messages."""

    def __init__(self):
        from coreth_tpu_torch.mpt import rehash as R
        self._mod, self._fn = R, R.hash_on_device
        self.calls = self.messages = 0
        self.largest: list = []

        def recorded(msgs, device):
            self.calls += 1
            self.messages += len(msgs)
            if len(msgs) > len(self.largest):
                self.largest = list(msgs)
            return self._fn(msgs, device)
        R.hash_on_device = recorded

    def close(self) -> None:
        self._mod.hash_on_device = self._fn


def replay_fresh(dev, genesis, wire, what: str, quiet: bool = True, **kw):
    """``wire`` decoded afresh (no cached senders) and replayed through
    ``ReplayEngine(**kw)`` on a fresh store of ``genesis``, the launch
    counters zeroed just before the replay and read just after; the
    final root must equal the last header's.  ``quiet``: the supervisor
    must not have struck (``close_engine``).  Returns (engine, seconds,
    launches)."""
    import torch
    from coreth_tpu_torch.evm.device import adapter as A
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    fresh = [Block.decode(w) for w in wire]
    store = StateStore(backend=kw.get("trie", "native"),
                       check=kw.get("trie_check", False))
    gblock = genesis.to_block(store)
    eng = E.ReplayEngine(genesis.config, store, parent_header=gblock.header,
                         device=dev, **kw)
    A.RECIPES.clear()
    _zero_launches()
    t0 = time.monotonic()
    root = eng.replay(fresh)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = _read_launches()
    if quiet:
        close_engine(eng)
    else:
        eng.close()
    if root != fresh[-1].header.root or store.trie.hash() != root:
        raise AssertionError(f"{what}: final root differs from the header")
    return eng, dt, launches


def _nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def phase_trie(dev, smi, chains):
    """The slice's main path: ``ReplayEngine(trie="py",
    rehash_min_batch=64)`` — every window's storage and account tries
    folded in Python and rehashed level by level on K3's entry — on the
    transfer chain of phase main and the ERC-20 chain of phase window
    (K6+K7, ``token_fastpath=False``), each beside the ``trie="native"``
    replay of the same chain.  Per replay: txs/s, ``t_trie``, the
    launches (K3's > 0 on the py fold), and K3 against its plain
    version on the largest level the path hashed (ms, tolerance 0).
    Then the transfer chain once more with ``trie_check=True`` over the
    native fold (every window root re-derived on the Python twin; no
    ``TrieOracleError``).  Returns (K3 launches over both py replays,
    the largest level's row)."""
    k3_launches, k3_row = 0, None
    for label, (genesis, wire, txs, kw) in chains.items():
        row = {"phase": "trie", "chain": label, "blocks": len(wire),
               "txs_per_block": txs}
        for backend in ("native", "py"):
            extra = dict(kw, trie=backend)
            rec = None
            if backend == "py":
                extra["rehash_min_batch"] = 64
                rec = LevelRecorder()
            try:
                eng, dt, launches = replay_fresh(
                    dev, genesis, wire, f"trie {label} {backend}", **extra)
            finally:
                if rec is not None:
                    rec.close()
            row[backend] = {
                "txs_per_s": round(eng.stats.txs / dt, 1),
                "replay_s": round(dt, 4),
                "t_trie": round(eng.stats.t_trie, 4),
                "folds": eng.commit_pipe.fold_calls,
                "launches": _nonzero(launches)}
            if rec is not None:
                if launches["keccak256_blocks"] < 1:
                    raise AssertionError(f"trie {label}: K3 never launched "
                                         "on the py fold")
                k3_launches += launches["keccak256_blocks"]
                level = k3_on_messages(dev, rec.largest,
                                       f"trie {label} largest level")
                row[backend].update(rehash_levels_on_k3=rec.calls,
                                    messages_on_k3=rec.messages,
                                    k3_largest_level=level)
                if k3_row is None or level["messages"] > k3_row["messages"]:
                    k3_row = dict(level, chain=label)
        row["roots_equal_headers"] = True
        row["card"] = smi
        emit(row)
    genesis, wire, txs, kw = chains["transfer"]
    eng, dt, launches = replay_fresh(dev, genesis, wire, "trie check",
                                     trie_check=True, **kw)
    emit({"phase": "trie_check", "chain": "transfer",
          "windows_checked": eng.commit_pipe.fold_calls,
          "ms": round(1000 * dt, 1),
          "t_trie": round(eng.stats.t_trie, 4),
          "oracle_divergences": 0, "roots_equal_headers": True,
          "launches": _nonzero(launches), "card": smi})
    return k3_launches, k3_row


# ------------------------------------------------------- faults (19)
FAULT_XFER_BLOCKS, FAULT_MACHINE_BLOCKS = 8, 4


def phase_faults(dev, smi, transfer, erc20, hot):
    """The supervisor's ladder on the card, on prefixes of the chains
    already built (no new signing), each case with an armed
    ``FaultPlan`` and a supervisor that demotes at the first strike
    (``retries=1, strikes=1``; the transient cases ``strikes=3``), as
    the reference's tests set it: (a) a transient ``device/dispatch``
    on K1, retried with no demotion; (b) a persistent one, demoted
    with every block on the host path; (c) re-promotion once the
    cooldown is forced open; (d) ``device/dispatch`` on a K6+K7 window,
    demoted; (e) ``device/key_exchange`` and (f)
    ``device/shard_exchange`` on K9 at n = 4, struck and demoted; (g)
    ``recover/fault`` on K2, degraded to per-tx recovery; (h) a
    transient ``commit/flush_fail``, retried.  Every root equals the
    header.  Prints each case's supervisor snapshot and launches."""
    from coreth_tpu_torch import faults
    from coreth_tpu_torch.faults import FaultPlan, FaultSpec
    from coreth_tpu_torch.parallel import make_mesh
    from coreth_tpu_torch.replay.supervisor import BackendSupervisor
    xg, xwire, xkw = transfer
    mg, mwire, mkw = erc20
    hg, hwire, hkw = hot
    xwire = xwire[:FAULT_XFER_BLOCKS]
    mwire, hwire = mwire[:FAULT_MACHINE_BLOCKS], hwire[:FAULT_MACHINE_BLOCKS]
    xkw = dict(xkw, window=4)

    def sup(**kw):
        return BackendSupervisor(**{"retries": 1, "backoff": 0.001,
                                    "strikes": 1, **kw})

    def case(name, chain, plan, check, sup_kw=None, **kw):
        genesis, wire, base = chain
        t0 = time.monotonic()
        with faults.armed(FaultPlan(plan)) as armed:
            eng, dt, launches = replay_fresh(
                dev, genesis, wire, f"faults {name}", quiet=False,
                supervisor=sup(**(sup_kw or {})), **dict(base, **kw))
            fired = armed.fired()
        st = eng.stats
        if not check(eng, launches, fired):
            raise AssertionError(f"faults {name}: supervisor "
                                 f"{eng.supervisor.snapshot()}, fired "
                                 f"{fired}, launches {launches}, stats "
                                 f"{st.row()}")
        emit({"phase": "faults", "case": name, "blocks": len(wire),
              "fired": fired, "supervisor": eng.supervisor.snapshot(),
              "blocks_device": st.blocks_device,
              "blocks_fallback": st.blocks_fallback,
              "sigs_device": st.sigs_device, "sigs_host": st.sigs_host,
              "launches": _nonzero(launches), "root_matches_header": True,
              "seconds": round(time.monotonic() - t0, 3), "card": smi})

    X = (xg, xwire, xkw)
    n = FAULT_XFER_BLOCKS
    case("k1_dispatch_transient", X,
         {"device/dispatch": FaultSpec(times=1, transient=True)},
         lambda e, ln, f: (e.supervisor.retries >= 1
                           and e.supervisor.demotions == 0
                           and e.stats.blocks_device == n
                           and ln["transfer_window"] >= 1),
         sup_kw={"strikes": 3})
    case("k1_dispatch_persistent", X, {"device/dispatch": FaultSpec()},
         lambda e, ln, f: (e.supervisor.demoted("device")
                           and e.stats.blocks_fallback == n
                           and e.stats.blocks_device == 0
                           and ln["transfer_window"] == 0))
    case("k9_key_exchange", (hg, hwire, hkw),
         {"device/key_exchange": FaultSpec()},
         lambda e, ln, f: (f.get("device/key_exchange", 0) >= 1
                           and e.supervisor.demotions >= 1
                           and e.stats.blocks_fallback > 0),
         mesh=make_mesh(4))
    case("k9_shard_exchange", (mg, mwire, mkw),
         {"device/shard_exchange": FaultSpec()},
         lambda e, ln, f: (f.get("device/shard_exchange", 0) >= 1
                           and ln["occ_sharded"] >= 1
                           and e.supervisor.demotions >= 1
                           and e.stats.blocks_fallback > 0),
         mesh=make_mesh(4))
    case("k6k7_dispatch", (mg, mwire, mkw), {"device/dispatch": FaultSpec()},
         lambda e, ln, f: (e.supervisor.demoted("device")
                           and e.stats.blocks_fallback == len(mwire)
                           and ln["occ_window_spec"] + ln["occ_window"]
                           == 0))
    case("k2_recover", X, {"recover/fault": FaultSpec()},
         lambda e, ln, f: (f.get("recover/fault", 0) >= 1
                           and e.stats.sigs_device == e.stats.sigs_host == 0
                           and ln["secp_recover"] == 0
                           and e.supervisor.strikes == 0
                           and e.stats.blocks_device == n))
    case("commit_flush_transient", X,
         {"commit/flush_fail": FaultSpec(times=2, transient=True)},
         lambda e, ln, f: (e.supervisor.retries >= 2
                           and e.supervisor.strikes == 0
                           and e.stats.blocks_device == n),
         sup_kw={"retries": 3, "strikes": 5})
    # (c) a fault that clears: demoted on the first window, the cooldown
    # forced open, then the probe promotes and the device path resumes
    import torch
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    fresh = [Block.decode(w) for w in xwire]
    store = StateStore()
    gblock = xg.to_block(store)
    eng = E.ReplayEngine(xg.config, store, parent_header=gblock.header,
                         device=dev, supervisor=sup(), **xkw)
    half = n // 2
    _zero_launches()
    t0 = time.monotonic()
    with faults.armed(FaultPlan({"device/dispatch": FaultSpec(times=1)})):
        eng.replay(fresh[:half])
        demoted = eng.supervisor.demoted("device")
        eng.supervisor._state["device"]["until"] = 0.0
        root = eng.replay(fresh[half:])
    torch.cuda.synchronize()
    launches = _read_launches()
    eng.close()
    sup_row = eng.supervisor.snapshot()
    if not (demoted and root == fresh[-1].header.root
            and eng.supervisor.promotions >= 1
            and not eng.supervisor.demoted("device")
            and eng.stats.blocks_fallback == half
            and eng.stats.blocks_device == n - half):
        raise AssertionError(f"faults k1_repromote: demoted {demoted}, "
                             f"supervisor {sup_row}, {eng.stats.row()}")
    emit({"phase": "faults", "case": "k1_repromote", "blocks": n,
          "supervisor": sup_row, "blocks_device": eng.stats.blocks_device,
          "blocks_fallback": eng.stats.blocks_fallback,
          "launches": _nonzero(launches), "root_matches_header": True,
          "seconds": round(time.monotonic() - t0, 3), "card": smi})


# -------------------------------------------------------- trace (20)

def phase_trace(dev, smi, genesis, wire, kw):
    """The transfer chain of phase main four times, in the order off,
    on, on, off: with no tracer, and with ``obs.install(device_spans=
    True)`` (spans of the sender recovery, the window issue and
    completion, the folds; ``torch.profiler`` labels on the launches).
    Prints txs/s of each, the spans and instants by name of the traced
    run, the export's size, and that it reloads with ``json.loads``;
    then a 16-block prefix traced under ``torch.profiler``, where the
    K1 launches' ``coreth/transfer_window`` labels must show."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    from coreth_tpu_torch import obs
    runs, doc = [], None
    for traced in (False, True, True, False):
        tracer = obs.install(device_spans=True) if traced else None
        try:
            eng, dt, _ln = replay_fresh(dev, genesis, wire, "trace", **kw)
        finally:
            obs.uninstall()
        runs.append({"traced": traced,
                     "txs_per_s": round(eng.stats.txs / dt, 1),
                     "replay_s": round(dt, 4)})
        if traced and doc is None:
            text = json.dumps(tracer.export())
            doc = json.loads(text)
            dropped = tracer.dropped
    spans = collections.Counter(e["name"] for e in doc["traceEvents"]
                                if e["ph"] == "X")
    instants = collections.Counter(e["name"] for e in doc["traceEvents"]
                                   if e["ph"] == "i")
    for need in ("replay/issue_window", "replay/complete_window",
                 "commit/flush"):
        if not spans.get(need):
            raise AssertionError(f"trace: no {need} span in {spans}")
    obs.install(device_spans=True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            replay_fresh(dev, genesis, wire[:16], "trace profiled", **kw)
    finally:
        obs.uninstall()
    labels = sum(ev.count for ev in prof.key_averages()
                 if ev.key == "coreth/transfer_window")
    if labels < 1:
        raise AssertionError("trace: no coreth/transfer_window label in the "
                             "profiler's trace")
    emit({"phase": "trace", "order": ["off", "on", "on", "off"],
          "runs": runs, "spans": dict(spans), "instants": dict(instants),
          "events": len(doc["traceEvents"]), "dropped": dropped,
          "export_bytes": len(text), "export_reloads": True,
          "profiler_labels": {"coreth/transfer_window": labels},
          "card": smi})


# ---------------------------------------------------------- flat (21)
FLAT_PREFIX_BLOCKS, FLAT_QUARANTINE_AT = 16, 8
FLAT_CHECKPOINT_EVERY = 64


def _flat_row(eng, dt: float, launches: dict) -> dict:
    row = {"txs_per_s": round(eng.stats.txs / dt, 1),
           "replay_s": round(dt, 4),
           "t_classify": round(eng.stats.t_classify, 4),
           "t_device": round(eng.stats.t_device, 4),
           "t_sender": round(eng.stats.t_sender, 4),
           "launches": _nonzero(launches)}
    if eng.flat is not None:
        row["flat"] = eng.flat.snapshot()
    return row


def _need_launches(what: str, launches: dict, names) -> None:
    missing = [n for n in names if launches.get(n, 0) < 1]
    if missing:
        raise AssertionError(f"{what}: never launched {missing}: "
                             f"{_nonzero(launches)}")


def phase_flat(dev, smi, transfer, erc20):
    """Phase 21: the flat-state layer on the chains phases main and
    window signed (``transfer`` and ``erc20`` are (genesis, wire, txs,
    engine keywords)); see the module docstring.  Returns the launches
    of the flat-on replays."""
    import tempfile
    import torch
    from coreth_tpu_torch.evm.device import adapter as A
    from coreth_tpu_torch.rawdb import FileDB, MemDB
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.replay.checkpoint import (
        CheckpointManager, resume_engine)
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    kernels_of = {"transfer": ("transfer_window", "secp_recover"),
                  "erc20": ("occ_window_spec", "secp_recover")}
    on_launches = {}
    # (a) the layer on against off, off first
    for label, (genesis, wire, txs, kw) in (("transfer", transfer),
                                            ("erc20", erc20)):
        row = {"phase": "flat", "case": "on_off", "chain": label,
               "blocks": len(wire), "txs_per_block": txs}
        for flat in (False, True):
            eng, dt, launches = replay_fresh(
                dev, genesis, wire, f"flat {label} flat={flat}", flat=flat,
                **kw)
            _need_launches(f"flat {label} flat={flat}", launches,
                           kernels_of[label])
            row["on" if flat else "off"] = _flat_row(eng, dt, launches)
            if flat:
                on_launches[label] = launches
                snap = eng.flat.snapshot()
                if snap["generations"] < 1 or snap["fills"] < 1:
                    raise AssertionError(f"flat {label}: the layer sealed "
                                         f"or filled nothing: {snap}")
        row["roots_equal_headers"] = True
        row["card"] = smi
        emit(row)
    # (b) the oracle over the ERC-20 window chain: one engine's cold
    # reads each fill the layer once and never hit it, so the second half
    # runs on an engine resumed from a checkpoint at the halfway block,
    # whose loaded flat base serves hits for the oracle to re-derive
    genesis, wire, txs, kw = erc20
    half = len(wire) // 2
    kv = MemDB()
    store = StateStore(kv=kv)
    gblock = genesis.to_block(store)
    eng = E.ReplayEngine(genesis.config, store, parent_header=gblock.header,
                         device=dev, flat_check=True, **kw)
    mgr = CheckpointManager(eng, kv, every=half)
    halves = []
    for lo, hi in ((0, half), (half, len(wire))):
        if lo:
            eng, _ck = resume_engine(genesis.config, kv, device=dev,
                                     flat_check=True, **kw)
        A.RECIPES.clear()
        _zero_launches()
        t0 = time.monotonic()
        root = eng.replay([Block.decode(w) for w in wire[lo:hi]])
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        launches = _read_launches()
        if not lo:
            mgr.on_committed(half)
            mgr.write()
            mgr.close()
        close_engine(eng)
        if root != Block.decode(wire[hi - 1]).header.root:
            raise AssertionError("flat check: a root differs from the "
                                 "header's")
        _need_launches("flat check", launches, kernels_of["erc20"])
        halves.append(_flat_row(eng, dt, launches))
    snap = halves[1]["flat"]
    checked = snap["account_hits"] + snap["storage_hits"]
    if checked < 1:
        raise AssertionError(f"flat check: no flat hit to check: {snap}")
    emit({"phase": "flat", "case": "oracle", "chain": "erc20",
          "checked_hits": checked, "oracle_divergences": 0,
          "roots_equal_headers": True, "halves": halves, "card": smi})
    # (c) quarantine, rollback, the true tail
    genesis, wire, txs, kw = transfer
    blocks = [Block.decode(w) for w in wire[:FLAT_PREFIX_BLOCKS]]
    bad = Block.decode(wire[FLAT_QUARANTINE_AT])
    bad.transactions.pop()
    store = StateStore()
    gblock = genesis.to_block(store)
    eng = E.ReplayEngine(genesis.config, store, parent_header=gblock.header,
                         device=dev, **kw)
    _zero_launches()
    eng.replay(blocks[:FLAT_QUARANTINE_AT])
    pre_root = eng.root
    reasons = eng.quarantine_block(bad)
    if not reasons or eng.root == blocks[FLAT_QUARANTINE_AT].header.root:
        raise AssertionError(f"flat rollback: the poison block did not "
                             f"diverge: {reasons}")
    t0 = time.monotonic()
    if eng.rollback_block(bad) != pre_root or store.trie.hash() != pre_root:
        raise AssertionError("flat rollback: not back at the pre-block root")
    t_rollback = time.monotonic() - t0
    root = eng.replay(blocks[FLAT_QUARANTINE_AT:])
    torch.cuda.synchronize()
    launches = _read_launches()
    close_engine(eng)
    if root != blocks[-1].header.root:
        raise AssertionError("flat rollback: the true tail missed the "
                             "header's root")
    _need_launches("flat rollback", launches, kernels_of["transfer"])
    emit({"phase": "flat", "case": "rollback", "blocks": len(blocks),
          "quarantined": bad.number, "reasons": reasons,
          "rollback_ms": round(1000 * t_rollback, 3),
          "blocks_rolled_back": eng.stats.blocks_rolled_back,
          "root_equals_header": True, "launches": _nonzero(launches),
          "card": smi})
    # (d) checkpoint halfway in background mode, close, resume, the rest
    half = len(wire) // 2
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "chain.db")
        kv = FileDB(path)
        store = StateStore(kv=kv)
        gblock = genesis.to_block(store)
        eng = E.ReplayEngine(genesis.config, store,
                             parent_header=gblock.header, device=dev, **kw)
        mgr = CheckpointManager(eng, kv, every=FLAT_CHECKPOINT_EVERY)
        t0 = time.monotonic()
        for i in range(0, half, FLAT_CHECKPOINT_EVERY):
            chunk = [Block.decode(w)
                     for w in wire[i:min(i + FLAT_CHECKPOINT_EVERY, half)]]
            eng.replay(chunk)
            mgr.on_committed(len(chunk))
        t_first = time.monotonic() - t0
        t0 = time.monotonic()
        ckpt = mgr.write()
        t_drain = time.monotonic() - t0
        ck = mgr.snapshot()
        mgr.close()
        close_engine(eng)
        kv.close()
        if ckpt is None or ckpt.number != half \
                or ckpt.root != Block.decode(wire[half - 1]).header.root:
            raise AssertionError(f"flat checkpoint: record {ckpt} is not "
                                 f"block {half}'s")
        kv2 = FileDB(path)
        t0 = time.monotonic()
        eng2, ckpt2 = resume_engine(genesis.config, kv2, device=dev, **kw)
        t_resume = time.monotonic() - t0
        _zero_launches()
        t0 = time.monotonic()
        root = eng2.replay([Block.decode(w) for w in wire[half:]])
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        launches = _read_launches()
        close_engine(eng2)
        kv2.close()
        db_bytes = os.path.getsize(path)
    if ckpt2.number != half or root != Block.decode(wire[-1]).header.root:
        raise AssertionError("flat resume: the resumed engine missed the "
                             "last header's root")
    _need_launches("flat resume", launches, kernels_of["transfer"])
    emit({"phase": "flat", "case": "checkpoint_resume",
          "record_number": ckpt.number, "every": FLAT_CHECKPOINT_EVERY,
          "stamp_us": ck["stamp_us"], "written": ck["written"],
          "exporter": ck["exporter"],
          "first_half_s": round(t_first, 3), "drain_s": round(t_drain, 3),
          "resume_s": round(t_resume, 3),
          "loaded_entries": eng2.flat.loaded_entries,
          "db_bytes": db_bytes, "tail_blocks": len(wire) - half,
          **_flat_row(eng2, dt, launches),
          "root_equals_header": True, "card": smi})
    return on_launches


def main() -> int:
    t_start = time.monotonic()
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
    global occ_split
    import occ_split
    import window_split
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
    split_builds = start_split_builds()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    k8s_split = pool.submit(window_split.build, "sharded_step")
    pool.shutdown(wait=False)
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
    win, k1, k1_fetches = phase_k1(dev, rng)

    # ---- 3b. K8 against its plain version on the same window
    k8 = phase_k8(dev, win, k1, k1_fetches)

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
    # the corner rows
    corner = [torch.from_numpy(a).to(dev) for a in corner_batch(SEED)]
    corner_plain = S.recover_kernel_plain(*corner)
    if not torch.equal(S.recover_kernel(*corner), corner_plain):
        raise AssertionError("K2 corner rows differ from the plain version")
    design = S.kernel_design()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # three medians of 10 launches each: the spread within this run
    k2_runs = [round(cuda_ms(lambda: S.recover_kernel(*dargs)), 4)
               for _ in range(3)]
    k2_ms = float(np.median(k2_runs))
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
          "valid_sigs": sum(okb), "imads": k2_imads,
          "corner_rows_equal": len(corner_plain), "ms_runs": k2_runs,
          "g": design["g"],
          "block": design["block"],
          "warps_per_sm": {str(r): round(r * design["g"] / 32 / sms, 2)
                           for r in (4096, 1024)},
          **k2})

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
    close_engine(eng)
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
    k3 = phase_k3(dev)
    k4 = phase_k4(dev)
    k5 = phase_k5(dev)

    # ---- 9. the machine path (per-block OCC, K5), on the ERC-20 chain
    m_txs, m_keys = 256, 1024
    t0 = time.monotonic()
    m_genesis, m_blocks = build_erc20_chain(128, m_txs, m_keys)
    t_build = time.monotonic() - t0
    m_launches = phase_machine(dev, smi, m_genesis,
                               m_blocks[:MACHINE_BLOCKS], t_build, m_txs,
                               m_keys)

    # ---- 10.-11. K6, then K6+K7, against their plain versions
    split_libs = occ_split.finish(split_builds)
    k6 = phase_k6(dev, m_genesis, m_blocks, split_libs["generic"])
    k7, split_libs["variant"], split_libs["spec"] = phase_k7(
        dev, m_genesis, m_blocks)
    phase_ptxas(split_libs["spec"])

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

    # ---- 12a. the same chain through the token fast path (K1 on one
    # shard, K8 at n = 4), then K8s against its plain version and on a
    # real classified block of it
    phase_token(
        dev, smi, m_genesis, m_blocks, m_txs,
        [st["txs_per_s"] for sp, _ln, st in runs if not sp])
    k8s_t, k8s_s = phase_k8s(dev, smi, m_genesis, m_blocks, m_txs, rng,
                             k8s_split.result())

    # ---- 12b. K9 against its plain version, then its flags (the
    # reference's K9x) against theirs (phase k7 built the token's
    # variant, which holds K9 too)
    k9, k9_outs, k9_split = phase_k9(
        dev, sharded_windows(dev, m_genesis, m_blocks), split_libs)
    k9x = phase_k9x(dev, k9_outs, k9_split)
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
    _hot, (h_genesis, h_wire) = phase_hot(dev, smi)

    # ---- 15. the exact host path: rewinds, a dirty block, serial blocks
    phase_host(dev, smi)

    # ---- 16. the Avalanche-semantics segment (atomic imports and
    # nativeAssetCall on the host path, transfers on K1 and K2)
    t0 = time.monotonic()
    phase_mixed(dev, smi)
    # ---- 17. the batched trie rehash on K3's entry
    rehash_launches, k3_rehash = phase_rehash(dev, smi)
    emit({"phase": "mixed_rehash_seconds",
          "seconds": round(time.monotonic() - t0, 2)})

    # ---- 18.-20. the Python-trie fold with K3 inside the replay (the
    # slice's main path), the fault ladder, the span tracer
    t0 = time.monotonic()
    x_kw = dict(batch_pad=txs, capacity=capacity, window=128)
    m_wire = [b.encode() for b in m_blocks]
    m_kw = dict(batch_pad=m_txs, window=16, token_fastpath=False)
    k3_launches, k3_path = phase_trie(dev, smi, {
        "transfer": (genesis, wire, txs, x_kw),
        "erc20": (m_genesis, m_wire, m_txs, m_kw)})
    t_trie_phase = time.monotonic() - t0
    phase_faults(dev, smi, (genesis, wire, x_kw), (m_genesis, m_wire, m_kw),
                 (h_genesis, h_wire, dict(
                     capacity=1 << 13, slot_capacity=1 << 13,
                     batch_pad=HOT_TXS, window=16, token_fastpath=False)))
    phase_trace(dev, smi, genesis, wire, x_kw)
    emit({"phase": "trie_faults_trace_seconds",
          "trie_s": round(t_trie_phase, 2),
          "seconds": round(time.monotonic() - t0, 2)})

    # ---- 21. the flat-state layer: on against off, its oracle, the
    # quarantine rollback, a checkpoint and the resume from it
    t0 = time.monotonic()
    phase_flat(dev, smi, (genesis, wire, txs, x_kw),
               (m_genesis, m_wire, m_txs, m_kw))
    emit({"phase": "flat_seconds",
          "seconds": round(time.monotonic() - t0, 2)})

    k1["launches"] = launches["transfer_window"]
    k2["launches"] = launches["secp_recover"]
    k5["launches"] = m_launches["step_machine"]
    k6["launches"] = w_launches["occ_window"]
    k7["launches"] = s_launches["occ_window_spec"]
    # K3's entry runs inside the replay on the py fold (phase trie, the
    # slice's main path): its numbers at that path's largest launch;
    # phase rehash's and phase k3's stay in their own lines
    k3.update({k: k3_path[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")})
    k3["shape"] = (f"py-fold level of the {k3_path['chain']} replay: "
                   f"{k3_path['messages']} messages, "
                   f"{k3_path['blocks']} blocks")
    k3["launches"] = k3_launches
    k3["launches_rehash_phase"] = rehash_launches
    k3["rehash_phase_ms"] = k3_rehash.get("ms")
    k3["launches_also"] = "in K5, K6 and K7"
    k4["launches"] = "in K5, K6 and K7"
    k8["launches"] = shard_launches[HEADLINE_WIDTH]["sharded_window"]
    k8r["launches"] = shard_launches[HEADLINE_WIDTH]["sharded_recover"]
    k9["launches"] = sh_launches["occ_sharded"]
    k9x["launches"] = sh_launches["flags_fill"]
    k9x["carried_by_k9"] = sh_launches["occ_sharded"]
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6, k7, k8, k8r, k9,
                                  k9x, k8s_t, k8s_s]}), flush=True)
    emit({"phase": "total", "seconds": round(time.monotonic() - t_start, 1)})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
