#!/usr/bin/env python3
"""Phase main of ``chip_smoke.py`` on two checkouts in one machine,
interleaved.

Run from the root of a checkout, on a machine with a card, with another
checkout (for example the parent commit unpacked by ``git archive`` into
a directory that ``.gitignore`` lists) as BASE:

    python3 main_ab.py BASE [REPS]

Each run is a child process that imports the ``chip_smoke.py`` and the
``coreth_tpu_torch`` of its checkout (so each runs its own code and
kernels, built into its own tree), builds K1, K2 and the native library,
builds phase main's transfer chain (256 blocks x 128 txs, 1,024 keys)
and replays it REPS times (default 3), each time as phase main does: a
fresh store and engine (window 128, no fault plan armed, no tracer), the
first block untimed, the other 255 timed with the card synchronised at
the end, the root held against the last header.  The children run in
the order BASE, this, this, BASE.

Every child prints one JSON line a replay (txs/s, seconds, the engine's
timers, the launches); this script prints them prefixed by the run
("base", "this") and its place in the order, then one JSON line with
each checkout's median and range of txs/s, and the card's name and
power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_BLOCKS, TXS, N_KEYS = 256, 128, 1024


def child(tree: str, reps: int) -> int:
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as CS
    from coreth_tpu_torch import kernels, nativebuild
    from coreth_tpu_torch.ops import secp as S
    from coreth_tpu_torch.replay import engine as E
    from coreth_tpu_torch.state import StateStore
    from coreth_tpu_torch.types import Block
    if not os.path.abspath(kernels.CSRC).startswith(tree + os.sep):
        raise RuntimeError(f"main_ab: coreth_tpu_torch imported from "
                           f"{kernels.CSRC}, not from {tree}")
    kernels.build(["transfer_window", "secp_recover"])
    nativebuild.ensure_built()
    torch.zeros(1, device="cuda")
    genesis, blocks = CS.build_chain(N_BLOCKS, TXS, N_KEYS)
    wire = [b.encode() for b in blocks]
    need = N_KEYS + N_BLOCKS * TXS // 2 + 1024
    capacity = 1 << max(14, (need - 1).bit_length())
    for rep in range(reps):
        fresh = [Block.decode(w) for w in wire]
        store = StateStore()
        gblock = genesis.to_block(store)
        eng = E.ReplayEngine(genesis.config, store,
                             parent_header=gblock.header, batch_pad=TXS,
                             capacity=capacity, window=128, device="cuda")
        E.LAUNCHES = 0
        S.LAUNCHES = 0
        eng.replay_block(fresh[0])
        t1 = time.monotonic()
        root = eng.replay(fresh[1:])
        torch.cuda.synchronize()
        dt = time.monotonic() - t1
        eng.close()
        if root != blocks[-1].header.root:
            raise AssertionError("main_ab: final root differs from the "
                                 "header")
        if eng.stats.blocks_device != N_BLOCKS:
            raise AssertionError("main_ab: a block left the device path")
        replayed = sum(len(b.transactions) for b in fresh[1:])
        print(json.dumps({
            "rep": rep, "replay_s": round(dt, 4),
            "txs_per_s": round(replayed / dt, 1),
            "launches": {"transfer_window": E.LAUNCHES,
                         "secp_recover": S.LAUNCHES},
            "stats": eng.stats.row()}), flush=True)
    return 0


def run_child(tree: str, reps: int) -> list:
    cmd = [sys.executable, os.path.abspath(__file__), "--child", tree,
           str(reps)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"{tree}: rc {r.returncode}\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-6000:]}")
    return [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        return child(os.path.abspath(sys.argv[2]), int(sys.argv[3]))
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    base = os.path.abspath(sys.argv[1])
    reps = int(sys.argv[2]) if len(sys.argv) == 3 else 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rates = {"base": [], "this": []}
    for order, (tag, tree) in enumerate((("base", base), ("this", HERE),
                                         ("this", HERE), ("base", base))):
        for row in run_child(tree, reps):
            rates[tag].append(row["txs_per_s"])
            print(json.dumps({"run": tag, "order": order, **row}),
                  flush=True)

    def summary(v):
        v = sorted(v)
        return {"median": v[len(v) // 2] if len(v) % 2
                else (v[len(v) // 2 - 1] + v[len(v) // 2]) / 2,
                "min": v[0], "max": v[-1], "n": len(v)}
    print(json.dumps({"phase": "main_ab", "txs_per_s": {
        k: summary(v) for k, v in rates.items()}, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
