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

    python3 main_ab.py --flat [REPS]

pairs this checkout with itself instead: the engine's flat-state layer
off (``ReplayEngine(flat=False)``) against on (the default), in the
order off, on, on, off, with each replay's flat snapshot beside its
timers.  A replay with the layer on also prints ``flat_host_ms``, the
layer's own host work timed directly: ``seal_ms``, the seconds inside
the commit pipeline's ``_seal_generation`` (one generation a fold), and
the cold account reads of every address the replay filled, read again
after the replay on the engine's trie once alone (``trie_ms``) and once
through a fresh ``FlatStateView`` (``view_ms``: the miss, the same trie
read and the fill); ``extra_ms`` is ``seal_ms + view_ms - trie_ms``.
The closing line gives the median of ``extra_ms`` beside the medians
of txs/s.  Every replay, in either mode, also prints ``gc``: the
garbage collector's passes inside the timed replay and their
milliseconds, by generation (``gc.callbacks``); the closing line sums
them a replay and gives each side's median.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_BLOCKS, TXS, N_KEYS = 256, 128, 1024


def _timed_seal(C, seal_s: list) -> None:
    """Count the seconds inside ``CommitPipeline._seal_generation``
    (called once a fold) into ``seal_s[0]``; a checkout without the
    method is left as it is."""
    seal = getattr(C.CommitPipeline, "_seal_generation", None)
    if seal is None:
        return

    def timed(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return seal(self, *args, **kw)
        finally:
            seal_s[0] += time.perf_counter() - t0
    C.CommitPipeline._seal_generation = timed


class _GcClock:
    """Passes and milliseconds of the garbage collector, by generation,
    between two ``reset`` calls."""

    def __init__(self):
        self._t0 = 0.0
        self.reset()
        gc.callbacks.append(self._on_gc)

    def reset(self) -> None:
        self.passes = [0, 0, 0]
        self.ms = [0.0, 0.0, 0.0]

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        gen = info["generation"]
        self.passes[gen] += 1
        self.ms[gen] += (time.perf_counter() - self._t0) * 1e3

    def row(self) -> dict:
        return {"passes": list(self.passes),
                "ms": [round(v, 4) for v in self.ms]}


def _fill_path_ms(eng) -> dict:
    """The cold account reads of every address the replay filled, on the
    engine's trie, alone and through a fresh flat view (the second of
    two passes each, so both read a warm trie)."""
    from coreth_tpu_torch.state.flat import FlatStateView, FlatStore
    from coreth_tpu_torch.types import StateAccount
    addrs = list(eng.flat.accounts)
    trie = eng.trie
    out = {}
    for _ in range(2):
        t0 = time.perf_counter()
        for addr in addrs:
            raw = trie.get(addr)
            if raw is not None:
                StateAccount.from_rlp(raw)
        t1 = time.perf_counter()
        view = FlatStateView(FlatStore())
        for addr in addrs:
            view.load_account(addr, trie)
        t2 = time.perf_counter()
        out = {"keys": len(addrs), "trie_ms": round((t1 - t0) * 1e3, 4),
               "view_ms": round((t2 - t1) * 1e3, 4)}
    return out


def child(tree: str, reps: int, flat: bool = True) -> int:
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as CS
    from coreth_tpu_torch import kernels, nativebuild
    from coreth_tpu_torch.ops import secp as S
    from coreth_tpu_torch.replay import commit as C
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
    seal_s = [0.0]
    _timed_seal(C, seal_s)
    gc_clock = _GcClock()
    for rep in range(reps):
        seal_s[0] = 0.0
        fresh = [Block.decode(w) for w in wire]
        store = StateStore()
        gblock = genesis.to_block(store)
        kw = {} if flat else {"flat": False}
        eng = E.ReplayEngine(genesis.config, store,
                             parent_header=gblock.header, batch_pad=TXS,
                             capacity=capacity, window=128, device="cuda",
                             **kw)
        E.LAUNCHES = 0
        S.LAUNCHES = 0
        eng.replay_block(fresh[0])
        gc_clock.reset()
        t1 = time.monotonic()
        root = eng.replay(fresh[1:])
        torch.cuda.synchronize()
        dt = time.monotonic() - t1
        gc_row = gc_clock.row()
        eng.close()
        if root != blocks[-1].header.root:
            raise AssertionError("main_ab: final root differs from the "
                                 "header")
        if eng.stats.blocks_device != N_BLOCKS:
            raise AssertionError("main_ab: a block left the device path")
        replayed = sum(len(b.transactions) for b in fresh[1:])
        row = {"rep": rep, "replay_s": round(dt, 4),
               "txs_per_s": round(replayed / dt, 1),
               "launches": {"transfer_window": E.LAUNCHES,
                            "secp_recover": S.LAUNCHES},
               "stats": eng.stats.row(), "gc": gc_row}
        if getattr(eng, "flat", None) is not None:
            row["flat"] = eng.flat.snapshot()
            if hasattr(eng, "_flat_view"):
                cost = {"seal_ms": round(seal_s[0] * 1e3, 4),
                        **_fill_path_ms(eng)}
                cost["extra_ms"] = round(cost["seal_ms"] + cost["view_ms"]
                                         - cost["trie_ms"], 4)
                row["flat_host_ms"] = cost
        print(json.dumps(row), flush=True)
    return 0


def run_child(tree: str, reps: int, flat: bool = True) -> list:
    cmd = [sys.executable, os.path.abspath(__file__), "--child", tree,
           str(reps), "1" if flat else "0"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"{tree}: rc {r.returncode}\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-6000:]}")
    return [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--child":
        return child(os.path.abspath(sys.argv[2]), int(sys.argv[3]),
                     sys.argv[4] == "1")
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    reps = int(sys.argv[2]) if len(sys.argv) == 3 else 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if sys.argv[1] == "--flat":
        runs = (("off", HERE, False), ("on", HERE, True),
                ("on", HERE, True), ("off", HERE, False))
    else:
        base = os.path.abspath(sys.argv[1])
        runs = (("base", base, True), ("this", HERE, True),
                ("this", HERE, True), ("base", base, True))
    rates = {tag: [] for tag, _tree, _flat in runs}
    gc_ms = {tag: [] for tag in rates}
    extra = []
    for order, (tag, tree, flat) in enumerate(runs):
        for row in run_child(tree, reps, flat):
            rates[tag].append(row["txs_per_s"])
            gc_ms[tag].append(round(sum(row["gc"]["ms"]), 4))
            if "flat_host_ms" in row:
                extra.append(row["flat_host_ms"]["extra_ms"])
            print(json.dumps({"run": tag, "order": order, **row}),
                  flush=True)

    def summary(v):
        v = sorted(v)
        return {"median": v[len(v) // 2] if len(v) % 2
                else (v[len(v) // 2 - 1] + v[len(v) // 2]) / 2,
                "min": v[0], "max": v[-1], "n": len(v)}
    line = {"phase": "main_ab", "txs_per_s": {
        k: summary(v) for k, v in rates.items()}, "gc_ms": {
        k: summary(v) for k, v in gc_ms.items()}, "card": smi}
    if extra:
        line["flat_extra_ms"] = summary(extra)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
