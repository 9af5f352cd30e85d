#!/usr/bin/env python3
"""Phases spec and hot of ``chip_smoke.py`` on two checkouts in one
machine, interleaved, and traced spec replays of each.

Run from the root of a checkout, on a machine with a card, with another
checkout (for example the parent commit unpacked by ``git archive`` into
a directory that ``.gitignore`` lists) as BASE:

    python3 window_ab.py BASE
    python3 window_ab.py BASE --kernels

With ``--kernels`` each child only times kernels, in CUDA events over 20
launches after one, three times: on phase k6's window (a) (the chain's
first 8 blocks x 256 lanes) K6 generic, K6+K7 (every lane traced), K9
at n = 4 with key-range placement and K7, and K9 with its window's
flags (``k9_flags_n4``: in a tree whose flags reduce is a launch of its
own, ``machine.shard_flags``, K9 and that launch; else K9 alone, which
holds it); generic K6 on phase k6's window (b) (swaps: MUL and DIV in
every lane); K5 on phase k5's 256-lane batch (ERC-20 lanes: SHR and two
SHA3 each); and the K3 and K4 launch entries on phases k3's and k4's
inputs: for K3 the wrapper, for K4 every op's wrapper, each also as
the kernel's device time a launch (``torch.profiler``) and K4's as the
wrapper's host time a call (``kernels`` lines), in the order BASE,
this, this, BASE; nothing else runs.

Each run is a child process that imports the ``chip_smoke.py`` and the
``coreth_tpu_torch`` of its checkout (so each runs its own kernels,
built into its own tree), builds the kernels and the ERC-20 chain of
phase spec, replays 16 of its blocks untimed (the chain's K7 variant is
built there), and then, as ``chip_smoke.py`` does:

- phase spec twice (the chain's 128 blocks x 256 txs through the window
  path with K7), with its root, launch and counter checks;
- phase shard_erc20 once on each runner (the same chain on a 4-shard
  engine: K9, then the single-chip runner over the sharded tables);
- phase hot once (the hot-contract chain on one shard, then 2 and 4);
- ``launch``: window (a) of phase k6 (the chain's first 8 blocks)
  through ``machine.run_occ_window`` 20 times without a synchronize,
  the host milliseconds a call (what a launch costs the replay's
  thread) beside the device milliseconds a launch (CUDA events over
  the 20).

The children run in the order BASE, this, this, BASE.  Then one more
child of each checkout replays the chain once under ``torch.profiler``
(the same 16 blocks untimed first), then again on a 4-shard engine
(phase shard_erc20's sharded runner: K9 windows, K8r's sender streams),
and reads, for every window launch (K6/K7 or K9) of each trace, on the
card's clock, the gap between the end of the previous kernel of its
stream and its start (where a launch would wait for its group's CTAs to
be co-resident while other streams' kernels hold the SMs), and the K2
(``secp``) kernels of other streams that ran in that gap.

Every child prints the JSON lines of the phases it ran; this script
prints them prefixed by the run ("base", "this") and its place in the
order, and then one JSON line that sums the A/B.  The traces themselves
are not kept.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TXS, N_BLOCKS, N_KEYS = 256, 128, 1024


def _setup(tree: str, n_blocks: int = N_BLOCKS):
    """The checkout's chip_smoke module, its kernels built, the card,
    nvidia-smi's line and the ERC-20 chain of ``n_blocks`` after an
    untimed replay of its first 16 blocks.  Nothing of ``coreth_tpu_torch`` may be imported
    before this (it would come from this script's checkout)."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as CS
    from coreth_tpu_torch import kernels, nativebuild
    if not os.path.abspath(kernels.CSRC).startswith(tree + os.sep):
        raise RuntimeError(f"window_ab: coreth_tpu_torch imported from "
                           f"{kernels.CSRC}, not from {tree}")
    kernels.build()
    nativebuild.ensure_built()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    genesis, blocks = CS.build_erc20_chain(n_blocks, TXS, N_KEYS)
    CS._replay_erc20(dev, genesis, blocks[:16], TXS, device_occ=True,
                     specialize=True)
    return CS, dev, smi, genesis, blocks


def _launch_cost(CS, dev, genesis, blocks, reps: int = 20) -> dict:
    import torch
    from coreth_tpu_torch.evm.device import machine as M
    pk = CS.window_from_chain(dev, genesis, blocks)
    args = (pk["p"], pk["occ"], pk["table"], pk["key_tab"], pk["inputs"])
    M.run_occ_window(*args)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    host = 0.0
    e0.record()
    for _ in range(reps):
        t0 = time.perf_counter()
        M.run_occ_window(*args)
        host += time.perf_counter() - t0
    e1.record()
    torch.cuda.synchronize()
    return {"phase": "launch", "reps": reps,
            "host_ms_per_call": 1000 * host / reps,
            "device_ms_per_launch": e0.elapsed_time(e1) / reps}


def child_kernels(tree: str) -> int:
    import numpy as np
    CS, dev, smi, genesis, blocks = _setup(tree, n_blocks=8)
    from coreth_tpu_torch.evm.device import machine as M
    gen = CS.window_from_chain(dev, genesis, blocks)
    spec = CS.window_from_chain(dev, genesis, blocks, specialize=True)
    k9 = CS.sharded_windows(dev, genesis, blocks)[(4, True)]

    def occ(pk, programs):
        return lambda: M.run_occ_window(pk["p"], pk["occ"], pk["table"],
                                        pk["key_tab"], pk["inputs"],
                                        programs)
    calls = {"k6": occ(gen, ()), "k6_k7": occ(spec, spec["spec"]),
             "k9_n4": lambda: M.run_occ_sharded(
                 k9["p"], k9["occ"], k9["table"], k9["key_tab"],
                 k9["inputs"], k9["spec"], 4, k9["sync_rows"], "psum")}
    calls["k6_b"] = occ(CS.swap_window(dev), ())
    calls["k5"] = _k5_batch(CS, dev)
    calls["k3"] = _k3_entry(CS, dev)
    calls["k9_flags_n4"] = calls["k9_n4"]
    if hasattr(M, "shard_flags"):
        def k9_flags():
            out = calls["k9_n4"]()
            return M.shard_flags(out["packed"], k9["inputs"]["active"], 4,
                                 "psum")
        calls["k9_flags_n4"] = k9_flags
    row = {"phase": "kernels", "card": smi}
    for name, fn in calls.items():
        runs = [CS.cuda_ms(fn, reps=20, warmup=1) for _ in range(3)]
        row[name] = float(np.median(runs))
        row[name + "_runs"] = runs
    for name, kern in (("k5", "step_machine"), ("k6", "occ_window"),
                       ("k6_b", "occ_window"), ("k3", "keccak256_blocks")):
        row[name + "_kernel"] = CS.kernel_ms(calls[name], kern, reps=20)
    row["k4"] = _k4_ops(CS, dev)
    CS.emit(row)
    return 0


def _k5_batch(CS, dev):
    """Phase k5's batch (``chip_smoke.k5_batch``) as one call of K5's
    wrapper."""
    from coreth_tpu_torch.evm.device import machine as M
    p, inputs = CS.k5_batch(dev)
    return lambda: M.run_machine(p, inputs)


def _k3_entry(CS, dev):
    """Phase k3's messages (``chip_smoke.k3_messages``) as one call of
    K3's wrapper."""
    import numpy as np
    import torch
    from coreth_tpu_torch.ops import keccak as K
    blocks, nblocks = K.pack_blocks(
        CS.k3_messages(np.random.default_rng(CS.SEED + 3)))
    b = torch.from_numpy(blocks).to(dev)
    nb = torch.from_numpy(nblocks).to(dev)
    return lambda: K.keccak256_blocks(b, nb)


def _k4_ops(CS, dev) -> dict:
    """Per K4 op on phase k4's operands (``chip_smoke.k4_operands``):
    ``chip_smoke.k4_op_times`` at 20 calls."""
    (a, b, c), _ints = CS.k4_operands(dev)
    return CS.k4_op_times(a, b, c, reps=20)


def child_runs(tree: str) -> int:
    CS, dev, smi, genesis, blocks = _setup(tree)
    for order in (1, 2):
        CS.phase_window(dev, smi, genesis, blocks, TXS, True, order)
    for order, shard_occ in ((1, True), (2, False)):
        CS.phase_shard_erc20(dev, smi, genesis, blocks, TXS, shard_occ,
                             order)
    CS.phase_hot(dev, smi)
    CS.emit(_launch_cost(CS, dev, genesis, blocks))
    return 0


def _is_window(name: str) -> bool:
    return "occ_window_kernel" in name or "occ_sharded_kernel" in name


def _queue_delays(trace: dict) -> dict:
    """Per window launch of a chrome trace, on the card's clock: the gap
    from the end of the previous kernel of its stream to its start (the
    time the window was next in its stream but did not run: the host's
    launch, or a wait for its group's SMs), and the K2 (``secp``) kernels of
    other streams running in that gap; and the host duration of its
    launch call."""
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    kern = sorted((e for e in evs if e.get("cat") == "kernel"),
                  key=lambda e: e["ts"])
    calls = {e["args"]["correlation"]: e for e in evs
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    secp = [e for e in kern if "secp" in e["name"] or "recover" in e["name"]]
    last_end, rows = {}, []
    for e in kern:
        st = e["args"].get("stream")
        prev = last_end.get(st)
        last_end[st] = e["ts"] + e["dur"]
        if not _is_window(e["name"]) or prev is None:
            continue
        k2 = [x for x in secp if x["args"].get("stream") != st
              and x["ts"] < e["ts"] and x["ts"] + x["dur"] > prev]
        call = calls.get(e["args"].get("correlation"))
        rows.append({"gap_us": e["ts"] - prev, "k2_other": len(k2),
                     "device_us": e["dur"],
                     "call_us": call["dur"] if call else None})
    n = len(rows)

    def mean(k):
        v = [r[k] for r in rows if r[k] is not None]
        return sum(v) / len(v) if v else None
    return {"window_launches": n,
            "mean_gap_us": mean("gap_us"),
            "max_gap_us": max((r["gap_us"] for r in rows), default=None),
            "launches_with_k2_of_other_streams_in_gap":
                sum(r["k2_other"] > 0 for r in rows),
            "mean_device_us": mean("device_us"),
            "mean_call_us": mean("call_us"),
            "k2_kernels": len(secp),
            "k2_streams": sorted({str(x["args"].get("stream"))
                                  for x in secp}),
            "window_streams": sorted({str(e["args"].get("stream"))
                                      for e in kern
                                      if _is_window(e["name"])})}


def child_trace(tree: str, out_dir: str) -> int:
    from torch.profiler import ProfilerActivity, profile
    CS, dev, smi, genesis, blocks = _setup(tree)
    from coreth_tpu_torch.parallel import make_mesh
    for name, mesh in (("spec", None), ("shard_erc20_n4", make_mesh(4))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _eng, root, dt, launches, _st = CS._replay_erc20(
                dev, genesis, blocks, TXS, device_occ=True,
                specialize=True, mesh=mesh)
        if root != blocks[-1].header.root:
            raise AssertionError(f"traced {name} replay: root differs")
        path = os.path.join(out_dir, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        os.remove(path)
        CS.emit({"phase": "trace", "replay": name, "replay_s": dt,
                 "launches": launches, "card": smi,
                 **_queue_delays(trace)})
    return 0


def _child(mode: str, tree: str, out_dir: str) -> list:
    cmd = [sys.executable, os.path.abspath(__file__), "--child", mode,
           tree, out_dir]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=1500)
    if r.returncode != 0:
        raise RuntimeError(f"{mode} {tree}: rc {r.returncode}\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-6000:]}")
    return [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]


def main() -> int:
    if len(sys.argv) >= 5 and sys.argv[1] == "--child":
        mode, tree, out_dir = sys.argv[2:5]
        out_dir = os.path.abspath(out_dir)      # before _setup's chdir
        if mode == "runs":
            return child_runs(tree)
        if mode == "kernels":
            return child_kernels(tree)
        return child_trace(tree, out_dir)
    kernels_only = sys.argv[2:] == ["--kernels"]
    if len(sys.argv) != 2 and not kernels_only:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("window_ab: no CUDA device", file=sys.stderr)
        return 1
    base = os.path.abspath(sys.argv[1])
    out_dir = os.path.join(HERE, "coreth_tpu_torch", "csrc", "build",
                           "window_ab")            # the traces, deleted
    os.makedirs(out_dir, exist_ok=True)
    trees = {"base": base, "this": HERE}
    summary = {"order": ["base", "this", "this", "base"]}
    if kernels_only:
        for place, who in enumerate(summary["order"], 1):
            for row in _child("kernels", trees[who], out_dir):
                print(json.dumps({"run": who, "place": place, **row}),
                      flush=True)
                for k in ("k6", "k6_k7", "k9_n4", "k9_flags_n4", "k6_b",
                          "k5", "k3", "k5_kernel", "k6_kernel",
                          "k6_b_kernel", "k3_kernel"):
                    summary.setdefault(f"{who}_{k}", []).append(row[k])
                for op, r in row["k4"].items():
                    summary.setdefault(f"{who}_k4_kernel_ms", {}).setdefault(
                        op, []).append(r["kernel_ms"])
        print(json.dumps(summary), flush=True)
        return 0
    for place, who in enumerate(summary["order"], 1):
        for row in _child("runs", trees[who], out_dir):
            print(json.dumps({"run": who, "place": place, **row}),
                  flush=True)
            key = row["phase"] + (
                f"_n{row['n_shards']}" if row["phase"] == "hot" else
                f"_{row['runner']}" if row["phase"] == "shard_erc20" else "")
            val = row.get("txs_per_s", row.get("host_ms_per_call"))
            summary.setdefault(f"{who}_{key}", []).append(val)
    for who in ("base", "this"):
        for row in _child("trace", trees[who], out_dir):
            print(json.dumps({"run": who, **row}), flush=True)
            summary[f"{who}_trace_{row['replay']}"] = {
                k: row[k] for k in ("mean_gap_us", "max_gap_us",
                                    "launches_with_k2_of_other_streams_in_gap",
                                    "mean_device_us", "mean_call_us",
                                    "window_launches")}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
