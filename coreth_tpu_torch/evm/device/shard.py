"""Sharded machine windows: per-shard slot tables, per-shard OCC and the
key-range replica sync (K9), with the shards' flags reduce (the
reference's K9x, K9's epilogue here).

Port of reference ``evm/device/shard.py`` (``ShardedWindowRunner``).  On
a mesh engine the fused OCC window of the single-card runner
(``adapter.MachineWindowRunner``, K6/K7) runs once per shard, each shard
on its own lanes and its own arena of a shard-major slot table
(``n_shards * G`` rows): on the one card the n shards are the n CTAs of
one thread-block cluster (``csrc/occ_window.cu`` ``occ_sharded_launch``).

- **Per-shard state.**  Each shard has its own (contract, key) -> local
  row map, host value mirror and arena.  A contract's storage lives on
  its contract bucket (``parallel.contract_bucket`` over
  keccak(address)), so every lane of a contract runs on one shard and
  the shard's Block-STM sweep serializes its conflicts exactly.
- **Key-range placement** for hot contracts: a contract with at least
  ``keyrange_threshold`` lanes in one block goes hot (sticky).  Its keys
  live on ``slot_bucket(keccak(key))``, and its lanes place by per-block
  conflict component (lanes sharing a premapped key stay together), by
  copy affinity then load.  A lane that touches a key of another range
  gets a local replica row; the window's keys with two or more copies
  form its sync set, and K9 syncs their copies after every block
  (writer elected by a max-reduce, value broadcast by an add-reduce)
  and gives them the owner copy's value at window start.  Placement
  only moves load: every touched key is premapped and co-located, so
  results, and roots, do not depend on it.
- **The flags exchange.**  K9's epilogue reduces the shards' per-block
  (all active lanes committed, any escape or pending) flags into one
  (W, 2) tensor of the window's result, with no launch of its own (the
  reference's K9x).  The scheduler fetches that first
  (``poll_clean``) and, when the window is clean and the next one needs
  no table rebuild (``can_pipeline``), launches the next window before
  it fetches this one's packed rows.  ``EVENT_LOG`` records the order.

Both reduces' modes (psum, or the ppermute ring) give equal integers,
and on one card K9 and its flags epilogue sum the shards in shard
order whatever the mode: it picks the counters and the plain version's
order.  The
window's mode is chosen once, at the first window with a nonempty
sync set (or forced by ``exchange``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from coreth_tpu_torch import faults, obs
from coreth_tpu_torch.crypto import keccak256
from coreth_tpu_torch.evm.device import machine as M
from coreth_tpu_torch.evm.device import tables as T
from coreth_tpu_torch.evm.device.adapter import (
    PT_DISPATCH, MachineWindowRunner, _pow2, _scatter_rows, _upload,
)
from coreth_tpu_torch.ops import u256
from coreth_tpu_torch.parallel import (
    account_bucket, contract_bucket, exchange_mode, slot_bucket,
)

# Injection point: the cross-shard exchange fails (K9's flags reduce,
# its epilogue).  Armed plans raise right after the window's launch;
# the machine executor's fault containment invalidates the runner and
# strikes the device scope.
PT_EXCHANGE = faults.declare(
    "device/shard_exchange", "cross-shard collective exchange failure")

# Injection point: the INTRA-contract key-range exchange (the replica
# sync K9 runs between blocks when the window has a sync set).  Fired at
# the launch that carries the sync set; contained exactly like
# PT_EXCHANGE.
PT_KEY_EXCHANGE = faults.declare(
    "device/key_exchange",
    "intra-contract key-range exchange collective failure")

# Dispatch / fetch order of the sharded windows: "dispatch:<seq>",
# "exchange_fetch:<seq>", "result_fetch:<seq>", newest 512, mirrored into
# the span tracer as instants when one is installed.  The sequence is
# module-wide, so two runners in one process never collide.
EVENT_LOG = obs.EventRing("shard", maxlen=512)
_SEQ = [0]


def _next_seq() -> int:
    _SEQ[0] += 1
    return _SEQ[0]


class ShardedWindowRunner(MachineWindowRunner):
    """``MachineWindowRunner`` over the shards of ``mesh``: per-shard row
    maps, mirrors and arenas, lane placement, the sync set, and the
    exchange-overlap hooks ``poll_clean`` / ``can_pipeline``.

    Tx li of block bi runs at lane ``shard * batch + local`` of its
    block row; the handle's ``lane_map`` gives it back to ``complete``.

    ``exchange`` ("psum" / "ppermute", the reference's
    ``CORETH_EXCHANGE``) forces both reduces' mode; ``keyrange``
    (``CORETH_KEYRANGE``) allows key-range placement, which a contract
    takes at ``keyrange_threshold`` lanes in one block
    (``CORETH_KEYRANGE_THRESHOLD``); ``exchange_density``
    (``CORETH_EXCHANGE_DENSITY``) is ``parallel.exchange_mode``'s.

    Counters beside the base runner's: ``kr_lanes`` (first-attempt lanes
    of hot contracts), ``cross_shard`` (lanes whose caller's account
    bucket is not their shard: value and fee effects that settle in the
    host sweep), ``exchange_psum`` / ``exchange_ppermute`` (windows with
    the sync compiled in, by mode), and ``load_imb_sum`` /
    ``load_imb_windows``: max over mean lanes per shard of each window,
    in permille (1000 flat, n * 1000 one shard)."""

    def __init__(self, fork: str, storage_resolver, mesh, device=None,
                 specialize: bool = True, exchange: Optional[str] = None,
                 keyrange: bool = True, keyrange_threshold: int = 16,
                 exchange_density: float = 0.25):
        super().__init__(fork, storage_resolver, device=device,
                         specialize=specialize)
        self.n_shards = n = mesh.n_shards
        self.exchange = exchange
        self.exchange_density = exchange_density
        # per-shard twins of the base runner's maps and mirror
        self.slot_gid = [dict() for _ in range(n)]
        self.gid_keys = [[] for _ in range(n)]
        self.vals = [[] for _ in range(n)]
        self._synced = [0] * n
        # (contract, key) -> [(shard, local row), ...]: every copy; the
        # first is the owner
        self.copies: Dict[Tuple[bytes, bytes], List[Tuple[int, int]]] = {}
        self._bucket_memo: Dict[bytes, int] = {}
        self._abucket_memo: Dict[bytes, int] = {}
        self._kr_bucket_memo: Dict[bytes, int] = {}
        self._kr = keyrange
        self._kr_threshold = keyrange_threshold
        self.hot_contracts: Dict[bytes, None] = {}
        self._place_cache = None      # (premaps object, placement)
        # the sync set's rows: a sticky pow2 high-water, 0 until key-range
        # placement first acts
        self._xchg_hw = 0
        self._xchg_mode = "psum"
        # the mode settles at the first window with a nonempty sync set
        self._xchg_locked = False
        self._sync_last = 0
        self._probe = None            # can_pipeline's prepared window
        # the last window issued: its handle keeps the result ("out"), the
        # flags ("ex"), the active lanes and the mode
        self.last_handle: Optional[dict] = None

    # ------------------------------------------------------------ state
    def shard_of(self, contract: bytes) -> int:
        s = self._bucket_memo.get(contract)
        if s is None:
            s = contract_bucket(keccak256(contract), self.n_shards)
            self._bucket_memo[contract] = s
        return s

    def _account_bucket(self, addr: bytes) -> int:
        s = self._abucket_memo.get(addr)
        if s is None:
            s = account_bucket(keccak256(addr), self.n_shards)
            self._abucket_memo[addr] = s
        return s

    def _kr_home(self, key: bytes) -> int:
        """Key-range shard of one storage slot."""
        s = self._kr_bucket_memo.get(key)
        if s is None:
            s = slot_bucket(keccak256(key), self.n_shards)
            self._kr_bucket_memo[key] = s
        return s

    def _alloc_copy(self, contract: bytes, key: bytes, s: int,
                    v: int) -> int:
        g = len(self.vals[s])
        self.slot_gid[s][(contract, key)] = g
        self.gid_keys[s].append((contract, key))
        self.vals[s].append(v)
        self.copies.setdefault((contract, key), []).append((s, g))
        return g

    def _default_home(self, contract: bytes, key: bytes) -> int:
        if self._kr and contract in self.hot_contracts:
            return self._kr_home(key)
        return self.shard_of(contract)

    def commit_block(self, writes) -> None:
        for (contract, key), v in writes.items():
            cps = self.copies.get((contract, key))
            if not cps:
                self._alloc_copy(contract, key,
                                 self._default_home(contract, key), v)
            else:
                # every copy's mirror learns the value (the device synced
                # the copies; the mirror is the rebuild source)
                for s, g in cps:
                    self.vals[s][g] = v

    def _gid(self, contract: bytes, key: bytes,
             home: Optional[int] = None) -> int:
        """Local row of ``key``'s copy on shard ``home``, making a replica
        there if the key lives elsewhere; ``home=None`` takes any copy,
        else makes one at the key's default shard."""
        cps = self.copies.get((contract, key))
        if home is None:
            if cps:
                return cps[0][1]
            home = self._default_home(contract, key)
        if cps:
            for s, g in cps:
                if s == home:
                    return g
            # a new replica starts from the owner's mirror value
            v = self.vals[cps[0][0]][cps[0][1]]
        else:
            v = self.resolver(contract, key)
        return self._alloc_copy(contract, key, home, v)

    def _key_mapped(self, contract: bytes, key: bytes) -> bool:
        return (contract, key) in self.copies

    # ------------------------------------------------------------ hooks
    def _prepare(self, items, discovered):
        probe, self._probe = self._probe, None
        if discovered is None and probe is not None and probe[0] is items:
            return probe[1:]
        return super()._prepare(items, discovered)

    def _lane_count(self, p: M.MachineParams) -> int:
        return self.n_shards * p.batch

    def _lane_map(self, items, premaps, p: M.MachineParams,
                  attempt: int) -> List[List[int]]:
        """Each tx's lane (its shard's slice), and the placement counters
        of the window."""
        n, L = self.n_shards, p.batch
        place = self._placements(items, premaps)
        lane_map: List[List[int]] = []
        for bi, (_env, specs) in enumerate(items):
            bh, bl = place["homes"][bi], place["locs"][bi]
            slots = []
            for li, t in enumerate(specs):
                s = bh[li]
                slots.append(s * L + bl[li])
                if attempt == 1 and self._kr \
                        and t.address in self.hot_contracts:
                    self.kr_lanes += 1
                if self._account_bucket(t.caller) != s:
                    self.cross_shard += 1
            lane_map.append(slots)
        total = sum(place["occupancy"])
        if attempt == 1 and total:
            self.load_imb_sum += max(place["occupancy"]) * 1000 * n // total
            self.load_imb_windows += 1
        return lane_map

    def _lane_gid(self, contract: bytes, key: bytes, lane: int,
                  p: M.MachineParams) -> int:
        return self._gid(contract, key, lane // p.batch)

    def _block_stride(self, handle: dict) -> int:
        return self.n_shards * handle["p"].batch

    def _lane_idx(self, handle: dict, bi: int, li: int) -> int:
        return handle["lane_map"][bi][li]

    def _on_result_fetch(self, handle: dict) -> None:
        EVENT_LOG.append(f"result_fetch:{handle['seq']}")

    def _discover_key(self, handle: dict, bi: int, li: int,
                      contract: bytes, key: bytes) -> None:
        # on the discovering lane's shard: the re-launch places the lane's
        # component around its copies, so discovery mints no replica
        self._gid(contract, key,
                  self._lane_idx(handle, bi, li) // handle["p"].batch)

    # --------------------------------------------------------- placement
    def _placements(self, items, premaps) -> dict:
        """Lane placement of one window, memoized on the premaps object
        (``can_pipeline``'s probe and the ``issue`` after it share it).
        Cold contracts' lanes go to their contract bucket; hot ones by
        conflict component (``_place_hot``).  Also plans the copies the
        packing will make: ``unmapped`` rows per shard and the window's
        multi-copy keys (``sync_need``)."""
        cached = self._place_cache
        if cached is not None and cached[0] is premaps:
            return cached[1]
        n = self.n_shards
        homes: List[List[int]] = []
        locs: List[List[int]] = []
        occupancy = [0] * n
        unmapped = [0] * n
        max_lanes = 1
        sync_keys: Dict[Tuple[bytes, bytes], None] = {}
        # the shards each key will have copies on after this window packs
        # (existing copies and earlier blocks' planned ones)
        planned: Dict[Tuple[bytes, bytes], set] = {}
        kr_active = False
        for (_env, specs), block_pre in zip(items, premaps):
            if self._kr and n > 1:
                per_contract: Dict[bytes, int] = {}
                for t in specs:
                    per_contract[t.address] = \
                        per_contract.get(t.address, 0) + 1
                for c, cnt in per_contract.items():
                    if cnt >= self._kr_threshold:
                        self.hot_contracts[c] = None  # sticky
            counters = [0] * n
            bh = [0] * len(specs)
            bl = [0] * len(specs)
            hot_lanes = []
            for li, t in enumerate(specs):
                if self._kr and n > 1 \
                        and t.address in self.hot_contracts:
                    hot_lanes.append(li)
                else:
                    s = self.shard_of(t.address)
                    bh[li] = s
                    bl[li] = counters[s]
                    counters[s] += 1
            if hot_lanes:
                kr_active = True
                self._place_hot(specs, block_pre, hot_lanes, counters,
                                bh, bl, planned)
            for li, t in enumerate(specs):
                s = bh[li]
                for k in block_pre[li]:
                    ck = (t.address, k)
                    have = planned.get(ck)
                    if have is None:
                        have = planned[ck] = {
                            cs for cs, _g in self.copies.get(ck, ())}
                    if s not in have:
                        unmapped[s] += 1
                        have.add(s)
                    if len(have) >= 2:
                        sync_keys[ck] = None
            max_lanes = max(max_lanes, max(counters))
            occupancy = [o + c for o, c in zip(occupancy, counters)]
            homes.append(bh)
            locs.append(bl)
        place = dict(homes=homes, locs=locs, occupancy=occupancy,
                     unmapped=unmapped, max_lanes=max_lanes,
                     sync_need=len(sync_keys), kr_active=kr_active)
        self._place_cache = (premaps, place)
        return place

    def _place_hot(self, specs, block_pre, hot_lanes, counters, bh,
                   bl, planned) -> None:
        """Union-find conflict components over one block's hot lanes, then
        each component to the shard holding most of its keys' copies
        (``planned`` first, so a sender stays put across the window's
        blocks), while that shard stays under a load cap; else the
        lightest shard."""
        n = self.n_shards
        parent = {li: li for li in hot_lanes}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        owner: Dict[Tuple[bytes, bytes], int] = {}
        for li in hot_lanes:
            addr = specs[li].address
            for k in block_pre[li]:
                o = owner.get((addr, k))
                if o is None:
                    owner[(addr, k)] = li
                else:
                    ra, rb = find(o), find(li)
                    if ra != rb:
                        parent[max(ra, rb)] = min(ra, rb)
        comps: Dict[int, List[int]] = {}
        for li in hot_lanes:
            comps.setdefault(find(li), []).append(li)
        # affinity is load-capped: following copies without a cap lets hot
        # keys accrete every component onto one shard window after window
        cap = max(1, (len(specs) * 5 + 4 * n - 1) // (4 * n))
        # biggest components first; ties by root lane
        for root in sorted(comps, key=lambda r: (-len(comps[r]), r)):
            lanes = comps[root]
            votes = [0] * n
            for li in lanes:
                addr = specs[li].address
                for k in block_pre[li]:
                    have = planned.get((addr, k))
                    if have is not None:
                        for s in have:
                            votes[s] += 1
                    else:
                        for s, _g in self.copies.get((addr, k), ()):
                            votes[s] += 1
            if any(votes):
                cands = sorted(range(n),
                               key=lambda s: (-votes[s], counters[s], s))
            else:
                # a fresh component anchors on its smallest key's range; a
                # keyless lane (nothing premapped yet) takes the lightest
                # shard
                anchor = min((k for li in lanes for k in block_pre[li]),
                             default=None)
                a = self._kr_home(anchor) if anchor is not None else None
                cands = sorted(range(n), key=lambda s: (counters[s], s))
                if a is not None:
                    cands = [a] + [s for s in cands if s != a]
            best = next((s for s in cands
                         if counters[s] + len(lanes) <= cap), None)
            if best is None:
                best = min(range(n), key=lambda s: (counters[s], s))
            for li in lanes:
                bh[li] = best
                bl[li] = counters[best]
                counters[best] += 1

    # ------------------------------------------------------------- shape
    def _occ_params(self, items, premaps):
        max_code = 64
        max_data = 64
        max_slots = 4
        place = self._placements(items, premaps)
        for (_env, specs), block_pre in zip(items, premaps):
            for t, pre in zip(specs, block_pre):
                info = T.scan_code(t.code, self.fork)
                if not info.eligible:
                    raise ValueError(
                        f"TxSpec code not device-eligible: {info.reason}")
                self._spec_id(t.code)  # the program set settles first
                max_code = max(max_code, len(t.code))
                max_data = max(max_data, len(t.calldata))
                max_slots = max(max_slots, len(pre) + 8)
        p = M.MachineParams(
            fork=self.fork,
            batch=_pow2(place["max_lanes"], 8),
            code_cap=_pow2(max_code, 256),
            data_cap=_pow2(max_data, 128),
            scache_cap=_pow2(max_slots, 8))
        g_need = max(len(v) + u
                     for v, u in zip(self.vals, place["unmapped"]))
        occ = M.OccParams(
            blocks=_pow2(len(items), 1),
            table_cap=_pow2(g_need + 1, 64),
            rounds=p.batch + 1)
        return self._apply_buckets(p, occ)

    def _device_tables(self, G: int):
        n = self.n_shards
        if self.table is not None and not self._stale \
                and G > self.table_cap:
            # every shard's arena pads in place on the device: row
            # s*G_old + g moves to s*G + g
            Go = self.table_cap

            def grow(tab):
                z = torch.zeros((n, G - Go, u256.LIMBS), dtype=torch.int32,
                                device=self.device)
                return torch.cat([tab.reshape(n, Go, u256.LIMBS), z],
                                 dim=1).reshape(n * G, u256.LIMBS)

            self.table = grow(self.table)
            self.key_tab = grow(self.key_tab)
            self.table_cap = G
        if self.table is None or self.table_cap != G or self._stale:
            tv = np.zeros((n * G, u256.LIMBS), dtype=np.int32)
            tk = np.zeros((n * G, u256.LIMBS), dtype=np.int32)
            for s in range(n):
                m = len(self.vals[s])
                if m:
                    tv[s * G:s * G + m] = u256.pack_np(self.vals[s])
                    tk[s * G:s * G + m] = u256.pack_np(
                        [int.from_bytes(k, "big")
                         for _c, k in self.gid_keys[s]])
            self.table = _upload(tv, self.device)
            self.key_tab = _upload(tk, self.device)
            self.table_cap = G
            self._synced = [len(v) for v in self.vals]
            self._stale = False
        else:
            rows, vals, keys = [], [], []
            for s in range(n):
                for g in range(self._synced[s], len(self.vals[s])):
                    rows.append(s * G + g)
                    vals.append(self.vals[s][g])
                    keys.append(int.from_bytes(self.gid_keys[s][g][1], "big"))
                self._synced[s] = len(self.vals[s])
            if rows:
                idx = np.asarray(rows, dtype=np.int64)
                _scatter_rows(self.table, idx, u256.pack_np(vals))
                _scatter_rows(self.key_tab, idx, u256.pack_np(keys))
        return self.table, self.key_tab

    # ---------------------------------------------------------- schedule
    def poll_clean(self, handle: dict) -> bool:
        """Fetch only the window's flags (K9's) and say whether every
        block committed clean on every shard: cheap enough to gate the
        next window's launch before the packed rows' fetch."""
        clean = handle.get("clean")
        if clean is None:
            ex = handle["ex"].cpu().numpy()
            EVENT_LOG.append(f"exchange_fetch:{handle['seq']}")
            clean = bool((ex[:, 0] == self.n_shards).all()
                         and (ex[:, 1] == 0).all())
            handle["clean"] = clean
        return clean

    def can_pipeline(self, items) -> bool:
        """True when launching ``items`` now needs no table rebuild (the
        per-shard cap holds and the device table is trusted), so the
        launch cannot read the not-yet-updated host mirror.  The window's
        premaps and shapes are kept for the ``issue`` that follows with
        the same items."""
        self._probe = None
        if self._stale or self.table is None:
            return False
        discovered = [[{} for _t in specs] for _env, specs in items]
        premaps, predicted = self._premaps(items, discovered)
        try:
            p, occ = self._occ_params(items, premaps)
        except ValueError:
            return False
        if occ.table_cap != self.table_cap:
            return False
        # a larger sync set would change the launch's shapes
        if self._xchg_bucket(self._place_cache[1]) != self._xchg_hw:
            return False
        self._probe = (items, discovered, premaps, predicted, p, occ)
        return True

    def _xchg_bucket(self, place: dict) -> int:
        """Sync-set rows a window needs: 0 until key-range placement first
        acts, then a pow2 ratchet over the multi-copy keys (floor 64, so
        the first hot window syncs even with an empty set)."""
        if not place["kr_active"] and not self._xchg_hw:
            return 0
        return max(self._xchg_hw, _pow2(max(place["sync_need"], 1), 64))

    # ------------------------------------------------------------- issue
    def pack(self, items, discovered=None, attempt: int = 1) -> dict:
        """The base runner's packing over the shards' lanes and arenas,
        plus the window's sync set: ``sync_rows`` (X, n + 1) on the device
        (key j's local row on each shard, ``table_cap`` where it has no
        copy, then its owner shard), or None while key-range placement
        has not acted; ``xchg_mode`` the reduces' mode."""
        handle = super().pack(items, discovered, attempt)
        n, G = self.n_shards, handle["occ"].table_cap
        place = self._placements(items, handle["premaps"])
        win_keys = dict.fromkeys(
            (t.address, k)
            for (_env, specs), pre in zip(items, handle["premaps"])
            for t, keys in zip(specs, pre) for k in keys)
        # the window's multi-copy keys
        sync = [ck for ck in win_keys if len(self.copies.get(ck, ())) >= 2]
        self._sync_last = len(sync)
        self._xchg_hw = max(self._xchg_bucket(place),
                            _pow2(max(len(sync), 1), 64) if sync else 0)
        rows = None
        if self._xchg_hw:
            if not self._xchg_locked:
                self._xchg_mode = exchange_mode(
                    len(sync), max(1, sum(place["occupancy"])), n,
                    forced=self.exchange, density=self.exchange_density)
                if sync or self.exchange:
                    self._xchg_locked = True
            if attempt == 1:
                if self._xchg_mode == "ppermute":
                    self.exchange_ppermute += 1
                else:
                    self.exchange_psum += 1
            # the owner is the first copy: the previous window's sync left
            # the value of record on its device row
            rows = np.full((self._xchg_hw, n + 1), G, dtype=np.int32)
            for j, ck in enumerate(sync):
                cps = self.copies[ck]
                for s, g in cps:
                    rows[j, s] = g
                rows[j, n] = cps[0][0]
            rows = _upload(rows, self.device)
        handle.update(sync_rows=rows, sync=len(sync),
                      xchg_mode=self._xchg_mode)
        return handle

    def issue(self, items, discovered=None, attempt: int = 1) -> dict:
        """Pack and launch one window (K9, its flags reduce inside);
        returns the handle for ``poll_clean`` and ``complete``.  Nothing
        here waits for the card.  Fault points: ``device/dispatch``
        before any packing, ``device/key_exchange`` at a launch that
        carries a sync set, ``device/shard_exchange`` after the launch."""
        faults.fire(PT_DISPATCH)  # the base runner's seam
        t0 = time.monotonic()
        handle = self.pack(items, discovered, attempt)
        t1 = time.monotonic()
        seq = _next_seq()
        EVENT_LOG.append(f"dispatch:{seq}")
        if handle["sync_rows"] is not None:
            faults.fire(PT_KEY_EXCHANGE)
        inputs = handle.pop("inputs")
        with obs.device_span("coreth/shard_occ_window"):
            out = M.run_occ_sharded(
                handle["p"], handle["occ"], handle.pop("table"),
                handle.pop("key_tab"), inputs, handle["spec"],
                self.n_shards, handle["sync_rows"], handle["xchg_mode"])
        self.table = out["table"]
        self.launches += 1
        faults.fire(PT_EXCHANGE)
        handle["ex"] = out["flags"]
        handle.update(out=out, active=inputs["active"], attempt=attempt,
                      seq=seq)
        self.last_handle = handle
        self.t_pack += t1 - t0
        self.t_machine += time.monotonic() - t1
        return handle
