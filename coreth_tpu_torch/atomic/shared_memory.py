"""Shared memory — the cross-chain UTXO mailbox.

Port of reference ``atomic/shared_memory.py``.

Twin of avalanchego's atomic.Memory/SharedMemory as the reference's
tests use it (plugin/evm/vm_test.go:219 atomic.NewMemory on memdb):
each ordered chain pair shares a KV space; a chain's exports PUT UTXO
bytes into the peer's inbound view, imports REMOVE consumed UTXOs.
Apply() takes batched requests keyed by peer chain so a block's whole
atomic effect lands atomically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class Element:
    """One shared-memory value with address traits for indexing."""
    key: bytes
    value: bytes
    traits: List[bytes] = field(default_factory=list)


@dataclass
class Requests:
    """Batch of operations against ONE peer chain's shared space."""
    remove_requests: List[bytes] = field(default_factory=list)
    put_requests: List[Element] = field(default_factory=list)


class SharedMemory:
    """The view chain `chain_id` has of its shared spaces."""

    def __init__(self, memory: "Memory", chain_id: bytes):
        self.memory = memory
        self.chain_id = chain_id

    def get(self, peer_chain: bytes, keys: List[bytes]) -> List[bytes]:
        space = self.memory._space(peer_chain, self.chain_id)
        out = []
        for k in keys:
            if k not in space:
                raise KeyError(k.hex())
            out.append(space[k])
        return out

    def indexed(self, peer_chain: bytes, traits: List[bytes],
                limit: int = 100) -> List[bytes]:
        """Values in OUR inbound space owned by any of `traits`
        (GetUTXOs shape)."""
        space = self.memory._space(peer_chain, self.chain_id)
        tindex = self.memory._traits(peer_chain, self.chain_id)
        seen = []
        for t in traits:
            for k in tindex.get(t, []):
                v = space.get(k)
                if v is not None and v not in seen:
                    seen.append(v)
                    if len(seen) >= limit:
                        return seen
        return seen

    def validate_removes(self, requests: Dict[bytes, Requests]) -> None:
        """Raise if any remove targets an absent key, before anything
        is mutated (callers use this to keep accept-time state — trie,
        pending maps, shared memory — consistent on failure)."""
        for peer_chain, req in requests.items():
            inbound = self.memory._space(peer_chain, self.chain_id)
            for k in req.remove_requests:
                if k not in inbound:
                    raise KeyError(
                        f"shared-memory remove of absent key {k.hex()}")

    def apply(self, requests: Dict[bytes, Requests]) -> None:
        """Apply a block's atomic ops (atomic_backend.go:252 shape):
        removes target OUR inbound view (consuming imports), puts land
        in the PEER's inbound view (exports).

        Removing a key that is not present raises: a silent no-op here
        would mask a double-spend that slipped past verification (the
        backend's ancestor-conflict check is the first line of defense;
        this is the backstop).  All removes are validated up front so a
        rejected batch leaves shared memory untouched — atomicity is
        part of this method's contract."""
        self.validate_removes(requests)
        self._apply_ops(requests)

    def _apply_ops(self, requests: Dict[bytes, Requests]) -> None:
        """The remove/put + trait-index bookkeeping, after ``apply``
        validated the removes."""
        for peer_chain, req in requests.items():
            inbound = self.memory._space(peer_chain, self.chain_id)
            in_traits = self.memory._traits(peer_chain, self.chain_id)
            in_rev = self.memory._key_traits(peer_chain, self.chain_id)
            for k in req.remove_requests:
                if inbound.pop(k, None) is None:
                    continue
                for t in in_rev.pop(k, []):
                    lst = in_traits.get(t)
                    if lst and k in lst:
                        lst.remove(k)
            out_space = self.memory._space(self.chain_id, peer_chain)
            out_traits = self.memory._traits(self.chain_id, peer_chain)
            out_rev = self.memory._key_traits(self.chain_id, peer_chain)
            for el in req.put_requests:
                if el.key not in out_space:
                    out_rev[el.key] = list(el.traits)
                    for t in el.traits:
                        out_traits.setdefault(t, []).append(el.key)
                out_space[el.key] = el.value


class Memory:
    """Process-wide shared memory hub (atomic.NewMemory)."""

    def __init__(self):
        # (from_chain, to_chain) -> key/value space written by from_chain
        self._spaces: Dict[Tuple[bytes, bytes], Dict[bytes, bytes]] = {}
        self._trait_idx: Dict[Tuple[bytes, bytes],
                              Dict[bytes, List[bytes]]] = {}
        # reverse map key -> traits so removes can prune the index
        self._key_trait_idx: Dict[Tuple[bytes, bytes],
                                  Dict[bytes, List[bytes]]] = {}

    def _space(self, from_chain: bytes, to_chain: bytes):
        return self._spaces.setdefault((from_chain, to_chain), {})

    def _traits(self, from_chain: bytes, to_chain: bytes):
        return self._trait_idx.setdefault((from_chain, to_chain), {})

    def _key_traits(self, from_chain: bytes, to_chain: bytes):
        return self._key_trait_idx.setdefault((from_chain, to_chain), {})

    def new_shared_memory(self, chain_id: bytes) -> SharedMemory:
        return SharedMemory(self, chain_id)
