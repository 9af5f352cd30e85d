"""Call targets that are not plain accounts.

A cut of reference ``evm/precompiles.py`` (the per-fork precompile
address sets, contracts.go ActivePrecompiles), ``precompile/modules.py``
(reserved stateful-precompile ranges, registerer.go:37) and
``processor/state_transition.py`` (``is_prohibited``, evm.go:54): only
the addresses, which is all the transfer classifier reads — a tx to one
of them executes (or rejects) despite the target having no code, so it
is never a plain value transfer.
"""

from __future__ import annotations

from typing import FrozenSet


def _addr(n: int) -> bytes:
    return n.to_bytes(20, "big")


# classic precompiles 0x01..0x09 (blake2f at 0x09 from Istanbul)
_CLASSIC = frozenset(_addr(i) for i in range(1, 9))
BLAKE2F_ADDR = _addr(9)
# Avalanche-specific (contracts.go:40-50)
GENESIS_CONTRACT_ADDR = bytes.fromhex(
    "0100000000000000000000000000000000000000")
NATIVE_ASSET_BALANCE_ADDR = bytes.fromhex(
    "0100000000000000000000000000000000000001")
NATIVE_ASSET_CALL_ADDR = bytes.fromhex(
    "0100000000000000000000000000000000000002")
# the blackhole: the coinbase of every block, prohibited as a call target
BLACKHOLE_ADDR = bytes.fromhex("0100000000000000000000000000000000000000")

_HOMESTEAD = frozenset(_addr(i) for i in range(1, 5))
_AVALANCHE = frozenset({GENESIS_CONTRACT_ADDR, NATIVE_ASSET_BALANCE_ADDR,
                        NATIVE_ASSET_CALL_ADDR})

_RESERVED_PREFIXES = (b"\x01", b"\x02", b"\x03")
_RESERVED_BODY = b"\x00" * 18


def special_call_targets(rules) -> FrozenSet[bytes]:
    """Precompile addresses active under ``rules`` (every fork from
    Apricot Phase 2 on keeps the three Avalanche addresses, deprecated
    or not, at the same places)."""
    if rules.is_apricot_phase2:
        return _CLASSIC | {BLAKE2F_ADDR} | _AVALANCHE
    if rules.is_istanbul:
        return _CLASSIC | {BLAKE2F_ADDR}
    if rules.is_byzantium:
        return _CLASSIC
    return _HOMESTEAD


def reserved_address(addr: bytes) -> bool:
    """modules/registerer.go:37 ReservedAddress."""
    return addr[:1] in _RESERVED_PREFIXES \
        and addr[1:19] == _RESERVED_BODY


def is_prohibited(addr: bytes) -> bool:
    """Blackhole + reserved precompile ranges (evm.go:54 IsProhibited)."""
    return addr == BLACKHOLE_ADDR or reserved_address(addr)
