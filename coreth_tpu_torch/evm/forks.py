"""The fork lattice of the accelerated fork tail.

Port of reference ``evm/forks.py`` (pure Python, copied): which opcodes
each supported fork introduces and which feature flags it switches on
(EIP-3529 refunds, the EIP-3651 warm coinbase, ...).  The device tables
and the native host session derive their per-fork sets from here.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, Tuple

# Fork keys the accelerated backends (native engine, device machine)
# support, oldest first.  Pre-AP2 has no EIP-2929 warm/cold accounting
# and live legacy refunds neither backend models.
SUPPORTED: Tuple[str, ...] = ("ap2", "ap3", "durango", "cancun")

# Opcodes each fork INTRODUCES relative to its predecessor in the
# supported tail (AP2 is the base).
INTRODUCED: Dict[str, FrozenSet[int]] = {
    "ap3": frozenset({0x48}),                    # BASEFEE (EIP-3198)
    "durango": frozenset({0x5F}),                # PUSH0 (EIP-3855)
    "cancun": frozenset({0x49, 0x4A,             # BLOBHASH BLOBBASEFEE
                         0x5C, 0x5D, 0x5E}),     # TLOAD TSTORE MCOPY
}

# Feature flags each fork INTRODUCES (monotone: once on, stays on).
FEATURES_INTRODUCED: Dict[str, FrozenSet[str]] = {
    "ap2": frozenset({"eip2929"}),
    # AP3 re-enables refunds at the reduced EIP-3529 schedule
    # (jump_table.new_ap3_table passes with_refunds=True)
    "ap3": frozenset({"eip3529_refunds", "basefee"}),
    # EIP-3651 warm coinbase (statedb.prepare's is_durango branch)
    "durango": frozenset({"push0", "warm_coinbase"}),
    "cancun": frozenset({"transient_storage", "mcopy", "blobs"}),
}


def fork_index(fork: str) -> int:
    try:
        return SUPPORTED.index(fork)
    except ValueError:
        raise ValueError(f"unknown fork {fork!r} (supported: {SUPPORTED})")


def at_or_after(fork: str, base: str) -> bool:
    """True when ``fork`` is ``base`` or a later supported fork."""
    return fork_index(fork) >= fork_index(base)


def features(fork: str) -> FrozenSet[str]:
    """All feature flags active at ``fork`` (cumulative)."""
    idx = fork_index(fork)
    out: set = set()
    for f in SUPPORTED[:idx + 1]:
        out |= FEATURES_INTRODUCED.get(f, frozenset())
    return frozenset(out)


def forks_with(feature: str) -> Tuple[str, ...]:
    """The supported forks where ``feature`` is active, oldest first."""
    return tuple(f for f in SUPPORTED if feature in features(f))


def introduced_ops(fork: str) -> FrozenSet[int]:
    """Opcodes live at ``fork`` that the AP2 base does not define."""
    idx = fork_index(fork)
    out: set = set()
    for f in SUPPORTED[:idx + 1]:
        out |= INTRODUCED.get(f, frozenset())
    return frozenset(out)


def _all_introduced() -> FrozenSet[int]:
    out: set = set()
    for ops in INTRODUCED.values():
        out |= ops
    return frozenset(out)


def gate(fork: str, ops: Iterable[int]) -> FrozenSet[int]:
    """Filter a backend's opcode pool down to what ``fork`` defines:
    drop every fork-introduced opcode not yet live at ``fork``.  Ops
    outside the INTRODUCED lattice (the frontier..AP2 base) pass
    through untouched — callers own the claim that they compile them.
    """
    inactive = _all_introduced() - introduced_ops(fork)
    return frozenset(ops) - inactive


def extra_for(fork: str, compiled: Iterable[int]) -> FrozenSet[int]:
    """The fork-gated EXTRAS a backend may claim at ``fork``: the
    subset of ``compiled`` (the fork-introduced ops the backend
    actually implements) that is live at ``fork``."""
    return frozenset(compiled) & introduced_ops(fork)


# Derived constant tuples.
REFUND_FORKS: Tuple[str, ...] = forks_with("eip3529_refunds")
COINBASE_WARM_FORKS: Tuple[str, ...] = forks_with("warm_coinbase")
