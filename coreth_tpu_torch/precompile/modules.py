"""Stateful-precompile module registry.

Twin of reference precompile/modules/registerer.go: modules register at
reserved addresses (0x01/0x02/0x03 || 18*0x00 || xx) and are iterated in
deterministic (address) order — the order is consensus-relevant because
ApplyUpgrades writes state (state_processor.go:182-186).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

_RESERVED_PREFIXES = (b"\x01", b"\x02", b"\x03")
_RESERVED_BODY = b"\x00" * 18


def reserved_address(addr: bytes) -> bool:
    """modules/registerer.go:37 ReservedAddress."""
    return addr[:1] in _RESERVED_PREFIXES \
        and addr[1:19] == _RESERVED_BODY


@dataclass
class Module:
    address: bytes
    config_key: str
    contract: object  # Precompile with run_stateful
    # called by ApplyUpgrades; default = no state changes
    apply_upgrade: Callable = lambda *a, **k: None
    # activation timestamp (None = registered but inactive); modules
    # become visible through ChainConfig.rules() once active
    timestamp: Optional[int] = 0
    # optional precompileconfig.Predicater (predicate_gas/verify_predicate)
    predicater: object = None


def unregister_module(address: bytes) -> None:
    """Test hook: drop a registration (module registries in the
    reference are import-time-global too; tests need cleanup)."""
    _registry.pop(address, None)


_registry: Dict[bytes, Module] = {}


def register_module(module: Module) -> None:
    if not reserved_address(module.address):
        raise ValueError(
            f"address {module.address.hex()} not in a reserved range")
    for existing in _registry.values():
        if existing.config_key == module.config_key:
            raise ValueError(f"config key {module.config_key} already used")
    if module.address in _registry:
        raise ValueError(f"address {module.address.hex()} already used")
    _registry[module.address] = module


def registered_modules() -> List[Module]:
    """Sorted by address — deterministic iteration
    (registerer.go sortedness contract)."""
    return [m for _, m in sorted(_registry.items())]


def get_module(addr: bytes) -> Optional[Module]:
    return _registry.get(addr)
