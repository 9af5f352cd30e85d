"""Chain configuration + fork schedule.

Semantic twin of reference params/config.go:474-1100.  Ethereum forks
activate by block number; Avalanche upgrades (ApricotPhase1..Durango)
activate by block timestamp.  ``Rules`` is the flattened per-block view the
EVM / processor consult (reference params/config.go:1027).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ChainConfig:
    chain_id: int = 43111
    # Ethereum block-number forks (all active from genesis on Avalanche nets)
    homestead_block: Optional[int] = 0
    eip150_block: Optional[int] = 0
    eip155_block: Optional[int] = 0
    eip158_block: Optional[int] = 0
    byzantium_block: Optional[int] = 0
    constantinople_block: Optional[int] = 0
    petersburg_block: Optional[int] = 0
    istanbul_block: Optional[int] = 0
    muir_glacier_block: Optional[int] = 0
    # per-config stateful-precompile activation overrides, keyed by
    # Module.config_key (None entry = disabled for this config)
    precompile_upgrades: Optional[dict] = None
    # Avalanche timestamp upgrades (None = never active)
    apricot_phase1_time: Optional[int] = None
    apricot_phase2_time: Optional[int] = None
    apricot_phase3_time: Optional[int] = None
    apricot_phase4_time: Optional[int] = None
    apricot_phase5_time: Optional[int] = None
    apricot_phase_pre6_time: Optional[int] = None
    apricot_phase6_time: Optional[int] = None
    apricot_phase_post6_time: Optional[int] = None
    banff_time: Optional[int] = None
    cortina_time: Optional[int] = None
    durango_time: Optional[int] = None
    cancun_time: Optional[int] = None

    # --- block-number forks ------------------------------------------------
    def is_homestead(self, num: int) -> bool:
        return _active_block(self.homestead_block, num)

    def is_eip150(self, num: int) -> bool:
        return _active_block(self.eip150_block, num)

    def is_eip155(self, num: int) -> bool:
        return _active_block(self.eip155_block, num)

    def is_eip158(self, num: int) -> bool:
        return _active_block(self.eip158_block, num)

    def is_byzantium(self, num: int) -> bool:
        return _active_block(self.byzantium_block, num)

    def is_constantinople(self, num: int) -> bool:
        return _active_block(self.constantinople_block, num)

    def is_petersburg(self, num: int) -> bool:
        return _active_block(self.petersburg_block, num)

    def is_istanbul(self, num: int) -> bool:
        return _active_block(self.istanbul_block, num)

    # --- timestamp upgrades ------------------------------------------------
    def is_apricot_phase1(self, time: int) -> bool:
        return _active_time(self.apricot_phase1_time, time)

    def is_apricot_phase2(self, time: int) -> bool:
        return _active_time(self.apricot_phase2_time, time)

    def is_apricot_phase3(self, time: int) -> bool:
        return _active_time(self.apricot_phase3_time, time)

    def is_apricot_phase4(self, time: int) -> bool:
        return _active_time(self.apricot_phase4_time, time)

    def is_apricot_phase5(self, time: int) -> bool:
        return _active_time(self.apricot_phase5_time, time)

    def is_apricot_phase_pre6(self, time: int) -> bool:
        return _active_time(self.apricot_phase_pre6_time, time)

    def is_apricot_phase6(self, time: int) -> bool:
        return _active_time(self.apricot_phase6_time, time)

    def is_apricot_phase_post6(self, time: int) -> bool:
        return _active_time(self.apricot_phase_post6_time, time)

    def is_banff(self, time: int) -> bool:
        return _active_time(self.banff_time, time)

    def is_cortina(self, time: int) -> bool:
        return _active_time(self.cortina_time, time)

    def is_durango(self, time: int) -> bool:
        return _active_time(self.durango_time, time)

    def is_cancun(self, num: int, time: int) -> bool:
        return _active_time(self.cancun_time, time)

    def precompile_activation_time(self, module):
        """Per-config activation override by config_key (the reference
        resolves activation from the chain config's upgrade schedule,
        config.go getActivePrecompileConfig) — falls back to the
        module's registry default."""
        overrides = self.precompile_upgrades or {}
        return overrides.get(module.config_key, module.timestamp)

    def precompile_active(self, module, timestamp: int) -> bool:
        at = self.precompile_activation_time(module)
        return at is not None and timestamp >= at

    def rules(self, num: int, timestamp: int) -> "Rules":
        """Flattened rule set for a block (reference config.go:1027-1100).

        Registered stateful-precompile modules active at `timestamp`
        populate active_precompiles/predicaters (config.go Rules
        ActivePrecompiles — here fed by the module registry)."""
        from coreth_tpu_torch.precompile.modules import registered_modules
        active = {}
        predicaters = {}
        for m in registered_modules():
            if not self.precompile_active(m, timestamp):
                continue
            active[m.address] = m.contract
            if m.predicater is not None:
                predicaters[m.address] = m.predicater
        return Rules(
            active_precompiles=active,
            predicaters=predicaters,
            chain_id=self.chain_id,
            is_homestead=self.is_homestead(num),
            is_eip150=self.is_eip150(num),
            is_eip155=self.is_eip155(num),
            is_eip158=self.is_eip158(num),
            is_byzantium=self.is_byzantium(num),
            is_constantinople=self.is_constantinople(num),
            is_petersburg=self.is_petersburg(num),
            is_istanbul=self.is_istanbul(num),
            is_apricot_phase1=self.is_apricot_phase1(timestamp),
            is_apricot_phase2=self.is_apricot_phase2(timestamp),
            is_apricot_phase3=self.is_apricot_phase3(timestamp),
            is_apricot_phase4=self.is_apricot_phase4(timestamp),
            is_apricot_phase5=self.is_apricot_phase5(timestamp),
            is_apricot_phase_pre6=self.is_apricot_phase_pre6(timestamp),
            is_apricot_phase6=self.is_apricot_phase6(timestamp),
            is_apricot_phase_post6=self.is_apricot_phase_post6(timestamp),
            is_banff=self.is_banff(timestamp),
            is_cortina=self.is_cortina(timestamp),
            is_durango=self.is_durango(timestamp),
            is_cancun=self.is_cancun(num, timestamp),
        )


@dataclass
class Rules:
    chain_id: int = 43111
    is_homestead: bool = False
    is_eip150: bool = False
    is_eip155: bool = False
    is_eip158: bool = False
    is_byzantium: bool = False
    is_constantinople: bool = False
    is_petersburg: bool = False
    is_istanbul: bool = False
    is_apricot_phase1: bool = False
    is_apricot_phase2: bool = False
    is_apricot_phase3: bool = False
    is_apricot_phase4: bool = False
    is_apricot_phase5: bool = False
    is_apricot_phase_pre6: bool = False
    is_apricot_phase6: bool = False
    is_apricot_phase_post6: bool = False
    is_banff: bool = False
    is_cortina: bool = False
    is_durango: bool = False
    is_cancun: bool = False
    # address -> stateful precompile module (filled by precompile registry)
    active_precompiles: dict = field(default_factory=dict)
    predicaters: dict = field(default_factory=dict)

    # EIP-1559-style semantics arrive with ApricotPhase3 on Avalanche
    @property
    def is_london(self) -> bool:
        return self.is_apricot_phase3

    # EIP-2929/2930 semantics arrive with ApricotPhase2
    @property
    def is_berlin(self) -> bool:
        return self.is_apricot_phase2

    # EIP-3529 refund reduction + EIP-3541 arrive with ApricotPhase3
    @property
    def is_eip3529(self) -> bool:
        return self.is_apricot_phase3


def _active_block(fork: Optional[int], num: int) -> bool:
    return fork is not None and fork <= num


def _active_time(fork: Optional[int], time: int) -> bool:
    return fork is not None and fork <= time


def _phases(n: int, chain_id: int = 43111, **extra) -> ChainConfig:
    """Config with apricot phases 1..n active from genesis."""
    names = ["apricot_phase1_time", "apricot_phase2_time",
             "apricot_phase3_time", "apricot_phase4_time",
             "apricot_phase5_time", "apricot_phase_pre6_time",
             "apricot_phase6_time", "apricot_phase_post6_time",
             "banff_time", "cortina_time", "durango_time"]
    kw = {k: 0 for k in names[:n]}
    kw.update(extra)
    return ChainConfig(chain_id=chain_id, **kw)


# Test configurations mirroring reference params/config.go:74-240
TEST_LAUNCH_CONFIG = _phases(0)
TEST_APRICOT_PHASE1_CONFIG = _phases(1)
TEST_APRICOT_PHASE2_CONFIG = _phases(2)
TEST_APRICOT_PHASE3_CONFIG = _phases(3)
TEST_APRICOT_PHASE4_CONFIG = _phases(4)
TEST_APRICOT_PHASE5_CONFIG = _phases(5)
TEST_BANFF_CONFIG = _phases(9)
TEST_CORTINA_CONFIG = _phases(10)
TEST_DURANGO_CONFIG = _phases(11)
# The "everything on" config used by most tests (reference TestChainConfig)
TEST_CHAIN_CONFIG = _phases(11, chain_id=43111)
