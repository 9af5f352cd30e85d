"""Chain configuration, fork schedule, and protocol gas constants.

Semantic twin of reference ``params/`` (config.go:474, protocol_params.go,
avalanche_params.go).
"""

from coreth_tpu_torch.params.protocol import *  # noqa: F401,F403
from coreth_tpu_torch.params.config import (  # noqa: F401
    ChainConfig,
    Rules,
    TEST_CHAIN_CONFIG,
    TEST_LAUNCH_CONFIG,
    TEST_APRICOT_PHASE1_CONFIG,
    TEST_APRICOT_PHASE2_CONFIG,
    TEST_APRICOT_PHASE3_CONFIG,
    TEST_APRICOT_PHASE4_CONFIG,
    TEST_APRICOT_PHASE5_CONFIG,
    TEST_BANFF_CONFIG,
    TEST_CORTINA_CONFIG,
    TEST_DURANGO_CONFIG,
)
