"""Chain configuration, fork schedule, and protocol gas constants.

Semantic twin of reference ``params/`` (config.go:474, protocol_params.go,
avalanche_params.go).
"""

from coreth_tpu_torch.params.protocol import *  # noqa: F401,F403
from coreth_tpu_torch.params.config import (  # noqa: F401
    ChainConfig,
    Rules,
    TEST_CHAIN_CONFIG,
)
