"""Batched block replay (value-transfer slice)."""

from coreth_tpu_torch.replay.engine import (  # noqa: F401
    DeviceState, ReplayEngine, ReplayError, ReplayStats,
)
