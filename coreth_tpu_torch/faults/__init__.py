"""Deterministic fault injection for the replay stack.

Port of reference ``faults/``.  A :class:`FaultPlan` arms named
injection points that the replay path threads through its failure
seams (the kernels' dispatch, the shards' exchanges, the native
boundary, the commit pipeline, sender recovery).
Unarmed — the production state — every point is ONE module-global
``None`` check; armed, the plan decides per hit (seeded, so a plan
replays identically) whether the point fires, and a point that fires
raises a :class:`FaultInjected`.

``CORETH_FAULT_PLAN`` arms a plan from the environment (inline JSON or
``@/path/to/plan.json``); ``ReplayEngine`` calls ``arm_from_env`` at
construction, as the reference's engine does.
"""

from coreth_tpu_torch.faults.registry import (
    FaultInjected, FaultPlan, FaultSpec, arm, arm_from_env, armed,
    check, declare, declared, disarm, fire, fired,
)

__all__ = [
    "FaultInjected", "FaultPlan", "FaultSpec", "arm", "arm_from_env",
    "armed", "check", "declare", "declared", "disarm", "fire", "fired",
]
