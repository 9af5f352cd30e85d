"""The fault-injection registry: declared points, armed plans, firing.

Port of reference ``faults/registry.py``.

Design constraints (in order):

1. **Production cost ~zero.**  ``check()``/``fire()`` return after one
   module-global ``is None`` comparison when no plan is armed.  No
   dict lookup, no lock, no allocation.
2. **Deterministic.**  A plan owns a seeded ``random.Random``; its
   per-point hit counters and probability draws replay identically for
   the same plan + same call sequence, so a failing fault scenario is
   a reproducible test, not a flake.
3. **Declared ≠ armed.**  Every injection point is ``declare()``d at
   import time by the module that hosts it; ``declared()`` enumerates
   them so the completeness test (tests/test_torch_faults.py) can
   assert every point is exercised by at least one armed scenario — a
   new point cannot land untested.
"""

from __future__ import annotations

import json
import os
import random
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional


class FaultInjected(Exception):
    """Raised by an armed point that fires.  ``transient``
    mirrors the spec: retry-with-backoff is appropriate; persistent
    faults should strike toward demotion instead."""

    def __init__(self, point: str, transient: bool = False):
        super().__init__(f"injected fault at {point}"
                         + (" (transient)" if transient else ""))
        self.point = point
        self.transient = transient


@dataclass
class FaultSpec:
    """One point's arming.  A point that fires raises
    :class:`FaultInjected`; the reference's other actions (``sigkill``,
    ``stall``, site-interpreted verbs, with ``delay``) serve the
    streaming pipeline's seams, which the port does not run yet, so a
    plan naming them is refused (``TypeError``) rather than ignored.

    after: skip the first N eligible hits (fire mid-run, not at start).
    times: fire at most N times (None = every hit).
    prob: per-hit firing probability, drawn from the plan's seeded RNG.
    transient: carried onto FaultInjected (retryable vs strike).
    """

    after: int = 0
    times: Optional[int] = None
    prob: float = 1.0
    transient: bool = False


class FaultPlan:
    """Armed point -> spec map with deterministic per-point state."""

    def __init__(self, points: Dict[str, object], seed: int = 0):
        self.points: Dict[str, FaultSpec] = {}
        for name, spec in points.items():
            if isinstance(spec, dict):
                spec = FaultSpec(**spec)
            self.points[name] = spec
        self.seed = seed
        self._rng = random.Random(seed)
        self._hits: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        # plans are consulted from several pipeline threads (feed,
        # prefetch, execute); the counters must not tear
        self._lock = threading.Lock()

    def hit(self, point: str) -> Optional[FaultSpec]:
        """One eligible pass through ``point``; the spec iff it fires."""
        spec = self.points.get(point)
        if spec is None:
            return None
        with self._lock:
            n = self._hits.get(point, 0)
            self._hits[point] = n + 1
            if n < spec.after:
                return None
            if spec.times is not None \
                    and self._fired.get(point, 0) >= spec.times:
                return None
            if spec.prob < 1.0 and self._rng.random() >= spec.prob:
                return None
            self._fired[point] = self._fired.get(point, 0) + 1
        return spec

    def fired(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._fired)


# ------------------------------------------------------------------ registry

_DECLARED: Dict[str, str] = {}
_PLAN: Optional[FaultPlan] = None


def declare(name: str, doc: str) -> str:
    """Register an injection point (call at import of the hosting
    module).  Returns ``name`` so sites can bind it to a constant."""
    _DECLARED[name] = doc
    return name


def declared() -> Dict[str, str]:
    """Every declared point -> its one-line doc."""
    return dict(_DECLARED)


def arm(plan: FaultPlan) -> None:
    global _PLAN
    _PLAN = plan


def disarm() -> None:
    global _PLAN
    _PLAN = None


@contextmanager
def armed(plan: FaultPlan):
    """Scoped arming for tests; restores the previous plan on exit."""
    global _PLAN
    prev = _PLAN
    _PLAN = plan
    try:
        yield plan
    finally:
        _PLAN = prev


def arm_from_env() -> Optional[FaultPlan]:
    """Arm CORETH_FAULT_PLAN if set and nothing is armed yet (inline
    JSON, or ``@path`` to a JSON file).  Idempotent — pipeline and
    engine constructors both call this, whoever runs first wins."""
    global _PLAN
    if _PLAN is not None:
        return _PLAN
    raw = os.environ.get("CORETH_FAULT_PLAN")
    if not raw:
        return None
    if raw.startswith("@"):
        with open(raw[1:], "r", encoding="utf-8") as f:
            raw = f.read()
    obj = json.loads(raw)
    seed = int(obj.pop("seed", 0)) if isinstance(obj, dict) else 0
    points = obj.get("points", obj)
    _PLAN = FaultPlan(points, seed=seed)
    return _PLAN


def check(point: str) -> Optional[FaultSpec]:
    """Armed spec for one eligible pass if the point fires, else None;
    raises nothing."""
    plan = _PLAN
    if plan is None:  # the production path: one comparison
        return None
    return plan.hit(point)


def fire(point: str) -> None:
    """check(), raising :class:`FaultInjected` if the point fires."""
    spec = check(point)
    if spec is not None:
        raise FaultInjected(point, transient=spec.transient)


def fired(point: Optional[str] = None):
    """Fired counts of the armed plan ({} / 0 when disarmed)."""
    plan = _PLAN
    if plan is None:
        return 0 if point is not None else {}
    counts = plan.fired()
    if point is not None:
        return counts.get(point, 0)
    return counts
