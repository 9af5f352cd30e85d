"""Backend supervisor: retry, demote, probe, quarantine.

Port of reference ``replay/supervisor.py``.  The replay stack already
has a correctness ladder — the kernels on the card -> the native host
session -> the Python interpreter — and per-tx / per-block *semantic*
escapes move work down it.  The supervisor adds the *fault* dimension:

- **transient faults retry** with bounded exponential backoff
  (``retries`` / ``backoff``);
- **repeated failures demote** the affected scope — ``device`` (every
  kernel dispatch: transfer windows, fused OCC windows, the shards'
  exchanges) or ``native`` (the hostexec C++ session) — for a cooldown
  (``strikes`` strikes -> ``cooldown`` seconds, doubling per
  re-demotion up to 8x).  A demoted ``device`` routes blocks through
  the exact host path; a demoted ``native`` routes txs through the
  Python interpreter.  Roots stay bit-identical either way — the
  ladder only ever trades speed;
- **re-promotion probes**: once the cooldown lapses the next eligible
  dispatch simply tries the backend again; success promotes, failure
  re-demotes with a longer cooldown;
- **armed-oracle divergences** (``host_exec_check``) hard-demote
  ``native`` immediately — a backend that disagrees with the
  interpreter is wrong, not slow;
- **poison blocks** — blocks that fail validation on every backend —
  are *quarantined* by callers that opt in
  (``ReplayEngine.quarantine_block``): counted here.

What the supervisor catches differs from the reference on purpose.
The reference's ``run`` strikes (and retries) on ANY exception, so a
kernel that fails to build, a CUDA error at launch or an out-of-memory
would send the chain to the host path and the run would still end
well.  Here the ``device`` and ``commit`` scopes strike only on an
injected :class:`~coreth_tpu_torch.faults.FaultInjected`, and the
``native`` scope on that and on the hostexec session's own
:class:`~coreth_tpu_torch.evm.hostexec.backend.SessionError`; every
other exception (a build error, a CUDA error, an OOM, a Python error)
propagates unchanged, so no fault of the card or of a kernel hides
behind the host path.

The reference's ``CORETH_SUPERVISOR_RETRIES`` / ``_BACKOFF`` /
``_STRIKES`` / ``_COOLDOWN`` are the constructor's ``retries``,
``backoff``, ``strikes`` and ``cooldown``.  Counters mirror into the
metrics registry under ``supervisor/*`` (``publish``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from coreth_tpu_torch import faults, obs


class BackendFault(Exception):
    """A supervised call failed past its retry budget; the caller must
    route the work down the ladder (the supervisor has already counted
    the strike and applied any demotion)."""

    def __init__(self, scope: str, cause: BaseException):
        super().__init__(f"backend fault in scope {scope!r}: {cause!r}")
        self.scope = scope
        self.cause = cause


def _struck_by(scope: str) -> tuple:
    """The exception types a failure in ``scope`` strikes on; anything
    else propagates."""
    if scope == "native":
        from coreth_tpu_torch.evm.hostexec.backend import SessionError
        return (faults.FaultInjected, SessionError)
    return (faults.FaultInjected,)


class BackendSupervisor:
    """Per-engine fault policy for the execution ladder.

    Scopes: ``device`` (the kernel dispatch paths), ``native`` (the
    hostexec C++ session) and ``commit`` (the window fold, which has
    no alternative backend: a persistent flush failure is fatal, but
    shares the retry and strike accounting).  ``allows(scope)`` is the
    routing gate the classify / dispatch sites consult; ``run(scope,
    point, fn, *args)`` wraps a supervised call with injection, retry
    and strike accounting.  ``clock`` and ``sleep`` are injectable so
    the cooldown logic is testable without sleeping.
    """

    SCOPES = ("device", "native", "commit")
    COOLDOWN_CAP = 8  # max cooldown growth factor across re-demotions

    def __init__(self, engine=None, registry=None, clock=time.monotonic,
                 sleep=time.sleep, retries: int = 2,
                 backoff: float = 0.05, strikes: int = 3,
                 cooldown: float = 30.0):
        self.engine = engine
        self._registry = registry
        self._clock = clock
        self._sleep = sleep
        self.max_retries = retries
        self.backoff = backoff
        self.strikes_to_demote = strikes
        self.cooldown = cooldown
        # per-scope cooldown is None until a re-demotion doubles it, so
        # late tuning of self.cooldown takes effect; "seq" counts the
        # strikes ever recorded for the scope — run() snapshots it to
        # tell a strike-free success from a partial-progress return that
        # contained its own fault
        self._state: Dict[str, dict] = {
            s: {"strikes": 0, "demoted": False, "until": 0.0,
                "cooldown": None, "seq": 0}
            for s in self.SCOPES
        }
        # strike / ok / quarantine accounting holds _mu: a reader may
        # snapshot() while the replay thread strikes
        self._mu = threading.Lock()
        self.retries = 0
        self.demotions = 0
        self.promotions = 0
        self.strikes = 0
        self.quarantined = 0
        # seconds from the first strike of a scope to its demotion
        self._first_strike_t: Dict[str, Optional[float]] = {
            s: None for s in self.SCOPES}
        self.demote_latency_s: Dict[str, float] = {}
        # the newest ladder transition (demote / probe_failed /
        # promote) on the injected clock, mirrored into the obs event
        # stream so a trace shows WHEN routing flipped
        self.last_transition: Optional[dict] = None

    def _transition(self, kind: str, scope: str) -> None:
        self.last_transition = {"kind": kind, "scope": scope,
                                "at_s": round(self._clock(), 3)}
        obs.instant(f"supervisor/{kind}", scope=scope)

    # ------------------------------------------------------------ routing
    def allows(self, scope: str) -> bool:
        """May work route to ``scope`` right now?  True while healthy,
        False while demoted-and-cooling; True again once the cooldown
        lapses (the probe — the next supervised call decides)."""
        st = self._state[scope]
        if not st["demoted"]:
            return True
        return self._clock() >= st["until"]

    def demoted(self, scope: str) -> bool:
        return self._state[scope]["demoted"]

    # ----------------------------------------------------------- outcomes
    def note_ok(self, scope: str) -> None:
        """A supervised call in ``scope`` succeeded: reset strikes; a
        success after the cooldown lapsed is a successful probe and
        re-promotes the scope (cooldown resets too)."""
        with self._mu:
            st = self._state[scope]
            st["strikes"] = 0
            self._first_strike_t[scope] = None
            if st["demoted"] and self._clock() >= st["until"]:
                st["demoted"] = False
                st["cooldown"] = None
                self.promotions += 1
                self._transition("promote", scope)

    def strike(self, scope: str, exc: BaseException,
               hard: bool = False) -> None:
        """A supervised call failed past retries.  ``hard`` demotes
        immediately (oracle divergence — the backend is *wrong*)."""
        now = self._clock()
        with self._mu:
            st = self._state[scope]
            self.strikes += 1
            st["seq"] += 1
            if self._first_strike_t[scope] is None:
                self._first_strike_t[scope] = now
            if st["demoted"]:
                if now >= st["until"]:
                    # failed probe: re-demote, back off harder
                    st["cooldown"] = min(
                        (st["cooldown"] or self.cooldown) * 2,
                        self.cooldown * self.COOLDOWN_CAP)
                    st["until"] = now + st["cooldown"]
                    self.demotions += 1
                    self._transition("probe_failed", scope)
                return
            st["strikes"] += 1
            if hard or st["strikes"] >= self.strikes_to_demote:
                st["demoted"] = True
                st["until"] = now + (st["cooldown"] or self.cooldown)
                self.demotions += 1
                self._transition("demote", scope)
                first = self._first_strike_t[scope]
                if first is not None:
                    self.demote_latency_s[scope] = round(now - first, 4)

    def note_quarantined(self) -> None:
        with self._mu:
            self.quarantined += 1

    def _backoff(self, delay: float) -> float:
        """Count one retry and sleep ``delay``; the next delay."""
        with self._mu:
            self.retries += 1
        self._sleep(delay)
        return delay * 2

    # --------------------------------------------------------- supervision
    def run(self, scope: str, point: Optional[str], fn, *args):
        """Run ``fn(*args)`` under supervision: fire the injection
        point first (no-op unarmed), retry transient faults with
        bounded exponential backoff, and convert a persistent failure
        into a strike + :class:`BackendFault`.  Only the exceptions the
        scope strikes on (see the module docstring) are supervised; a
        session error of the ``native`` scope retries like a transient
        fault.  Everything else — a consensus failure, a kernel build
        error, a CUDA error — propagates unchanged.

        ``fn`` must be safe to re-invoke after a failed attempt: every
        wrapped site either fails before mutating shared state or
        contains its own mid-run faults (``MachineBlockExecutor.
        execute_run`` returns its consumed count instead of raising
        once progress has been staged)."""
        struck_by = _struck_by(scope)
        delay = self.backoff
        seq0 = self._state[scope]["seq"]
        attempt = 0
        while True:
            try:
                if point is not None:
                    faults.fire(point)
                out = fn(*args)
            except struck_by as exc:
                retryable = not isinstance(exc, faults.FaultInjected) \
                    or exc.transient
                if retryable and attempt < self.max_retries:
                    attempt += 1
                    delay = self._backoff(delay)
                    continue
                self.strike(scope, exc)
                raise BackendFault(scope, exc) from exc
            # a wrapped call may CONTAIN a mid-run fault and still return
            # progress: it strikes the scope itself, and that strike must
            # not be erased by crediting the partial return as a success
            if self._state[scope]["seq"] == seq0:
                self.note_ok(scope)
            return out

    def retry_point(self, scope: str, point: str) -> None:
        """Fire an injection point with the transient-retry policy but
        no wrapped callable — for seams like the commit flush where the
        real work must not re-run (only the injected gate does)."""
        delay = self.backoff
        attempt = 0
        while True:
            try:
                faults.fire(point)
                return
            except faults.FaultInjected as exc:
                if exc.transient and attempt < self.max_retries:
                    attempt += 1
                    delay = self._backoff(delay)
                    continue
                self.strike(scope, exc)
                raise

    # ------------------------------------------------------------ reporting
    def snapshot(self) -> dict:
        with self._mu:
            return {
                "retries": self.retries,
                "strikes": self.strikes,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "quarantined": self.quarantined,
                "demoted_scopes": sorted(
                    s for s in self.SCOPES
                    if self._state[s]["demoted"]),
                "demote_latency_s": dict(self.demote_latency_s),
                "last_transition": self.last_transition,
            }

    def publish(self, registry=None) -> None:
        """Mirror the counters into the metrics registry."""
        from coreth_tpu_torch.metrics import Gauge, get_or_register
        reg = registry or self._registry
        for name in ("retries", "strikes", "demotions", "promotions",
                     "quarantined"):
            get_or_register(f"supervisor/{name}", Gauge,
                            reg).update(getattr(self, name))
