"""End-to-end span tracing: per-block latency attribution + Perfetto.

Port of reference ``obs/trace.py``.  The replay path's actors (sender
recovery, the window launches, the trie folds, the host path) and the
supervisor that reroutes work between backends record their spans
here; this module is the shared evidence layer that says WHERE a
replay's time went.

Design constraints, in order (the faults-registry / metrics.ENABLED
mold):

1. **Disabled costs ~nothing.**  ``TRACER`` is a module global that is
   ``None`` by default; every instrumentation site goes through
   :func:`span` / :func:`instant` / :func:`device_span`, which
   return after ONE module-global ``is None`` check — no ring is allocated, no event is recorded, no
   contextvar is touched.  ``CORETH_TRACE=1`` installs the tracer
   (:func:`arm_from_env`, called idempotently by the engine
   constructor, like ``faults.arm_from_env``).
2. **Bounded.**  Events land in a ring (``CORETH_TRACE_RING``, default
   64k events); a long run overwrites its oldest events instead of
   growing, and ``dropped`` counts the evictions.
3. **Exportable.**  :meth:`SpanTracer.export` renders the ring as
   Chrome trace-event / Perfetto JSON: one row per thread (metadata
   ``thread_name`` events), complete ``X`` spans, ``i`` instants, and
   ``s``/``t``/``f`` flow arrows that follow a block (flow id = block
   number) across threads.  ``CORETH_TRACE_OUT=path`` names the file
   :func:`write_out` writes; a write failure — the ``obs/export_fail``
   injection point, or a real I/O error — is counted, never raised:
   the trace is diagnostics, losing it must not take the replay down.

The reference's per-block stage attribution (``BlockTrace``,
``StageAccumulator``) follows a block through the streaming pipeline's
queues, and comes with that pipeline.

``SpanTracer(device_spans=True)`` (the reference's
``CORETH_TRACE_JAX=1``) additionally brackets the kernel launches with
``torch.profiler.record_function`` (:func:`device_span`), so a
``torch.profiler`` trace taken around a replay shows the launches under
the same names.  It works on the CPU too (the plain versions' ops then
nest under the label).
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Optional

from coreth_tpu_torch import faults

# the trace-file write fails mid-export: the replay must finish
# unharmed and the failure must be COUNTED (SpanTracer.export_failures)
PT_EXPORT_FAIL = faults.declare(
    "obs/export_fail",
    "trace-file write fails mid-export (pipeline unharmed, counted)")

# THE module global every instrumentation site checks (None = off)
TRACER: Optional["SpanTracer"] = None

# current flow id (block number) for span/instant inheritance: set by
# a span opened with an explicit flow=, read by everything nested under
# it on the same thread — contextvars give per-thread isolation without
# threading the id through every call signature
_FLOW: "contextvars.ContextVar[Optional[int]]" = contextvars.ContextVar(
    "coreth_trace_flow", default=None)

# Stable per-thread trace ids.  threading.get_ident() is the raw
# pthread handle, which the OS RECYCLES the moment a thread exits — a
# fast backlog feed thread can die before the prefetch thread is even
# created, handing both the same ident and merging their timeline rows
# (observed: the prefetch row labeled "serve-feed").  A monotonic
# counter bound to a threading.local never repeats, so every thread
# lifetime gets its own row.
_TID_LOCAL = threading.local()
_TID_COUNTER = itertools.count(1)


def _tid() -> int:
    t = getattr(_TID_LOCAL, "tid", None)
    if t is None:
        t = next(_TID_COUNTER)
        _TID_LOCAL.tid = t
    return t


class _NullSpan:
    """Shared no-op context manager the disabled path hands out."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One recorded span: a complete ``X`` event emitted at exit, with
    flow inheritance through the contextvar while it is open."""

    __slots__ = ("_t", "name", "_flow", "_args", "_t0", "_tok")

    def __init__(self, tracer: "SpanTracer", name: str,
                 flow: Optional[int], args: dict):
        self._t = tracer
        self.name = name
        self._flow = flow
        self._args = args
        self._tok = None

    def __enter__(self):
        t = self._t
        self._t0 = t._now_us()
        if self._flow is None:
            self._flow = _FLOW.get()
        else:
            self._tok = _FLOW.set(self._flow)
        if self._flow is not None:
            t._bind_flow(self._flow, self._t0)
        return self

    def __exit__(self, *exc):
        t = self._t
        tid = _tid()
        t._note_thread(tid)
        ev = {"ph": "X", "name": self.name, "ts": self._t0,
              "dur": t._now_us() - self._t0, "tid": tid}
        if self._flow is not None:
            args = dict(self._args) if self._args else {}
            args["flow"] = self._flow
            ev["args"] = args
        elif self._args:
            ev["args"] = self._args
        t._emit(ev)
        if self._tok is not None:
            _FLOW.reset(self._tok)
            self._tok = None
        return False


class SpanTracer:
    """Thread-safe span/instant recorder over a bounded ring."""

    def __init__(self, ring: int = 65536, clock=time.monotonic,
                 device_spans: bool = False):
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self.ring_size = ring
        self._ring: deque = deque(maxlen=ring)
        self.dropped = 0           # events evicted from the full ring
        self.export_failures = 0   # write_out failures (counted, eaten)
        self._thread_names: Dict[int, str] = {}
        # bracket kernel launches with torch.profiler labels
        self.device_spans = device_spans

    # ------------------------------------------------------------ recording
    def _now_us(self) -> int:
        return int((self._clock() - self._t0) * 1e6)

    def _note_thread(self, tid: int) -> None:
        # unlocked fast path for the steady state; the insert itself
        # must hold the lock because export() iterates/prunes this
        # dict under it (an unlocked insert racing that iteration is
        # a RuntimeError out of a live /trace scrape)
        if tid in self._thread_names:
            return
        with self._lock:
            self._thread_names[tid] = threading.current_thread().name

    def _emit(self, ev: dict) -> None:
        with self._lock:
            if len(self._ring) == self.ring_size:
                self.dropped += 1
            self._ring.append(ev)

    def _bind_flow(self, flow: int, ts: int) -> None:
        """One flow-arrow binding at (ts, this thread).  Every binding
        records as ``t``; export() derives ``s``/``f`` from the ring's
        surviving content (first/last binding per id), so pairing needs
        NO cross-run state and survives both ring eviction of a flow's
        head and block numbers recurring across pipeline runs."""
        tid = _tid()
        self._note_thread(tid)
        with self._lock:
            if len(self._ring) == self.ring_size:
                self.dropped += 1
            self._ring.append({"ph": "t", "name": "block", "id": flow,
                               "ts": ts, "tid": tid})

    def span(self, name: str, flow: Optional[int] = None,
             **args) -> _Span:
        return _Span(self, name, flow, args)

    def instant(self, name: str, flow: Optional[int] = None,
                **args) -> None:
        ts = self._now_us()
        tid = _tid()
        self._note_thread(tid)
        if flow is None:
            flow = _FLOW.get()
        if flow is not None:
            self._bind_flow(flow, ts)
        ev = {"ph": "i", "s": "t", "name": name, "ts": ts, "tid": tid}
        if args:
            ev["args"] = args
        self._emit(ev)

    # --------------------------------------------------------------- export
    def export(self) -> dict:
        """The ring as a Chrome trace-event / Perfetto JSON document:
        thread_name metadata rows first, then the events with pid/cat
        stamped.  Flow phases derive from the SURVIVING ring content —
        per id, the first binding becomes ``s`` and the last the
        terminating ``f`` — so arrows pair up even when the ring
        evicted a flow's head or a block number recurred across runs.
        Only the shallow snapshot happens under the recording lock
        (per-event copies outside it: a 64k-ring scrape must not stall
        every instrumented thread)."""
        pid = os.getpid()
        with self._lock:
            snap = list(self._ring)
            # prune names whose threads have no surviving events: a
            # long-lived env-armed tracer spawns fresh pipeline threads
            # (fresh tids — the counter never reuses) every run, and
            # without pruning the name map and every export's metadata
            # rows would grow without bound.  Safe: a still-live thread
            # re-notes its name on its next event.
            live = {e["tid"] for e in snap}
            for tid in [t for t in self._thread_names
                        if t not in live]:
                del self._thread_names[tid]
            names = dict(self._thread_names)
        evs = [dict(e) for e in snap]
        first_bind: Dict[int, int] = {}
        last_bind: Dict[int, int] = {}
        for i, e in enumerate(evs):
            if e["ph"] == "t":
                first_bind.setdefault(e["id"], i)
                last_bind[e["id"]] = i
        out = []
        for tid, nm in sorted(names.items()):
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "ts": 0, "cat": "__metadata",
                        "args": {"name": nm}})
        for i, e in enumerate(evs):
            e["pid"] = pid
            e.setdefault("cat", "coreth")
            if e["ph"] == "t":
                fid = e["id"]
                if first_bind[fid] == i:
                    e["ph"] = "s"
                elif last_bind[fid] == i:
                    e["ph"] = "f"
                    e["bp"] = "e"
            out.append(e)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write_out(self, path: Optional[str] = None) -> Optional[str]:
        """Write the export to ``path`` (default ``CORETH_TRACE_OUT``);
        returns the path written, or None (not configured / failed —
        failures are counted in ``export_failures``, never raised)."""
        path = path or os.environ.get("CORETH_TRACE_OUT")
        if not path:
            return None
        try:
            faults.fire(PT_EXPORT_FAIL)
            # default=str: the open **kwargs span API means one
            # refactor could pass a non-JSON primitive (a numpy int,
            # say) — degrade it to its repr instead of losing the file
            data = json.dumps(self.export(), default=str)
            with open(path, "w", encoding="utf-8") as f:
                f.write(data)
            return path
        except (faults.FaultInjected, OSError, TypeError, ValueError):
            # counted, never raised: a failed diagnostic write must
            # not turn a successful run into a crashed one
            self.export_failures += 1
            return None


class EventRing:
    """Small ALWAYS-ON ordered event ring (the evm/device/shard.py
    dispatch-ordering trace).  Appends cost one bounded-deque push when
    tracing is off — the exact semantics the dispatch-ordering test in
    tests/test_shard_replay.py pins — and mirror into the active tracer
    as instant events when it is on, so the Perfetto timeline shows the
    same dispatch/fetch ordering the test asserts."""

    __slots__ = ("name", "_dq")

    def __init__(self, name: str, maxlen: int = 512):
        self.name = name
        self._dq: deque = deque(maxlen=maxlen)

    def append(self, entry: str) -> None:
        self._dq.append(entry)
        t = TRACER
        if t is not None:
            t.instant(f"{self.name}/{entry}")

    def clear(self) -> None:
        self._dq.clear()

    def __iter__(self):
        return iter(self._dq)

    def __len__(self) -> int:
        return len(self._dq)

    def __contains__(self, entry) -> bool:
        return entry in self._dq


# ------------------------------------------------------------- module API

def enabled() -> bool:
    return TRACER is not None


def tracer() -> Optional[SpanTracer]:
    """The active tracer (None when tracing is off) — the accessor for
    callers that hold ``obs`` rather than this module (the re-exported
    ``TRACER`` name would snapshot the binding at import)."""
    return TRACER


def span(name: str, **kw):
    """A recorded span, or the shared no-op when tracing is off (the
    one-module-global-None-check contract every site relies on)."""
    t = TRACER
    if t is None:
        return _NULL_SPAN
    return t.span(name, **kw)


def instant(name: str, **kw) -> None:
    t = TRACER
    if t is None:
        return
    t.instant(name, **kw)


def device_span(name: str):
    """``torch.profiler.record_function(name)`` bracketing a kernel
    launch when tracing is on with ``device_spans`` (so the launches
    line up under the same names in a captured ``torch.profiler``
    trace); the shared no-op otherwise.  ``record_function`` is the
    profiler's own annotation and runs on any device."""
    t = TRACER
    if t is None or not t.device_spans:
        return _NULL_SPAN
    from torch.profiler import record_function
    return record_function(name)


def install(tracer: Optional[SpanTracer] = None,
            ring: Optional[int] = None,
            device_spans: bool = False) -> SpanTracer:
    """Install (and return) the global tracer.  Tests and
    ``chip_smoke.py`` use this directly; a run opts in through
    CORETH_TRACE=1."""
    global TRACER
    if tracer is None:
        tracer = SpanTracer(ring=ring or 65536, device_spans=device_spans)
    TRACER = tracer
    return tracer


def uninstall() -> Optional[SpanTracer]:
    """Remove and return the global tracer (instrumentation sites go
    back to the one-None-check no-op)."""
    global TRACER
    t = TRACER
    TRACER = None
    return t


def arm_from_env() -> Optional[SpanTracer]:
    """Install a tracer if CORETH_TRACE=1 and none is active yet
    (idempotent — every engine constructor calls this, the first wins,
    mirroring faults.arm_from_env)."""
    if TRACER is not None:
        return TRACER
    if not bool(int(os.environ.get("CORETH_TRACE", "0") or "0")):
        return None
    ring = int(os.environ.get("CORETH_TRACE_RING", "65536") or "65536")
    return install(ring=ring)


def write_out(path: Optional[str] = None) -> Optional[str]:
    """Write the active tracer's export to CORETH_TRACE_OUT (or
    ``path``); no-op when tracing is off or no path is configured."""
    t = TRACER
    if t is None:
        return None
    return t.write_out(path)
