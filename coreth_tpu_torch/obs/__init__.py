"""Observability: end-to-end span tracing and Perfetto export.

Port of reference ``obs/``, cut to ``obs.trace``.  A level-0 leaf beside
``metrics`` and ``faults``: every layer from the replay engine down to
the kernel launches threads its timing evidence through it, so it
imports nothing of the tree above (faults is a same-level peer).

- ``obs.trace`` — the span tracer: ``span()``/``instant()`` with ONE
  module-global None check when disabled (CORETH_TRACE=0, the default),
  ``device_span()`` labels for ``torch.profiler``, a bounded ring, and
  Chrome trace-event / Perfetto JSON export (CORETH_TRACE_OUT).
"""

from coreth_tpu_torch.obs.trace import (
    PT_EXPORT_FAIL, EventRing, SpanTracer, arm_from_env, device_span,
    enabled, install, instant, span, tracer, uninstall, write_out,
)

__all__ = [
    "PT_EXPORT_FAIL", "EventRing", "SpanTracer", "arm_from_env",
    "device_span", "enabled", "install", "instant", "span", "tracer", "uninstall",
    "write_out",
]
