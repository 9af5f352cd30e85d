"""Prometheus text exposition of a metrics registry.

Port of reference ``metrics/prometheus.py``, the twin of coreth's
metrics/prometheus/ (the gatherer AvalancheGo scrapes through its own
endpoint): metric names sanitize '/' and '.' into '_'.
"""

from __future__ import annotations

from typing import Optional

from coreth_tpu_torch.metrics.registry import Registry, default_registry


def _sanitize(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    return s if not s[:1].isdigit() else "_" + s


def render_prometheus(registry: Optional[Registry] = None) -> str:
    reg = registry or default_registry
    lines = []
    for name, metric in reg.each():
        snap = metric.snapshot()
        base = _sanitize(name)
        kind = snap.pop("type")
        desc = reg.description(name)
        if desc:
            # HELP precedes TYPE for the metric family
            lines.append(f"# HELP {base} {desc}")
        value = snap["count"] if kind == "counter" else snap["value"]
        lines.append(f"# TYPE {base} {kind}")
        lines.append(f"{base} {value}")
    return "\n".join(lines) + "\n"
