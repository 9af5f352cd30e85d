"""Metrics registry: counters and gauges.

Port of reference ``metrics/``, itself the twin of coreth's metrics/
(the go-metrics fork: registry.go +
metrics.go Enabled gate + prometheus/ gatherer): components register
named instruments in a hierarchy-by-name registry; the Prometheus
exposition renders the whole registry as text for scraping (the
endpoint AvalancheGo aggregates, vm.go:674 initializeMetrics).
"""

from coreth_tpu_torch.metrics.registry import (
    Counter, Gauge, Registry, default_registry, get_or_register,
)
from coreth_tpu_torch.metrics.prometheus import render_prometheus

__all__ = [
    "Counter", "Gauge", "Registry", "default_registry", "get_or_register",
    "render_prometheus",
]
