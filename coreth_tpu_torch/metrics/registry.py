"""The instrument types + registry (metrics/registry.go role).

Port of reference ``metrics/registry.py``, cut to the instruments the
port publishes (counters and gauges); the reference's meters,
histograms and timers serve the streaming pipeline and come with it.

`Enabled` gates cost the way the reference's metrics.Enabled /
EnabledExpensive do: when disabled, instruments become no-ops so hot
paths never pay for bookkeeping they do not report.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

ENABLED = True


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if not ENABLED:
            return
        with self._lock:
            self.value += n

    def snapshot(self) -> dict:
        return {"type": "counter", "count": self.value}


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def update(self, v: float) -> None:
        if ENABLED:
            self.value = v

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Registry:
    def __init__(self):
        self._metrics: Dict[str, object] = {}
        # optional one-line descriptions registered alongside a metric;
        # the Prometheus exposition renders them as # HELP lines
        self._help: Dict[str, str] = {}
        self._lock = threading.Lock()

    def register(self, name: str, metric,
                 description: Optional[str] = None) -> object:
        with self._lock:
            if name in self._metrics:
                raise ValueError(f"metric {name!r} already registered")
            self._metrics[name] = metric
            if description:
                self._help[name] = description
        return metric

    def get(self, name: str):
        return self._metrics.get(name)

    def description(self, name: str) -> Optional[str]:
        return self._help.get(name)

    def get_or_register(self, name: str, factory: Callable,
                        description: Optional[str] = None):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            if description and name not in self._help:
                self._help[name] = description
            return m

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)
            self._help.pop(name, None)

    def each(self):
        with self._lock:
            return sorted(self._metrics.items())

    def snapshot(self) -> Dict[str, dict]:
        return {name: m.snapshot() for name, m in self.each()}


default_registry = Registry()


def get_or_register(name: str, factory: Callable,
                    registry: Optional[Registry] = None,
                    description: Optional[str] = None):
    return (registry or default_registry).get_or_register(
        name, factory, description)
