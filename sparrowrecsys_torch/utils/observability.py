"""Minimal metrics registry: the port of
`sparrowrecsys_tpu/utils/observability.py`.

Replaces the reference's print-line observability (`DataManager.java:88-124`
loading counters, `ABTest.java:33-41` bucket decisions) with counters and
gauges that components can register and a `snapshot()` any server endpoint
or test can read. Intentionally tiny: a dict with locks, not a Prometheus
client — but shaped so one could be swapped in.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self.started_at = time.time()

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "uptime_sec": time.time() - self.started_at,
            }


_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = MetricsRegistry()
        return _registry
