"""Micro-batching for on-device scoring: a copy of
`sparrowrecsys_tpu/serving/batcher.py`, which imports no JAX.

Requests arrive one at a time, but the device wants batches. The
MicroBatcher collects concurrent requests for up to `max_wait_ms` (or
until `max_batch` accumulate), runs ONE batched scoring call, and fans
the rows back out to the waiting callers. Every scorer call is padded to
exactly `max_batch` rows (repeating the first row).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Tuple

import numpy as np


class MicroBatcher:
    """Batches concurrent `submit(query_row)` calls into one scorer call.

    scorer: Callable[[np.ndarray [max_batch, ...]], np.ndarray
    [max_batch, ...]] — always receives exactly max_batch rows (padding
    rows are duplicates of row 0 and are dropped on fan-out).
    """

    def __init__(
        self,
        scorer: Callable[[np.ndarray], np.ndarray],
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
    ):
        self.scorer = scorer
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._lock = threading.Lock()
        self._pending: List[Tuple[np.ndarray, threading.Event, dict]] = []
        self._leader_running = False
        #: lifetime counters: scored requests and scorer invocations
        #: (waves); requests/wave is what one device dispatch amortizes.
        self.n_requests = 0
        self.n_waves = 0

    def submit(self, query: np.ndarray) -> np.ndarray:
        """Block until this query's row is scored; thread-safe."""
        ev = threading.Event()
        slot: dict = {}
        with self._lock:
            self._pending.append((np.asarray(query), ev, slot))
            become_leader = not self._leader_running
            if become_leader:
                self._leader_running = True
        if become_leader:
            try:
                self._drive()
            finally:
                with self._lock:
                    self._leader_running = False
                # Requests that raced in after the leader drained must get
                # a new leader; hand off to one of their threads by waking
                # them through a zero-wait drain here.
                self._drain_stragglers()
        ev.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def _drain_stragglers(self) -> None:
        while True:
            with self._lock:
                if not self._pending or self._leader_running:
                    return
                self._leader_running = True
            try:
                self._score_one_batch()
            finally:
                with self._lock:
                    self._leader_running = False

    def _drive(self) -> None:
        """Leader: wait the micro-window, then drain the backlog in a LOOP
        (bounded stack depth under sustained load)."""
        deadline = time.perf_counter() + self.max_wait
        while time.perf_counter() < deadline:
            with self._lock:
                if len(self._pending) >= self.max_batch:
                    break
            time.sleep(self.max_wait / 10)
        while True:
            with self._lock:
                if not self._pending:
                    return
            self._score_one_batch()

    def _score_one_batch(self) -> None:
        with self._lock:
            batch = self._pending[: self.max_batch]
            self._pending = self._pending[self.max_batch :]
        with self._lock:
            self.n_requests += len(batch)
            self.n_waves += 1
        try:
            queries = np.stack([q for q, _, _ in batch])
            if len(batch) < self.max_batch:
                # Pad to the static batch size -> one compiled executable.
                pad = np.repeat(
                    queries[:1], self.max_batch - len(batch), axis=0
                )
                queries = np.concatenate([queries, pad], axis=0)
            results = self.scorer(queries)
            for i, (_, ev, slot) in enumerate(batch):
                slot["result"] = np.asarray(results[i])
                ev.set()
        except Exception as e:  # re-raised in every waiting caller
            for _, ev, slot in batch:
                slot["error"] = e
                ev.set()

    def stats(self) -> dict:
        with self._lock:
            return {
                "pending": len(self._pending),
                "requests": self.n_requests,
                "waves": self.n_waves,
                "requests_per_wave": round(
                    self.n_requests / self.n_waves, 2
                ) if self.n_waves else None,
            }
