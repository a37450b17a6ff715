"""Asyncio HTTP/1.1 front-end for the serving plane: a copy of
`sparrowrecsys_tpu/serving/http.py`, which imports no JAX.

One event loop multiplexes persistent keep-alive connections; handler
execution (catalog lookups, device-dispatching rankers) runs on a
bounded thread pool so the loop never blocks on scoring. GET only, as
the reference's five servlets.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

Response = Tuple[int, str, bytes]

_STATUS = {200: "OK", 404: "Not Found", 405: "Method Not Allowed",
           400: "Bad Request", 500: "Internal Server Error",
           503: "Service Unavailable"}


class AsyncHTTPServer:
    """Keep-alive HTTP server around a `handler(path, q) -> (status,
    content_type, body)` routing callable (RecSysServer.handle)."""

    def __init__(
        self,
        handler: Callable[[str, Callable[..., str]], Response],
        port: int = 0,
        host: str = "0.0.0.0",
        workers: int = 16,
        max_inflight: int = 0,
    ):
        self.handler = handler
        self.host = host
        self.port = port
        #: Admission control (0 = off): requests beyond this many
        #: in-flight handler executions are shed with an immediate 503
        #: instead of queueing without bound, so that an open-loop
        #: overload keeps the server at capacity with bounded latency
        #: (the reference gets this from Jetty's bounded thread pool).
        self.max_inflight = max_inflight
        self._inflight = 0  # touched only on the event-loop thread
        self.shed_count = 0
        #: Per-endpoint latency ring buffers (server-side observability —
        #: the saturation curves were previously visible only from the
        #: load generator). Timed from executor submit to handler return,
        #: so executor QUEUE WAIT — the overload signal — is included.
        #: Touched only on the event-loop thread; /metrics reads a
        #: snapshot via latency_stats(). Sliding window of 2048 samples.
        self._lat: Dict[str, deque] = {}
        self._lat_n: Dict[str, int] = {}
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()

    # ------------------------------------------------------------------
    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except (asyncio.IncompleteReadError, ConnectionResetError,
                        asyncio.LimitOverrunError):
                    break
                line, _, rest = head.partition(b"\r\n")
                parts = line.decode("latin1").split()
                if len(parts) < 3:
                    break
                method, target, version = parts[0], parts[1], parts[2]
                lower = rest.lower()
                close = (
                    b"connection: close" in lower
                    or (version == "HTTP/1.0"
                        and b"connection: keep-alive" not in lower)
                )
                if method != "GET":
                    try:
                        await self._respond(writer, 405, "text/plain",
                                            b"GET only", close=True)
                    except (ConnectionResetError, BrokenPipeError, OSError):
                        pass
                    break
                parsed = urlparse(target)
                qs = parse_qs(parsed.query)

                def q(name, default=""):
                    return qs.get(name, [default])[0]

                if self.max_inflight and self._inflight >= self.max_inflight:
                    # Shed: answer 503 now, keep the connection usable.
                    self.shed_count += 1
                    try:
                        await self._respond(writer, 503, "text/plain",
                                            b"overloaded", close=close)
                    except (ConnectionResetError, BrokenPipeError, OSError):
                        break
                    if close:
                        break
                    continue
                self._inflight += 1
                t0 = time.perf_counter()
                try:
                    status, ctype, body = await loop.run_in_executor(
                        self._pool, self.handler, parsed.path, q
                    )
                except Exception:
                    status, ctype, body = 500, "text/plain", b""
                finally:
                    self._inflight -= 1
                    self._record_latency(
                        parsed.path, (time.perf_counter() - t0) * 1e3
                    )
                # The peer may vanish mid-write (load generators close all
                # sockets at their deadline; warmup clients abandon slow
                # first-compile requests) — a dead socket ends the
                # connection task quietly instead of leaking an
                # unretrieved-exception traceback from drain().
                try:
                    await self._respond(writer, status, ctype, body,
                                        close=close)
                except (ConnectionResetError, BrokenPipeError, OSError):
                    break
                if close:
                    break
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    def _record_latency(self, path: str, ms: float) -> None:
        # Bounded cardinality: API endpoints keep their path; the static
        # webroot (arbitrary file paths) collapses into one group.
        group = path if path.startswith("/get") or path == "/metrics" \
            else "static"
        ring = self._lat.get(group)
        if ring is None:
            ring = self._lat[group] = deque(maxlen=2048)
            self._lat_n[group] = 0
        ring.append(ms)
        self._lat_n[group] += 1

    def latency_stats(self) -> Dict[str, Dict[str, float]]:
        """Sliding-window latency quantiles per endpoint, in ms: p50/p90/
        p99 over the last <=2048 requests plus the all-time count. Safe to
        call from any thread (list() snapshots the ring; the GIL makes the
        deque read atomic enough for monitoring)."""
        out = {}
        for group, ring in list(self._lat.items()):
            xs = sorted(ring)
            if not xs:
                continue
            n = len(xs)

            def pct(p):
                return round(xs[min(n - 1, int(p * (n - 1) + 0.5))], 2)

            out[group] = {
                "count": self._lat_n.get(group, n), "window": n,
                "p50_ms": pct(0.50), "p90_ms": pct(0.90),
                "p99_ms": pct(0.99),
            }
        return out

    @staticmethod
    async def _respond(writer, status: int, ctype: str, body: bytes,
                       *, close: bool) -> None:
        reason = _STATUS.get(status, "OK")
        head = (
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            "Access-Control-Allow-Origin: *\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: {'close' if close else 'keep-alive'}\r\n"
            "\r\n"
        ).encode("latin1")
        writer.write(head + body)
        await writer.drain()

    # ------------------------------------------------------------------
    async def _serve(self) -> None:
        self._server = await asyncio.start_server(
            self._client, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._ready.set()
        async with self._server:
            await self._server.serve_forever()

    def _run_loop(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._serve())
        except asyncio.CancelledError:
            pass
        finally:
            self._loop.close()

    def start(self) -> None:
        """Serve on a daemon thread; returns once bound, so `self.port`
        holds the OS-assigned port for port=0. `join()` waits on it."""
        self._thread = threading.Thread(target=self._run_loop, daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=10):
            raise RuntimeError("HTTP server failed to start")

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()

    def stop(self) -> None:
        if self._loop is None:
            return

        def _shutdown():
            for task in asyncio.all_tasks(self._loop):
                task.cancel()

        self._loop.call_soon_threadsafe(_shutdown)
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._pool.shutdown(wait=False)
