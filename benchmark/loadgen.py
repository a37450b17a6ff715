"""Open-loop HTTP load: a frozen copy of `open_loop_worker` in the repo
root's `tools/http_load.py`, cut to what a benchmark run needs.

A sender process reads one job (JSON on standard input) and writes one
result (JSON on standard output). Request k is sent at `t0 + offset_k`
on the monotonic clock, which every process on the machine shares,
whatever the server is doing: an open loop. Keep-alive connections are
pooled, and the pool grows when responses lag arrivals. Latency runs
from the scheduled send to the parsed response, so a stall is charged
to every request it delays; lateness (actual send minus scheduled send)
says how far the sender itself fell behind.

    job:    {"host", "port", "t0", "drain_until", "cores" (or null),
             "requests": [[k, offset_s, path], ...]}
    result: {"rows": [[k, lateness_s, latency_s or null, status,
                       [movieId, ...] or null], ...], "connections": n}

Standard library only: it runs in its own process so that it shares no
interpreter lock with the server.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import sys
import time


async def _read_response(reader):
    head = await reader.readuntil(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    body_len = 0
    for line in head.split(b"\r\n"):
        if line.lower().startswith(b"content-length:"):
            body_len = int(line.split(b":")[1])
    body = await reader.readexactly(body_len) if body_len else b""
    return status, body


def _movie_ids(body: bytes):
    """The ranked list's movie ids, or None for a body that is not one."""
    if not body:
        return []
    try:
        return [int(m["movieId"]) for m in json.loads(body)]
    except (ValueError, TypeError, KeyError):
        return None


async def _run(job: dict) -> dict:
    host, port = job["host"], job["port"]
    t0 = job["t0"]
    pool: list = []
    rows: list = []
    stats = {"connections": 0}

    async def one(k, t_sched, path):
        writer = None
        lateness = time.monotonic() - t_sched
        try:
            if pool:
                reader, writer = pool.pop()
            else:
                reader, writer = await asyncio.open_connection(host, port)
                stats["connections"] += 1
            writer.write((f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
                          "Connection: keep-alive\r\n\r\n").encode())
            await writer.drain()
            status, body = await _read_response(reader)
            ids = _movie_ids(body) if status == 200 else None
            rows.append([k, lateness, time.monotonic() - t_sched, status, ids])
            pool.append((reader, writer))
        except (OSError, asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                ValueError, IndexError):
            rows.append([k, lateness, None, 0, None])
            if writer is not None:
                writer.close()

    tasks = []
    for k, offset, path in job["requests"]:
        t_sched = t0 + offset
        delay = t_sched - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.ensure_future(one(k, t_sched, path)))
    if tasks:
        _, pending = await asyncio.wait(
            tasks, timeout=max(0.0, job["drain_until"] - time.monotonic()))
        for t in pending:
            t.cancel()
        if pending:
            await asyncio.wait(pending)
    for _, writer in pool:
        writer.close()
    answered = {r[0] for r in rows}
    for k, offset, _ in job["requests"]:
        if k not in answered:
            rows.append([k, None, None, 0, None])
    return {"rows": rows, "connections": stats["connections"]}


def main() -> None:
    job = json.loads(sys.stdin.read())
    # The rows kept grow to thousands of lists; the cyclic collector would
    # walk them all again and again and make the sender late. Nothing
    # here makes a reference cycle.
    gc.disable()
    if job.get("cores"):
        os.sched_setaffinity(0, job["cores"])
    out = asyncio.run(_run(job))
    sys.stdout.write(json.dumps(out))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
