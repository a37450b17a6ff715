"""The streaming latest-behaviour feature: the port of
`sparrowrecsys_tpu/nearline/stream.py` (host code, no device work).

The reference's Flink `RealTimeFeature` (`RealTimeFeature.java:42-73`)
re-reads ratings.csv every 100 ms, keys the ratings by userId, reduces a
1 s window to the rating with the largest timestamp and prints
`userId / latestMovieId`. Here a tail source reads only the rows
appended since its last poll (binary offsets, so CRLF files stay in
step; a file that shrank is read again from its start), the keyed
window feeds a sink, and `attach_to_store` makes the sink write each
user's `latestMovieId` and `latestMovieRating` into the serving
catalog, where the assembler's real-time shift puts a positive event
into the history of the next ranked request.

    python -m sparrowrecsys_torch.nearline.stream [--ratings PATH]
        [--from-start] [--duration SECONDS]
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class RatingEvent:
    user_id: int
    movie_id: int
    rating: float
    timestamp: int


class FileWatchSource:
    """Tails a ratings CSV: each `poll` returns the complete rows appended
    since the last one. The first poll skips what the file holds, unless
    `from_start`."""

    def __init__(self, path: str, interval: float = 0.1, from_start: bool = False):
        self.path = path
        self.interval = interval
        self._offset = 0 if from_start else None

    def poll(self) -> List[RatingEvent]:
        if not os.path.exists(self.path):
            return []
        events: List[RatingEvent] = []
        # Binary mode: offsets count bytes. Text mode would count a CRLF
        # row one byte short and drift into the middle of a row.
        with open(self.path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if self._offset is None:
                self._offset = size
                return []
            if size < self._offset:
                self._offset = 0  # truncated or rotated: start over
            f.seek(self._offset)
            for raw in f:
                if not raw.endswith(b"\n"):
                    break  # a partial write: read again on the next poll
                self._offset += len(raw)
                parts = raw.decode("utf-8", "replace").strip().split(",")
                if len(parts) < 4 or parts[0] == "userId":
                    continue
                try:
                    events.append(RatingEvent(int(parts[0]), int(parts[1]),
                                              float(parts[2]), int(parts[3])))
                except ValueError:
                    continue  # a malformed row is skipped
        return events


class LatestRatingStream:
    """keyBy(userId), a tumbling window of `window_seconds`, and a reduce
    to the rating with the largest timestamp; each fired window's events
    go to `sink`."""

    def __init__(
        self,
        source: FileWatchSource,
        window_seconds: float = 1.0,   # timeWindow(Time.seconds(1))
        sink: Optional[Callable[[RatingEvent], None]] = None,
    ):
        self.source = source
        self.window_seconds = window_seconds
        self.sink = sink or (lambda e: print(f"user:{e.user_id}\tlatest movie:{e.movie_id}"))
        self.latest: Dict[int, RatingEvent] = {}
        self._pending: Dict[int, RatingEvent] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _reduce(self, events: List[RatingEvent]) -> None:
        for e in events:
            cur = self._pending.get(e.user_id)
            if cur is None or e.timestamp > cur.timestamp:
                self._pending[e.user_id] = e

    def _fire_window(self) -> None:
        for uid, e in self._pending.items():
            self.latest[uid] = e
            self.sink(e)
        self._pending = {}

    def _drive(self, done: Callable[[], bool]) -> None:
        next_fire = time.time() + self.window_seconds
        while not done():
            self._reduce(self.source.poll())
            if time.time() >= next_fire:
                self._fire_window()
                next_fire += self.window_seconds
            time.sleep(self.source.interval)

    def run_for(self, seconds: float) -> None:
        """Poll and fire windows for `seconds`, then fire what is pending."""
        deadline = time.time() + seconds
        self._drive(lambda: time.time() >= deadline)
        self._fire_window()

    def start(self) -> None:
        """Run on a daemon thread until `stop`."""
        self._thread = threading.Thread(target=self._drive, args=(self._stop.is_set,),
                                        daemon=True, name="latest-rating-stream")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


def attach_to_store(stream: LatestRatingStream, dm) -> None:
    """Make the stream's sink write each event into the serving catalog:
    the user's `user_features["latestMovieId"]` and `["latestMovieRating"]`
    (the `uf:<id>` hash's role), creating a user seen for the first time;
    then the sink it had."""
    from sparrowrecsys_torch.serving.catalog import User

    base_sink = stream.sink

    def sink(e: RatingEvent) -> None:
        user = dm.get_user_by_id(e.user_id)
        if user is None:
            user = User(e.user_id)
            dm.users[e.user_id] = user
        # One assignment of a new dict: a reader sees both fields of one
        # event, never the movie of one and the rating of another.
        user.user_features = {**(user.user_features or {}),
                              "latestMovieId": str(e.movie_id),
                              "latestMovieRating": str(e.rating)}
        base_sink(e)

    stream.sink = sink


def main(argv=None) -> None:
    """`RealTimeFeature.main` (RealTimeFeature.java:79-81): watch a ratings
    CSV and print each user's latest movie per 1 s window."""
    import argparse

    from sparrowrecsys_torch.config import DataConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--ratings", default=None)
    ap.add_argument("--from-start", action="store_true",
                    help="replay the rows the file already holds (the reference "
                    "re-reads the whole file; the default tails new rows only)")
    ap.add_argument("--duration", type=float, default=30.0)
    args = ap.parse_args(argv)
    path = args.ratings or DataConfig().path("ratings.csv")
    stream = LatestRatingStream(FileWatchSource(path, interval=0.1, from_start=args.from_start))
    print(f"watching {path} for {args.duration}s ...")
    stream.run_for(args.duration)


if __name__ == "__main__":
    main()
