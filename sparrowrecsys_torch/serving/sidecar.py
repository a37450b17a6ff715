"""TF-Serving-protocol scoring sidecar: the port of
`sparrowrecsys_tpu/serving/sidecar.py`.

The reference scores "nerualcf" requests over REST against TF Serving at
`http://localhost:8501/v1/models/recmodel:predict`
(`RecForYouProcess.java:139`), with `{"instances": [{userId, movieId},
...]}` in and `{"predictions": [[p], ...]}` out. This server speaks that
protocol over the port's `ModelScorer` on its device (`cuda` by
default), so the reference's serving stack could point at it unchanged
and `rankers.RestScorer` round-trips against it. A malformed body gets
a 400 with a JSON `{"error": ...}` body, another path a 404; a new
`NNN/` export under the scorer's model dir is served without a restart
(`ModelVersionWatcher`, every `poll_s` seconds).

    from sparrowrecsys_torch.serving.sidecar import ScoringSidecar
    sidecar = ScoringSidecar(scorer, port=8501)
    sidecar.start()
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from sparrowrecsys_torch.serving.rankers import ModelScorer, ModelVersionWatcher


class ScoringSidecar:
    def __init__(self, scorer: ModelScorer, port: int = 8501,
                 model_name: str = "recmodel", poll_s: float = 1.0):
        self.scorer = scorer
        self.port = port
        self.path = f"/v1/models/{model_name}:predict"
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.watcher = None
        if poll_s > 0 and scorer.model_dir:
            self.watcher = ModelVersionWatcher({model_name: scorer}, poll_s=poll_s)

    def _predict(self, body: bytes) -> list:
        """The predictions of a request body: one dispatch per distinct
        user, each instance's score at its position."""
        instances = json.loads(body or b"{}").get("instances", [])
        scores = np.empty(len(instances), np.float32)
        by_user = {}
        for pos, inst in enumerate(instances):
            by_user.setdefault(int(inst.get("userId", 0)), []).append(
                (pos, int(inst.get("movieId", 0))))
        for user, items in by_user.items():
            scores[[p for p, _ in items]] = self.scorer.score(user, [m for _, m in items])
        return [[float(s)] for s in scores]

    def _make_handler(self):
        sidecar = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, status: int, obj) -> None:
                out = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def do_POST(self):
                if self.path != sidecar.path:
                    self.send_response(404)
                    self.end_headers()
                    return
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    preds = sidecar._predict(self.rfile.read(length))
                except Exception as e:  # TF Serving's error body, not a dropped connection
                    self._send(400, {"error": str(e)})
                    return
                self._send(200, {"predictions": preds})

            def log_message(self, fmt, *args):
                pass

        return Handler

    def start(self) -> None:
        """Bind (port 0 gets a free port, in `self.port`) and serve on a
        background thread."""
        self._httpd = ThreadingHTTPServer(("0.0.0.0", self.port), self._make_handler())
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        if self.watcher is not None:
            self.watcher.start()

    def stop(self) -> None:
        if self.watcher is not None:
            self.watcher.stop()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
