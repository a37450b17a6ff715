"""HTTP facade: the five reference endpoints and /metrics.

The port of `sparrowrecsys_tpu/serving/server.py`:

- GET /getmovie?id=
- GET /getuser?id=
- GET /getrecommendation?genre=&size=&sortby=
- GET /getsimilarmovie?movieId=&size=&model=
- GET /getrecforyou?id=&size=&model=   (model = emb, or a --rank-model)
- GET /metrics

CORS `*`, JSON in the reference's shapes, an empty body on a miss or an
error. The static webroot, the posters, the NeuralCF scorer
(`--model-dir`) and `--ab-test` are not ported yet; other paths get 404.

Run: python -m sparrowrecsys_torch.serving.server --rank-model din \
         --rank-model-dir data/modeldata/din [--cpu]
"""

from __future__ import annotations

import json
import os
from typing import Optional

from sparrowrecsys_torch.config import ServingConfig
from sparrowrecsys_torch.serving.ab import get_config_by_user_id
from sparrowrecsys_torch.serving.catalog import DataManager
from sparrowrecsys_torch.serving.http import AsyncHTTPServer
from sparrowrecsys_torch.serving.processes import RecForYouProcess, SimilarMovieProcess
from sparrowrecsys_torch.serving.rankers import ModelVersionWatcher
from sparrowrecsys_torch.utils.device import resolve_device
from sparrowrecsys_torch.utils.observability import get_registry


class RecSysServer:
    def __init__(
        self,
        dm: DataManager,
        config: Optional[ServingConfig] = None,
        scorers: Optional[dict] = None,
        ab_test: bool = False,
        device=None,
    ):
        self.dm = dm
        self.config = config or ServingConfig()
        self.device = resolve_device(device)
        self.similar = SimilarMovieProcess(dm, self.device)
        self.rec_for_you = RecForYouProcess(
            dm, self.device, batch_wait_ms=self.config.batch_wait_ms,
            scorers=scorers, model_batch=self.config.model_batch,
        )
        self.ab_test = ab_test
        self.port = int(os.environ.get("PORT", self.config.port))
        self._httpd: Optional[AsyncHTTPServer] = None
        # Hot reload of every checkpoint-backed scorer's versioned dir.
        self.watcher = None
        watchable = {n: s for n, s in self.rec_for_you.scorers.items() if s.model_dir}
        if watchable and self.config.model_poll_s > 0:
            self.watcher = ModelVersionWatcher(watchable, poll_s=self.config.model_poll_s)

    def warmup(self) -> None:
        """Run every serving path once before taking traffic: builds the
        CUDA kernels (nvcc, at first use), initialises the device
        libraries, and pins each scorer's wave-resident candidate block."""
        import numpy as np

        batcher = self.rec_for_you._batcher
        _, mat = self.rec_for_you._candidate_set()
        if mat.size:
            batcher.scorer(np.ones((batcher.max_batch, mat.shape[1]), np.float32))
        movie_ids = [m.movie_id for m in self.dm.get_movies(8, "rating")]
        if movie_ids:
            for s in self.rec_for_you.scorers.values():
                s.score(1, movie_ids)
        cands, _ = self.rec_for_you._candidate_set()
        cand_ids = [c.movie_id for c in cands]
        if cand_ids:
            k = self.rec_for_you.model_batch
            for s in self.rec_for_you.scorers.values():
                s.prepare_wave(cand_ids, k)
                s.score_wave([1] * k)

    # ---- endpoint handlers ----------------------------------------------
    def handle(self, path: str, q) -> tuple:
        """Returns (status, content_type, body_bytes)."""
        reg = get_registry()
        reg.incr(f"http.requests{path}" if path.startswith("/get") else "http.other")
        if path == "/metrics":
            return self._json(self._metrics(reg.snapshot()))
        try:
            if path == "/getmovie":
                m = self.dm.get_movie_by_id(int(q("id")))
                if m is None:
                    return self._json(None)
                return 200, "application/json", m.to_json_str().encode()
            if path == "/getuser":
                u = self.dm.get_user_by_id(int(q("id")))
                return self._json(u.to_json() if u else None)
            if path == "/getrecommendation":
                return self._json_movies(self.dm.get_movies_by_genre(
                    q("genre"), int(q("size")), q("sortby")))
            if path == "/getsimilarmovie":
                return self._json_movies(self.similar.get_rec_list(
                    int(q("movieId")), int(q("size")), q("model")))
            if path == "/getrecforyou":
                model = get_config_by_user_id(q("id")) if self.ab_test else q("model")
                return self._json_movies(self.rec_for_you.get_rec_list(
                    int(q("id")), int(q("size")), model))
        except Exception:
            # Servlet catch-all parity: empty body (MovieService.java:57-62).
            return 200, "text/html", b""
        return 404, "text/html", b"Not Found"

    def _metrics(self, snap: dict) -> dict:
        batchers = {"emb": self.rec_for_you._batcher.stats()}
        for name, b in self.rec_for_you._model_batchers.items():
            batchers[name] = b.stats()
        snap["batchers"] = batchers
        if self.watcher is not None:
            snap["model_versions"] = self.watcher.versions()
        if self._httpd is not None:
            if self._httpd.max_inflight:
                snap["shed_count"] = self._httpd.shed_count
            lat = self._httpd.latency_stats()
            if lat:
                snap["latency_ms"] = lat
        return snap

    @staticmethod
    def _json_movies(movies) -> tuple:
        """Joins each movie's cached JSON: byte-identical to
        json.dumps([m.to_json() for m in movies])."""
        body = "[" + ", ".join(m.to_json_str() for m in movies) + "]"
        return 200, "application/json", body.encode()

    @staticmethod
    def _json(obj) -> tuple:
        if obj is None:
            return 200, "application/json", b""
        return 200, "application/json", json.dumps(obj).encode()

    # ---- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Bind (port 0 gets a real port, in `self.port`) and serve on a
        background thread."""
        self._httpd = AsyncHTTPServer(
            self.handle, port=self.port, max_inflight=self.config.max_inflight)
        self._httpd.start()
        self.port = self._httpd.port
        if self.watcher is not None:
            self.watcher.start()

    def stop(self) -> None:
        if self.watcher is not None:
            self.watcher.stop()
        if self._httpd:
            self._httpd.stop()


def load_catalog(data) -> DataManager:
    """The DataManager over a DataConfig's files, as the server loads it."""
    def first_existing(*names):
        for n in names:
            if os.path.exists(data.path(n)):
                return data.path(n)
        return None

    return DataManager().load_data(
        data.path(data.movies_csv),
        first_existing(data.links_csv),
        first_existing(data.ratings_csv),
        first_existing("modeldata/item2vecEmb.csv", data.item_emb_file),
        first_existing("modeldata/userEmb.csv", data.user_emb_file),
    )


def main() -> None:
    import argparse
    import dataclasses

    from sparrowrecsys_torch.config import DataConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--rank-model", default=None, metavar="NAME",
                    help="full-feature ranker for ?model=NAME (deepfm, deepfm_v2, din)")
    ap.add_argument("--rank-model-dir", default=None, metavar="DIR",
                    help="versioned export dir for --rank-model")
    ap.add_argument("--feature-store", default=None, metavar="PATH",
                    help="feature_store.json for the assembler; default "
                    "<data-root>/feature_store.json")
    ap.add_argument("--model-batch", type=int, default=None,
                    help="model-path wave size (ServingConfig.model_batch)")
    ap.add_argument("--max-inflight", type=int, default=None,
                    help="shed with 503 beyond this many in-flight requests (0 = off)")
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the CPU; the default is the CUDA device")
    args = ap.parse_args()

    device = resolve_device("cpu" if args.cpu else "cuda")
    data = DataConfig() if args.data_root is None else DataConfig(data_root=args.data_root)
    cfg = ServingConfig()
    if args.model_batch is not None:
        cfg = dataclasses.replace(cfg, model_batch=args.model_batch)
    if args.max_inflight is not None:
        cfg = dataclasses.replace(cfg, max_inflight=args.max_inflight)
    dm = load_catalog(data)
    scorers = None
    if args.rank_model and args.rank_model_dir:
        from sparrowrecsys_torch.models import build_model
        from sparrowrecsys_torch.serving.assembler import FeatureAssembler
        from sparrowrecsys_torch.serving.feature_store import FeatureStore
        from sparrowrecsys_torch.serving.rankers import ModelScorer

        store_path = args.feature_store or data.path("feature_store.json")
        store = FeatureStore.load(store_path) if os.path.exists(store_path) else FeatureStore()
        scorers = {
            args.rank_model: ModelScorer.from_checkpoint(
                build_model(args.rank_model), args.rank_model_dir,
                FeatureAssembler(store, dm), device=device,
            )
        }
    server = RecSysServer(dm, cfg, scorers=scorers, device=device)
    server.start()
    print(f"Sparrow RecSys (PyTorch, {device}) binding http://localhost:{server.port}/ "
          "(warming up...)", flush=True)
    server.warmup()
    print(f"Sparrow RecSys (PyTorch, {device}) serving on http://localhost:{server.port}/",
          flush=True)
    server._httpd.join()


if __name__ == "__main__":
    main()
