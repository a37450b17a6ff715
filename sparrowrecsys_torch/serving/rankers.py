"""Rankers for the recall + rank pipelines: the port of
`sparrowrecsys_tpu/serving/rankers.py`.

- `"emb"`: cosine between the query embedding and every candidate, one
  matmul on the device (`cosine_scores_batch`, `rank_by_embedding`);
- the default similar-movie heuristic, 0.7 * genre overlap + 0.3 *
  rating / 5, on the host (`similar_score`);
- `ModelScorer`: an in-process CTR scorer over a zoo model restored from
  a versioned flax export, fed the full feature dict by the assembler
  (or, without one, the movie and user ids alone: NeuralCF), with hot
  reload of new versions (`ModelVersionWatcher`);
- `RestScorer`: the TF-Serving REST client, against `serving/sidecar.py`.

The JAX package pads candidate sets to shape buckets so that `jit`
compiles a few shapes only; PyTorch runs eagerly, so the cosine path
scores the exact set. The model paths keep the JAX batch padding
(`BATCH_PAD`, doubled until it fits): the models score rows
independently, so padding leaves every real row's score unchanged, and
a wave keeps one launch shape.
"""

from __future__ import annotations

import copy
import http.client
import json
import logging
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from sparrowrecsys_torch.ops.topk import cosine_scores
from sparrowrecsys_torch.serving.assembler import (
    MOVIE_FLOAT_COLS,
    MOVIE_GENRE_COLS,
    USER_FLOAT_COLS,
    USER_GENRE_COLS,
    USER_INT_COLS,
)
from sparrowrecsys_torch.serving.catalog import DataManager, Movie
from sparrowrecsys_torch.training.checkpoint import (
    latest_ready_version,
    load_latest,
    load_version,
    params_from_flax,
)
from sparrowrecsys_torch.utils.device import resolve_device
from sparrowrecsys_torch.utils.observability import get_registry

#: Device work from the HTTP worker threads is serialized.
DEVICE_LOCK = threading.Lock()
#: Model batches are zero-padded to this many rows, doubled until they fit.
BATCH_PAD = 1024

_log = logging.getLogger(__name__)


def cosine_scores_batch(query: np.ndarray, matrix: np.ndarray, device) -> np.ndarray:
    """One [1, D] x [N, D] cosine pass on `device`; -1 for all-zero rows
    (the reference returns -1 for a missing embedding)."""
    if matrix.size == 0 or query.size == 0:
        return np.full(len(matrix), -1.0, np.float32)
    with DEVICE_LOCK:
        s = cosine_scores(
            torch.from_numpy(np.ascontiguousarray(query[None, :])).to(device),
            torch.from_numpy(np.ascontiguousarray(matrix)).to(device),
        )[0].cpu().numpy()
    s[~np.any(matrix != 0, axis=1)] = -1.0
    return s


def similar_score(movie: Movie, candidate: Movie) -> float:
    """`calculateSimilarScore` (SimilarMovieProcess.java:181-198)."""
    same = sum(1 for g in movie.genres if g in candidate.genres)
    denom = len(movie.genres) + len(candidate.genres)
    genre_sim = (same / denom / 2) if denom else 0.0
    return 0.7 * genre_sim + 0.3 * (candidate.average_rating / 5)


def rank_by_embedding(
    query_emb: Optional[np.ndarray], candidates: Sequence[Movie],
    dm: DataManager, device,
) -> List[Movie]:
    """Candidates by cosine to `query_emb`, best first (stable); without a
    query embedding, in the order given."""
    if query_emb is None:
        return list(candidates)
    rows = np.array([dm.movie_emb_row(m.movie_id) for m in candidates])
    have = rows >= 0
    mat = np.zeros((len(candidates), len(query_emb)), np.float32)
    if have.any():
        mat[have] = dm.movie_emb_matrix[rows[have]]
    scores = cosine_scores_batch(np.asarray(query_emb, np.float32), mat, device)
    scores[~have] = -1.0
    order = np.argsort(-scores, kind="stable")
    return [candidates[i] for i in order]


def _padded(n: int) -> int:
    pad = BATCH_PAD
    while pad < n:
        pad *= 2
    return pad


class ModelScorer:
    """In-process CTR scorer: probabilities of a zoo model on `device`
    (default `cuda`) over the full feature dict the assembler builds, or,
    with `assembler=None`, over the movie and user ids alone (NeuralCF,
    JAX `rankers.py:149-160`). `extra_int_cols` adds zero int32 columns
    (DIEN's negative history, `models.dien.NEGATIVE_COLS`). A model that
    returns (logits, aux) is scored on its logits."""

    def __init__(self, model: torch.nn.Module, assembler=None, device=None,
                 extra_int_cols: Sequence[str] = ()):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.assembler = assembler
        self.extra_int_cols = tuple(extra_int_cols)
        #: Hot-reload state (set by from_checkpoint): the versioned dir
        #: and the version being served.
        self.model_dir: Optional[str] = None
        self.version: Optional[int] = None
        #: prepare_wave() state: device-resident candidate-side columns.
        self._wave = None

    @classmethod
    def from_checkpoint(cls, model: torch.nn.Module, model_dir: str, assembler=None,
                        device=None, extra_int_cols: Sequence[str] = ()) -> "ModelScorer":
        """Load the newest version under `model_dir` into `model`."""
        tree, version, _ = load_latest(model_dir)
        model.load_state_dict(params_from_flax(tree, model))
        scorer = cls(model, assembler, device, extra_int_cols)
        scorer.model_dir = model_dir
        scorer.version = version
        return scorer

    def reload_if_new(self) -> Optional[int]:
        """Swap in the newest complete version if one has appeared; returns
        it, or None. The new weights go into a copy of the model and the
        copy replaces `self.model` in one assignment, so a call in flight
        finishes on the model it started with. A version that fails to
        load is skipped and retried on the next poll."""
        if self.model_dir is None:
            return None
        v = latest_ready_version(self.model_dir)
        if v is None or (self.version is not None and v <= self.version):
            return None
        try:
            tree, _ = load_version(self.model_dir, v)
            fresh = copy.deepcopy(self.model)
            fresh.load_state_dict(params_from_flax(tree, fresh))
        except (OSError, ValueError, KeyError) as e:
            _log.warning("model version %s under %s not loaded: %s",
                         v, self.model_dir, e)
            return None
        self.model = fresh
        self.version = v
        return v

    def _probs(self, feats) -> torch.Tensor:
        with torch.inference_mode():
            out = self.model(feats)
            return torch.sigmoid(out[0] if isinstance(out, tuple) else out)

    def _rows(self, user_id: int, mids: np.ndarray) -> dict:
        """The host columns of one user's candidates."""
        if self.assembler is None:
            return {"movieId": mids, "userId": np.full(len(mids), int(user_id), np.int32)}
        return self.assembler.features(user_id, mids, self.extra_int_cols)

    def _host_batch(self, host_cols, total: int):
        """Zero-pad host columns to the batch size; upload."""
        pad = _padded(total)
        feats = {}
        for k, v in host_cols.items():
            col = np.zeros(pad, v.dtype)
            col[:total] = v
            feats[k] = torch.from_numpy(col).to(self.device)
        return feats

    def score(self, user_id: int, movie_ids: Sequence[int]) -> np.ndarray:
        """Probabilities [n] of `user_id` for each movie."""
        n = len(movie_ids)
        real = self._rows(user_id, np.asarray(movie_ids, np.int32))
        with DEVICE_LOCK:
            feats = self._host_batch(real, n)
            return self._probs(feats)[:n].cpu().numpy()

    def score_many(self, user_ids: Sequence[int], movie_ids: Sequence[int]) -> np.ndarray:
        """The same candidate list for k users in one forward: [k, n]."""
        n, k = len(movie_ids), len(user_ids)
        mids = np.asarray(movie_ids, np.int32)
        reals = [self._rows(int(u), mids) for u in user_ids]
        cols = {key: np.concatenate([r[key] for r in reals]) for key in reals[0]}
        with DEVICE_LOCK:
            feats = self._host_batch(cols, k * n)
            flat = self._probs(feats)[: k * n].cpu().numpy()
        return flat.reshape(k, n)

    def prepare_wave(self, movie_ids: Sequence[int], k: int) -> None:
        """Keep the candidate-side columns of [k x n] waves over a fixed
        candidate list resident on the device; each wave then uploads only
        the k user rows (`score_wave`)."""
        mids = np.asarray([int(m) for m in movie_ids], np.int32)
        n = len(mids)
        total = k * n
        pad = _padded(total)

        def tile_pad(col: np.ndarray) -> torch.Tensor:
            out = np.zeros(pad, col.dtype)
            out[:total] = np.tile(col, k)
            return torch.from_numpy(out).to(self.device)

        resident = {"movieId": tile_pad(mids)}
        user_int_cols, user_flt_cols = ("userId",), ()
        if self.assembler is not None:
            mg, mf = self.assembler.movie_block(mids)
            for j, c in enumerate(MOVIE_GENRE_COLS):
                resident[c] = tile_pad(np.ascontiguousarray(mg[:, j]))
            for j, c in enumerate(MOVIE_FLOAT_COLS):
                resident[c] = tile_pad(np.ascontiguousarray(mf[:, j]))
            for c in self.extra_int_cols:
                resident[c] = torch.zeros(pad, dtype=torch.int32, device=self.device)
            user_int_cols += USER_INT_COLS + USER_GENRE_COLS
            user_flt_cols = USER_FLOAT_COLS
        self._wave = {
            "resident": resident, "k": k, "n": n, "total": total, "pad": pad,
            "user_int_cols": user_int_cols, "user_flt_cols": user_flt_cols,
        }

    def score_wave(self, user_ids: Sequence[int]) -> np.ndarray:
        """[k, n] probabilities over the prepared candidate list."""
        w = self._wave
        if w is None or len(user_ids) != w["k"]:
            raise ValueError("call prepare_wave(movie_ids, k) first")
        rows = ([self.assembler.user_row(int(u)) for u in user_ids]
                if self.assembler is not None else [{}] * len(user_ids))
        ui = np.asarray(
            [[int(u)] + [int(r[c]) for c in w["user_int_cols"][1:]]
             for u, r in zip(user_ids, rows)], np.int32)
        uf = np.asarray(
            [[float(r[c]) for c in w["user_flt_cols"]] for r in rows], np.float32
        ).reshape(len(rows), len(w["user_flt_cols"]))
        n, tail = w["n"], w["pad"] - w["total"]
        with DEVICE_LOCK:
            feats = dict(w["resident"])
            for cols, host in ((w["user_int_cols"], ui), (w["user_flt_cols"], uf)):
                if not cols:
                    continue
                dev = torch.from_numpy(host).to(self.device)
                for j, c in enumerate(cols):
                    col = dev[:, j].repeat_interleave(n)
                    feats[c] = torch.nn.functional.pad(col, (0, tail)) if tail else col
            flat = self._probs(feats)[: w["total"]].cpu().numpy()
        return flat.reshape(w["k"], n)


class ModelVersionWatcher:
    """Polls every registered ModelScorer's versioned dir on one daemon
    thread and hot-swaps new versions (TF Serving's version policy)."""

    def __init__(self, scorers: dict, poll_s: float = 1.0):
        self.scorers = dict(scorers)
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> dict:
        """One sweep; returns {name: new_version} for scorers that swapped."""
        swapped = {}
        for name, scorer in self.scorers.items():
            v = scorer.reload_if_new()
            if v is not None:
                swapped[name] = v
                get_registry().incr(f"model.reload.{name}")
        return swapped

    def versions(self) -> dict:
        return {n: s.version for n, s in self.scorers.items() if s.version is not None}

    def start(self) -> "ModelVersionWatcher":
        def loop():
            while not self._stop.wait(self.poll_s):
                try:
                    self.poll_once()
                except Exception:  # the watcher must outlive a bad poll
                    _log.exception("model version poll failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="model-version-watcher")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


class RestScorer:
    """TF-Serving-protocol REST client (`HttpClient.asyncSinglePostRequest`
    with the `{"instances": [...]}` payload, RecForYouProcess.java:131-147):
    scores against `serving.sidecar.ScoringSidecar` or a real TF Serving."""

    def __init__(self, endpoint: str = "http://localhost:8501/v1/models/recmodel:predict"):
        self.endpoint = endpoint

    def _post(self, body: bytes, timeout: float) -> bytes:
        req = urllib.request.Request(self.endpoint, data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read()

    def score(self, user_id: int, movie_ids: Sequence[int]) -> np.ndarray:
        """Probabilities [n], float32 (the JSON carries each score's
        float32 value exactly)."""
        payload = json.dumps(
            {"instances": [{"userId": int(user_id), "movieId": int(m)} for m in movie_ids]}
        ).encode()
        out = json.loads(self._post(payload, timeout=10))
        return np.asarray([p[0] for p in out["predictions"]], np.float32)

    def map_post(self, body_map: dict, timeout: float = 10.0) -> Optional[dict]:
        """`HttpClient.asyncMapPostRequest` (HttpClient.java:65-101): POST
        every value of `body_map` concurrently and return {key: response
        text}; None for an empty or None map, and None, not a partial
        dict, when any request fails (the reference catches the whole
        batch)."""
        if not body_map:
            return None
        try:
            with ThreadPoolExecutor(max_workers=min(len(body_map), 16)) as pool:
                futures = {k: pool.submit(self._post, v.encode(), timeout)
                           for k, v in body_map.items()}
                return {k: f.result().decode() for k, f in futures.items()}
        except (OSError, ValueError, http.client.HTTPException):
            return None
