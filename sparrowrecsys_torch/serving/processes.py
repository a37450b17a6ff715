"""Recall + rank pipelines: the port of `sparrowrecsys_tpu/serving/processes.py`.

similar movies: candidates are the union of each genre's top 100 by
rating, the movie itself removed; ranked by embedding cosine ("emb") or
by 0.7 * genre overlap + 0.3 * rating / 5.

rec for you: the top-800 movies by rating; ranked by a zoo scorer
(`?model=<name>`: a full-feature model, or NeuralCF over the ids at
`?model=neuralcf` and at the reference's typo `nerualcf`), by user-movie
cosine ("emb"), or left in candidate order (also for `neuralcf` when the
server has no NeuralCF scorer, as the JAX server does). Concurrent
requests are always micro-batched: one cosine pass, or one model wave,
for all of them (the JAX server is only ever built with micro-batching
on; it scores NeuralCF request by request, which gives each row the same
score, as the models score rows independently).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from sparrowrecsys_torch.ops.topk import cosine_scores
from sparrowrecsys_torch.serving.batcher import MicroBatcher
from sparrowrecsys_torch.serving.catalog import DataManager, Movie, User
from sparrowrecsys_torch.serving.rankers import (
    DEVICE_LOCK,
    rank_by_embedding,
    similar_score,
)

CANDIDATE_SIZE = 800  # RecForYouProcess.java:35
#: `?model=` spellings of the NeuralCF scorer: the A/B router's bucket B
#: carries the reference's typo (ABTest.java:14).
NEURALCF_NAMES = ("neuralcf", "nerualcf")


class SimilarMovieProcess:
    def __init__(self, dm: DataManager, device):
        self.dm = dm
        self.device = device

    def get_rec_list(self, movie_id: int, size: int, model: str) -> List[Movie]:
        movie = self.dm.get_movie_by_id(movie_id)
        if movie is None:
            return []
        return self.ranker(movie, self.candidate_generator(movie), model)[:size]

    def candidate_generator(self, movie: Movie) -> List[Movie]:
        seen: Dict[int, Movie] = {}
        for genre in movie.genres:
            try:
                for c in self.dm.get_movies_by_genre(genre, 100, "rating"):
                    seen[c.movie_id] = c
            except KeyError:
                continue
        seen.pop(movie.movie_id, None)
        return list(seen.values())

    def ranker(self, movie: Movie, candidates: List[Movie], model: str) -> List[Movie]:
        if model == "emb":
            return rank_by_embedding(movie.emb, candidates, self.dm, self.device)
        return sorted(candidates, key=lambda c: similar_score(movie, c), reverse=True)


class RecForYouProcess:
    def __init__(
        self,
        dm: DataManager,
        device,
        batch_wait_ms: float,
        scorers: Optional[dict],
        model_batch: int,
    ):
        self.dm = dm
        self.device = device
        #: Model-path wave size: concurrent ranked requests per forward.
        self.model_batch = model_batch
        #: Named scorers, {"din": ModelScorer, ..., "neuralcf": ...}.
        self.scorers = scorers or {}
        # The top-800 candidate set changes only with the catalog, which
        # is read-only after load: computed once.
        self._candidates: Optional[List[Movie]] = None
        self._candidate_matrix = None      # aligned [800, D] embedding rows
        self._candidate_matrix_dev = None  # its device copy
        # Concurrent requests' user embeddings are stacked into one
        # [B, 800] cosine pass.
        self._batcher = MicroBatcher(
            self._score_user_embs, max_batch=64, max_wait_ms=batch_wait_ms)
        self._model_batch_wait_ms = batch_wait_ms
        self._model_batchers: dict = {}
        # Two concurrent first requests for one model must not each build
        # a batcher; steady-state reads stay lock-free.
        self._model_batchers_lock = threading.Lock()

    def _score_user_embs(self, user_embs: np.ndarray) -> np.ndarray:
        with DEVICE_LOCK:
            if self._candidate_matrix_dev is None:
                _, mat = self._candidate_set()
                self._candidate_matrix_dev = torch.from_numpy(mat).to(self.device)
            q = torch.from_numpy(np.ascontiguousarray(user_embs)).to(self.device)
            return cosine_scores(q, self._candidate_matrix_dev).cpu().numpy()

    def _model_batcher(self, name: str) -> MicroBatcher:
        batcher = self._model_batchers.get(name)
        if batcher is not None:
            return batcher
        with self._model_batchers_lock:
            if name in self._model_batchers:
                return self._model_batchers[name]
            cands, _ = self._candidate_set()
            cand_ids = [c.movie_id for c in cands]
            scorer = self.scorers[name]

            def _score_users(uids: np.ndarray) -> np.ndarray:  # [k, 1]
                if scorer._wave is None:
                    scorer.prepare_wave(cand_ids, self.model_batch)
                return scorer.score_wave([int(u) for u in uids[:, 0]])

            self._model_batchers[name] = MicroBatcher(
                _score_users, max_batch=self.model_batch,
                max_wait_ms=self._model_batch_wait_ms,
            )
            return self._model_batchers[name]

    def _candidate_set(self):
        if self._candidates is None:
            cands = self.dm.get_movies(CANDIDATE_SIZE, "rating")
            d = self.dm.movie_emb_matrix.shape[1] if self.dm.movie_emb_matrix.size else 0
            mat = np.zeros((len(cands), d), np.float32)
            for i, m in enumerate(cands):
                row = self.dm.movie_emb_row(m.movie_id)
                if row >= 0 and d:
                    mat[i] = self.dm.movie_emb_matrix[row]
            self._candidates, self._candidate_matrix = cands, mat
        return self._candidates, self._candidate_matrix

    def get_rec_list(self, user_id: int, size: int, model: str) -> List[Movie]:
        user = self.dm.get_user_by_id(user_id)
        if user is None:
            return []
        return self.ranker(user, model)[:size]

    def ranker(self, user: User, model: str) -> List[Movie]:
        """The candidate set ranked for `user` by `model`."""
        candidates, mat = self._candidate_set()
        if model in NEURALCF_NAMES:
            model = NEURALCF_NAMES[0]
        if model in self.scorers:
            scores = self._model_batcher(model).submit(np.array([user.user_id], np.int64))
        elif model == "emb":
            emb = user.emb
            if emb is None:
                row = self.dm.user_emb_row(user.user_id)
                emb = self.dm.user_emb_matrix[row] if row >= 0 else None
            if emb is None or not mat.size:
                # Without embeddings the reference scores everything -1,
                # which leaves the candidate order.
                return list(candidates)
            scores = self._batcher.submit(np.asarray(emb, np.float32))
        else:
            return list(candidates)  # default: candidate order
        order = np.argsort(-scores, kind="stable")
        return [candidates[i] for i in order]
