"""DIEN (Deep Interest Evolution Network): the port of
`sparrowrecsys_tpu/models/dien.py`.

- one shared movie table with `mask_zero` for the candidate, the history
  and the per-step negatives (three gathers, or one with `merged_gather`);
- a masked GRU over the history (`ops/augru.py::gru`);
- attention: sigmoid Dense(32) -> sigmoid Dense(1) over hidden * candidate,
  one scalar a step;
- the AUGRU over the hidden states with the attention (`augru`);
- [interest, candidate, user profile, context] -> Dense(hidden) -> PReLU
  -> Dense(hidden // 2) -> PReLU -> Dense(1): logits [B];
- the auxiliary heads: two sigmoid MLPs (Dense(32) -> Dense(1)) score
  (hidden_t, history_{t+1}) and (hidden_t, negative_{t+1}). The JAX
  package folds each pair into one block-diagonal product
  (`folded_dense`); the zero blocks add exact zeros, so the four
  `nn.Linear`s here (`aux_pos32`, `aux_neg32`, `aux_pos1`, `aux_neg1`)
  give the same numbers.

`forward` returns (logits [B], aux [B]); `dien_loss_fn` combines them.
`aux_mode`: "reference" (loss = BCE - alpha * sum_t(pos_t + neg_t), the
reference's sign, unmasked), "paper" (BCE + alpha * sum_t of
-log(pos_t) - log(1 - neg_t) over the steps whose next history id
exists; "mean" divides by their count) or "none" (no aux parameters, no
aux compute, aux = 0). The recurrences stay in float32 under any
`compute_dtype`; on the card each is one kernel launch a direction
(`ops/augru.py`). `recurrence_custom_vjp` (the hand-written backward: on
the CPU the kernels' twins) and `recurrence_remat` (None: remat from
T = 64 on) choose the backward off the card's kernels, which take every
float32 state up to 32 wide with their own. The recurrences
are the profiler ranges `dien.gru` and `dien.augru` forward and
`dien.gru.backward` and `dien.augru.backward` backward while a profiler
records (`utils/profiling.py`). Parameter names are the flax ones; the
recurrent kernels are root-level [in, out] parameters, as flax has them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sparrowrecsys_torch.config import EMBEDDING_DIM, MOVIE_VOCAB_SIZE, USER_VOCAB_SIZE
from sparrowrecsys_torch.models.din import MOVIE_NUMERICS, USER_NUMERICS
from sparrowrecsys_torch.models.features import (
    GenreEmbed,
    IdEmbed,
    PReLU,
    compute_dtype as dtype_of,
    dense,
    history_stack,
    numeric_stack,
)
from sparrowrecsys_torch.ops.augru import AUGRUGate, AUGRUParams, GRUParams, augru, gru
from sparrowrecsys_torch.utils.profiling import backward_span, span

AUX_MODES = ("reference", "paper", "none")
#: Width of the attention's and the aux heads' first layer (the JAX
#: model's, fixed).
HEAD_WIDTH = 32


def negative_cols(recent_movies: int = 5):
    """negativeUserRatedMovie2..T: one negative per non-initial history step."""
    return tuple(f"negativeUserRatedMovie{k}" for k in range(2, recent_movies + 1))


#: The reference's columns (T=5).
NEGATIVE_COLS = negative_cols(5)


def _param(*shape) -> nn.Parameter:
    # Placeholder values: `flax_init` or a loaded export sets them.
    return nn.Parameter(torch.zeros(*shape))


class DIEN(nn.Module):
    #: [in, out] kernels drawn lecun-normal over shape[0] by `flax_init`.
    RAW_KERNELS = ("gru_kernel",) + tuple(
        f"augru_{g}_{p}" for g in "rzh" for p in "wu")
    #: drawn orthogonal, as flax's `orthogonal()` draws them.
    ORTHOGONAL_KERNELS = ("gru_recurrent",)

    def __init__(
        self,
        dim: int = EMBEDDING_DIM,
        movie_buckets: int = MOVIE_VOCAB_SIZE,
        user_buckets: int = USER_VOCAB_SIZE,
        aux_mode: str = "reference",
        alpha: float = 0.5,
        hidden: int = 128,
        compute_dtype: str = "float32",
        aux_norm: str = "sum",
        recent_movies: int = 5,
        merged_gather: bool = False,
        recurrence_custom_vjp: bool = False,
        recurrence_remat: Optional[bool] = None,
        lookup_dtype: Optional[str] = None,
    ):
        super().__init__()
        if aux_mode not in AUX_MODES:
            raise ValueError(f"aux_mode {aux_mode!r} is not one of {AUX_MODES}")
        if aux_norm not in ("sum", "mean"):
            raise ValueError(f"aux_norm {aux_norm!r} is not 'sum' or 'mean'")
        if aux_norm == "mean" and aux_mode == "reference":
            # The JAX model ignores it there (dien.py:318-323).
            raise ValueError("aux_norm='mean' applies to aux_mode='paper' only; "
                             "the reference aux is an unmasked sum")
        self.aux_mode, self.alpha, self.aux_norm = aux_mode, alpha, aux_norm
        self.recent_movies = recent_movies
        self.merged_gather = merged_gather
        self.recurrence_custom_vjp = recurrence_custom_vjp
        self.recurrence_remat = recurrence_remat
        self.tower_dtype = dtype_of(compute_dtype)
        d = dim
        self.emb_movie_shared = IdEmbed(movie_buckets, d, mask_zero=True,
                                        lookup_dtype=lookup_dtype)
        self.gru_kernel = _param(d, 3 * d)
        self.gru_recurrent = _param(d, 3 * d)
        self.gru_bias = _param(3 * d)
        self.att_dense32 = nn.Linear(d, HEAD_WIDTH)
        self.att_dense1 = nn.Linear(HEAD_WIDTH, 1)
        for g in "rzh":
            setattr(self, f"augru_{g}_w", _param(d, d))
            setattr(self, f"augru_{g}_b", _param(d))
            setattr(self, f"augru_{g}_u", _param(d, d))
        self.emb_userId = IdEmbed(user_buckets, d, lookup_dtype=lookup_dtype)
        self.emb_userGenre1 = GenreEmbed(d)
        self.emb_movieGenre1 = GenreEmbed(d)
        width = d + d + (2 * d + len(USER_NUMERICS)) + (d + len(MOVIE_NUMERICS))
        self.fc1 = nn.Linear(width, hidden)
        self.prelu1 = PReLU(hidden)
        self.fc2 = nn.Linear(hidden, hidden // 2)
        self.prelu2 = PReLU(hidden // 2)
        self.out = nn.Linear(hidden // 2, 1)
        if aux_mode != "none":
            self.aux_pos32 = nn.Linear(2 * d, HEAD_WIDTH)
            self.aux_neg32 = nn.Linear(2 * d, HEAD_WIDTH)
            self.aux_pos1 = nn.Linear(HEAD_WIDTH, 1)
            self.aux_neg1 = nn.Linear(HEAD_WIDTH, 1)

    def _gate(self, g: str) -> AUGRUGate:
        return AUGRUGate(getattr(self, f"augru_{g}_w"), getattr(self, f"augru_{g}_b"),
                         getattr(self, f"augru_{g}_u"))

    def _lookups(self, features, hist_ids):
        """(candidate [B, D], history [B, T, D], negatives [B, T-1, D] or None)."""
        t = self.recent_movies
        neg_ids = None
        if self.aux_mode != "none":
            neg_ids = torch.stack([features[c] for c in negative_cols(t)], dim=-1)
        emb = self.emb_movie_shared
        if not self.merged_gather:
            return (emb(features["movieId"]), emb(hist_ids),
                    None if neg_ids is None else emb(neg_ids))
        blocks = [features["movieId"][:, None], hist_ids]
        if neg_ids is not None:
            blocks.append(neg_ids)
        chn = emb(torch.cat(blocks, dim=1))                          # [B, <=2T, D]
        return chn[:, 0], chn[:, 1:t + 1], (chn[:, t + 1:] if neg_ids is not None else None)

    def forward(self, features: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self.recent_movies
        hist_ids = history_stack(features, t)                        # [B, T]
        hist_mask = hist_ids > 0
        remat = self.recurrence_remat if self.recurrence_remat is not None else t >= 64
        cand, hist, neg = self._lookups(features, hist_ids)

        paths = {"custom_vjp": self.recurrence_custom_vjp, "remat": remat}

        def gru_layer(x, *w):
            return gru(GRUParams(*w), x, hist_mask, **paths)

        def augru_layer(states, att, *w):
            return augru(AUGRUParams(*(AUGRUGate(*w[i:i + 3]) for i in (0, 3, 6))), states,
                         att, **paths)

        with span("dien.gru"):
            hidden = backward_span("dien.gru.backward", gru_layer, hist, self.gru_kernel,
                                   self.gru_recurrent, self.gru_bias)     # [B, T, D]
        att = torch.sigmoid(self.att_dense32(hidden * cand[:, None, :]))
        att = torch.sigmoid(self.att_dense1(att))                    # [B, T, 1]
        with span("dien.augru"):
            interest = backward_span("dien.augru.backward", augru_layer, hidden, att,
                                     *self._gate("r"), *self._gate("z"),
                                     *self._gate("h"))              # [B, D]

        profile = torch.cat([self.emb_userId(features["userId"]),
                             self.emb_userGenre1(features["userGenre1"]),
                             numeric_stack(features, USER_NUMERICS)], dim=-1)
        context = torch.cat([self.emb_movieGenre1(features["movieGenre1"]),
                             numeric_stack(features, MOVIE_NUMERICS)], dim=-1)
        x = torch.cat([interest, cand, profile, context], dim=-1)
        x = self.prelu1(dense(self.fc1, x, self.tower_dtype).float())
        x = self.prelu2(dense(self.fc2, x, self.tower_dtype).float())
        logits = self.out(x)[..., 0]
        if self.aux_mode == "none":
            return logits, torch.zeros_like(logits)

        prev = hidden[:, : t - 1]
        pos_p = torch.sigmoid(self.aux_pos1(torch.sigmoid(
            self.aux_pos32(torch.cat([prev, hist[:, 1:t]], dim=-1)))))[..., 0]
        neg_p = torch.sigmoid(self.aux_neg1(torch.sigmoid(
            self.aux_neg32(torch.cat([prev, neg], dim=-1)))))[..., 0]    # [B, T-1]
        if self.aux_mode == "paper":
            eps = 1e-7
            step_valid = hist_mask[:, 1:t].to(pos_p.dtype)
            aux = -((torch.log(pos_p + eps) + torch.log(1.0 - neg_p + eps))
                    * step_valid).sum(1)
            if self.aux_norm == "mean":
                aux = aux / step_valid.sum(1).clamp_min(1.0)
        else:
            aux = (pos_p + neg_p).sum(1)
        return logits, aux


def sample_negatives_in_graph(
    generator: torch.Generator, feats: Dict[str, torch.Tensor],
    recent_movies: int = 5, movie_vocab: int = MOVIE_VOCAB_SIZE,
) -> Dict[str, torch.Tensor]:
    """The negative columns drawn inside the step from `generator` (on the
    columns' device): r ~ U[0, vocab - 1), neg = r + (r >= pos), uniform
    over [0, vocab) without the same column's positive, as
    `add_dien_negatives` draws them, with no rejection loop."""
    out = dict(feats)
    for i, col in enumerate(negative_cols(recent_movies)):
        pos = feats[f"userRatedMovie{i + 2}"]
        r = torch.randint(0, movie_vocab - 1, pos.shape, generator=generator,
                          device=pos.device, dtype=torch.int32)
        out[col] = r + (r >= pos).to(torch.int32)
    return out


def dien_loss_fn(
    alpha: float = 0.5,
    aux_mode: str = "reference",
    in_graph_negatives: bool = False,
    recent_movies: int = 5,
    movie_vocab: int = MOVIE_VOCAB_SIZE,
):
    """The Trainer's loss for DIEN's (logits, aux):
    `fn(forward, params, feats, labels, mask, generator=None)` ->
    (loss, (logits, summed masked objective)). The objective per example
    is BCE - alpha * aux ("reference"), BCE + alpha * aux ("paper") or BCE
    ("none"); keep `aux_mode` the model's. The loss reported is the whole
    objective, as Keras reports one with its added terms.

    `in_graph_negatives=True` draws the negative columns in the step from
    the generator the Trainer passes (`wants_rng`), so the training data
    needs none; evaluation still reads them from the data. `fn.draw(
    generator, feats)` draws them alone: a mesh's trainer draws them for
    the global batch and hands each rank its rows with no generator.
    `prepare_init_features` adds them to sample features for a caller that
    traces the model on training data without them."""
    sign = 1.0 if aux_mode == "paper" else -1.0

    def draw(generator, feats):
        return sample_negatives_in_graph(generator, feats, recent_movies, movie_vocab)

    def fn(forward, params, feats, labels, mask, generator=None):
        if in_graph_negatives and aux_mode != "none" and generator is not None:
            feats = draw(generator, feats)
        logits, aux = forward(params, feats)
        per_ex = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
        if aux_mode != "none":
            per_ex = per_ex + sign * alpha * aux
        loss_sum = (per_ex * mask).sum()
        return loss_sum / mask.sum().clamp_min(1.0), (logits, loss_sum)

    fn.wants_rng = bool(in_graph_negatives)
    if in_graph_negatives and aux_mode != "none":
        fn.draw = draw
    if in_graph_negatives:
        def prepare(feats):
            dev = next(iter(feats.values())).device
            return sample_negatives_in_graph(torch.Generator(device=dev).manual_seed(0),
                                             feats, recent_movies, movie_vocab)

        fn.prepare_init_features = prepare
    return fn
