"""The zoo's training throughput at production widths as a share of the
card's peaks: the twin of `tools/mfu_zoo.py`.

Each model trains at the JAX tool's defaults (dim 128, hidden 1024,
bfloat16 compute, a 2^20-row user table and a 2^17-row movie table, T=64
histories for DIN and DIEN, batch 262144, or 65536 for DIN and DIEN)
through the port's `Trainer`, one step after another on columns made on
the card: `warmup` steps, `hard_sync`, then `steps` timed steps and
`hard_sync` again. A row gives ms a step, examples/s, TFLOP/s and their
share of three peaks of an H100 SXM (NVIDIA's data sheet): BF16_PEAK
(dense bfloat16 on the tensor cores), F32_PEAK (float32 outside them)
and HBM_BYTES_PER_S against the coarse bytes model; the
dtype each CUDA kernel of the step ran in (the DIN kernels take float32
only, so under bfloat16 compute DIN hands them its float32 lookups); each
kernel's launches; and the card's name and power limit.

The FLOPs are the JAX tool's analytic count (`flops_per_example`, 3x
the forward: forward, input gradient and weight gradient) and the bytes
its model (`hbm_bytes_per_step`): estimates, the same numbers in both
packages. `tools/mfu_probe.py` (an ablation that leans on XLA's dead-code
elimination) has no twin.

    python -m sparrowrecsys_torch.tools.mfu_zoo [--models a,b] [--dim 128]
        [--hidden 1024] [--t 64] [--batch 262144] [--seq-batch 65536]
        [--warmup 3] [--steps 5] [--json-out F] [--cpu]

Models: embedding_mlp, wide_deep, deepfm, deepfm_v2, din, dien (aux
none), dien_paper (the paper's aux loss with negatives drawn in the step).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Callable, Dict, Optional

#: H100 SXM peaks (NVIDIA's data sheet, dense): bfloat16 on the tensor
#: cores, float32 outside them, HBM3 bytes/s.
BF16_PEAK = 989e12
F32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12
ATTENTION_HIDDEN = 32
DEFAULT_MODELS = "embedding_mlp,wide_deep,deepfm,deepfm_v2,din,dien,dien_paper"
_GENRES = ("userGenre1", "userGenre2", "userGenre3", "userGenre4", "userGenre5",
           "movieGenre1", "movieGenre2", "movieGenre3")
_NUMERICS = ("releaseYear", "movieRatingCount", "movieAvgRating", "movieRatingStddev",
             "userRatingCount", "userAvgRating", "userRatingStddev")


def flops_per_example(name: str, dim: int, hidden: int, t: int, aux: str = "none") -> float:
    """Forward FLOPs per example of `name` (the JAX tool's `model_config`
    counts, `tools/mfu_zoo.py:90-145`)."""
    if name in ("embedding_mlp", "wide_deep"):
        # wide_deep's 10k cross-hash wide path is a bias gather (bytes).
        return 2.0 * ((10 * dim + 7) * hidden + hidden * hidden + hidden)
    if name == "deepfm":
        return 2.0 * ((2 * dim + 7) * hidden + hidden * hidden + (hidden + 4) + 4 * dim)
    if name == "deepfm_v2":
        fdim = dim                                   # field_dim rides dim
        return 2.0 * ((4 * dim + 7) * fdim           # 5 field projections
                      + 6 * fdim                     # fm sum-sq - sq-sum
                      + 5 * fdim * hidden            # deep1
                      + hidden * (hidden // 2)       # deep2
                      + (1 + fdim + hidden // 2))
    if name == "din":
        att = ATTENTION_HIDDEN
        return 2.0 * (t * (4 * dim * att + att)      # activation unit
                      + (5 * dim + 7) * hidden + hidden * (hidden // 2) + hidden // 2)
    if name == "dien":
        f = (12.0 * dim * dim * t * 2                # GRU x/h matmuls (2x[D,3D])
             + 12.0 * dim * dim * t                  # AUGRU 3 gates x 2 [D,D]
             + 2.0 * t * (dim * 32 + 32)             # attention
             + (5 * dim + 7) * hidden * 2 + hidden * hidden
             + hidden)
        if aux != "none":
            f += 2.0 * (t - 1) * 2 * (2 * dim * 32 + 32)
        return f
    raise KeyError(name)


def hbm_bytes_per_step(name, dim, hidden, t, batch, user_vocab, movie_vocab) -> float:
    """The JAX tool's coarse bytes a step (`tools/mfu_zoo.py:148-158`):
    Adam's streams, the gathers and their scatter, activations, inputs."""
    params = user_vocab * dim + movie_vocab * dim + 12 * dim * dim
    params += (10 * dim + 7) * hidden + hidden * hidden
    adam = 6.0 * 4 * params                  # read+write p/mu/nu
    gathers = 3.0 * 4 * batch * dim * (2 + min(t, 8))  # fwd read + bwd scatter
    acts = 4.0 * 4 * batch * (10 * dim + 2 * hidden)
    if name in ("din", "dien"):
        acts += 4.0 * 4 * batch * t * dim * (2 if name == "din" else 6)
    xs = 2.0 * 4 * batch * (27 + t)
    return adam + gathers + acts + xs


def build(name: str, dim: int, hidden: int, t: int, user_vocab: int, movie_vocab: int,
          aux: str = "none", compute_dtype: str = "bfloat16"):
    """(model, loss_fn) as the JAX tool builds them."""
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.models.dien import dien_loss_fn

    kw = dict(dim=dim, compute_dtype=compute_dtype, user_buckets=user_vocab,
              movie_buckets=movie_vocab)
    if name in ("embedding_mlp", "wide_deep"):
        return build_model(name, hidden=hidden, **kw), None
    if name == "deepfm":
        return build_model(name, deep_hidden=hidden, **kw), None
    if name == "deepfm_v2":
        return build_model(name, field_dim=dim, deep_hidden=hidden, **kw), None
    if name == "din":
        return build_model(name, hidden=hidden, recent_movies=t, **kw), None
    if name == "dien":
        model = build_model(name, hidden=hidden, recent_movies=t, aux_mode=aux, **kw)
        return model, dien_loss_fn(aux_mode=aux, alpha=0.1, in_graph_negatives=aux != "none",
                                   recent_movies=t, movie_vocab=movie_vocab)
    raise KeyError(name)


def card_columns(n: int, user_vocab: int, movie_vocab: int, t: int, device, seed: int = 0):
    """(features, labels) of n rows made on `device`: ids, a T-step history,
    genres, N(0, 1) numerics and coin-flip labels."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=device, dtype=torch.int32)

    feats = {"movieId": ints(1, movie_vocab), "userId": ints(1, user_vocab)}
    for i in range(1, t + 1):
        feats[f"userRatedMovie{i}"] = ints(0, movie_vocab)
    for c in _GENRES:
        feats[c] = ints(-1, 19)
    for c in _NUMERICS:
        feats[c] = torch.randn(n, generator=g, device=device)
    labels = (torch.rand(n, generator=g, device=device) > 0.5).float()
    return feats, labels


@contextlib.contextmanager
def recording_dtypes(seen: Dict[str, str]):
    """Within the block, `seen[kernel]` is the dtype of the tensor each
    kernel wrapper the models call receives (its backward runs in the
    same dtype)."""
    from sparrowrecsys_torch.models import deepfm, din

    wrapped = [(din, "din_attention"), (deepfm, "fm_cross")]
    real = {name: getattr(mod, name) for mod, name in wrapped}

    def recorder(name):
        def call(x, *rest):
            seen[name] = str(x.dtype).replace("torch.", "")
            return real[name](x, *rest)
        return call

    for mod, name in wrapped:
        setattr(mod, name, recorder(name))
    try:
        yield seen
    finally:
        for mod, name in wrapped:
            setattr(mod, name, real[name])


def measure(spec: str, args, device, card: str = "") -> dict:
    """One model's row."""
    import torch

    from sparrowrecsys_torch.config import TrainConfig
    from sparrowrecsys_torch.ops import metrics as M
    from sparrowrecsys_torch.ops.kernels import launch_counters
    from sparrowrecsys_torch.training.loop import Trainer, hard_sync

    name, aux = ("dien", "paper") if spec == "dien_paper" else (spec, "none")
    seq = name in ("din", "dien")
    batch = args.seq_batch if seq else args.batch
    t = args.t if seq else 5
    steps = args.warmup + args.steps
    model, loss_fn = build(name, args.dim, args.hidden, t, args.user_vocab, args.movie_vocab,
                           aux)
    trainer = Trainer(model, TrainConfig(batch_size=batch, epochs=1), loss_fn=loss_fn,
                      device=device)
    params, opt_state = trainer.prepare(trainer.init_params())
    feats_all, labels_all = card_columns(batch * steps, args.user_vocab, args.movie_vocab,
                                         t, trainer.device)
    mask = torch.ones(batch, device=trainer.device)
    mstate = M.init_metrics(trainer.device)
    counters = launch_counters()
    dtypes: Dict[str, str] = {}
    t0 = None
    for s in range(steps):
        if s == args.warmup:
            hard_sync(params)
            for k in counters.values():
                k.launches = 0
            t0 = time.perf_counter()
        sl = slice(s * batch, (s + 1) * batch)
        feats = {k: v[sl] for k, v in feats_all.items()}
        gen = trainer.step_generator(0, s) if getattr(loss_fn, "wants_rng", False) else None
        with recording_dtypes(dtypes) if s == 0 else contextlib.nullcontext():
            params, opt_state, mstate = trainer._train_step(
                params, opt_state, mstate, feats, labels_all[sl], mask, gen)
    hard_sync(params)
    secs = time.perf_counter() - t0
    loss = M.finalize_metrics(mstate)["loss"]
    n = batch * args.steps
    fwd = flops_per_example(name, args.dim, args.hidden, t, aux)
    train_flops = 3.0 * fwd
    rate = train_flops * n / secs
    hbm = hbm_bytes_per_step(name, args.dim, args.hidden, t, batch, args.user_vocab,
                             args.movie_vocab) * args.steps / secs / HBM_BYTES_PER_S
    row = {
        "model": spec, "dim": args.dim, "hidden": args.hidden, "t": t if seq else None,
        "batch": batch, "warmup_steps": args.warmup, "timed_steps": args.steps,
        "ms_per_step": secs / args.steps * 1e3, "examples_per_s": n / secs,
        "tflops": rate / 1e12, "bf16_peak_share": rate / BF16_PEAK,
        "f32_peak_share": rate / F32_PEAK, "hbm_share_est": hbm,
        "flops_per_example_M": train_flops / 1e6, "loss": loss,
        "kernel_dtypes": dtypes,
        # over the timed steps
        "launches": {name: k.launches for name, k in counters.items() if k.launches},
        "device": str(trainer.device), "card": card,
    }
    if not loss == loss:
        raise AssertionError(f"mfu_zoo {spec}: the loss is NaN")
    return row


def run(args, emit: Optional[Callable[[dict], None]] = None, device=None) -> list:
    """One row per model of `args.models`, in order."""
    import torch

    device = device or ("cpu" if args.cpu else "cuda")
    card = ""
    if torch.device(device).type == "cuda":
        from sparrowrecsys_torch.tools.kernel_bench import card_label

        card = card_label()
    rows = []
    for spec in args.models.split(","):
        rows.append(measure(spec, args, device, card))
        if emit:
            emit(rows[-1])
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return rows


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default=DEFAULT_MODELS)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--t", type=int, default=64)
    ap.add_argument("--batch", type=int, default=262144)
    ap.add_argument("--seq-batch", type=int, default=65536,
                    help="batch for din/dien (their [B, T, D] histories)")
    ap.add_argument("--user-vocab", type=int, default=1 << 20)
    ap.add_argument("--movie-vocab", type=int, default=1 << 17)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--json-out", default="")
    ap.add_argument("--cpu", action="store_true")
    return ap


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    rows = run(args, emit=lambda row: print(json.dumps(row), flush=True))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"config": vars(args), "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
