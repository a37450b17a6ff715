"""The C++ CSV loader: the port of `sparrowrecsys_tpu/native/`."""

from sparrowrecsys_torch.native.loader import (
    counts,
    load_embeddings_native,
    load_ratings_native,
    load_samples_native,
    native_available,
    reset_counts,
)

__all__ = [
    "counts",
    "load_embeddings_native",
    "load_ratings_native",
    "load_samples_native",
    "native_available",
    "reset_counts",
]
