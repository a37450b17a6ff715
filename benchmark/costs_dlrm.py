"""The work of DLRM-DCNv2's measured operations, counted from the
configuration's widths.

- `dlrm_flops_per_example`: the forward FLOPs of one example, a
  multiply-add two: the dense arch (13 -> 512 -> 256 -> 128), the cross
  layers (27 D -> rank -> 27 D each) and the over arch (27 D -> 1024 ->
  1024 -> 512 -> 256 -> 1). The pooled lookups' additions and the
  elementwise terms are left out. A training step counts three times
  this: forward, input gradient and weight gradient.
- `row_adam_bytes`: the least bytes of one lazy row-Adam step over the
  sparse tables, the work the update must do whatever implements it:
  for each table, each DISTINCT touched row's [table | mu | nu] read and
  written once (3 D floats each way) and its gradient row read once (D
  floats), plus the table's ids read once (int32). Counted from the
  distinct rows, not from a padded count of the flat ids, so a
  deduplicated or sync-free update reads the same work.
"""

from __future__ import annotations

from typing import Iterable, Sequence

F32 = 4
ID_BYTES = 4


def dlrm_flops_per_example(dim: int, dense_sizes: Sequence[int], over_sizes: Sequence[int],
                           cross_layers: int, cross_rank: int, tables: int,
                           dense_features: int = 13) -> float:
    width = (tables + 1) * dim
    bottom = sum(a * b for a, b in zip((dense_features, *dense_sizes), dense_sizes))
    cross = cross_layers * 2 * width * cross_rank
    over = sum(a * b for a, b in zip((width, *over_sizes), over_sizes))
    return 2.0 * (bottom + cross + over)


def config_flops_per_example(cfg: dict) -> float:
    """`dlrm_flops_per_example` at a configuration file's widths."""
    return dlrm_flops_per_example(cfg["embedding_dim"], cfg["dense_arch_layer_sizes"],
                                  cfg["over_arch_layer_sizes"], cfg["dcn_num_layers"],
                                  cfg["dcn_low_rank_dim"], len(cfg["num_embeddings_per_feature"]))


def row_adam_bytes(distinct_rows: Iterable[int], ids: Iterable[int], dim: int) -> int:
    """The least bytes of one step over tables whose distinct touched rows
    and flat id counts are given, table by table."""
    row = (3 * dim + dim + 3 * dim) * F32
    return sum(int(u) * row for u in distinct_rows) + sum(int(n) * ID_BYTES for n in ids)
