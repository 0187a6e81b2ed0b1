"""Ranking within queries, for every retrieval metric (counterpart of
``metrics_tpu/functional/retrieval/_ranking.py``).

The rows of all queries are put in one order, query ascending, score
descending, position ascending, by two stable sorts. Every retrieval metric
is then a few segment sums over the sorted rows, for all queries at once.

Ties follow the JAX package's ``jnp.lexsort``: equal scores keep their
input order, ``-0.0`` equals ``0.0`` and a NaN score ranks below every other
score of its query (NaN sorts after every number in both packages).
"""
from typing import NamedTuple, Optional

import torch


class GroupedRanking(NamedTuple):
    """The rows of all queries, sorted by (query, descending score)."""

    target: torch.Tensor  # targets in that order
    seg: torch.Tensor  # int64 dense query number of each row, 0..num_segments-1
    rank: torch.Tensor  # int64 0-based rank of each row within its query
    sizes: torch.Tensor  # int64 [Q] rows per query
    num_segments: int


def _score_order(preds: torch.Tensor) -> torch.Tensor:
    """Stable ascending order of ``-preds``: descending scores, ties in input
    order. Zeros are made one value first, so ``-0.0`` ties with ``0.0``
    whatever the sort's key transform does with the sign bit."""
    key = -preds
    key = torch.where(key == 0, torch.zeros_like(key), key)
    return torch.sort(key, stable=True).indices


def _group_by_query(
    preds: torch.Tensor, target: torch.Tensor, indexes: torch.Tensor, num_segments: Optional[int] = None
) -> GroupedRanking:
    """Sort by (query, descending score) and derive each row's query number
    and rank and each query's size. ``num_segments`` (the number of distinct
    queries) is read from the data when None, which syncs with the device."""
    order = _score_order(preds)
    order = order[torch.sort(indexes[order], stable=True).indices]
    idx_s = indexes[order]
    t_s = target[order]
    n = idx_s.shape[0]

    newseg = torch.cat([torch.ones(1, dtype=torch.bool, device=idx_s.device), idx_s[1:] != idx_s[:-1]])
    seg = torch.cumsum(newseg, dim=0) - 1
    pos = torch.arange(n, device=idx_s.device)
    # each query's first position, carried to all its rows
    seg_start = torch.cummax(torch.where(newseg, pos, 0), dim=0).values
    rank = pos - seg_start

    if num_segments is None:
        num_segments = int(seg[-1].item()) + 1
    sizes = torch.zeros(num_segments, dtype=torch.int64, device=seg.device).index_add_(0, seg, torch.ones_like(seg))
    return GroupedRanking(t_s, seg, rank, sizes, num_segments)


def _segment_sum(x: torch.Tensor, g: GroupedRanking) -> torch.Tensor:
    """Per-query sums of ``x``. Floats add in float64: a query's float32
    terms then sum exactly (while they span under 53 - 24 - log2(rows) bits,
    as hit counts and AP's ``hits / rank`` terms do at 1,000 candidates), so
    the atomic adds' order cannot change the result."""
    acc = torch.float64 if x.is_floating_point() else torch.int64
    out = torch.zeros(g.num_segments, dtype=acc, device=x.device).index_add_(0, g.seg, x.to(acc))
    return out.to(x.dtype)


def _segment_min(x: torch.Tensor, g: GroupedRanking) -> torch.Tensor:
    out = torch.full((g.num_segments,), torch.iinfo(x.dtype).max, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, g.seg, x, reduce="amin")


def _within_group_cumsum(x: torch.Tensor, g: GroupedRanking) -> torch.Tensor:
    """Inclusive cumulative sum restarting at each query: a global cumsum less
    its value before the query's first row. The two global sums are taken in
    float64, where counts stay exact to 2^53 rows (float32 would hold them
    exactly only below 2^24, 16.7M rows; MS MARCO dev has 6.98M)."""
    c = torch.cumsum(x, dim=0, dtype=torch.float64)
    start = torch.arange(x.shape[0], device=x.device) - g.rank
    return (c - (c[start] - x[start].to(torch.float64))).to(x.dtype)


def _k_mask(g: GroupedRanking, k: Optional[int]) -> torch.Tensor:
    """Rows within the top ``k`` of their query (all rows when ``k`` is None)."""
    if k is None:
        return torch.ones_like(g.rank, dtype=torch.bool)
    return g.rank < k


def _validate_k(k: Optional[int]) -> None:
    if k is not None and not (isinstance(k, int) and k > 0):
        raise ValueError("`k` has to be a positive integer or None")


def _sorted_by_scores(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """One query's targets in descending score order."""
    return target[_score_order(preds)]


def _ideal_grouping(target: torch.Tensor, indexes: torch.Tensor, num_segments: Optional[int] = None) -> GroupedRanking:
    """The grouping by (query, descending target): NDCG's ideal ranking."""
    return _group_by_query(target.to(torch.float32), target, indexes, num_segments)
