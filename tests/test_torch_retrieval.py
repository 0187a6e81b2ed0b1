"""The port's retrieval metrics against ``metrics_tpu`` on the same numpy
batches: the eight module metrics over several ``forward``/``update`` calls
(every ``empty_target_action``, ``ignore_index``, ``k`` from 1 to past the
longest query, graded NDCG targets, bounded buffers with and without
``ignore_index``), the eight single-query functionals, the ranking's tie
rules (equal scores, ``-0.0`` against ``0.0``, NaN scores, one-row queries,
queries whose targets are all 0 or all 1) and the retrieval helpers of
``utils``. The port runs on ``device="cpu"``.

Tolerance: retrieval values within 1e-6 absolute; counts and orders exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu.functional as fj
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as ft
from metrics_tpu.utils import data as jdata
from metrics_tpu_torch.functional.retrieval import _ranking
from metrics_tpu_torch.utils import data as tdata

ATOL = 1e-6
METRICS = (
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalPrecision",
    "RetrievalRecall",
    "RetrievalRPrecision",
    "RetrievalHitRate",
    "RetrievalFallOut",
    "RetrievalNormalizedDCG",
)
TOPK = ("RetrievalPrecision", "RetrievalRecall", "RetrievalHitRate", "RetrievalFallOut", "RetrievalNormalizedDCG")
FUNCTIONALS = (
    "retrieval_average_precision",
    "retrieval_reciprocal_rank",
    "retrieval_precision",
    "retrieval_recall",
    "retrieval_r_precision",
    "retrieval_hit_rate",
    "retrieval_fall_out",
    "retrieval_normalized_dcg",
)
FUNCTIONAL_TOPK = ("retrieval_precision", "retrieval_recall", "retrieval_hit_rate", "retrieval_fall_out", "retrieval_normalized_dcg")


def _batches(seed: int, n_batches: int = 4, graded: bool = False, ignore: bool = False):
    """``(preds, target, indexes)`` numpy batches over 7 queries: scores on a
    0.1 grid with signed zeros and a NaN (ties within queries), query 5 with
    no positive, query 6 all positive, a query of one row, a ragged last
    batch; ``ignore`` marks some targets -100."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        n = 24 - 5 * (i == n_batches - 1)
        indexes = rng.integers(0, 5, n)
        indexes[:3] = [5, 5, 6]
        indexes[3] = 7 + i  # a query of one row
        preds = np.round(rng.random(n) * 2 - 1, 1).astype(np.float32)
        preds[rng.integers(0, n, 2)] = -0.0
        preds[rng.integers(0, n, 1)] = np.nan if i == 1 else 0.0
        target = rng.integers(0, 4 if graded else 2, n)
        target[indexes == 5] = 0
        target[indexes == 6] = 1
        if ignore:
            target[rng.random(n) < 0.2] = -100
        out.append((preds, target, indexes))
    return out


def _assert_close(got, want) -> None:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _run_both(port_m, jax_m, batches) -> None:
    for i, (preds, target, indexes) in enumerate(batches):
        p, t, x = torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes)
        if i % 2 == 0:
            _assert_close(port_m(p, t, indexes=x), jax_m(jnp.asarray(preds), jnp.asarray(target), indexes=jnp.asarray(indexes)))
        else:
            port_m.update(p, t, x)
            jax_m.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(indexes))
    _assert_close(port_m.compute(), jax_m.compute())


@pytest.mark.parametrize("action", ["neg", "pos", "skip"])
@pytest.mark.parametrize("name", METRICS)
def test_module_metric_matches_jax(name, action):
    kwargs = {"empty_target_action": action}
    _run_both(getattr(mt, name)(device="cpu", **kwargs), getattr(mj, name)(**kwargs), _batches(seed=len(name)))


@pytest.mark.parametrize("k", [1, 2, 5, 100])
@pytest.mark.parametrize("name", TOPK)
def test_topk_metric_matches_jax_for_each_k(name, k):
    _run_both(getattr(mt, name)(k=k, device="cpu"), getattr(mj, name)(k=k), _batches(seed=3 * k))


@pytest.mark.parametrize("name", METRICS)
def test_ignore_index_matches_jax(name):
    batches = _batches(seed=7, ignore=True, graded=name == "RetrievalNormalizedDCG")
    _run_both(getattr(mt, name)(ignore_index=-100, device="cpu"), getattr(mj, name)(ignore_index=-100), batches)


@pytest.mark.parametrize("k", [None, 3])
def test_ndcg_graded_targets_match_jax(k):
    batches = _batches(seed=11, graded=True)
    _run_both(mt.RetrievalNormalizedDCG(k=k, device="cpu"), mj.RetrievalNormalizedDCG(k=k), batches)


@pytest.mark.parametrize("name", METRICS)
def test_error_action_raises_like_jax(name):
    batches = _batches(seed=13)
    port_m, jax_m = getattr(mt, name)(empty_target_action="error", device="cpu"), getattr(mj, name)(empty_target_action="error")
    for preds, target, indexes in batches:
        port_m.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes))
        jax_m.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(indexes))
    with pytest.raises(ValueError) as jax_err:
        jax_m.compute()
    with pytest.raises(ValueError) as port_err:
        port_m.compute()
    assert str(port_err.value) == str(jax_err.value)
    # without empty queries the value is the plain mean
    preds, target, indexes = (np.concatenate(cols) for cols in zip(*batches))
    keep = indexes < 5
    preds, target, indexes = preds[keep], target[keep].copy(), indexes[keep]
    for q in range(5):  # one positive and one negative in every query
        rows = np.flatnonzero(indexes == q)
        target[rows[0]], target[rows[-1]] = 1, 0
    port_m, jax_m = getattr(mt, name)(empty_target_action="error", device="cpu"), getattr(mj, name)(empty_target_action="error")
    port_m.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes))
    jax_m.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(indexes))
    _assert_close(port_m.compute(), jax_m.compute())


@pytest.mark.parametrize("ignore", [False, True])
@pytest.mark.parametrize("name", METRICS)
def test_bounded_buffers_match_jax_and_the_lists(name, ignore):
    """``buffer_capacity`` gives the unbounded lists' values, and its update
    runs as one program (no eager fallback), ``ignore_index`` included."""
    batches = _batches(seed=17, ignore=ignore, graded=name == "RetrievalNormalizedDCG")
    kwargs = {"ignore_index": -100} if ignore else {}
    port_b = getattr(mt, name)(buffer_capacity=200, device="cpu", **kwargs)
    port_u = getattr(mt, name)(device="cpu", **kwargs)
    jax_b = getattr(mj, name)(buffer_capacity=200, **kwargs)
    for preds, target, indexes in batches:
        for m in (port_b, port_u):
            m.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes))
        jax_b.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(indexes))
    assert int(port_b.count) == int(jax_b.count)
    _assert_close(port_b.compute(), jax_b.compute())
    assert torch.equal(port_b.compute(), port_u.compute())
    assert not port_b.compile_stats()["jit_failed"]


def test_bounded_overflow_raises_like_jax():
    batches = _batches(seed=19)
    port_m, jax_m = mt.RetrievalMAP(buffer_capacity=30, device="cpu"), mj.RetrievalMAP(buffer_capacity=30)
    for preds, target, indexes in batches[:2]:
        port_m.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes))
        jax_m.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(indexes))
    with pytest.raises(ValueError) as jax_err:
        jax_m.compute()
    with pytest.raises(ValueError) as port_err:
        port_m.compute()
    assert str(port_err.value) == str(jax_err.value)


def test_constructor_and_input_errors_match_jax():
    for name, kwargs in (
        ("RetrievalMAP", {"empty_target_action": "drop"}),
        ("RetrievalMAP", {"ignore_index": 1.5}),
        ("RetrievalPrecision", {"k": 0}),
        ("RetrievalNormalizedDCG", {"k": -2}),
        ("RetrievalMAP", {"buffer_capacity": 0}),
    ):
        with pytest.raises(ValueError) as jax_err:
            getattr(mj, name)(**kwargs)
        with pytest.raises(ValueError) as port_err:
            getattr(mt, name)(device="cpu", **kwargs)
        assert str(port_err.value) == str(jax_err.value)
    bad = (
        (np.array([0.5, 0.2], np.float32), np.array([1, 0]), np.array([0, 0, 1])),
        (np.array([0.5, 0.2], np.float32), np.array([1, 2]), np.array([0, 0])),
        (np.array([1, 2]), np.array([1, 0]), np.array([0, 0])),
        (np.array([0.5, 0.2], np.float32), np.array([1, 0]), np.array([0.0, 1.0])),
    )
    for preds, target, indexes in bad:
        with pytest.raises(ValueError) as jax_err:
            mj.RetrievalMAP().update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(indexes))
        with pytest.raises(ValueError) as port_err:
            mt.RetrievalMAP(device="cpu").update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes))
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="`indexes` cannot be None"):
        mt.RetrievalMAP(device="cpu").update(torch.ones(2), torch.ones(2, dtype=torch.int64), None)


# single queries: ties, signed zeros, NaN, one row, all 0, all 1
QUERIES = {
    "ties": (np.array([0.5, 0.5, 0.2, 0.5, 0.2], np.float32), np.array([0, 1, 1, 0, 1])),
    "signed_zeros": (np.array([-0.0, 0.0, -0.0, 0.1, 0.0], np.float32), np.array([0, 0, 1, 0, 1])),
    "nan": (np.array([np.nan, 0.3, -np.inf, 0.9, np.nan], np.float32), np.array([1, 0, 1, 0, 0])),
    "one_row": (np.array([0.4], np.float32), np.array([1])),
    "one_row_negative": (np.array([0.4], np.float32), np.array([0])),
    "all_zero": (np.array([0.1, 0.7, 0.3], np.float32), np.array([0, 0, 0])),
    "all_one": (np.array([0.1, 0.7, 0.3], np.float32), np.array([1, 1, 1])),
}


@pytest.mark.parametrize("query", list(QUERIES))
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_functional_matches_jax_on_edge_queries(name, query):
    preds, target = QUERIES[query]
    ks = (None, 1, 2, 3, 6) if name in FUNCTIONAL_TOPK else (None,)
    for k in ks:
        kwargs = {} if k is None else {"k": k}
        want = getattr(fj, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
        _assert_close(getattr(ft, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs), want)


@pytest.mark.parametrize("name", FUNCTIONALS)
def test_functional_matches_jax_on_random_queries(name):
    rng = np.random.default_rng(23)
    for _ in range(5):
        n = int(rng.integers(2, 40))
        preds = np.round(rng.random(n), 1).astype(np.float32)
        target = rng.integers(0, 4 if name == "retrieval_normalized_dcg" else 2, n)
        for k in (None, 1, 4, 50) if name in FUNCTIONAL_TOPK else (None,):
            kwargs = {} if k is None else {"k": k}
            want = getattr(fj, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
            _assert_close(getattr(ft, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs), want)


def test_functional_errors_match_jax():
    for name, preds, target, kwargs in (
        ("retrieval_precision", np.array([0.1, 0.2], np.float32), np.array([1, 0]), {"k": 0}),
        ("retrieval_recall", np.array([0.1, 0.2], np.float32), np.array([1, 0, 1]), {}),
        ("retrieval_average_precision", np.zeros(0, np.float32), np.zeros(0, np.int64), {}),
        ("retrieval_hit_rate", np.array([1, 2]), np.array([1, 0]), {}),
        ("retrieval_fall_out", np.array([0.1, 0.2], np.float32), np.array([3, 0]), {}),
    ):
        with pytest.raises(ValueError) as jax_err:
            getattr(fj, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
        with pytest.raises(ValueError) as port_err:
            getattr(ft, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
        assert str(port_err.value) == str(jax_err.value)


def test_grouping_order_follows_jax_lexsort():
    """Rows sorted by (query, descending score, position): equal scores keep
    their input order, ``-0.0`` ties with ``0.0``, NaN ranks last in its
    query, as the JAX package's ``jnp.lexsort((-preds, indexes))``."""
    preds = np.array([0.0, -0.0, np.nan, 0.5, 0.0, -0.0, 0.5, np.nan, -np.inf, 0.5], np.float32)
    indexes = np.array([2, 2, 2, 1, 1, 2, 1, 1, 1, 2])
    target = np.arange(10)
    want = np.asarray(jnp.lexsort((-jnp.asarray(preds), jnp.asarray(indexes))))
    g = _ranking._group_by_query(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes))
    np.testing.assert_array_equal(g.target.numpy(), target[want])
    np.testing.assert_array_equal(g.rank.numpy(), [0, 1, 2, 3, 4, 0, 1, 2, 3, 4])
    np.testing.assert_array_equal(g.sizes.numpy(), [5, 5])


def test_utils_helpers_match_jax():
    x = np.array([3, 1, 3, 0, 1, 3, 7])
    got = tdata.get_group_indexes(torch.from_numpy(x))
    want = jdata.get_group_indexes(jnp.asarray(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tdata._flexible_bincount(torch.from_numpy(x)).numpy(), np.asarray(jdata._flexible_bincount(jnp.asarray(x))))
    f = np.array([0.5, 0.25, 1.0], np.float32)
    np.testing.assert_array_equal(tdata._cumsum(torch.from_numpy(f)).numpy(), np.asarray(jdata._cumsum(jnp.asarray(f))))


def test_collection_of_all_eight_matches_jax():
    """One ``MetricCollection`` of the eight, as a passage-ranking eval runs them."""

    def members(pkg, **dev):
        return {
            "mrr": pkg.RetrievalMRR(**dev),
            "map": pkg.RetrievalMAP(**dev),
            "r_prec": pkg.RetrievalRPrecision(**dev),
            "ndcg10": pkg.RetrievalNormalizedDCG(k=10, **dev),
            "p10": pkg.RetrievalPrecision(k=10, **dev),
            "hit10": pkg.RetrievalHitRate(k=10, **dev),
            "fallout10": pkg.RetrievalFallOut(k=10, **dev),
            "r100": pkg.RetrievalRecall(k=100, **dev),
        }

    port_mc, jax_mc = mt.MetricCollection(members(mt, device="cpu")), mj.MetricCollection(members(mj))
    for preds, target, indexes in _batches(seed=29):
        got = port_mc(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(indexes))
        want = jax_mc(jnp.asarray(preds), jnp.asarray(target), indexes=jnp.asarray(indexes))
        for key in want:
            _assert_close(got[key], want[key])
    got, want = port_mc.compute(), jax_mc.compute()
    for key in want:
        _assert_close(got[key], want[key])
