"""The port's cross-process sync against ``metrics_tpu`` on the same inputs.

In process: a ``dist_sync_fn`` stands in for the other ranks (as
``tests/helpers/testers.py`` does for the JAX package), and the synced
results of both packages are held together. Across processes: this file is
also the worker of real ``torch.distributed`` gloo runs on the CPU (2 ranks,
and 3 ranks with a subgroup ``{0, 2}`` syncing while rank 1 syncs alone);
each rank streams its share of the batches and syncs in ``compute()``, and
its results are held against serial ``metrics_tpu`` over the ranks' batches
in rank-major order; a second world of 2 does so for ``JaccardIndex``,
``CohenKappa`` and ``RetrievalNormalizedDCG`` (its rows are ``cat`` list
states, gathered rank-major), and a third for ``MeanAveragePrecision``,
whose per-image states must keep their image boundaries (bit for bit). Counts must match bit for bit, scores within 1e-6
relative (kappa also within 1e-6 absolute), float sums within 1e-5
relative, NDCG within 1e-6 absolute, cat states exactly. Every worker
runs under a wall-clock limit of its own and is killed past it.
"""
import copy
import os
import pickle
import socket
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_SCORE = 1e-6
RTOL_SUM = 1e-5
C = 7
TOP_K = 3
BATCH_SIZES = (40, 33, 40, 29, 40, 40, 21)  # rank 0 of 2 takes 4 batches, rank 1 takes 3
WORKER_TIMEOUT_S = 120
# result keys compared exactly (counts, and the cat buffer), as float sums,
# or as float32 moments that cancel (explained variance: 1e-4 relative)
EXACT_KEYS = {"confmat", "confidence", "cat"}
SUM_KEYS = {"loss_mean", "loss_max"}
MOMENT_KEYS = {"explained_variance"}


def _batches(seed: int = 0):
    """Seeded batches: logits, labels, each sample's cross-entropy and top-1
    confidence (float32, computed once so both packages see the same values)
    and a regression pair."""
    rng = np.random.default_rng(seed)
    out = []
    for n in BATCH_SIZES:
        logits = rng.standard_normal((n, C)).astype(np.float32)
        target = rng.integers(0, C, n)
        logits[np.arange(n), target] += np.float32(1.0)
        z = logits.astype(np.float64)
        lse = np.log(np.exp(z - z.max(1, keepdims=True)).sum(1)) + z.max(1)
        loss = (lse - z[np.arange(n), target]).astype(np.float32)
        confidence = np.exp(z.max(1) - lse).astype(np.float32)
        x = rng.standard_normal(n).astype(np.float32)
        y = (0.6 * x + 0.8 * rng.standard_normal(n)).astype(np.float32)
        x3 = rng.standard_normal((n, 3)).astype(np.float32)
        y3 = (x3 + 0.5 * rng.standard_normal((n, 3))).astype(np.float32)
        out.append(
            {"preds": logits, "target": target, "loss": loss, "confidence": confidence, "x": x, "y": y, "x3": x3, "y3": y3}
        )
    return out


def _renamed(base, arg: str):
    """``base`` with its ``update`` argument renamed to ``arg``, so that a
    collection routes each sample's loss and confidence to different
    aggregators by keyword."""
    if arg == "loss":

        class OverLoss(base):
            def update(self, loss):
                base.update(self, loss)

        return OverLoss

    class OverConfidence(base):
        def update(self, confidence):
            base.update(self, confidence)

    return OverConfidence


def _collection(pkg, **kw):
    """The sync phase's collection at small width, in either package."""
    harmonic = 2 / (
        1 / pkg.Precision(num_classes=C, average="macro", top_k=TOP_K, **kw) + 1 / pkg.Recall(average="micro", **kw)
    )
    return pkg.MetricCollection(
        {
            "top1": pkg.Accuracy(num_classes=C, **kw),
            "topk": pkg.Accuracy(num_classes=C, top_k=TOP_K, **kw),
            "f1": pkg.F1Score(num_classes=C, average="macro", **kw),
            "confmat": pkg.ConfusionMatrix(num_classes=C, **kw),
            "precision": pkg.Precision(num_classes=C, average="macro", top_k=TOP_K, **kw),
            "recall": pkg.Recall(average="micro", **kw),
            "specificity": pkg.Specificity(num_classes=C, average="macro", **kw),
            "hamming": pkg.HammingDistance(**kw),
            "loss_mean": _renamed(pkg.MeanMetric, "loss")(**kw),
            "loss_max": _renamed(pkg.MaxMetric, "loss")(**kw),
            "confidence": _renamed(pkg.CatMetric, "confidence")(**kw),
            "harmonic": harmonic,
        }
    )


def _feed(mc, batch, as_tensor) -> None:
    mc.update(
        preds=as_tensor(batch["preds"]),
        target=as_tensor(batch["target"]),
        loss=as_tensor(batch["loss"]),
        confidence=as_tensor(batch["confidence"]),
    )


def _rank_batches(rank: int, world: int, ranks=None):
    """Indices of the batches ``rank`` streams; with ``ranks``, those of all
    of them in rank-major order (what a sync over them gathers)."""
    ranks = [rank] if ranks is None else ranks
    return [i for r in ranks for i in range(r, len(BATCH_SIZES), world)]


def _assert_matches(got: dict, want: dict, where: str) -> None:
    assert set(got) == set(want), where
    for key, w in want.items():
        g = np.asarray(got[key].cpu().numpy() if isinstance(got[key], torch.Tensor) else got[key])
        w = np.asarray(w)
        assert g.shape == w.shape, f"{where} {key}: shape {g.shape} vs {w.shape}"
        if key in EXACT_KEYS or w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {key}")
        else:
            rtol = 1e-4 if key in MOMENT_KEYS else RTOL_SUM if key in SUM_KEYS else RTOL_SCORE
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=f"{where} {key}")


# ---------------------------------------------------------------------------
# the worker (this file run as a script, one process per rank)
# ---------------------------------------------------------------------------
def _ranking_metrics(pkg, **kw):
    """Jaccard, kappa and a list-state retrieval metric, in either package."""
    return {
        "iou": pkg.JaccardIndex(num_classes=C, ignore_index=0, **kw),
        "kappa": pkg.CohenKappa(num_classes=C, weights="quadratic", **kw),
        "ndcg": pkg.RetrievalNormalizedDCG(k=3, **kw),
    }


def _feed_ranking(metrics, batch, as_tensor) -> None:
    """Classification members take the logits; NDCG ranks the rounded ``x``
    scores of each sample within queries named by its label."""
    metrics["iou"].update(as_tensor(batch["preds"]), as_tensor(batch["target"]))
    metrics["kappa"].update(as_tensor(batch["preds"]), as_tensor(batch["target"]))
    scores = np.round(batch["x"], 1).astype(np.float32)
    relevant = (batch["y"] > 0).astype(np.int64)
    metrics["ndcg"].update(as_tensor(scores), as_tensor(relevant), as_tensor(batch["target"]))


def _worker(rank: int, world: int, port: int, out_path: str, mode: str = "collection") -> None:
    sys.path.insert(0, REPO)
    import metrics_tpu_torch as mt

    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank, timeout=timedelta(seconds=60)
    )
    data = _batches()
    as_tensor = torch.from_numpy
    results = {}
    if mode == "placeholder":
        results = _placeholder_world(mt, rank)
    elif mode == "bert_score":
        results = _bert_score_world(mt, rank)
    elif mode == "detection":
        results = _detection_world(mt, rank)
    elif mode == "ranking":
        metrics = _ranking_metrics(mt, device="cpu")
        for i in _rank_batches(rank, world):
            _feed_ranking(metrics, data[i], as_tensor)
        results["ranking"] = {k: m.compute() for k, m in metrics.items()}
        results["local_rows"] = len(torch.cat(metrics["ndcg"].preds))
    elif world == 2:
        mine = _rank_batches(rank, world)
        mc, pure = _collection(mt, device="cpu"), _collection(mt, device="cpu")
        spearman, pearson = mt.SpearmanCorrCoef(device="cpu"), mt.PearsonCorrCoef(device="cpu")
        cat = mt.CatMetric(device="cpu")
        # sums that take the inputs' width: their shapes are exchanged first
        ev, lonely = (mt.ExplainedVariance(multioutput="raw_values", device="cpu") for _ in range(2))
        states = pure.init_state()
        for i in mine:
            b = data[i]
            _feed(mc, b, as_tensor)
            spearman.update(as_tensor(b["x"]), as_tensor(b["y"]))
            pearson.update(as_tensor(b["x"]), as_tensor(b["y"]))
            cat.update(as_tensor(b["loss"]))
            ev.update(as_tensor(b["x3"]), as_tensor(b["y3"]))
            states = pure.update_state(states, **{k: as_tensor(b[k]) for k in ("preds", "target", "loss", "confidence")})
        results["collection"] = mc.compute()
        results["regression"] = {
            "spearman": spearman.compute(), "pearson": pearson.compute(), "cat": cat.compute(),
            "explained_variance": ev.compute(),
        }
        # rank 1 never updates: its scalar sums cannot meet rank 0's [3], and
        # every rank says so instead of waiting in a mismatched collective
        if rank == 0:
            lonely.update(as_tensor(data[0]["x3"]), as_tensor(data[0]["y3"]))
        try:
            lonely.compute()
            results["lonely"] = "no error"
        except ValueError as err:
            results["lonely"] = str(err)
        results["pure"] = pure.compute_state(pure.sync_state(states))
        # compute() gave the local state back
        results["local_rows"] = len(torch.cat(mc["confidence"].value))
    else:  # 3 ranks: {0, 2} sync over their group while rank 1 syncs alone
        pair, alone = dist.new_group([0, 2]), dist.new_group([1])
        group = alone if rank == 1 else pair
        mc = _collection(mt, device="cpu", process_group=group)
        for i in _rank_batches(rank, world):
            _feed(mc, data[i], as_tensor)
        results["collection"] = mc.compute()
    dist.barrier()
    dist.destroy_process_group()
    torch.save(results, out_path)


PLACEHOLDER_WIDTH = 5


def _rows_metric(pkg, placeholder: bool):
    """A metric with one ``cat`` list state of int64 rows of width 5, with
    or without a declared placeholder."""

    class Rows(pkg.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            spec = torch.zeros((0, PLACEHOLDER_WIDTH), dtype=torch.int64) if placeholder else None
            self.add_state("rows", default=[], dist_reduce_fx="cat", placeholder=spec)

        def update(self, x):
            self.rows.append(x)

        def compute(self):
            return self.cat_state("rows") if placeholder else self.rows

    return Rows


def _placeholder_world(mt, rank: int) -> dict:
    """Both ranks empty, then rank 0 alone holding rows: the declared
    metric, the undeclared one and the raw gather of the placeholder."""
    from metrics_tpu_torch.parallel import comm

    declared, undeclared = _rows_metric(mt, True)(device="cpu"), _rows_metric(mt, False)(device="cpu")
    out = {
        "empty": declared.compute(),
        "empty_undeclared": undeclared.compute(),
        "empty_pure": declared.sync_state(declared.init_state())["rows"],
        "gather": comm.gather_all_arrays(torch.zeros((0, PLACEHOLDER_WIDTH), dtype=torch.int64)),
    }
    declared.reset()
    if rank == 0:
        declared.update(torch.arange(3 * PLACEHOLDER_WIDTH, dtype=torch.int64).reshape(3, PLACEHOLDER_WIDTH))
    out["one_holder"] = declared.compute()
    return out


def _bert_score_world(mt, rank: int) -> dict:
    """Rank 0 holds three sentences and rank 1 none; then both empty."""
    from tests.test_torch_bert_score import MAX_LEN, PREDS, TARGETS, port_model
    from tests.text.test_bert import toy_tokenizer

    metric = mt.BERTScore(model=port_model, user_tokenizer=toy_tokenizer, max_length=MAX_LEN, device="cpu")
    if rank == 0:
        metric.update(PREDS, TARGETS)
    out = {"scores": metric.compute()}
    metric.reset()
    out["empty"] = metric.sync_state(metric.init_state())
    out["empty_compute"] = metric.compute()
    return out


DETECTION_SPLIT = (7, 4)  # images of rank 0 and rank 1


def _detection_images():
    from tests.helpers.detection_scenes import detection_scenes

    return detection_scenes(31, sum(DETECTION_SPLIT))


def _detection_world(mt, rank: int) -> dict:
    """mAP over this rank's images, synced in ``compute()`` and through the
    pure ``sync_state``; the images left on this rank after the unsync."""
    preds, targets = _detection_images()
    lo = sum(DETECTION_SPLIT[:rank])
    mine = slice(lo, lo + DETECTION_SPLIT[rank])
    m = mt.MeanAveragePrecision(class_metrics=True, device="cpu")
    m.update(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in preds[mine]],
        [{k: torch.from_numpy(v) for k, v in t.items()} for t in targets[mine]],
    )
    return {
        "map": m.compute(),
        "pure": m.compute_state(m.sync_state(m._snapshot_state())),
        "local_images": len(m.detection_boxes),
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(world: int, tmp_path, mode: str = "collection") -> list:
    """Start ``world`` workers, wait for each within its limit, and return
    their results; a worker that fails or outlives its limit fails the test
    with every worker's log."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs, paths = [], []
    for rank in range(world):
        path = str(tmp_path / f"rank{rank}.pt")
        log = open(tmp_path / f"rank{rank}.log", "w+")
        cmd = [sys.executable, os.path.abspath(__file__), str(rank), str(world), str(port), path, mode]
        procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO), log))
        paths.append(path)
    failures = []
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = f"killed after {WORKER_TIMEOUT_S} s"
            if rc != 0:
                failures.append((rank, rc))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        logs = []
        for rank, (_, log) in enumerate(procs):
            log.seek(0)
            logs.append(f"--- rank {rank} ---\n{log.read()[-4000:]}")
        pytest.fail(f"workers failed {failures}:\n" + "\n".join(logs))
    for _, log in procs:
        log.close()
    return [torch.load(p, weights_only=False) for p in paths]


def _serial_jax(indices):
    """Serial ``metrics_tpu`` over the given batches, in that order."""
    import jax.numpy as jnp

    import metrics_tpu as mj

    data = _batches()
    mc = _collection(mj)
    spearman, pearson, cat = mj.SpearmanCorrCoef(), mj.PearsonCorrCoef(), mj.CatMetric()
    ev = mj.ExplainedVariance(multioutput="raw_values")
    for i in indices:
        b = data[i]
        _feed(mc, b, jnp.asarray)
        spearman.update(jnp.asarray(b["x"]), jnp.asarray(b["y"]))
        pearson.update(jnp.asarray(b["x"]), jnp.asarray(b["y"]))
        cat.update(jnp.asarray(b["loss"]))
        ev.update(jnp.asarray(b["x3"]), jnp.asarray(b["y3"]))
    regression = {
        "spearman": spearman.compute(), "pearson": pearson.compute(), "cat": cat.compute(),
        "explained_variance": ev.compute(),
    }
    return {k: np.asarray(v) for k, v in mc.compute().items()}, {k: np.asarray(v) for k, v in regression.items()}


def test_two_gloo_ranks_equal_serial_jax(tmp_path):
    results = _run_world(2, tmp_path)
    want, want_regression = _serial_jax(_rank_batches(0, 2, ranks=[0, 1]))
    lengths = [sum(BATCH_SIZES[i] for i in _rank_batches(r, 2)) for r in range(2)]
    assert lengths[0] != lengths[1]  # the cat states are uneven
    for rank, res in enumerate(results):
        _assert_matches(res["collection"], want, f"rank {rank} compute()")
        _assert_matches(res["pure"], want, f"rank {rank} sync_state")
        _assert_matches(res["regression"], want_regression, f"rank {rank} regression")
        assert res["local_rows"] == lengths[rank]  # unsync gave the local buffer back
        assert "different dtypes or ranks" in res["lonely"], res["lonely"]


def test_two_gloo_ranks_of_jaccard_kappa_and_ndcg_equal_serial_jax(tmp_path):
    """Uneven shares (4 and 3 batches); the NDCG rows gather rank-major, so
    the synced value is serial ``metrics_tpu``'s over that order."""
    import jax.numpy as jnp

    import metrics_tpu as mj

    results = _run_world(2, tmp_path, mode="ranking")
    serial = _ranking_metrics(mj)
    for i in _rank_batches(0, 2, ranks=[0, 1]):
        _feed_ranking(serial, _batches()[i], jnp.asarray)
    want = {k: np.asarray(m.compute()) for k, m in serial.items()}
    lengths = [sum(BATCH_SIZES[i] for i in _rank_batches(r, 2)) for r in range(2)]
    for rank, res in enumerate(results):
        got = res["ranking"]
        np.testing.assert_allclose(got["iou"].numpy(), want["iou"], rtol=RTOL_SCORE, atol=0, err_msg=f"rank {rank} iou")
        np.testing.assert_allclose(got["kappa"].numpy(), want["kappa"], rtol=RTOL_SCORE, atol=1e-6, err_msg=f"rank {rank} kappa")
        np.testing.assert_allclose(got["ndcg"].numpy(), want["ndcg"], rtol=0, atol=1e-6, err_msg=f"rank {rank} ndcg")
        assert res["local_rows"] == lengths[rank]  # unsync gave the local rows back


def test_three_gloo_ranks_with_a_subgroup_equal_serial_jax(tmp_path):
    results = _run_world(3, tmp_path)
    want_pair, _ = _serial_jax(_rank_batches(0, 3, ranks=[0, 2]))
    want_alone, _ = _serial_jax(_rank_batches(1, 3))
    _assert_matches(results[0]["collection"], want_pair, "rank 0 of {0, 2}")
    _assert_matches(results[2]["collection"], want_pair, "rank 2 of {0, 2}")
    _assert_matches(results[1]["collection"], want_alone, "rank 1 alone")


# ---------------------------------------------------------------------------
# in process: a dist_sync_fn stands in for the other ranks
# ---------------------------------------------------------------------------
def _reductions_metric(pkg):
    """A metric with one state per reduction, in either package."""
    if pkg.__name__ == "metrics_tpu":
        import jax.numpy as xp
    else:
        xp = torch

    class Reductions(pkg.Metric):
        full_state_update = True

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            for name, fx in (("s", "sum"), ("m", "mean"), ("hi", "max"), ("lo", "min"), ("stack", None)):
                self.add_state(name, default=np.zeros(3, np.float32), dist_reduce_fx=fx)
            self.add_state("rows", default=[], dist_reduce_fx="cat")
            self.add_state("n", default=np.zeros((), np.int64), dist_reduce_fx="sum")

        def update(self, x):
            self.s = self.s + x.sum(0)
            self.m = self.m + x.mean(0)
            self.hi = xp.maximum(self.hi, xp.amax(x, 0))
            self.lo = xp.minimum(self.lo, xp.amin(x, 0))
            self.stack = self.stack + x[0]
            self.rows.append(x)
            self.n = self.n + x.shape[0]

        def compute(self):
            return self.s

    return Reductions


def _peer_gather(pkg, peers):
    """A ``dist_sync_fn`` that answers each leaf with this rank's tensor and
    the peers' (taken from ``peers``, metrics of the same class, at call
    time), in the sorted state order both packages gather in."""
    calls = {"i": 0}

    def leaves(m):
        if pkg.__name__ == "metrics_tpu":
            import jax

            from metrics_tpu.utils.data import dim_zero_cat

            state = {a: getattr(m, a) for a in m._reductions}
            state = {a: ([dim_zero_cat(v)] if isinstance(v, list) and v else v) for a, v in state.items()}
            return jax.tree_util.tree_leaves(state)
        return list(m._sync_leaves(m._snapshot_state()).values())

    def gather(x, group=None):
        i = calls["i"]
        calls["i"] += 1
        return [x] + [leaves(p)[i % len(leaves(p))] for p in peers]

    return gather


def _as(pkg):
    if pkg.__name__ == "metrics_tpu":
        import jax.numpy as jnp

        return jnp.asarray
    return torch.from_numpy


def _packages():
    import metrics_tpu as mj
    import metrics_tpu_torch as mt

    return mj, mt


def _synced_states(pkg, xs_rank0, xs_rank1):
    as_array = _as(pkg)
    kw = {} if pkg.__name__ == "metrics_tpu" else {"device": "cpu"}
    cls = _reductions_metric(pkg)
    m0, m1 = cls(**kw), cls(**kw)
    for x in xs_rank0:
        m0.update(as_array(x))
    for x in xs_rank1:
        m1.update(as_array(x))
    m0._distributed_available_fn = lambda: True
    m0.sync(dist_sync_fn=_peer_gather(pkg, [m1]), distributed_available=lambda: True)
    synced = {a: np.asarray(getattr(m0, a)) for a in m0._defaults}
    m0.unsync()
    local = {a: getattr(m0, a) for a in m0._defaults}
    return synced, local, m0


def test_every_reduction_syncs_like_jax():
    mj, mt = _packages()
    rng = np.random.default_rng(4)
    xs0 = [rng.standard_normal((5, 3)).astype(np.float32), rng.standard_normal((2, 3)).astype(np.float32)]
    xs1 = [rng.standard_normal((4, 3)).astype(np.float32)]
    want, _, _ = _synced_states(mj, xs0, xs1)
    got, local, m0 = _synced_states(mt, xs0, xs1)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL_SUM, atol=0, err_msg=key)
    np.testing.assert_array_equal(got["rows"], np.concatenate(xs0 + xs1))  # uneven cat, rank-major
    # unsync restored the local state: a list of this rank's rows, its own counts
    assert isinstance(local["rows"], list) and len(local["rows"]) == 2 and int(local["n"]) == 7
    assert not m0._is_synced and m0._cache is None


def test_uneven_and_empty_list_states_gather_rank_major():
    _, mt = _packages()
    cat = [mt.CatMetric(device="cpu") for _ in range(3)]
    cat[0].update(torch.tensor([1.0, 2.0, 3.0]))
    cat[2].update(torch.tensor([[4.0], [5.0]]).reshape(-1))
    # rank 1 holds nothing: it gathers as empty and the rest keep rank order
    cat[0].sync(dist_sync_fn=_peer_gather(mt, cat[1:]), distributed_available=True)
    assert cat[0].value.tolist() == [1.0, 2.0, 3.0, 4.0, 5.0]
    cat[0].unsync()
    cat[1].sync(dist_sync_fn=lambda x, group=None: [x, torch.zeros(0)], distributed_available=True)
    assert cat[1].value == []  # no rank held data
    cat[1].unsync()


def test_sync_context_restores_and_double_sync_raises():
    _, mt = _packages()
    from metrics_tpu_torch.utils.exceptions import MetricsUserError

    a, b = mt.Accuracy(num_classes=C, device="cpu"), mt.Accuracy(num_classes=C, device="cpu")
    data = _batches()
    a.update(torch.from_numpy(data[0]["preds"]), torch.from_numpy(data[0]["target"]))
    b.update(torch.from_numpy(data[1]["preds"]), torch.from_numpy(data[1]["target"]))
    before = {n: getattr(a, n).clone() for n in a._defaults}
    gather = _peer_gather(mt, [b])
    with a.sync_context(dist_sync_fn=gather, distributed_available=True):
        assert int(a.tp + a.fn) == BATCH_SIZES[0] + BATCH_SIZES[1]
        with pytest.raises(MetricsUserError, match="already been synced"):
            a.sync(dist_sync_fn=gather, distributed_available=True)
        with pytest.raises(MetricsUserError, match="shouldn't be synced"):
            a(torch.from_numpy(data[2]["preds"]), torch.from_numpy(data[2]["target"]))
    assert all(torch.equal(getattr(a, n), before[n]) for n in a._defaults)
    with pytest.raises(MetricsUserError, match="already been un-synced"):
        a.unsync()
    a.sync(dist_sync_fn=gather, distributed_available=False)  # no world: nothing happens
    assert not a._is_synced


def test_failed_gather_raises_or_keeps_the_local_state():
    _, mt = _packages()
    from metrics_tpu_torch.obs.warn import reset_warn_once
    from metrics_tpu_torch.utils.exceptions import SyncError

    def broken(x, group=None):
        raise RuntimeError("peer 1 closed the connection")

    data = _batches()
    preds, target = torch.from_numpy(data[0]["preds"]), torch.from_numpy(data[0]["target"])
    strict = mt.Accuracy(num_classes=C, dist_sync_fn=broken, device="cpu")
    strict._distributed_available_fn = lambda: True
    strict.update(preds, target)
    with pytest.raises(SyncError, match="peer 1 closed"):
        strict.compute()
    reset_warn_once()
    lenient = mt.Accuracy(num_classes=C, dist_sync_fn=broken, on_sync_error="local", device="cpu")
    lenient._distributed_available_fn = lambda: True
    lenient.update(preds, target)
    with pytest.warns(UserWarning, match="keeping the rank-local state"):
        got = lenient.compute()
    assert float(got) == float(mt.functional.accuracy(preds, target, num_classes=C))
    assert not lenient._is_synced
    # "partial" is accepted; a custom gather has no per-rank result, so its
    # failure degrades the whole state, as "local" does (the JAX package's rule)
    reset_warn_once()
    partial = mt.Accuracy(num_classes=C, dist_sync_fn=broken, on_sync_error="partial", device="cpu")
    partial._distributed_available_fn = lambda: True
    partial.update(preds, target)
    with pytest.warns(UserWarning, match="keeping the rank-local state"):
        got = partial.compute()
    assert float(got) == float(mt.functional.accuracy(preds, target, num_classes=C))
    report = partial.sync_report()
    assert report["last_sync_outcome"] == "local" and report["degraded_local"] == 1 and report["missing_ranks"] == []
    with pytest.raises(ValueError, match="on_sync_error"):
        mt.Accuracy(on_sync_error="retry-forever", device="cpu")
    with pytest.raises(ValueError, match="ProcessGroup"):
        mt.Accuracy(process_group=object(), device="cpu")


STEP_METRICS = {"Accuracy": ({"num_classes": C}, ("preds", "target")), "MaxMetric": ({}, ("loss",))}


@pytest.mark.parametrize("name", sorted(STEP_METRICS))  # the merge path and the full-state path
def test_dist_sync_on_step_syncs_the_batch_value_like_jax(name):
    """With ``dist_sync_on_step`` the batch value of ``forward`` covers every
    rank's batch, while the accumulated state stays this rank's own."""
    mj, mt = _packages()
    data = _batches()
    args, keys = STEP_METRICS[name]

    def run(pkg, kw):
        as_array = _as(pkg)
        peer = getattr(pkg, name)(**args, **kw)
        m = getattr(pkg, name)(dist_sync_on_step=True, **args, **kw)
        m._distributed_available_fn = lambda: True
        batch_values = []
        for i in (0, 2):  # this rank streams batches 0 and 2 while its peer streams 1 and 3
            peer.reset()
            peer.update(*(as_array(data[i + 1][k]) for k in keys))
            m.dist_sync_fn = _peer_gather(pkg, [peer])
            batch_values.append(np.asarray(m(*(as_array(data[i][k]) for k in keys))))
        m.dist_sync_fn = None
        m._distributed_available_fn = None
        return batch_values, np.asarray(m.compute())

    def serial(batches):
        m = getattr(mt, name)(**args, device="cpu")
        for i in batches:
            m.update(*(torch.from_numpy(data[i][k]) for k in keys))
        return m.compute().numpy()

    (want_batches, want_total), (got_batches, got_total) = run(mj, {}), run(mt, {"device": "cpu"})
    for i, g, w in zip((0, 2), got_batches, want_batches):
        np.testing.assert_allclose(g, w, rtol=RTOL_SCORE, atol=0)
        np.testing.assert_allclose(g, serial([i, i + 1]), rtol=RTOL_SCORE, atol=0)  # both ranks' batch
    np.testing.assert_allclose(got_total, want_total, rtol=RTOL_SCORE, atol=0)
    np.testing.assert_allclose(got_total, serial([0, 2]), rtol=RTOL_SCORE, atol=0)  # no batch merged twice


def test_pure_sync_state_over_a_fake_world_matches_the_module_sync():
    mj, mt = _packages()
    data = _batches()
    port = _collection(mt, device="cpu")
    states = port.init_state()
    for i in (0, 1):
        b = data[i]
        states = port.update_state(
            states, preds=torch.from_numpy(b["preds"]), target=torch.from_numpy(b["target"]),
            loss=torch.from_numpy(b["loss"]), confidence=torch.from_numpy(b["confidence"]),
        )
    # a world of one (no default group) gathers the local state: None stacks, the rest stay
    synced = port.sync_state(states)
    _assert_matches(port.compute_state(synced), port.compute_state(states), "sync_state at world size 1")
    jax_mc = _collection(mj)
    for i in (0, 1):
        _feed(jax_mc, data[i], _as(mj))
    want = {k: np.asarray(v) for k, v in jax_mc.compute().items()}
    _assert_matches(port.compute_state(states), want, "pure API")


def test_bounded_buffers_sync_like_jax():
    """Fixed-capacity sample buffers (``dist_reduce_fx=None``) stack over
    the ranks, and the synced compute joins each rank's valid rows."""
    mj, mt = _packages()
    data = _batches()
    results = {}
    for pkg in (mj, mt):
        as_array = _as(pkg)
        kw = {} if pkg is mj else {"device": "cpu"}
        m, peer = pkg.SpearmanCorrCoef(buffer_capacity=128, **kw), pkg.SpearmanCorrCoef(buffer_capacity=128, **kw)
        for i in (0, 2):
            m.update(as_array(data[i]["x"]), as_array(data[i]["y"]))
        peer.update(as_array(data[1]["x"]), as_array(data[1]["y"]))
        m.dist_sync_fn = _peer_gather(pkg, [peer])
        m._distributed_available_fn = lambda: True
        results[pkg.__name__] = np.asarray(m.compute())
    serial = mt.SpearmanCorrCoef(device="cpu")
    for i in (0, 2, 1):
        serial.update(torch.from_numpy(data[i]["x"]), torch.from_numpy(data[i]["y"]))
    np.testing.assert_allclose(results["metrics_tpu_torch"], results["metrics_tpu"], rtol=RTOL_SCORE, atol=0)
    np.testing.assert_allclose(results["metrics_tpu_torch"], serial.compute().numpy(), rtol=RTOL_SCORE, atol=0)


def test_moving_a_synced_metric_moves_its_cache():
    _, mt = _packages()
    a, b = mt.ConfusionMatrix(num_classes=3, device="cpu"), mt.ConfusionMatrix(num_classes=3, device="cpu")
    a.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
    b.update(torch.tensor([2, 2]), torch.tensor([2, 0]))
    a.sync(dist_sync_fn=_peer_gather(mt, [b]), distributed_available=True)
    assert int(a.confmat.sum()) == 5
    a.to("meta")
    a.unsync()
    assert a.confmat.device.type == "meta" and a._cache is None
    cat, peer = mt.CatMetric(device="cpu"), mt.CatMetric(device="cpu")
    cat.update(torch.tensor([1.0, 2.0]))
    peer.update(torch.tensor([3.0]))
    cat.sync(dist_sync_fn=_peer_gather(mt, [peer]), distributed_available=True)
    cat.to(torch.float64)  # the synced list state is one tensor until unsync
    assert cat.value.dtype == torch.float64 and cat.value.tolist() == [1.0, 2.0, 3.0]
    cat.unsync()
    assert isinstance(cat.value, list) and cat.value[0].dtype == torch.float64


def test_comm_reductions_match_jax():
    """``class_reduce``, ``reduce`` and ``host_reduce`` (a world of one here)
    give the JAX package's values and shapes."""
    import jax.numpy as jnp

    from metrics_tpu.parallel import comm as jcomm
    from metrics_tpu_torch.parallel import comm as pcomm

    rng = np.random.default_rng(8)
    num, denom, weights = (rng.integers(0, 9, 5).astype(np.float32) for _ in range(3))
    denom[1] = 0
    for red in ("micro", "macro", "weighted", "none"):
        got = pcomm.class_reduce(torch.from_numpy(num), torch.from_numpy(denom), torch.from_numpy(weights), red)
        want = jcomm.class_reduce(jnp.asarray(num), jnp.asarray(denom), jnp.asarray(weights), red)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL_SCORE, atol=0)
    x = rng.standard_normal((4, 3)).astype(np.float32)
    for red in ("elementwise_mean", "sum", "none"):
        np.testing.assert_allclose(pcomm.reduce(torch.from_numpy(x), red).numpy(), np.asarray(jcomm.reduce(jnp.asarray(x), red)), rtol=RTOL_SCORE)
    for fx in ("sum", "mean", "max", "min", "cat", None):
        got, want = pcomm.host_reduce(torch.from_numpy(x), fx), np.asarray(jcomm.host_reduce(jnp.asarray(x), fx))
        assert got.shape == want.shape, fx
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_SCORE, atol=0)
    with pytest.raises(ValueError, match="Unsupported dist_reduce_fx"):
        pcomm.host_reduce(torch.from_numpy(x), "median")
    assert pcomm.world_size() == 1 and pcomm.process_index() == 0 and not pcomm.distributed_available()


def test_world_of_one_syncs_and_copies_share_the_process_group():
    """In a one-rank gloo world, ``compute()`` gathers over the group (None
    states stack to one row) and gives the serial answer. A process group is
    a handle to this process's communicator: ``clone`` and ``deepcopy`` keep
    the same handle and ``dist_sync_fn``; ``pickle`` leaves the handle out
    and warns when the metric is loaded."""
    _, mt = _packages()
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0, timeout=timedelta(seconds=30)
    )
    try:
        group = dist.new_group([0])
        data = _batches()
        pearson = mt.PearsonCorrCoef(process_group=group, device="cpu")
        serial = mt.PearsonCorrCoef(device="cpu")
        serial._distributed_available_fn = lambda: False
        for b in data[:3]:
            pearson.update(torch.from_numpy(b["x"]), torch.from_numpy(b["y"]))
            serial.update(torch.from_numpy(b["x"]), torch.from_numpy(b["y"]))
        with pearson.sync_context():
            assert pearson.mean_x.shape == (1, 1)  # stacked over the world of one
        np.testing.assert_allclose(pearson.compute().numpy(), serial.compute().numpy(), rtol=RTOL_SCORE, atol=0)
        assert pearson.mean_x.shape == ()  # unsynced again

        gather = _peer_gather(mt, [])
        m = mt.Accuracy(num_classes=C, process_group=group, dist_sync_fn=gather, device="cpu")
        for twin in (m.clone(), copy.deepcopy(m)):
            assert twin.process_group is group and twin.dist_sync_fn is gather
        with pytest.warns(UserWarning, match="process_group=None"):
            loaded = pickle.loads(pickle.dumps(pearson))
        assert loaded.process_group is None and pearson.process_group is group
    finally:
        dist.destroy_process_group()


def test_all_empty_gather_gives_the_declared_placeholder_on_gloo(tmp_path):
    """On a gloo world of two where no rank holds a row, a list state with
    ``placeholder=`` syncs to its declared int64 ``[0, 5]`` (as ``compute``,
    as ``sync_state`` and as the raw gather); without one it stays an empty
    list; one holder beside an empty rank gives the holder's rows."""
    results = _run_world(2, tmp_path, mode="placeholder")
    rows = torch.arange(3 * PLACEHOLDER_WIDTH, dtype=torch.int64).reshape(3, PLACEHOLDER_WIDTH)
    for rank, res in enumerate(results):
        for key in ("empty", "empty_pure"):
            assert res[key].dtype == torch.int64 and tuple(res[key].shape) == (0, PLACEHOLDER_WIDTH), (rank, key)
        assert [tuple(g.shape) for g in res["gather"]] == [(0, PLACEHOLDER_WIDTH)] * 2
        assert res["empty_undeclared"] == []
        assert torch.equal(res["one_holder"], rows), rank


def test_two_gloo_ranks_of_map_keep_image_boundaries(tmp_path):
    """``MeanAveragePrecision`` on a gloo world of two (7 and 4 images, some
    without detections or ground truth): each per-image state travels as
    rows and per-image lengths, so both ranks' ``compute()`` and pure
    ``sync_state`` equal serial JAX over the 11 images bit for bit."""
    import jax.numpy as jnp

    import metrics_tpu as mj

    results = _run_world(2, tmp_path, mode="detection")
    preds, targets = _detection_images()
    ref = mj.MeanAveragePrecision(class_metrics=True)
    ref.update(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in preds],
        [{k: jnp.asarray(v) for k, v in t.items()} for t in targets],
    )
    want = {k: np.asarray(v) for k, v in ref.compute().items()}
    for rank, res in enumerate(results):
        for key in ("map", "pure"):
            got = res[key]
            assert list(got) == list(want), (rank, key)
            for k, w in want.items():
                np.testing.assert_array_equal(got[k].numpy().reshape(w.shape), w, err_msg=f"rank {rank} {key} {k}")
        assert res["local_images"] == DETECTION_SPLIT[rank]


def test_add_state_takes_the_jax_keywords():
    """``placeholder=`` as a dtype (1-d samples), a numpy dtype or a shaped
    tensor or array (its row shape); the JAX package's errors for anything
    else and for an array default; ``sync_precision`` registers its codec
    tag in both packages (and survives a deep copy), and ``sharding=`` its
    annotation."""
    mj, mt = _packages()
    m = _reductions_metric(mt)(device="cpu")
    cases = {
        "a": (torch.int32, ((0,), torch.int32)),
        "b": (np.float64, ((0,), torch.float64)),
        "c": (torch.zeros((7, 4), dtype=torch.int64), ((0, 4), torch.int64)),
        "d": (np.zeros((1, 2, 3), np.float32), ((0, 2, 3), torch.float32)),
    }
    for name, (spec, want) in cases.items():
        m.add_state(name, default=[], dist_reduce_fx="cat", placeholder=spec, sync_precision="exact", sharding=None)
        assert m._list_placeholders[name] == want
        got = m.cat_state(name)
        assert tuple(got.shape) == want[0] and got.dtype == want[1]
    for pkg, kw in ((mj, {}), (mt, {"device": "cpu"})):
        other = _reductions_metric(pkg)(**kw)
        with pytest.raises(ValueError, match="must be a dtype or a shaped spec/array, got 'rows'"):
            other.add_state("bad", default=[], placeholder="rows")
        with pytest.raises(ValueError, match="LIST state"):
            other.add_state("bad", default=np.zeros(2), placeholder=np.int64)
        with pytest.raises(ValueError, match="must be one of"):
            other.add_state("bad", default=np.zeros(2), sync_precision="fp8")
    # the wire codecs are ported: a quantized tag registers, as in the JAX package
    for pkg, metric in ((mj, _reductions_metric(mj)()), (mt, m)):
        metric.add_state("q", default=np.zeros(2), sync_precision="bf16")
        metric.add_state("q8", default=np.zeros(2), dist_reduce_fx="sum", sync_precision="int8")
        assert metric._sync_precisions["q"] == "bf16" and metric._sync_precisions["q8"] == "int8", pkg.__name__
    assert copy.deepcopy(m)._sync_precisions["q8"] == "int8"
    # sharded states are ported: the annotation registers as in the JAX package
    m.add_state("s", default=np.zeros(2), sharding="mp")
    assert m._state_shardings["s"] == ("mp",) and m.state_spec()["s"].sharding == ("mp",)
    undeclared = _reductions_metric(mt)(device="cpu")
    with pytest.raises(ValueError, match="No samples"):
        undeclared.cat_state("rows")


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], *sys.argv[5:6])
