"""The port's kernel ops (``metrics_tpu_torch/ops``) against the JAX package's
Pallas kernels, run in interpret mode on the CPU as ``tests/ops/`` runs them.

On CPU tensors the port runs each op's plain PyTorch version; its CUDA
kernel is held against that plain version on the card by ``chip_smoke.py``.
Counts must match bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.ops.confusion_counts import (
    _confusion_counts_pallas,
    _confusion_counts_xla,
    _multilabel_counts_pallas,
)
from metrics_tpu.ops.binned_counts import (
    _binned_calibration_pallas,
    _binned_calibration_xla,
    _binned_counts_pallas,
    _binned_counts_xla,
)
from metrics_tpu.ops.select_topk import _topk_mask, _topk_mask_xla
from metrics_tpu_torch import kernel_stats, reset_kernel_stats
from metrics_tpu_torch.ops.binned_counts import _calibration_route, binned_calibration_counts, binned_stat_counts
from metrics_tpu_torch.ops.confusion_counts import (
    _confusion_route,
    _index_dtype,
    _multilabel_route,
    confusion_counts,
    multilabel_counts,
)
from metrics_tpu_torch.ops.select_topk import _topk_route, select_topk_mask
from metrics_tpu_torch.utils.data import _linspace, select_topk


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _assert_same_counts(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.int64 and want.dtype.kind == "i"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,c", [(64, 3), (512, 7), (1000, 10), (513, 130)])
def test_confusion_counts_match_pallas(n, c):
    rng = np.random.default_rng(0)
    preds, target = rng.integers(0, c, n), rng.integers(0, c, n)
    got = confusion_counts(_t(preds), _t(target), num_classes=c)
    _assert_same_counts(got, _confusion_counts_pallas(jnp.asarray(preds), jnp.asarray(target), num_classes=c, interpret=True))
    assert int(got.sum()) == n


def test_confusion_counts_drop_out_of_range_like_the_kernel():
    """Indices outside [0, C) are dropped, as the Pallas kernel drops them;
    the JAX package's XLA composition folds them into other cells instead."""
    preds = np.array([0, 1, -1, 2, 5, 1])
    target = np.array([0, -1, 1, 2, 1, 7])
    got = confusion_counts(_t(preds), _t(target), num_classes=3)
    pallas = _confusion_counts_pallas(jnp.asarray(preds), jnp.asarray(target), num_classes=3, interpret=True)
    _assert_same_counts(got, pallas)
    assert int(got.sum()) == 2
    assert not np.array_equal(got.numpy(), np.asarray(_confusion_counts_xla(jnp.asarray(preds), jnp.asarray(target), 3)))


def _cityscapes_like(rng: np.random.Generator, n: int, c: int = 20):
    """Segmentation-shaped labels: one class per run of 32 pixels, class 0
    (the road) on a third of the runs, the rest uniform; predictions equal
    to them but for 8% of the pixels."""
    runs = (n + 31) // 32
    cls = np.where(rng.random(runs) < 1 / 3, 0, rng.integers(0, c, runs))
    target = np.repeat(cls, 32)[:n]
    preds = np.where(rng.random(n) < 0.08, rng.integers(0, c, n), target)
    return preds, target


def test_confusion_counts_of_segmentation_runs_match_the_composition():
    """The shape the shared-memory route was built for (C = 20, a third of
    the pixels on one class, in runs): in-range inputs give the bincount
    composition's counts."""
    preds, target = _cityscapes_like(np.random.default_rng(10), 65_536)
    got = confusion_counts(_t(preds), _t(target), num_classes=20)
    _assert_same_counts(got, _confusion_counts_xla(jnp.asarray(preds), jnp.asarray(target), 20))
    assert int(got[0, 0]) > 65_536 // 4  # the hot cell holds over a quarter of the pixels


@pytest.mark.parametrize("n,c", [(4096, 20), (4093, 20), (4096, 241), (4096, 242)])
def test_confusion_counts_of_segmentation_runs_match_pallas(n, c):
    """Both sides of the shared route's limit (C = 241 fits, 242 does not), and a ragged N."""
    preds, target = _cityscapes_like(np.random.default_rng(c + n), n, c)
    got = confusion_counts(_t(preds), _t(target), num_classes=c)
    _assert_same_counts(got, _confusion_counts_pallas(jnp.asarray(preds), jnp.asarray(target), num_classes=c, interpret=True))
    assert int(got.sum()) == n


@pytest.mark.parametrize("c", [1, 20, 241, 242, 1000])
def test_confusion_counts_take_int32_and_int64_alike(c):
    rng = np.random.default_rng(c)
    preds, target = rng.integers(-2, c + 2, 3000), rng.integers(-2, c + 2, 3000)
    got32 = confusion_counts(_t(preds).int(), _t(target).int(), num_classes=c)
    got64 = confusion_counts(_t(preds), _t(target), num_classes=c)
    assert got32.dtype == got64.dtype == torch.int64
    torch.testing.assert_close(got32, got64, rtol=0, atol=0)
    _assert_same_counts(got64, _confusion_counts_pallas(jnp.asarray(preds), jnp.asarray(target), num_classes=c, interpret=True))


@pytest.mark.parametrize(
    "c,want",
    [
        (1, ("shared", 16)),  # one histogram per warp
        (20, ("shared", 16)),  # Cityscapes: 16 copies of 1.6 KB
        (85, ("shared", 4)),  # 4 copies of 28,900 bytes fit half of 227 KB
        (86, ("shared", 2)),
        (170, ("shared", 1)),  # one copy over half of 227 KB: one block per SM
        (241, ("shared", 1)),  # the limit: 241^2 * 4 = 232,324 <= 232,448
        (242, ("global", 0)),  # 242^2 * 4 = 234,256: one global atomic per sample
        (1000, ("global", 0)),  # ImageNet
    ],
)
def test_confusion_route_picks_shared_histograms_up_to_241_classes(c, want):
    assert _confusion_route(c) == want


@pytest.mark.parametrize(
    "preds,target,want",
    [
        (torch.int32, torch.int32, torch.int32),
        (torch.int64, torch.int64, torch.int64),
        (torch.int32, torch.int64, torch.int64),
        (torch.uint8, torch.uint8, torch.int64),
        (torch.int16, torch.int32, torch.int64),
    ],
)
def test_confusion_kernel_reads_int32_and_int64_as_given(preds, target, want):
    assert _index_dtype(torch.zeros(2, dtype=preds), torch.zeros(2, dtype=target)) == want


@pytest.mark.parametrize("n,c", [(64, 4), (256, 16), (300, 130)])
def test_multilabel_counts_match_pallas(n, c):
    rng = np.random.default_rng(2)
    preds, target = rng.integers(0, 2, (n, c)), rng.integers(0, 2, (n, c))
    got = multilabel_counts(_t(preds).int(), _t(target).int())
    assert got.shape == (c, 2, 2)
    _assert_same_counts(got, _multilabel_counts_pallas(jnp.asarray(preds), jnp.asarray(target), interpret=True))
    np.testing.assert_array_equal(got.sum(dim=(1, 2)).numpy(), np.full(c, n))


def _pallas_mask(x: np.ndarray, k: int) -> np.ndarray:
    return np.asarray(_topk_mask(jnp.asarray(x), k, interpret=True))


@pytest.mark.parametrize("shape", [(8, 16), (77, 130), (513, 129)])
@pytest.mark.parametrize("k", [2, 5])
def test_topk_mask_matches_pallas(shape, k):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    x = rng.random(shape).astype(np.float32)
    got = select_topk_mask(_t(x), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _pallas_mask(x, k))
    assert got.sum(dim=1).tolist() == [k] * shape[0]


_INF, _NAN = np.inf, np.nan
_EDGE_ROWS = np.array(
    [
        [0.5, 0.9, 0.5, 0.5, 0.1, 0.5],  # ties straddling the k boundary
        [1.0, 1.0, 1.0, 1.0, 1.0, 1.0],  # a run of ties
        [0.1, _NAN, 0.3, _NAN, _INF, 0.2],  # NaN ranks above +inf
        [_NAN] * 6,
        [-1.0, -_INF, -0.5, -2.0, _INF, 0.0],
        [0.5, -_INF, -_INF, -_INF, -_INF, -_INF],  # fewer than k finite values
        [-_INF] * 6,
        [-0.0, 0.0, -0.0, 0.0, -1.0, -0.0],  # signed zeros tie
    ],
    dtype=np.float32,
)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_topk_mask_edge_rows_match_pallas(k):
    got = select_topk_mask(_t(_EDGE_ROWS), k)
    np.testing.assert_array_equal(got.numpy(), _pallas_mask(_EDGE_ROWS, k))
    assert got.sum(dim=1).tolist() == [k] * len(_EDGE_ROWS)


def test_topk_mask_signed_zero_follows_the_pallas_kernel():
    """-0.0 and 0.0 tie and the tie goes to the lower index, as in the Pallas
    body; the XLA composition (``lax.top_k``) orders 0.0 above -0.0."""
    row = np.array([[5.0, -0.0, 0.0, -1.0]], np.float32)
    got = select_topk_mask(_t(row), 2).numpy()
    np.testing.assert_array_equal(got, [[1, 1, 0, 0]])
    np.testing.assert_array_equal(got, _pallas_mask(row, 2))
    np.testing.assert_array_equal(np.asarray(_topk_mask_xla(jnp.asarray(row), 2)), [[1, 0, 1, 0]])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_topk_mask_half_inputs_are_widened(dtype):
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((33, 40)).astype(np.float32)).to(dtype)
    want = _pallas_mask(x.float().numpy(), 4)
    np.testing.assert_array_equal(select_topk_mask(x, 4).numpy(), want)


def test_select_topk_k1_is_argmax_and_matches_jax():
    from metrics_tpu.utils.data import select_topk as jax_select_topk

    x = _EDGE_ROWS[:, :5].copy()
    np.testing.assert_array_equal(select_topk(_t(x), 1).numpy(), np.asarray(jax_select_topk(jnp.asarray(x), 1)))


@pytest.mark.parametrize(
    "args,reason",
    [
        ((torch.zeros(4, 8), 1), "argmax path"),
        ((torch.zeros(4, 8), 9), "must be in"),
        ((torch.zeros(4, 8, dtype=torch.int32), 2), "float32, float64"),
        ((torch.zeros(4, 8, 2), 2), "2-D"),
    ],
)
def test_topk_mask_rejects_what_the_kernel_does_not_take(args, reason):
    with pytest.raises(ValueError, match=reason):
        select_topk_mask(*args)


def test_count_ops_reject_float_and_mismatched_inputs():
    with pytest.raises(ValueError, match="integer"):
        confusion_counts(torch.zeros(4), torch.zeros(4, dtype=torch.int64), num_classes=3)
    with pytest.raises(ValueError, match="one length"):
        confusion_counts(torch.zeros(4, dtype=torch.int64), torch.zeros(5, dtype=torch.int64), num_classes=3)
    with pytest.raises(ValueError, match="one shape"):
        multilabel_counts(torch.zeros(4, 3, dtype=torch.int32), torch.zeros(4, 2, dtype=torch.int32))


def test_cpu_tensors_run_the_plain_versions_and_launch_nothing():
    reset_kernel_stats()
    confusion_counts(torch.tensor([0, 1]), torch.tensor([1, 1]), num_classes=2)
    multilabel_counts(torch.ones(3, 2, dtype=torch.int32), torch.ones(3, 2, dtype=torch.int32))
    select_topk_mask(torch.rand(3, 4), 2)
    binned_stat_counts(torch.rand(3, 2), torch.ones(3, 2, dtype=torch.int32), torch.rand(4))
    binned_calibration_counts(torch.rand(3), torch.ones(3), torch.linspace(0, 1, 4))
    stats = kernel_stats()
    assert {name: rec["launches"] for name, rec in stats.items()} == {
        "binned_calibration": 0,
        "binned_counts": 0,
        "confusion_counts": 0,
        "multilabel_counts": 0,
        "select_topk": 0,
    }
    assert all(rec["plain_calls"] == 1 for rec in stats.values())


@pytest.mark.parametrize("shape", [(8, 16), (77, 130)])
@pytest.mark.parametrize("k", [2, 5])
def test_topk_mask_float64_is_ranked_as_float64(shape, k):
    """float64 scores keep their full width: values that narrowing to float32
    would tie are ranked apart, as ``lax.top_k`` ranks them in the JAX package."""
    rng = np.random.default_rng(shape[0] + k)
    x = rng.integers(0, 3, shape).astype(np.float64) + rng.random(shape) * 1e-12
    got = select_topk_mask(_t(x), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_topk_mask_xla(jnp.asarray(x), k)))
    assert not np.array_equal(got.numpy(), _pallas_mask(x.astype(np.float32), k))


def test_topk_mask_float64_signed_zero_keeps_the_tie_rule():
    """On float64 rows the port keeps its one tie rule (-0.0 ties 0.0, the lower
    index wins); ``lax.top_k``, which the JAX package runs on float64, orders
    0.0 above -0.0."""
    row = np.array([[5.0, -0.0, 0.0, -1.0]], np.float64)
    np.testing.assert_array_equal(select_topk_mask(_t(row), 2).numpy(), [[1, 1, 0, 0]])
    np.testing.assert_array_equal(np.asarray(_topk_mask_xla(jnp.asarray(row), 2)), [[1, 0, 1, 0]])


def test_accuracy_top_k_takes_float64_scores_like_jax():
    import metrics_tpu as mj
    import metrics_tpu_torch as mt

    rng = np.random.default_rng(8)
    preds, target = rng.standard_normal((24, 10)), rng.integers(0, 10, 24)
    assert preds.dtype == np.float64
    got = mt.Accuracy(num_classes=10, top_k=3, device="cpu")(_t(preds), _t(target))
    want = mj.Accuracy(num_classes=10, top_k=3)(jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _assert_four_counts(got, want) -> None:
    for g, w, name in zip(got, want, ("tp", "fp", "fn", "tn")):
        assert g.dtype == torch.int64, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("n,c,t", [(64, 3, 10), (1000, 10, 100), (1025, 1, 7)])
def test_binned_counts_match_the_composition_and_the_pallas_body(n, c, t):
    rng = np.random.default_rng(n + c)
    preds = rng.random((n, c)).astype(np.float32)
    target = (rng.random((n, c)) > 0.7).astype(np.int32)
    ths = np.linspace(0, 1, t).astype(np.float32)
    got = binned_stat_counts(_t(preds), _t(target), _t(ths))
    _assert_four_counts(got, _binned_counts_xla(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(ths)))
    _assert_four_counts(got, _binned_counts_pallas(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(ths), interpret=True))


def test_binned_counts_edge_inputs_match_the_composition():
    """NaN preds are below every threshold; thresholds may come unsorted, repeat,
    or be infinite or NaN; positive means target > 0; half and float64 preds."""
    rng = np.random.default_rng(3)
    grid = np.linspace(0, 1, 11).astype(np.float32)
    preds = grid[rng.integers(0, 11, (200, 4))]  # preds exactly on thresholds
    preds[rng.random((200, 4)) < 0.1] = np.nan
    target = rng.integers(-1, 3, (200, 4))
    ths = np.concatenate([grid[::-1], grid[:3], [np.inf, -np.inf, np.nan]]).astype(np.float32)
    for p in (preds, preds.astype(np.float16), preds.astype(np.float64) + 1e-12):
        want = _binned_counts_xla(jnp.asarray(p), jnp.asarray(target), jnp.asarray(ths))
        _assert_four_counts(binned_stat_counts(_t(p), _t(target), _t(ths)), want)
    bf16 = torch.from_numpy(preds).bfloat16()
    want = _binned_counts_xla(jnp.asarray(bf16.float().numpy()), jnp.asarray(target), jnp.asarray(ths))
    _assert_four_counts(binned_stat_counts(bf16, _t(target), _t(ths)), want)


def test_binned_counts_float64_preds_follow_the_composition_not_the_pallas_body():
    """A float64 pred of 0.1 + 1e-12 is below the float32 threshold 0.1
    (0.10000000149...) when compared in float64, as the XLA composition
    compares; the Pallas body narrows the pred to float32 first and counts it
    above."""
    preds = np.array([[0.1 + 1e-12], [0.5]])
    target = np.array([[1], [0]], np.int32)
    ths = np.array([0.1, 0.3], np.float32)
    got = binned_stat_counts(_t(preds), _t(target), _t(ths))
    _assert_four_counts(got, _binned_counts_xla(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(ths)))
    assert got[0].tolist() == [[0, 0]]
    pallas_tp = np.asarray(_binned_counts_pallas(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(ths), interpret=True)[0])
    assert pallas_tp.tolist() == [[1, 0]]


def _assert_calibration(got, want) -> None:
    assert got[0].dtype == torch.int64
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # counts exact
    for g, w, name in zip(got[1:], want[1:], ("conf_sum", "acc_sum")):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=0, err_msg=name)


@pytest.mark.parametrize("n,bins", [(64, 5), (1000, 15), (4097, 10), (300, 5000)])
def test_binned_calibration_matches_the_composition_and_the_pallas_body(n, bins):
    """Inside (b[0], b[-1]] the two JAX paths agree, and the port with both;
    a confidence of exactly b[0] falls in no bin."""
    rng = np.random.default_rng(n)
    conf = rng.random(n).astype(np.float32)
    conf[: max(1, n // 50)] = 0.0
    acc = (rng.random(n) > 0.4).astype(np.float32)
    bounds = np.asarray(jnp.linspace(0, 1, bins + 1, dtype=jnp.float32))
    got = binned_calibration_counts(_t(conf), _t(acc), _t(bounds))
    _assert_calibration(got, _binned_calibration_xla(jnp.asarray(conf), jnp.asarray(acc), jnp.asarray(bounds)))
    if bins <= 4096:  # the Pallas body's cap
        _assert_calibration(got, _binned_calibration_pallas(jnp.asarray(conf), jnp.asarray(acc), jnp.asarray(bounds), interpret=True))


def test_binned_calibration_nan_and_above_range_follow_the_composition_not_the_pallas_body():
    """A confidence above b[-1] or NaN lands in the last bin, as in the XLA
    composition (its clip), where a NaN spoils only that bin's sum. The Pallas
    body drops both, and one NaN turns every bin's conf_sum NaN (0 * NaN)."""
    conf = np.array([0.5, 1.5, np.nan, 0.0, 0.2, -1.0], np.float32)
    acc = np.array([1, 0, 1, 1, 0, 1], np.float32)
    bounds = np.asarray(jnp.linspace(0, 1, 4, dtype=jnp.float32))
    count, conf_sum, acc_sum = binned_calibration_counts(_t(conf), _t(acc), _t(bounds))
    want = _binned_calibration_xla(jnp.asarray(conf), jnp.asarray(acc), jnp.asarray(bounds))
    assert count.tolist() == [1, 1, 2] == np.asarray(want[0]).tolist()
    np.testing.assert_allclose(conf_sum.numpy(), np.asarray(want[1]), rtol=1e-5)  # equal NaN in the last bin
    assert np.isnan(conf_sum[2].item()) and not np.isnan(conf_sum[:2].numpy()).any()
    np.testing.assert_allclose(acc_sum.numpy(), np.asarray(want[2]), rtol=1e-5)
    pallas = _binned_calibration_pallas(jnp.asarray(conf), jnp.asarray(acc), jnp.asarray(bounds), interpret=True)
    assert np.asarray(pallas[0]).tolist() == [1, 1, 0]
    assert np.isnan(np.asarray(pallas[1])).all()


def test_linspace_matches_jnp_linspace_bit_for_bit():
    """Thresholds and bin boundaries sit on the JAX package's values
    (``torch.linspace`` differs in the last bit for some of them)."""
    for num in (2, 5, 11, 16, 200, 5001):
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
            np.testing.assert_array_equal(_linspace(0.0, 1.0, num, dtype=tdt).numpy(), np.asarray(jnp.linspace(0, 1, num, dtype=jdt)))


@pytest.mark.parametrize(
    "op,args,reason",
    [
        (binned_stat_counts, (torch.rand(4, 2), torch.ones(4, 3), torch.rand(3)), "one shape"),
        (binned_stat_counts, (torch.rand(4, 2), torch.ones(4, 2), torch.rand(0)), "not empty"),
        (binned_stat_counts, (torch.ones(4, 2, dtype=torch.int32), torch.ones(4, 2), torch.rand(3)), "floating point"),
        (binned_calibration_counts, (torch.rand(4), torch.ones(5), torch.linspace(0, 1, 3)), "one length"),
        (binned_calibration_counts, (torch.rand(4), torch.ones(4), torch.zeros(1)), "at least 2"),
        (binned_calibration_counts, (torch.ones(4, dtype=torch.int64), torch.ones(4), torch.linspace(0, 1, 3)), "floating point"),
    ],
)
def test_binned_ops_reject_what_they_do_not_take(op, args, reason):
    with pytest.raises(ValueError, match=reason):
        op(*args)


def _sorted_threshold_counts(preds: torch.Tensor, target: torch.Tensor, thresholds: torch.Tensor):
    """The CUDA ``binned_counts`` kernel's formulation, in torch on the CPU:
    rank the thresholds (slot = #less + #equal before, NaN after every
    number; lb = #less, T for NaN), histogram each pred's bin u = #{s <= p}
    per class, split into positives and negatives, and read each count off
    the suffix sums at lb + 1."""
    dtype = torch.float64 if torch.float64 in (preds.dtype, thresholds.dtype) else torch.float32
    p, th = preds.to(dtype), thresholds.to(dtype)
    n, c = p.shape
    t = th.numel()
    nan_th = torch.isnan(th)
    # less[j, i]: th[j] orders before th[i] (NaN after every number, never less)
    less = ~nan_th[:, None] & (nan_th[None, :] | (th[:, None] < th[None, :]))
    ties = ~less & ~less.T & torch.tril(torch.ones(t, t, dtype=torch.bool), diagonal=-1)
    below = less.sum(0)
    slot = below + ties.sum(0)
    assert sorted(slot.tolist()) == list(range(t))  # a permutation
    s = torch.empty_like(th)
    s[slot] = th
    lb = torch.where(nan_th, t, below)
    if not nan_th.any() and (th[1:] > th[:-1]).all():  # the kernel's fast path for a strictly ascending grid
        assert torch.equal(s, th) and torch.equal(lb, torch.arange(t))
    u = (s[None, None, :] <= p[:, :, None]).sum(-1)  # NaN s or NaN p: never <=, so a NaN pred is bin 0
    key = torch.arange(c)[None, :] * (t + 1) + u
    positive = target > 0
    pos = torch.zeros(c * (t + 1), dtype=torch.int64).index_add_(0, key[positive], torch.ones_like(key[positive]))
    neg = torch.zeros(c * (t + 1), dtype=torch.int64).index_add_(0, key[~positive], torch.ones_like(key[~positive]))

    def suffix(h):
        h = h.view(c, t + 1)
        return torch.cat([h.flip(1).cumsum(1).flip(1), torch.zeros(c, 1, dtype=torch.int64)], dim=1)

    sp, sn = suffix(pos), suffix(neg)
    tp, fp = sp[:, lb + 1], sn[:, lb + 1]
    return tp, fp, sp[:, :1] - tp, sn[:, :1] - fp


def _threshold_identity_inputs():
    rng = np.random.default_rng(11)
    grid = np.linspace(0, 1, 11).astype(np.float32)
    preds = grid[rng.integers(0, 11, (300, 5))]  # preds exactly on thresholds
    preds[rng.random((300, 5)) < 0.05] = np.nan
    preds[rng.random((300, 5)) < 0.03] = np.inf
    preds[rng.random((300, 5)) < 0.03] = -np.inf
    target = rng.integers(-1, 3, (300, 5)).astype(np.int32)
    return {
        "unsorted_repeated_nan_inf": (preds, target, np.concatenate([grid[::-1], grid[2:5], [np.inf, -np.inf, np.nan, 0.5, np.nan]]).astype(np.float32)),
        "ascending_grid": (preds, target, grid),
        "f64_preds_above_f32_thresholds": (preds.astype(np.float64) + 1e-12, target, grid),
        "t1": (preds, target, grid[4:5]),
        "t1_nan": (preds, target, np.array([np.nan], np.float32)),
        "all_preds_equal": (np.full((300, 5), 0.5, np.float32), target, grid),
        "signed_zeros": (np.where(rng.random((300, 5)) < 0.5, -0.0, 0.0).astype(np.float32), target, np.array([0.0, -0.0, 1.0, -1.0], np.float32)),
    }


@pytest.mark.parametrize("case", sorted(_threshold_identity_inputs()))
def test_sorted_threshold_histogram_gives_the_compare_counts(case):
    """The identity the kernel rests on, ``p >= th[t]`` exactly when
    ``#{s <= p} > #{th < th[t]}``, with suffix sums over a per-class
    histogram, gives the broadcast compare's counts bit for bit: against the
    port's plain version and the JAX package's XLA composition."""
    preds, target, ths = _threshold_identity_inputs()[case]
    got = _sorted_threshold_counts(_t(preds), _t(target), _t(ths))
    plain = binned_stat_counts(_t(preds), _t(target), _t(ths))
    for g, w, name in zip(got, plain, ("tp", "fp", "fn", "tn")):
        assert torch.equal(g, w), name
    _assert_four_counts(got, _binned_counts_xla(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(ths)))


@pytest.mark.parametrize(
    "dtype,c,offset,want",
    [
        (torch.float32, 1000, 0, ("registers", 32, True)),  # the ImageNet path
        (torch.float32, 1000, 4, ("registers", 32, False)),  # a view one element in: not 16-byte aligned
        (torch.float32, 998, 0, ("registers", 32, False)),  # width not a multiple of 4
        (torch.float32, 1024, 0, ("registers", 32, True)),
        (torch.float32, 1025, 0, ("shared", 0, False)),  # past the register kernel
        (torch.float32, 20_000, 0, ("shared", 0, False)),
        (torch.float32, 1, 0, ("registers", 4, False)),
        (torch.float32, 128, 0, ("registers", 4, True)),
        (torch.float32, 129, 0, ("registers", 8, False)),
        (torch.float32, 256, 16, ("registers", 8, True)),
        (torch.float32, 257, 0, ("registers", 16, False)),
        (torch.float32, 513, 0, ("registers", 32, False)),
        (torch.float64, 10, 0, ("shared_f64", 0, False)),
        (torch.float64, 1000, 0, ("shared_f64", 0, False)),
    ],
)
def test_topk_route_picks_the_kernel_by_width_alignment_and_dtype(dtype, c, offset, want):
    assert _topk_route(dtype, c, 1 << 20 | offset) == want


def test_topk_route_sees_the_alignment_of_a_view():
    base = torch.zeros(301 * 1000)
    aligned = base[: 300 * 1000].view(300, 1000)
    shifted = base[1 : 1 + 300 * 1000].view(300, 1000)
    assert aligned.data_ptr() % 16 == 0
    assert _topk_route(torch.float32, 1000, aligned.data_ptr())[2]
    assert not _topk_route(torch.float32, 1000, shifted.data_ptr())[2]


@pytest.mark.parametrize(
    "n,bins,offset,want",
    [
        (8192, 15, 0, ("cluster", 16, True)),  # the ImageNet calibration path
        (8192, 1, 0, ("cluster", 16, True)),
        (8192, 16, 0, ("cluster", 16, True)),
        (8192, 17, 0, ("cluster", 32, True)),
        (8192, 32, 0, ("cluster", 32, True)),
        (8192, 33, 0, ("cluster", 64, True)),
        (8192, 64, 0, ("cluster", 64, True)),
        (8192, 65, 0, ("atomics", 0, False)),  # past the largest instance
        (8192, 5000, 0, ("atomics", 0, False)),
        (8192, 15, 4, ("cluster", 16, False)),  # a view one element in: 4-byte loads
        (0, 15, 0, ("cluster", 16, True)),
        (32_768, 15, 0, ("cluster", 16, True)),  # a batch of 8 for each thread of 16 blocks
        (32_769, 15, 0, ("grid", 16, True)),
        (50_000, 15, 0, ("grid", 16, True)),  # the buffered compute
        (4_194_304, 64, 0, ("grid", 64, True)),
        (1 << 31, 15, 0, ("atomics", 0, False)),  # the private kernel counts in 32 bits
    ],
)
def test_calibration_route_picks_the_instance_by_bins_and_the_route_by_size(n, bins, offset, want):
    assert _calibration_route(n, bins, 1 << 20 | offset, 1 << 21) == want


def test_calibration_route_sees_the_alignment_of_both_inputs():
    base = torch.zeros(8200)
    assert _calibration_route(8192, 15, base.data_ptr(), base.data_ptr())[2]
    assert not _calibration_route(8192, 15, base[1:].data_ptr(), base.data_ptr())[2]
    assert not _calibration_route(8192, 15, base.data_ptr(), base[1:].data_ptr())[2]


def test_binned_calibration_plain_sums_in_float64_and_rounds_once():
    """One bin of 200,000 equal confidences: a float32 running sum drifts
    by about 2e-4 relative; the plain version, which the kernel is held to
    on the card, gives the float64 sum rounded to float32."""
    n = 200_000
    conf = np.full(n, 0.999, np.float32)
    acc = np.ones(n, np.float32)
    bounds = np.asarray(jnp.linspace(0, 1, 16, dtype=jnp.float32))
    count, conf_sum, acc_sum = binned_calibration_counts(_t(conf), _t(acc), _t(bounds))
    assert count.tolist() == [0] * 14 + [n]
    assert conf_sum[14].item() == np.float32(conf.astype(np.float64).sum())
    assert acc_sum[14].item() == float(n)
    drift = abs(float(np.cumsum(conf, dtype=np.float32)[-1]) - conf.astype(np.float64).sum()) / conf.astype(np.float64).sum()
    assert drift > 1e-5  # what the float64 sums avoid


@pytest.mark.parametrize(
    "c,offsets,want",
    [
        (80, (0, 0), (4, True)),  # the COCO path: 4 lanes of 4 columns, a 16-column tile
        (80, (4, 0), (16, False)),  # preds one element in: 4-byte loads
        (80, (0, 4), (16, False)),
        (81, (0, 0), (16, False)),  # not a multiple of 4
        (1, (0, 0), (1, False)),
        (3, (0, 0), (4, False)),
        (4, (0, 0), (1, True)),
        (8, (0, 0), (2, True)),
        (1000, (0, 0), (4, True)),
        (1000, (8, 8), (16, False)),
    ],
)
def test_multilabel_route_picks_lanes_and_load_width(c, offsets, want):
    assert _multilabel_route(c, 1 << 20 | offsets[0], 1 << 21 | offsets[1]) == want


def test_multilabel_route_sees_the_alignment_of_a_view():
    base = torch.zeros(301 * 80, dtype=torch.int32)
    aligned, shifted = base[: 300 * 80].view(300, 80), base[1 : 1 + 300 * 80].view(300, 80)
    assert _multilabel_route(80, aligned.data_ptr(), aligned.data_ptr())[1]
    assert not _multilabel_route(80, shifted.data_ptr(), aligned.data_ptr())[1]


def test_multilabel_counts_of_any_int32_values_are_exact_int64_sums():
    """Values outside 0/1, up to int32's extremes: every product of two of
    them, and sums over rows, are taken in int64 (the kernel's arithmetic
    too), never wrapped in int32."""
    extremes = np.array([-(2**31), -1, 0, 1, 2, 2**31 - 1], np.int64)
    pairs = np.stack([np.repeat(extremes, 6), np.tile(extremes, 6)])  # [2, 36]: every pair once
    for preds, target in ((pairs[:1], pairs[1:]), (np.repeat(pairs[:1], 3, 0) // 4, np.repeat(pairs[1:], 3, 0) // 4)):
        got = multilabel_counts(_t(preds).int(), _t(target).int())
        n = preds.shape[0]
        tp, sp, st = (preds * target).sum(0), preds.sum(0), target.sum(0)
        want = np.stack([n - sp - st + tp, sp - tp, st - tp, tp], axis=-1).reshape(-1, 2, 2)
        np.testing.assert_array_equal(got.numpy(), want)
        assert np.abs(tp).max() > 2**31  # past what int32 holds
