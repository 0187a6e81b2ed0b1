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
from metrics_tpu.ops.select_topk import _topk_mask, _topk_mask_xla
from metrics_tpu_torch import kernel_stats, reset_kernel_stats
from metrics_tpu_torch.ops.confusion_counts import confusion_counts, multilabel_counts
from metrics_tpu_torch.ops.select_topk import select_topk_mask
from metrics_tpu_torch.utils.data import select_topk


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
        ((torch.zeros(4, 8, dtype=torch.float64), 2), "float64"),
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
    stats = kernel_stats()
    assert {name: rec["launches"] for name, rec in stats.items()} == {
        "confusion_counts": 0,
        "multilabel_counts": 0,
        "select_topk": 0,
    }
    assert all(rec["plain_calls"] == 1 for rec in stats.values())
