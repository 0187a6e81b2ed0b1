"""The port's pairwise functionals and its ``pairwise_reduce`` op against
``metrics_tpu`` on the same numpy inputs, on the CPU (the op's plain
version; its CUDA kernel is held against that version on the card by
``chip_smoke.py``).

The JAX side runs as its users run it: ``pairwise_reduce`` is registered off
by default there, so its functionals compute the XLA composition. The Pallas
body is compared in interpret mode, as ``tests/ops/test_select_topk.py``
runs it.

Tolerances, relative to the largest magnitude of the result (cosine row
sums sit near 0, where an entrywise relative error means nothing): float32
1e-5, float64 1e-10, bfloat16 2e-2 (the JAX kernel's own tolerance, and
about four bfloat16 ulps); the Pallas body, which multiplies in bfloat16,
2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional as fj
import metrics_tpu_torch.functional as ft
from metrics_tpu.ops.pairwise_reduce import _fused_row_sums
from metrics_tpu_torch import kernel_stats, reset_kernel_stats
from metrics_tpu_torch.ops.pairwise_reduce import pairwise_reduce, pairwise_reduce_rows

FUNCTIONALS = (
    "pairwise_euclidean_distance",
    "pairwise_cosine_similarity",
    "pairwise_linear_similarity",
    "pairwise_manhattan_distance",
)
REDUCTIONS = (None, "sum", "mean")
# (second input given, zero_diagonal): x against itself with the default
# (True), then a non-square pair with the default (False) and with each value
CASES = {"self": (False, None), "pair": (True, None), "pair_zero_diag": (True, True), "pair_no_zero_diag": (True, False)}
TOL = {"float32": 1e-5, "float64": 1e-10, "bfloat16": 2e-2}


def _inputs(n: int = 13, m: int = 9, d: int = 7, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32), rng.standard_normal((m, d)).astype(np.float32)


def _call_both(name: str, x: np.ndarray, y, dtype: str = "float32", **kwargs):
    jax_out = getattr(fj, name)(jnp.asarray(x, dtype=dtype), None if y is None else jnp.asarray(y, dtype=dtype), **kwargs)
    tdt = getattr(torch, dtype)
    port_out = getattr(ft, name)(torch.from_numpy(x).to(tdt), None if y is None else torch.from_numpy(y).to(tdt), **kwargs)
    return port_out, jax_out


def _assert_close(got: torch.Tensor, want, rtol: float) -> None:
    """Values within ``rtol`` of the largest |want|, NaN in the same places,
    and the same dtype."""
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    g = got.double().numpy()
    w = np.asarray(want.astype(jnp.float64))
    assert g.shape == w.shape
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    finite = ~np.isnan(w)
    scale = np.abs(w[finite]).max() if finite.any() else 1.0
    np.testing.assert_allclose(g[finite], w[finite], rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_functionals_match_jax(name, reduction, case):
    x, y = _inputs()
    with_y, zero_diagonal = CASES[case]
    got, want = _call_both(name, x, y if with_y else None, reduction=reduction, zero_diagonal=zero_diagonal)
    _assert_close(got, want, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_functionals_keep_the_input_dtype_like_jax(name, reduction, dtype):
    x, y = _inputs(seed=1)
    got, want = _call_both(name, x, y, dtype=dtype, reduction=reduction)
    _assert_close(got, want, TOL[dtype])


def _pallas_cases():
    """The padded ``[70, 24]`` x ``[33, 24]`` cases of ``tests/ops/test_select_topk.py``."""
    rng = np.random.RandomState(3)
    x = rng.rand(70, 24).astype(np.float32)
    y = rng.rand(33, 24).astype(np.float32)
    unit = lambda a: a / np.linalg.norm(a, axis=1, keepdims=True)  # noqa: E731
    return {
        "euclidean": (x, y, "euclidean", False),
        "euclidean_self_zero_diag": (x, x, "euclidean", True),
        "cosine": (unit(x), unit(y), "cosine", False),
        "cosine_self_zero_diag": (unit(x), unit(x), "cosine", True),
        "euclidean_pair_zero_diag": (x, y, "euclidean", True),
    }


@pytest.mark.parametrize("case", list(_pallas_cases()))
def test_plain_op_matches_the_pallas_body(case):
    x, y, op, zero_diagonal = _pallas_cases()[case]
    want = np.asarray(_fused_row_sums(jnp.asarray(x), jnp.asarray(y), op=op, zero_diagonal=zero_diagonal, interpret=True))
    got = pairwise_reduce(torch.from_numpy(x), torch.from_numpy(y), op=op, zero_diagonal=zero_diagonal)
    assert got.dtype == torch.float32 and got.shape == (x.shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("name", FUNCTIONALS[:2])
def test_width_beyond_the_jax_kernel_cap(name, reduction):
    """d = 4100 is past the Pallas kernel's VMEM cap (4096); the port's op has none."""
    x, y = _inputs(n=6, m=5, d=4100, seed=2)
    got, want = _call_both(name, x, y, reduction=reduction)
    _assert_close(got, want, TOL["float32"])


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", FUNCTIONALS[:2])
def test_nan_row_spoils_its_sums_like_jax(name, reduction):
    x, y = _inputs(seed=3)
    x[4, 2] = np.nan
    y[1, 0] = np.nan
    for second in (None, y):
        got, want = _call_both(name, x, second, reduction=reduction)
        _assert_close(got, want, TOL["float32"])


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_cosine_zero_row_gives_nan_like_jax(reduction):
    x, y = _inputs(seed=4)
    x[3] = 0.0
    got, want = _call_both("pairwise_cosine_similarity", x, y, reduction=reduction)
    assert np.isnan(got.numpy()).any()
    _assert_close(got, want, TOL["float32"])


def _raised(fn, *args, **kwargs) -> str:
    with pytest.raises(ValueError) as err:
        fn(*args, **kwargs)
    return str(err.value)


@pytest.mark.parametrize(
    "case",
    [
        ("x_not_2d", np.zeros((3,), np.float32), None, {}),
        ("y_not_2d", np.zeros((3, 2), np.float32), np.zeros((3,), np.float32), {}),
        ("y_other_width", np.zeros((3, 2), np.float32), np.zeros((3, 4), np.float32), {}),
        ("bad_reduction", np.ones((3, 2), np.float32), None, {"reduction": "max"}),
    ],
    ids=lambda c: c[0],
)
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_error_texts_match_jax(name, case):
    _, x, y, kwargs = case
    want = _raised(getattr(fj, name), jnp.asarray(x), None if y is None else jnp.asarray(y), **kwargs)
    got = _raised(getattr(ft, name), torch.from_numpy(x), None if y is None else torch.from_numpy(y), **kwargs)
    assert got == want


@pytest.mark.parametrize(
    "args,kwargs,reason",
    [
        ((torch.zeros(4, 3, 2), torch.zeros(4, 3)), {}, "2-D"),
        ((torch.zeros(4, 3), torch.zeros(5, 2)), {}, "same width"),
        ((torch.zeros(4, 3), torch.zeros(5, 3)), {"op": "manhattan"}, "op must be"),
        ((torch.zeros(4, 3, dtype=torch.int64), torch.zeros(5, 3, dtype=torch.int64)), {}, "float32, float64"),
    ],
)
def test_op_rejects_what_the_kernel_does_not_take(args, kwargs, reason):
    with pytest.raises(ValueError, match=reason):
        pairwise_reduce(*args, **kwargs)


def test_op_runs_its_plain_version_on_cpu_and_mean_divides_by_m():
    x, y = (torch.from_numpy(a) for a in _inputs(n=5, m=4, d=3, seed=5))
    reset_kernel_stats()
    sums = pairwise_reduce_rows(x, y, "euclidean", "sum", zero_diagonal=True)
    means = pairwise_reduce_rows(x, y, "euclidean", "mean", zero_diagonal=True)
    assert kernel_stats() == {"pairwise_reduce": {"launches": 0, "plain_calls": 2}}
    torch.testing.assert_close(means, sums / 4, rtol=0, atol=0)
    matrix = torch.cdist(x.double(), y.double())
    matrix.diagonal().zero_()
    torch.testing.assert_close(sums.double(), matrix.sum(1), rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="'sum' or 'mean'"):
        pairwise_reduce_rows(x, y, "euclidean", "none", zero_diagonal=False)


def test_plain_op_cuts_rows_into_blocks(monkeypatch):
    """The plain version's row blocks (about 1 GB each at real sizes) meet
    at the diagonal without a seam (1e-6: a block's product may round
    differently from the whole matrix's, and a cosine sum may sit near 0)."""
    from metrics_tpu_torch.ops import pairwise_reduce as pr

    x, _ = _inputs(n=11, m=11, d=5, seed=6)
    xt = torch.from_numpy(x)
    whole = {op: pr._pairwise_plain(xt, xt, op, True) for op in ("euclidean", "cosine")}
    monkeypatch.setattr(pr, "_PLAIN_BLOCK_ELEMENTS", 3 * 11)  # 3 rows per block
    for op, want in whole.items():
        torch.testing.assert_close(pr._pairwise_plain(xt, xt, op, True), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("y_change", ["zero_row", "nan_entry"])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("name", FUNCTIONALS[:2])
def test_nan_column_on_the_masked_diagonal_like_jax(name, reduction, y_change):
    """Column 2 of y is NaN (for cosine a zero row is too, 0/0): every row's
    sum is NaN but row 2's, whose NaN cell is the zeroed diagonal one."""
    x, y = _inputs(n=5, m=6, d=4, seed=7)
    if y_change == "zero_row":
        y[2] = 0.0
    else:
        y[2, 1] = np.nan
    got, want = _call_both(name, x, y, reduction=reduction, zero_diagonal=True)
    _assert_close(got, want, TOL["float32"])
    if y_change == "nan_entry" or name == "pairwise_cosine_similarity":
        assert np.isnan(got.numpy()).tolist() == [True, True, False, True, True]


@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("name", FUNCTIONALS[:2])
def test_one_zero_row_against_itself_gives_zero_like_jax(name, reduction):
    """Every cell masked: the sum is 0, though cosine's only cell is 0/0."""
    x = np.zeros((1, 4), np.float32)
    got, want = _call_both(name, x, None, reduction=reduction)
    _assert_close(got, want, TOL["float32"])
    assert got.tolist() == [0.0]


@pytest.mark.parametrize("zero_diagonal", [True, False])
@pytest.mark.parametrize("case", ["self", "pair"])
def test_cosine_linear_order_in_float64_matches_jax(case, zero_diagonal):
    """The plain cosine row sums, x_i.(sum_j y_j) less the masked diagonal,
    in float64 against the JAX composition's matrix row sums."""
    x, y = _inputs(n=13, m=9, d=7, seed=8)
    y = x if case == "self" else y
    unit = lambda a: a.astype(np.float64) / np.linalg.norm(a.astype(np.float64), axis=1, keepdims=True)  # noqa: E731
    want = fj.pairwise_cosine_similarity(jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64), reduction="sum", zero_diagonal=zero_diagonal)
    got = pairwise_reduce(torch.from_numpy(unit(x)), torch.from_numpy(unit(y)), op="cosine", zero_diagonal=zero_diagonal)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)


def _misaligned(a: torch.Tensor) -> torch.Tensor:
    """The same values 4 bytes past an allocation's start."""
    return torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].view(a.shape)


@pytest.mark.parametrize("view", ["whole", "offset_rows", "misaligned"])
@pytest.mark.parametrize("d", [1, 5, 7, 8])
def test_tma_operand_pads_and_aligns_without_changing_the_sums(d, view):
    """The euclidean kernel's operands: width a multiple of 4 (zero columns),
    contiguous, 16-byte aligned; the plain row sums are those of the
    unpadded inputs (1e-6: a padded product may round otherwise)."""
    from metrics_tpu_torch.ops.pairwise_reduce import _pairwise_plain, _tma_operand

    x, y = (torch.from_numpy(a) for a in _inputs(n=9, m=6, d=d, seed=9))
    x = {"whole": x, "offset_rows": x[1:], "misaligned": _misaligned(x)}[view]
    xp, yp = _tma_operand(x), _tma_operand(y)
    for a, ap in ((x, xp), (y, yp)):
        assert ap.is_contiguous() and ap.shape[1] % 4 == 0 and ap.data_ptr() % 16 == 0
        torch.testing.assert_close(ap[:, : a.shape[1]], a, rtol=0, atol=0)
        assert not ap[:, a.shape[1]:].any()
    for zero_diagonal in (True, False):
        want = _pairwise_plain(x, y, "euclidean", zero_diagonal)
        torch.testing.assert_close(_pairwise_plain(xp, yp, "euclidean", zero_diagonal), want, rtol=1e-6, atol=0)
