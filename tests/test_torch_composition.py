"""The port's ``CompositionalMetric`` and metric operators against
``metrics_tpu``: every operator with metric and constant operands, through
``update``/``compute``, ``forward`` and ``reset``; identity hashing beside
the overridden ``==``; and where a composition lives.

The operand sums are exact in float32 (dyadic inputs), so the results agree
within 1e-6 relative (float32 against the JAX package's float64 states);
integer and boolean results exactly.
"""
import operator

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu_torch.metric import CompositionalMetric

RTOL = 1e-6
A_VALUES = ([1.5, 2.25], [3.5])  # sums to 7.25
B_VALUES = ([0.5, 1.0], [1.0])  # sums to 2.5
CONFMAT_BATCHES = (([0, 1, 2, 1], [0, 2, 2, 1]), ([2, 2, 0], [1, 2, 0]))

BINARY = {
    "add": operator.add,
    "sub": operator.sub,
    "mul": operator.mul,
    "truediv": operator.truediv,
    "floordiv": operator.floordiv,
    "mod": operator.mod,
    "pow": operator.pow,
    "eq": operator.eq,
    "ne": operator.ne,
    "lt": operator.lt,
    "le": operator.le,
    "gt": operator.gt,
    "ge": operator.ge,
}
BITWISE = {"and": operator.and_, "or": operator.or_, "xor": operator.xor, "matmul": operator.matmul}
UNARY = {
    "abs": operator.abs,
    "neg": operator.neg,
    "pos": operator.pos,
    "invert": operator.invert,
    "getitem": lambda m: m[1],
}
# (operand kinds): metric with metric, metric with constant, constant with metric (the reflected operator)
SIDES = ("metric-metric", "metric-const", "const-metric")


def _sum_pair(pkg):
    kw = {} if pkg is mj else {"device": "cpu"}
    return pkg.SumMetric(**kw), pkg.SumMetric(**kw)


def _confmat_pair(pkg):
    kw = {} if pkg is mj else {"device": "cpu"}
    return pkg.ConfusionMatrix(num_classes=3, **kw), pkg.ConfusionMatrix(num_classes=3, **kw)


def _compose(op, a, b, side: str, const):
    if side == "metric-metric":
        return op(a, b)
    if side == "metric-const":
        return op(a, const)
    return op(const, a)


def _as_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want) -> None:
    got, want = _as_numpy(got), _as_numpy(want)
    assert got.shape == want.shape
    if want.dtype.kind in "biu":
        assert got.dtype.kind == want.dtype.kind
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _drive_sums(pkg, comp, a, b):
    """Stream A_VALUES into ``a`` and B_VALUES into ``b``; with a metric
    ``b`` the composition's own ``forward`` feeds both operands."""
    as_array = jnp.asarray if pkg is mj else torch.tensor
    values = []
    for va, vb in zip(A_VALUES, B_VALUES):
        a.update(as_array(va))
        b.update(as_array(vb))
        values.append(comp.compute())
        comp._computed = None  # the operands moved underneath the composition
    return values


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_operator_matches_jax(name, side):
    results = []
    for pkg in (mj, mt):
        a, b = _sum_pair(pkg)
        comp = _compose(BINARY[name], a, b, side, 2.5 if side == "metric-const" else 3.0)
        assert type(comp).__name__ == "CompositionalMetric"
        results.append(_drive_sums(pkg, comp, a, b))
    for got, want in zip(results[1], results[0]):
        _assert_same(got, want)


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("name", sorted(BITWISE))
def test_integer_operator_matches_jax(name, side):
    """The bitwise operators and ``@`` on integer confusion matrices, through
    the composition's ``forward`` (which feeds every metric operand)."""
    results = []
    for pkg in (mj, mt):
        as_array = jnp.asarray if pkg is mj else torch.tensor
        a, b = _confmat_pair(pkg)
        const = as_array(np.arange(9).reshape(3, 3) % 4) if pkg is mt else jnp.asarray(np.arange(9).reshape(3, 3) % 4)
        comp = _compose(BITWISE[name], a, b, side, const)
        out = [comp(as_array(p), as_array(t)) for p, t in CONFMAT_BATCHES]
        out.append(comp.compute())
        results.append(out)
    for got, want in zip(results[1], results[0]):
        _assert_same(got, want)


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_operator_matches_jax(name):
    results = []
    for pkg in (mj, mt):
        as_array = jnp.asarray if pkg is mj else torch.tensor
        a, _ = _confmat_pair(pkg)
        comp = UNARY[name](a)
        out = [comp(as_array(p), as_array(t)) for p, t in CONFMAT_BATCHES]
        out.append(comp.compute())
        comp.reset()
        assert a._update_count == 0 and int(a.confmat.sum()) == 0
        results.append(out)
    for got, want in zip(results[1], results[0]):
        _assert_same(got, want)


def test_composition_in_a_collection_matches_jax():
    """The harmonic mean of precision and recall from the operators, beside
    its operands in a collection, over forward, compute and reset."""
    rng = np.random.default_rng(2)
    batches = [(rng.standard_normal((30, 5)).astype(np.float32), rng.integers(0, 5, 30)) for _ in range(3)]
    results = []
    for pkg in (mj, mt):
        kw = {} if pkg is mj else {"device": "cpu"}
        as_array = jnp.asarray if pkg is mj else torch.from_numpy
        p, r = pkg.Precision(num_classes=5, average="macro", top_k=2, **kw), pkg.Recall(average="micro", **kw)
        mc = pkg.MetricCollection({"harmonic": 2 / (1 / p + 1 / r), "acc": pkg.Accuracy(num_classes=5, **kw)})
        out = [mc(as_array(x), as_array(y)) for x, y in batches]
        out.append(mc.compute())
        mc.reset()
        assert p._update_count == 0 and r._update_count == 0
        results.append(out)
    for got, want in zip(results[1], results[0]):
        assert got.keys() == want.keys()
        for key in want:
            _assert_same(got[key], want[key])


def test_hash_is_identity_and_modules_walk_with_eq_overridden():
    a, b = _sum_pair(mt)
    comp = a + b
    assert hash(a) == hash(a) and hash(a) != hash(b)
    assert isinstance(a == b, CompositionalMetric)
    a.update(torch.tensor([1.0]))  # states are replaced: the hash stays
    assert hash(a) == object.__hash__(a)
    names = [name for name, _ in comp.named_modules()]
    assert names == ["", "metric_a", "metric_b"]
    assert {a, b, comp} == {comp, b, a} and len({a, a, b}) == 2


def test_composition_takes_its_device_from_its_operands():
    a = mt.SumMetric(device="cpu")
    comp = 3 * a
    assert comp.device.type == "cpu" and comp.metric_a.device.type == "cpu"  # the constant is a buffer there
    comp.to("meta")
    assert comp.metric_a.device.type == "meta" and a.value.device.type == "meta"
    if not torch.cuda.is_available():
        # no metric operand: the default device, which needs CUDA
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CompositionalMetric(torch.add, 1.0, 2.0)
