"""Carrying metric state from ``metrics_tpu`` into the port, the port's own
``state_dict`` round trip, and the rule that the port imports no JAX."""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu_torch.utils.enums import DataType

REPO = pathlib.Path(__file__).resolve().parent.parent
C = 9


def _stream(seed: int, n_batches: int = 4, n: int = 40):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal((n, C)).astype(np.float32), rng.integers(0, C, n)) for _ in range(n_batches)
    ]


def _members(pkg, **dev):
    return {
        "top1": pkg.Accuracy(num_classes=C, **dev),
        "top5": pkg.Accuracy(num_classes=C, top_k=5, **dev),
        "f1": pkg.F1Score(num_classes=C, average="macro", **dev),
        "confmat": pkg.ConfusionMatrix(num_classes=C, **dev),
    }


def _assert_results_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key in want:
        w = np.asarray(want[key])
        g = got[key].numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


def test_collection_state_carries_across_from_jax():
    """JAX updates batches 1-2; the port takes its state and updates 3-4; the
    result equals JAX over batches 1-4."""
    batches = _stream(seed=0)
    jax_mc = mj.MetricCollection(_members(mj))
    for preds, target in batches[:2]:
        jax_mc.update(jnp.asarray(preds), jnp.asarray(target))
    jax_mc.persistent(True)
    dynamic = {f"{k}.mode": jax_mc[k].mode for k in ("top1", "top5")}
    state = mt.state_from_jax(jax_mc.state_dict(), dynamic=dynamic)

    port_mc = mt.MetricCollection(_members(mt, device="cpu"))
    result = port_mc.load_state_dict(state)
    assert not result.missing_keys and not result.unexpected_keys
    assert port_mc["top5"].mode == DataType.MULTICLASS and isinstance(port_mc["top5"].mode, DataType)
    for preds, target in batches[2:]:
        port_mc.update(torch.from_numpy(preds), torch.from_numpy(target))
        jax_mc.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_results_equal(port_mc.compute(), jax_mc.compute())


def test_list_states_carry_across_from_jax():
    batches = _stream(seed=1, n_batches=3)
    jax_m = mj.StatScores(reduce="samples")
    for preds, target in batches[:2]:
        jax_m.update(jnp.asarray(preds), jnp.asarray(target))
    jax_m.persistent(True)
    port_m = mt.StatScores(reduce="samples", device="cpu")
    port_m.load_state_dict(mt.state_from_jax(jax_m.state_dict()))
    assert len(port_m.tp) == 2
    preds, target = batches[2]
    port_m.update(torch.from_numpy(preds), torch.from_numpy(target))
    jax_m.update(jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_array_equal(port_m.compute().numpy(), np.asarray(jax_m.compute()))


def test_port_state_dict_round_trip_and_validation():
    batches = _stream(seed=2, n_batches=2)
    src = mt.MetricCollection(_members(mt, device="cpu"))
    src.update(torch.from_numpy(batches[0][0]), torch.from_numpy(batches[0][1]))
    assert src.state_dict() == {}  # states are not persistent by default, as in the JAX package
    src.persistent(True)
    saved = src.state_dict()
    assert saved["top1.mode"] == {"$enum": "DataType", "value": "multi-class"}
    assert "confmat.confmat" in saved and saved["confmat.confmat"].dtype == torch.int64

    dst = mt.MetricCollection(_members(mt, device="cpu"))
    dst.persistent(True)
    dst.load_state_dict(saved)
    for m in (src, dst):
        m.update(torch.from_numpy(batches[1][0]), torch.from_numpy(batches[1][1]))
    _assert_results_equal(dst.compute(), {k: v.numpy() for k, v in src.compute().items()})

    with pytest.raises(RuntimeError, match="Missing key"):
        dst.load_state_dict({k: v for k, v in saved.items() if k != "f1.tp"})
    with pytest.raises(RuntimeError, match="shape"):
        dst.load_state_dict({**saved, "confmat.confmat": torch.zeros(3, 3, dtype=torch.int64)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        dst.load_state_dict({**saved, "f1.bogus": torch.zeros(1)})


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((REPO / "metrics_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    scanned = {str(path.relative_to(REPO)) for path in files}
    curve_slice = {
        "metrics_tpu_torch/ops/binned_counts.py",
        "metrics_tpu_torch/utils/bounded.py",
        *(f"metrics_tpu_torch/classification/{m}.py" for m in ("auc", "auroc", "avg_precision", "binned_precision_recall", "calibration_error", "precision_recall_curve", "roc")),
        *(f"metrics_tpu_torch/functional/classification/{m}.py" for m in ("auc", "auroc", "average_precision", "calibration_error", "precision_recall_curve", "roc")),
    }
    assert curve_slice <= scanned, sorted(curve_slice - scanned)
    offenders = [
        f"{path.relative_to(REPO)}: {mod}"
        for path in files
        for mod in _imported_modules(path)
        if mod.split(".")[0] in ("jax", "jaxlib", "metrics_tpu")
    ]
    assert offenders == []
