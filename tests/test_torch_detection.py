"""The port's detection metrics against ``metrics_tpu`` on the same seeded
numpy scenes: the box primitives, and ``MeanAveragePrecision`` equal bit for
bit on all fourteen outputs (the same host float64 evaluation on the same
float64 inputs) across seeds, the three box formats, custom IoU and recall
thresholds and detection caps, ``class_metrics``, and scenes with no
detections, no ground truth and classes only in the predictions; the
per-image states through a sync (``compute()`` and the pure
``sync_state``) against serial JAX over every rank's images; ``state_dict``
and checkpoint trees crossed both ways; ``update`` with no host read.

The box primitives: float64 exactly, float32 within 1e-6 relative.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu.detection as dj
import metrics_tpu.utils.checkpoint as cj
import metrics_tpu_torch as mt
import metrics_tpu_torch.detection as dt
import metrics_tpu_torch.utils.checkpoint as ct
from metrics_tpu_torch.utils.program import program_scope
from tests.helpers.detection_scenes import detection_scenes

FORMATS = ("xyxy", "xywh", "cxcywh")


def _boxes(seed: int, n: int, dtype) -> np.ndarray:
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(0, 50, (n, 2))
    wh[0] = 0.0  # a degenerate box: its unions with itself are empty
    return np.concatenate([xy, xy + wh], axis=1).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("out_fmt", FORMATS)
@pytest.mark.parametrize("in_fmt", FORMATS)
def test_box_convert_follows_jax(in_fmt, out_fmt, dtype):
    boxes = _boxes(1, 9, dtype)
    got = dt.box_convert(torch.from_numpy(boxes), in_fmt, out_fmt)
    want = np.asarray(dj.box_convert(jnp.asarray(boxes), in_fmt, out_fmt))
    assert got.dtype == torch.from_numpy(want.copy()).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6 if dtype == np.float32 else 0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_box_area_and_iou_follow_jax(dtype):
    a, b = _boxes(2, 7, dtype), _boxes(3, 5, dtype)
    rtol = 1e-6 if dtype == np.float32 else 0
    np.testing.assert_allclose(dt.box_area(torch.from_numpy(a)).numpy(), np.asarray(dj.box_area(jnp.asarray(a))), rtol=rtol)
    got = dt.box_iou(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(dj.box_iou(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=1e-7 if dtype == np.float32 else 0)
    assert float(dt.box_iou(torch.from_numpy(a[:1]), torch.from_numpy(a[:1]))) == 0.0


def test_box_convert_rejects_unknown_formats():
    with pytest.raises(ValueError, match="Unsupported box format"):
        dt.box_convert(torch.zeros(1, 4), "xyxy", "yxyx")


def _as(pkg, scene):
    as_array = jnp.asarray if pkg is mj else torch.from_numpy
    return [{k: as_array(v) for k, v in d.items()} for d in scene]


def _fed(pkg, preds, targets, batch: int = 5, **kwargs):
    m = pkg.MeanAveragePrecision(**({"device": "cpu"} if pkg is mt else {}), **kwargs)
    for s in range(0, len(preds), batch):
        m.update(_as(pkg, preds[s : s + batch]), _as(pkg, targets[s : s + batch]))
    return m


def _assert_equal(got: dict, want: dict) -> None:
    """All fourteen outputs bit for bit, as float32 of the same shapes."""
    assert list(got) == list(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


MAP_CASES = [
    ("seed0", 0, {}),
    ("seed1-classwise", 1, {"class_metrics": True}),
    ("seed2-xywh", 2, {"box_format": "xywh", "class_metrics": True}),
    ("seed3-cxcywh", 3, {"box_format": "cxcywh"}),
    ("custom-thresholds", 4, {"iou_thresholds": [0.3, 0.5, 0.75], "rec_thresholds": [0.0, 0.25, 0.5, 1.0], "class_metrics": True}),
    ("detection-caps", 5, {"max_detection_thresholds": [2, 5, 8]}),
]


@pytest.mark.parametrize("label,seed,kwargs", MAP_CASES, ids=[c[0] for c in MAP_CASES])
def test_map_equals_jax_bit_for_bit(label, seed, kwargs):
    preds, targets = detection_scenes(seed, 23, box_format=kwargs.get("box_format", "xyxy"))
    assert any(len(p["labels"]) == 0 for p in preds) and any(len(t["labels"]) == 0 for t in targets)
    _assert_equal(_fed(mt, preds, targets, **kwargs).compute(), _fed(mj, preds, targets, **kwargs).compute())


def _box(*xyxy):
    return np.asarray([xyxy], dtype=np.float64).reshape(-1, 4)


EMPTY = np.zeros((0, 4))
SCENES = {
    "no-detections": (
        [{"boxes": EMPTY, "scores": np.zeros(0), "labels": np.zeros(0, np.int64)}],
        [{"boxes": _box(10, 10, 50, 50), "labels": np.asarray([1])}],
    ),
    "no-ground-truth": (
        [{"boxes": _box(10, 10, 50, 50), "scores": np.asarray([0.7]), "labels": np.asarray([2])}],
        [{"boxes": EMPTY, "labels": np.zeros(0, np.int64)}],
    ),
    "class-only-in-predictions": (
        [{"boxes": np.concatenate([_box(10, 10, 50, 50), _box(0, 0, 20, 30)]), "scores": np.asarray([0.9, 0.4]), "labels": np.asarray([0, 5])}],
        [{"boxes": _box(12, 10, 50, 52), "labels": np.asarray([0])}],
    ),
    "nothing": (
        [{"boxes": EMPTY, "scores": np.zeros(0), "labels": np.zeros(0, np.int64)}],
        [{"boxes": EMPTY, "labels": np.zeros(0, np.int64)}],
    ),
}


@pytest.mark.parametrize("class_metrics", [False, True], ids=["overall", "classwise"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_map_edge_scenes_equal_jax(scene, class_metrics):
    preds, targets = SCENES[scene]
    _assert_equal(
        _fed(mt, preds, targets, class_metrics=class_metrics).compute(),
        _fed(mj, preds, targets, class_metrics=class_metrics).compute(),
    )


def test_map_forward_equals_jax():
    preds, targets = detection_scenes(6, 12)
    port, ref = mt.MeanAveragePrecision(device="cpu"), mj.MeanAveragePrecision()
    for s in (0, 6):
        _assert_equal(port(_as(mt, preds[s : s + 6]), _as(mt, targets[s : s + 6])), ref(_as(mj, preds[s : s + 6]), _as(mj, targets[s : s + 6])))
    _assert_equal(port.compute(), ref.compute())


def test_map_states_are_device_tensors_and_update_reads_nothing_back():
    """The per-image states are float64 xyxy boxes, float64 scores and int64
    labels; ``update`` runs under the host-sync guard (no ``.cpu()``,
    ``.item()`` or other wait for the device)."""
    preds, targets = detection_scenes(7, 4, box_format="cxcywh")
    m = mt.MeanAveragePrecision(box_format="cxcywh", device="cpu")
    with program_scope():
        m.update(_as(mt, preds), _as(mt, targets))
    assert [b.dtype for b in m.detection_boxes] == [torch.float64] * 4
    assert m.detection_labels[0].dtype == m.groundtruth_labels[0].dtype == torch.int64
    assert m.detection_scores[0].dtype == torch.float64
    assert m._compute_is_host_side and not m._enable_jit
    ref = mj.MeanAveragePrecision(box_format="cxcywh")
    ref.update(_as(mj, preds), _as(mj, targets))
    for got, want in zip(m.groundtruth_boxes, ref.groundtruth_boxes):
        np.testing.assert_array_equal(got.numpy(), want)


def test_map_validates_like_jax():
    preds, targets = detection_scenes(8, 2)
    bad = [
        (preds[0], targets),
        (preds, targets[:1]),
        ([{k: v for k, v in preds[0].items() if k != "scores"}, preds[1]], targets),
        (preds, [{"boxes": targets[0]["boxes"]}, targets[1]]),
    ]
    for p, t in bad:
        with pytest.raises(ValueError) as port_err:
            mt.MeanAveragePrecision(device="cpu").update(p, t)
        with pytest.raises(ValueError) as jax_err:
            mj.MeanAveragePrecision().update(p, t)
        assert str(port_err.value) == str(jax_err.value)
    for kwargs in ({"box_format": "yxyx"}, {"class_metrics": 1}):
        with pytest.raises(ValueError) as port_err:
            mt.MeanAveragePrecision(device="cpu", **kwargs)
        with pytest.raises(ValueError) as jax_err:
            mj.MeanAveragePrecision(**kwargs)
        assert str(port_err.value) == str(jax_err.value)


def _peer_gather(peers):
    """A ``dist_sync_fn`` answering each leaf with this rank's tensor and the
    peers' same leaf (their packed per-image rows and lengths), in order;
    each sync asks for every leaf once."""
    calls = {"i": 0}

    def gather(x, group=None):
        i = calls["i"]
        calls["i"] += 1
        return [x] + [(lambda v: v[i % len(v)])(list(p._sync_leaves(p._snapshot_state()).values())) for p in peers]

    return gather


@pytest.mark.parametrize("class_metrics", [False, True], ids=["overall", "classwise"])
def test_map_keeps_image_boundaries_through_a_sync(class_metrics):
    """Rank 0 holds 9 images, its peer 6 (one of each with no detection):
    the synced compute and the pure ``sync_state`` equal serial JAX over all
    15 images, and unsync gives rank 0 its own 9 back."""
    preds, targets = detection_scenes(9, 15)
    m0 = _fed(mt, preds[:9], targets[:9], class_metrics=class_metrics)
    m1 = _fed(mt, preds[9:], targets[9:], class_metrics=class_metrics)
    want = _fed(mj, preds, targets, class_metrics=class_metrics).compute()
    local = {k: v.clone() for k, v in m0.compute().items()}

    m0._computed = None
    m0._distributed_available_fn = lambda: True
    m0.dist_sync_fn = _peer_gather([m1])
    _assert_equal(m0.compute(), want)
    assert len(m0.detection_boxes) == 9
    # the pure compute returns the values as computed (``[-1.0]`` per-class
    # lists unsqueezed); ``compute()`` squeezes one-element results
    pure = m0.compute_state(m0.sync_state(m0._snapshot_state()))
    _assert_equal({k: v.squeeze() if v.numel() == 1 else v for k, v in pure.items()}, want)
    m0.dist_sync_fn = None
    m0._computed = None
    _assert_equal(m0.compute(), local)


def test_map_state_dicts_and_trees_cross_both_ways():
    """JAX takes batch 0, the port its state and batch 1, JAX the port's
    state back and batch 2: bit for bit JAX over all three; then the
    checkpoint trees, each way."""
    preds, targets = detection_scenes(10, 15)
    parts = [(preds[s : s + 5], targets[s : s + 5]) for s in (0, 5, 10)]
    whole = _fed(mj, preds, targets).compute()
    first = mj.MeanAveragePrecision()
    first.update(*(_as(mj, x) for x in parts[0]))
    first.persistent(True)
    port = mt.MeanAveragePrecision(device="cpu")
    port.persistent(True)
    loaded = port.load_state_dict(mt.state_from_jax(first.state_dict()))
    assert not loaded.missing_keys and not loaded.unexpected_keys
    port.update(*(_as(mt, x) for x in parts[1]))
    back = mj.MeanAveragePrecision()
    back.persistent(True)
    back.load_state_dict(mt.state_to_jax(port.state_dict()))
    back.update(*(_as(mj, x) for x in parts[2]))
    _assert_equal({k: torch.from_numpy(np.asarray(v)) for k, v in back.compute().items()}, whole)

    jax_m = _fed(mj, preds, targets)
    fresh = mt.MeanAveragePrecision(device="cpu")
    ct.restore_metric_state_pytree(fresh, cj.metric_state_pytree(jax_m))
    _assert_equal(fresh.compute(), whole)
    fresh_jax = mj.MeanAveragePrecision()
    cj.restore_metric_state_pytree(fresh_jax, ct.metric_state_pytree(fresh))
    _assert_equal({k: torch.from_numpy(np.asarray(v)) for k, v in fresh_jax.compute().items()}, whole)


def test_map_is_the_jax_alias_and_warns_from_deprecated():
    assert dt.MAP is dt.MeanAveragePrecision and dj.MAP is dj.MeanAveragePrecision
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(DeprecationWarning, match="`MAP` was renamed to `MeanAveragePrecision`"):
            mt.MAP(device="cpu")
