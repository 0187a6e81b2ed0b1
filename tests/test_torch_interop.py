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


# (class, constructor kwargs, input kind); each new metric carries its state across mid-stream
NEW_METRICS = [
    ("Precision", {"num_classes": C, "average": "macro", "top_k": 3}, "scores"),
    ("Recall", {"average": "micro"}, "scores"),
    ("Specificity", {"num_classes": C, "average": "macro"}, "scores"),
    ("Precision", {"average": "samples"}, "multilabel"),  # list states
    ("HammingDistance", {}, "scores"),
    ("MaxMetric", {}, "values"),
    ("MinMetric", {}, "values"),
    ("SumMetric", {"compensated": True}, "values"),
    ("MeanMetric", {}, "values"),
    ("CatMetric", {}, "values"),
    ("HingeLoss", {}, "scores"),
    ("HingeLoss", {"multiclass_mode": "one-vs-all", "squared": True}, "scores"),
    ("KLDivergence", {}, "dist"),  # a sum state
    ("KLDivergence", {"reduction": "none"}, "dist"),  # a cat list state
    ("CohenKappa", {"num_classes": C, "weights": "quadratic"}, "scores"),  # int32 confmat in JAX
    ("MatthewsCorrCoef", {"num_classes": C}, "scores"),
    ("JaccardIndex", {"num_classes": C, "ignore_index": 0}, "scores"),
    ("RetrievalMAP", {}, "retrieval"),  # list states
    ("RetrievalMAP", {"buffer_capacity": 200, "ignore_index": -1}, "retrieval"),  # bounded buffers
    ("WordErrorRate", {}, "text"),
    ("CharErrorRate", {}, "text"),
    ("MatchErrorRate", {}, "text"),
    ("WordInfoLost", {}, "text"),
    ("WordInfoPreserved", {}, "text"),
    ("BLEUScore", {"smooth": True}, "text"),
    ("SacreBLEUScore", {"tokenize": "13a"}, "text"),
    ("CHRFScore", {"return_sentence_level_score": True}, "text"),  # a list state of sentence scores
    ("TranslationEditRate", {"return_sentence_level_score": True}, "text"),
    ("ExtendedEditDistance", {}, "text"),  # a list state
    ("ROUGEScore", {"rouge_keys": ("rouge1", "rougeLsum")}, "text"),  # lists of per-sentence scalars
    ("SQuAD", {}, "squad"),  # an int64 count
]


def _text_batches(rng, n: int = 4, size: int = 3):
    """Seeded hypothesis and reference strings, four batches of three."""
    words = "the cat dog sat ran on a mat house big small red tree".split()
    batches = []
    for _ in range(n):
        refs = [" ".join(rng.choice(words, rng.integers(3, 9))) for _ in range(size)]
        hyps = [" ".join(w if rng.random() > 0.3 else str(rng.choice(words)) for w in r.split()) for r in refs]
        batches.append((hyps, refs))
    return batches


def _squad_batches(rng, n: int = 4, size: int = 3):
    batches = []
    for b in range(n):
        ids = [f"{b}-{i}" for i in range(size)]
        truths = [str(rng.choice(["a red tree", "the big cat", "seven", "on the mat"])) for _ in ids]
        preds = [{"prediction_text": t if rng.random() > 0.4 else "a dog", "id": q} for t, q in zip(truths, ids)]
        batches.append((preds, [{"answers": {"text": [t]}, "id": q} for t, q in zip(truths, ids)]))
    return batches


def _as_numpy(value):
    if isinstance(value, dict):
        return {k: _as_numpy(v) for k, v in value.items()}
    if isinstance(value, tuple):
        return tuple(_as_numpy(v) for v in value)
    return value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


@pytest.mark.parametrize("name,kwargs,kind", NEW_METRICS, ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(NEW_METRICS)])
def test_new_metric_state_carries_across_from_jax(name, kwargs, kind):
    """JAX updates batches 1-2; the port takes its state and updates 3-4; the
    result equals JAX over batches 1-4 (scores within 1e-6 relative, kappa and
    MCC also within 1e-6 absolute; float sums, hinge and KL 1e-5 relative)."""
    rng = np.random.default_rng(5)
    if kind == "values":
        batches = [(rng.standard_normal(11).astype(np.float32),) for _ in range(4)]
    elif kind == "multilabel":
        batches = [(rng.random((20, C)).astype(np.float32), rng.integers(0, 2, (20, C))) for _ in range(4)]
    elif kind == "dist":
        batches = [tuple(rng.random((20, C)).astype(np.float32) + 0.05 for _ in range(2)) for _ in range(4)]
    elif kind == "retrieval":
        batches = [
            (np.round(rng.random(30), 1).astype(np.float32), rng.integers(-1, 2, 30), rng.integers(0, 6, 30)) for _ in range(4)
        ]
        if "ignore_index" not in kwargs:
            batches = [(p, np.abs(t), x) for p, t, x in batches]
    elif kind == "text":
        batches = _text_batches(rng)
    elif kind == "squad":
        batches = _squad_batches(rng)
    else:
        batches = [(preds, target) for preds, target in _stream(seed=6)]
    strings = kind in ("text", "squad")
    to_jax = (lambda b: b) if strings else (lambda b: tuple(map(jnp.asarray, b)))
    to_port = (lambda b: b) if strings else (lambda b: tuple(map(torch.from_numpy, b)))
    jax_m = getattr(mj, name)(**kwargs)
    for batch in batches[:2]:
        jax_m.update(*to_jax(batch))
    jax_m.persistent(True)
    port_m = getattr(mt, name)(device="cpu", **kwargs)
    port_m.persistent(True)
    result = port_m.load_state_dict(mt.state_from_jax(jax_m.state_dict()))
    assert not result.missing_keys and not result.unexpected_keys
    for batch in batches[2:]:
        port_m.update(*to_port(batch))
        jax_m.update(*to_jax(batch))
    if strings:  # text scores: 1e-6 absolute on the unit scale (SQuAD's are percentages)
        got, want = _as_numpy(port_m.compute()), _as_numpy(jax_m.compute())
        flat_got = got if isinstance(got, dict) else dict(enumerate(got if isinstance(got, tuple) else (got,)))
        flat_want = want if isinstance(want, dict) else dict(enumerate(want if isinstance(want, tuple) else (want,)))
        assert flat_got.keys() == flat_want.keys()
        for key in flat_want:
            assert flat_got[key].shape == flat_want[key].shape, key
            np.testing.assert_allclose(flat_got[key], flat_want[key], rtol=0, atol=1e-4 if name == "SQuAD" else 1e-6, err_msg=str(key))
        return
    got, want = port_m.compute().numpy(), np.asarray(jax_m.compute())
    assert got.shape == want.shape
    if name == "CatMetric":
        np.testing.assert_array_equal(got, want)
    elif name in ("CohenKappa", "MatthewsCorrCoef"):  # near 0: a difference of two O(1) float32 values
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5 if kind in ("values", "dist") or name == "HingeLoss" else 1e-6, atol=0)


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("MeanMetric", {}),
        ("Accuracy", {"num_classes": C, "on_bad_input": "skip"}),
        ("HingeLoss", {"on_bad_input": "skip"}),
        ("CohenKappa", {"num_classes": C, "on_bad_input": "mask"}),
    ],
)
def test_health_counters_carry_across_both_ways(name, kwargs):
    """``_health_counts`` rides ``state_from_jax`` into the port and
    ``state_to_jax`` back: after a NaN-laced stream split across the two
    packages, each side's counters and value equal one package's over the
    whole stream."""
    rng = np.random.RandomState(3)
    if name == "MeanMetric":
        batches = [(rng.standard_normal(8).astype(np.float32),) for _ in range(4)]
        batches[1][0][[2, 5]] = np.nan
    else:
        batches = list(_stream(seed=7))
        batches[2][0][1, 0] = np.nan
    whole = getattr(mj, name)(**kwargs)
    for batch in batches:
        whole.update(*map(jnp.asarray, batch))

    jax_m = getattr(mj, name)(**kwargs)
    for batch in batches[:2]:
        jax_m.update(*map(jnp.asarray, batch))
    jax_m.persistent(True)
    port_m = getattr(mt, name)(device="cpu", **kwargs)
    port_m.persistent(True)
    dynamic = {"mode": jax_m.mode} if name == "Accuracy" else None
    result = port_m.load_state_dict(mt.state_from_jax(jax_m.state_dict(), dynamic=dynamic))
    assert not result.missing_keys and not result.unexpected_keys
    np.testing.assert_array_equal(port_m._health_counts.numpy(), np.asarray(jax_m._health_counts))
    port_m.update(*map(torch.from_numpy, batches[2]))

    back = getattr(mj, name)(**kwargs)
    back.persistent(True)
    state = mt.state_to_jax(port_m.state_dict())
    if name == "Accuracy":
        back.mode = jax_m.mode
        state.pop("mode")
    back.load_state_dict(state)
    back.update(*map(jnp.asarray, batches[3]))
    np.testing.assert_array_equal(np.asarray(back._health_counts), np.asarray(whole._health_counts))
    assert back.health_report()["nan_count"] == whole.health_report()["nan_count"] > 0
    np.testing.assert_allclose(np.asarray(back.compute()), np.asarray(whole.compute()), rtol=1e-5)


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


def _import_time_modules(path: pathlib.Path):
    """The modules a file imports when it is imported: every import outside
    a function body (class bodies and ``if``/``try`` blocks included)."""

    def walk(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(node, ast.Import):
                yield from (alias.name for alias in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                yield node.module
            yield from walk(ast.iter_child_nodes(node))

    yield from walk(ast.parse(path.read_text(), filename=str(path)).body)


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((REPO / "metrics_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    scanned = {str(path.relative_to(REPO)) for path in files}
    sync_slice = {
        "metrics_tpu_torch/parallel/comm.py",
        "metrics_tpu_torch/utils/prints.py",
        "metrics_tpu_torch/aggregation.py",
        *(f"metrics_tpu_torch/classification/{m}.py" for m in ("precision_recall", "specificity", "hamming")),
        *(f"metrics_tpu_torch/functional/classification/{m}.py" for m in ("precision_recall", "specificity", "hamming")),
    }
    assert sync_slice <= scanned, sorted(sync_slice - scanned)
    curve_slice = {
        "metrics_tpu_torch/ops/binned_counts.py",
        "metrics_tpu_torch/utils/bounded.py",
        *(f"metrics_tpu_torch/classification/{m}.py" for m in ("auc", "auroc", "avg_precision", "binned_precision_recall", "calibration_error", "precision_recall_curve", "roc")),
        *(f"metrics_tpu_torch/functional/classification/{m}.py" for m in ("auc", "auroc", "average_precision", "calibration_error", "precision_recall_curve", "roc")),
    }
    assert curve_slice <= scanned, sorted(curve_slice - scanned)
    retrieval_slice = {
        "metrics_tpu_torch/deprecated.py",
        "metrics_tpu_torch/functional/deprecated.py",
        "metrics_tpu_torch/functional/retrieval/_ranking.py",
        *(f"metrics_tpu_torch/classification/{m}.py" for m in ("cohen_kappa", "hinge", "jaccard", "kl_divergence", "matthews_corrcoef")),
        *(f"metrics_tpu_torch/functional/classification/{m}.py" for m in ("cohen_kappa", "dice", "hinge", "jaccard", "kl_divergence", "matthews_corrcoef")),
        *(
            f"metrics_tpu_torch/{pkg}retrieval/{m}.py"
            for pkg in ("", "functional/")
            for m in ("average_precision", "fall_out", "hit_rate", "ndcg", "precision", "r_precision", "recall", "reciprocal_rank")
        ),
        "metrics_tpu_torch/retrieval/base.py",
        "metrics_tpu_torch/retrieval/_topk_base.py",
    }
    assert retrieval_slice <= scanned, sorted(retrieval_slice - scanned)
    generative_slice = {
        *(f"metrics_tpu_torch/image/networks/{m}.py" for m in ("__init__", "_common", "inception", "lpips")),
        *(f"metrics_tpu_torch/image/{m}.py" for m in ("fid", "kid", "inception", "lpip")),
        *(f"metrics_tpu_torch/sharding/{m}.py" for m in ("__init__", "linalg")),
        *(f"metrics_tpu_torch/encoders/{m}.py" for m in ("__init__", "runtime", "stream")),
    }
    assert generative_slice <= scanned, sorted(generative_slice - scanned)
    text_modules = ("bert", "bleu", "cer", "chrf", "eed", "mer", "rouge", "sacre_bleu", "squad", "ter", "wer", "wil", "wip")
    text_slice = {
        "metrics_tpu_torch/text/__init__.py",
        "metrics_tpu_torch/functional/text/__init__.py",
        "metrics_tpu_torch/functional/text/helper.py",
        *(f"metrics_tpu_torch/{pkg}text/{m}.py" for pkg in ("", "functional/") for m in text_modules),
    }
    assert text_slice <= scanned, sorted(text_slice - scanned)
    audio_modules = ("__init__", "pesq", "pit", "sdr", "snr", "stoi")
    audio_detection_slice = {
        "metrics_tpu_torch/functional/audio/_host.py",
        *(f"metrics_tpu_torch/{pkg}audio/{m}.py" for pkg in ("", "functional/") for m in audio_modules),
        *(f"metrics_tpu_torch/detection/{m}.py" for m in ("__init__", "_box_ops", "map")),
    }
    assert audio_detection_slice <= scanned, sorted(audio_detection_slice - scanned)
    # the optional packages are imported where they are used, never when a module is
    optional = [
        f"{path.relative_to(REPO)}: {mod}"
        for path in files
        for mod in _import_time_modules(path)
        if mod.split(".")[0] in ("nltk", "regex", "transformers", "pesq")
    ]
    assert optional == []
    offenders = [
        f"{path.relative_to(REPO)}: {mod}"
        for path in files
        for mod in _imported_modules(path)
        if mod.split(".")[0] in ("jax", "jaxlib", "metrics_tpu")
    ]
    assert offenders == []


def test_generative_entry_points_default_to_cuda():
    """The embedding metrics, their networks' resolvers, weight loaders,
    random-parameter functions and JAX-tree converters, and the encoder
    runtime live on the card unless the caller names another device."""
    from metrics_tpu_torch.encoders import ShardedEncoder
    from metrics_tpu_torch.image.networks import inception as net_inception
    from metrics_tpu_torch.image.networks import lpips as net_lpips
    from metrics_tpu_torch.image.networks import resolve_inception_extractor
    from metrics_tpu_torch.image.networks.lpips import resolve_lpips_network
    from metrics_tpu_torch.interop import inception_params_from_jax, lpips_params_from_jax

    def extractor(imgs):
        return imgs.reshape(imgs.shape[0], -1)

    makers = [
        lambda: mt.FrechetInceptionDistance(feature=extractor, feature_dim=4),
        lambda: mt.FrechetInceptionDistance(),
        lambda: mt.KernelInceptionDistance(feature=extractor),
        lambda: mt.InceptionScore(feature=extractor),
        lambda: mt.LearnedPerceptualImagePatchSimilarity(net=lambda a, b: a),
        lambda: ShardedEncoder(lambda params, x: x, ()),
        lambda: ShardedEncoder.from_callable(extractor),
    ]
    if torch.cuda.is_available():
        assert mt.InceptionScore(feature=extractor).device.type == "cuda"
        assert ShardedEncoder.from_callable(extractor).device.type == "cuda"
        assert net_lpips.LPIPSNetwork(net_lpips.random_lpips_params("alex", seed=0), "alex").device.type == "cuda"
        return
    for make in makers:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    weights = [
        lambda: resolve_inception_extractor(2048, "unused.npz"),
        lambda: resolve_lpips_network("vgg", "unused.npz"),
        lambda: net_inception.random_inception_params(seed=0),
        lambda: net_inception.load_inception_weights("unused.npz"),
        lambda: net_inception.params_from_file_layout({}),
        lambda: net_lpips.random_lpips_params("vgg", seed=0),
        lambda: net_lpips.load_lpips_weights("unused.npz", "vgg"),
        lambda: net_lpips.params_from_file_layout({}, "vgg"),
        lambda: inception_params_from_jax({}),
        lambda: lpips_params_from_jax({}, "vgg"),
    ]
    for make in weights:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
