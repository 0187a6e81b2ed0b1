"""Warmup manifests and the persistent kernel cache of the port
(``metrics_tpu_torch.engine.warmup``, ``engine.persist``) on the CPU, where
a warm run is the program key's first eager run. It mirrors
``tests/engine/test_warmup.py`` and ``tests/engine/test_persistent_cache.py``
and holds the port against the JAX package where their meanings meet: the
same traffic records the same entry kinds, program counts and input shapes;
the reports carry the JAX keys and the Prometheus families the JAX names; a
warmed bank's values equal the JAX bank's. A JAX-recorded manifest warms
nothing here: its templates are refused by name. Nothing is built with
``nvcc`` here.

Tolerances: states and values bit for bit against the port's own cold runs;
against the JAX package, integer states bit for bit, floats within 1e-6
relative.
"""
import contextlib
import importlib
import json
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu import engine as ej
from metrics_tpu_torch import engine, obs
from metrics_tpu_torch.engine import cache, persist
from metrics_tpu_torch.serving import MetricBank

wm = importlib.import_module("metrics_tpu_torch.engine.warmup")
jwm = importlib.import_module("metrics_tpu.engine.warmup")

NUM_CLASSES = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "compat", "golden")


@pytest.fixture(autouse=True)
def _fresh_warmup_state():
    for m in (wm, jwm):
        m.stop_recording()
        m.reset_warmup_state()
    engine.clear_cache()
    ej.clear_cache()
    yield
    for m in (wm, jwm):
        m.stop_recording()
        m.reset_warmup_state()
    engine.clear_cache()
    ej.clear_cache()


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    preds = rng.uniform(size=(n, NUM_CLASSES)).astype(np.float32)
    target = rng.integers(0, NUM_CLASSES, size=(n,)).astype(np.int64)
    return torch.from_numpy(preds), torch.from_numpy(target)


def _acc(**kw):
    return mt.Accuracy(num_classes=NUM_CLASSES, device="cpu", **kw)


def _record_accuracy(tmp_path, n_updates=2, **metric_kwargs):
    path = str(tmp_path / "manifest.json")
    wm.record_manifest(path)
    m = _acc(**metric_kwargs)
    preds, target = _batch()
    for _ in range(n_updates):
        m.update(preds, target)
    saved = wm.save_manifest()
    wm.stop_recording()
    return m, saved


def _fresh_start():
    engine.clear_cache()
    wm.reset_warmup_state()


# ---------------------------------------------------------------------------
# recording and the document
# ---------------------------------------------------------------------------
def test_record_save_load_round_trip(tmp_path):
    _, path = _record_accuracy(tmp_path)
    doc = wm.load_manifest(path)
    assert doc["version"] == wm.MANIFEST_VERSION
    assert doc["torch_version"] == torch.__version__ and "jax_version" not in doc
    entry = next(e for e in doc["entries"] if e["kind"] == "metric_update")
    assert entry["source"] == "Accuracy"
    assert entry["template"]
    assert entry["meta"]["dyn"] == {"_": {"mode": {"$enum": "DataType", "value": "multi-class"}}}
    # two identical dispatches record one program
    assert len(entry["programs"]) == 1 and entry["programs"][0]["variant"] == "exact"


def test_load_rejects_unknown_version(tmp_path):
    from metrics_tpu_torch.utils.exceptions import SchemaVersionError

    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"version": 99, "entries": []}))
    with pytest.raises(SchemaVersionError, match="NEWER build"):
        wm.load_manifest(str(path))


def test_load_upcasts_older_version_with_warning(tmp_path):
    path = tmp_path / "old.json"
    path.write_text(json.dumps({"version": 1, "entries": []}))
    with pytest.warns(RuntimeWarning, match="schema v1"):
        doc = wm.load_manifest(str(path))
    assert doc["version"] == wm.MANIFEST_VERSION


def test_save_needs_a_path(monkeypatch):
    monkeypatch.delenv(wm.ENV_VAR, raising=False)
    wm.record_manifest()
    with pytest.raises(ValueError, match=wm.ENV_VAR):
        wm.save_manifest()


def test_recording_off_by_default_and_costs_nothing():
    """With no manifest recording or loaded the engine's one flag is off."""
    assert cache._WARM_HOOKS is False
    m = _acc()
    m.update(*_batch())
    assert wm.warmup_report()["recording"]["programs"] == 0
    wm.record_manifest()
    assert cache._WARM_HOOKS is True
    wm.stop_recording()
    assert cache._WARM_HOOKS is False


def test_arg_codec_round_trip_keys_match():
    """A manifest's decoded inputs make the program key the live inputs make:
    shapes, dtypes, devices, scalars by value, dict order."""
    state = {"tp": torch.zeros(4, dtype=torch.int64), "total": torch.zeros((), dtype=torch.float32)}
    args = (torch.ones(8, 3), torch.arange(8), 0.5, None, True)
    kwargs = {"flag": 3, "b": "x"}
    fn_args = (state, args, kwargs, [torch.zeros(2, dtype=torch.bool)])
    specs = json.loads(json.dumps([wm._encode_obj(a) for a in fn_args], sort_keys=True))
    decoded = tuple(wm._decode_obj(s) for s in specs)
    assert wm.dispatch_key(decoded) == wm.dispatch_key(fn_args)
    assert list(decoded[0]) == ["tp", "total"] and list(decoded[2]) == ["flag", "b"]
    # the dtype, and a scalar's value, are part of the key
    assert wm.dispatch_key((torch.zeros(2, dtype=torch.int32),)) != wm.dispatch_key((torch.zeros(2, dtype=torch.int64),))
    assert wm.dispatch_key((0.5,)) != wm.dispatch_key((0.25,))
    with pytest.raises(wm._Unrecordable):
        wm._encode_obj(object())


def test_stable_digest_is_config_sensitive_and_instance_stable():
    a1, a2, b = _acc(), _acc(), mt.Accuracy(num_classes=NUM_CLASSES + 1, device="cpu")
    assert wm.stable_digest(a1) == wm.stable_digest(a2)
    assert wm.stable_digest(a1) != wm.stable_digest(b)
    # a served instance digests as it was keyed: what its first update
    # learned (Accuracy.mode) does not move it away from a fresh template
    a1.update(*_batch())
    assert a1.mode is not None
    assert wm.stable_digest(a1) == wm.stable_digest(a2)
    # the digest differs from the JAX package's by the class path
    assert wm.stable_digest(a2) != jwm.stable_digest(mj.Accuracy(num_classes=NUM_CLASSES))


# ---------------------------------------------------------------------------
# warm dispatch
# ---------------------------------------------------------------------------
def test_warmed_first_request_compiles_nothing(tmp_path):
    recorded, path = _record_accuracy(tmp_path)
    expected = recorded.compute()
    _fresh_start()
    report = wm.warmup(path)
    assert report["programs_warmed"] == 1 and report["programs_failed"] == 0, report["errors"]

    fresh = _acc()
    preds, target = _batch()
    fresh.update(preds, target)
    fresh.update(preds, target)
    stats = fresh.compile_stats()
    assert stats["compiles"] == 0 and stats["cache_hits"] == 2, stats
    assert wm.warmup_report()["warmed_hits"] == 2
    assert torch.equal(fresh.compute(), expected)
    assert wm.warmup_report()["stale_total"] == 0
    assert engine.cache_summary()["warmed_programs"] == 1


def test_warmed_and_cold_workers_agree(tmp_path):
    """A warmed worker and a cold one (the JAX package's two slow
    cold-start tests): the same values bit for bit; the cold one makes its
    program at the first request, the warmed one made it at warmup."""
    _, path = _record_accuracy(tmp_path, jit_bucket="pow2")
    _fresh_start()
    cold = _acc(jit_bucket="pow2")
    for n in (3, 4, 7):
        cold.update(*_batch(n=n, seed=n))
    assert cold.compile_stats()["compiles"] == 2  # buckets 4 and 8: the recorded 4 and a new one
    _fresh_start()
    wm.warmup(path)
    warm = _acc(jit_bucket="pow2")
    for n in (3, 4, 7):
        with pytest.warns(RuntimeWarning, match="stale") if n == 7 else contextlib.nullcontext():
            warm.update(*_batch(n=n, seed=n))
    assert warm.compile_stats()["compiles"] == 1  # only the bucket the manifest never saw
    assert wm.warmup_report()["stale"][0]["changed"] == ["avals", "bucket"]
    for name, value in cold._snapshot_state().items():
        assert torch.equal(warm._snapshot_state()[name], value), name


def test_warmup_accepts_explicit_templates(tmp_path):
    _, path = _record_accuracy(tmp_path)
    doc = wm.load_manifest(path)
    for entry in doc["entries"]:
        entry["template"] = None
    _fresh_start()
    report = wm.warmup(dict(doc))
    assert report["programs_warmed"] == 0 and report["skipped"].get("no_template", 0) > 0
    wm.reset_warmup_state()
    report = wm.warmup(dict(doc), templates=[_acc()])
    assert report["programs_warmed"] == 1


def test_warmup_emits_bus_events(tmp_path):
    _, path = _record_accuracy(tmp_path, n_updates=1)
    _fresh_start()
    with obs.bus.capture(kinds=("warmup",)) as events:
        wm.warmup(path)
    kinds = [e.data.get("event") for e in events]
    assert "program" in kinds and "complete" in kinds


def test_bucketed_programs_warm_per_bucket(tmp_path):
    path = str(tmp_path / "manifest.json")
    wm.record_manifest(path)
    m = _acc(jit_bucket="pow2")
    m.update(*_batch(n=5))  # bucket 8
    m.update(*_batch(n=3))  # bucket 4
    m.update(*_batch(n=7))  # bucket 8 again: the same program
    wm.save_manifest()
    wm.stop_recording()
    states = {n: v.clone() for n, v in m._snapshot_state().items()}
    doc = wm.load_manifest(path)
    assert sorted(p["bucket"] for p in doc["entries"][0]["programs"]) == [4, 8]

    _fresh_start()
    wm.warmup(path)
    fresh = _acc(jit_bucket="pow2")
    for n in (5, 3, 7):
        fresh.update(*_batch(n=n))
    assert fresh.compile_stats()["compiles"] == 0
    assert wm.warmup_report()["stale_total"] == 0
    for n, v in fresh._snapshot_state().items():
        assert torch.equal(v, states[n]), n


def _pair(pkg, **kw):
    return pkg.MetricCollection(
        {"acc": pkg.Accuracy(num_classes=NUM_CLASSES, **kw), "prec": pkg.Precision(num_classes=NUM_CLASSES, **kw)}
    )


def test_fused_collection_warms(tmp_path):
    path = str(tmp_path / "manifest.json")
    wm.record_manifest(path)
    mc = _pair(mt, device="cpu")
    preds, target = _batch(n=8)
    mc.update(preds, target)
    expected = mc.compute()
    wm.save_manifest()
    wm.stop_recording()

    _fresh_start()
    report = wm.warmup(path)
    assert report["programs_warmed"] >= 2  # fused_update + fused_compute
    fresh = _pair(mt, device="cpu")
    fresh.update(preds, target)
    out = fresh.compute()
    assert fresh._compile_stats["compiles"] == 0, fresh._compile_stats
    for key, value in expected.items():
        assert torch.equal(out[key], value)


def test_bank_warms_from_manifest(tmp_path):
    """A bank's entries warm on the live bank only; its values equal the
    cold bank's and the JAX package's bank."""
    from metrics_tpu.serving import MetricBank as JBank

    path = str(tmp_path / "manifest.json")
    wm.record_manifest(path)
    bank = MetricBank(_acc(jit_bucket="pow2"), capacity=4)
    preds, target = _batch(n=5, seed=3)
    bank.apply_batch([(t, (preds, target)) for t in range(4)])
    expected = bank.compute(0)
    wm.save_manifest()
    wm.stop_recording()

    _fresh_start()
    report = wm.warmup(path)  # no live bank: its programs cannot warm from the recipe
    assert report["skipped"].get("bank_needs_live_bank") == 1
    fresh = MetricBank(_acc(jit_bucket="pow2"), capacity=4)
    report = fresh.warmup(path)
    assert report["programs_warmed"] >= 1 and report["programs_failed"] == 0, report
    assert fresh.occupancy == 0  # warming admits no tenant
    fresh.apply_batch([(t, (preds, target)) for t in range(4)])
    assert fresh._template._compile_stats["compiles"] == 0, fresh._template._compile_stats
    assert wm.warmup_report()["warmed_hits"] >= 1
    assert torch.equal(fresh.compute(0), expected)
    jbank = JBank(mj.Accuracy(num_classes=NUM_CLASSES, jit_bucket="pow2"), capacity=4)
    jbank.apply_batch([(t, (jnp.asarray(preds.numpy()), jnp.asarray(target.numpy()))) for t in range(4)])
    np.testing.assert_allclose(fresh.compute(0).numpy(), np.asarray(jbank.compute(0)), rtol=1e-6)


def test_driver_programs_warm(tmp_path):
    path = str(tmp_path / "manifest.json")
    wm.record_manifest(path)
    rng = np.random.RandomState(0)
    epoch = (torch.from_numpy(rng.rand(4, 8, NUM_CLASSES).astype(np.float32)), torch.from_numpy(rng.randint(0, NUM_CLASSES, (4, 8))))
    m = _acc()
    engine.drive(m, epoch, steps_per_chunk=2)
    wm.save_manifest()
    wm.stop_recording()
    _fresh_start()
    assert wm.warmup(path)["programs_warmed"] == 1
    fresh = _acc()
    engine.drive(fresh, epoch, steps_per_chunk=2)
    assert engine.cache_summary()["by_kind"]["driver"]["compiles"] == 1  # the warm run's, none at serve time
    assert torch.equal(fresh.compute(), m.compute())


def _enc_apply(params, x):
    return x @ params["w"]


def test_encoder_warms_from_a_live_template(tmp_path, monkeypatch):
    """An encoder's weights never enter the manifest's programs; it warms
    from a live template matched by its digest, or from its embedded pickle
    (at most 16 MB) when its apply function's module is admitted. A recipe
    whose apply function lives outside the admitted packages is refused, as
    every foreign class is."""
    from metrics_tpu_torch.encoders import ShardedEncoder

    rng = np.random.RandomState(0)
    enc = ShardedEncoder(_enc_apply, {"w": torch.from_numpy(rng.rand(6, 3).astype(np.float32))}, name="mlp")
    x = torch.from_numpy(rng.rand(5, 6).astype(np.float32))
    path = str(tmp_path / "manifest.json")
    wm.record_manifest(path)
    expected = enc(x)
    enc.encode_into(lambda carry, feats, valid: carry + feats.sum(), torch.zeros(()), (x,), torch.ones(5))
    wm.save_manifest()
    wm.stop_recording()
    assert wm.warmup_report()["recording"]["unrecordable"] == {"encoder_consumer_bound": 1}
    doc = wm.load_manifest(path)
    (entry,) = doc["entries"]
    assert entry["kind"] == "encode" and entry["digest"] == enc.stable_digest()
    _fresh_start()
    report = wm.warmup(path)
    assert report["skipped"] == {"no_template": 1}
    wm.reset_warmup_state()
    other = ShardedEncoder(_enc_apply, {"w": torch.from_numpy(rng.rand(6, 3).astype(np.float32))}, name="mlp")
    assert wm.warmup(path, templates=[other])["programs_warmed"] == 1
    served = ShardedEncoder(_enc_apply, enc.params, name="mlp")
    got = served(x)
    assert served.compile_stats()["compiles"] == 0 and torch.equal(got, expected)
    assert wm.warmup_report()["warmed_hits"] == 1
    # the recipe, with this module admitted: the pickled encoder warms alone
    _fresh_start()
    monkeypatch.setattr(wm, "_ALLOWED_ROOTS", wm._ALLOWED_ROOTS + (__name__.split(".")[0],))
    assert wm.warmup(path)["programs_warmed"] == 1
    again = ShardedEncoder(_enc_apply, enc.params, name="mlp")
    assert torch.equal(again(x), expected) and again.compile_stats()["compiles"] == 0


# ---------------------------------------------------------------------------
# staleness
# ---------------------------------------------------------------------------
def test_stale_manifest_names_changed_component(tmp_path):
    _, path = _record_accuracy(tmp_path)
    _fresh_start()
    obs.reset_warn_once()
    wm.warmup(path)
    fresh = _acc()
    fresh.update(*_batch())
    assert wm.warmup_report()["stale_total"] == 0
    with obs.bus.capture(kinds=("warmup_stale",)) as events:
        with pytest.warns(RuntimeWarning, match="warmup manifest stale"):
            fresh.update(*_batch(n=9))
    report = wm.warmup_report()
    assert report["stale_total"] == 1
    assert report["stale"][0]["changed"] == ["avals"]
    assert "(9," in report["stale"][0]["detail"]
    assert len(events) == 1 and events[0].data["explain"]["changed"] == ["avals"]
    assert events[0].source == "Accuracy"


def test_uncovered_entries_never_flag_stale(tmp_path):
    _, path = _record_accuracy(tmp_path)
    _fresh_start()
    wm.warmup(path)
    other = mt.Accuracy(num_classes=NUM_CLASSES + 2, device="cpu")
    rng = np.random.default_rng(5)
    other.update(
        torch.from_numpy(rng.uniform(size=(4, NUM_CLASSES + 2)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, NUM_CLASSES + 2, size=(4,))),
    )
    assert wm.warmup_report()["stale_total"] == 0


# ---------------------------------------------------------------------------
# surfaces, and the JAX package's
# ---------------------------------------------------------------------------
def test_report_in_snapshot_and_prometheus(tmp_path):
    _, path = _record_accuracy(tmp_path, n_updates=1)
    _fresh_start()
    wm.warmup(path)
    snap = obs.snapshot()
    assert snap["warmup"] == wm.warmup_report()
    assert snap["warmup"]["programs_warmed"] > 0
    assert "warmup" not in obs.export.UNPORTED_SECTIONS
    assert snap["engine"]["persistent_cache"] == persist.persistent_cache_stats()
    # the JAX report's keys, down to the recorder's
    jreport = jwm.warmup_report()
    assert set(snap["warmup"]) == set(jreport)
    assert set(snap["warmup"]["recording"]) == set(jreport["recording"])
    text = obs.prometheus_text()
    assert "metrics_tpu_warmup_manifest_loaded 1" in text
    assert "metrics_tpu_warmup_stale_total 0" in text
    assert engine.cache_summary()["warmed_programs"] > 0
    # the JAX package's warmup and persistent-cache family names
    from metrics_tpu import obs as jobs

    def families(txt, prefixes):
        return {line.split()[2] for line in txt.splitlines() if line.startswith("# TYPE") and line.split()[2].startswith(prefixes)}

    prefixes = ("metrics_tpu_warmup_", "metrics_tpu_engine_persistent")
    assert families(text, prefixes) == families(jobs.prometheus_text(), prefixes)


def test_same_traffic_records_the_same_programs_in_both_packages(tmp_path):
    """One metric's updates, one collection's fused forward and compute,
    and a one-metric bank's wave, recorded by both packages: the same entry
    kinds with the same program counts, and each program's inputs hold the
    same batch shapes."""
    from metrics_tpu.serving import MetricBank as JBank

    preds, target = _batch(n=8)
    jp, jt = jnp.asarray(preds.numpy()), jnp.asarray(target.numpy())
    recorded = {}
    for pkg, rec, p, t, kw, bank_cls in ((mt, wm, preds, target, {"device": "cpu"}, MetricBank), (mj, jwm, jp, jt, {}, JBank)):
        rec.record_manifest(str(tmp_path / f"{pkg.__name__}.json"))
        m = pkg.Accuracy(num_classes=NUM_CLASSES, **kw)
        m.update(p, t)
        m.update(p[:5], t[:5])
        mc = _pair(pkg, **kw)
        mc(p, t)
        mc.compute()
        bank = bank_cls(pkg.Accuracy(num_classes=NUM_CLASSES, **kw), capacity=4)
        bank.apply_batch([(i, (p, t)) for i in range(4)])
        rec.stop_recording()
        recorded[pkg.__name__] = rec.manifest_dict()

    def summary(doc):
        out = {}
        for e in doc["entries"]:
            shapes = sorted(sorted(_shapes(p["args"], keep=(8, 5))) for p in e["programs"])
            out.setdefault(e["kind"], []).append((len(e["programs"]), shapes))
        return {k: sorted(v) for k, v in out.items()}

    assert summary(recorded["metrics_tpu_torch"]) == summary(recorded["metrics_tpu"])


def _shapes(specs, keep):
    """The shapes of the recorded tensors whose leading axis is a batch (or
    a wave's request axis and batch) of ``keep`` rows."""
    out = []

    def walk(spec):
        if "a" in spec:
            shape = tuple(spec["a"][0])
            if shape and (shape[0] in keep or (len(shape) > 1 and shape[1] in keep)):
                out.append(shape)
        for key in ("t", "l"):
            for x in spec.get(key, ()):
                walk(x)
        for x in spec.get("d", {}).values():
            walk(x)

    for s in specs:
        walk(s)
    return out


def test_jax_manifest_templates_are_refused_by_name(tmp_path):
    """A JAX-recorded manifest warms nothing in the port: the restricted
    unpickler refuses ``metrics_tpu`` by name before importing anything of
    it, and every entry is skipped as ``no_template``."""
    path = str(tmp_path / "jax.json")
    jwm.record_manifest(path)
    jm = mj.Accuracy(num_classes=NUM_CLASSES)
    jm.update(jnp.asarray(_batch()[0].numpy()), jnp.asarray(_batch()[1].numpy()))
    jwm.save_manifest()
    jwm.stop_recording()
    doc = json.load(open(path))
    blob = next(e["template"] for e in doc["entries"] if e["kind"] == "metric_update")
    with pytest.raises(pickle.UnpicklingError, match=r"metrics_tpu\.classification"):
        wm._unpickle_template(blob)
    unpickler = wm._RestrictedUnpickler(__import__("io").BytesIO(b""))
    for module, name in (("metrics_tpu.classification.accuracy", "Accuracy"), ("jax._src.array", "ArrayImpl"), ("os", "system")):
        with pytest.raises(pickle.UnpicklingError, match=module.split(".")[0]):
            unpickler.find_class(module, name)
    assert unpickler.find_class("metrics_tpu_torch.classification.accuracy", "Accuracy") is mt.Accuracy
    report = wm.warmup(path)
    assert report["programs_warmed"] == 0 and report["skipped"] == {"no_template": len(doc["entries"])}


def test_repeated_warmup_reports_stable_counters(tmp_path):
    _, path = _record_accuracy(tmp_path)
    _fresh_start()
    first = wm.warmup(path)
    again = wm.warmup(path)
    for key in ("manifest_entries", "manifest_programs", "entries_warmed", "programs_warmed"):
        assert again[key] == first[key], key
    assert again["programs_warmed"] == again["manifest_programs"]


def test_warmup_validates_dict_manifests():
    with pytest.warns(RuntimeWarning, match="cold-compile"):
        report = wm.warmup({"version": 99, "entries": []})
    assert report["skipped"].get("manifest_version_skew") == 1
    with pytest.raises(ValueError, match="entry list"):
        wm.warmup({"version": wm.MANIFEST_VERSION})


def test_explicit_template_matching_probes_a_clone_not_the_caller(tmp_path):
    _, path = _record_accuracy(tmp_path)
    doc = wm.load_manifest(path)
    for entry in doc["entries"]:
        entry["template"] = None
    _fresh_start()
    bystander = mt.Accuracy(num_classes=NUM_CLASSES + 3, device="cpu")
    match = _acc()
    report = wm.warmup(dict(doc), templates=[bystander, match])
    assert report["programs_warmed"] > 0
    for caller in (bystander, match):
        assert not caller.__dict__.get("_engine_probed", False)
        assert caller.mode is None and "_engine_key" not in caller.__dict__


@pytest.mark.parametrize(
    "entry",
    [e for e in json.load(open(os.path.join(GOLDEN, "index.json")))["artifacts"] if e["family"] == "manifest"],
    ids=lambda e: e["file"],
)
def test_golden_manifest_artifacts_decode_through_the_port_schema(entry):
    from metrics_tpu.resilience import schema as jschema
    from metrics_tpu_torch.resilience import schema
    from metrics_tpu_torch.utils.exceptions import SchemaVersionError

    with open(os.path.join(GOLDEN, entry["file"])) as fh:
        doc = json.load(fh)
    assert schema.registered_versions("manifest") == jschema.registered_versions("manifest") == [1, 2]
    if entry["expect"] == "ok":
        got = schema.decode_any("manifest", doc, context=" (golden)")
        assert got == jschema.decode_any("manifest", doc, context=" (golden)")
        assert got["version"] == 2
        return
    with pytest.raises(SchemaVersionError, match="NEWER build") as exc:
        schema.decode_any("manifest", doc, context=" (golden)")
    assert (exc.value.family, exc.value.version, exc.value.current) == ("manifest", 99, 2)


_CHILD = r"""
import json, sys
import numpy as np, torch
import metrics_tpu_torch as mt
wm = sys.modules["metrics_tpu_torch.engine.warmup"]
rng = np.random.default_rng(0)
m = mt.Accuracy(num_classes=4, device="cpu")
m.update(torch.from_numpy(rng.uniform(size=(8, 4)).astype(np.float32)), torch.from_numpy(rng.integers(0, 4, size=(8,))))
r = wm.warmup_report()
print(json.dumps({"value": float(m.compute()), "compiles": m.compile_stats()["compiles"], "warmed": r["programs_warmed"],
                  "stale": r["stale_total"], "hits": r["warmed_hits"], "jax": "metrics_tpu" in sys.modules}))
"""


def _run_child(manifest):
    env = dict(os.environ, PYTHONPATH=REPO, **{wm.ENV_VAR: manifest})
    env.pop(persist.ENV_VAR, None)
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    return json.loads([line for line in out.stdout.splitlines() if line.startswith("{")][-1])


def test_env_wiring_records_then_warms(tmp_path):
    """With ``METRICS_TPU_WARMUP_MANIFEST`` set the port records a missing
    manifest and saves it at exit, and warms an existing one at import, in
    processes that import nothing of the JAX package."""
    manifest = str(tmp_path / "env_manifest.json")
    first = _run_child(manifest)
    assert os.path.exists(manifest)
    assert first["warmed"] == 0 and first["compiles"] == 1 and not first["jax"]
    second = _run_child(manifest)
    assert second["warmed"] == 1 and second["compiles"] == 0 and second["hits"] == 1, second
    assert second["stale"] == 0 and second["value"] == first["value"] and not second["jax"]


def test_autowire_under_monkeypatch(tmp_path, monkeypatch):
    """The wiring called in this process: a missing manifest starts the
    recorder, an existing one is warmed."""
    path = str(tmp_path / "m.json")
    monkeypatch.setenv(wm.ENV_VAR, path)
    wm._maybe_autowire_from_env()
    assert wm.recording() and wm.warmup_report()["recording"]["path"] == path
    _acc().update(*_batch())
    wm._save_at_exit()
    wm.stop_recording()
    _fresh_start()
    wm._maybe_autowire_from_env()
    assert wm.warmup_report()["programs_warmed"] == 1


# ---------------------------------------------------------------------------
# the persistent kernel cache
# ---------------------------------------------------------------------------
@pytest.fixture
def _persist_state():
    saved = dict(persist._STATE)
    yield
    persist._STATE.clear()
    persist._STATE.update(saved)


def test_enable_requires_a_path(monkeypatch, _persist_state):
    monkeypatch.delenv(persist.ENV_VAR, raising=False)
    with pytest.raises(ValueError, match=persist.ENV_VAR):
        persist.enable_persistent_cache()


def test_enable_points_the_build_at_the_cache_dir(tmp_path, _persist_state):
    from metrics_tpu_torch.ops import _build

    default = _build._library_path()
    assert default.parent == _build.BUILD_DIR
    path = persist.enable_persistent_cache(str(tmp_path / "kc"))
    assert os.path.isdir(path) and persist.persistent_cache_enabled()
    assert _build._library_path() == type(default)(path) / default.name  # the same hash, the cache's directory
    stats = persist.persistent_cache_stats()
    assert stats["enabled"] and stats["path"] == path and stats["persistent_hits"] == stats["persistent_misses"] == 0
    assert engine.cache_summary()["persistent_cache"] == stats
    assert set(stats) == set(ej.persistent_cache_stats())  # the JAX package's keys


def test_env_var_wiring(tmp_path, monkeypatch, _persist_state):
    path = str(tmp_path / "envkc")
    monkeypatch.setenv(persist.ENV_VAR, path)
    persist._maybe_enable_from_env()
    assert persist.persistent_cache_stats()["path"] == os.path.abspath(path)
    monkeypatch.setenv(persist.ENV_VAR, "/proc/no/such/dir")
    with pytest.warns(RuntimeWarning, match=persist.ENV_VAR):
        persist._maybe_enable_from_env()


def test_reused_library_is_a_persistent_hit(tmp_path, _persist_state):
    """A library already in the cache directory loads without ``nvcc``:
    one ``persistent_hit`` and a ``compile`` event tagged as one."""
    from metrics_tpu_torch.ops import _build

    persist.enable_persistent_cache(str(tmp_path / "kc"))
    so = _build._library_path()
    so.write_bytes(b"")  # stands in for a library an earlier process built
    with obs.bus.capture(kinds=("compile",)) as events:
        assert _build.build() == so
    assert _build.last_build_seconds == 0.0
    stats = persist.persistent_cache_stats()
    assert stats["persistent_hits"] == 1 and stats["persistent_misses"] == 0
    (event,) = events
    assert event.source == "persistent_cache" and event.data["persistent_hit"] is True
    assert "metrics_tpu_engine_persistent_hits 1" in obs.prometheus_text()


def test_failed_build_raises_and_counts_nothing(tmp_path, monkeypatch, _persist_state):
    from metrics_tpu_torch.ops import _build

    persist.enable_persistent_cache(str(tmp_path / "kc"))

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    stats = persist.persistent_cache_stats()
    assert stats["persistent_hits"] == stats["persistent_misses"] == 0
