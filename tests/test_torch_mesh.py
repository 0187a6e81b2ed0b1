"""The port's sharded state plane across processes, against ``metrics_tpu``.

One world per module: four gloo ranks on the CPU, each a process of this
file, laid out as a ``(2, 2)`` ``DeviceMesh`` with dims ``("dp", "mp")``
(and, for the hierarchical cases, ``("host", "local")`` and ``("i",)``).
Every rank is given the same whole inputs (the SPMD contract), runs every
case and saves its results; the parent holds them against ``metrics_tpu``
on a ``(2, 2)`` mesh of the JAX virtual CPU devices, on the same numpy
inputs. Counts and shard contents must match bit for bit (each rank's shard
against its slice of the JAX array), FID within 1e-6 relative of the JAX
sharded value and within ``NEWTON_SCHULZ_FID_RTOL`` of the host eigh value,
hierarchical integer reductions bit for bit against flat, means within
1e-6. Every worker runs under a wall-clock limit and is killed past it.
"""
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 150
WORLD = 4
C = 8  # classes: 4 rows per mp shard
C_ML = 12  # multilabel classes: 6 per mp shard
STEPS, BATCH = 6, 16  # 8 rows per dp shard
FID_D = 8


def _inputs(seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    health = rng.rand(STEPS, BATCH, C).astype(np.float32)
    health[1, :3, 0] = np.nan  # contaminated rows of one step, all in dp shard 0
    health[4, 5, 2] = np.inf
    health[2, 12, 1] = np.nan  # and one in dp shard 1
    return {
        "preds": rng.randint(0, C, size=(STEPS, BATCH)).astype(np.int32),
        "target": rng.randint(0, C, size=(STEPS, BATCH)).astype(np.int32),
        "ml_preds": rng.rand(4, 8, C_ML).astype(np.float32),
        "ml_target": rng.randint(0, 2, size=(4, 8, C_ML)).astype(np.int32),
        "health": health,
        "fid_real": rng.rand(300, FID_D).astype(np.float32),
        "fid_fake": (rng.rand(400, FID_D) * 1.1 + 0.05).astype(np.float32),
        "reduce_int": (np.arange(WORLD * 16, dtype=np.int32).reshape(WORLD, 16) * 1000003),
        "reduce_minmax": rng.randint(-(2**30), 2**30, size=(WORLD, 5)).astype(np.int32),
        "reduce_float": rng.normal(size=(WORLD, 4)).astype(np.float32),
        "reduce_cat": np.arange(WORLD * 2, dtype=np.float32).reshape(WORLD, 2),
        "drive_sum": np.arange(16 * 4, dtype=np.float32).reshape(16, 4),
    }


def _stack_sum(stacked):
    return stacked.sum(0)


# ---------------------------------------------------------------------------
# the worker: one rank of the world
# ---------------------------------------------------------------------------
def _cm_cases(mt, engine, P, mesh, x, t) -> dict:
    from metrics_tpu_torch.utils.exceptions import MetricsUserError

    out = {}
    preds, target = t(x["preds"]), t(x["target"])
    sh = mt.ConfusionMatrix(num_classes=C, class_sharding="mp", device="cpu")
    res = engine.drive(sh, (preds, target), mesh=mesh, in_specs=P(None, "dp"))
    out["cm_fused"] = res.fused_keys
    out["confmat"] = sh.confmat.clone()
    out["cm_compute"] = sh.compute()
    out["cm_spec"] = mt.sharding.spec_of_value(sh.sharded_state("confmat"))
    out["cm_resident"] = mt.sharding.shard_stats()["resident"]["ConfusionMatrix.confmat"]
    out["cm_drive_synced"] = sh._drive_synced
    try:
        sh.update(preds[0], target[0])
        out["cm_update_after"] = "no error"
    except MetricsUserError as err:
        out["cm_update_after"] = str(err)
    # the checkpoint tree is global; a restored metric driven again keeps accumulating, sharded
    from metrics_tpu_torch.utils.checkpoint import metric_state_pytree, restore_metric_state_pytree

    tree = metric_state_pytree(sh)
    out["ckpt_confmat"] = tree["confmat"]
    fresh = mt.ConfusionMatrix(num_classes=C, class_sharding="mp", device="cpu")
    # placed, it restores its shard of the global tree; unplaced, every rank
    # would hold the whole global state and its host sync would add them up
    fresh.shard_states(mesh)
    restore_metric_state_pytree(fresh, tree)
    out["ckpt_compute"] = fresh.compute()
    engine.drive(fresh, (preds, target), mesh=mesh, in_specs=P(None, "dp"))
    out["ckpt_twice"] = fresh.confmat.clone()
    # reset re-places the defaults
    sh.reset()
    out["reset_shape"] = tuple(sh.confmat.shape)
    out["reset_sum"] = int(sh.confmat.sum())
    out["reset_spec"] = mt.sharding.spec_of_value(sh.sharded_state("confmat"))

    def driver_compiles():
        return engine.cache_summary()["by_kind"].get("driver", {}).get("compiles", 0)

    engine.clear_cache()
    ref = mt.ConfusionMatrix(num_classes=C, device="cpu")
    before = driver_compiles()
    engine.drive(ref, (preds, target))
    unsharded = driver_compiles() - before
    a = mt.ConfusionMatrix(num_classes=C, class_sharding="mp", device="cpu")
    before = driver_compiles()
    engine.drive(a, (preds, target), mesh=mesh, in_specs=P(None, "dp"))
    sharded = driver_compiles() - before
    before = driver_compiles()
    engine.drive(a, (preds, target), mesh=mesh, in_specs=P(None, "dp"))
    repeat = driver_compiles() - before
    clone = a.clone()
    out["clone_mesh"] = clone._shard_mesh
    out["clone_confmat"] = clone.confmat.clone()
    clone.reset()
    before = driver_compiles()
    engine.drive(clone, (preds, target), mesh=mesh, in_specs=P(None, "dp"))
    out["compiles"] = (unsharded, sharded, repeat, driver_compiles() - before)

    ml = mt.ConfusionMatrix(num_classes=C_ML, multilabel=True, class_sharding="mp", device="cpu")
    engine.drive(ml, (t(x["ml_preds"]), t(x["ml_target"])), mesh=mesh, in_specs=P(None, "dp"))
    out["ml_confmat"] = ml.confmat.clone()
    out["ml_compute"] = ml.compute()
    return out


def _stat_cases(mt, engine, P, mesh, x, t) -> dict:
    out = {}
    preds, target = t(x["preds"]), t(x["target"])
    ss = mt.StatScores(reduce="macro", num_classes=C, class_sharding="mp", device="cpu")
    engine.drive(ss, (preds, target), mesh=mesh, in_specs=P(None, "dp"))
    for name in ("tp", "fp", "tn", "fn"):
        out[name] = getattr(ss, name).clone()
    out["ss_compute"] = ss.compute()
    out["ss_specs"] = {n: mt.sharding.spec_of_value(ss.sharded_state(n)) for n in ("tp", "fp", "tn", "fn")}
    for policy in ("skip", "mask"):
        m = mt.StatScores(reduce="macro", num_classes=C, class_sharding="mp", on_bad_input=policy, device="cpu")
        engine.drive(m, (t(x["health"]), target), mesh=mesh, in_specs=P(None, "dp"))
        report = m.health_report()
        out[f"health_{policy}"] = (
            m.compute(),
            {k: report[k] for k in ("nan_count", "inf_count", "rows_masked", "updates_quarantined")},
        )
    coll = mt.MetricCollection(
        {
            "cm": mt.ConfusionMatrix(num_classes=C, class_sharding="mp", device="cpu"),
            "ss": mt.StatScores(reduce="macro", num_classes=C, class_sharding="mp", device="cpu"),
        }
    )
    res = engine.drive(coll, (preds, target), mesh=mesh, in_specs=P(None, "dp"))
    out["coll_fused"] = tuple(sorted(res.fused_keys))
    out["coll_compute"] = coll.compute()
    return out


def _fid_cases(mt, mesh, x, t) -> dict:
    dp = mesh.get_local_rank("dp")
    real, fake = t(x["fid_real"]), t(x["fid_fake"])
    fid = mt.FrechetInceptionDistance(feature=lambda z: z.float(), feature_dim=FID_D, feature_sharding="mp", device="cpu")
    fid.shard_states(mesh)
    # the processes of one mp group feed the same batches; the dp groups split them
    fid.update(real.chunk(2)[dp], real=True)
    fid.update(fake.chunk(2)[dp], real=False)
    return {
        "fid": float(fid.compute()),
        "fid_sqrt": fid._resolved_sqrt(),
        "fid_outer_shape": tuple(fid.real_outer.shape),
        "fid_spec": mt.sharding.spec_of_value(fid.sharded_state("real_outer")),
    }


def _reduce_cases(mt, x, t) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from metrics_tpu_torch.parallel import comm

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("host", "local"))
    r = comm.axis_index(mesh, ("host", "local"))
    out = {}
    cases = {
        "sum": ("reduce_int", "sum"),
        "max": ("reduce_minmax", "max"),
        "min": ("reduce_minmax", "min"),
        "mean": ("reduce_float", "mean"),
        "cat": ("reduce_cat", "cat"),
        "none": ("reduce_float", None),
        "callable": ("reduce_float", _stack_sum),
    }
    with comm.axis_env(mesh):
        for name, (key, fx) in cases.items():
            row = t(x[key][r])
            out[f"reduce_{name}"] = tuple(
                comm.reduce_in_trace(row, fx, ("host", "local"), hierarchical=h) for h in (False, True)
            )
        try:
            comm.reduce_in_trace(t(x["reduce_float"][r]), "median", ("host", "local"), state="acc.tp")
        except ValueError as err:
            out["reduce_error"] = str(err)
        try:
            comm.sync_state_trees({"m": {"bad": t(x["reduce_float"][r])}}, {"m": {"bad": "median"}}, ("host", "local"))
        except ValueError as err:
            out["trees_error"] = str(err)
        # the pure sync API of a metric and of a collection over the named axes
        s = mt.SumMetric(nan_strategy="disable", device="cpu")
        state = s.update_state(s.init_state(), t(x["reduce_float"][r]))
        out["metric_sync"] = s.sync_state(state, ("host", "local"))["value"]
        coll = mt.MetricCollection({"sum": mt.SumMetric(nan_strategy="disable", device="cpu"), "max": mt.MaxMetric(nan_strategy="disable", device="cpu")})
        states = coll.update_state(coll.init_state(), t(x["reduce_float"][r]))
        synced = coll.sync_state(states, ("host", "local"), hierarchical=True)
        out["coll_sync"] = {k: v["value"] for k, v in synced.items()}

    from metrics_tpu_torch import engine

    batches = (t(x["drive_sum"]),)
    for name, shape, axis, hier in (
        ("i", (4,), "i", False),
        ("flat", (2, 2), ("host", "local"), False),
        ("hier", (2, 2), ("host", "local"), True),
    ):
        names = ("i",) if shape == (4,) else ("host", "local")
        m_mesh = mesh if shape == (2, 2) else init_device_mesh("cpu", shape, mesh_dim_names=names)
        m = mt.SumMetric(nan_strategy="disable", device="cpu")
        engine.drive(m, batches, mesh=m_mesh, axis_name=axis, hierarchical_sync=hier)
        out[f"drive_{name}"] = float(m.compute())
    single = init_device_mesh("cpu", (4,), mesh_dim_names=("i",))
    try:
        engine.drive(mt.MeanMetric(nan_strategy="disable", device="cpu"), batches, mesh=single, axis_name="i", hierarchical_sync=True)
    except ValueError as err:
        out["hier_single_error"] = str(err)
    return out


def _jax_state_dict_case(mt, mesh, x, t) -> dict:
    from metrics_tpu_torch.interop import state_from_jax

    sd = {"confmat": x["jax_cm_state"]}
    port = mt.ConfusionMatrix(num_classes=C, class_sharding="mp", device="cpu")
    port.shard_states(mesh)
    port.persistent(True)
    port.load_state_dict(state_from_jax(sd))
    return {"loaded_shard": port.confmat.clone(), "loaded_compute": port.compute()}


def _obs_case(mt, engine, P, mesh, x, t) -> dict:
    mt.sharding.reset_shard_stats()
    sh = mt.ConfusionMatrix(num_classes=C, class_sharding="mp", device="cpu")
    with mt.obs.capture() as events:
        engine.drive(sh, (t(x["preds"]), t(x["target"])), mesh=mesh, in_specs=P(None, "dp"))
    return {
        "obs_kinds": sorted({e.kind for e in events}),
        "obs_reshard": [e.data for e in events if e.kind == "reshard"],
        "obs_stats": mt.sharding.shard_stats(),
        "obs_snapshot": mt.obs.snapshot()["sharding"],
        "obs_prom": mt.obs.prometheus_text(),
    }


def _worker(rank: int, world: int, port: int, inputs_path: str, out_path: str) -> None:
    sys.path.insert(0, REPO)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import metrics_tpu_torch as mt
    from metrics_tpu_torch import engine
    from metrics_tpu_torch.sharding import PartitionSpec as P

    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank, timeout=timedelta(seconds=60)
    )
    x = dict(np.load(inputs_path))
    t = torch.from_numpy
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("dp", "mp"))
    results = {"coords": (mesh.get_local_rank("dp"), mesh.get_local_rank("mp"))}
    results.update(_cm_cases(mt, engine, P, mesh, x, t))
    results.update(_stat_cases(mt, engine, P, mesh, x, t))
    results.update(_fid_cases(mt, mesh, x, t))
    results.update(_reduce_cases(mt, x, t))
    results.update(_jax_state_dict_case(mt, mesh, x, t))
    results.update(_obs_case(mt, engine, P, mesh, x, t))
    torch.save(results, out_path)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: the world, and metrics_tpu on a (2, 2) mesh
# ---------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_mesh(names=("dp", "mp")):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), names)


def _jax_cm_state(x) -> np.ndarray:
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from metrics_tpu import ConfusionMatrix, engine

    cm = ConfusionMatrix(num_classes=C, class_sharding="mp")
    engine.drive(cm, (jnp.asarray(x["preds"]), jnp.asarray(x["target"])), mesh=_jax_mesh(), in_specs=JP(None, "dp"))
    cm.persistent(True)
    return np.asarray(cm.state_dict()["confmat"])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_world")
    x = _inputs()
    x["jax_cm_state"] = _jax_cm_state(x)
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **x)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs, paths = [], []
    for rank in range(WORLD):
        path = str(tmp / f"rank{rank}.pt")
        log = open(tmp / f"rank{rank}.log", "w+")
        cmd = [sys.executable, os.path.abspath(__file__), str(rank), str(WORLD), str(port), inputs, path]
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
    return x, [torch.load(p, weights_only=False) for p in paths]


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rows(full: np.ndarray, mp: int, n: int) -> np.ndarray:
    per = n // 2
    return full[mp * per:(mp + 1) * per]


@pytest.fixture(scope="module")
def jax_refs(world):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from metrics_tpu import ConfusionMatrix, MetricCollection, StatScores, engine

    x, _ = world
    mesh = _jax_mesh()
    preds, target = jnp.asarray(x["preds"]), jnp.asarray(x["target"])
    out = {}
    cm = ConfusionMatrix(num_classes=C, class_sharding="mp")
    engine.drive(cm, (preds, target), mesh=mesh, in_specs=JP(None, "dp"))
    out["confmat"] = np.asarray(cm.confmat)
    ml = ConfusionMatrix(num_classes=C_ML, multilabel=True, class_sharding="mp")
    engine.drive(ml, (jnp.asarray(x["ml_preds"]), jnp.asarray(x["ml_target"])), mesh=mesh, in_specs=JP(None, "dp"))
    out["ml_confmat"] = np.asarray(ml.confmat)
    ss = StatScores(reduce="macro", num_classes=C, class_sharding="mp")
    engine.drive(ss, (preds, target), mesh=mesh, in_specs=JP(None, "dp"))
    for name in ("tp", "fp", "tn", "fn"):
        out[name] = np.asarray(getattr(ss, name))
    out["ss_compute"] = np.asarray(ss.compute())
    for policy in ("skip", "mask"):
        m = StatScores(reduce="macro", num_classes=C, class_sharding="mp", on_bad_input=policy)
        engine.drive(m, (jnp.asarray(x["health"]), target), mesh=mesh, in_specs=JP(None, "dp"))
        report = m.health_report()
        out[f"health_{policy}"] = (
            np.asarray(m.compute()),
            {k: report[k] for k in ("nan_count", "inf_count", "rows_masked", "updates_quarantined")},
        )
    coll = MetricCollection(
        {
            "cm": ConfusionMatrix(num_classes=C, class_sharding="mp"),
            "ss": StatScores(reduce="macro", num_classes=C, class_sharding="mp"),
        }
    )
    engine.drive(coll, (preds, target), mesh=mesh, in_specs=JP(None, "dp"))
    out["coll_compute"] = {k: np.asarray(v) for k, v in coll.compute().items()}
    return out


def test_confusion_matrix_shards_match_jax_bit_for_bit(world, jax_refs):
    _, ranks = world
    for r in ranks:
        _, mp = r["coords"]
        assert r["cm_fused"] == ("_",)
        np.testing.assert_array_equal(_np(r["confmat"]), _rows(jax_refs["confmat"], mp, C))
        np.testing.assert_array_equal(_np(r["cm_compute"]), jax_refs["confmat"])
        assert r["cm_spec"] == ("mp",) and r["reset_spec"] == ("mp",)
        resident = r["cm_resident"]
        assert resident["per_device_bytes"] * 2 == resident["total_bytes"] and resident["devices"] == 4
        # the mesh spans processes: the state is global, host updates are refused
        assert r["cm_drive_synced"] and "globally-synced" in r["cm_update_after"]
        assert r["reset_shape"] == (C // 2, C) and r["reset_sum"] == 0


def test_multilabel_confusion_matrix_shards_match_jax(world, jax_refs):
    _, ranks = world
    for r in ranks:
        _, mp = r["coords"]
        np.testing.assert_array_equal(_np(r["ml_confmat"]), _rows(jax_refs["ml_confmat"], mp, C_ML))
        np.testing.assert_array_equal(_np(r["ml_compute"]), jax_refs["ml_confmat"])


def test_macro_stat_scores_shards_match_jax(world, jax_refs):
    _, ranks = world
    for r in ranks:
        _, mp = r["coords"]
        for name in ("tp", "fp", "tn", "fn"):
            np.testing.assert_array_equal(_np(r[name]), _rows(jax_refs[name], mp, C))
            assert r["ss_specs"][name] == ("mp",)
        np.testing.assert_array_equal(_np(r["ss_compute"]), jax_refs["ss_compute"])


@pytest.mark.parametrize("policy", ["skip", "mask"])
def test_health_policies_inside_the_sharded_drive_match_jax(world, jax_refs, policy):
    """A quarantine is a verdict on the whole batch although each dp rank
    holds half of it: the counts equal JAX's, bit for bit."""
    _, ranks = world
    want_value, want_report = jax_refs[f"health_{policy}"]
    for r in ranks:
        value, report = r[f"health_{policy}"]
        np.testing.assert_array_equal(_np(value), want_value)
        assert report == want_report, (policy, report, want_report)


def test_collection_sharded_drive_matches_jax(world, jax_refs):
    _, ranks = world
    for r in ranks:
        assert r["coll_fused"] == ("cm", "ss")
        for key, want in jax_refs["coll_compute"].items():
            np.testing.assert_array_equal(_np(r["coll_compute"][key]), want)


def test_repeat_and_clone_drives_run_no_new_program(world, jax_refs):
    _, ranks = world
    for r in ranks:
        unsharded, sharded, repeat, clone = r["compiles"]
        assert sharded == unsharded == 1 and repeat == 0 and clone == 0
        # a clone carries the global state (of two drives) and the annotations, not the mesh
        assert r["clone_mesh"] is None
        np.testing.assert_array_equal(_np(r["clone_confmat"]), 2 * jax_refs["confmat"])


def test_checkpoint_round_trip_then_second_drive_doubles(world, jax_refs):
    _, ranks = world
    for r in ranks:
        _, mp = r["coords"]
        np.testing.assert_array_equal(_np(r["ckpt_confmat"]), jax_refs["confmat"])
        np.testing.assert_array_equal(_np(r["ckpt_compute"]), jax_refs["confmat"])
        np.testing.assert_array_equal(_np(r["ckpt_twice"]), 2 * _rows(jax_refs["confmat"], mp, C))


def test_jax_class_sharded_state_dict_loads_into_each_shard(world, jax_refs):
    x, ranks = world
    np.testing.assert_array_equal(x["jax_cm_state"], jax_refs["confmat"])
    for r in ranks:
        _, mp = r["coords"]
        np.testing.assert_array_equal(_np(r["loaded_shard"]), _rows(jax_refs["confmat"], mp, C))
        np.testing.assert_array_equal(_np(r["loaded_compute"]), jax_refs["confmat"])


def test_feature_sharded_fid_matches_jax(world):
    import jax.numpy as jnp

    from metrics_tpu import FrechetInceptionDistance
    from metrics_tpu import sharding as jshd

    x, ranks = world

    def ext(z):
        return jnp.asarray(z, jnp.float32)

    sharded = FrechetInceptionDistance(feature=ext, feature_dim=FID_D, feature_sharding="mp")
    sharded.shard_states(_jax_mesh())
    host = FrechetInceptionDistance(feature=ext, feature_dim=FID_D)
    for m in (sharded, host):
        m.update(jnp.asarray(x["fid_real"]), real=True)
        m.update(jnp.asarray(x["fid_fake"]), real=False)
    v_sharded, v_host = float(sharded.compute()), float(host.compute())
    for r in ranks:
        assert r["fid_sqrt"] == "newton_schulz" and r["fid_spec"] == ("mp",)
        assert r["fid_outer_shape"] == (FID_D // 2, FID_D)
        assert abs(r["fid"] - v_sharded) <= 1e-6 * abs(v_sharded)
        assert abs(r["fid"] - v_host) <= jshd.NEWTON_SCHULZ_FID_RTOL * abs(v_host)


def _jax_reduce(x, fx, hierarchical):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from metrics_tpu.parallel import comm

    mesh = _jax_mesh(("host", "local"))
    out_spec = JP(("host", "local")) if fx == "cat" else JP()

    def f(shard):
        return comm.reduce_in_trace(shard[0], fx, ("host", "local"), hierarchical=hierarchical)

    return np.asarray(
        jax.shard_map(f, mesh=mesh, in_specs=(JP(("host", "local")),), out_specs=out_spec, check_vma=False)(jnp.asarray(x))
    )


@pytest.mark.parametrize(
    "name,key,fx",
    [
        ("sum", "reduce_int", "sum"),
        ("max", "reduce_minmax", "max"),
        ("min", "reduce_minmax", "min"),
        ("mean", "reduce_float", "mean"),
        ("cat", "reduce_cat", "cat"),
        ("none", "reduce_float", None),
        ("callable", "reduce_float", _stack_sum),
    ],
)
def test_reduce_in_trace_flat_and_hierarchical_match_jax(world, name, key, fx):
    x, ranks = world
    want = _jax_reduce(x[key], fx, False)
    if name == "cat":
        want = want.reshape(WORLD, -1)[0]  # every device's gather, concatenated by the out_spec
    for r in ranks:
        flat, hier = (_np(v) for v in r[f"reduce_{name}"])
        if name in ("sum", "max", "min"):
            # integers: staged is flat, bit for bit
            np.testing.assert_array_equal(hier, flat)
            np.testing.assert_array_equal(flat, want)
        elif name == "mean":
            np.testing.assert_allclose(hier, flat, rtol=1e-6)
            np.testing.assert_allclose(flat, want, rtol=1e-6)
        else:
            # cat keeps the flat rank-major order; None and callables run flat
            np.testing.assert_array_equal(hier, flat)
            np.testing.assert_array_equal(flat, want)


def test_sync_errors_name_the_state(world):
    _, ranks = world
    for r in ranks:
        assert "Unsupported dist_reduce_fx for state 'acc.tp'" in r["reduce_error"]
        assert "for state 'm.bad'" in r["trees_error"]


def test_metric_and_collection_sync_state_over_axes(world):
    x, ranks = world
    total = x["reduce_float"].astype(np.float32).sum()
    top = x["reduce_float"].max()
    for r in ranks:
        np.testing.assert_allclose(_np(r["metric_sync"]), total, rtol=1e-6)
        np.testing.assert_allclose(_np(r["coll_sync"]["sum"]), total, rtol=1e-6)
        np.testing.assert_array_equal(_np(r["coll_sync"]["max"]), top)


def test_drive_axis_name_hierarchical_sums_bit_for_bit(world):
    x, ranks = world
    ref = float(x["drive_sum"].sum())
    for r in ranks:
        assert r["drive_i"] == r["drive_flat"] == r["drive_hier"] == ref
        assert "MULTI-axis" in r["hier_single_error"]


def test_sharded_drive_feeds_obs_surfaces(world):
    _, ranks = world
    for r in ranks:
        assert "reshard" in r["obs_kinds"]
        assert r["obs_reshard"][0]["mesh_axes"] == {"dp": 2, "mp": 2}
        stats = r["obs_stats"]
        assert stats["sharded_drives"] == 1 and stats["reshard_events"] >= 1 and stats["mesh_changes"] == 0
        assert stats["specs"]["ConfusionMatrix.confmat"] == "PartitionSpec('mp',)"
        resident = stats["resident"]["ConfusionMatrix.confmat"]
        assert resident["per_device_bytes"] * 2 == resident["total_bytes"]
        assert r["obs_snapshot"] == stats
        prom = r["obs_prom"]
        for family in (
            "metrics_tpu_shard_sharded_drives",
            "metrics_tpu_shard_reshard_events",
            "metrics_tpu_shard_mesh_changes",
            "metrics_tpu_shard_registered_specs",
            "metrics_tpu_shard_resident_bytes_per_device",
            "metrics_tpu_shard_state_bytes_total",
            "metrics_tpu_shard_state_devices",
        ):
            assert family in prom, family


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
