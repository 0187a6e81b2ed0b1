"""The port's sharded-state registration surface, in one process, against
``metrics_tpu`` (cases of ``tests/sharding/test_spec_api.py``).

``add_state(sharding=)``, the ``class_sharding``/``feature_sharding``
registrations, ``state_spec()``, ``bind_state``'s layout check, placement
(``shard_states``) with clone, pickle, checkpoint and reset, the class
windows of the confusion counts, ``drive``'s mesh-mode validation and the
world-of-one mesh drives. The cases that need a ``DeviceMesh`` run on a
``(1, 1)`` ``("dp", "mp")`` mesh over a gloo group of one process, made for
this module and taken down after it; the multi-process cases are in
``tests/test_torch_mesh.py``. JAX's ``Metric.state_spec()`` is not called on
a sharded state (it raises in this container's JAX); its
``_state_shardings`` is read instead.
"""
import copy
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu import engine as jengine
from metrics_tpu.ops.confusion_counts import _confusion_counts_pallas, _multilabel_counts_pallas
from metrics_tpu_torch import engine
from metrics_tpu_torch.ops.confusion_counts import _confusion_route, confusion_counts, multilabel_counts
from metrics_tpu_torch.sharding import PartitionSpec as P
from metrics_tpu_torch.sharding import spec as shd
from metrics_tpu_torch.utils.exceptions import MetricsUserError

N = 8


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A (1, 1) ("dp", "mp") mesh over a gloo group of this process alone."""
    from torch.distributed.device_mesh import init_device_mesh

    if dist.is_initialized():  # pragma: no cover - another module left a group up
        pytest.fail("a torch.distributed group is already initialised in this process")
    store = dist.FileStore(str(tmp_path_factory.mktemp("store") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("dp", "mp"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _fresh():
    engine.clear_cache()
    shd.reset_shard_stats()
    yield
    engine.clear_cache()


class _ShardedSum(mt.Metric):
    """The port's case metric (module level, so that it pickles)."""

    _batch_additive = True

    def __init__(self, n=N, sharding="mp", **kwargs):
        super().__init__(**kwargs)
        self.n = n
        self.add_state("total", default=torch.zeros(n), dist_reduce_fx="sum", sharding=sharding)

    def update(self, x):
        self.total = self.total + x.sum(0)

    def compute(self):
        return self.total


def _summed(pkg, **kw):
    """The same metric on ``metrics_tpu``."""

    class _ShardedSum(pkg.Metric):
        _batch_additive = True

        def __init__(self, n=N, sharding="mp", **kwargs):
            super().__init__(**kwargs)
            self.n = n
            self.add_state("total", default=jnp.zeros((n,), jnp.float32), dist_reduce_fx="sum", sharding=sharding)

        def update(self, x):
            self.total = self.total + jnp.sum(x, axis=0)

        def compute(self):
            return self.total

    return _ShardedSum(**kw)


def _port_sum(**kw):
    return _ShardedSum(device="cpu", **kw)


def _dtensor(mesh, value, spec):
    layout = shd.layout_of(mesh, spec, tuple(value.shape))
    return shd.dtensor_view(value, layout, mesh)


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------
def test_partition_spec_follows_jax():
    from jax.sharding import PartitionSpec as JP

    for entries in [("mp",), ("mp", None), (), (None, "dp"), (("dp", "mp"),)]:
        port, jax_spec = P(*entries), JP(*entries)
        assert str(port) == str(jax_spec) and len(port) == len(jax_spec) and tuple(port) == tuple(jax_spec)
        assert pickle.loads(pickle.dumps(port)) == port and copy.deepcopy(port) == port
    assert (P("mp") == P("mp", None)) == (JP("mp") == JP("mp", None)) is False
    assert shd.canonical_spec(P("mp", None)) == shd.canonical_spec(P("mp")) == ("mp",)


@pytest.mark.parametrize("sharding", ["mp", P("mp"), ("mp",)], ids=["name", "spec", "tuple"])
def test_add_state_sharding_registers_like_jax(sharding):
    from jax.sharding import PartitionSpec as JP

    port = _port_sum(sharding=sharding)
    jax_m = _summed(mj, sharding=JP("mp") if isinstance(sharding, P) else sharding)
    assert port._state_shardings == {"total": P("mp")}
    assert tuple(port._state_shardings["total"]) == tuple(jax_m._state_shardings["total"])


@pytest.mark.parametrize("case", ["list", "rank"])
def test_add_state_sharding_rejects_list_states_and_overlong_specs_like_jax(case):
    for pkg, kw in ((mj, {}), (mt, {"device": "cpu"})):

        class Bad(pkg.Metric):
            def __init__(self):
                super().__init__(**kw)
                if case == "list":
                    self.add_state("buf", default=[], dist_reduce_fx="cat", sharding="mp")
                else:
                    self.add_state("s", default=np.zeros(4), dist_reduce_fx="sum", sharding=("mp", None, "dp"))

            def update(self):  # pragma: no cover
                pass

            def compute(self):  # pragma: no cover
                pass

        with pytest.raises(ValueError, match=case):
            Bad()


def test_class_sharding_registrations_follow_jax():
    for kw in ({}, {"multilabel": True}):
        port = mt.ConfusionMatrix(num_classes=N, class_sharding="mp", device="cpu", **kw)
        jax_m = mj.ConfusionMatrix(num_classes=N, class_sharding="mp", **kw)
        assert port.class_sharding == jax_m.class_sharding == ("mp",)
        assert port._state_shardings == {"confmat": P("mp")}
    port = mt.StatScores(reduce="macro", num_classes=N, class_sharding="mp", device="cpu")
    jax_m = mj.StatScores(reduce="macro", num_classes=N, class_sharding="mp")
    assert {n: tuple(s) for n, s in port._state_shardings.items()} == {
        n: tuple(s) for n, s in jax_m._state_shardings.items()
    } == {n: ("mp",) for n in ("tp", "fp", "tn", "fn")}
    fid = mt.FrechetInceptionDistance(feature=lambda x: x, feature_dim=4, feature_sharding="mp", device="cpu")
    jfid = mj.FrechetInceptionDistance(feature=lambda x: jnp.asarray(x), feature_dim=4, feature_sharding="mp")
    assert {n: tuple(s) for n, s in fid._state_shardings.items()} == {
        n: tuple(s) for n, s in jfid._state_shardings.items()
    }
    assert fid.feature_sharding == jfid.feature_sharding == ("mp",)


@pytest.mark.parametrize(
    "kwargs",
    [{"reduce": "micro"}, {"reduce": "samples", "num_classes": N}, {"reduce": "macro", "num_classes": N, "mdmc_reduce": "samplewise"}],
    ids=["micro", "samples", "samplewise"],
)
def test_stat_scores_class_sharding_needs_macro_like_jax(kwargs):
    for pkg, kw in ((mj, {}), (mt, {"device": "cpu"})):
        with pytest.raises(ValueError, match="macro"):
            pkg.StatScores(class_sharding="mp", **kwargs, **kw)


def test_fid_feature_sharding_needs_feature_dim_like_jax():
    for pkg, kw in ((mj, {}), (mt, {"device": "cpu"})):
        with pytest.raises(MetricsUserError if pkg is mt else mj.utils.exceptions.MetricsUserError, match="feature_dim"):
            pkg.FrechetInceptionDistance(feature=lambda x: x, feature_sharding="mp", **kw)


@pytest.mark.parametrize(
    "kwargs,want",
    [
        ({}, "eigh"),
        ({"feature_sharding": "mp"}, "newton_schulz"),
        ({"matrix_sqrt": "newton_schulz"}, "newton_schulz"),
        ({"feature_sharding": "mp", "matrix_sqrt": "eigh"}, "eigh"),
    ],
    ids=["auto", "auto-sharded", "newton_schulz", "sharded-eigh"],
)
def test_fid_resolved_sqrt_follows_jax(kwargs, want):
    port = mt.FrechetInceptionDistance(feature=lambda x: x, feature_dim=4, device="cpu", **kwargs)
    jax_m = mj.FrechetInceptionDistance(feature=lambda x: jnp.asarray(x), feature_dim=4, **kwargs)
    assert port._resolved_sqrt() == jax_m._resolved_sqrt() == want


# ---------------------------------------------------------------------------
# state_spec, bind_state
# ---------------------------------------------------------------------------
def test_state_spec_carries_the_sharding_annotation():
    port = _port_sum()
    jax_m = _summed(mj)
    spec = port.state_spec()["total"]
    assert isinstance(spec, shd.StateSpec)
    assert spec.shape == tuple(jax_m._defaults["total"].shape) == (N,) and spec.dtype == torch.float32
    assert tuple(spec.sharding) == tuple(jax_m._state_shardings["total"]) == ("mp",)
    plain = mt.ConfusionMatrix(num_classes=4, device="cpu").state_spec()["confmat"]
    assert plain.sharding is None and plain.shape == tuple(mj.ConfusionMatrix(num_classes=4).state_spec()["confmat"].shape)
    assert mt.CatMetric(device="cpu").state_spec()["value"] is None


@pytest.mark.parametrize("layout", ["host", "replicated", "matching", "conflict"])
def test_bind_state_checks_the_layout(mesh, layout):
    m = _port_sum()
    value = torch.arange(N, dtype=torch.float32)
    if layout == "host":
        bound = value
    else:
        bound = _dtensor(mesh, value, {"replicated": P(), "matching": P("mp"), "conflict": P("dp")}[layout])
    if layout == "conflict":
        with pytest.raises(MetricsUserError, match=r"_ShardedSum\.total"):
            m.bind_state({"total": bound})
        # the JAX package refuses a conflicting layout the same way
        import jax
        from jax.sharding import Mesh, NamedSharding
        from jax.sharding import PartitionSpec as JP

        jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "mp"))
        wrong = jax.device_put(jnp.arange(N, dtype=jnp.float32), NamedSharding(jmesh, JP("dp")))
        with pytest.raises(mj.utils.exceptions.MetricsUserError, match=r"_ShardedSum\.total"):
            _summed(mj).bind_state({"total": wrong})
        return
    m.bind_state({"total": bound})
    assert m.total.tolist() == list(range(N))


# ---------------------------------------------------------------------------
# placement and its lifecycle
# ---------------------------------------------------------------------------
def test_shard_states_places_records_and_reset_reapplies(mesh):
    m = _port_sum()
    m.update(torch.ones(3, N))
    with mt.obs.capture() as events:
        m.shard_states(mesh)
    assert shd.spec_of_value(m.sharded_state("total")) == P("mp")
    assert m._shard_layout["total"].global_shape == (N,)
    stats = mt.sharding.shard_stats()
    assert stats["reshard_events"] >= 1 and stats["specs"]["_ShardedSum.total"] == str(P("mp"))
    assert stats["resident"]["_ShardedSum.total"] == {"per_device_bytes": N * 4, "total_bytes": N * 4, "devices": 1}
    assert [e.kind for e in events].count("reshard") == 1
    assert mt.obs.snapshot()["sharding"] == stats
    assert "metrics_tpu_shard_resident_bytes_per_device" in mt.obs.prometheus_text()
    assert m.compute().tolist() == [3.0] * N
    # an update that does not window itself runs on the gathered state and keeps its shard
    m.update(torch.ones(1, N))
    assert m.compute().tolist() == [4.0] * N and m.total.shape == (N,)
    m.reset()
    assert shd.spec_of_value(m.sharded_state("total")) == P("mp") and float(m.total.sum()) == 0.0


@pytest.mark.parametrize("how", ["clone", "pickle"])
def test_clone_and_pickle_carry_annotations_not_placement(mesh, how):
    m = _port_sum()
    m.update(torch.ones(2, N))
    m.shard_states(mesh)
    other = m.clone() if how == "clone" else pickle.loads(pickle.dumps(m))
    assert other._state_shardings == {"total": P("mp")}
    assert other._shard_mesh is None and other._shard_layout == {}
    assert torch.equal(other.total, m.total)


def test_checkpoint_round_trips_placed_state(mesh):
    from metrics_tpu_torch.utils.checkpoint import metric_state_pytree, restore_metric_state_pytree

    m = _port_sum()
    m.update(torch.from_numpy(np.random.RandomState(0).rand(4, N).astype(np.float32)))
    m.shard_states(mesh)
    tree = metric_state_pytree(m)
    fresh = _port_sum()
    restore_metric_state_pytree(fresh, tree)
    assert torch.equal(fresh.total, m.total)
    fresh.shard_states(mesh)
    assert shd.spec_of_value(fresh.sharded_state("total")) == P("mp")


# ---------------------------------------------------------------------------
# class windows of the confusion counts (the CUDA windows run on the card)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c,window", [(10, (0, 10)), (10, (3, 4)), (10, (9, 1)), (10, (5, 0)), (130, (65, 65))])
def test_windowed_confusion_counts_are_slices_of_the_full_counts(c, window):
    rng = np.random.default_rng(c)
    preds, target = rng.integers(-1, c + 1, 600), rng.integers(-1, c + 1, 600)
    full = confusion_counts(torch.from_numpy(preds), torch.from_numpy(target), num_classes=c)
    got = confusion_counts(torch.from_numpy(preds), torch.from_numpy(target), num_classes=c, rows=window)
    r0, rows = window
    assert got.shape == (rows, c)
    torch.testing.assert_close(got, full[r0:r0 + rows], rtol=0, atol=0)
    inside = ((preds >= 0) & (preds < c) & (target >= 0) & (target < c))
    want = np.asarray(
        _confusion_counts_pallas(jnp.asarray(preds[inside]), jnp.asarray(target[inside]), num_classes=c, interpret=True)
    )
    np.testing.assert_array_equal(got.numpy(), want[r0:r0 + rows])


@pytest.mark.parametrize("c,window", [(13, (0, 13)), (13, (2, 5)), (13, (12, 1)), (16, (8, 8))])
def test_windowed_multilabel_counts_are_slices_of_the_full_counts(c, window):
    rng = np.random.default_rng(c)
    preds, target = rng.integers(0, 2, (70, c)), rng.integers(0, 2, (70, c))
    p, t = torch.from_numpy(preds).int(), torch.from_numpy(target).int()
    got = multilabel_counts(p, t, cols=window)
    c0, w = window
    torch.testing.assert_close(got, multilabel_counts(p, t)[c0:c0 + w], rtol=0, atol=0)
    want = np.asarray(_multilabel_counts_pallas(jnp.asarray(preds), jnp.asarray(target), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want[c0:c0 + w])


def test_windowed_counts_reject_windows_outside_the_classes():
    x = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="row window"):
        confusion_counts(x, x, num_classes=4, rows=(3, 2))
    with pytest.raises(ValueError, match="column window"):
        multilabel_counts(torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, 4, dtype=torch.int32), cols=(-1, 2))


@pytest.mark.parametrize("c,rows,want", [(10450, 5225, "global"), (1000, 50, "shared"), (241, None, "shared"), (242, 121, "shared")])
def test_confusion_route_decides_by_the_window_bytes(c, rows, want):
    assert _confusion_route(c, rows)[0] == want


# ---------------------------------------------------------------------------
# drive's mesh modes in one process
# ---------------------------------------------------------------------------
def _int_epoch(seed=7, steps=6, batch=16, c=N):
    rng = np.random.RandomState(seed)
    return rng.randint(0, c, size=(steps, batch)).astype(np.int32), rng.randint(0, c, size=(steps, batch)).astype(np.int32)


@pytest.mark.parametrize("case", ["mesh", "one or the other", "STEPS axis", "stacked", "scan-drivable"])
def test_in_specs_validation_follows_jax(mesh, case):
    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as JP

    preds, target = _int_epoch()
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "mp"))
    for pkg, drive, m_mesh, spec, tensor, kw in (
        (mj, jengine.drive, jmesh, JP, jnp.asarray, {}),
        (mt, engine.drive, mesh, P, torch.from_numpy, {"device": "cpu"}),
    ):
        epoch = (tensor(preds), tensor(target))
        m = pkg.ConfusionMatrix(num_classes=N, class_sharding="mp", **kw)
        call = {
            "mesh": lambda: drive(m, epoch, in_specs=spec(None, "dp")),
            "one or the other": lambda: drive(m, epoch, mesh=m_mesh, axis_name="dp", in_specs=spec(None, "dp")),
            "STEPS axis": lambda: drive(m, epoch, mesh=m_mesh, in_specs=spec("dp")),
            "stacked": lambda: drive(m, iter([(epoch[0][0], epoch[1][0])]), mesh=m_mesh, in_specs=spec(None, "dp")),
            "scan-drivable": lambda: drive(
                pkg.ConfusionMatrix(num_classes=N, jit_update=False, **kw), epoch, mesh=m_mesh, in_specs=spec(None, "dp")
            ),
        }[case]
        with pytest.raises(ValueError, match=case):
            call()


def test_world_of_one_sharded_drive_equals_local_and_stays_usable(mesh):
    preds, target = (torch.from_numpy(a) for a in _int_epoch())
    ref = mt.ConfusionMatrix(num_classes=N, device="cpu")
    engine.drive(ref, (preds, target))
    sh = mt.ConfusionMatrix(num_classes=N, class_sharding="mp", device="cpu")
    res = engine.drive(sh, (preds, target), mesh=mesh, in_specs=P(None, "dp"))
    assert res.fused_keys == ("_",) and torch.equal(sh.compute(), ref.compute())
    # no axis of more than one process: the merge runs in the last program, and no collective
    assert mt.sharding.shard_stats()["sharded_drives"] == 1 and sh.compile_stats()["mesh_sync"] == "in_program"
    # one process: the metric stays fully usable, as after a local drive
    assert not sh._drive_synced
    sh.update(preds[0], target[0])
    ref.update(preds[0], target[0])
    assert torch.equal(sh.compute(), ref.compute())


def test_world_of_one_axis_drive_equals_local_bit_for_bit(mesh):
    preds, target = (torch.from_numpy(a) for a in _int_epoch(c=5))
    scores = torch.nn.functional.one_hot(preds.long(), 5).float() + 0.1 * torch.rand(6, 16, 5, generator=torch.Generator().manual_seed(0))

    def coll():
        return mt.MetricCollection(
            {
                "acc": mt.Accuracy(device="cpu"),
                "cm": mt.ConfusionMatrix(num_classes=5, device="cpu"),
                "f1": mt.F1Score(num_classes=5, average="macro", device="cpu"),
            }
        )

    ref, sh = coll(), coll()
    engine.drive(ref, (scores, target))
    engine.drive(sh, (scores, target), mesh=mesh, axis_name="dp")
    for key, value in ref.compute().items():
        assert torch.equal(sh.compute()[key], value), key
    # the axis_name mode leaves the global state: host updates refuse
    assert all(m._drive_synced for m in sh.values())
    with pytest.raises(MetricsUserError, match="globally-synced"):
        sh.update(scores[0], target[0])
    with pytest.raises(MetricsUserError, match="globally-synced"):
        engine.drive(sh, (scores, target))
    sh.reset()
    sh.update(scores[0], target[0])
    with pytest.raises(ValueError, match="MULTI-axis"):
        engine.drive(sh, (scores, target), mesh=mesh, axis_name=("dp",), hierarchical_sync=True)


def test_sync_state_over_an_axis_needs_a_mesh(mesh):
    m = mt.SumMetric(nan_strategy="disable", device="cpu", axis_name="dp")
    state = m.update_state(m.init_state(), torch.arange(4.0))
    with pytest.raises(ValueError, match="DeviceMesh"):
        m.sync_state(state)
    with mt.parallel.axis_env(mesh):
        assert float(m.sync_state(state)["value"]) == 6.0
        coll = mt.MetricCollection({"s": mt.SumMetric(nan_strategy="disable", device="cpu")})
        states = coll.update_state(coll.init_state(), torch.arange(4.0))
        assert float(coll.sync_state(states, "dp")["s"]["value"]) == 6.0
    # without an axis, the host sync runs as before
    assert float(mt.SumMetric(nan_strategy="disable", device="cpu").sync_state(state)["value"]) == 6.0


def test_staged_axes_and_errors_follow_jax():
    from metrics_tpu.parallel import comm as jcomm

    from metrics_tpu_torch.parallel import comm

    for args in (("i", True), (("i",), True), (("host", "local"), False), (("host", "local"), True)):
        assert comm._staged_axes(*args) == jcomm._staged_axes(*args)
    with pytest.raises(ValueError, match=r"Unsupported dist_reduce_fx for state 'acc\.tp'"):
        comm.reduce_in_trace(torch.zeros(3), "median", "i", state="acc.tp")
    with pytest.raises(ValueError, match="Unsupported dist_reduce_fx: 'median'"):
        comm.reduce_in_trace(torch.zeros(3), "median", "i")
