"""The port's pod-scale banks (``MetricBank(mesh=, tenant_axis=)``) against
``metrics_tpu``'s, on the same numpy requests.

One world per module: four gloo ranks on the CPU, each a process of this
file, holding a ``(2, 2)`` ``DeviceMesh`` with dims ``("host", "mp")`` and
a ``(4,)`` one with dim ``("host",)``. Every rank makes the same calls (the
SPMD contract of a pod bank) and saves one observation per scenario; the
parent runs each scenario on the JAX package's pod bank over 4 of its 8
virtual CPU devices laid out the same way, and holds every rank's
observation against it: per-tenant states, values and ``stats`` bit for
bit, ``summary()`` (bar the wall-clock ``flush_ms_ewma``) equal, and the
store's blobs and journal records the same bytes (rank 0's store: the one
writer; the other ranks' stores stay empty). The scenarios are those of
``tests/serving/test_pod_bank.py`` and ``test_bank_sharded_states.py``,
plus the port's own: each package recovers the other's ``DiskStore`` and
imports the other's export; ``sync_state_in_trace`` over the non-tenant
axis (the JAX side inside a ``shard_map``; over the tenant axis, or over a
member state's own split axis, the port raises); a wave that fails on one
rank, or a store write that fails on rank 0 while an admission spills,
raises on every rank and leaves rows, counts and journal unchanged; calls
made out of step raise ``MetricsUserError``; a router flushes the same
waves on every rank; and the constructor raises the JAX errors. The JAX
side never calls ``state_spec()``: some JAX versions refuse to set the
sharding it reports.
Every worker runs under a wall-clock limit and is killed past it.
"""
import gc
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
NUM_CLASSES = 8


# ---------------------------------------------------------------------------
# the two packages, as a scenario sees them
# ---------------------------------------------------------------------------
class Side:
    def __init__(self, name, meshes, tmp):
        self.name = name
        self.meshes = meshes
        self.tmp = tmp
        if name == "jax":
            import jax.numpy as jnp

            import metrics_tpu as pkg

            self.kw, self._arr = {}, jnp.asarray
        else:
            import metrics_tpu_torch as pkg

            self.kw, self._arr = {"device": "cpu"}, torch.as_tensor
        self.pkg = pkg
        self.serving = pkg.serving
        self.exc = sys.modules[f"{pkg.__name__}.utils.exceptions"]

    def m(self, cls, **kw):
        return getattr(self.pkg, cls)(**kw, **self.kw)

    def coll(self, members):
        return self.pkg.MetricCollection(members)

    def arr(self, x):
        return self._arr(np.asarray(x))

    def mesh(self, kind):
        return self.meshes[kind]

    def disk(self, name):
        return self.serving.DiskStore(os.path.join(self.tmp, name))


def req(S, seed, batch=8):
    rng = np.random.RandomState(seed)
    return (
        S.arr(rng.randint(0, NUM_CLASSES, size=batch).astype(np.int32)),
        S.arr(rng.randint(0, NUM_CLASSES, size=batch).astype(np.int32)),
    )


def prob_req(S, seed, batch=8, nan_rows=0):
    rng = np.random.RandomState(seed)
    preds = rng.rand(batch, NUM_CLASSES).astype(np.float32)
    if nan_rows:
        preds[:nan_rows, 0] = np.nan
    return S.arr(preds), S.arr(rng.randint(0, NUM_CLASSES, size=batch).astype(np.int32))


def host(x):
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def summ(bank):
    out = dict(bank.summary())
    out.pop("flush_ms_ewma")  # wall clock
    return out


def store_bytes(store, journals):
    """Every blob and journal frame of a store. A ``DiskStore``'s directory
    is the one rank 0 writes, whichever rank reads it here."""
    if hasattr(store, "_blobs"):
        kind, blobs = "memory", dict(store._blobs)
    else:
        kind, blobs = "disk", {}
        for name in sorted(os.listdir(store._blob_dir)):
            with open(os.path.join(store._blob_dir, name), "rb") as f:
                blobs[name] = f.read()
    return {"kind": kind, "blobs": blobs, "journals": {j: store.journal_frames(j) for j in journals}}


def observe(bank, tenants):
    """States, values, counts, stats and summary of a bank (collectives on
    a port pod bank: every rank calls them in the same order)."""
    return {
        "states": {t: host(bank.tenant_state(t)) for t in tenants},
        "values": {t: host(bank.compute(t)) for t in tenants},
        "counts": {t: bank.update_count(t) for t in tenants},
        "stats": dict(bank.stats),
        "summary": summ(bank),
        "store": store_bytes(bank.store, [bank.name]),
    }


def serve(S, bank, tenants, steps, make=req, base=0):
    for step in range(steps):
        for j, t in enumerate(tenants):
            bank.update(t, *make(S, base + 1000 * step + j))


def statscores(S, **kw):
    return S.m("StatScores", reduce="macro", num_classes=NUM_CLASSES, class_sharding="mp", **kw)


def pair(S):
    return S.coll(
        {
            "acc": S.m("Accuracy", num_classes=NUM_CLASSES),
            "cm": S.m("ConfusionMatrix", num_classes=NUM_CLASSES, class_sharding="mp"),
        }
    )


# ---------------------------------------------------------------------------
# scenarios: the same calls on both packages
# ---------------------------------------------------------------------------
def sc_layout(S):
    bank = S.serving.MetricBank(
        S.m("Accuracy", num_classes=NUM_CLASSES), capacity=2, mesh=S.mesh("4"), tenant_axis="host", name="pod_layout"
    )
    tenants = [f"t{i}" for i in range(6)]
    serve(S, bank, tenants, 1)
    out = {"capacity": bank.capacity, "shard_capacity": bank.shard_capacity, **observe(bank, tenants)}
    gc.collect()  # every rank holds the same live banks when the export sums them
    text = S.pkg.obs.prometheus_text()
    out["prom"] = sorted(l for l in text.splitlines() if "metrics_tpu_bank_shard" in l and "pod_layout" in l)
    return out


def sc_churn(S):
    """5 tenants churn through a 2-shard bank of class-sharded StatScores at
    one slot a shard: admit, evict, spill, readmit."""
    bank = S.serving.MetricBank(statscores(S), capacity=1, mesh=S.mesh("2x2"), tenant_axis="host", name="pod_churn")
    tenants = [f"u{i}" for i in range(5)]
    serve(S, bank, tenants, 3)
    out = observe(bank, tenants)
    mat = bank.materialize("u1")
    out["mat_count"] = mat._update_count
    out["mat_value"] = host(mat.compute())
    if S.name == "torch":
        out["mat_spec"] = str(mat.state_spec()["tp"].sharding)
        out["mat_shard"] = tuple(mat.tp.shape)
    return out


def sc_screen(S, policy):
    bank = S.serving.MetricBank(
        S.m("Accuracy", num_classes=NUM_CLASSES, on_bad_input=policy),
        capacity=1,
        mesh=S.mesh("4"),
        tenant_axis="host",
        name=f"pod_{policy}",
    )
    tenants = [f"u{i}" for i in range(6)]
    for step in range(4):
        for j, t in enumerate(tenants):
            bank.update(t, *prob_req(S, 100 * step + j, nan_rows=2 if step % 2 else 0))
    return observe(bank, tenants)


def sc_launches(S):
    scatter = S.serving.MetricBank(
        S.m("Accuracy", num_classes=NUM_CLASSES), capacity=4, mesh=S.mesh("4"), tenant_axis="host",
        dense_threshold=1.0, name="pod_scatter",
    )
    tenants = [f"t{i}" for i in range(8)]
    scatter.apply_batch([(t, req(S, i)) for i, t in enumerate(tenants)])
    dense = S.serving.MetricBank(
        S.m("Accuracy", num_classes=NUM_CLASSES), capacity=4, mesh=S.mesh("4"), tenant_axis="host",
        dense_threshold=0.25, name="pod_dense",
    )
    dense.apply_batch([(t, req(S, i)) for i, t in enumerate(tenants[:5])])
    return {"scatter": observe(scatter, tenants), "dense": observe(dense, tenants[:5])}


def sc_disk_recover(S):
    template = statscores(S)
    bank = S.serving.MetricBank(
        template, capacity=1, mesh=S.mesh("2x2"), tenant_axis="host", name="pod_disk",
        spill_store=S.disk("pod_disk"), checkpoint_every_n_flushes=1,
    )
    tenants = [f"u{i}" for i in range(6)]
    serve(S, bank, tenants, 3, base=31)
    written = store_bytes(bank.store, ["pod_disk"])
    del bank  # the kill: only the DiskStore survives
    gc.collect()
    recovered = S.serving.MetricBank.recover(
        template.clone(), 1, S.disk("pod_disk"), name="pod_disk", mesh=S.mesh("2x2"), tenant_axis="host"
    )
    out = {"store": written, "recovered": observe(recovered, tenants)}
    serve(S, recovered, tenants, 1, base=9000)
    out["after"] = observe(recovered, tenants)
    return out


def write_for_other(S, name, tenants):
    """A pod bank's DiskStore and one exported payload, for the other package."""
    bank = S.serving.MetricBank(
        statscores(S), capacity=1, mesh=S.mesh("2x2"), tenant_axis="host", name=name,
        spill_store=S.disk(name), checkpoint_every_n_flushes=1,
    )
    serve(S, bank, tenants, 2, base=77)
    bank.update("x", *req(S, 5))
    export = bank.export_payload("x")
    out = {"values": {t: host(bank.compute(t)) for t in tenants}, "export": export}
    del bank
    gc.collect()
    return out


def read_from_other(S, name, tenants, export):
    """Recover the other package's DiskStore into a fresh pod bank, serve on,
    and import its exported payload."""
    recovered = S.serving.MetricBank.recover(
        statscores(S), 1, S.disk(name), name=name, mesh=S.mesh("2x2"), tenant_axis="host"
    )
    out = {"recovered": {t: host(recovered.compute(t)) for t in tenants}}
    serve(S, recovered, tenants, 1, base=500)
    out["served"] = {t: host(recovered.compute(t)) for t in tenants}
    dst = S.serving.MetricBank(statscores(S), capacity=1, mesh=S.mesh("2x2"), tenant_axis="host", name=f"{name}_import")
    dst.import_tenant("x", S.serving.store.decode_tenant_payload(export))
    out["imported"] = host(dst.compute("x"))
    dst.update("x", *req(S, 6))
    out["imported_served"] = host(dst.compute("x"))
    out["imported_count"] = dst.update_count("x")
    return out


def sc_export(S):
    """An export's payload bytes, and the import it round-trips through."""
    src = S.serving.MetricBank(statscores(S), capacity=1, mesh=S.mesh("2x2"), tenant_axis="host", name="pod_src")
    serve(S, src, ["T", "U"], 3, base=3)
    payload = src.export_payload("T", keep=True)
    tree = src.export_tenant("U")
    dst = S.serving.MetricBank(statscores(S), capacity=2, mesh=S.mesh("2x2"), tenant_axis="host", name="pod_dst")
    dst.import_tenant("T", S.serving.store.decode_tenant_payload(payload))
    dst.import_tenant("U", tree, admit=False)
    return {"payload": payload, "src": observe(src, ["T"]), "dst": observe(dst, ["T", "U"])}


def sc_compute_many(S):
    bank = S.serving.MetricBank(statscores(S), capacity=2, mesh=S.mesh("2x2"), tenant_axis="host", name="pod_many")
    tenants = [f"u{i}" for i in range(6)]
    serve(S, bank, tenants, 1)
    before = bank.stats["coalesced_gathers"]
    values = bank.compute_async(tenants).result()
    many = bank.compute_many(["u5", "u0", "u4"])
    return {
        "async": {t: host(v) for t, v in values.items()},
        "many": {t: host(v) for t, v in many.items()},
        "gathers": bank.stats["coalesced_gathers"] - before,
        **observe(bank, tenants),
    }


def sc_drive(S):
    bank = S.serving.MetricBank(statscores(S), capacity=2, mesh=S.mesh("2x2"), tenant_axis="host", name="pod_drive")
    bank.drive("e", [req(S, i) for i in range(5)])
    bank.update("e", *req(S, 99))
    bank.drive("f", [req(S, 50 + i) for i in range(3)])
    return observe(bank, ["e", "f"])


def sc_collection(S):
    bank = S.serving.MetricBank(pair(S), capacity=1, mesh=S.mesh("2x2"), tenant_axis="host", name="pod_coll")
    tenants = [f"u{i}" for i in range(5)]
    serve(S, bank, tenants, 2, base=23)
    return observe(bank, tenants)


def sc_mesh_alone(S):
    """``mesh=`` alone: class-sharded members placed on the mesh, tenants
    replicated (the port of ``test_bank_sharded_states.py``)."""
    bank = S.serving.MetricBank(statscores(S), capacity=2, mesh=S.mesh("2x2"), name="pod_alone")
    tenants = [f"t{i}" for i in range(6)]
    serve(S, bank, tenants, 4, base=11)
    out = observe(bank, tenants)
    out["spilled"] = sorted(bank.spilled_tenants)
    mat = bank.materialize("t2")
    out["mat_count"] = mat._update_count
    out["mat_value"] = host(mat.compute())
    if S.name == "torch":
        out["mat_spec"] = str(mat.state_spec()["fp"].sharding)
    return out


def sc_router(S):
    bank = S.serving.MetricBank(
        S.m("Accuracy", num_classes=NUM_CLASSES), capacity=2, mesh=S.mesh("4"), tenant_axis="host", name="pod_router"
    )
    router = S.serving.RequestRouter(bank, max_requests=4, max_delay_s=None)
    order = ["a", "b", "c", "a", "d", "e", "b", "f", "g", "a"]
    for i, t in enumerate(order):
        router.submit(t, *req(S, i))
    router.flush()
    out = {"router": dict(router.stats), **observe(bank, sorted(set(order)))}
    if S.name == "torch":
        try:
            S.serving.RequestRouter(bank)
        except S.exc.MetricsUserError as err:
            out["deadline_error"] = str(err)
    return out


def _jax_sync_in_trace(S, bank, axis):
    """The JAX bank's ``sync_state_in_trace`` where it runs: inside a
    ``shard_map`` over the bank's mesh, each leaf in its own layout."""
    import jax

    smap = getattr(jax, "shard_map", None)
    if smap is None:
        from jax.experimental.shard_map import shard_map as smap
    names = sorted(bank._bank)
    leaves = [bank._bank[n] for n in names]
    specs = tuple(leaf.sharding.spec for leaf in leaves)

    def body(*local):
        saved, bank._bank = bank._bank, dict(zip(names, local))
        try:
            bank.sync_state_in_trace(axis)
            return tuple(bank._bank[n] for n in names)
        finally:
            bank._bank = saved

    bank._bank = dict(zip(names, smap(body, mesh=S.mesh("2x2"), in_specs=specs, out_specs=specs)(*leaves)))


def sc_sync(S):
    """``sync_state_in_trace`` over the non-tenant axis: the two ``mp``
    processes of a shard hold the same tenants, so each row doubles."""
    bank = S.serving.MetricBank(
        S.m("Accuracy", num_classes=NUM_CLASSES), capacity=2, mesh=S.mesh("2x2"), tenant_axis="host", name="pod_sync"
    )
    tenants = [f"t{i}" for i in range(4)]
    serve(S, bank, tenants, 2, base=40)
    before = {t: host(bank.tenant_state(t)) for t in tenants}
    if S.name == "jax":
        _jax_sync_in_trace(S, bank, "mp")
    else:
        bank.sync_state_in_trace("mp")
    return {"before": before, **observe(bank, tenants)}


def sc_constructor_errors(S):
    out = {}
    cases = {
        "no_mesh": lambda: S.serving.MetricBank(S.m("Accuracy", num_classes=NUM_CLASSES), 2, tenant_axis="host"),
        "bad_axis": lambda: S.serving.MetricBank(
            S.m("Accuracy", num_classes=NUM_CLASSES), 2, mesh=S.mesh("2x2"), tenant_axis="dp"
        ),
        "state_axis": lambda: S.serving.MetricBank(
            S.m("StatScores", reduce="macro", num_classes=NUM_CLASSES, class_sharding="host"),
            2,
            mesh=S.mesh("2x2"),
            tenant_axis="host",
        ),
    }
    for key, build in cases.items():
        try:
            build()
            out[key] = None
        except S.exc.MetricsUserError as err:
            out[key] = str(err)
    return out


SCENARIOS = {
    "layout": sc_layout,
    "churn": sc_churn,
    "screen_skip": lambda S: sc_screen(S, "skip"),
    "screen_mask": lambda S: sc_screen(S, "mask"),
    "launches": sc_launches,
    "disk_recover": sc_disk_recover,
    "export": sc_export,
    "compute_many": sc_compute_many,
    "drive": sc_drive,
    "collection": sc_collection,
    "mesh_alone": sc_mesh_alone,
    "router": sc_router,
    "constructor_errors": sc_constructor_errors,
    "sync": sc_sync,
}
CROSS_TENANTS = ["u0", "u1", "u2"]


# ---------------------------------------------------------------------------
# the port's own cases (no JAX counterpart to run)
# ---------------------------------------------------------------------------
def port_sync(S, rank):
    """The reductions the port refuses (the JAX bank runs them and adds
    different tenants', or different class slices', rows together): over
    the tenant axis, and over a member state's own split axis."""
    out = {}
    banks = {
        "tenant_axis_error": (S.m("Accuracy", num_classes=NUM_CLASSES), "host"),
        "state_axis_error": (statscores(S), "mp"),
    }
    for key, (template, axis) in banks.items():
        bank = S.serving.MetricBank(template, capacity=2, mesh=S.mesh("2x2"), tenant_axis="host", name=f"pod_{key}")
        serve(S, bank, ["t0", "t1"], 1)
        before = {t: host(bank.tenant_state(t)) for t in ("t0", "t1")}
        try:
            bank.sync_state_in_trace(axis)
        except ValueError as err:
            out[key] = str(err)
        out[f"{key}_unchanged"] = before, {t: host(bank.tenant_state(t)) for t in ("t0", "t1")}
    return out


def port_failures(S, rank):
    """A wave that raises on one rank, or a store write of the writer
    (rank 0) that fails while an admission spills: every rank raises, and
    nothing moves."""
    bank = S.serving.MetricBank(
        S.m("Accuracy", num_classes=NUM_CLASSES), capacity=2, mesh=S.mesh("2x2"), tenant_axis="host", name="pod_fail"
    )
    tenants = [f"t{i}" for i in range(4)]
    serve(S, bank, tenants, 1)

    def snap():
        return {
            "states": {t: host(bank.tenant_state(t)) for t in tenants},
            "counts": {t: bank.update_count(t) for t in tenants},
            "journal": list(bank.store.journal_frames("pod_fail")),
            "blobs": dict(bank.store._blobs),
            "launches": bank.stats["launches"],
            "resident": sorted(bank.tenants),
            "spilled": sorted(bank.spilled_tenants),
        }

    out = {"start": snap(), "errors": []}
    wave = [(t, req(S, 70 + i)) for i, t in enumerate(tenants)]

    def fault():
        raise S.exc.InjectedFaultError("injected on rank 1")

    if rank == 1:
        bank.fault_injector = fault
    try:
        bank.apply_batch(wave)
    except Exception as err:  # noqa: BLE001 - the rank-1 error travels to every rank
        out["errors"].append((type(err).__name__, str(err)))
    bank.fault_injector = None
    out["after_hook"] = snap()
    if rank == 2:
        def broken(*a, **k):
            raise RuntimeError("dispatch failed on rank 2")

        bank._dispatch_wave = broken
    try:
        bank.apply_batch(wave)
    except Exception as err:  # noqa: BLE001
        out["errors"].append((type(err).__name__, str(err)))
    bank.__dict__.pop("_dispatch_wave", None)
    out["after_dispatch"] = snap()
    # out of step: rank 0 serves another tenant than the others
    try:
        bank.update("t0" if rank == 0 else "t1", *req(S, 90))
    except S.exc.MetricsUserError as err:
        out["errors"].append((type(err).__name__, str(err)))
    out["after_step"] = snap()
    bank.apply_batch(wave)  # in step again: applies everywhere
    out["end"] = snap()
    # the bank is full: a new tenant spills the least recently used one,
    # and rank 0's put of its blob fails
    put = bank.store.put
    if rank == 0:
        def failing_put(key, payload):
            raise OSError("disk full on rank 0")

        bank.store.put = failing_put
    try:
        bank.update("t4", *req(S, 95))
    except Exception as err:  # noqa: BLE001 - rank 0's store error travels to every rank
        out["errors"].append((type(err).__name__, str(err)))
    bank.store.__dict__.pop("put", None)
    assert bank.store.put == put
    out["after_store"] = snap()
    bank.update("t4", *req(S, 95))  # the store takes writes again: the admission goes through
    out["store_end"] = {**snap(), "t4": host(bank.tenant_state("t4")), "t4_count": bank.update_count("t4")}
    out["flush_errors"] = bank.stats["flush_errors"]
    return out


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------
def _worker(rank, world, port, tmp, out_path):
    sys.path.insert(0, REPO)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank, timeout=timedelta(seconds=60)
    )
    meshes = {
        "2x2": init_device_mesh("cpu", (2, 2), mesh_dim_names=("host", "mp")),
        "4": init_device_mesh("cpu", (4,), mesh_dim_names=("host",)),
    }
    # rank 0 writes the stores; every rank names the same directories
    S = Side("torch", meshes, tmp)
    results = {"scenarios": {}, "port": {}}
    for name, fn in SCENARIOS.items():
        S.pkg.engine.clear_cache()
        results["scenarios"][name] = fn(S)
    results["port"]["sync"] = port_sync(S, rank)
    results["port"]["failures"] = port_failures(S, rank)
    with open(os.path.join(tmp, "jax_export.bin"), "rb") as f:
        results["port"]["from_jax"] = read_from_other(S, "jax_wrote", CROSS_TENANTS, f.read())
    results["port"]["for_jax"] = write_for_other(S, "port_wrote", CROSS_TENANTS)
    torch.save(results, out_path)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: the world, and metrics_tpu on 4 of its virtual devices
# ---------------------------------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_side(tmp):
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:4])
    meshes = {"2x2": Mesh(devs.reshape(2, 2), ("host", "mp")), "4": Mesh(devs, ("host",))}
    return Side("jax", meshes, tmp)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pod_world"))
    J = _jax_side(os.path.join(tmp, "jax"))
    T_dir = os.path.join(tmp, "torch")
    os.makedirs(T_dir)
    # what the port reads of the JAX package: a DiskStore and an export
    J.pkg.engine.clear_cache()
    jax_wrote = write_for_other(Side("jax", J.meshes, T_dir), "jax_wrote", CROSS_TENANTS)
    with open(os.path.join(T_dir, "jax_export.bin"), "wb") as f:
        f.write(jax_wrote["export"])
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs, paths = [], []
    for rank in range(WORLD):
        path = os.path.join(tmp, f"rank{rank}.pt")
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
        cmd = [sys.executable, os.path.abspath(__file__), str(rank), str(WORLD), str(port), T_dir, path]
        procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO), log))
        paths.append(path)
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    jax_out = {}
    try:
        # the JAX package's scenarios run while the ranks run theirs
        for name, fn in SCENARIOS.items():
            J.pkg.engine.clear_cache()
            jax_out[name] = fn(J)
        failures = []
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
    ranks = [torch.load(p, weights_only=False) for p in paths]
    # what the JAX package reads of the port: rank 0's DiskStore and export
    J.pkg.engine.clear_cache()
    port_export = ranks[0]["port"]["for_jax"]["export"]
    from_port = read_from_other(Side("jax", J.meshes, T_dir), "port_wrote", CROSS_TENANTS, port_export)
    # and the JAX package's own run of the port's stream, for reference
    J.pkg.engine.clear_cache()
    jax_twin = write_for_other(Side("jax", J.meshes, os.path.join(tmp, "jax_twin")), "port_wrote", CROSS_TENANTS)
    J.pkg.engine.clear_cache()
    jax_self = read_from_other(Side("jax", J.meshes, os.path.join(tmp, "jax_twin")), "port_wrote", CROSS_TENANTS, jax_twin["export"])
    return {
        "jax": jax_out,
        "ranks": ranks,
        "jax_wrote": jax_wrote,
        "jax_twin": jax_twin,
        "jax_self": jax_self,
        "from_port": from_port,
    }


def same(j, t, path="obs"):
    """The port's observation ``t`` against the JAX package's ``j``, bit for
    bit (integer states and counts exactly; float values too)."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(j) == set(t), f"{path}: keys {sorted(map(str, j))} vs {sorted(map(str, t))}"
        for k in j:
            same(j[k], t[k], f"{path}[{k!r}]")
        return
    if isinstance(j, (list, tuple)):
        assert isinstance(t, (list, tuple)) and len(j) == len(t), f"{path}: {j!r} vs {t!r}"
        for i, (a, b) in enumerate(zip(j, t)):
            same(a, b, f"{path}[{i}]")
        return
    if isinstance(j, (bytes, str, bool, type(None), int)) and not isinstance(j, np.ndarray):
        assert j == t, f"{path}: {j!r} vs {t!r}"
        return
    a, b = host(j), host(t)
    assert a.shape == b.shape, f"{path}: shape {a.shape} vs {b.shape}"
    assert a.dtype.kind == b.dtype.kind, f"{path}: dtype {a.dtype} vs {b.dtype}"
    np.testing.assert_array_equal(b, a, err_msg=path)


def _each_rank(world, name):
    for rank, res in enumerate(world["ranks"]):
        obs = dict(res["scenarios"][name])
        yield rank, obs


def _hold(world, name, drop=()):
    """Every rank's observation of scenario ``name`` against the JAX one;
    the store's bytes are rank 0's, the other ranks' stores stay empty."""
    want = dict(world["jax"][name])
    for key in drop:
        want.pop(key, None)
    for rank, got in _each_rank(world, name):
        for key in drop:
            got.pop(key, None)
        expect = want
        if rank:
            _no_store(got)
            expect, got = _strip_store(want), _strip_store(got)
        same(expect, got, f"{name} rank {rank}")


def _strip_store(obs):
    if isinstance(obs, dict):
        return {k: _strip_store(v) for k, v in obs.items() if not (k == "store" and isinstance(v, dict))}
    return obs


def _no_store(obs):
    """A rank other than 0 never writes its (own, in-memory) store."""
    if isinstance(obs, dict):
        for k, v in obs.items():
            if k == "store" and isinstance(v, dict):
                if v["kind"] == "memory":
                    assert not v["blobs"] and not any(v["journals"].values()), "a rank other than 0 wrote to its store"
            else:
                _no_store(v)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------
def test_layout_summary_and_shard_families(world):
    _hold(world, "layout")
    jax_obs = world["jax"]["layout"]
    assert jax_obs["capacity"] == 8 and jax_obs["shard_capacity"] == 2
    occ = jax_obs["summary"]["shard_occupancy"]
    assert sum(occ) == 6 and max(occ) - min(occ) <= 1
    assert any(l.startswith("metrics_tpu_bank_shard_occupancy") for l in jax_obs["prom"])


def test_churn_class_sharded_statscores(world):
    _hold(world, "churn", drop=("mat_spec", "mat_shard"))
    assert world["jax"]["churn"]["stats"]["spills"] > 0
    assert world["jax"]["churn"]["mat_count"] == 3
    for rank, got in _each_rank(world, "churn"):
        assert got["mat_spec"] == "PartitionSpec('mp',)"
        assert got["mat_shard"] == (NUM_CLASSES // 2,)


@pytest.mark.parametrize("policy", ["skip", "mask"])
def test_screening_policies(world, policy):
    _hold(world, f"screen_{policy}")
    summary = world["jax"][f"screen_{policy}"]["summary"]
    assert summary["updates_quarantined" if policy == "skip" else "rows_masked"] > 0


def test_scatter_launches_are_the_shards_touched(world):
    _hold(world, "launches")
    stats = world["jax"]["launches"]
    assert stats["scatter"]["stats"]["scatter_launches"] == 4 and stats["scatter"]["stats"]["requests"] == 8
    assert stats["dense"]["stats"]["dense_launches"] == 1 and stats["dense"]["stats"]["launches"] == 1


def test_disk_store_kill_and_recover(world):
    _hold(world, "disk_recover")
    assert world["jax"]["disk_recover"]["recovered"]["summary"]["tenant_shards"] == 2


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_recover_and_import_the_other_package(world, writer):
    if writer == "jax":
        # the ranks recover the JAX package's store and import its export,
        # landing where the JAX package itself lands from the same bytes
        want = world["jax_self"]
        for rank, res in enumerate(world["ranks"]):
            same(want, res["port"]["from_jax"], f"from jax, rank {rank}")
        same(world["jax_twin"]["values"], world["jax_wrote"]["values"])
    else:
        # the JAX package recovers rank 0's store and imports its export
        same(world["jax_self"], world["from_port"], "from port")
        for rank, res in enumerate(world["ranks"]):
            same(world["jax_twin"]["values"], res["port"]["for_jax"]["values"], f"port values rank {rank}")
        assert world["ranks"][0]["port"]["for_jax"]["export"] == world["jax_twin"]["export"]


def test_export_and_import(world):
    _hold(world, "export")
    for rank, got in _each_rank(world, "export"):
        assert got["payload"] == world["jax"]["export"]["payload"], rank


def test_compute_many_and_async_one_gather(world):
    _hold(world, "compute_many")
    assert world["jax"]["compute_many"]["gathers"] == 2


def test_drive_on_tenant_sharded_bank(world):
    _hold(world, "drive")
    assert world["jax"]["drive"]["counts"] == {"e": 6, "f": 3}


def test_collection_bank_on_the_mesh(world):
    _hold(world, "collection")


def test_mesh_alone_with_class_sharded_members(world):
    _hold(world, "mesh_alone", drop=("mat_spec",))
    assert world["jax"]["mesh_alone"]["spilled"] == ["t0", "t1", "t2", "t3"]
    for rank, got in _each_rank(world, "mesh_alone"):
        assert got["mat_spec"] == "PartitionSpec('mp',)"


def test_router_flushes_the_same_waves_on_every_rank(world):
    _hold(world, "router", drop=("deadline_error",))
    for rank, got in _each_rank(world, "router"):
        assert "max_delay_s=None" in got["deadline_error"]


def test_constructor_errors_are_the_jax_errors(world):
    _hold(world, "constructor_errors")
    assert all(world["jax"]["constructor_errors"].values())


def test_summary_is_the_same_on_every_rank(world):
    for name in SCENARIOS:
        first = _strip_store(world["ranks"][0]["scenarios"][name])
        for rank in range(1, WORLD):
            same(first, _strip_store(world["ranks"][rank]["scenarios"][name]), f"{name}: rank 0 vs rank {rank}")


def test_sync_state_in_trace_within_the_tenant_shard(world):
    _hold(world, "sync")
    jax_sync = world["jax"]["sync"]
    # the two mp processes of a shard hold the same rows: the sum doubles them
    same({t: {n: 2 * v for n, v in s.items()} for t, s in jax_sync["before"].items()}, jax_sync["states"])
    for rank, res in enumerate(world["ranks"]):
        refused = res["port"]["sync"]
        assert "'host' is the bank's tenant_axis" in refused["tenant_axis_error"], rank
        assert "is split over ['mp']" in refused["state_axis_error"], rank
        for key in ("tenant_axis_error", "state_axis_error"):
            same(*refused[f"{key}_unchanged"], f"rank {rank} {key}")


def test_a_failure_on_one_rank_moves_nothing_anywhere(world):
    for rank, res in enumerate(world["ranks"]):
        fail = res["port"]["failures"]
        kinds = [k for k, _ in fail["errors"]]
        assert kinds == ["InjectedFaultError", "RuntimeError", "MetricsUserError", "OSError"], (rank, fail["errors"])
        assert "injected on rank 1" in fail["errors"][0][1]
        assert "dispatch failed on rank 2" in fail["errors"][1][1]
        assert "out of step" in fail["errors"][2][1] and "t0" in fail["errors"][2][1]
        for stage in ("after_hook", "after_dispatch", "after_step"):
            same(fail["start"], fail[stage], f"rank {rank} {stage}")
        assert fail["end"]["launches"] == fail["start"]["launches"] + 1
        assert all(fail["end"]["counts"][t] == 2 for t in fail["end"]["counts"])
        assert fail["flush_errors"] == 4
        if rank == 0:
            assert fail["start"]["journal"], "rank 0 journals"
        else:
            assert not fail["start"]["journal"] and not fail["end"]["journal"]


def test_a_failed_store_write_on_the_writer_moves_nothing(world):
    """Rank 0's put of a spilled tenant's blob fails inside an admission:
    every rank raises its error there, the victim stays resident, and rows,
    counts, journal and blobs are as they were; the retry goes through."""
    for rank, res in enumerate(world["ranks"]):
        fail = res["port"]["failures"]
        assert fail["errors"][3][0] == "OSError" and "disk full on rank 0" in fail["errors"][3][1], rank
        same(fail["end"], fail["after_store"], f"rank {rank} after_store")
        end = fail["store_end"]
        assert len(end["spilled"]) == 1 and end["spilled"][0] in fail["end"]["resident"]
        assert end["resident"] == sorted(set(fail["end"]["resident"]) - set(end["spilled"]) | {"t4"})
        same(fail["end"]["states"], end["states"], f"rank {rank} the spilled tenant decodes as it was")
        assert end["t4_count"] == 1 and end["launches"] == fail["end"]["launches"] + 1
        if rank == 0:
            assert len(end["journal"]) == len(fail["end"]["journal"]) + 2, "spill + admit"
        else:
            assert not end["journal"] and not end["blobs"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
