"""The port's encoder mesh across processes, against ``metrics_tpu``.

One world per module, as in ``tests/test_torch_mesh.py``: four gloo ranks
on the CPU, each a process of this file, laid out as a ``(2, 2)``
``DeviceMesh`` with dims ``("dp", "mp")``. Every rank is given the same
whole inputs, made from a seed with numpy, runs every case and saves its
results; the parent holds them against ``metrics_tpu`` on a ``(2, 2)`` mesh
of the JAX virtual CPU devices, on the same inputs:

* the toy table encoder of ``tests/encoders/test_runtime.py``: each rank's
  output block bit for bit against its shard of the JAX global array, the
  weights resident in halves, one placement, the callable ``param_specs``
  form, ``batch_multiple()``, program sharing, ``pickle`` and the exports;
* the linear FID encoder of ``tests/encoders/test_flagships.py`` through
  ``update_stream`` (a ragged chunk included) and ``update``: FID within
  1e-6 relative of the JAX sharded value and within
  ``NEWTON_SCHULZ_FID_RTOL`` of the port's unsharded eigh value;
* ``encoder_sharding="mp"`` on the seeded InceptionV3 (the stem only, at
  75 x 75): the features against the port's unsharded network within 1e-6
  (the JAX package never runs a sharded forward), and the runtime's
  sharing, re-placement and mesh check;
* BERTScore over the toy embedding encoder with a CRC32 tokenizer: per
  sentence within 1e-6 of JAX's sharded BERTScore, equal on every rank.

Every worker runs under a wall-clock limit and is killed past it.
"""
import os
import socket
import subprocess
import sys
import time
import zlib
from datetime import timedelta

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 150
WORLD = 4
VOCAB, DIM = 64, 16  # the toy table encoder
BERT_VOCAB, BERT_DIM, BERT_LEN = 104, 16, 32
FEAT_D = 16  # the linear FID encoder's features
INC_FEATURE = 64  # the InceptionV3 tap: the stem only
INC_IMAGES = 8  # per distribution; each dp group streams half
FID_REL = 1e-6
FEATURE_ATOL = 1e-6

_SENTS = [
    "the cat sat on the mat",
    "hello world",
    "a much longer sentence with many more words than the others here",
    "tiny",
    "the quick brown fox jumps over the lazy dog",
]


def _corpus(k: int = 3):
    preds = (_SENTS * k)[: 5 * k]
    return preds, [s.replace("the", "a") for s in preds]


def _tokenizer(text, max_length):
    """A deterministic word hash (CRC32) between [CLS] (1) and [SEP] (2)."""
    ids = np.zeros((len(text), max_length), np.int64)
    mask = np.zeros_like(ids)
    for i, sentence in enumerate(text):
        words = [zlib.crc32(w.encode()) % (BERT_VOCAB - 10) + 5 for w in sentence.split()]
        toks = [1] + words[: max_length - 2] + [2]
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = 1
    return {"input_ids": ids, "attention_mask": mask}


def _inputs(seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    stream = np.random.RandomState(0)  # test_flagships.py's _image_stream draws

    def image_stream():
        return [stream.rand(16, 3, 4, 4).astype(np.float32) for _ in range(4)] + [stream.rand(5, 3, 4, 4).astype(np.float32)]

    real = image_stream()
    fake = [b * 0.6 + 0.2 for b in image_stream()]
    out = {
        "table": np.random.RandomState(0).normal(size=(VOCAB, DIM)).astype(np.float32),
        "table9": np.random.RandomState(9).normal(size=(VOCAB, DIM)).astype(np.float32),
        "ids": rng.randint(0, VOCAB, size=(8, 5)),
        "mask": np.ones((8, 5), np.int32),
        "ragged_ids": rng.randint(0, VOCAB, size=(7, 5)),
        "w": (np.random.RandomState(7).normal(size=(48, FEAT_D)) * 0.2).astype(np.float32),
        "bert_table": np.random.RandomState(0).normal(size=(BERT_VOCAB, BERT_DIM)).astype(np.float32),
        "inc_real": (rng.rand(INC_IMAGES, 3, 75, 75) * 255).astype(np.float32),
        "inc_fake": (rng.rand(INC_IMAGES, 3, 75, 75) * 200 + 30).astype(np.float32),
    }
    for i, (r, f) in enumerate(zip(real, fake)):
        out[f"real{i}"], out[f"fake{i}"] = r, f
    return out


def _stream(x: dict, prefix: str) -> list:
    return [x[f"{prefix}{i}"] for i in range(5)]


def _table_apply(params, ids, mask):
    return params["table"][ids] * mask[..., None]


def _feat_apply(params, imgs):
    return imgs.float().reshape(imgs.shape[0], -1) @ params["w"]


# ---------------------------------------------------------------------------
# the worker: one rank of the world
# ---------------------------------------------------------------------------
def _table_cases(mt, P, mesh, x, t) -> dict:
    import copy
    import pickle

    from metrics_tpu_torch import engine
    from metrics_tpu_torch.encoders import ShardedEncoder, encoder_stats, reset_encoder_stats

    engine.clear_cache()
    reset_encoder_stats()
    ids, mask = t(x["ids"]), t(x["mask"])

    def enc_of(table, name, **kw):
        kw.setdefault("param_specs", {"table": P("mp", None)})
        return ShardedEncoder(
            _table_apply, {"table": t(table)}, mesh=mesh, in_specs=P("dp"), out_spec=P("dp"), name=name, device="cpu", **kw
        )

    enc = enc_of(x["table"], "toy")
    out = {"table_block": enc(ids, mask), "table_shard": tuple(enc.params["table"].shape)}
    first = dict(enc.compile_stats())
    for _ in range(3):
        enc(ids, mask)
    out["table_compiles"] = (first, dict(enc.compile_stats()))
    other = enc_of(x["table9"], "toy2")
    out["table_other_block"] = other(ids, mask)
    out["table_other_stats"] = dict(other.compile_stats())
    out["table_summary"] = engine.cache_summary()["by_kind"]["encode"]
    out["table_stats"] = encoder_stats()
    out["table_digest"] = (enc.stable_digest(), other.stable_digest(), enc_of(x["table"], "toy3", param_specs=None).stable_digest())
    cb = ShardedEncoder(
        _table_apply, {"table": t(x["table"])}, param_specs=lambda path, leaf: P("mp", None) if "table" in path else None,
        mesh=mesh, in_specs=P("dp"), out_spec=P("dp"), name="cb", device="cpu",
    )
    out["table_cb"] = (cb(ids, mask), tuple(cb.params["table"].shape))
    prod = ShardedEncoder(_table_apply, {"table": t(x["table"])}, in_specs=P(("dp", "mp")), mesh=mesh, name="prod", device="cpu")
    out["table_multiples"] = (enc.batch_multiple(), prod.batch_multiple())
    out["table_ragged"] = (enc.row_window(7), enc(t(x["ragged_ids"]), torch.ones(7, 5, dtype=torch.int32)))
    out["table_deepcopy"] = copy.deepcopy(enc) is enc
    back = pickle.loads(pickle.dumps(enc))  # gathers the table: a collective
    out["table_pickled"] = (back.mesh is None, tuple(back.params["table"].shape), torch.equal(back.params["table"], t(x["table"])))
    out["table_replaced"] = back.place(mesh)(ids, mask)
    # the program's gather (comm.reduce_in_trace; eager on gloo) against the eager one, an uneven split included
    from metrics_tpu_torch.sharding import spec as shard_spec

    uneven = torch.arange(21, dtype=torch.float32).reshape(7, 3)
    layout = shard_spec.layout_of(mesh, P("mp"), (7, 3))
    shard = shard_spec.local_slice(uneven, layout)
    out["table_gathers"] = (
        tuple(shard.shape),
        shard_spec.gather_state(shard, layout, mesh, in_program=True),
        shard_spec.gather_state(shard, layout, mesh),
    )
    out["table_snapshot"] = mt.obs.snapshot()["encoders"]
    out["table_prom"] = mt.obs.prometheus_text()
    return out


def _fid_linear_cases(mt, P, mesh, x, t) -> dict:
    from metrics_tpu_torch.encoders import ShardedEncoder

    real, fake = [t(b) for b in _stream(x, "real")], [t(b) for b in _stream(x, "fake")]
    enc = ShardedEncoder(
        _feat_apply, {"w": t(x["w"])}, param_specs={"w": P(None, "mp")}, mesh=mesh, in_specs=P("dp"),
        out_spec=P(None, "mp"), name="fid_feat", device="cpu",
    )
    mt.sharding.reset_shard_stats()
    fid = mt.FrechetInceptionDistance(
        feature=enc, feature_dim=FEAT_D, feature_sharding="mp", encoder_sharding=enc, device="cpu"
    )
    fid.shard_states(mesh)
    results = [fid.update_stream(real, real=True), fid.update_stream(fake, real=False)]
    out = {
        "fid_stream": float(fid.compute()),
        "fid_rows": [(r.chunks, r.rows) for r in results],
        "fid_outer_shape": tuple(fid.real_outer.shape),
        "fid_resident": mt.sharding.shard_stats()["resident"]["FrechetInceptionDistance.real_outer"],
        "fid_block": enc(real[0]),
        "fid_w_shard": tuple(enc.params["w"].shape),
    }
    # update(): each batch split over dp by torch.chunk (the 5-row one as 3 + 2)
    stepped = mt.FrechetInceptionDistance(
        feature=enc, feature_dim=FEAT_D, feature_sharding="mp", encoder_sharding=enc, device="cpu"
    )
    stepped.shard_states(mesh)
    for r, f in zip(real, fake):
        stepped.update(r, real=True)
        stepped.update(f, real=False)
    out["fid_update"] = float(stepped.compute())
    return out


def _inception_cases(mt, P, mesh, x, t, weights: str) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from metrics_tpu_torch.encoders import ShardedEncoder, encoder_stats
    from metrics_tpu_torch.image.networks import inception as net
    from metrics_tpu_torch.utils.exceptions import MetricsUserError

    dp = mesh.get_local_rank("dp")
    ext = net.resolve_inception_extractor(INC_FEATURE, weights, resize_input=False, device="cpu")
    real, fake = t(x["inc_real"]), t(x["inc_fake"])

    def sharded_fid():
        fid = mt.FrechetInceptionDistance(
            feature=INC_FEATURE, weights_path=weights, feature_sharding="mp", encoder_sharding="mp", device="cpu"
        )
        fid.inception = ext  # the stem at the network's smallest input: no 299 x 299 resize
        return fid

    fid = sharded_fid()
    fid.shard_states(mesh)
    fid.update_stream([real.chunk(2)[dp]], real=True)  # the processes of one mp group stream one half
    fid.update_stream([fake.chunk(2)[dp]], real=False)
    runtime = fid._encoder_runtime
    out = {
        "inc_fid": float(fid.compute()),
        "inc_block": runtime(real[:3]),
        "inc_kernel": tuple(runtime.params["Conv2d_1a_3x3"]["kernel"].shape),
        "inc_record": encoder_stats()["encoders"]["inception_64"],
        "inc_gather": runtime.compile_stats()["param_gather"],
    }
    second = sharded_fid()
    second.shard_states(mesh)
    out["inc_shared"] = (
        second._encoder_runtime._apply is runtime._apply,
        second._encoder_runtime._program_key()[0] == runtime._program_key()[0],
    )
    # the runtime follows the states onto another mesh
    mesh2 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("dp", "mp"))
    fid.shard_states(mesh2)
    out["inc_followed"] = (
        fid._encoder_runtime is runtime and runtime.mesh is mesh2,
        tuple(runtime.params["Conv2d_1a_3x3"]["kernel"].shape),
        runtime(real[:3]),
    )
    # a ready runtime placed on another mesh than the states
    enc = ShardedEncoder(_feat_apply, {"w": t(x["w"])}, param_specs={"w": P(None, "mp")}, mesh=mesh2, name="cross", device="cpu")
    cross = mt.FrechetInceptionDistance(feature=enc, feature_dim=FEAT_D, feature_sharding="mp", encoder_sharding=enc, device="cpu")
    try:
        cross.shard_states(mesh)
        out["inc_cross"] = "no error"
    except MetricsUserError as err:
        out["inc_cross"] = str(err)
    # the unsharded reference, on this process alone
    out["inc_unsharded"] = ext(real[:3])
    return out


def _bert_cases(mt, P, mesh, x, t) -> dict:
    from metrics_tpu_torch.encoders import ShardedEncoder
    from metrics_tpu_torch.functional import bert_score

    enc = ShardedEncoder(
        _table_apply, {"table": t(x["bert_table"])}, param_specs={"table": P("mp", None)}, mesh=mesh,
        in_specs=P("dp"), out_spec=P("dp"), name="bert_emb", device="cpu",
    )
    preds, target = _corpus()
    kw = dict(user_tokenizer=_tokenizer, max_length=BERT_LEN, batch_size=4, idf=True, device="cpu")
    functional = bert_score(preds, target, model=enc, **kw)
    # the module: each process buffers its own quarter; compute() syncs them in rank order
    rank = torch.distributed.get_rank()
    module = mt.BERTScore(encoder_sharding=enc, **kw)
    module.update(preds[4 * rank:4 * rank + 4], target[4 * rank:4 * rank + 4])
    scores = module.compute()
    return {
        "bert_functional": {k: np.asarray(functional[k]) for k in ("precision", "recall", "f1")},
        "bert_module": {k: np.asarray(scores[k]) for k in ("precision", "recall", "f1")},
        "bert_table_shard": tuple(enc.params["table"].shape),
    }


def _worker(rank: int, world: int, port: int, inputs_path: str, weights: str, out_path: str) -> None:
    sys.path.insert(0, REPO)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import metrics_tpu_torch as mt
    from metrics_tpu_torch.sharding import PartitionSpec as P

    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank, timeout=timedelta(seconds=60)
    )
    x = dict(np.load(inputs_path))
    t = torch.from_numpy
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("dp", "mp"))
    results = {"coords": (mesh.get_local_rank("dp"), mesh.get_local_rank("mp"))}
    results.update(_table_cases(mt, P, mesh, x, t))
    results.update(_fid_linear_cases(mt, P, mesh, x, t))
    results.update(_inception_cases(mt, P, mesh, x, t, weights))
    results.update(_bert_cases(mt, P, mesh, x, t))
    torch.save(results, out_path)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: the world, and metrics_tpu on a (2, 2) mesh
# ---------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "mp"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from metrics_tpu_torch.image.networks import inception as net

    tmp = tmp_path_factory.mktemp("encoder_mesh_world")
    x = _inputs()
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **x)
    weights = str(tmp / "inception.npz")
    net.save_inception_weights(net.random_inception_params(0, device="cpu"), weights)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs, paths = [], []
    for rank in range(WORLD):
        path = str(tmp / f"rank{rank}.pt")
        log = open(tmp / f"rank{rank}.log", "w+")
        cmd = [sys.executable, os.path.abspath(__file__), str(rank), str(WORLD), str(port), inputs, weights, path]
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
    return x, weights, [torch.load(p, weights_only=False) for p in paths]


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _jax_table_encoder(table, mesh, **kw):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from metrics_tpu import ShardedEncoder

    def apply(params, ids, mask):
        return params["table"][ids] * mask[..., None]

    kw.setdefault("param_specs", {"table": JP("mp", None)})
    return ShardedEncoder(apply, {"table": jnp.asarray(table)}, mesh=mesh, in_specs=JP("dp"), out_spec=JP("dp"), name="toy", **kw)


def test_table_encoder_blocks_match_jax_shards_bit_for_bit(world):
    x, _, ranks = world
    jax_out = np.asarray(_jax_table_encoder(x["table"], _jax_mesh())(x["ids"], x["mask"]))
    for r in ranks:
        dp, _ = r["coords"]
        np.testing.assert_array_equal(_np(r["table_block"]), jax_out[4 * dp:4 * dp + 4])
        np.testing.assert_array_equal(_np(r["table_replaced"]), jax_out[4 * dp:4 * dp + 4])


def test_table_weights_resident_in_halves_with_one_placement(world):
    _, _, ranks = world
    for r in ranks:
        assert r["table_shard"] == (VOCAB // 2, DIM)
        rec = r["table_stats"]["encoders"]["toy"]
        assert rec["params_bytes_per_device"] * 2 == rec["params_bytes_total"] == VOCAB * DIM * 4
        assert rec["devices"] == WORLD and rec["placements"] == 1


def test_callable_param_specs_agree(world):
    x, _, ranks = world
    jax_out = np.asarray(_jax_table_encoder(x["table"], _jax_mesh())(x["ids"], x["mask"]))
    for r in ranks:
        dp, _ = r["coords"]
        block, shard = r["table_cb"]
        np.testing.assert_array_equal(_np(block), jax_out[4 * dp:4 * dp + 4])
        assert shard == (VOCAB // 2, DIM)


def test_batch_multiple_and_ragged_rows(world):
    import jax.numpy as jnp

    from metrics_tpu import ShardedEncoder
    from jax.sharding import PartitionSpec as JP

    x, _, ranks = world
    jenc = ShardedEncoder(lambda p, ids, m: p["table"][ids], {"table": jnp.asarray(x["table"])}, in_specs=JP(("dp", "mp")), mesh=_jax_mesh())
    assert _jax_table_encoder(x["table"], _jax_mesh()).batch_multiple() == 2
    want = x["table"][x["ragged_ids"]]
    rows = []
    for r in ranks:
        assert r["table_multiples"] == (2, jenc.batch_multiple()) == (2, 4)
        (start, length), block = r["table_ragged"]
        np.testing.assert_array_equal(_np(block), want[start:start + length])
        rows.append((start, length))
    assert sorted(set(rows)) == [(0, 4), (4, 3)]  # torch.chunk's split: each row encoded by one dp group


def test_in_program_gather_equals_the_eager_gather(world):
    _, _, ranks = world
    whole = np.arange(21, dtype=np.float32).reshape(7, 3)
    for r in ranks:
        shape, in_program, eager = r["table_gathers"]
        assert shape == ((4, 3) if r["coords"][1] == 0 else (3, 3))  # torch.chunk's split of 7 rows
        np.testing.assert_array_equal(_np(in_program), whole)
        np.testing.assert_array_equal(_np(eager), whole)


def test_repeat_calls_and_other_weights_share_one_program(world):
    x, _, ranks = world
    want = x["table9"][x["ids"]]
    for r in ranks:
        first, after = r["table_compiles"]
        assert first["compiles"] == after["compiles"] == 1
        assert after["cache_hits"] == first["cache_hits"] + 3
        assert first["param_gather"] == "before_program"  # gloo: gathered before the dispatch
        assert r["table_other_stats"]["compiles"] == 0 and r["table_other_stats"]["cache_hits"] == 1
        assert r["table_summary"]["entries"] == 1
        dp, _ = r["coords"]
        np.testing.assert_array_equal(_np(r["table_other_block"]), want[4 * dp:4 * dp + 4])
        same, other, unsharded = r["table_digest"]
        assert same == other != unsharded


def test_pickle_deepcopy_and_exports(world):
    _, _, ranks = world
    for r in ranks:
        assert r["table_deepcopy"]
        assert r["table_pickled"] == (True, (VOCAB, DIM), True)
        snap = r["table_snapshot"]
        assert set(snap["encoders"]["toy"]) == {"params_bytes_total", "params_bytes_per_device", "devices", "placements"}
        assert snap["encoders"]["toy"]["placements"] == 2  # the pickled copy placed again
        for family in (
            "metrics_tpu_encoder_params_bytes_per_device",
            "metrics_tpu_encoder_params_bytes_total",
            "metrics_tpu_encoder_devices",
        ):
            assert f'{family}{{encoder="toy"}}' in r["table_prom"], family


def test_linear_fid_encoder_matches_jax_sharded_and_host_eigh(world):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    import metrics_tpu_torch as mt
    from metrics_tpu import FrechetInceptionDistance, ShardedEncoder
    from metrics_tpu_torch.sharding import NEWTON_SCHULZ_FID_RTOL

    x, _, ranks = world
    mesh = _jax_mesh()

    def japply(params, imgs):
        return jnp.asarray(imgs, jnp.float32).reshape(imgs.shape[0], -1) @ params["w"]

    jenc = ShardedEncoder(
        japply, {"w": jnp.asarray(x["w"])}, param_specs={"w": JP(None, "mp")}, mesh=mesh, in_specs=JP("dp"),
        out_spec=JP(None, "mp"), name="fid_feat",
    )
    jfid = FrechetInceptionDistance(feature=jenc, feature_dim=FEAT_D, feature_sharding="mp", encoder_sharding=jenc)
    jfid.shard_states(mesh)
    jfid.update_stream(_stream(x, "real"), real=True)
    jfid.update_stream(_stream(x, "fake"), real=False)
    want = float(jfid.compute())
    w = torch.from_numpy(x["w"])
    host = mt.FrechetInceptionDistance(feature=lambda z: z.reshape(z.shape[0], -1) @ w, feature_dim=FEAT_D, device="cpu")
    for r_b, f_b in zip(_stream(x, "real"), _stream(x, "fake")):
        host.update(torch.from_numpy(r_b), real=True)
        host.update(torch.from_numpy(f_b), real=False)
    eigh = float(host.compute())
    assert eigh > 1e-3
    feats = x["real0"].reshape(16, -1) @ x["w"]
    for r in ranks:
        dp, mp = r["coords"]
        for key in ("fid_stream", "fid_update"):
            assert abs(r[key] - want) <= FID_REL * abs(want), (key, r[key], want)
            assert abs(r[key] - eigh) <= NEWTON_SCHULZ_FID_RTOL * abs(eigh)
        assert r["fid_rows"] == [(5, 69), (5, 69)]  # counted once across the mesh
        assert r["fid_outer_shape"] == (FEAT_D // 2, FEAT_D) and r["fid_w_shard"] == (48, FEAT_D // 2)
        assert r["fid_resident"]["per_device_bytes"] * 2 == r["fid_resident"]["total_bytes"]
        np.testing.assert_allclose(_np(r["fid_block"]), feats[8 * dp:8 * dp + 8, 8 * mp:8 * mp + 8], rtol=1e-6, atol=1e-6)


def test_inception_encoder_sharding_features_and_placement(world):
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.image.networks import inception as net
    from metrics_tpu_torch.sharding import NEWTON_SCHULZ_FID_RTOL

    x, weights, ranks = world
    ext = net.resolve_inception_extractor(INC_FEATURE, weights, resize_input=False, device="cpu")
    host = mt.FrechetInceptionDistance(feature=ext, feature_dim=INC_FEATURE, device="cpu")
    host.update(torch.from_numpy(x["inc_real"]), real=True)
    host.update(torch.from_numpy(x["inc_fake"]), real=False)
    eigh = float(host.compute())
    values = {r["inc_fid"] for r in ranks}
    assert len(values) == 1
    (value,) = values
    assert abs(value - eigh) <= NEWTON_SCHULZ_FID_RTOL * abs(eigh)
    for r in ranks:
        _, mp = r["coords"]
        unsharded = _np(r["inc_unsharded"])
        half = INC_FEATURE // 2
        np.testing.assert_allclose(_np(r["inc_block"]), unsharded[:, mp * half:(mp + 1) * half], rtol=0, atol=FEATURE_ATOL)
        assert r["inc_kernel"] == (16, 3, 3, 3)  # Conv2d_1a_3x3's 32 output channels in halves
        rec = r["inc_record"]
        assert rec["params_bytes_per_device"] * 2 == rec["params_bytes_total"] == 23_885_392 * 4
        assert r["inc_gather"] == "before_program"
        assert r["inc_shared"] == (True, True)
        followed, kernel, block = r["inc_followed"]
        assert followed and kernel == (8, 3, 3, 3)
        rank = r["coords"][0] * 2 + r["coords"][1]
        quarter = INC_FEATURE // 4
        np.testing.assert_allclose(_np(block), unsharded[:, rank * quarter:(rank + 1) * quarter], rtol=0, atol=FEATURE_ATOL)
        assert "different mesh" in r["inc_cross"]


def test_bert_score_matches_jax_sharded_on_every_rank(world):
    from jax.sharding import PartitionSpec as JP

    import metrics_tpu as mj

    x, _, ranks = world
    jenc = _jax_table_encoder(x["bert_table"], _jax_mesh(), param_specs={"table": JP("mp", None)})
    jbert = mj.BERTScore(encoder_sharding=jenc, user_tokenizer=_tokenizer, max_length=BERT_LEN, batch_size=4, idf=True)
    jbert.update(*_corpus())
    want = jbert.compute()
    for r in ranks:
        assert r["bert_table_shard"] == (BERT_VOCAB // 2, BERT_DIM)
        for route in ("bert_functional", "bert_module"):
            for key in ("precision", "recall", "f1"):
                np.testing.assert_allclose(r[route][key], np.asarray(want[key]), rtol=0, atol=1e-6, err_msg=f"{route} {key}")
    for key in ("precision", "recall", "f1"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["bert_functional"][key], ranks[0]["bert_functional"][key])


# ---------------------------------------------------------------------------
# without a world: the errors, against the JAX package's
# ---------------------------------------------------------------------------
def _errors(make) -> tuple:
    try:
        make()
    except Exception as err:  # noqa: BLE001 - the error is the result
        return type(err).__name__, str(err)
    return None, None


def test_param_spec_of_wrong_rank_raises_like_jax():
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    import metrics_tpu as mj
    from metrics_tpu_torch.encoders import ShardedEncoder
    from metrics_tpu_torch.sharding import PartitionSpec as P

    table = np.zeros((VOCAB, DIM), np.float32)
    got = _errors(lambda: ShardedEncoder(_table_apply, {"table": torch.from_numpy(table)}, param_specs={"table": P("mp", None, "dp")}))
    want = _errors(lambda: mj.ShardedEncoder(_table_apply, {"table": jnp.asarray(table)}, param_specs={"table": JP("mp", None, "dp")}))
    assert got[0] == want[0] == "ValueError" and "names 3 dimensions" in got[1] and "names 3 dimensions" in want[1]


def test_param_specs_tree_of_wrong_length_raises_like_jax():
    import jax.numpy as jnp

    import metrics_tpu as mj
    from metrics_tpu_torch.encoders import ShardedEncoder

    w = np.zeros((4, 4), np.float32)
    got = _errors(lambda: ShardedEncoder(_feat_apply, {"a": torch.from_numpy(w), "b": torch.from_numpy(w), "c": torch.from_numpy(w)}, param_specs=["mp", None]))
    want = _errors(lambda: mj.ShardedEncoder(_feat_apply, {"a": jnp.asarray(w), "b": jnp.asarray(w), "c": jnp.asarray(w)}, param_specs=["mp", None]))
    assert got == want and got[0] == "ValueError" and "param_specs has 2 entries for 3" in got[1]


def test_axis_encoder_sharding_needs_the_builtin_network():
    import jax.numpy as jnp

    import metrics_tpu as mj
    import metrics_tpu_torch as mt

    got = _errors(lambda: mt.FrechetInceptionDistance(feature=lambda z: z, feature_dim=4, encoder_sharding="mp", device="cpu"))
    want = _errors(lambda: mj.FrechetInceptionDistance(feature=lambda z: jnp.asarray(z), feature_dim=4, encoder_sharding="mp"))
    assert got[0] == want[0] == "MetricsUserError" and "built-in" in got[1] and "built-in" in want[1]


def test_bert_score_encoder_sharding_must_be_a_runtime():
    import metrics_tpu as mj
    import metrics_tpu_torch as mt

    got = _errors(lambda: mt.BERTScore(encoder_sharding="mp", user_tokenizer=_tokenizer, device="cpu"))
    want = _errors(lambda: mj.BERTScore(encoder_sharding="mp", user_tokenizer=_tokenizer))
    assert got[0] == want[0] == "ValueError" and "ShardedEncoder" in got[1] and "ShardedEncoder" in want[1]


def test_in_specs_split_the_batch_axis_only():
    from metrics_tpu_torch.encoders import ShardedEncoder
    from metrics_tpu_torch.sharding import PartitionSpec as P

    table = {"table": torch.zeros(VOCAB, DIM)}
    with pytest.raises(ValueError, match="past its batch axis"):
        ShardedEncoder(_table_apply, table, in_specs=P("dp", "mp"), device="cpu")
    with pytest.raises(ValueError, match="out_spec must be"):
        ShardedEncoder(_table_apply, table, out_spec=3, device="cpu")
    enc = ShardedEncoder(_table_apply, table, in_specs=(P("dp"), None), out_spec="dp", device="cpu")
    assert enc.in_specs == (P("dp"), None) and enc.out_spec == P("dp")
    assert enc.batch_multiple() == 1 and enc.row_window(8) is None  # nothing staged off a mesh


def test_inception_param_specs_split_every_output_channel_axis():
    from metrics_tpu.image.networks.inception import inception_param_specs as jax_specs
    from metrics_tpu_torch.image.networks import inception as net

    specs, shapes, jspecs = net.inception_param_specs("mp"), net.inception_param_spec(), jax_specs("mp")
    assert set(specs) == set(shapes) == set(jspecs) and len(shapes) == 95
    total = 0
    for mod, group in shapes.items():
        assert set(specs[mod]) == set(group) == set(jspecs[mod])
        for name, shape in group.items():
            total += int(np.prod(shape))
            assert tuple(specs[mod][name]) == ("mp",) and shape[0] % 4 == 0, (mod, name, shape)
            # the same channel axis as the JAX package's HWIO spec names
            assert tuple(jspecs[mod][name])[-1] == "mp"
    assert total == 23_885_392


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
