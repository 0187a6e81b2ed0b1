"""The port's sync wire (``metrics_tpu_torch/parallel/{groups,quantize}.py``
and the ``wire`` schema family) against ``metrics_tpu`` on the same numpy
inputs:

* wire v1 payloads byte-identical to the JAX package's ``_encode`` across
  float16/32/64, int32/64, bool, 0-d, empty and big-endian input, and tree
  payloads (the structure fingerprint is the crc32 of the JAX ``treedef``
  string) byte-identical too;
* wire v2 bf16 and int8 payloads byte-identical, NaN and ±Inf included (the
  port writes NaN as ml_dtypes does: ``0x7FC0`` with the sign);
* every payload decoded across both ways, bit for bit;
* the golden ``tests/compat/golden/wire_v{1,2}.bin`` through the port's
  ``schema.decode_any("wire", ...)``, equal to the JAX decode, and
  ``wire_v99.bin`` rejected by name;
* the single-bit envelope fuzz of ``tests/parallel/test_envelope_fuzz.py``:
  every flip loud, with the JAX package's exception type and ``transient``
  flag on the same flipped bytes;
* the codecs against ``quantize_array`` and ``encode_in_jax`` bit for bit
  (codes and scales): a partial last block, an all-zero block, integer and
  bool passthrough, and ``error_bound`` held;
* the ``torch.distributed`` path of ``gather_all_arrays`` moving the codes:
  a gloo world of one in this process, and the ragged pad-to-max path over
  a stand-in two-rank gather.

Exact equality everywhere: a codec is bit-exact or it is wrong.
"""
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "compat", "golden")


def _jax_groups():
    from metrics_tpu.parallel import groups

    return groups


def _port_groups():
    from metrics_tpu_torch.parallel import groups

    return groups


def _jq():
    from metrics_tpu.parallel import quantize

    return quantize


def _pq():
    from metrics_tpu_torch.parallel import quantize

    return quantize


def _np(x) -> np.ndarray:
    """A decoded array as numpy (a bfloat16 tensor through float32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _round_trip(arr: np.ndarray, codec: str) -> np.ndarray:
    """The JAX package's numpy codec there and back."""
    jq = _jq()
    q, scales, _ = jq.quantize_array(arr, codec)
    return jq.dequantize_array(q, scales, codec, arr.dtype, arr.shape)


def _same(got, want) -> None:
    """Equal dtype kind, shape and bits (NaN where NaN)."""
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.dtype.name == "bfloat16":
        w = w.astype(np.float32)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


_RNG = np.random.default_rng(0)
EXACT_CASES = {
    "float16": _RNG.normal(size=(5, 3)).astype(np.float16),
    "float32": _RNG.normal(size=(7,)).astype(np.float32),
    "float64": _RNG.normal(size=(2, 2, 3)),
    "int32": _RNG.integers(-9, 9, (11,)).astype(np.int32),
    "int64": _RNG.integers(-(2**40), 2**40, (3, 4)),
    "bool": _RNG.random(9) > 0.5,
    "uint8": np.arange(6, dtype=np.uint8),
    "zero_dim": np.asarray(3.5, np.float32),
    "zero_dim_int": np.asarray(7, np.int64),
    "empty": np.zeros((0, 4), np.float32),
    "big_endian": np.arange(6, dtype=">f4").reshape(2, 3),
    "big_endian_int": np.arange(5, dtype=">i8"),
    "nonfinite": np.asarray([np.nan, -np.inf, np.inf, -0.0], np.float32),
}


@pytest.mark.parametrize("case", sorted(EXACT_CASES))
def test_v1_payload_is_byte_identical_and_decodes_both_ways(case):
    jg, pg = _jax_groups(), _port_groups()
    arr = EXACT_CASES[case]
    want = jg._encode(arr)
    assert pg._encode(arr) == want
    # the same array handed over as a tensor (native order) encodes alike
    native = arr.astype(arr.dtype.newbyteorder("="))
    assert pg._encode(torch.from_numpy(np.array(native))) == want
    assert want[2] == pg.WIRE_VERSION
    _same(pg._decode(want), native)
    _same(jg._decode(pg._encode(arr)), native)


def test_v1_layout_matches_the_wire_format():
    pg = _port_groups()
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    header = json.dumps({"dtype": "float32", "shape": [3, 4]}).encode()
    body = struct.pack(">I", len(header)) + header + arr.tobytes()
    assert pg._encode(torch.from_numpy(arr)) == struct.pack(">2sBI", b"MT", 1, zlib.crc32(body)) + body


QUANT_CASES = {
    "f32_normal": _RNG.normal(size=(1000,)).astype(np.float32) * 37,
    "f64_wide": _RNG.normal(size=(37, 11)) * np.exp(_RNG.uniform(-20, 20, (37, 11))),
    "f16": _RNG.normal(size=(300,)).astype(np.float16),
    "partial_block": _RNG.normal(size=(257,)).astype(np.float32),
    "zero_block": np.concatenate([np.zeros(256, np.float32), _RNG.normal(size=100).astype(np.float32)]),
    "one_block": _RNG.normal(size=(256,)).astype(np.float32),
    "zero_dim": np.asarray(-2.75, np.float32),
    "empty": np.zeros((0,), np.float32),
    "empty_3d": np.zeros((3, 0, 2), np.float64),
    "nan_and_inf": np.asarray([np.nan, -np.nan, np.inf, -np.inf, 1.5, -0.0, 3e38, 1e-40], np.float32),
    "nan_block": np.concatenate([_RNG.normal(size=256), [np.nan, 2.0, -np.nan]]).astype(np.float32),
    "big_endian": (np.arange(300, dtype=">f4") / 7),
}


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_v2_payload_is_byte_identical_and_decodes_both_ways(case, precision):
    jg, pg = _jax_groups(), _port_groups()
    arr = QUANT_CASES[case]
    with np.errstate(invalid="ignore"):
        want = jg._encode(arr, precision)
        got = pg._encode(arr, precision)
        assert got == want
        assert got[2] == pg.WIRE_VERSION_QUANTIZED
        _same(pg._decode(want), jg._decode(want))
        _same(jg._decode(got), jg._decode(want))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint8, np.bool_])
@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_integer_and_bool_pass_through_exact(dtype, precision):
    jg, pg = _jax_groups(), _port_groups()
    arr = np.arange(10).astype(dtype)
    payload = pg._encode(arr, precision)
    assert payload[2] == pg.WIRE_VERSION and payload == jg._encode(arr, precision)
    _same(pg._decode(payload), arr)


def test_tree_payloads_are_byte_identical():
    import jax
    import jax.numpy as jnp

    jg, pg = _jax_groups(), _port_groups()
    arrays = {
        "tp": np.arange(3.0),
        "buf": np.ones((2, 2), np.float32),
        "n": np.asarray(4, np.int64),
        "scores": _RNG.normal(size=(300,)).astype(np.float32),
    }
    jtree = {"tp": jnp.asarray(arrays["tp"]), "buf": [jnp.asarray(arrays["buf"])], "n": jnp.asarray(arrays["n"]),
             "pair": (jnp.asarray(arrays["scores"]), None), "e": []}
    ttree = {"tp": torch.from_numpy(arrays["tp"]), "buf": [torch.from_numpy(arrays["buf"])],
             "n": torch.from_numpy(arrays["n"]), "pair": (torch.from_numpy(arrays["scores"]), None), "e": []}
    _, treedef = jax.tree_util.tree_flatten(jtree)
    assert pg._tree_signature(pg._flatten(ttree)[1]) == jg._tree_signature(treedef)
    # a None inside a state misaligns the JAX package's tags, and the whole
    # tree then travels exact; without it the tags apply
    for precisions in (None, {"pair": "int8", "tp": "bf16"}, {"buf": "int8", "tp": "bf16"}):
        want = jg._encode_tree(jtree, precisions=precisions)
        assert pg._encode_tree(ttree, precisions=precisions) == want
        leaves, spec = pg._flatten(ttree)
        back = pg._decode_tree(want, spec, len(leaves))
        jback = jg._decode_tree(want, treedef, len(leaves))
        for a, b in zip(pg._flatten(back)[0], jax.tree_util.tree_leaves(jback)):
            _same(a, np.asarray(b))
    # a tree of another structure is refused before any leaf is read
    with pytest.raises(ValueError, match="structurally identical"):
        pg._decode_tree(pg._encode_tree({"A": [torch.zeros(2)], "B": []}), pg._flatten({"A": [], "B": [0]})[1], 1)


def _golden():
    with open(os.path.join(GOLDEN, "index.json")) as fh:
        return [e for e in json.load(fh)["artifacts"] if e["family"] == "wire"]


@pytest.mark.parametrize("entry", _golden(), ids=lambda e: e["file"])
def test_golden_wire_artifacts_decode_through_the_port_schema(entry):
    from metrics_tpu.resilience import schema as jschema
    from metrics_tpu_torch.resilience import schema
    from metrics_tpu_torch.utils.exceptions import SchemaVersionError

    with open(os.path.join(GOLDEN, entry["file"]), "rb") as fh:
        raw = fh.read()
    assert schema.registered_versions("wire") == jschema.registered_versions("wire") == [1, 2]
    before = schema.compat_stats()["wire"]
    if entry["expect"] == "ok":
        got = schema.decode_any("wire", raw, context=" (golden)")
        _same(got, jschema.decode_any("wire", raw, context=" (golden)"))
        after = schema.compat_stats()["wire"]
        assert after["decodes"] == before["decodes"] + 1
        assert after["upcasts"] == before["upcasts"] + (1 if entry["version"] == 1 else 0)
        return
    with pytest.raises(SchemaVersionError, match="NEWER build") as exc:
        schema.decode_any("wire", raw, context=" (golden)")
    assert (exc.value.family, exc.value.version, exc.value.current) == ("wire", 99, 2)
    assert schema.compat_stats()["wire"]["rejects"] == before["rejects"] + 1


# ---------------------------------------------------------------------------
# the envelope fuzz, on both packages' decoders
# ---------------------------------------------------------------------------
_HEADER_BITS = 7 * 8
_BODY_SAMPLES = 64


def _flip(payload: bytes, bit: int) -> bytes:
    raw = bytearray(payload)
    raw[bit // 8] ^= 1 << (bit % 8)
    return bytes(raw)


def _fuzz_bits(payload: bytes, seed: int):
    nbits = len(payload) * 8
    bits = list(range(min(_HEADER_BITS, nbits)))
    if nbits > _HEADER_BITS:
        rng = np.random.RandomState(seed)
        picks = rng.choice(nbits - _HEADER_BITS, size=min(_BODY_SAMPLES, nbits - _HEADER_BITS), replace=False)
        bits.extend(sorted({_HEADER_BITS, nbits - 1, *(int(p) + _HEADER_BITS for p in picks)}))
    return bits


def _outcome(decode, payload):
    try:
        decode(payload)
    except Exception as err:  # noqa: BLE001 - compared across packages below
        return type(err).__name__, getattr(err, "transient", None)
    return None


FUZZ_PAYLOADS = {
    "raw_body": lambda g: g.pack_envelope(np.random.RandomState(0).bytes(257)),
    "exact_v1": lambda g: g._encode(np.random.RandomState(2).rand(17, 3).astype(np.float32)),
    "int8_v2": lambda g: g._encode(np.random.RandomState(4).rand(130).astype(np.float32), "int8"),
    "bf16_v2": lambda g: g._encode(np.random.RandomState(5).rand(40).astype(np.float32), "bf16"),
    "zero_dim": lambda g: g._encode(np.asarray(3.0, np.float32)),
}


@pytest.mark.parametrize("kind", sorted(FUZZ_PAYLOADS))
def test_every_single_bit_flip_is_loud_and_classified_as_in_jax(kind):
    jg, pg = _jax_groups(), _port_groups()
    payload = FUZZ_PAYLOADS[kind](pg)
    assert payload == FUZZ_PAYLOADS[kind](jg)
    if kind == "raw_body":
        port_decode, jax_decode = pg.unpack_envelope, jg.unpack_envelope
    else:
        port_decode, jax_decode = pg._decode, jg._decode
    port_decode(payload)  # no false positive
    for bit in _fuzz_bits(payload, seed=len(kind)):
        flipped = _flip(payload, bit)
        got = _outcome(port_decode, flipped)
        assert got is not None, f"bit {bit} decoded silently"
        assert got[0] == "SyncIntegrityError", (bit, got)
        assert got == _outcome(jax_decode, flipped), bit


def test_envelope_errors_carry_the_jax_flags():
    from metrics_tpu_torch.utils.exceptions import SyncIntegrityError

    pg = _port_groups()
    payload = pg._encode(np.arange(10.0))
    with pytest.raises(SyncIntegrityError, match="[Tt]runcated"):
        pg._open_envelope(payload[:4])
    with pytest.raises(SyncIntegrityError, match="crc32") as exc:
        pg._decode(payload[:-8])
    assert exc.value.transient
    wrong = bytearray(payload)
    wrong[2] = 3
    with pytest.raises(SyncIntegrityError, match="version mismatch") as exc:
        pg._decode(bytes(wrong))
    assert not exc.value.transient
    with pytest.raises(SyncIntegrityError, match="wire magic") as exc:
        pg._decode(struct.pack(">I", 10) + b"x" * 30)
    assert not exc.value.transient
    header = json.dumps({"dtype": "float32", "shape": [8]}).encode()
    with pytest.raises(SyncIntegrityError, match="length mismatch"):
        pg._decode(pg._seal(struct.pack(">I", len(header)) + header + np.arange(6, dtype=np.float32).tobytes()))
    # an exact header under a v2 envelope, and a foreign int8 block size
    body = struct.pack(">I", len(header)) + header + np.arange(8, dtype=np.float32).tobytes()
    with pytest.raises(SyncIntegrityError, match="version mismatch") as exc:
        pg._decode(pg._seal(body, pg.WIRE_VERSION_QUANTIZED))
    assert not exc.value.transient
    h8 = json.dumps({"dtype": "float32", "shape": [4], "codec": "int8", "block": 128}).encode()
    with pytest.raises(SyncIntegrityError, match="block size 128") as exc:
        pg._decode(pg._seal(struct.pack(">I", len(h8)) + h8 + b"\0" * 8, pg.WIRE_VERSION_QUANTIZED))
    assert not exc.value.transient
    with pytest.raises(ValueError, match="speaks"):
        pg.pack_envelope(b"abc", version=9)
    for version in pg.SUPPORTED_WIRE_VERSIONS:
        for bit in range(8):
            assert (version ^ (1 << bit)) not in pg.SUPPORTED_WIRE_VERSIONS


# ---------------------------------------------------------------------------
# the codecs themselves
# ---------------------------------------------------------------------------
CODEC_CASES = {k: v for k, v in QUANT_CASES.items() if k != "big_endian"}


@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codes_and_scales_equal_quantize_array_and_encode_in_jax(case, codec):
    import jax.numpy as jnp

    jq, pq = _jq(), _pq()
    arr = CODEC_CASES[case]
    with np.errstate(invalid="ignore"):
        qd, sc, meta = jq.quantize_array(arr, codec)
        jqd, jsc = jq.encode_in_jax(jnp.asarray(arr), codec)
    tq, ts, tmeta = pq.quantize_array(torch.from_numpy(arr), codec)
    assert tmeta == meta
    bits = (lambda a: np.asarray(a).view(np.uint16)) if codec == "bf16" else np.asarray
    port_bits = (lambda t: t.view(torch.int16).numpy().view(np.uint16)) if codec == "bf16" else (lambda t: t.numpy())
    np.testing.assert_array_equal(port_bits(tq), bits(qd))
    if not np.isnan(arr).any() or codec == "bf16":
        # XLA's NaN-to-int8 cast is its own; the numpy codec is the wire's
        np.testing.assert_array_equal(port_bits(tq), bits(jqd))
    if codec == "int8":
        assert ts.dtype == torch.float32
        np.testing.assert_array_equal(ts.numpy().view(np.uint32), sc.view(np.uint32))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(jsc))
    else:
        assert ts is None and sc is None
    back = pq.dequantize_array(tq, ts, codec, torch.from_numpy(arr).dtype, arr.shape)
    want = jq.dequantize_array(qd, sc, codec, arr.dtype, arr.shape)
    _same(back, want)
    # the bound is the codec's; a float16 state adds its own rounding on decode
    if arr.size and np.isfinite(arr).all() and arr.dtype != np.float16:
        bound = pq.error_bound(codec, float(np.max(np.abs(arr))))
        assert bound == jq.error_bound(codec, float(np.max(np.abs(arr))))
        assert float(np.max(np.abs(_np(back).astype(np.float64) - arr))) <= bound


def test_resolve_codec_and_error_bound_match():
    jq, pq = _jq(), _pq()
    for precision in (None, "exact", "bf16", "int8"):
        for dtype in (np.float32, np.float64, np.float16, np.int32, np.bool_, np.uint8):
            assert pq.resolve_codec(precision, dtype) == jq.resolve_codec(precision, dtype)
            assert pq.resolve_codec(precision, torch.from_numpy(np.zeros(1, dtype)).dtype) == jq.resolve_codec(precision, dtype)
        assert pq.resolve_codec(precision, torch.bfloat16) == jq.resolve_codec(precision, np.dtype("bfloat16"))
    with pytest.raises(ValueError, match="sync_precision"):
        pq.resolve_codec("fp4", np.float32)
    for codec in pq.CODECS:
        assert pq.error_bound(codec, 3.0) == jq.error_bound(codec, 3.0)
    assert pq.INT8_BLOCK == jq.INT8_BLOCK and pq.CODECS == jq.CODECS


def test_wire_counters_and_events_follow_the_jax_rules():
    from metrics_tpu_torch import obs
    from metrics_tpu_torch.resilience import new_sync_stats

    pg, pq = _port_groups(), _pq()
    pq.reset_wire_stats()
    report = new_sync_stats()
    arr = np.zeros(4 * pq.INT8_BLOCK, np.float32)
    with obs.capture() as events:
        pg._encode(arr, "int8", stats=report)
        pg._encode(np.arange(64, dtype=np.int32), "int8", stats=report)
    assert report["bytes_raw_quantized"] == 4096 and report["bytes_encoded_quantized"] == 1024 + 16
    assert report["bytes_raw"] == 4096 + 256 and report["codec_counts"] == {"exact": 1, "bf16": 0, "int8": 1}
    assert pq.wire_stats()["codec_counts"] == report["codec_counts"]
    (wire,) = [e for e in events if e.kind == "wire"]  # quantized payloads only
    assert wire.source == "kv" and wire.data["codec"] == "int8" and wire.data["bytes_encoded"] == 1040
    assert obs.snapshot()["wire"] == pq.wire_stats()
    pq.reset_wire_stats()
    assert pq.wire_stats()["bytes_raw"] == 0


# ---------------------------------------------------------------------------
# the torch.distributed path: codes through all_gather
# ---------------------------------------------------------------------------
@pytest.fixture
def gloo_world_of_one():
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fixed_shape", [True, False])
@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_all_gather_moves_the_codes_in_a_world_of_one(gloo_world_of_one, precision, fixed_shape):
    from metrics_tpu_torch.parallel import comm
    from metrics_tpu_torch.resilience import new_sync_stats

    arr = (_RNG.normal(size=(700,)) * 5).astype(np.float32)
    report = new_sync_stats()
    (got,) = comm.gather_all_arrays(torch.from_numpy(arr), fixed_shape=fixed_shape, precision=precision, report=report)
    want = _round_trip(arr, precision)
    _same(got, want)
    encoded = 700 * 2 if precision == "bf16" else 700 + 3 * 4
    assert report["bytes_raw_quantized"] == 2800 and report["bytes_encoded_quantized"] == encoded
    assert report["codec_counts"][precision] == 1 and report["max_dequant_error"] > 0
    # counts stay exact whatever the tag
    (ints,) = comm.gather_all_arrays(torch.arange(9), fixed_shape=fixed_shape, precision=precision, report=report)
    assert torch.equal(ints, torch.arange(9)) and report["codec_counts"]["exact"] == 1


def test_tagged_metric_syncs_its_codes_in_a_world_of_one(gloo_world_of_one):
    import metrics_tpu_torch as mt

    arr = (_RNG.normal(size=(3, 300)) * 2).astype(np.float32)

    class Tagged(mt.Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("total", default=torch.zeros(300), dist_reduce_fx="sum", sync_precision="int8")
            self.add_state("scores", default=[], dist_reduce_fx="cat", sync_precision="bf16")
            self.add_state("n", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum", sync_precision="int8")

        def update(self, x):
            self.total = self.total + x.sum(0)
            self.scores.append(x.reshape(-1))
            self.n = self.n + x.shape[0]

        def compute(self):
            return {"total": self.total, "scores": mt.utils.data.dim_zero_cat(self.scores), "n": self.n}

    m = Tagged(device="cpu")
    m.update(torch.from_numpy(arr))
    got = m.compute()
    total = arr.sum(0)
    _same(got["total"], _round_trip(total, "int8"))
    flat = arr.reshape(-1)
    _same(got["scores"], _round_trip(flat, "bf16"))
    assert int(got["n"]) == 3
    report = m.sync_report()
    assert report["codec_counts"] == {"exact": 1, "bf16": 1, "int8": 1} and report["last_sync_outcome"] == "complete"
    assert torch.equal(m.total, torch.from_numpy(total))  # unsynced after compute()


def test_ragged_all_gather_pads_quantizes_and_trims(monkeypatch):
    """Two ranks of different lengths through the pad-to-max path: a
    stand-in all-gather answers each collective with this rank's buffer and
    a recorded peer buffer, as a gloo world of two would."""
    from metrics_tpu_torch.parallel import comm

    mine = (_RNG.normal(size=(300,)) * 3).astype(np.float32)
    peer = (_RNG.normal(size=(513,)) * 3).astype(np.float32)
    peer_q, peer_s, _ = _pq().quantize_array(torch.from_numpy(peer), "int8")
    peer_record = torch.tensor([1, comm._DTYPES.index(torch.float32), 1, 513] + [0] * (comm._MAX_DIMS - 1))

    def peer_buffer(flat):
        """The peer's part of this collective: its shape record, codes or scales."""
        return {torch.int64: peer_record, torch.int8: peer_q, torch.float32: peer_s}[flat.dtype]

    def fake_all_gather(x, group, report=None):
        flat = x.reshape(-1).contiguous()
        return [flat.clone(), peer_buffer(flat)]

    monkeypatch.setattr(comm, "distributed_available", lambda: True)
    monkeypatch.setattr(comm, "_all_gather_flat", fake_all_gather)
    monkeypatch.setattr(comm.dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(comm.dist, "get_world_size", lambda group=None: 2)
    got = comm.gather_all_arrays(torch.from_numpy(mine), precision="int8")
    assert [tuple(g.shape) for g in got] == [(300,), (513,)]
    padded_mine = np.zeros(513, np.float32)
    padded_mine[:300] = mine
    want_mine = _round_trip(padded_mine, "int8")[:300]
    _same(got[0], want_mine)
    _same(got[1], _round_trip(peer, "int8"))
