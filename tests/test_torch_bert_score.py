"""The port's BERTScore against ``metrics_tpu`` on the same inputs.

Both packages use the toy tokenizer and embedding table of
``tests/text/test_bert.py`` (the own-model contract); the port's model is
the same lookup on torch tensors. Scores agree within 1e-6 (1e-5 against
the numpy oracle and on the ``transformers`` default, whose two networks
differ by float32 rounding).
"""
import importlib.util
import os
import socket
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu.functional.text.bert import bert_score as jax_bert_score
from metrics_tpu_torch.encoders import ShardedEncoder, encoder_stats, reset_encoder_stats
from metrics_tpu_torch.engine import cache as engine_cache
from metrics_tpu_torch.engine.bucketing import next_pow2
from metrics_tpu_torch.functional.text.bert import bert_score
from metrics_tpu_torch.utils.exceptions import JitIncompatibleError
from tests.text.test_bert import (
    _BASELINE_ROWS,
    _EMB_TABLE,
    MAX_LEN,
    N_LAYERS,
    PREDS,
    TARGETS,
    _np_bertscore,
    _write_baseline_csv,
    toy_model,
    toy_model_layers,
    toy_tokenizer,
)

KEYS = ("precision", "recall", "f1")
TABLE = torch.from_numpy(_EMB_TABLE)
# a longer corpus, so that chunks are ragged and pow2 buckets trim the width
WORDS = "the cat sat on a mat dog ran fast hello world good morning night zebra".split()
_RNG = np.random.default_rng(21)
LONG_PREDS = [" ".join(_RNG.choice(WORDS, _RNG.integers(1, 13))) for _ in range(11)]
LONG_TARGETS = [" ".join(_RNG.choice(WORDS, _RNG.integers(1, 13))) for _ in range(11)]
LONG_LEN = 16


def port_model(input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """``toy_model`` on torch tensors: table lookup plus a positional mix."""
    pos = torch.sin(torch.arange(input_ids.shape[1], dtype=torch.float64))[None, :, None] * 0.1
    return (TABLE[input_ids] + pos) * attention_mask[..., None]


def port_model_layers(input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """``toy_model_layers`` on torch tensors: ``[layers, N, L, d]``."""
    base = port_model(input_ids, attention_mask)
    layers = torch.stack([base * (1.0 + 0.3 * k) + 0.05 * k for k in range(N_LAYERS)])
    return layers * attention_mask[None, ..., None]


def _assert_scores(got: dict, want: dict, atol: float = 1e-6) -> None:
    for key in KEYS:
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), rtol=0, atol=atol, err_msg=key)


def _both(preds, targets, layers: bool = False, **kwargs):
    got = bert_score(preds, targets, model=port_model_layers if layers else port_model, user_tokenizer=toy_tokenizer, device="cpu", **kwargs)
    want = jax_bert_score(preds, targets, model=toy_model_layers if layers else toy_model, user_tokenizer=toy_tokenizer, **kwargs)
    return got, want


@pytest.mark.parametrize("idf", [False, True])
@pytest.mark.parametrize("batch_size,length_bucketing", [(64, True), (64, False), (4, True), (4, False), (1, True)])
def test_functional_matches_jax(idf, batch_size, length_bucketing):
    kwargs = {"idf": idf, "batch_size": batch_size, "length_bucketing": length_bucketing}
    got, want = _both(PREDS, TARGETS, max_length=MAX_LEN, **kwargs)
    _assert_scores(got, want)
    _assert_scores(got, _np_bertscore(PREDS, TARGETS, idf=idf), atol=1e-5)
    got, want = _both(LONG_PREDS, LONG_TARGETS, max_length=LONG_LEN, **kwargs)
    _assert_scores(got, want)


def test_chunking_and_bucketing_give_the_same_scores():
    reset_encoder_stats()
    runs = [
        bert_score(LONG_PREDS, LONG_TARGETS, model=port_model, user_tokenizer=toy_tokenizer, max_length=LONG_LEN,
                   batch_size=b, length_bucketing=lb, device="cpu", idf=True)
        for b in (1, 3, 64) for lb in (True, False)
    ]
    for run in runs[1:]:
        _assert_scores(run, runs[0], atol=1e-12)
    assert encoder_stats()["bucketed_dispatches"] > 0


def test_all_layers_and_per_layer_rescale_match_jax(tmp_path):
    path = _write_baseline_csv(tmp_path / "baseline.csv")
    for kwargs in ({}, {"batch_size": 2}, {"rescale_with_baseline": True, "baseline_path": path}):
        got, want = _both(PREDS, TARGETS, layers=True, max_length=MAX_LEN, all_layers=True, **kwargs)
        assert np.asarray(got["f1"]).shape == (N_LAYERS, len(PREDS))
        _assert_scores(got, want)


def test_all_layers_errors_match_jax(tmp_path):
    with pytest.raises(ValueError, match="rank-4"):
        bert_score(PREDS, TARGETS, model=port_model, user_tokenizer=toy_tokenizer, max_length=MAX_LEN, all_layers=True, device="cpu")
    with pytest.raises(ValueError, match="rank-3"):
        bert_score(PREDS, TARGETS, model=port_model_layers, user_tokenizer=toy_tokenizer, max_length=MAX_LEN, device="cpu")
    path = tmp_path / "mismatch.csv"
    with open(path, "w") as f:
        f.write("LAYER,P,R,F\n" + "".join(f"{i},0.3,0.35,0.32\n" for i in range(N_LAYERS + 2)))
    for fn, model in ((bert_score, port_model_layers), (jax_bert_score, toy_model_layers)):
        kwargs = {"device": "cpu"} if fn is bert_score else {}
        with pytest.raises(ValueError, match="baseline row per layer"):
            fn(PREDS, TARGETS, model=model, user_tokenizer=toy_tokenizer, max_length=MAX_LEN, all_layers=True,
               rescale_with_baseline=True, baseline_path=str(path), **kwargs)


@pytest.mark.parametrize("num_layers", [None, 1])
def test_rescale_with_a_local_baseline_matches_jax(tmp_path, num_layers):
    path = _write_baseline_csv(tmp_path / "baseline.csv")
    raw, _ = _both(PREDS, TARGETS, max_length=MAX_LEN)
    got, want = _both(PREDS, TARGETS, max_length=MAX_LEN, rescale_with_baseline=True, baseline_path=path, num_layers=num_layers)
    _assert_scores(got, want)
    row = _BASELINE_ROWS[-1 if num_layers is None else num_layers]
    for col, key in enumerate(KEYS):
        np.testing.assert_allclose(got[key], (np.asarray(raw[key]) - row[col]) / (1 - row[col]), rtol=0, atol=1e-12)
    bad = tmp_path / "five_columns.csv"
    with open(bad, "w") as f:
        f.write("LAYER,P,R,F,EXTRA\n0,0.3,0.35,0.32,0.9\n")
    with pytest.raises(ValueError, match="exactly"):
        bert_score(PREDS, TARGETS, model=port_model, user_tokenizer=toy_tokenizer, rescale_with_baseline=True,
                   baseline_path=str(bad), device="cpu")
    with pytest.raises(ValueError, match="baseline_path"):
        bert_score(PREDS, TARGETS, model=port_model, user_tokenizer=toy_tokenizer, rescale_with_baseline=True, device="cpu")


def test_edge_cases_match_jax(tmp_path):
    got, want = _both(PREDS, TARGETS, max_length=MAX_LEN, return_hash=True, idf=True, num_layers=3)
    assert got["hash"] == want["hash"]
    got, want = _both(["hello world", ""], ["", "hello world"], max_length=MAX_LEN)
    _assert_scores(got, want)
    assert all(np.isfinite(got[k]).all() for k in KEYS)
    path = _write_baseline_csv(tmp_path / "baseline.csv")
    for layers in (False, True):
        for kwargs in ({}, {"rescale_with_baseline": True, "baseline_path": path}):
            got, want = _both([], [], layers=layers, max_length=MAX_LEN, all_layers=layers, **kwargs)
            assert got == want == {k: [] for k in KEYS}
    for fn, model in ((bert_score, port_model), (jax_bert_score, toy_model)):
        kwargs = {"device": "cpu"} if fn is bert_score else {}
        with pytest.raises(ValueError, match="must be the same"):
            fn(["a", "b"], ["a"], model=model, user_tokenizer=toy_tokenizer, **kwargs)
        with pytest.raises(ValueError, match="`user_tokenizer` must be provided"):
            fn(PREDS, TARGETS, model=model, **kwargs)
        with pytest.raises(ValueError, match="a user `model` must be provided"):
            fn(PREDS, TARGETS, user_tokenizer=toy_tokenizer, **kwargs)
    with pytest.raises(ValueError, match="`user_tokenizer` must be provided"):
        mt.BERTScore(model=port_model, device="cpu")
    metric = mt.BERTScore(model=port_model, user_tokenizer=toy_tokenizer, max_length=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="must be the same"):
        metric.update(["a"], ["a", "b"])


@pytest.mark.parametrize("idf", [False, True])
def test_module_streams_like_the_functional_and_jax(idf):
    """idf is taken over the accumulated corpus: one sentence per update."""
    port = mt.BERTScore(model=port_model, user_tokenizer=toy_tokenizer, max_length=LONG_LEN, idf=idf, batch_size=4, device="cpu")
    ref = mj.BERTScore(model=toy_model, user_tokenizer=toy_tokenizer, max_length=LONG_LEN, idf=idf, batch_size=4)
    for i in range(len(LONG_PREDS)):
        port.update(LONG_PREDS[i : i + 1], LONG_TARGETS[i : i + 1])
        ref.update(LONG_PREDS[i : i + 1], LONG_TARGETS[i : i + 1])
    assert port.preds_input_ids[0].dtype == torch.int64 and port.preds_input_ids[0].shape == (1, LONG_LEN)
    got = port.compute()
    direct = bert_score(LONG_PREDS, LONG_TARGETS, model=port_model, user_tokenizer=toy_tokenizer, max_length=LONG_LEN, idf=idf, device="cpu")
    _assert_scores(got, direct, atol=1e-12)
    _assert_scores(got, ref.compute())
    port.reset()
    assert port.preds_input_ids == []


def test_sharded_encoder_route_equals_the_plain_route():
    """One ``encode`` program per ``(rows, width)`` signature, and the same
    scores as the plain callable, with bucketing on and off."""
    engine_cache.clear_cache()
    enc = ShardedEncoder.from_callable(port_model, device="cpu")
    for bucketing in (True, False):
        plain = mt.BERTScore(model=port_model, user_tokenizer=toy_tokenizer, max_length=LONG_LEN, idf=True, batch_size=4,
                             length_bucketing=bucketing, device="cpu")
        sharded = mt.BERTScore(encoder_sharding=enc, user_tokenizer=toy_tokenizer, max_length=LONG_LEN, idf=True,
                               batch_size=4, length_bucketing=bucketing, device="cpu")
        for m in (plain, sharded):
            m.update(LONG_PREDS, LONG_TARGETS)
        _assert_scores(sharded.compute(), plain.compute(), atol=1e-12)
    assert engine_cache.encoder_entry(enc).summary()["compiles"] == len(_signatures(4, LONG_LEN)) >= 3
    with pytest.raises(ValueError, match="ShardedEncoder"):
        mt.BERTScore(encoder_sharding=port_model, user_tokenizer=toy_tokenizer, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        mt.BERTScore(encoder_sharding=enc, model=port_model, user_tokenizer=toy_tokenizer, device="cpu")


def _signatures(batch_size: int, max_length: int) -> set:
    """The ``(rows, width)`` encoder inputs of the long corpus's chunks, with
    bucketing on and off."""
    out = {(min(batch_size, len(LONG_PREDS) - s), max_length) for s in range(0, len(LONG_PREDS), batch_size)}
    for text in (LONG_PREDS, LONG_TARGETS):
        mask = toy_tokenizer(text, max_length)["attention_mask"]
        for s in range(0, len(text), batch_size):
            rows = mask[s : s + batch_size].shape[0]
            width = min(max_length, next_pow2(int(np.flatnonzero(mask[s : s + batch_size].any(0))[-1]) + 1))
            out.add((rows if rows >= batch_size else next_pow2(rows), width))
    return out


def test_an_encoder_that_cannot_run_as_a_program_raises():
    """A ``ShardedEncoder`` forward that waits for the device (here a
    ``.item()``) is refused as a program, and the pass raises: there is no
    eager fallback."""

    def host_reading(input_ids, attention_mask):
        scale = float(attention_mask.sum().item())
        return port_model(input_ids, attention_mask) * scale

    enc = ShardedEncoder.from_callable(host_reading, device="cpu")
    metric = mt.BERTScore(encoder_sharding=enc, user_tokenizer=toy_tokenizer, max_length=MAX_LEN, device="cpu")
    metric.update(PREDS, TARGETS)
    with pytest.raises(JitIncompatibleError):
        metric.compute()


def test_bert_score_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        metric = mt.BERTScore(model=port_model, user_tokenizer=toy_tokenizer, max_length=MAX_LEN)
        assert metric.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mt.BERTScore(model=port_model, user_tokenizer=toy_tokenizer)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bert_score(PREDS, TARGETS, model=port_model, user_tokenizer=toy_tokenizer)


def test_empty_and_full_ranks_sync_on_gloo(tmp_path):
    """Rank 0 holds three sentences, rank 1 none: both compute rank 0's
    scores; two empty buffers sync to the placeholder's int64 ``[0, L]``."""
    from tests.test_torch_sync import _run_world

    results = _run_world(2, tmp_path, mode="bert_score")
    want = bert_score(PREDS, TARGETS, model=port_model, user_tokenizer=toy_tokenizer, max_length=MAX_LEN, device="cpu")
    for rank, res in enumerate(results):
        _assert_scores(res["scores"], want, atol=1e-12)
        for name, value in res["empty"].items():
            assert value.dtype == torch.int64 and tuple(value.shape) == (0, MAX_LEN), (rank, name)
        assert res["empty_compute"] == {k: [] for k in KEYS}


# ---------------------------------------------------------------------------
# the transformers default, on a tiny BERT built and saved locally
# ---------------------------------------------------------------------------
requires_hf = pytest.mark.skipif(
    importlib.util.find_spec("transformers") is None or importlib.util.find_spec("flax") is None,
    reason="transformers and flax are needed to build the tiny BERT for both packages",
)
_HF_VOCAB = (
    "[PAD] [UNK] [CLS] [SEP] [MASK] the cat sat on mat dog ran fast hello world "
    "good morning night a an is was very not so much more".split()
)
_HF_PREDS = ["the cat sat on the mat", "hello world good morning", "a dog ran very fast", "the night was not so good"]
_HF_TARGETS = ["a cat sat on a mat", "good morning hello world", "the dog ran fast", "the morning was very good"]


@pytest.fixture(scope="module")
def tiny_bert_dir(tmp_path_factory):
    """The tiny ``BertConfig`` of ``tests/text/test_bert_hf.py`` as a
    ``FlaxBertModel`` (seed 7), saved with ``save_pretrained``, and the same
    weights as a torch ``BertModel`` saved beside it, so that both packages
    read one directory."""
    set_here = "USE_TF" not in os.environ
    os.environ.setdefault("USE_TF", "0")  # read once, when transformers is first imported
    try:
        from transformers import BertConfig, BertModel, BertTokenizerFast, FlaxBertModel
        from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model
    finally:
        if set_here:
            del os.environ["USE_TF"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        d = str(tmp_path_factory.mktemp("tiny_bert_torch"))
        with open(os.path.join(d, "vocab.txt"), "w") as f:
            f.write("\n".join(_HF_VOCAB))
        tokenizer = BertTokenizerFast(vocab_file=os.path.join(d, "vocab.txt"))
        config = BertConfig(
            vocab_size=len(_HF_VOCAB),
            hidden_size=32,
            num_hidden_layers=2,
            num_attention_heads=2,
            intermediate_size=64,
            max_position_embeddings=64,
        )
        flax_model = FlaxBertModel(config, seed=7)
        tokenizer.save_pretrained(d)
        flax_model.save_pretrained(d)
        # BertModel.from_pretrained(d, from_flax=True) leaves the weights on the
        # meta device in this transformers; its converter fills a fresh model
        torch_model = load_flax_weights_in_pytorch_model(BertModel(config), flax_model.params)
        torch_model.save_pretrained(d)
    return d


@pytest.fixture
def no_network(monkeypatch):
    """Any attempt to resolve or reach a host fails in the test process."""

    def refuse(*args, **kwargs):
        raise OSError("network access is refused in this test")

    monkeypatch.setattr(socket, "getaddrinfo", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(socket.socket, "connect", refuse)


@requires_hf
@pytest.mark.parametrize("kwargs", [{"idf": True}, {"num_layers": 1}, {"all_layers": True}])
def test_transformers_default_matches_jax(tiny_bert_dir, no_network, kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_bert_score(_HF_PREDS, _HF_TARGETS, model_name_or_path=tiny_bert_dir, max_length=32, **kwargs)
        got = bert_score(_HF_PREDS, _HF_TARGETS, model_name_or_path=tiny_bert_dir, max_length=32, device="cpu", **kwargs)
        metric = mt.BERTScore(model_name_or_path=tiny_bert_dir, max_length=32, device="cpu", **kwargs)
        metric.update(_HF_PREDS[:2], _HF_TARGETS[:2])
        metric.update(_HF_PREDS[2:], _HF_TARGETS[2:])
        streamed = metric.compute()
    _assert_scores(got, want, atol=1e-5)
    _assert_scores(streamed, got, atol=1e-6)


@requires_hf
def test_transformers_default_without_the_model_raises_like_jax(tmp_path, no_network):
    missing = str(tmp_path / "no_such_model")
    with pytest.raises(ModuleNotFoundError) as want:
        jax_bert_score(["a"], ["a"], model_name_or_path=missing)
    with pytest.raises(ModuleNotFoundError) as got:
        bert_score(["a"], ["a"], model_name_or_path=missing, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ModuleNotFoundError, match="Could not load"):
        mt.BERTScore(model_name_or_path=missing, device="cpu")
