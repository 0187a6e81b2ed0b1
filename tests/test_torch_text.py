"""The port's text metrics against ``metrics_tpu`` on the same inputs.

Each of the twelve string metrics (the word error rate family, BLEU,
SacreBLEU, chrF, TER, EED, ROUGE and SQuAD) runs as a functional, as a
module's batch ``forward`` and as a module's ``compute`` over four batches,
in both packages, on ``tests/text/inputs.py``'s corpora and on seeded
numpy-made ones; values agree within 1e-6 absolute (the JAX text tests'
``atol``) and in the kind of their dtype. The JAX reference counts in
float64 (the tests turn on x64); the port counts in float32, exact up to
2^24 per counter.
"""
import pickle
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu.functional as fj
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as ft
from metrics_tpu_torch.obs.warn import reset_warn_once
from tests.text.inputs import _inputs_error_rate_batch_size_2, _inputs_multiple_references, _inputs_single_reference

ATOL = 1e-6
WORDS = (
    "the a cat dog sat ran on under mat hat quickly slowly big small red blue house tree "
    "river stone it's isn't 3.5 1,000 U.S. Dr. e.g. (note) well-known \"quoted\" end. yes! why?"
).split()
CJK = "我们 今天 去 学校 了 。 他 喜欢 读书 ， 她 在 家 写字 吗 ？ 東京 は 晴れ です".split()


def _sentence(rng, vocab, lo=3, hi=12) -> list:
    return [str(w) for w in rng.choice(vocab, rng.integers(lo, hi))]


def _perturb(rng, words, vocab) -> list:
    """Seeded substitutions, drops and insertions of a word list."""
    out = []
    for w in words:
        r = rng.random()
        if r < 0.15:
            out.append(str(rng.choice(vocab)))
        elif r < 0.25:
            continue
        else:
            out.append(w)
        if rng.random() < 0.1:
            out.append(str(rng.choice(vocab)))
    return out


def _seeded_corpus(seed: int, vocab=WORDS, refs: int = 2, n_batches: int = 4, batch: int = 3, sep: str = " "):
    """``n_batches`` batches of hypotheses and ``refs`` references each."""
    rng = np.random.default_rng(seed)
    preds, targets = [], []
    for _ in range(n_batches):
        p_batch, t_batch = [], []
        for _ in range(batch):
            ref = _sentence(rng, vocab)
            p_batch.append(sep.join(_perturb(rng, ref, vocab)))
            t_batch.append([sep.join(ref)] + [sep.join(_perturb(rng, ref, vocab)) for _ in range(refs - 1)])
        preds.append(p_batch)
        targets.append(t_batch)
    return preds, targets


def _single(targets):
    return [[refs[0] for refs in batch] for batch in targets]


SEEDED = _seeded_corpus(11)
SEEDED_CJK = _seeded_corpus(12, vocab=CJK, sep="")
CORPORA = {
    "error_rate": (_inputs_error_rate_batch_size_2.preds, _inputs_error_rate_batch_size_2.targets),
    "seeded_single": (SEEDED[0], _single(SEEDED[1])),
    "multi": (_inputs_multiple_references.preds, _inputs_multiple_references.targets),
    "single": (_inputs_single_reference.preds, _inputs_single_reference.targets),
    "seeded": SEEDED,
    "seeded_cjk": SEEDED_CJK,
}


def _squad_corpus(seed: int = 13, as_list: bool = True):
    """Four batches of SQuAD predictions and targets (1-3 ground truths, one
    question unanswered) in the list layout, or one dict per batch."""
    rng = np.random.default_rng(seed)
    batches = []
    qid = 0
    for _ in range(4):
        preds, targets = [], []
        for _ in range(3):
            truths = [" ".join(_sentence(rng, WORDS, 1, 5)) for _ in range(rng.integers(1, 4))]
            answer = " ".join(_perturb(rng, truths[0].split(), WORDS)) if rng.random() < 0.6 else truths[-1].upper()
            if qid != 5:  # question 5 goes unanswered
                preds.append({"prediction_text": answer, "id": str(qid)})
            targets.append({"answers": {"answer_start": [0] * len(truths), "text": truths}, "id": str(qid)})
            qid += 1
        batches.append((preds, targets) if as_list else (preds[0], targets[0]))
    return [b[0] for b in batches], [b[1] for b in batches]


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _assert_close(got, want, where: str = "", scale: float = 1.0) -> None:
    """Equal structure, shapes and dtype kinds, values within ``ATOL *
    scale`` (SQuAD's scores are percentages: ``scale=100``)."""
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _assert_close(got[k], want[k], f"{where}[{k}]", scale)
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{where}[{i}]", scale)
        return
    assert got.shape == want.shape, (where, got.shape, want.shape)
    assert got.dtype.kind == want.dtype.kind, (where, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * scale, err_msg=where)


# (class, functional, constructor kwargs, corpus)
CASES = [
    *((cls, fn, {}, corpus) for cls, fn in (
        ("WordErrorRate", "word_error_rate"),
        ("CharErrorRate", "char_error_rate"),
        ("MatchErrorRate", "match_error_rate"),
        ("WordInfoLost", "word_information_lost"),
        ("WordInfoPreserved", "word_information_preserved"),
    ) for corpus in ("error_rate", "seeded_single")),
    *(("BLEUScore", "bleu_score", {"n_gram": n, "smooth": s}, "multi") for n in (1, 2, 3, 4) for s in (False, True)),
    ("BLEUScore", "bleu_score", {}, "seeded"),
    ("BLEUScore", "bleu_score", {"n_gram": 2}, "single"),
    *(
        ("SacreBLEUScore", "sacre_bleu_score", {"tokenize": tok, "lowercase": low}, corpus)
        for tok in ("none", "13a", "zh", "intl", "char")
        for low, corpus in ((False, "seeded"), (True, "multi"))
    ),
    ("SacreBLEUScore", "sacre_bleu_score", {"tokenize": "zh", "smooth": True}, "seeded_cjk"),
    ("CHRFScore", "chrf_score", {}, "multi"),
    ("CHRFScore", "chrf_score", {"n_word_order": 0}, "seeded"),
    ("CHRFScore", "chrf_score", {"n_char_order": 4, "n_word_order": 1, "lowercase": True}, "seeded"),
    ("CHRFScore", "chrf_score", {"whitespace": True, "beta": 1.0}, "multi"),
    ("CHRFScore", "chrf_score", {"n_char_order": 2, "n_word_order": 3, "return_sentence_level_score": True}, "seeded"),
    ("CHRFScore", "chrf_score", {"return_sentence_level_score": True, "lowercase": True, "whitespace": True}, "single"),
    ("TranslationEditRate", "translation_edit_rate", {}, "multi"),
    ("TranslationEditRate", "translation_edit_rate", {"normalize": True}, "seeded"),
    ("TranslationEditRate", "translation_edit_rate", {"no_punctuation": True, "lowercase": False}, "seeded"),
    ("TranslationEditRate", "translation_edit_rate", {"normalize": True, "no_punctuation": True, "asian_support": True}, "seeded_cjk"),
    ("TranslationEditRate", "translation_edit_rate", {"return_sentence_level_score": True}, "seeded"),
    ("TranslationEditRate", "translation_edit_rate", {"return_sentence_level_score": True, "asian_support": True}, "single"),
    ("ExtendedEditDistance", "extended_edit_distance", {}, "multi"),
    ("ExtendedEditDistance", "extended_edit_distance", {"return_sentence_level_score": True}, "seeded"),
    ("ExtendedEditDistance", "extended_edit_distance", {"language": "ja", "return_sentence_level_score": True}, "seeded_cjk"),
    ("ExtendedEditDistance", "extended_edit_distance", {"alpha": 1.0, "rho": 0.5, "deletion": 0.4, "insertion": 0.5}, "single"),
    ("ROUGEScore", "rouge_score", {}, "single"),
    ("ROUGEScore", "rouge_score", {}, "seeded"),
    ("ROUGEScore", "rouge_score", {"accumulate": "avg", "rouge_keys": ("rouge1", "rouge3", "rougeL")}, "multi"),
    ("ROUGEScore", "rouge_score", {"rouge_keys": "rougeLsum"}, "seeded"),
    ("ROUGEScore", "rouge_score", {"use_stemmer": True, "rouge_keys": ("rouge2", "rougeLsum")}, "multi"),
    ("ROUGEScore", "rouge_score", {"use_stemmer": True, "accumulate": "avg"}, "seeded"),
    ("SQuAD", "squad", {}, "squad_list"),
    ("SQuAD", "squad", {}, "squad_dict"),
]


def _corpus(name: str):
    if name.startswith("squad"):
        return _squad_corpus(as_list=name == "squad_list")
    return CORPORA[name]


def _skip_missing(kwargs: dict) -> None:
    import importlib.util

    if kwargs.get("tokenize") == "intl" and importlib.util.find_spec("regex") is None:
        pytest.skip("the intl tokenizer needs `regex`")
    if kwargs.get("use_stemmer") and importlib.util.find_spec("nltk") is None:
        pytest.skip("the stemmer needs `nltk`")


def _scale(cls: str) -> float:
    return 100.0 if cls == "SQuAD" else 1.0


def _flatten(batches):
    return [x for b in batches for x in ([b] if isinstance(b, dict) else b)]


@pytest.mark.parametrize("cls,fn,kwargs,corpus", CASES, ids=[f"{c}-{i}-{k}" for i, (c, _, _, k) in enumerate(CASES)])
def test_text_metric_matches_jax(cls, fn, kwargs, corpus):
    """Functional per batch and over the corpus, the module's batch
    ``forward`` values, its ``compute`` over the four batches (twice: it is
    cached) and after a pickle round trip mid-stream."""
    _skip_missing(kwargs)
    reset_warn_once()
    preds, targets = _corpus(corpus)
    scale = _scale(cls)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # SQuAD's unanswered question
        for p, t in list(zip(preds, targets)) + [(_flatten(preds), _flatten(targets))]:
            _assert_close(getattr(ft, fn)(p, t, device="cpu", **kwargs), getattr(fj, fn)(p, t, **kwargs), f"{fn} functional", scale)
        port, ref = getattr(mt, cls)(device="cpu", **kwargs), getattr(mj, cls)(**kwargs)
        for i, (p, t) in enumerate(zip(preds, targets)):
            _assert_close(port(p, t), ref(p, t), f"{cls} forward {i}", scale)
            if i == 1:
                port = pickle.loads(pickle.dumps(port))
        _assert_close(port.compute(), ref.compute(), f"{cls} compute", scale)
        _assert_close(port.compute(), ref.compute(), f"{cls} compute again", scale)
        port.reset()
        assert port._update_count == 0


def test_text_metrics_default_to_cuda_and_raise_without_it():
    """The modules' states and the functionals' outputs live on the card
    unless a device is named; without CUDA they raise."""
    if torch.cuda.is_available():
        assert mt.BLEUScore().numerator.device.type == "cuda"
        assert ft.word_error_rate(["a b"], ["a c"]).device.type == "cuda"
        return
    names = ["WordErrorRate", "CharErrorRate", "MatchErrorRate", "WordInfoLost", "WordInfoPreserved", "BLEUScore",
             "SacreBLEUScore", "CHRFScore", "TranslationEditRate", "ExtendedEditDistance", "ROUGEScore", "SQuAD"]
    for name in names:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            getattr(mt, name)()
    calls = [
        lambda: ft.word_error_rate(["a b"], ["a c"]),
        lambda: ft.char_error_rate(["a b"], ["a c"]),
        lambda: ft.match_error_rate(["a b"], ["a c"]),
        lambda: ft.word_information_lost(["a b"], ["a c"]),
        lambda: ft.word_information_preserved(["a b"], ["a c"]),
        lambda: ft.bleu_score(["a b"], [["a c"]]),
        lambda: ft.sacre_bleu_score(["a b"], [["a c"]]),
        lambda: ft.chrf_score(["a b"], [["a c"]]),
        lambda: ft.translation_edit_rate(["a b"], [["a c"]]),
        lambda: ft.extended_edit_distance(["a b"], [["a c"]]),
        lambda: ft.rouge_score(["a b"], ["a c"]),
        lambda: ft.squad({"prediction_text": "a", "id": "1"}, {"answers": {"text": ["a"]}, "id": "1"}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize(
    "fn,args",
    [
        ("bleu_score", (["a b c"], [["a b c"], ["a b"]])),
        ("sacre_bleu_score", (["a b c"], [["a b c"], ["a b"]])),
        ("chrf_score", (["a b c"], [["a b c"], ["a b"]])),
        ("translation_edit_rate", (["a b c", "d"], [["a b c"]])),
        ("extended_edit_distance", (["a b c", "d"], [["a b c"]])),
    ],
)
def test_corpus_size_mismatch_raises_like_jax(fn, args):
    with pytest.raises(ValueError) as want:
        getattr(fj, fn)(*args)
    with pytest.raises(ValueError) as got:
        getattr(ft, fn)(*args, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "fn,preds,target,kwargs",
    [
        ("word_error_rate", ["", "a b"], ["a", "a b"], {}),
        ("char_error_rate", ["abc", ""], ["ab", "x"], {}),
        ("match_error_rate", [""], ["a b"], {}),
        ("word_information_preserved", ["a"], ["a b"], {}),
        ("bleu_score", [""], [["the cat"]], {}),
        ("bleu_score", ["the cat sat"], [[""]], {"smooth": True}),
        ("chrf_score", [""], [["the cat"]], {"return_sentence_level_score": True}),
        ("chrf_score", ["the cat"], [[""]], {}),
        ("translation_edit_rate", ["the cat"], [[""]], {"return_sentence_level_score": True}),
        ("translation_edit_rate", [""], [["the cat"]], {"return_sentence_level_score": True}),
        ("translation_edit_rate", [""], [[""]], {}),
        ("extended_edit_distance", [], [], {"return_sentence_level_score": True}),
        ("extended_edit_distance", [""], [["the cat"]], {}),
        ("rouge_score", [""], ["the cat"], {}),
        ("rouge_score", ["the cat"], [""], {"rouge_keys": ("rouge2", "rougeLsum")}),
    ],
)
def test_empty_hypotheses_and_references_match_jax(fn, preds, target, kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # 0/0 in both packages
        want = getattr(fj, fn)(preds, target, **kwargs)
        got = getattr(ft, fn)(preds, target, device="cpu", **kwargs)
    want = _np(want)
    got = _np(got)
    if isinstance(want, dict):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, equal_nan=True, err_msg=k)
    elif isinstance(want, tuple):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, equal_nan=True)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, equal_nan=True)


@pytest.mark.parametrize(
    "make,error",
    [
        (lambda pkg, **kw: pkg.CHRFScore(n_char_order=0, **kw), ValueError),
        (lambda pkg, **kw: pkg.CHRFScore(n_word_order=-1, **kw), ValueError),
        (lambda pkg, **kw: pkg.CHRFScore(beta=-1.0, **kw), ValueError),
        (lambda pkg, **kw: pkg.ExtendedEditDistance(language="de", **kw), ValueError),
        (lambda pkg, **kw: pkg.ExtendedEditDistance(alpha=2, **kw), ValueError),
        (lambda pkg, **kw: pkg.TranslationEditRate(normalize=1, **kw), ValueError),
        (lambda pkg, **kw: pkg.ROUGEScore(rouge_keys=("rouge42",), **kw), ValueError),
        (lambda pkg, **kw: pkg.ROUGEScore(accumulate="max", **kw), ValueError),
        (lambda pkg, **kw: pkg.SacreBLEUScore(tokenize="moses", **kw), ValueError),
    ],
)
def test_constructor_errors_match_jax(make, error):
    with pytest.raises(error) as want:
        make(mj)
    with pytest.raises(error) as got:
        make(mt, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "preds,target,match",
    [
        ([{"prediction_text": "a"}], [{"answers": {"text": ["a"]}, "id": "1"}], "prediction_text"),
        ([{"prediction_text": "a", "id": "1"}], [{"answers": {"text": ["a"]}}], "'answers' and 'id'"),
        ([{"prediction_text": "a", "id": "1"}], [{"answers": {"answer_start": [0]}, "id": "1"}], "'text'"),
    ],
)
def test_squad_input_errors_match_jax(preds, target, match):
    with pytest.raises(KeyError, match=match) as want:
        fj.squad(preds, target)
    with pytest.raises(KeyError, match=match) as got:
        ft.squad(preds, target, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(KeyError, match=match):
        mt.SQuAD(device="cpu").update(preds, target)


def test_squad_unanswered_question_warns_once_under_its_coarse_key():
    reset_warn_once("squad_unanswered_question")
    target = [{"answers": {"text": ["a"]}, "id": str(i)} for i in range(3)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = ft.squad([{"prediction_text": "a", "id": "0"}], target, device="cpu")
        mt.SQuAD(device="cpu").update([], target)
    hits = [w for w in caught if "Unanswered question" in str(w.message)]
    assert len(hits) == 1 and "Unanswered question 1 " in str(hits[0].message)
    assert float(out["exact_match"]) == pytest.approx(100 / 3)
    assert mt.SQuAD(device="cpu").total.dtype == torch.int64


def test_rouge_lsum_is_the_lcs_over_the_flattened_tokens():
    """The JAX package's rougeLsum joins the sentences with newlines and the
    tokenizer then drops them, so Lsum is the LCS of the flattened token
    lists: 3 of 6 here (the summary-level union LCS would give 6 of 6)."""
    pred = "The cat sat. The dog ran."
    target = "The dog ran. The cat sat."
    want = fj.rouge_score(pred, target, rouge_keys=("rougeL", "rougeLsum"))
    got = ft.rouge_score(pred, target, rouge_keys=("rougeL", "rougeLsum"), device="cpu")
    _assert_close(got, want)
    for key in ("rougeLsum_precision", "rougeLsum_recall", "rougeLsum_fmeasure", "rougeL_recall"):
        assert float(got[key]) == pytest.approx(0.5, abs=ATOL), key
    module = mt.ROUGEScore(rouge_keys="rougeLsum", device="cpu")
    module.update([pred], [target])
    assert float(module.compute()["rougeLsum_recall"]) == pytest.approx(0.5, abs=ATOL)


def _port_gather(ranks):
    """A ``dist_sync_fn`` answering each leaf, in the sorted state order the
    port gathers in, with every rank's leaf (rank 0 first)."""
    leaves = [list(m._sync_leaves(m._snapshot_state()).values()) for m in ranks]
    calls = {"i": 0}

    def gather(x, group=None):
        i = calls["i"]
        calls["i"] += 1
        return [r[i % len(r)] for r in leaves]

    return gather


@pytest.mark.parametrize(
    "cls,kwargs,corpus",
    [
        ("CHRFScore", {"return_sentence_level_score": True}, "seeded"),
        ("TranslationEditRate", {"return_sentence_level_score": True}, "seeded"),
        ("ExtendedEditDistance", {"return_sentence_level_score": True}, "seeded"),
        ("ROUGEScore", {}, "single"),
        ("BLEUScore", {}, "multi"),
        ("SQuAD", {}, "squad_list"),
    ],
)
def test_two_rank_sync_of_the_list_states_equals_serial(cls, kwargs, corpus):
    """Rank 0 takes batches 0 and 2, rank 1 batches 1 and 3 (equal sizes:
    ROUGE's per-sentence states stack on sync); the synced value equals one
    instance over the batches in rank-major order, in the port and in JAX."""
    preds, targets = _corpus(corpus)
    ranks = [mt.__dict__[cls](device="cpu", **kwargs) for _ in range(2)]
    order = [0, 2, 1, 3]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for r, metric in enumerate(ranks):
            for i in order[2 * r : 2 * r + 2]:
                metric.update(preds[i], targets[i])
        serial, ref = mt.__dict__[cls](device="cpu", **kwargs), mj.__dict__[cls](**kwargs)
        for i in order:
            serial.update(preds[i], targets[i])
            ref.update(preds[i], targets[i])
    m0 = ranks[0]
    m0.dist_sync_fn = _port_gather(ranks)
    m0._distributed_available_fn = lambda: True
    got = m0.compute()
    _assert_close(got, serial.compute(), "synced vs serial port", _scale(cls))
    _assert_close(got, ref.compute(), "synced vs serial jax", _scale(cls))
    assert not m0._is_synced


# (class, kwargs, corpus): text states carry across mid-stream, both ways
CARRY = [
    ("WordErrorRate", {}, "error_rate"),
    ("WordInfoPreserved", {}, "seeded_single"),
    ("BLEUScore", {}, "multi"),
    ("SacreBLEUScore", {"tokenize": "char"}, "seeded"),
    ("CHRFScore", {"return_sentence_level_score": True}, "seeded"),
    ("TranslationEditRate", {"return_sentence_level_score": True}, "multi"),
    ("ExtendedEditDistance", {}, "seeded"),
    ("ROUGEScore", {}, "seeded"),
    ("SQuAD", {}, "squad_list"),
]


@pytest.mark.parametrize("cls,kwargs,corpus", CARRY, ids=[c for c, _, _ in CARRY])
def test_text_state_dicts_cross_both_ways(cls, kwargs, corpus):
    """JAX takes batches 0-1, the port takes its state and batch 2, JAX takes
    the port's state back and batch 3: equal to JAX over all four."""
    preds, targets = _corpus(corpus)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        whole = mj.__dict__[cls](**kwargs)
        for p, t in zip(preds, targets):
            whole.update(p, t)
        first = mj.__dict__[cls](**kwargs)
        for p, t in zip(preds[:2], targets[:2]):
            first.update(p, t)
        first.persistent(True)
        port = mt.__dict__[cls](device="cpu", **kwargs)
        port.persistent(True)
        loaded = port.load_state_dict(mt.state_from_jax(first.state_dict()))
        assert not loaded.missing_keys and not loaded.unexpected_keys
        port.update(preds[2], targets[2])
        back = mj.__dict__[cls](**kwargs)
        back.persistent(True)
        back.load_state_dict(mt.state_to_jax(port.state_dict()))
        back.update(preds[3], targets[3])
        back._update_count = whole._update_count
    _assert_close(back.compute(), whole.compute(), cls, _scale(cls))


def _eed_exact(hyp: str, ref: str) -> float:
    """EED's CDER DP one cell at a time in exact rational arithmetic:
    deletions propagate left to right, each row visits its first minimum."""
    from fractions import Fraction

    alpha, rho, deletion, insertion = Fraction(2), Fraction(3, 10), Fraction(1, 5), Fraction(1)
    n = len(hyp)
    visits = [-1] * (n + 1)
    row = [Fraction(0)] + [Fraction(1)] * n
    for c in ref:
        nxt = [row[0] + 1] + [min(row[i - 1] + (hyp[i - 1] != c), row[i] + insertion) for i in range(1, n + 1)]
        for i in range(1, n + 1):
            nxt[i] = min(nxt[i], nxt[i - 1] + deletion)
        best = min(nxt)
        visits[nxt.index(best)] += 1
        if c == " ":
            nxt = [min(x, alpha + best) for x in nxt]
        row = nxt
    coverage = rho * sum(v if v >= 0 else 1 for v in visits)
    return float(min(Fraction(1), (row[-1] + coverage) / (len(ref) + coverage)))


def test_eed_rows_visit_the_first_minimum_of_exact_arithmetic():
    """Costs are sums of 1, 0.2 and 2, so two paths of one cost can differ by
    an ulp in floats. The vectorized row (and its ``(x - i*del) + i*del``
    round trip) takes the first cell within 1e-9 of the minimum, as the JAX
    package does: the cell exact arithmetic visits, so the coverage penalty
    counts the same cells. Repetitive text makes many ties."""
    from metrics_tpu_torch.functional.text.eed import _eed_function, _preprocess_en

    rng = np.random.default_rng(5)
    chunks = ["ab", "ba", "a", "b", "abab", "the", "cat"]
    pairs = [tuple(" ".join(rng.choice(chunks, rng.integers(2, 9))) for _ in range(2)) for _ in range(80)]
    pairs += [(p, t) for p, t in zip(_flatten(SEEDED[0]), _flatten(_single(SEEDED[1])))]
    for hyp, ref in pairs:
        hyp, ref = _preprocess_en(hyp), _preprocess_en(ref)
        assert _eed_function(hyp, ref) == pytest.approx(_eed_exact(hyp, ref), abs=1e-12), (hyp, ref)


@pytest.mark.parametrize(
    "cls,states",
    [
        ("WordErrorRate", ("errors", "total")),
        ("WordInfoLost", ("hits", "target_total", "preds_total")),
        ("BLEUScore", ("preds_len", "target_len", "numerator", "denominator")),
        ("CHRFScore", ("total_preds_char_n_grams", "total_matching_word_n_grams")),
        ("TranslationEditRate", ("total_num_edits", "total_tgt_len")),
        ("SQuAD", ("f1_score", "exact_match")),
    ],
)
def test_counters_are_float32_and_the_squad_count_int64(cls, states):
    """float32 counters, exact up to 2^24 each, as the JAX package's without
    x64 (its tests count in float64); SQuAD's question count is int64."""
    metric = getattr(mt, cls)(device="cpu")
    for name in states:
        assert getattr(metric, name).dtype == torch.float32, name
    if cls == "SQuAD":
        assert metric.total.dtype == torch.int64
