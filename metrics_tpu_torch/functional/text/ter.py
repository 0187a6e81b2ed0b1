"""Translation edit rate (counterpart of ``metrics_tpu/functional/text/ter.py``).

TER (Snover et al. 2006): the fewest edits (insertions, deletions,
substitutions and phrase shifts) that turn a hypothesis into a reference,
over the average reference length. The greedy shift search ranks shifts by
(edit gain, span length, earliest hypothesis position, earliest target
position) and repeats until no shift lowers the word-level Levenshtein
distance, on an exact trace-producing DP. All of it runs on the host; the
two counters are float32 tensors on the metric's device.
"""
import re
from functools import lru_cache
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.metric import resolve_device

# tercom search limits (algorithm constants from Snover et al. / tercom):
# spans longer than _SPAN_LIMIT-1 words are never shifted, spans may not move
# further than _OFFSET_LIMIT positions, and the greedy search gives up after
# _CANDIDATE_BUDGET evaluated relocations.
_SPAN_LIMIT = 10
_OFFSET_LIMIT = 50
_CANDIDATE_BUDGET = 1000

# edit operations in the alignment trace
_OP_MATCH, _OP_SUB, _OP_INS, _OP_DEL = "A", "S", "I", "D"


class _TercomTokenizer:
    """Tercom normalization: lowercase, optional western and asian
    tokenization, optional punctuation removal (the public tercom
    Normalizer.java rules, as sacrebleu's tokenizer_ter has them)."""

    _ASIAN_PUNCTUATION = r"([、。〈-】〔-〟｡-･・])"
    _FULL_WIDTH_PUNCTUATION = r"([．，？：；！＂（）])"

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support

    @lru_cache(maxsize=2**16)
    def __call__(self, sentence: str) -> str:
        if not sentence:
            return ""
        if self.lowercase:
            sentence = sentence.lower()
        if self.normalize:
            sentence = self._normalize_general_and_western(sentence)
            if self.asian_support:
                sentence = self._normalize_asian(sentence)
        if self.no_punctuation:
            sentence = self._remove_punct(sentence)
            if self.asian_support:
                sentence = self._remove_asian_punct(sentence)
        return " ".join(sentence.split())

    @staticmethod
    def _normalize_general_and_western(sentence: str) -> str:
        sentence = f" {sentence} "
        rules = [
            (r"\n-", ""),
            (r"\n", " "),
            (r"&quot;", '"'),
            (r"&amp;", "&"),
            (r"&lt;", "<"),
            (r"&gt;", ">"),
            (r"([{-~[-` -&(-+:-@/])", r" \1 "),
            (r"'s ", r" 's "),
            (r"'s$", r" 's"),
            (r"([^0-9])([\.,])", r"\1 \2 "),
            (r"([\.,])([^0-9])", r" \1 \2"),
            (r"([0-9])(-)", r"\1 \2 "),
        ]
        for pattern, replacement in rules:
            sentence = re.sub(pattern, replacement, sentence)
        return sentence

    @classmethod
    def _normalize_asian(cls, sentence: str) -> str:
        sentence = re.sub(r"([一-鿿㐀-䶿])", r" \1 ", sentence)
        sentence = re.sub(r"([㇀-㇯⺀-⻿])", r" \1 ", sentence)
        sentence = re.sub(r"([㌀-㏿豈-﫿︰-﹏])", r" \1 ", sentence)
        sentence = re.sub(r"([㈀-㼢])", r" \1 ", sentence)
        sentence = re.sub(r"(^|^[぀-ゟ])([぀-ゟ]+)(?=$|^[぀-ゟ])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[゠-ヿ])([゠-ヿ]+)(?=$|^[゠-ヿ])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[ㇰ-ㇿ])([ㇰ-ㇿ]+)(?=$|^[ㇰ-ㇿ])", r"\1 \2 ", sentence)
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r" \1 ", sentence)
        sentence = re.sub(cls._FULL_WIDTH_PUNCTUATION, r" \1 ", sentence)
        return sentence

    @staticmethod
    def _remove_punct(sentence: str) -> str:
        return re.sub(r"[\.,\?:;!\"\(\)]", "", sentence)

    @classmethod
    def _remove_asian_punct(cls, sentence: str) -> str:
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r"", sentence)
        return re.sub(cls._FULL_WIDTH_PUNCTUATION, r"", sentence)


def _edit_distance_with_trace(hyp: Tuple[str, ...], ref: Tuple[str, ...]) -> Tuple[int, str]:
    """Word-level Levenshtein distance plus an alignment trace.

    Trace ops (hypothesis vs reference): ``A`` match, ``S`` substitute,
    ``I`` hypothesis-only word (insertion), ``D`` reference-only word
    (deletion). Backtrace prefers diagonal moves, then insertions.
    """
    m, n = len(hyp), len(ref)
    dist = np.zeros((m + 1, n + 1), dtype=np.int64)
    dist[:, 0] = np.arange(m + 1)
    dist[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        sub = dist[i - 1, :-1] + np.array([hyp[i - 1] != r for r in ref], dtype=np.int64)
        ins = dist[i - 1, 1:] + 1
        row = np.minimum(sub, ins)
        row = np.concatenate(([i], row))
        row = np.minimum.accumulate(row - np.arange(n + 1)) + np.arange(n + 1)
        dist[i] = row
    ops: List[str] = []
    i, j = m, n
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dist[i, j] == dist[i - 1, j - 1] + (hyp[i - 1] != ref[j - 1]):
            ops.append(_OP_MATCH if hyp[i - 1] == ref[j - 1] else _OP_SUB)
            i, j = i - 1, j - 1
        elif i > 0 and dist[i, j] == dist[i - 1, j] + 1:
            ops.append(_OP_INS)
            i -= 1
        else:
            ops.append(_OP_DEL)
            j -= 1
    return int(dist[m, n]), "".join(reversed(ops))


class _Alignment:
    """Array view of an alignment trace.

    ``ref_to_hyp[p]`` is the hypothesis index aligned with reference position
    ``p`` (index 0 stands for ref position -1, mapped to hyp -1, so lookups are
    shifted by one). ``hyp_err_cum``/``ref_err_cum`` are prefix sums of the
    per-position error indicators, so any span's error count is a difference
    of two entries.
    """

    __slots__ = ("ref_to_hyp", "hyp_err_cum", "ref_err_cum")

    def __init__(self, trace: str) -> None:
        ops = np.frombuffer(trace.encode(), dtype=np.uint8)
        in_hyp = (ops != ord(_OP_DEL))  # ops that consume a hypothesis word
        in_ref = (ops != ord(_OP_INS))  # ops that consume a reference word
        err = (ops != ord(_OP_MATCH))
        # hypothesis cursor value after each op, then select the ops that
        # consume a reference word to get the ref->hyp position map
        hyp_cursor = np.cumsum(in_hyp) - 1
        self.ref_to_hyp = np.concatenate(([-1], hyp_cursor[in_ref]))
        self.hyp_err_cum = np.concatenate(([0], np.cumsum(err[in_hyp])))
        self.ref_err_cum = np.concatenate(([0], np.cumsum(err[in_ref])))


def _span_table(hyp_ids: np.ndarray, ref_ids: np.ndarray) -> np.ndarray:
    """Enumerate every common word span as an ``[K, 3]`` array of
    ``(hyp_start, ref_start, length)`` rows, ordered like tercom's scan
    (hypothesis position, then reference position, then growing length).

    Built from a run-length matrix: ``runs[i, j]`` = length of the longest
    common prefix of ``hyp[i:]`` and ``ref[j:]``, computed with one vector op
    per hypothesis position.
    """
    m, n = len(hyp_ids), len(ref_ids)
    if m == 0 or n == 0:
        return np.empty((0, 3), dtype=np.int64)
    eq = hyp_ids[:, None] == ref_ids[None, :]
    runs = np.zeros((m + 1, n + 1), dtype=np.int64)
    for i in range(m - 1, -1, -1):
        runs[i, :n] = eq[i] * (1 + runs[i + 1, 1:])
    # distance gate + span-length cap
    offside = np.abs(np.arange(m)[:, None] - np.arange(n)[None, :]) > _OFFSET_LIMIT
    capped = np.where(offside, 0, np.minimum(runs[:m, :n], _SPAN_LIMIT - 1))
    starts = np.argwhere(capped > 0)
    if starts.size == 0:
        return np.empty((0, 3), dtype=np.int64)
    # expand each (i, j) into rows for lengths 1..capped[i, j]
    counts = capped[starts[:, 0], starts[:, 1]]
    rows = np.repeat(starts, counts, axis=0)
    lengths = np.concatenate([np.arange(1, c + 1) for c in counts])
    return np.column_stack([rows, lengths])


def _relocate(ids: np.ndarray, start: int, length: int, dest: int) -> np.ndarray:
    """Return ``ids`` with the block ``[start, start+length)`` moved so that it
    begins at original-coordinate position ``dest``."""
    span = ids[start : start + length]
    rest = np.delete(ids, np.s_[start : start + length])
    at = dest - length if dest > start + length else dest
    return np.concatenate([rest[:at], span, rest[at:]])


class _TraceDistance:
    """Levenshtein-with-trace against a fixed reference, memoized on the
    hypothesis token ids (every search round re-queries shifted variants)."""

    def __init__(self, ref_words: List[str]) -> None:
        self._ref = tuple(ref_words)
        self._memo: Dict[Tuple[str, ...], Tuple[int, str]] = {}

    def __call__(self, hyp_words: Sequence[str]) -> Tuple[int, str]:
        key = tuple(hyp_words)
        if key not in self._memo:
            self._memo[key] = _edit_distance_with_trace(key, self._ref)
        return self._memo[key]


def _candidate_shifts(
    spans: np.ndarray, align: "_Alignment", budget: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Filter the span table down to legal tercom shifts and expand each span
    into its candidate landing positions.

    Returns parallel arrays ``(hyp_start, length, dest, span_row)`` truncated
    to ``budget`` entries. A span is shiftable only if it is misaligned on both
    sides (at least one error inside the span in the hypothesis AND at the
    reference landing zone) and does not already overlap its own destination.
    Landing positions come from the alignment of the reference words just
    before/inside the span's reference window, deduplicated when consecutive
    offsets alias to the same hypothesis slot.
    """
    hs, rs, ln = spans[:, 0], spans[:, 1], spans[:, 2]
    n_ref = len(align.ref_to_hyp) - 1

    hyp_wrong = (align.hyp_err_cum[hs + ln] - align.hyp_err_cum[hs]) > 0
    ref_wrong = (align.ref_err_cum[rs + ln] - align.ref_err_cum[rs]) > 0
    anchor = align.ref_to_hyp[rs + 1]  # hyp position aligned to the span's ref start
    outside = ~((hs <= anchor) & (anchor < hs + ln))
    keep = hyp_wrong & ref_wrong & outside
    if not keep.any():
        empty = np.empty(0, dtype=np.int64)
        return empty, empty, empty, empty

    spans = spans[keep]
    out_h, out_l, out_d, out_row = [], [], [], []
    for row, (h, r, l) in enumerate(spans):
        # reference offsets r-1 .. r+l-1 (stop at the reference end), shifted
        # +1 into ref_to_hyp's padded indexing; +1 again: land *after* the
        # aligned word
        upper = min(r + l, n_ref)
        dests = align.ref_to_hyp[r : upper + 1] + 1
        dests = dests[np.concatenate(([True], dests[1:] != dests[:-1]))]
        out_h.append(np.full(len(dests), h))
        out_l.append(np.full(len(dests), l))
        out_d.append(dests)
        out_row.append(np.full(len(dests), row))
    hyp_start = np.concatenate(out_h)
    length = np.concatenate(out_l)
    dest = np.concatenate(out_d)
    span_row = np.concatenate(out_row)
    if len(dest) > budget:
        # spend at most the remaining candidate budget, in scan order
        hyp_start, length, dest, span_row = (
            hyp_start[:budget], length[:budget], dest[:budget], span_row[:budget]
        )
    return hyp_start, length, dest, span_row


def _best_shift(
    hyp_words: List[str],
    ref_words: List[str],
    distance: _TraceDistance,
    vocab: Dict[str, int],
    budget: int,
) -> Tuple[int, List[str], int]:
    """Evaluate every legal shift of the current hypothesis in one batch and
    return (edit-distance gain, shifted hypothesis, candidates spent).

    Ranking follows tercom: largest gain, then longest span, then earliest
    span in the hypothesis, then earliest landing position.
    """
    base_distance, trace = distance(hyp_words)
    align = _Alignment(trace)
    hyp_ids = np.array([vocab[w] for w in hyp_words], dtype=np.int64)
    ref_ids = np.array([vocab.setdefault(w, len(vocab)) for w in ref_words], dtype=np.int64)

    spans = _span_table(hyp_ids, ref_ids)
    hs, ln, dest, _ = _candidate_shifts(spans, align, budget)
    used = len(dest)
    if used == 0:
        return 0, hyp_words, 0

    id_to_word = [""] * len(vocab)
    for word, wid in vocab.items():
        id_to_word[wid] = word
    variants = [
        [id_to_word[i] for i in _relocate(hyp_ids, int(h), int(l), int(d))]
        for h, l, d in zip(hs, ln, dest)
    ]
    gains = np.array([base_distance - distance(v)[0] for v in variants], dtype=np.int64)
    best = np.lexsort((dest, hs, -ln, -gains))[0]
    return int(gains[best]), variants[best], used


def _translation_edit_rate(hyp_words: List[str], ref_words: List[str]) -> int:
    """Edits (shifts + word edits) to turn hypothesis into one reference."""
    if len(ref_words) == 0:
        return 0
    distance = _TraceDistance(ref_words)
    vocab: Dict[str, int] = {}
    for w in hyp_words:
        vocab.setdefault(w, len(vocab))
    shifts = 0
    spent = 0
    words = list(hyp_words)
    while True:
        gain, words_next, used = _best_shift(words, ref_words, distance, vocab, _CANDIDATE_BUDGET - spent)
        spent += used
        # a shift found on the round that drains the budget is not applied —
        # tercom gives up as soon as the candidate allowance runs out
        if spent >= _CANDIDATE_BUDGET or gain <= 0:
            break
        shifts += 1
        words = words_next
    return shifts + distance(words)[0]


def _compute_sentence_statistics(hyp_words: List[str], ref_sentences: List[List[str]]) -> Tuple[float, float]:
    """Best (lowest) edit count over references, and average reference length."""
    total_ref_len = 0.0
    best_num_edits = float("inf")
    for ref_words in ref_sentences:
        total_ref_len += len(ref_words)
        num_edits = _translation_edit_rate(hyp_words, ref_words)
        if num_edits < best_num_edits:
            best_num_edits = num_edits
    return best_num_edits, total_ref_len / len(ref_sentences)


def _compute_ter_score_from_statistics(num_edits: torch.Tensor, tgt_length: torch.Tensor) -> torch.Tensor:
    """Edits over reference length; with an empty reference, 1 if there are
    edits and 0 if not."""
    ratio = num_edits / torch.clamp(tgt_length, min=1e-16)
    empty = (num_edits > 0).to(ratio.dtype)
    return torch.where(tgt_length > 0, ratio, empty).to(torch.float32)


def _ter_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    tokenizer: _TercomTokenizer,
) -> Tuple[float, float, List[float]]:
    """A batch's ``(total_num_edits, total_tgt_length, sentence_scores)``, on the host."""
    if isinstance(preds, str):
        preds = [preds]
    target = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")

    total_num_edits = 0.0
    total_tgt_length = 0.0
    sentence_scores: List[float] = []
    for pred, refs in zip(preds, target):
        hyp_words = tokenizer(pred).split()
        ref_sentences = [tokenizer(ref).split() for ref in refs]
        num_edits, avg_len = _compute_sentence_statistics(hyp_words, ref_sentences)
        total_num_edits += num_edits
        total_tgt_length += avg_len
        if avg_len > 0 and num_edits > 0:
            sentence_scores.append(num_edits / avg_len)
        elif avg_len == 0 and num_edits > 0:
            sentence_scores.append(1.0)
        else:
            sentence_scores.append(0.0)
    return total_num_edits, total_tgt_length, sentence_scores


def _ter_compute(total_num_edits: torch.Tensor, total_tgt_length: torch.Tensor) -> torch.Tensor:
    return _compute_ter_score_from_statistics(total_num_edits, total_tgt_length)


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    device: Optional[Any] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Translation edit rate: word edits plus phrase shifts over reference
    length, float32 on ``device`` (the GPU unless given).

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(translation_edit_rate(preds, target, device="cpu")), 4)
        0.1538
    """
    dev = resolve_device(device)
    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    total_num_edits, total_tgt_length, sentence_scores = _ter_update(preds, target, tokenizer)
    stats = torch.tensor([total_num_edits, total_tgt_length], dtype=torch.float32).to(dev)
    corpus = _ter_compute(stats[0], stats[1])
    if return_sentence_level_score:
        return corpus, torch.tensor(sentence_scores, dtype=torch.float32, device=dev)
    return corpus
