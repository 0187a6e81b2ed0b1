"""BERTScore (counterpart of ``metrics_tpu/functional/text/bert.py``).

* The contextual encoder is a user callable ``model(input_ids [N, L],
  attention_mask [N, L]) -> embeddings [N, L, d]`` that takes int64 tensors
  on the metric's device (a :class:`~metrics_tpu_torch.ShardedEncoder`
  makes it one captured program per input signature). The default loads a
  ``transformers`` tokenizer and torch ``AutoModel`` from a local directory
  or cache, gated on ``transformers``; the port never downloads.
* Tokenization, the idf statistics, the special-token mask, the baseline
  CSV and the rescale run on the host, as in the JAX package.
* The idf-weighted greedy cosine matching runs on the device: one batched
  matmul in full float32 (TF32 off, whatever the caller set), masked
  maxima and weighted sums, chunk by chunk.
"""
import importlib.util
import math
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.encoders.runtime import count_bucketed_dispatch
from metrics_tpu_torch.engine.bucketing import next_pow2
from metrics_tpu_torch.image.networks._common import full_fp32
from metrics_tpu_torch.metric import resolve_device


def _simple_tokenizer_call(tokenizer: Any, text: List[str], max_length: int) -> Dict[str, np.ndarray]:
    """Call an HF-style tokenizer (keyword API) or the own-tokenizer contract
    ``tokenizer(text, max_length)``; numpy ids and mask either way."""
    if hasattr(tokenizer, "batch_encode_plus") or getattr(tokenizer, "is_fast", None) is not None:
        out = tokenizer(text, padding="max_length", max_length=max_length, truncation=True, return_tensors="np")
    else:
        out = tokenizer(text, max_length)
    return {"input_ids": np.asarray(out["input_ids"]), "attention_mask": np.asarray(out["attention_mask"])}


def _get_tokens_idf(input_ids: np.ndarray, attention_mask: np.ndarray) -> Dict[int, float]:
    """idf(t) = log((N + 1) / (df(t) + 1)) over the reference corpus; key -1
    holds the default of a token the references do not have."""
    num_sentences = len(input_ids)
    counter: Counter = Counter()
    for ids, mask in zip(input_ids, attention_mask):
        counter.update(set(ids[mask.astype(bool)].tolist()))
    default = math.log((num_sentences + 1) / 1)
    idf = {int(idx): math.log((num_sentences + 1) / (occ + 1)) for idx, occ in counter.items()}
    return {**idf, -1: default}


def _idf_scale(input_ids: np.ndarray, tokens_idf: Optional[Dict[int, float]]) -> np.ndarray:
    """Each token's idf weight (1 without idf), float64, looked up once per
    distinct token."""
    if tokens_idf is None:
        return np.ones_like(input_ids, dtype=np.float64)
    default = tokens_idf.get(-1, 0.0)
    uniq, inverse = np.unique(input_ids, return_inverse=True)
    weights = np.array([tokens_idf.get(int(t), default) for t in uniq], dtype=np.float64)
    return weights[inverse].reshape(input_ids.shape)


def _process_attention_mask_for_special_tokens(attention_mask: np.ndarray) -> np.ndarray:
    """Zero [CLS] (the first position) and [SEP] (the last attended one)."""
    attention_mask = attention_mask.copy()
    if attention_mask.shape[1] == 0:
        return attention_mask
    attention_mask[:, 0] = 0
    sep_pos = np.argmax(np.cumsum(attention_mask - 0.1, axis=-1), axis=-1)
    attention_mask[np.arange(attention_mask.shape[0]), sep_pos] = 0
    return attention_mask


def _get_precision_recall_f1(
    preds_emb: torch.Tensor,
    target_emb: torch.Tensor,
    preds_mask: torch.Tensor,
    target_mask: torch.Tensor,
    preds_idf: torch.Tensor,
    target_idf: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Greedy cosine matching with idf weights, batched on the device.

    Embeddings are ``[..., B, L, d]`` (a leading layer axis broadcasts);
    masks and idf weights ``[B, L]`` in the embeddings' dtype. Invalid pairs
    are ``-inf`` to the maxima; a sentence with nothing to match on the
    other side scores 0, and a NaN F1 is 0."""

    def _norm(emb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        emb = emb * mask[..., None]
        denom = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        return emb / torch.where(denom > 0, denom, torch.ones_like(denom))

    p = _norm(preds_emb, preds_mask)
    t = _norm(target_emb, target_mask)
    # full float32: TF32 costs about 5e-4 of cosine, visible at BERTScore's scale
    with full_fp32():
        cos_sim = torch.matmul(p, t.transpose(-1, -2))
    pair_mask = (preds_mask[:, :, None] * target_mask[:, None, :]) > 0
    cos_sim = torch.where(pair_mask, cos_sim, torch.full_like(cos_sim, -math.inf))

    p_weights = preds_idf * preds_mask
    t_weights = target_idf * target_mask
    has_target = (target_mask > 0).any(dim=1)[:, None]
    has_pred = (preds_mask > 0).any(dim=1)[:, None]
    zero = torch.zeros((), dtype=cos_sim.dtype, device=cos_sim.device)
    best_for_pred = torch.where((preds_mask > 0) & has_target, cos_sim.amax(dim=-1), zero)
    best_for_target = torch.where((target_mask > 0) & has_pred, cos_sim.amax(dim=-2), zero)
    precision = (best_for_pred * p_weights).sum(-1) / p_weights.sum(-1).clamp_min(1e-12)
    recall = (best_for_target * t_weights).sum(-1) / t_weights.sum(-1).clamp_min(1e-12)
    f1 = 2 * precision * recall / (precision + recall)
    f1 = torch.where(torch.isnan(f1), zero, f1)
    return {"precision": precision, "recall": recall, "f1": f1}


def _read_baseline_csv(baseline_path: str) -> np.ndarray:
    """A rescale-baseline CSV from a local path: a header row, then rows of
    ``layer, precision, recall, f1``; the per-layer ``[P, R, F1]`` rows."""
    import csv

    with open(baseline_path) as fname:
        rows = [[float(item) for item in row] for idx, row in enumerate(csv.reader(fname)) if idx > 0]
    baseline = np.asarray(rows, dtype=np.float64)
    if baseline.ndim != 2 or baseline.shape[1] != 4:
        raise ValueError(
            f"Baseline CSV at {baseline_path!r} must have a header row and rows of"
            " exactly `layer_idx, precision, recall, f1` values"
            f" (got {baseline.shape[1] if baseline.ndim == 2 else 'ragged'} columns)."
        )
    return baseline[:, 1:4]


def _true_width(mask: np.ndarray) -> int:
    """Last attended column + 1 of a chunk's attention mask."""
    cols = np.flatnonzero(np.asarray(mask).any(axis=0))
    return int(cols[-1]) + 1 if cols.size else 1


def _bucket_width(mask: np.ndarray, max_length: int) -> int:
    """A chunk's pow2 length bucket: the smallest power of two covering every
    attended token, at most the padded width. The columns cut are all
    masked, so an encoder whose valid positions do not depend on trailing
    padding gives the same embeddings there, and encoder programs stay at
    O(log max_length) signatures."""
    return min(int(max_length), next_pow2(_true_width(mask)))


def _pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    """Zero-pad the sentence axis up to ``rows`` (the pad rows' masks are all
    zero, so their scores are zeros, sliced off)."""
    arr = np.asarray(arr)
    if arr.shape[0] >= rows:
        return arr
    return np.pad(arr, [(0, rows - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1))


def _rescale_metrics_with_baseline(
    out: Dict[str, np.ndarray], baseline: np.ndarray, num_layers: Optional[int], all_layers: bool = False
) -> Dict[str, np.ndarray]:
    """``(score - baseline) / (1 - baseline)`` per metric with the scored
    layer's baseline row (the last with ``num_layers=None``); with
    ``all_layers`` each layer of the ``[num_layers, n]`` scores takes its own."""
    if all_layers:
        n_layers = np.asarray(out["f1"]).shape[0]
        if baseline.shape[0] != n_layers:
            raise ValueError(
                f"`all_layers` rescale needs exactly one baseline row per layer: scores"
                f" have {n_layers} layers but the baseline CSV has {baseline.shape[0]} rows."
            )
        return {
            key: (np.asarray(out[key]) - baseline[:, i : i + 1]) / (1.0 - baseline[:, i : i + 1])
            for i, key in enumerate(("precision", "recall", "f1"))
        }
    row = baseline[-1 if num_layers is None else num_layers]
    return {key: (np.asarray(out[key]) - row[i]) / (1.0 - row[i]) for i, key in enumerate(("precision", "recall", "f1"))}


def _default_hf_model(
    model_name_or_path: Optional[str],
    max_length: int,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
    device: Optional[Any] = None,
) -> Tuple[Callable, Any]:
    """The ``transformers`` default: ``AutoTokenizer`` and the torch
    ``AutoModel`` of ``model_name_or_path`` (``roberta-large`` when None),
    from local files only, in eval mode on ``device``. The forward returns
    the hidden state of layer ``num_layers`` (the last when None), or every
    hidden state stacked to ``[layers, n, L, d]`` with ``all_layers``."""
    if importlib.util.find_spec("transformers") is None:
        raise ModuleNotFoundError(
            "`bert_score` metric with default models requires `transformers` package be installed."
            " Either install with `pip install transformers>=4.0` or `pip install metrics_tpu[text]`."
        )
    from transformers import AutoModel, AutoTokenizer

    name = model_name_or_path or "roberta-large"
    try:
        tokenizer = AutoTokenizer.from_pretrained(name, local_files_only=True)
        model = AutoModel.from_pretrained(name, local_files_only=True)
    except Exception as err:  # noqa: BLE001 - every load failure becomes the one documented error
        raise ModuleNotFoundError(
            f"Could not load pretrained model/tokenizer {name!r} (no local cache and no network"
            " egress on TPU pods?). Pass `user_model` + `user_tokenizer` callables instead —"
            " see the own-model contract in the docstring."
        ) from err
    model = model.eval().to(resolve_device(device))

    def forward(input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            out = model(input_ids=input_ids, attention_mask=attention_mask, output_hidden_states=True)
        if all_layers:
            return torch.stack(out.hidden_states, dim=0)
        return out.hidden_states[num_layers if num_layers is not None else -1]

    return forward, tokenizer


def bert_score(
    preds: Union[str, List[str]],
    target: Union[str, List[str]],
    model_name_or_path: Optional[str] = None,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
    model: Optional[Callable] = None,
    user_tokenizer: Optional[Any] = None,
    user_forward_fn: Optional[Callable] = None,
    verbose: bool = False,
    idf: bool = False,
    lang: str = "en",
    rescale_with_baseline: bool = False,
    baseline_path: Optional[str] = None,
    baseline_url: Optional[str] = None,
    max_length: int = 512,
    batch_size: int = 64,
    num_threads: int = 4,
    return_hash: bool = False,
    device: Optional[Any] = None,
    length_bucketing: bool = True,
) -> Dict[str, Union[List[float], str]]:
    """BERTScore precision, recall and F1 between candidate and reference sentences.

    Args:
        preds / target: candidate and reference sentences.
        model: user encoder ``(input_ids, attention_mask) -> [N, L, d]``
            taking int64 tensors on ``device`` (a torch module's forward, or
            a :class:`~metrics_tpu_torch.ShardedEncoder`); embeddings it
            returns elsewhere are moved to ``device``. A placed
            ``ShardedEncoder`` whose ``in_specs`` split the sentence axis
            encodes and scores this process's rows of each chunk, and the
            scores are gathered over those mesh axes (a collective every
            process of the mesh makes). With ``None`` the
            ``transformers`` default loads ``model_name_or_path`` from local
            files.
        all_layers: score every encoder layer; the outputs become
            ``[num_layers, N]`` per metric, and a user ``model`` must then
            return ``[num_layers, N, L, d]``.
        user_tokenizer: HF-style, or the own-model contract
            ``tokenizer(text, max_length) -> {input_ids, attention_mask}``.
        idf: weight tokens by inverse document frequency over the references.
        max_length: padded sequence length.
        rescale_with_baseline: rescale as ``(score - b) / (1 - b)`` with the
            per-layer baseline ``b`` of ``baseline_path`` (a local copy of the
            bert-score baseline CSV: a header row, then ``layer, precision,
            recall, f1`` rows; the row used is ``num_layers``, the last when
            None).
        device: where the masks, the idf weights and the matching live, and
            where the encoder's inputs go; the GPU unless given.
        length_bucketing: trim each encoder chunk to the smallest power-of-two
            width covering its attended tokens (and pad a ragged last chunk's
            sentence axis to a power of two) instead of padding every chunk
            to ``max_length``. The cut columns are masked and pad rows score
            zeros, so the result is the same for an encoder whose valid
            positions do not depend on trailing padding, and an encoder
            program sees O(log max_length) signatures. ``False`` keeps
            ``[batch, max_length]`` launches.

    Returns:
        dict with per-sentence ``precision``/``recall``/``f1`` lists.

    Example:
        >>> from metrics_tpu_torch.functional import bert_score
        >>> preds = ["hello there", "general kenobi"]
        >>> target = ["hello there", "master kenobi"]
        >>> bert_score(preds, target, model=my_torch_encoder,
        ...            user_tokenizer=my_tokenizer)  # doctest: +SKIP
        {'precision': [1.0, 0.99...], 'recall': [1.0, 0.99...], 'f1': [1.0, 0.99...]}
    """
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    if len(preds) != len(target):
        raise ValueError("Number of predicted and reference sentences must be the same!")
    dev = resolve_device(device)
    baseline = None
    if rescale_with_baseline:
        if baseline_path:
            baseline = _read_baseline_csv(baseline_path)
        else:
            raise ValueError(
                "`rescale_with_baseline` without a local `baseline_path` requires downloading"
                " baseline CSVs, which needs network access not available here. Pass"
                " `baseline_path` pointing at a local copy of the bert-score baseline file."
            )
    forward = model or user_forward_fn
    tokenizer = user_tokenizer
    if forward is None:
        if tokenizer is not None:
            raise ValueError("a user `model` must be provided together with `user_tokenizer`")
        forward, tokenizer = _default_hf_model(model_name_or_path, max_length, num_layers, all_layers, dev)
    elif tokenizer is None:
        raise ValueError("`user_tokenizer` must be provided together with a user `model`")

    preds_tok = _simple_tokenizer_call(tokenizer, list(preds), max_length)
    target_tok = _simple_tokenizer_call(tokenizer, list(target), max_length)
    tokens_idf = _get_tokens_idf(target_tok["input_ids"], target_tok["attention_mask"]) if idf else None

    # special tokens take no part in the matching
    preds_mask = _process_attention_mask_for_special_tokens(preds_tok["attention_mask"])
    target_mask = _process_attention_mask_for_special_tokens(target_tok["attention_mask"])
    preds_idf_scale = _idf_scale(preds_tok["input_ids"], tokens_idf)
    target_idf_scale = _idf_scale(target_tok["input_ids"], tokens_idf)

    n = len(preds)
    # per-side padded widths: a user tokenizer may pad each call to its own width
    p_width = int(preds_tok["input_ids"].shape[1]) if n else int(max_length)
    t_width = int(target_tok["input_ids"].shape[1]) if n else int(max_length)
    mult = forward.batch_multiple() if hasattr(forward, "batch_multiple") else 1
    # a placed ShardedEncoder that stages rows encodes this process's window
    # of each chunk: the pairs are scored there and the scores gathered
    row_window = getattr(forward, "row_window", lambda rows: None)
    want_ndim = 4 if all_layers else 3

    def _encode_side(ids: np.ndarray, mask: np.ndarray, rows: int, width: int, side: str, window: Any) -> torch.Tensor:
        """One encoder launch: the token axis trimmed to ``width``, the
        sentence axis padded to ``rows``, both sliced back (to this
        process's window of the rows where the encoder stages them)."""
        ids_c = torch.from_numpy(np.ascontiguousarray(_pad_rows(ids[:, :width], rows))).to(dev)
        mask_c = torch.from_numpy(np.ascontiguousarray(_pad_rows(mask[:, :width], rows))).to(dev)
        emb = forward(ids_c, mask_c)
        emb = (emb if isinstance(emb, torch.Tensor) else torch.as_tensor(np.asarray(emb))).to(dev)
        if emb.ndim != want_ndim:
            raise ValueError(
                f"With `all_layers={all_layers}` the encoder must return a rank-{want_ndim} array"
                f" ({'[num_layers, n, seq_len, dim]' if all_layers else '[n, seq_len, dim]'}),"
                f" got shape {tuple(emb.shape)} for the {side} sentences."
            )
        if window is not None:
            return emb
        # the sentence axis: 0 for [n, L, d], 1 for all_layers' [layers, n, L, d]
        return emb[:, : ids.shape[0]] if all_layers else emb[: ids.shape[0]]

    def _side_weights(values: np.ndarray, width: int, dtype: torch.dtype, rows: int, window: Any) -> torch.Tensor:
        if window is not None:  # pad rows weigh 0, so they score 0
            values = _pad_rows(values, rows)[window[0]:window[0] + window[1]]
        return torch.from_numpy(np.ascontiguousarray(values[:, :width], dtype=np.float64)).to(dev).to(dtype)

    chunks: List[Dict[str, torch.Tensor]] = []
    for start in range(0, n, batch_size):
        sl = slice(start, start + batch_size)
        p_ids, p_m = preds_tok["input_ids"][sl], preds_tok["attention_mask"][sl]
        t_ids, t_m = target_tok["input_ids"][sl], target_tok["attention_mask"][sl]
        if length_bucketing:
            p_w = _bucket_width(p_m, p_width)
            t_w = _bucket_width(t_m, t_width)
            rows = p_ids.shape[0] if p_ids.shape[0] >= batch_size else next_pow2(p_ids.shape[0])
        else:
            p_w, t_w = p_width, t_width
            rows = p_ids.shape[0]
        if rows % mult:
            rows = ((rows + mult - 1) // mult) * mult
        if length_bucketing and (p_w < p_width or t_w < t_width or rows != p_ids.shape[0]):
            count_bucketed_dispatch()
        window = row_window(rows)
        preds_emb = _encode_side(p_ids, p_m, rows, p_w, "preds", window)
        target_emb = _encode_side(t_ids, t_m, rows, t_w, "target", window)
        scores = _get_precision_recall_f1(
            preds_emb,
            target_emb,
            _side_weights(preds_mask[sl], p_w, preds_emb.dtype, rows, window),
            _side_weights(target_mask[sl], t_w, target_emb.dtype, rows, window),
            _side_weights(preds_idf_scale[sl], p_w, preds_emb.dtype, rows, window),
            _side_weights(target_idf_scale[sl], t_w, target_emb.dtype, rows, window),
        )
        if window is not None:
            # every process returns every pair's scores: 3 floats a pair cross, not its embeddings
            scores = {k: forward.gather_rows(v, rows, dim=-1)[..., : p_ids.shape[0]] for k, v in scores.items()}
        chunks.append(scores)
    keys = ("precision", "recall", "f1")
    if chunks:
        # the sentence axis is last in both layouts: [n] plain, [num_layers, n] stacked; one copy to the host
        scores = torch.stack([torch.cat([c[k] for c in chunks], dim=-1) for k in keys]).cpu().numpy()
        out = dict(zip(keys, scores))
    else:
        # no sentences: the layer count is unknown without an encoder pass
        empty = np.zeros((0, 0)) if all_layers else np.zeros(0)
        out = dict.fromkeys(keys, empty)
    if baseline is not None and np.asarray(out["f1"]).shape[0] > 0:
        out = _rescale_metrics_with_baseline(out, baseline, num_layers, all_layers)
    result: Dict[str, Union[List[float], str]] = {k: np.asarray(v).tolist() for k, v in out.items()}
    if return_hash:
        result["hash"] = f"{model_name_or_path}_L{num_layers}{'_idf' if idf else '_no-idf'}"
    return result
