"""BERTScore module metric (counterpart of ``metrics_tpu/text/bert.py``).

The states are the tokenized sentences, ``"cat"`` buffers of int64
``input_ids`` and ``attention_mask`` rows (storing tokens, not strings, is
what lets them sync). The encoder runs once, at ``compute``, over the whole
accumulated corpus.
"""
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from metrics_tpu_torch.functional.text.bert import _default_hf_model, _simple_tokenizer_call, bert_score
from metrics_tpu_torch.metric import Metric

_BUFFERS = ("preds_input_ids", "preds_attention_mask", "target_input_ids", "target_attention_mask")


class _PreTokenized:
    """Serves buffered token arrays through the functional's tokenizer slot,
    in call order (preds, then target)."""

    def __init__(self, *calls: Dict[str, np.ndarray]) -> None:
        self.calls = list(calls)

    def __call__(self, text: List[str], max_length: int) -> Dict[str, np.ndarray]:
        return self.calls.pop(0)


class BERTScore(Metric):
    """Streaming BERTScore.

    Args:
        model: user encoder ``(input_ids, attention_mask) -> [N, L, d]`` on
            int64 tensors on the metric's device; with ``None`` the
            ``transformers`` default loads ``model_name_or_path`` from local
            files onto the metric's device.
        user_tokenizer: HF-style, or the own-model contract
            ``tokenizer(text, max_length)``.
        idf: idf-weight tokens over the accumulated references.
        max_length: padded sequence length (a fixed width keeps the ``cat``
            states rectangular for sync; an empty buffer syncs as int64
            ``[0, max_length]``).
        encoder_sharding: a :class:`~metrics_tpu_torch.ShardedEncoder` to
            encode with in place of ``model``: each ``(rows, width)``
            signature of the compute-time pass is then one captured
            ``encode`` program (a CUDA graph on the card); a capture the
            encoder refuses raises. Placed on a mesh with ``in_specs``
            splitting the sentence axis, each process encodes and scores its
            rows of every chunk (a pair's two sides stay on one process) and
            the per-sentence scores are gathered, so every process returns
            them all.
        length_bucketing: trim each compute-time encoder chunk to its pow2
            width bucket (see :func:`~metrics_tpu_torch.functional.bert_score`).
        device: where the token buffers, the encoder's inputs and the
            matching live; the GPU unless given.

    Example:
        >>> import numpy as np
        >>> import torch
        >>> from metrics_tpu_torch import BERTScore
        >>> def tokenizer(text, max_length):  # own-tokenizer contract
        ...     ids = np.zeros((len(text), max_length), np.int64)
        ...     mask = np.zeros_like(ids)
        ...     for i, s in enumerate(text):
        ...         toks = [hash(w) % 90 + 10 for w in s.split()][:max_length]
        ...         ids[i, :len(toks)] = toks; mask[i, :len(toks)] = 1
        ...     return {'input_ids': ids, 'attention_mask': mask}
        >>> table = torch.from_numpy(np.random.RandomState(0).normal(size=(100, 8)))
        >>> model = lambda ids, mask: table[ids] * mask[..., None]
        >>> score = BERTScore(model=model, user_tokenizer=tokenizer, max_length=8, device="cpu")
        >>> score.update(['the cat sat'], ['the cat sat'])
        >>> print(round(float(np.asarray(score.compute()['f1'])[0]), 4))  # identical -> 1
        1.0
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
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
        return_hash: bool = False,
        encoder_sharding: Optional[Any] = None,
        length_bucketing: bool = True,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)  # host-side tokenization
        super().__init__(**kwargs)
        self.model_name_or_path = model_name_or_path
        self.num_layers = num_layers
        self.all_layers = all_layers
        if encoder_sharding is not None:
            if not getattr(encoder_sharding, "_is_sharded_encoder", False):
                raise ValueError(
                    "`encoder_sharding` must be a metrics_tpu_torch.ShardedEncoder"
                    f" (the encoder runtime), got {type(encoder_sharding).__name__!r}."
                    " For a plain callable pass `model=` instead."
                )
            if model is not None or user_forward_fn is not None:
                raise ValueError(
                    "pass either `model` (a plain callable) or `encoder_sharding` (a ShardedEncoder), not both."
                )
            model = encoder_sharding
        self.encoder_sharding = encoder_sharding
        self.length_bucketing = length_bucketing
        self._forward = model or user_forward_fn
        self.idf = idf
        self.max_length = max_length
        self.batch_size = batch_size
        self.return_hash = return_hash
        self.lang = lang
        self.rescale_with_baseline = rescale_with_baseline
        self.baseline_path = baseline_path
        self.baseline_url = baseline_url

        if user_tokenizer is not None:
            self.tokenizer = user_tokenizer
            if self._forward is None:
                raise ValueError("a user `model` must be provided together with `user_tokenizer`")
        elif self._forward is not None:
            raise ValueError("`user_tokenizer` must be provided together with a user `model`")
        else:
            self._forward, self.tokenizer = _default_hf_model(
                model_name_or_path, max_length, num_layers, all_layers, self.device
            )

        # int64 rows of max_length: an empty rank's sync gives [0, max_length] int64
        for name in _BUFFERS:
            self.add_state(name, [], dist_reduce_fx="cat", placeholder=torch.zeros((0, max_length), dtype=torch.int64))

    def update(self, preds: List[str], target: List[str]) -> None:
        """Tokenize on the host and buffer the int64 rows on the device."""
        if len(preds) != len(target):
            raise ValueError("Number of predicted and reference sentences must be the same!")
        preds_tok = _simple_tokenizer_call(self.tokenizer, list(preds), self.max_length)
        target_tok = _simple_tokenizer_call(self.tokenizer, list(target), self.max_length)
        arrays = (preds_tok["input_ids"], preds_tok["attention_mask"], target_tok["input_ids"], target_tok["attention_mask"])
        for name, arr in zip(_BUFFERS, arrays):
            getattr(self, name).append(torch.from_numpy(np.asarray(arr, dtype=np.int64)).to(self.device))

    def compute(self) -> Dict[str, Any]:
        """One encoder pass and the matching over the accumulated corpus: the
        buffers are read to the host, as the JAX package does, and replayed
        through :func:`~metrics_tpu_torch.functional.bert_score`."""
        preds_ids, preds_mask, target_ids, target_mask = (self.cat_state(name).cpu().numpy() for name in _BUFFERS)
        tokens = _PreTokenized(
            {"input_ids": preds_ids, "attention_mask": preds_mask},
            {"input_ids": target_ids, "attention_mask": target_mask},
        )
        n = len(preds_ids)
        return bert_score(
            preds=[""] * n,
            target=[""] * n,
            model=self._forward,
            user_tokenizer=tokens,
            idf=self.idf,
            max_length=self.max_length,
            batch_size=self.batch_size,
            length_bucketing=self.length_bucketing,
            return_hash=self.return_hash,
            model_name_or_path=self.model_name_or_path,
            num_layers=self.num_layers,
            all_layers=self.all_layers,
            lang=self.lang,
            rescale_with_baseline=self.rescale_with_baseline,
            baseline_path=self.baseline_path,
            baseline_url=self.baseline_url,
            device=self.device,
        )
