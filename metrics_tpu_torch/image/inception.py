"""Inception Score (counterpart of ``metrics_tpu/image/inception.py``).

The shuffle is ``np.random.default_rng(seed).permutation``, as in the JAX
package, and the splits are ``torch.chunk``'s ceil-sized chunks, never
empty when there are fewer samples than splits. The std over splits has
ddof 1 (KID's has ddof 0). The score is computed in float64 and returned in
the logits' dtype: with logits that vary little between images (a randomly
initialized network's), each split's KL is about 1e-8 and float32 would keep
none of its digits.
"""
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.image.fid import _extract, _resolve_feature_extractor
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.exceptions import MetricsUserError


class InceptionScore(Metric):
    """IS = exp(E_x KL(p(y|x) || p(y))), mean/std over ``splits`` chunks.

    Args:
        feature: callable ``imgs -> [N, num_classes]`` logits, or
            ``"logits_unbiased"``/``"logits"``/an int selecting the default
            InceptionV3 tap (built from ``weights_path``, see FID).
        splits: number of chunks to compute the score over.
        seed: host RNG seed for the pre-split shuffle.
        weights_path: local InceptionV3 ``.npz`` weights for the default.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import InceptionScore
        >>> constant_logits = lambda imgs: torch.tensor([[0.1, 0.9]]).repeat(imgs.shape[0], 1)
        >>> inception = InceptionScore(feature=constant_logits, device="cpu")
        >>> inception.update(torch.rand(16, 3, 8, 8, generator=torch.Generator().manual_seed(0)))
        >>> mean, std = inception.compute()  # constant predictions -> IS of 1
        >>> print(round(float(mean), 4))
        1.0
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        feature: Union[int, str, Callable] = "logits_unbiased",
        splits: int = 10,
        seed: int = 42,
        weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)  # extractor call is user code
        kwargs.setdefault("compute_on_step", False)  # reference ``inception.py:117``
        super().__init__(**kwargs)
        if isinstance(feature, str) and feature not in ("logits", "logits_unbiased"):
            raise ValueError(
                f"Input to argument `feature` must be one of ('logits', 'logits_unbiased'), an int"
                f" feature dimensionality, or a callable, but got {feature!r}"
            )
        if isinstance(feature, (int, str)):
            feature = _resolve_feature_extractor(feature, weights_path, self.device)
        if not callable(feature):
            raise TypeError("Got unknown input to argument `feature`")
        self.inception = feature
        self.splits = splits
        self._seed = seed
        self.add_state("features", default=[], dist_reduce_fx="cat")

    def update(self, imgs: Any) -> None:
        self.features.append(_extract(self.inception, imgs, self.device))

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        features = dim_zero_cat(self.features)
        n = features.shape[0]
        if n == 0:
            raise MetricsUserError("InceptionScore requires at least one sample before `compute`")
        idx = torch.from_numpy(np.random.default_rng(self._seed).permutation(n)).to(features.device)
        out_dtype = features.dtype
        features = features[idx].to(torch.float64)
        prob = features.softmax(dim=1)
        log_prob = features.log_softmax(dim=1)
        kl = []
        for p, lp in zip(prob.chunk(self.splits), log_prob.chunk(self.splits)):
            mean_prob = p.mean(dim=0, keepdim=True)
            kl.append((p * (lp - mean_prob.log())).sum(dim=1).mean())
        score = torch.stack(kl).exp()
        return score.mean().to(out_dtype), score.std(correction=1).to(out_dtype)
