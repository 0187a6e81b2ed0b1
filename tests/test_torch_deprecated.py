"""The port's deprecated short names: each class alias warns on construction
with the JAX package's ``DeprecationWarning`` text and then is its target;
each functional alias warns on call and returns its target's value. Values
equal the target's exactly (the same code runs)."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.deprecated as dj
import metrics_tpu.functional.deprecated as fdj
import metrics_tpu_torch as mt
import metrics_tpu_torch.deprecated as dt
import metrics_tpu_torch.functional as ft
import metrics_tpu_torch.functional.deprecated as fdt

RNG = np.random.default_rng(61)
LOGITS = RNG.standard_normal((30, 4)).astype(np.float32)
LABELS = RNG.integers(0, 4, 30)
X = RNG.standard_normal(30).astype(np.float32)
Y = (X + RNG.standard_normal(30)).astype(np.float32)

# alias, target, constructor kwargs, inputs
CLASSES = [
    ("F1", "F1Score", {"num_classes": 4, "average": "macro"}, (LOGITS, LABELS)),
    ("FBeta", "FBetaScore", {"num_classes": 4, "beta": 0.5}, (LOGITS, LABELS)),
    ("Hinge", "HingeLoss", {}, (LOGITS, LABELS)),
    ("IoU", "JaccardIndex", {"num_classes": 4}, (LOGITS, LABELS)),
    ("MatthewsCorrcoef", "MatthewsCorrCoef", {"num_classes": 4}, (LOGITS, LABELS)),
    ("PearsonCorrcoef", "PearsonCorrCoef", {}, (X, Y)),
    ("SpearmanCorrcoef", "SpearmanCorrCoef", {}, (X, Y)),
]


def _warning_text(fn):
    with pytest.warns(DeprecationWarning) as caught:
        value = fn()
    return value, [str(w.message) for w in caught if w.category is DeprecationWarning]


@pytest.mark.parametrize("alias,target,kwargs,inputs", CLASSES, ids=[c[0] for c in CLASSES])
def test_class_alias_warns_like_jax_and_equals_its_target(alias, target, kwargs, inputs):
    port_m, port_msgs = _warning_text(lambda: getattr(dt, alias)(device="cpu", **kwargs))
    _, jax_msgs = _warning_text(lambda: getattr(dj, alias)(**kwargs))
    assert port_msgs == jax_msgs
    assert isinstance(port_m, getattr(mt, target))
    ref = getattr(mt, target)(device="cpu", **kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for m in (port_m, ref):
            m.update(*map(torch.from_numpy, inputs))
        assert torch.equal(port_m.compute(), ref.compute())


# alias, target, inputs, kwargs
FUNCTIONS = [
    ("f1", "f1_score", (LOGITS, LABELS), {"num_classes": 4, "average": "macro"}),
    ("fbeta", "fbeta_score", (LOGITS, LABELS), {"num_classes": 4, "beta": 2.0}),
    ("hinge", "hinge_loss", (LOGITS, LABELS), {"multiclass_mode": "one-vs-all"}),
    ("pairwise_manhatten_distance", "pairwise_manhattan_distance", (LOGITS, LOGITS[:7]), {}),
]


@pytest.mark.parametrize("alias,target,inputs,kwargs", FUNCTIONS, ids=[f[0] for f in FUNCTIONS])
def test_functional_alias_warns_like_jax_and_equals_its_target(alias, target, inputs, kwargs):
    got, port_msgs = _warning_text(lambda: getattr(fdt, alias)(*map(torch.from_numpy, inputs), **kwargs))
    _, jax_msgs = _warning_text(lambda: getattr(fdj, alias)(*map(jnp.asarray, inputs), **kwargs))
    assert port_msgs == jax_msgs
    assert getattr(fdt, alias).__name__ == alias
    assert torch.equal(got, getattr(ft, target)(*map(torch.from_numpy, inputs), **kwargs))
