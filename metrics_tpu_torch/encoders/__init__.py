"""The "model inside the metric" runtime (counterpart of
``metrics_tpu/encoders``):

* :mod:`metrics_tpu_torch.encoders.runtime`: :class:`ShardedEncoder`, an
  encoder forward as a program of the shared engine cache (entry kind
  ``encode``; a CUDA graph per input signature on the card), its weights
  laid out over a ``DeviceMesh`` by ``param_specs`` (``place(mesh)``), its
  batch staged over the data axes by ``in_specs`` and its output block
  given by ``out_spec``.
* :mod:`metrics_tpu_torch.encoders.stream`: :func:`encode_stream`, fused
  encode-then-accumulate chunks with staging outside the program, pow2 row
  buckets rounded to the encoder's ``batch_multiple()`` and
  ``on_bad_input`` screening upstream of the encoder.

``FrechetInceptionDistance.update_stream`` runs on it, and FID's and
BERTScore's ``encoder_sharding=`` take a placed runtime.
"""
from metrics_tpu_torch.encoders.runtime import (  # noqa: F401
    ShardedEncoder,
    encoder_stats,
    reset_encoder_stats,
)
from metrics_tpu_torch.encoders.stream import StreamResult, encode_stream  # noqa: F401

__all__ = [
    "ShardedEncoder",
    "StreamResult",
    "encode_stream",
    "encoder_stats",
    "reset_encoder_stats",
]
