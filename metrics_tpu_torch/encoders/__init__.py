"""The "model inside the metric" runtime on one device (counterpart of
``metrics_tpu/encoders``):

* :mod:`metrics_tpu_torch.encoders.runtime`: :class:`ShardedEncoder`, an
  encoder forward as a program of the shared engine cache (entry kind
  ``encode``; a CUDA graph per input signature on the card).
* :mod:`metrics_tpu_torch.encoders.stream`: :func:`encode_stream`, fused
  encode-then-accumulate chunks with staging outside the program, pow2 row
  buckets and ``on_bad_input`` screening upstream of the encoder.

``FrechetInceptionDistance.update_stream`` runs on it. The mesh layout of
the JAX runtime (``param_specs``, ``in_specs``, ``out_spec``,
``place(mesh)``) is the encoder's mesh, ROADMAP §1 item 7b.
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
