"""Feature-extractor networks of the embedding-based image metrics
(counterpart of ``metrics_tpu/image/networks``): InceptionV3 (FID variant)
for FID, KID and IS, and the LPIPS VGG16/AlexNet nets. PyTorch inference
modules over explicit parameter trees, with local-weights loaders (the
``.npz`` files of the JAX package) and converters from the canonical torch
checkpoints. ``inception_param_specs`` is the weights' layout over a mesh
axis (``FrechetInceptionDistance(encoder_sharding=)``).
"""
from metrics_tpu_torch.image.networks.inception import (
    InceptionV3Features,
    clear_inception_extractor_cache,
    convert_torch_inception_checkpoint,
    inception_param_spec,
    inception_param_specs,
    inception_v3,
    load_inception_weights,
    preprocess_inception_input,
    random_inception_params,
    resize_bilinear_tf1,
    resolve_inception_extractor,
    save_inception_weights,
)
from metrics_tpu_torch.image.networks.lpips import (
    LPIPSNetwork,
    convert_torch_lpips_checkpoint,
    load_lpips_weights,
    lpips_distance,
    lpips_param_spec,
    random_lpips_params,
    save_lpips_weights,
)

__all__ = [
    "InceptionV3Features",
    "LPIPSNetwork",
    "clear_inception_extractor_cache",
    "convert_torch_inception_checkpoint",
    "convert_torch_lpips_checkpoint",
    "inception_param_spec",
    "inception_param_specs",
    "inception_v3",
    "load_inception_weights",
    "load_lpips_weights",
    "lpips_distance",
    "lpips_param_spec",
    "preprocess_inception_input",
    "random_inception_params",
    "random_lpips_params",
    "resize_bilinear_tf1",
    "resolve_inception_extractor",
    "save_inception_weights",
    "save_lpips_weights",
]
