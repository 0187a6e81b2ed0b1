"""Carry metric state, and the networks' weights, across from the JAX package.

What a user carries from one framework to the other is mostly the
accumulated state of a metric mid-stream. A JAX metric's (or
``MetricCollection``'s) ``state_dict()`` holds numpy leaves and lists of
numpy arrays under the same keys this package uses, so the conversion is
per leaf. The attributes a metric learns during ``update`` (its
``_dynamic_state_attrs``, such as ``Accuracy.mode``) are not in a JAX
``state_dict``; pass them as ``dynamic``. The health counters
(``_health_counts``, registered under ``on_bad_input`` and by the
aggregators' ``nan_strategy``) carry across both ways like any state:
both packages register them for the same configurations.

Class- and feature-sharded metrics (``ConfusionMatrix(class_sharding=)``,
macro ``StatScores(class_sharding=)``, FID's ``feature_sharding=``) cross
the same way: a JAX ``state_dict`` holds the global arrays (a sharded
``jax.Array`` converts whole), and loading it into the port's placed metric
(after ``shard_states(mesh)``) keeps each process's shard of them.

Example::

    jax_acc.persistent(True)
    state = state_from_jax(jax_acc.state_dict(), dynamic={"mode": jax_acc.mode})
    port_acc.load_state_dict(state)

The embedding metrics' networks have weights: :func:`inception_params_from_jax`
and :func:`lpips_params_from_jax` turn the JAX package's parameter trees
(numpy leaves, HWIO kernels) into the port's (OIHW kernels, the fc kernel
``[out, in]``), the same tensors the shared ``.npz`` files load into.
"""
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from metrics_tpu_torch.metric import _decode_dynamic, _encode_dynamic


def _leaf(x: Any) -> torch.Tensor:
    # copy: JAX hands out read-only views of its buffers
    return torch.from_numpy(np.array(x, copy=True))


def state_from_jax(
    jax_state: Mapping[str, Union[np.ndarray, List[np.ndarray]]],
    dynamic: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Union[torch.Tensor, List[torch.Tensor], Any]]:
    """A ``state_dict`` that this package's ``load_state_dict`` takes.

    Args:
        jax_state: the JAX ``state_dict()``: array leaves and lists of arrays.
        dynamic: learned attributes by state-dict key (``"mode"``, or
            ``"<member>.mode"`` for a collection). Enum values are carried by
            enum name and value and come back as this package's enum.
    """
    out: Dict[str, Any] = {
        key: [_leaf(x) for x in value] if isinstance(value, list) else _leaf(value)
        for key, value in jax_state.items()
    }
    for key, value in (dynamic or {}).items():
        out[key] = _encode_dynamic(value)
    return out


def inception_params_from_jax(
    jax_params: Mapping[str, Mapping[str, Any]], dtype: torch.dtype = torch.float32, device: Any = "cuda"
) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's InceptionV3 parameter tree (``random_inception_params``,
    ``load_inception_weights``: HWIO kernels, fc ``[in, out]``) as the port's
    (OIHW, fc ``[out, in]``) on ``device``, for ``InceptionV3Features``."""
    from metrics_tpu_torch.image.networks.inception import params_from_file_layout

    return params_from_file_layout(_numpy_tree(jax_params), dtype, device)


def lpips_params_from_jax(
    jax_params: Mapping[str, Mapping[str, Any]], net: str = "vgg", dtype: torch.dtype = torch.float32, device: Any = "cuda"
) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's LPIPS parameter tree of ``net`` (HWIO kernels) as
    the port's (OIHW) on ``device``, for ``LPIPSNetwork``."""
    from metrics_tpu_torch.image.networks.lpips import params_from_file_layout

    return params_from_file_layout(_numpy_tree(jax_params), net, dtype, device)


def _numpy_tree(tree: Mapping[str, Mapping[str, Any]]) -> Dict[str, Dict[str, np.ndarray]]:
    return {mod: {name: np.array(v, copy=True) for name, v in group.items()} for mod, group in tree.items()}


def state_to_jax(port_state: Mapping[str, Any]) -> Dict[str, Any]:
    """The other way: this package's ``state_dict()`` as numpy leaves (lists
    of arrays for list states) that the JAX package's ``load_state_dict``
    takes. Learned attributes come back decoded (enums as this package's
    enum); pass their ``.value`` to the JAX metric's attribute."""
    out: Dict[str, Any] = {}
    for key, value in port_state.items():
        if isinstance(value, torch.Tensor):
            out[key] = value.detach().cpu().numpy()
        elif isinstance(value, list):
            out[key] = [x.detach().cpu().numpy() for x in value]
        else:
            out[key] = _decode_dynamic(value)
    return out
