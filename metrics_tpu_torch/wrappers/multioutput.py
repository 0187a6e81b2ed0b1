"""One clone of a metric per output dimension (counterpart of
``metrics_tpu/wrappers/multioutput.py``).

The JAX package strips rows that hold a NaN on the host with numpy. Here
the rows stay on their device: each output's NaN mask is computed there,
the kept counts of every output are read in one host sync per batch, and
each output's kept rows are gathered in order (a stable sort puts them
first). The batch is never copied to the host. Kept batches vary in length,
so the clones update eagerly when ``remove_nans`` is set, as in JAX.
"""
from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from metrics_tpu_torch.engine import _tree
from metrics_tpu_torch.metric import Metric

__all__ = ["MultioutputWrapper"]


def _get_nan_indices(*tensors: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the rows (dim 0) that hold a NaN in any input."""
    if len(tensors) == 0:
        raise ValueError("Must pass at least one tensor as argument")
    sentinel = tensors[0]
    nan_idxs = torch.zeros(len(sentinel), dtype=torch.bool, device=sentinel.device)
    for t in tensors:
        nan_idxs |= torch.isnan(t.reshape(len(t), -1)).any(dim=1)
    return nan_idxs


class MultioutputWrapper(Metric):
    """Compute one clone of ``base_metric`` per output along ``output_dim``;
    ``compute`` returns the list of per-output values.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError, MultioutputWrapper
        >>> mo = MultioutputWrapper(MeanSquaredError(device="cpu"), num_outputs=2)
        >>> out = mo(torch.tensor([[1.0, 10.0], [2.0, 20.0]]), torch.tensor([[1.0, 11.0], [2.0, 22.0]]))
        >>> print([round(float(v), 2) for v in out])
        [0.0, 2.5]
    """

    is_differentiable = False
    full_state_update = True

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)  # update mutates the child clones
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self.metrics = nn.ModuleList(base_metric.clone() for _ in range(num_outputs))
        for m in self.metrics:
            m.reset()
            if remove_nans:
                # kept batches vary in length: a program per length
                m._enable_jit = False
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _get_args_kwargs_by_output(self, *args: Any, **kwargs: Any) -> List[Tuple[list, dict]]:
        """Each output's slice of the inputs, its NaN rows dropped (under
        ``remove_nans``) and the output axis squeezed (under ``squeeze_outputs``)."""
        leaves, spec = _tree.flatten((args, kwargs))
        tensor_pos = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
        per_output = [
            [leaves[p].narrow(self.output_dim, i, 1) for p in tensor_pos] for i in range(len(self.metrics))
        ]
        if self.remove_nans:
            masks = torch.stack([_get_nan_indices(*sel) for sel in per_output])
            kept = (~masks).sum(dim=1).tolist()  # the one host sync of the batch
            for i, sel in enumerate(per_output):
                rows = torch.argsort(masks[i].to(torch.uint8), stable=True)[: kept[i]]
                per_output[i] = [x.index_select(0, rows) for x in sel]
        out = []
        for sel in per_output:
            if self.squeeze_outputs:
                sel = [x.squeeze(self.output_dim) for x in sel]
            new_leaves = list(leaves)
            for p, x in zip(tensor_pos, sel):
                new_leaves[p] = x
            sel_args, sel_kwargs = _tree.unflatten(spec, new_leaves)
            out.append((list(sel_args), sel_kwargs))
        return out

    def update(self, *args: Any, **kwargs: Any) -> None:
        reshaped = self._get_args_kwargs_by_output(*args, **kwargs)
        for metric, (sel_args, sel_kwargs) in zip(self.metrics, reshaped):
            metric.update(*sel_args, **sel_kwargs)

    def compute(self) -> List[torch.Tensor]:
        return [m.compute() for m in self.metrics]

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Each clone's ``forward`` on its output's slice."""
        reshaped = self._get_args_kwargs_by_output(*args, **kwargs)
        results = [metric(*sel_args, **sel_kwargs) for metric, (sel_args, sel_kwargs) in zip(self.metrics, reshaped)]
        self._update_count += 1
        self._computed = None
        if results[0] is None:
            return None
        self._forward_cache = results
        return results

    def reset(self) -> None:
        super().reset()
        for metric in self.metrics:
            metric.reset()

    def _children(self) -> Dict[str, Metric]:
        return {f"output_{i}": m for i, m in enumerate(self.metrics)}
