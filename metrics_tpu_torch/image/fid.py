"""Fréchet Inception Distance (counterpart of ``metrics_tpu/image/fid.py``).

* **Pluggable feature extractor.** An int ``feature`` builds the InceptionV3
  FID network (``image/networks/inception.py``) from local weights, on the
  metric's device; any callable ``imgs -> [N, d]`` also serves. The
  extractor follows the metric to its device (``InceptionV3Features.on``).
* **Streaming sufficient statistics.** When ``feature_dim`` is known the
  states are ``(sum x, sum x x^T, n)`` per distribution, O(d^2) memory,
  named as in the JAX package (``{real,fake}_{sum,sum_c,outer,outer_c,n}``)
  so ``state_dict``s cross between the packages. Without ``feature_dim``
  the reference's buffer-of-features fallback is used.
* **Float64 states on the card.** The moments accumulate in float64, as the
  JAX package's do under ``jax_enable_x64``. On an H100 the ``f.T @ f`` of
  a ``[512, 2048]`` batch is about 4.3 GFLOP in float64, tens of
  microseconds at the FP64 tensor-core rate, beside an Inception forward of
  tens of milliseconds. The ``_c`` states hold the two-sum error terms of
  each addition, as in the JAX package, where they matter for float32.
* **Matrix square root.** ``matrix_sqrt='eigh'`` (the default under
  ``'auto'``) computes on the host in float64 through two symmetric
  eigendecompositions, retrying with an ``eps`` diagonal offset when the
  eigenvalues are not finite. ``'newton_schulz'`` runs the matmul-only
  iteration on the card (``sharding/linalg.py``) and brings back only the
  scalar.
* **Streaming updates.** :meth:`FrechetInceptionDistance.update_stream`
  runs the extractor and the moment accumulation as one captured program
  per chunk signature (``encoders/stream.py``).

* **Feature-sharded moments.** ``feature_sharding="mp"`` registers the
  ``[d]`` and ``[d, d]`` moment states split by feature rows over that mesh
  axis. Placed (``shard_states(mesh)``), each process accumulates only its
  rows, ``f[:, r0:r1].T @ f`` (a plain product, as the JAX package's), and
  ``compute()`` sums the moments over the data axes, gathers the float64
  ``[d, d]`` over the feature axis on the device and runs Newton–Schulz
  (the default square root under ``feature_sharding``).

* **Sharded encoder.** ``encoder_sharding=`` runs the extractor as a
  :class:`~metrics_tpu_torch.encoders.ShardedEncoder` whose weights are laid
  out over the mesh: a ready runtime (any extractor), or, for the built-in
  InceptionV3 (an int ``feature``), a mesh-axis name splitting the network's
  output channels over that axis (``inception_param_specs``).
  :meth:`FrechetInceptionDistance.shard_states` places the states and the
  runtime together; each dispatch gathers the weights and folds the BN, and
  the features of this process's rows feed the feature-split moments in the
  same program.
"""
from functools import lru_cache
from typing import Any, Callable, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.sharding.spec import canonical_spec, class_axis_spec
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.exceptions import MetricsUserError


def _resolve_feature_extractor(feature: Union[int, str], weights_path: Optional[str], device: torch.device) -> Any:
    """int/str feature -> default InceptionV3 extractor (local weights) on ``device``."""
    from metrics_tpu_torch.image.networks.inception import resolve_inception_extractor

    return resolve_inception_extractor(feature, weights_path, device=device)


@lru_cache(maxsize=None)
def _inception_apply_for(feature: str, resize_input: bool) -> Callable:
    """``(params, imgs) -> [N, d]`` for the built-in InceptionV3 tap,
    memoized so every ``FrechetInceptionDistance(encoder_sharding=<axis>)``
    of one tap shares one callable, and with it one encoder program family
    (the program key holds the apply by identity)."""
    from functools import partial

    from metrics_tpu_torch.image.networks.inception import _extract

    return partial(_extract, feature=feature, resize_input=resize_input)


def _extract(extractor: Any, imgs: Any, device: torch.device) -> torch.Tensor:
    """Run ``extractor`` on its copy on ``device`` (the built-in networks
    have one) and return ``[N, d]`` features on ``device``."""
    if hasattr(extractor, "on"):
        extractor = extractor.on(device)
    features = torch.as_tensor(extractor(imgs))
    if features.device != device:
        features = features.to(device)
    return _validate_features(features)


def _validate_features(features: torch.Tensor) -> torch.Tensor:
    """Extractor output must be ``[N, d]``."""
    if features.ndim != 2:
        raise MetricsUserError(
            f"Expected the feature extractor to return a [N, d] array, got shape {tuple(features.shape)}"
        )
    return features


@lru_cache(maxsize=None)
def _moment_consumer_for(feature_dim: int, rows: Optional[Tuple[int, int]] = None) -> Callable:
    """The ``(carry, features, valid) -> carry`` of :meth:`update_stream`,
    memoized per feature dimension and row window: the fused
    encode+accumulate program is keyed by the consumer's identity, so every
    FID instance of one dimensionality (and placement) shares one program
    family. ``rows=(r0, R)``: the feature rows a placed process keeps."""

    def consumer(carry, features, valid):
        if features.ndim != 2 or features.shape[1] != feature_dim:
            raise MetricsUserError(
                f"Feature extractor returned shape {tuple(features.shape)}, expected [N, {feature_dim}]"
            )
        # multiplying by 1.0 is exact: an all-valid chunk adds what update() adds
        f = features.to(carry["sum"].dtype) * valid[:, None].to(carry["sum"].dtype)
        mine = f if rows is None else f[:, rows[0]:rows[0] + rows[1]]
        new = dict(carry)
        for name, delta in (("sum", mine.sum(dim=0)), ("outer", mine.T @ f)):
            acc = carry[name]
            folded = acc + delta
            new[name + "_c"] = carry[name + "_c"] + ((acc - folded) + delta)
            new[name] = folded
        new["n"] = carry["n"] + valid.sum().to(carry["n"].dtype)
        return new

    return consumer


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Symmetric PSD square root via eigendecomposition (host, float64)."""
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def _compute_fid(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray, eps: float = 1e-6
) -> float:
    """d^2 = |mu1 - mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), host float64. The
    trace of ``sqrtm(S1 S2)`` is that of ``sqrtm(S1^1/2 S2 S1^1/2)``, which
    is symmetric PSD; with non-finite eigenvalues the computation is retried
    with ``eps`` on both diagonals."""
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1)
    inner = s1_half @ sigma2 @ s1_half
    vals = np.linalg.eigvalsh(inner)
    if not np.all(np.isfinite(vals)):
        offset = np.eye(sigma1.shape[0]) * eps
        s1_half = _sqrtm_psd(sigma1 + offset)
        inner = s1_half @ (sigma2 + offset) @ s1_half
        vals = np.linalg.eigvalsh(inner)
    tr_covmean = np.sum(np.sqrt(np.clip(vals, 0.0, None)))
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


class FrechetInceptionDistance(Metric):
    """FID between the feature distributions of real and generated images.

    Args:
        feature: an int (selects the default InceptionV3 tap of that
            dimensionality, built from ``weights_path`` on the metric's
            device) or a callable ``imgs -> [N, d]``.
        feature_dim: dimensionality ``d`` of the extractor output; enables the
            O(d^2) streaming-statistics states. Auto-set when ``feature`` is an
            int.
        weights_path: local ``.npz`` InceptionV3 weights (the JAX package's
            files; see ``convert_torch_inception_checkpoint``); falls back to
            ``$METRICS_TPU_INCEPTION_WEIGHTS``. Only used when ``feature`` is
            an int.
        feature_sharding: a mesh-axis name (or ``PartitionSpec``) the
            feature axis of the moment states is split over (needs
            ``feature_dim``); see :meth:`shard_states`.
        matrix_sqrt: ``'eigh'`` (the host eigendecomposition),
            ``'newton_schulz'`` (the matmul-only iteration on the metric's
            device; agrees with the host path to
            ``sharding.NEWTON_SCHULZ_FID_RTOL``), or ``'auto'``: Newton–Schulz
            under ``feature_sharding``, else eigh.
        sqrt_iters: Newton–Schulz iteration count.
        encoder_sharding: run the extractor as a mesh-resident
            :class:`~metrics_tpu_torch.encoders.ShardedEncoder`: a ready
            runtime (any extractor), or, with the built-in InceptionV3 (an
            int ``feature``), a mesh-axis name or ``PartitionSpec`` naming
            one, whose output channels the weights are split over
            (``inception_param_specs``). :meth:`shard_states` places the
            weights and the states together. Pairs with
            ``feature_sharding`` on the same axis.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import FrechetInceptionDistance
        >>> def extractor(imgs):  # any callable imgs -> [N, d]
        ...     return imgs.float().reshape(imgs.shape[0], -1)[:, :8]
        >>> fid = FrechetInceptionDistance(feature=extractor, feature_dim=8, device="cpu")
        >>> gen = torch.Generator().manual_seed(0)
        >>> fid.update(torch.rand(32, 3, 8, 8, generator=gen), real=True)
        >>> fid.update(torch.rand(32, 3, 8, 8, generator=gen), real=False)
        >>> print(round(float(fid.compute()), 2))
        0.09
    """

    is_differentiable = False
    higher_is_better = False
    _sharded_update = True

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        feature_dim: Optional[int] = None,
        weights_path: Optional[str] = None,
        feature_sharding: Optional[Any] = None,
        matrix_sqrt: str = "auto",
        sqrt_iters: int = 40,
        encoder_sharding: Optional[Any] = None,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)  # extractor call is user code
        kwargs.setdefault("compute_on_step", False)  # reference ``fid.py:215``
        super().__init__(**kwargs)
        feature_is_int = isinstance(feature, int)
        if feature_is_int:
            feature = _resolve_feature_extractor(feature, weights_path, self.device)
            if feature_dim is None:
                feature_dim = feature.feature_dim  # O(d^2) streaming stats
        if not callable(feature):
            raise TypeError("Got unknown input to argument `feature`")
        self.inception = feature
        self.feature_dim = feature_dim
        if matrix_sqrt not in ("auto", "eigh", "newton_schulz"):
            raise ValueError(f"`matrix_sqrt` must be 'auto', 'eigh' or 'newton_schulz', got {matrix_sqrt!r}")
        # a canonical tuple, not a PartitionSpec: public attributes key programs
        self.feature_sharding = canonical_spec(class_axis_spec(feature_sharding)) or None
        self._encoder_runtime = None  # the ShardedEncoder, once placed
        self._pending_encoder = None  # a ready runtime, placed at shard_states(mesh)
        self._pending_encoder_axis = None  # the built-in network's axis, runtime built at shard_states(mesh)
        if encoder_sharding is None:
            self.encoder_sharding = None
        elif getattr(encoder_sharding, "_is_sharded_encoder", False):
            self._encoder_runtime = encoder_sharding if encoder_sharding.mesh is not None else None
            self._pending_encoder = encoder_sharding
            self.encoder_sharding = encoder_sharding  # pinned by identity in the fingerprint
        else:
            axis_spec = canonical_spec(class_axis_spec(encoder_sharding))
            if not axis_spec or not isinstance(axis_spec[0], str):
                raise MetricsUserError(
                    "`encoder_sharding` must be a mesh-axis name, a PartitionSpec naming one, or a"
                    f" ShardedEncoder; got {encoder_sharding!r}"
                )
            if not feature_is_int:
                raise MetricsUserError(
                    "`encoder_sharding=<axis>` shards the built-in InceptionV3 extractor (integer"
                    " `feature`). For a custom extractor pass a ready metrics_tpu_torch.ShardedEncoder instead."
                )
            self.encoder_sharding = axis_spec
            self._pending_encoder_axis = axis_spec[0]
        self.matrix_sqrt = matrix_sqrt
        self.sqrt_iters = int(sqrt_iters)
        if feature_dim is None and (self.feature_sharding is not None or matrix_sqrt == "newton_schulz"):
            raise MetricsUserError(
                "feature_sharding / matrix_sqrt='newton_schulz' operate on the"
                " O(d^2) streaming-statistics states and need `feature_dim`"
                " (the buffer-of-features fallback has no fixed covariance"
                " layout to shard)."
            )
        if feature_dim is not None:
            d = int(feature_dim)
            for prefix in ("real", "fake"):
                for name, shape in (("sum", (d,)), ("sum_c", (d,)), ("outer", (d, d)), ("outer_c", (d, d))):
                    self.add_state(
                        f"{prefix}_{name}",
                        default=torch.zeros(shape, dtype=torch.float64),
                        dist_reduce_fx="sum",
                        sharding=self.feature_sharding,
                    )
                self.add_state(f"{prefix}_n", default=torch.tensor(0), dist_reduce_fx="sum")
        else:
            self.add_state("real_features", default=[], dist_reduce_fx="cat")
            self.add_state("fake_features", default=[], dist_reduce_fx="cat")

    # ------------------------------------------------------------------
    # sharded encoder runtime
    # ------------------------------------------------------------------
    def shard_states(self, mesh: Any) -> "FrechetInceptionDistance":
        """Place the registered-sharded states and the encoder runtime on
        ``mesh`` (one layout of the weights, per leaf)."""
        super().shard_states(mesh)
        self._bind_encoder_mesh(mesh)
        return self

    def _bind_encoder_mesh(self, mesh: Any) -> None:
        from metrics_tpu_torch.encoders import ShardedEncoder

        pending = self.__dict__.get("_pending_encoder")
        if pending is not None:
            if pending.mesh is not None and pending.mesh is not mesh:
                raise MetricsUserError(
                    f"encoder_sharding runtime {pending.name!r} is placed on a different mesh than"
                    " shard_states(mesh) received: features would be made on one mesh and accumulated on"
                    " another. Place encoder and states on the same mesh (or pass an unplaced ShardedEncoder"
                    " and let shard_states place it)."
                )
            self._encoder_runtime = pending if pending.mesh is not None else pending.place(mesh)
            return
        axis = self.__dict__.get("_pending_encoder_axis")
        if axis is None:
            return
        runtime = self.__dict__.get("_encoder_runtime")
        if runtime is not None:
            # a runtime this metric built follows the states onto a new mesh
            if runtime.mesh is not mesh:
                runtime.place(mesh)
            return
        from metrics_tpu_torch.image.networks.inception import inception_param_specs
        from metrics_tpu_torch.sharding.spec import PartitionSpec

        extractor = self.inception.on(self.device)
        self._encoder_runtime = ShardedEncoder(
            _inception_apply_for(extractor.feature, extractor.resize_input),
            extractor.params,
            param_specs=inception_param_specs(axis),
            mesh=mesh,
            out_spec=PartitionSpec(None, axis),
            name=f"inception_{extractor.feature}",
            device=self.device,
        )

    def _stream_encoder(self) -> Any:
        """The encoder runtime the streaming driver runs: the placed runtime
        of ``encoder_sharding``, else the extractor on the metric's device,
        wrapped once. A built-in network keeps the
        wrapper, so every FID sharing it (``resolve_inception_extractor``
        shares them) shares its programs; any other callable's wrapper is
        kept by this metric, as in the JAX package. The wrapper's identity
        keys the fused program family."""
        from metrics_tpu_torch.encoders import ShardedEncoder
        from metrics_tpu_torch.image.networks._common import SharedNetwork

        runtime = self.__dict__.get("_encoder_runtime")
        if runtime is not None:
            return runtime
        extractor = self.inception.on(self.device) if hasattr(self.inception, "on") else self.inception
        holder = extractor if isinstance(extractor, SharedNetwork) else self
        kept = holder.__dict__.setdefault("_stream_encoders", {})
        key = str(self.device)
        if key not in kept:
            kept[key] = ShardedEncoder.from_callable(extractor, name=type(extractor).__name__, device=self.device)
        return kept[key]

    def __getstate__(self) -> dict:
        state = super().__getstate__()
        state.pop("_stream_encoders", None)  # its apply is a closure: rebuilt on demand
        # process-local, as the mesh is: a runtime built from the axis is
        # built again at the next shard_states(mesh); a ready one stays in
        # `encoder_sharding` and `_pending_encoder`
        state["_encoder_runtime"] = None
        return state

    def _moment_consumer(self) -> Callable:
        """The ``(carry, features, valid) -> carry`` folding one chunk into
        the moment states: the same accumulation :meth:`update` performs,
        with pad and screened rows zeroed by ``valid``."""
        return _moment_consumer_for(int(self.feature_dim), self._feature_rows())

    def _feature_rows(self) -> Optional[Tuple[int, int]]:
        """This process's feature rows of the placed moment states, or None."""
        rows = self._state_window("real_outer")
        if rows is None and self._shard_layout:
            raise MetricsUserError("FID's moment states are split by feature rows (dimension 0) only")
        return rows

    def _moments(self, real: bool) -> dict:
        prefix = "real" if real else "fake"
        return {name: getattr(self, f"{prefix}_{name}") for name in ("sum", "sum_c", "outer", "outer_c", "n")}

    def _store_moments(self, real: bool, carry: dict) -> None:
        prefix = "real" if real else "fake"
        for name, value in carry.items():
            setattr(self, f"{prefix}_{name}", value)

    def update_stream(self, batches: Iterable[Any], real: bool = True, **stream_kwargs: Any) -> Any:
        """Stream image batches into the tracked distribution without ever
        holding the feature corpus: each chunk runs one fused
        encode+accumulate program (a CUDA graph per chunk signature on the
        card), host batches are staged outside it, the ragged final chunk
        is padded to a pow2 bucket, and this metric's ``on_bad_input``
        policy screens raw images upstream of the encoder. Needs the
        ``feature_dim`` states. Returns the
        :class:`~metrics_tpu_torch.encoders.StreamResult`."""
        if self.feature_dim is None:
            raise MetricsUserError(
                "update_stream accumulates into the O(d^2) streaming-"
                "statistics states and needs `feature_dim` (the buffer-of-"
                "features fallback materializes the corpus by definition)."
            )
        from metrics_tpu_torch.encoders import encode_stream

        carry, result = encode_stream(
            self._stream_encoder(),
            batches,
            self._moment_consumer(),
            self._moments(real),
            screen=self if self.on_bad_input != "propagate" else None,
            source=type(self).__name__,
            **stream_kwargs,
        )
        self._store_moments(real, carry)
        self._update_count += result.chunks + result.batches_quarantined
        self._computed = None
        return result

    def update(self, imgs: Any, real: bool = True) -> None:
        """Extract features and fold them into the tracked distribution."""
        runtime = self.__dict__.get("_encoder_runtime")
        if runtime is not None:
            if self.feature_dim is None:
                raise MetricsUserError(
                    "`encoder_sharding` feeds the O(d^2) streaming-statistics states and needs `feature_dim`"
                )
            # the runtime's rows: the forward and the moments in one program
            imgs = torch.as_tensor(imgs).to(runtime.device)
            valid = torch.ones(imgs.shape[0], dtype=torch.float32, device=runtime.device)
            self._store_moments(real, runtime.encode_into(self._moment_consumer(), self._moments(real), (imgs,), valid))
            return
        features = _extract(self.inception, imgs, self.device)
        if self.feature_dim is not None:
            if features.shape[1] != self.feature_dim:
                raise MetricsUserError(
                    f"Feature extractor returned dim {features.shape[1]}, expected feature_dim={self.feature_dim}"
                )
            valid = torch.ones(features.shape[0], dtype=self.real_sum.dtype, device=features.device)
            self._store_moments(real, self._moment_consumer()(self._moments(real), features, valid))
        elif real:
            self.real_features.append(features)
        else:
            self.fake_features.append(features)

    @staticmethod
    def _stats_from_moments(s: np.ndarray, outer: np.ndarray, n: int) -> tuple:
        mu = s / n
        cov = (outer - n * np.outer(mu, mu)) / (n - 1)
        return mu, cov

    @staticmethod
    def _stats_from_features(features: np.ndarray) -> tuple:
        n = features.shape[0]
        mu = features.mean(axis=0)
        diff = features - mu
        cov = diff.T @ diff / (n - 1)
        return mu, cov

    def _resolved_sqrt(self) -> str:
        if self.matrix_sqrt != "auto":
            return self.matrix_sqrt
        return "newton_schulz" if self.feature_sharding is not None else "eigh"

    def _compute_on_device(self) -> torch.Tensor:
        """FID on the metric's device: the moments (with the two-sum terms
        folded in) and both square roots by Newton–Schulz; only the scalar
        is ever needed on the host."""
        from metrics_tpu_torch.sharding import linalg as _linalg

        mu1, cov1 = _linalg.covariance_from_sums(
            self.real_sum + self.real_sum_c, self.real_outer + self.real_outer_c, self.real_n
        )
        mu2, cov2 = _linalg.covariance_from_sums(
            self.fake_sum + self.fake_sum_c, self.fake_outer + self.fake_outer_c, self.fake_n
        )
        return _linalg.fid_from_moments(mu1, cov1, mu2, cov2, iters=self.sqrt_iters).to(torch.float32)

    def compute(self) -> torch.Tensor:
        """FID from the accumulated statistics: in float64 on the host, or
        on the device by Newton–Schulz (``matrix_sqrt='newton_schulz'``)."""

        def host(x: torch.Tensor) -> np.ndarray:
            return x.detach().cpu().numpy().astype(np.float64)

        if self.feature_dim is not None:
            if int(self.real_n) < 2 or int(self.fake_n) < 2:
                raise MetricsUserError("FID requires at least two samples in each distribution")
            if self._resolved_sqrt() == "newton_schulz":
                return self._compute_on_device()
            mu1, cov1 = self._stats_from_moments(
                host(self.real_sum) + host(self.real_sum_c), host(self.real_outer) + host(self.real_outer_c), int(self.real_n)
            )
            mu2, cov2 = self._stats_from_moments(
                host(self.fake_sum) + host(self.fake_sum_c), host(self.fake_outer) + host(self.fake_outer_c), int(self.fake_n)
            )
        else:
            real = host(dim_zero_cat(self.real_features))
            fake = host(dim_zero_cat(self.fake_features))
            if real.shape[0] < 2 or fake.shape[0] < 2:
                raise MetricsUserError("FID requires at least two samples in each distribution")
            mu1, cov1 = self._stats_from_features(real)
            mu2, cov2 = self._stats_from_features(fake)
        return torch.tensor(_compute_fid(mu1, cov1, mu2, cov2), dtype=torch.float32).to(self.device)
