"""``MetricCollection``: a dict of metrics with one lifecycle (counterpart of
``metrics_tpu/collections.py``).

``update``, ``forward`` and ``compute`` fuse every member that can run as a
program into ONE program of the engine (``engine/cache.py``): one CUDA graph
replay per batch on the card for all of them, so N stat-scores members
format the same ``(preds, target)`` inside one launch sequence instead of N
eager passes. Members that cannot (list states, eager policies, a failed
program, a synced or pending-sync state) keep their own dispatch. Each
member syncs in its own ``compute()``; with a ``torch.distributed`` world
present ``compute`` is never fused.

``forward``, ``update`` and ``compute`` each run in one span (source
``MetricCollection``) while tracing or the event bus is on; a fenced
``forward`` or ``update`` span waits for the members' states.
"""
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from metrics_tpu_torch.engine import _tree
from metrics_tpu_torch.engine import bucketing as _bucketing
from metrics_tpu_torch.engine import cache as _engine
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.obs import bus as _obs_bus
from metrics_tpu_torch.obs import trace as _obs_trace
from metrics_tpu_torch.obs.warn import instance_token, warn_once
from metrics_tpu_torch.parallel import comm
from metrics_tpu_torch.resilience import health as _health
from metrics_tpu_torch.utils.data import _squeeze_if_scalar
from metrics_tpu_torch.utils.exceptions import MetricsUserError, NumericalHealthError
from metrics_tpu_torch.utils.program import program_scope


class MetricCollection(nn.ModuleDict):
    """Metrics sharing one ``update``/``forward``/``compute``/``reset`` call,
    with per-member kwarg routing and prefix/postfix renaming of results.

    Args:
        metrics: one metric, a list or tuple of metrics (keyed by class
            name), or a dict name -> metric (kept in sorted key order).
        additional_metrics: more metrics appended to a single/sequence input.
        prefix: string prepended to all result keys.
        postfix: string appended to all result keys.

    ``state_dict`` keys are ``"<member>.<state>"``, as in the JAX package.

    The fused programs live in the process-wide engine cache: two
    collections with the same members (clones too) share one program per
    path; :meth:`compile_stats` shows the collection's dispatches. A member
    whose ``compute`` cannot run as a program is left out of the fused
    compute after one failed probe (for good once it has state, for now
    before its first update); :meth:`reset` clears those exclusions, so the
    next epoch probes again.
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
    ) -> None:
        super().__init__()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._warn_token = instance_token()
        self._compile_stats = _engine.new_stats()
        self._clear_fused()
        self.add_metrics(metrics, *additional_metrics)

    def _clear_fused(self) -> None:
        # failure flags and introspection handles of the three fused paths
        # (the programs themselves live in the engine cache)
        self._fused_keys: Tuple[str, ...] = ()
        self._fused_fn: Optional[Any] = None
        self._fused_failed = False
        self._fused_fwd_keys: Tuple[str, ...] = ()
        self._fused_fwd_fn: Optional[Any] = None
        self._fused_fwd_failed = False
        self._fused_cmp_keys: Tuple[str, ...] = ()
        self._fused_cmp_fn: Optional[Any] = None
        self._fused_cmp_failed = False
        self._fused_cmp_probed: Optional[Tuple] = None
        # key -> the member's _update_count when its compute failed the fused
        # probe: 0 is provisional (retried once the member has state)
        self._fused_cmp_excluded: Dict[str, int] = {}

    # -- lifecycle ------------------------------------------------------
    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Every member's ``forward``: accumulate and return the batch values,
        the fusable members' in one program."""
        if not _obs_trace.active():
            return self._forward_impl(*args, **kwargs)
        with _obs_trace.span("forward", "MetricCollection", payload=self._member_states):
            return self._forward_impl(*args, **kwargs)

    def _member_states(self) -> list:
        """Every member's states: what a fenced span waits for."""
        return [m._snapshot_state() for m in self._modules.values()]

    def _forward_impl(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        self._check_drive_synced()
        was_failed = self._fused_fwd_failed
        fused_vals = self._fused_forward(args, kwargs)
        try:
            return {
                self._set_name(k): fused_vals[k] if k in fused_vals else m(*args, **m._filter_kwargs(**kwargs))
                for k, m in self.items(keep_base=True)
            }
        except Exception:
            # the per-member retry raised too: a call-site error, which must
            # not disable the fused path for later, correct, calls
            self._fused_fwd_failed = was_failed
            raise

    def update(self, *args: Any, **kwargs: Any) -> None:
        if not _obs_trace.active():
            self._update_members(*args, **kwargs)
            return
        with _obs_trace.span("update", "MetricCollection", payload=self._member_states):
            self._update_members(*args, **kwargs)

    def _check_drive_synced(self) -> None:
        """A member holding a mesh drive's global state takes no host update
        (the fused programs would skip its own guard)."""
        synced = [k for k, m in self._modules.items() if m._drive_synced]
        if synced:
            raise MetricsUserError(
                f"members {synced} hold the globally-synced state of a mesh-mode engine.drive: a host-side update"
                " would be dropped from (or double-counted in) the cross-rank total. reset() first, or accumulate"
                " further epochs through drive(mesh=...)."
            )

    def _update_members(self, *args: Any, **kwargs: Any) -> None:
        self._check_drive_synced()
        was_failed = self._fused_failed
        done = self._fused_update(args, kwargs)
        try:
            for k, m in self.items(keep_base=True):
                if k not in done:
                    m.update(*args, **m._filter_kwargs(**kwargs))
        except Exception:
            self._fused_failed = was_failed
            raise

    def compute(self) -> Dict[str, Any]:
        """Every member's ``compute``, the fusable members' in one program."""
        if not _obs_trace.active():
            return self._compute_members()
        with _obs_trace.span("compute", "MetricCollection"):
            return self._compute_members()

    def _compute_members(self) -> Dict[str, Any]:
        fused_vals = self._fused_compute()
        return {
            self._set_name(k): fused_vals[k] if k in fused_vals else m.compute() for k, m in self.items(keep_base=True)
        }

    def compute_async(self) -> Any:
        """:meth:`compute` with one coalesced device-to-host copy for the
        whole collection (:class:`~metrics_tpu_torch.engine.AsyncResult`)."""
        from metrics_tpu_torch.engine.driver import async_compute

        return async_compute(self)

    def reset(self) -> None:
        for _, m in self.items(keep_base=True):
            m.reset()
        # probe the fused compute's exclusions again next epoch
        self._fused_cmp_excluded = {}

    # -- fused programs -------------------------------------------------
    def _fusable_keys(self) -> Tuple[str, ...]:
        keys = []
        seen = set()
        for k, m in self._modules.items():
            if not (m._enable_jit and not m._jit_failed and not m.dist_sync_on_step and not m._has_list_state()):
                continue
            if _health.forces_eager(m) or (m._shard_layout and not m._sharded_update):
                continue  # dispatches eagerly by design; the others still fuse
            # an instance under two keys must update twice: only its first
            # key fuses, the others take the per-member path
            if id(m) in seen:
                continue
            seen.add(id(m))
            keys.append(k)
        # one member gains nothing over its own program
        return tuple(keys) if len(keys) >= 2 else ()

    def _forward_fusable_keys(self) -> Tuple[str, ...]:
        """Members whose whole ``forward`` (batch value and merge) fits one
        program: the merge path of ``Metric.forward``, no sync."""
        keys = []
        for k in self._fusable_keys():
            m = self._modules[k]
            use_dance = m.full_state_update if m.full_state_update is not None else not m._states_mergeable
            # a placed member's batch value needs its global view (a gather)
            if use_dance or not m.compute_on_step or m._is_synced or m._shard_layout:
                continue
            keys.append(k)
        return tuple(keys) if len(keys) >= 2 else ()

    def _fused_forward(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """The merge-path members' forwards as one program; ``{key: batch
        value}`` for those handled (the others fall through)."""
        if self._fused_fwd_failed:
            return {}
        keys = self._forward_fusable_keys()
        if not keys:
            return {}
        members = [self._modules[k] for k in keys]
        states = {k: m._snapshot_state() for k, m in zip(keys, members)}
        member_kwargs = {k: m._filter_kwargs(**kwargs) for k, m in zip(keys, members)}
        try:
            entry = _engine.fused_entry("fused_forward", keys, members)
            self._fused_fwd_keys, self._fused_fwd_fn = keys, entry
            vals, merged = entry.invoke(
                "exact", members, self._compile_stats, states, args, member_kwargs, probe=not _engine.probed(members)
            )
        except _engine.FALLBACK_ERRORS:
            self._fused_fwd_failed = True
            for k, m in zip(keys, members):
                m._restore_state(states[k])
            return {}
        except BaseException:
            for k, m in zip(keys, members):
                m._restore_state(states[k])
            raise
        _engine.mark_probed(members)
        out: Dict[str, Any] = {}
        for k, m in zip(keys, members):
            m._restore_state(merged[k])
            m._update_count += 1
            m._computed = None
            out[k] = m._forward_cache = _squeeze_if_scalar(vals[k])
        self._post_fused_health(members)
        return out

    def _fused_update(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Tuple[str, ...]:
        """All fusable members' updates as one program; the keys handled."""
        if self._fused_failed:
            return ()
        keys = self._fusable_keys()
        if not keys:
            return ()
        members = [self._modules[k] for k in keys]
        states = {k: m._snapshot_state() for k, m in zip(keys, members)}
        member_kwargs = {k: m._filter_kwargs(**kwargs) for k, m in zip(keys, members)}
        probe = not _engine.probed(members)
        try:
            entry = _engine.fused_entry("fused_update", keys, members)
            self._fused_keys, self._fused_fn = keys, entry
            spec = None
            if all(m.jit_bucket == "pow2" and _bucketing.supports_bucketing(m) for m in members):
                spec = _bucketing.input_spec(args, member_kwargs)
            if spec is None:
                new_states = entry.invoke("exact", members, self._compile_stats, states, args, member_kwargs, probe=probe)
            else:
                leaves, treedef, batched, pad = spec
                batch = int(leaves[batched[0]].shape[0])
                if _obs_bus.enabled():
                    _bucketing.emit_bucket_event("fused_update", batch, pad)
                p_args, p_kwargs = _tree.unflatten(treedef, _bucketing.pad_leaves(leaves, batched, pad))
                pad_count = _engine.pad_count_tensor(pad, leaves[batched[0]].device)
                new_states = entry.invoke(
                    "bucketed",
                    members,
                    self._compile_stats,
                    states,
                    p_args,
                    p_kwargs,
                    pad_count,
                    probe=probe,
                    bucket=batch + pad,
                )
        except _engine.FALLBACK_ERRORS:
            self._fused_failed = True
            for k, m in zip(keys, members):
                m._restore_state(states[k])
            return ()
        except BaseException:
            for k, m in zip(keys, members):
                m._restore_state(states[k])
            raise
        _engine.mark_probed(members)
        for k, m in zip(keys, members):
            m._restore_state(new_states[k])
            m._update_count += 1
            m._computed = None
        self._post_fused_health(members)
        return keys

    @staticmethod
    def _post_fused_health(members: Any) -> None:
        """The per-update host side of the health policies after a fused
        dispatch: every "raise" member's check runs (and syncs its mirrors)
        before the first error surfaces."""
        first_err: Optional[NumericalHealthError] = None
        for m in members:
            if _health.health_enabled(m):
                m._health_stats["batches_screened"] += 1
                if m.on_bad_input == "raise":
                    try:
                        _health.raise_on_quarantine(m)
                    except NumericalHealthError as err:
                        first_err = first_err or err
        if first_err is not None:
            raise first_err

    def _compute_fusable_keys(self) -> Tuple[str, ...]:
        """Members whose compute fits the fused program: program-capable
        tensor states, no sync configured or pending, no cached result."""
        if comm.distributed_available():
            return ()  # each member syncs inside its own compute()
        keys = []
        for k, m in self._modules.items():
            excluded_at = self._fused_cmp_excluded.get(k)
            if excluded_at is not None and (excluded_at > 0 or m._update_count == excluded_at):
                continue
            if not (m._enable_jit and not m._jit_failed and not m._has_list_state()) or m._compute_is_host_side:
                continue
            if m._shard_layout:
                continue  # a placed member computes on its gathered global view
            if (
                m._is_synced
                or m.dist_sync_fn is not None
                or m._distributed_available_fn is not None
                or m.process_group is not None
                or m._computed is not None
            ):
                continue
            keys.append(k)
        return tuple(keys) if len(keys) >= 2 else ()

    def _fused_compute(self, _warn: bool = True) -> Dict[str, Any]:
        """The fusable members' computes as one program; ``{key: value}``
        for those handled. Mirrors the wrapped compute: the before-update
        warning, ``_computed`` caching, states untouched."""
        if self._fused_cmp_failed:
            return {}
        keys = self._compute_fusable_keys()
        if not keys:
            return {}
        members = [self._modules[k] for k in keys]
        states = {k: m._snapshot_state() for k, m in zip(keys, members)}
        for k, m in zip(keys, members) if _warn else ():
            if m._update_count == 0:
                warn_once(
                    f"The ``compute`` method of metric {m.__class__.__name__}"
                    " was called before the ``update`` method which may lead to errors,"
                    " as metric states have not yet been updated.",
                    UserWarning,
                    key=("compute_before_update", self._warn_token, k),
                )
        probe_key = (keys, tuple(id(m) for m in members))
        try:
            entry = _engine.fused_entry("fused_compute", keys, members)
            self._fused_cmp_keys, self._fused_cmp_fn = keys, entry
            # the members' Python compute bodies run once per member set, so
            # a warm program cannot skip their checks (Accuracy's mode)
            vals = entry.invoke(
                "exact", members, self._compile_stats, states, probe=self._fused_cmp_probed != probe_key
            )
            self._fused_cmp_probed = probe_key
        except Exception as fused_err:  # noqa: BLE001 - probed per member and re-raised below
            for k, m in zip(keys, members):
                m._restore_state(states[k])
            offenders = {k for k, m in zip(keys, members) if not self._compute_runs_as_program(m, states[k])}
            if offenders:
                for k in offenders:
                    self._fused_cmp_excluded[k] = self._modules[k]._update_count
                return self._fused_compute(_warn=False)
            if isinstance(fused_err, _engine.FALLBACK_ERRORS):
                self._fused_cmp_failed = True  # no single member reproduces it
                return {}
            raise
        out: Dict[str, Any] = {}
        for k, m in zip(keys, members):
            m._restore_state(states[k])
            m._computed = value = _squeeze_if_scalar(vals[k])
            out[k] = value
            if _health.health_enabled(m):
                _health.check_compute_result(m, value)
        return out

    @staticmethod
    def _compute_runs_as_program(m: Metric, state: Dict[str, Any]) -> bool:
        """Whether one member's compute runs under the program guard."""
        try:
            with torch.no_grad(), program_scope():
                m._restore_state(state)
                m._compute_impl()
            return True
        except Exception:  # noqa: BLE001 - any failure marks the member
            return False
        finally:
            m._restore_state(state)

    # -- telemetry --------------------------------------------------------
    def compile_stats(self) -> Dict[str, Any]:
        """The collection's fused dispatches, and each member's own
        :meth:`~Metric.compile_stats` under ``members``."""
        out: Dict[str, Any] = dict(self._compile_stats)
        out["members"] = {k: m.compile_stats() for k, m in self._modules.items()}
        return out

    @staticmethod
    def _sync_aggregate(members: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        """Cross-member sync aggregates of member reports already in hand:
        numeric counters summed (``max_dequant_error`` a max), codec counts
        summed, missing ranks unioned."""
        out: Dict[str, Any] = {}
        missing: set = set()
        codec_counts: Dict[str, int] = {}
        for report in members.values():
            for key, value in report.items():
                if key == "max_dequant_error":
                    out[key] = max(out.get(key, 0.0), value)
                elif isinstance(value, (int, float)) and not isinstance(value, bool):
                    out[key] = out.get(key, 0) + value
            for codec, count in report.get("codec_counts", {}).items():
                codec_counts[codec] = codec_counts.get(codec, 0) + count
            missing.update(report["missing_ranks"])
        if codec_counts:
            out["codec_counts"] = codec_counts
        out["missing_ranks"] = sorted(missing)
        return out

    def sync_report(self) -> Dict[str, Any]:
        """Sync counters summed over the members (each syncs in its own
        ``compute()``), the union of their missing ranks, and each member's
        report under ``members``."""
        members = {k: m.sync_report() for k, m in self._modules.items()}
        out = self._sync_aggregate(members)
        out["members"] = members
        return out

    @staticmethod
    def _health_aggregate(members: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        """Numeric health counters summed over member reports already in
        hand, and whether any member's last compute was not finite."""
        out: Dict[str, Any] = {}
        for report in members.values():
            for key, value in report.items():
                if isinstance(value, (int, float)) and not isinstance(value, bool):
                    out[key] = out.get(key, 0) + value
        out["any_compute_nonfinite"] = any(r["last_compute_nonfinite"] for r in members.values())
        return out

    def health_report(self) -> Dict[str, Any]:
        """Numeric health counters summed over the members, whether any
        member's last compute was not finite, and each member's report under
        ``members``."""
        members = {k: m.health_report() for k, m in self._modules.items()}
        out = self._health_aggregate(members)
        out["members"] = members
        return out

    def obs_snapshot(self) -> Dict[str, Any]:
        """Every telemetry surface of the collection in one dict:
        ``members`` maps each key to the member's :meth:`Metric.obs_snapshot`;
        ``fused_compile`` is the collection's own fused dispatches (the
        non-``members`` half of :meth:`compile_stats`); ``sync`` and
        ``health`` are the cross-member aggregates, built from the member
        sections, so each member report runs once."""
        members = {k: m.obs_snapshot() for k, m in self._modules.items()}
        return {
            "class": "MetricCollection",
            "fused_compile": dict(self._compile_stats),
            "sync": self._sync_aggregate({k: s["sync"] for k, s in members.items()}),
            "health": self._health_aggregate({k: s["health"] for k, s in members.items()}),
            "members": members,
        }

    def persistent(self, mode: bool = True) -> None:
        for _, m in self.items(keep_base=True):
            m.persistent(mode)

    # -- pure (explicitly state-passing) API -----------------------------
    def init_state(self) -> Dict[str, Dict[str, Any]]:
        """Fresh per-member states, keyed like ``compute`` results. A metric
        registered under two keys gets two independent states here."""
        return {k: m.init_state() for k, m in self.items()}

    def update_state(self, states: Dict[str, Dict[str, Any]], *args: Any, **kwargs: Any) -> Dict[str, Dict[str, Any]]:
        """Pure update of every member, with per-member kwarg routing."""
        return {k: m.update_state(states[k], *args, **m._filter_kwargs(**kwargs)) for k, m in self.items()}

    def sync_state(
        self,
        states: Dict[str, Dict[str, Any]],
        axis_name: Optional[Union[str, Sequence[str]]] = None,
        hierarchical: bool = False,
        *,
        process_group: Optional[Any] = None,
    ) -> Dict[str, Dict[str, Any]]:
        """With ``axis_name``: every member's state synced over those axes of
        the ``comm.axis_env`` mesh, one collective per state, in key order
        (``comm.sync_state_trees``; ``hierarchical=True`` with two or more
        axes stages them inner axis first). Without: every member's state
        gathered over ``process_group`` (each member's own group when None)
        and reduced, member by member in key order, so every rank issues the
        same collectives."""
        if axis_name is not None and process_group is None:
            items = list(self.items())
            return comm.sync_state_trees(
                states,
                {k: m._reductions for k, m in items},
                axis_name,
                placeholders={k: m._list_placeholders for k, m in items},
                hierarchical=hierarchical,
            )
        return {k: m.sync_state(states[k], process_group=process_group) for k, m in self.items()}

    def compute_state(self, states: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        """Pure compute: ``states -> {key: value}``."""
        return {k: m.compute_state(states[k]) for k, m in self.items()}

    def merge_states(
        self, states_a: Dict[str, Dict[str, Any]], states_b: Dict[str, Dict[str, Any]]
    ) -> Dict[str, Dict[str, Any]]:
        """Merge two independently accumulated collection states, member by member."""
        return {k: m.merge_states(states_a[k], states_b[k]) for k, m in self.items()}

    def to_device(self, device: Union[str, torch.device]) -> "MetricCollection":
        for _, m in self.items(keep_base=True):
            m.to_device(device)
        return self

    def astype(self, dtype: torch.dtype) -> "MetricCollection":
        """Cast every member's current floating-point states to ``dtype``."""
        for _, m in self.items(keep_base=True):
            m.astype(dtype)
        return self

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        """A deep copy of every member under the same keys; ``prefix`` and
        ``postfix`` replace this collection's where given, else are kept."""
        mc = MetricCollection({k: m.clone() for k, m in self._modules.items()})
        mc.prefix = self._check_arg(prefix, "prefix") if prefix is not None else self.prefix
        mc.postfix = self._check_arg(postfix, "postfix") if postfix is not None else self.postfix
        return mc

    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        """Register members: lists key by class name (duplicates forbidden),
        dicts keep user keys in sorted order."""
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                warn_once(f"You have passes extra arguments {remain} which are not Metrics and will be ignored.")
        elif additional_metrics:
            raise ValueError(
                f"You have passes extra arguments {additional_metrics} which are not compatible with mapping input."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if isinstance(metric, Metric):
                    self[name] = metric
                elif isinstance(metric, MetricCollection):
                    for k, v in metric.items(keep_base=False):
                        self[f"{name}_{k}"] = v
                else:
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of `Metric` or `MetricCollection`"
                    )
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if isinstance(metric, MetricCollection):
                    for k, v in metric.items(keep_base=False):
                        self[k] = v
                    continue
                if not isinstance(metric, Metric):
                    raise ValueError(f"Input {metric} to `MetricCollection` is not a instance of `Metric`")
                name = metric.__class__.__name__
                if name in self:
                    raise ValueError(f"Encountered two metrics both named {name}")
                self[name] = metric
        else:
            raise ValueError("Unknown input to MetricCollection.")

    def __getstate__(self) -> Dict[str, Any]:
        # the entry handles hold graphs; a copy finds its entries anew
        state = super().__getstate__() if hasattr(super(), "__getstate__") else self.__dict__.copy()
        state = dict(state)
        state["_fused_fn"] = state["_fused_fwd_fn"] = state["_fused_cmp_fn"] = None
        state["_compile_stats"] = _engine.new_stats()
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        super().__setstate__(state)
        self._warn_token = instance_token()

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def items(self, keep_base: bool = False) -> Iterable[Tuple[str, Metric]]:  # type: ignore[override]
        if keep_base:
            return list(self._modules.items())
        return [(self._set_name(k), v) for k, v in self._modules.items()]

    def keys(self, keep_base: bool = False) -> Iterable[str]:  # type: ignore[override]
        if keep_base:
            return list(self._modules.keys())
        return [self._set_name(k) for k in self._modules.keys()]
