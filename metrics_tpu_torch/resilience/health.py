"""Numerical-health screening and its policies (counterpart of
``metrics_tpu/resilience/health.py``).

One NaN-laced batch poisons a streaming sum forever (``nan + x = nan``).
Every ``Metric`` takes ``on_bad_input``:

* ``"propagate"`` (the default): no screening; the update program is the
  unscreened one.
* ``"raise"``: a contaminated update is quarantined inside the program
  (state unchanged) and a :class:`NumericalHealthError` naming the metric,
  the update index and the NaN and ±Inf counts is raised by the host check
  after the update. The check reads the counters back: one host sync per
  update, a debugging policy.
* ``"skip"``: the whole contaminated update is quarantined and counted; the
  state is bit-identical to never having seen the batch.
* ``"mask"``: only the contaminated rows are dropped, exactly, by the
  bucketing correction (``engine/bucketing.py``): they are zeroed and their
  zero-row contribution subtracted. That is exact for row-additive metrics;
  the others raise :class:`JitIncompatibleError` in the program and fall
  back to the eager update, which filters the rows by boolean indexing.

Screening is branchless (``torch.where``, no host sync), so it runs inside a
captured update program. The JAX package counts the NaN and ±Inf elements
under a ``lax.cond`` that runs only for contaminated batches; a CUDA graph
has no data-dependent branch, so the port counts them on every screened
update and multiplies by the contamination flag (the same counts).

The counters are state: ``_health_counts``, a ``"sum"``-reduced int64
vector of six slots, registered when a policy is active. It rides
``forward`` merges, checkpoints, clones and the cross-process sync like any
state. ``health_screen`` says what is bad: ``"nonfinite"`` (NaN and ±Inf)
or ``"nan"`` (the aggregators' ``nan_strategy``, where ±Inf is data).

While the event bus records, a contaminated update that reaches the host
emits a ``quarantine`` event: ``path="eager"`` from :func:`eager_update`,
``path="compiled"`` from :func:`raise_on_quarantine`'s host check. A
captured ``"skip"`` or ``"mask"`` update emits none: nothing reads its
counters on the host (the JAX package emits none there either).
"""
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.engine import _tree
from metrics_tpu_torch.obs import bus as _obs_bus
from metrics_tpu_torch.utils.exceptions import JitIncompatibleError, NumericalHealthError
from metrics_tpu_torch.utils.prints import rank_zero_warn

HEALTH_POLICIES = ("propagate", "raise", "skip", "mask")

#: The registered state holding the health counters.
HEALTH_STATE = "_health_counts"

# Five additive counters (a zero pad or mask row adds 0, so the corrections
# are exact for them) and SLOT_LAST_BAD, a per-update sentinel that every
# screened update overwrites with its own contamination flag; the "raise"
# host check reads and clears it.
SLOT_NAN, SLOT_INF, SLOT_MASKED, SLOT_QUARANTINED, SLOT_OVERFLOW, SLOT_LAST_BAD = range(6)
N_SLOTS = 6

_REPORT_SLOTS = (
    ("nan_count", SLOT_NAN),
    ("inf_count", SLOT_INF),
    ("rows_masked", SLOT_MASKED),
    ("updates_quarantined", SLOT_QUARANTINED),
    ("overflow_events", SLOT_OVERFLOW),
)


def new_health_stats() -> Dict[str, Any]:
    """The host half of ``health_report()``: ``batches_screened`` (screened
    update dispatches) and ``last_compute_nonfinite``; the ``_seen_*``
    mirrors of the device counters refine the "raise" message."""
    return {
        "batches_screened": 0,
        "last_compute_nonfinite": False,
        "_seen_quarantined": 0,
        "_seen_nan": 0,
        "_seen_inf": 0,
    }


def attach_state(metric: Any) -> None:
    """Register the counter state on ``metric`` (a policy other than propagate)."""
    metric.add_state(HEALTH_STATE, default=torch.zeros(N_SLOTS, dtype=torch.int64), dist_reduce_fx="sum")


def health_enabled(metric: Any) -> bool:
    return getattr(metric, "on_bad_input", "propagate") != "propagate" and HEALTH_STATE in getattr(
        metric, "_defaults", {}
    )


def mask_supported(metric: Any) -> bool:
    """``"mask"`` needs the row-additivity contract of bucketing."""
    from metrics_tpu_torch.engine import bucketing

    return bool(getattr(metric, "_batch_additive", False)) and bucketing.row_additive_states(metric)


def forces_eager(metric: Any) -> bool:
    """True when the policy can never run as a program for this instance:
    the warn-at-removal contract (a host-side warning), or ``"mask"``
    without row-additivity (rows are filtered concretely). Checked before
    dispatch, so such instances never reach a shared program."""
    if not health_enabled(metric):
        return False
    if getattr(metric, "_health_warn_on_bad", False):
        return True
    return metric.on_bad_input == "mask" and not mask_supported(metric)


def record_overflow(metric: Any, overflowed: torch.Tensor) -> None:
    """Add a saturated accumulation (the stat-scores family's
    ``saturating_add``) to the overflow slot from inside ``update``."""
    counts = getattr(metric, HEALTH_STATE)
    slot = torch.zeros_like(counts)
    slot[SLOT_OVERFLOW] = overflowed.to(counts.dtype)
    setattr(metric, HEALTH_STATE, counts + slot)


# ---------------------------------------------------------------------------
# screening
# ---------------------------------------------------------------------------
def _screenable(leaf: Any, device: Optional[torch.device]) -> Optional[torch.Tensor]:
    if isinstance(leaf, float):
        # a fill kernel, not a host-to-device copy (a capture refuses those)
        return torch.full((), leaf, device=device)
    if isinstance(leaf, torch.Tensor) and (leaf.is_floating_point() or leaf.is_complex()):
        return leaf
    return None


def _row_bad(x: torch.Tensor, nan_only: bool) -> torch.Tensor:
    """[B] contamination of each row of one batched leaf; ``x * 0`` is NaN
    exactly for NaN and ±Inf."""
    flat = x.reshape(x.shape[0], -1)
    if nan_only:
        return torch.isnan(flat).any(dim=1)
    return torch.isnan((flat * 0).sum(dim=1))


def _any_bad(x: torch.Tensor, nan_only: bool) -> torch.Tensor:
    if nan_only:
        return torch.isnan(x).any()
    return torch.isnan((x * 0).sum())


def screen_leaves(
    leaves: List[Any],
    batched: Tuple[int, ...],
    nan_only: bool,
    need_rows: bool = True,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Classify the update inputs without a host sync: ``(nan_count,
    inf_count, row_bad, any_bad)``, the NaN and ±Inf element counts over the
    float leaves, the per-row flags over the shared batch axis (None without
    one, or when ``need_rows`` is False) and the whole-update flag. Python
    float leaves are screened on ``device`` (the tensors' device by default)."""
    if device is None:
        device = next((x.device for x in leaves if isinstance(x, torch.Tensor)), None)
    batched_set = set(batched)
    row_bad: Optional[torch.Tensor] = None
    scalar_bad: Optional[torch.Tensor] = None
    screenable: List[torch.Tensor] = []
    for i, leaf in enumerate(leaves):
        x = _screenable(leaf, device)
        if x is None:
            continue
        screenable.append(x)
        if need_rows and i in batched_set and x.ndim >= 1:
            rows = _row_bad(x, nan_only)
            row_bad = rows if row_bad is None else row_bad | rows
        else:
            bad = _any_bad(x, nan_only)
            scalar_bad = bad if scalar_bad is None else scalar_bad | bad
    if not screenable:
        zero = torch.zeros((), dtype=torch.int64, device=device)
        return zero, zero, None, torch.zeros((), dtype=torch.bool, device=device)
    if row_bad is not None:
        if scalar_bad is not None:
            # a bad non-batched leaf (a scalar weight) taints every row
            row_bad = row_bad | scalar_bad
        any_bad = row_bad.any()
    else:
        any_bad = scalar_bad if scalar_bad is not None else torch.zeros((), dtype=torch.bool, device=device)
    # the counts describe contaminated updates only (under "nan" screening
    # a ±Inf is data): the JAX package's lax.cond, as a multiply
    nan_c = sum(torch.isnan(x).sum() for x in screenable) * any_bad
    notfin = sum((~torch.isfinite(x)).sum() for x in screenable) * any_bad
    return nan_c, notfin - nan_c, row_bad, any_bad


def _zero_bad_rows(leaves: List[Any], batched: Tuple[int, ...], row_bad: torch.Tensor) -> List[Any]:
    batched_set = set(batched)
    out: List[Any] = []
    for i, leaf in enumerate(leaves):
        if i in batched_set:
            mask = row_bad.reshape((-1,) + (1,) * (leaf.ndim - 1))
            leaf = torch.where(mask, torch.zeros((), dtype=leaf.dtype, device=leaf.device), leaf)
        out.append(leaf)
    return out


# ---------------------------------------------------------------------------
# the program body
# ---------------------------------------------------------------------------
def _run_inner(inst: Any, state: Dict[str, Any], args: Tuple, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    inst._restore_state(state)
    inst._inner_update(*args, **kwargs)
    return inst._snapshot_state()


def _zero_row_delta(inst: Any, args: Tuple, kwargs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``update(default, zero_row) - default`` per state: what one zero pad
    (or masked) row adds, the correction term of pow2 padding and of row
    masking. It depends on the configuration and the row's shapes only, so
    it is computed once per instance and row signature, eagerly, and kept
    on the instance (the JAX compiler folds it to a constant): a captured
    program reads it and runs no update of its own for it."""
    from metrics_tpu_torch.engine import bucketing

    leaves, treedef = _tree.flatten((args, kwargs))
    batched = bucketing.batched_leaf_indices(leaves)
    row_leaves = bucketing.row_slice_leaves(leaves, batched)
    key = (treedef,) + tuple(
        (tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor) else ("v", x) for x in row_leaves
    )
    cache = inst.__dict__.setdefault("_zero_row_deltas", {})
    if key not in cache:
        row_args, row_kwargs = _tree.unflatten(treedef, row_leaves)
        defaults = inst.init_state()
        saved = inst._snapshot_state()
        try:
            row_out = _run_inner(inst, defaults, row_args, row_kwargs)
        finally:
            inst._restore_state(saved)
        cache[key] = {n: row_out[n] - defaults[n] for n in row_out}
    return cache[key]


def _subtract_rows(out: torch.Tensor, count: Any, delta: torch.Tensor) -> torch.Tensor:
    """``out - count * delta`` in the state's own dtype."""
    count = count.to(out.dtype) if isinstance(count, torch.Tensor) else count
    return out - count * delta


def traced_update(
    inst: Any,
    state: Dict[str, Any],
    args: Tuple,
    kwargs: Dict[str, Any],
    pad_count: Optional[Any] = None,
    global_bad: Optional[torch.Tensor] = None,
    quarantine_share: int = 1,
) -> Dict[str, Any]:
    """One screened state transition, the body of every engine program
    (exact and pow2-bucketed, single metric and fused collection, each step
    of ``drive``). ``pad_count`` is the number of zero rows the bucketing
    appended (None for exact shapes). Under ``"propagate"`` it is the plain
    update with the pad correction.

    A sharded drive gives each process a slice of the batch, while a
    quarantine is a verdict on the whole batch: ``global_bad`` is that
    verdict (the whole batch held a bad element), and ``quarantine_share``
    (1 on one process of the data axes, 0 on the others) makes the summed
    counters count one quarantined update, not one per process."""
    policy = getattr(inst, "on_bad_input", "propagate")
    if policy == "propagate":
        out = _run_inner(inst, state, args, kwargs)
        if pad_count is None:
            return out
        delta = _zero_row_delta(inst, args, kwargs)
        return {n: _subtract_rows(out[n], pad_count, delta[n]) for n in out}

    if getattr(inst, "_health_warn_on_bad", False):
        raise JitIncompatibleError(
            f"nan_strategy='warn' on {type(inst).__name__} warns at every NaN removal, which an update"
            " program cannot do; falling back to the eager update."
        )
    if pad_count is None:
        # the metric's own normalization before screening (the aggregators
        # flatten rank >= 2 values so "mask" drops elements); not on padded
        # inputs, whose pad_count counts rows of the original batch axis
        args, kwargs = inst._health_prescreen(args, kwargs)

    from metrics_tpu_torch.engine import bucketing

    leaves, treedef = _tree.flatten((args, kwargs))
    batched = bucketing.batched_leaf_indices(leaves)
    nan_only = getattr(inst, "health_screen", "nonfinite") == "nan"
    nan_count, inf_count, row_bad, any_bad = screen_leaves(
        leaves, batched, nan_only, need_rows=policy == "mask", device=state[HEALTH_STATE].device
    )

    use_mask = policy == "mask"
    if use_mask and not mask_supported(inst):
        raise JitIncompatibleError(
            f"on_bad_input='mask' needs the row-additivity contract (`_batch_additive` with all-'sum'"
            f" tensor states) to drop rows inside a program; {type(inst).__name__} does not declare it."
            " Falling back to the eager update, which filters the rows."
        )
    if use_mask and row_bad is None:
        use_mask = False  # no batch axis: quarantine the whole update

    if global_bad is not None:
        any_bad = any_bad | global_bad.to(device=any_bad.device, dtype=torch.bool)
    counts_dtype = state[HEALTH_STATE].dtype
    run_leaves = leaves
    n_bad: Any = 0
    if use_mask:
        n_bad = row_bad.sum()
        run_leaves = _zero_bad_rows(leaves, batched, row_bad)
    run_args, run_kwargs = _tree.unflatten(treedef, run_leaves)

    out = _run_inner(inst, state, run_args, run_kwargs)

    drop: Any = None
    if pad_count is not None:
        drop = pad_count + n_bad if use_mask else pad_count
    elif use_mask:
        drop = n_bad
    if drop is not None:
        delta = _zero_row_delta(inst, run_args, run_kwargs)
        out = {n: _subtract_rows(out[n], drop, delta[n]) for n in out}

    quarantine = policy in ("skip", "raise") or not use_mask
    if quarantine:
        out = {n: torch.where(any_bad.to(out[n].device), state[n], out[n]) for n in out}

    counts = out[HEALTH_STATE]
    bad = any_bad.to(device=counts.device, dtype=counts_dtype)
    zero = torch.zeros((), dtype=counts_dtype, device=counts.device)
    masked = torch.as_tensor(n_bad).to(device=counts.device, dtype=counts_dtype) if use_mask else zero
    delta = torch.stack(
        [
            nan_count.to(device=counts.device, dtype=counts_dtype),
            inf_count.to(device=counts.device, dtype=counts_dtype),
            zero if quarantine else masked,
            bad * quarantine_share if quarantine else zero,
            zero,
            zero,
        ]
    )
    counts = counts + delta
    # the sentinel is overwritten with this update's flag, not accumulated
    out[HEALTH_STATE] = torch.cat([counts[:SLOT_LAST_BAD], bad.reshape(1)])
    return out


# ---------------------------------------------------------------------------
# the eager transition (list states, eager fallbacks)
# ---------------------------------------------------------------------------
def eager_update(inst: Any, args: Tuple, kwargs: Dict[str, Any]) -> None:
    """The screened update on concrete values, in place: ``"raise"`` raises
    at once, ``"mask"`` filters the bad rows by boolean indexing (no
    additivity needed) and the aggregators' legacy ``"warn"`` warns."""
    policy = getattr(inst, "on_bad_input", "propagate")
    if policy == "propagate" or not health_enabled(inst):
        inst._inner_update(*args, **kwargs)
        return
    from metrics_tpu_torch.engine import bucketing

    args, kwargs = inst._health_prescreen(args, kwargs)
    leaves, treedef = _tree.flatten((args, kwargs))
    batched = bucketing.batched_leaf_indices(leaves)
    nan_only = getattr(inst, "health_screen", "nonfinite") == "nan"
    nan_count, inf_count, row_bad, any_bad = screen_leaves(
        leaves, batched, nan_only, device=getattr(inst, HEALTH_STATE).device
    )
    nan_i, inf_i = int(nan_count), int(inf_count)

    def _bump(masked: int = 0, quarantined: int = 0) -> None:
        counts = getattr(inst, HEALTH_STATE)
        delta = torch.zeros(N_SLOTS, dtype=counts.dtype)
        delta[SLOT_NAN], delta[SLOT_INF] = nan_i, inf_i
        delta[SLOT_MASKED], delta[SLOT_QUARANTINED] = masked, quarantined
        setattr(inst, HEALTH_STATE, counts + delta.to(counts.device))

    if not bool(any_bad):
        inst._inner_update(*args, **kwargs)
        _bump()
        return
    if _obs_bus.enabled():
        # one event per contaminated update, whatever the policy does with it
        _obs_bus.emit(
            "quarantine",
            source=type(inst).__name__,
            policy=policy,
            nan_count=nan_i,
            inf_count=inf_i,
            update_index=inst._update_count,
            path="eager",
        )
    if policy == "raise":
        _bump(quarantined=1)
        counts = getattr(inst, HEALTH_STATE).cpu()
        inst._health_stats["_seen_quarantined"] = int(counts[SLOT_QUARANTINED])
        inst._health_stats["_seen_nan"] = int(counts[SLOT_NAN])
        inst._health_stats["_seen_inf"] = int(counts[SLOT_INF])
        raise NumericalHealthError(_raise_message(inst, inst._update_count, nan_i, inf_i))
    if getattr(inst, "_health_warn_on_bad", False):
        rank_zero_warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)
    if policy == "skip" or row_bad is None:
        _bump(quarantined=1)
        return
    keep = ~row_bad
    n_bad = int(row_bad.sum())
    if not bool(keep.any()):
        _bump(masked=n_bad)
        return
    batched_set = set(batched)
    filtered = [leaf[keep] if i in batched_set else leaf for i, leaf in enumerate(leaves)]
    run_args, run_kwargs = _tree.unflatten(treedef, filtered)
    inst._inner_update(*run_args, **run_kwargs)
    _bump(masked=n_bad)


# ---------------------------------------------------------------------------
# host-side checks and reports
# ---------------------------------------------------------------------------
def _raise_message(metric: Any, update_index: int, nan_i: int, inf_i: int) -> str:
    return (
        f"Encountered `nan` values or ±inf in the inputs of"
        f" {type(metric).__name__}.update (update #{update_index}):"
        f" {nan_i} NaN and {inf_i} ±Inf element(s) this update. The"
        " contaminated update was quarantined — the accumulated states"
        f" ({', '.join(n for n in metric._defaults if n != HEALTH_STATE)})"
        " are unchanged (on_bad_input='raise')."
    )


def reset_seen_mirrors(metric: Any, counts: Optional[np.ndarray] = None) -> None:
    """Re-sync the "raise" host mirrors with the counters after they changed
    outside an update (``reset()``, a checkpoint load); zeros by default."""
    stats = getattr(metric, "_health_stats", None)
    if stats is None:
        return
    if counts is None:
        stats["_seen_quarantined"] = stats["_seen_nan"] = stats["_seen_inf"] = 0
    else:
        stats["_seen_quarantined"] = int(counts[SLOT_QUARANTINED])
        stats["_seen_nan"] = int(counts[SLOT_NAN])
        stats["_seen_inf"] = int(counts[SLOT_INF])


def raise_on_quarantine(metric: Any) -> None:
    """The host check behind ``on_bad_input="raise"``: read the counters and
    raise if this update was quarantined. The decision reads the
    per-update sentinel (cleared before raising), so it holds through
    ``forward`` merges, ``reset()`` and checkpoint loads; the mirrors only
    refine the message's NaN and ±Inf counts."""
    cur = getattr(metric, HEALTH_STATE, None)
    if cur is None:
        return
    cur_np = cur.cpu().numpy()  # the advertised per-update host fetch
    stats = metric._health_stats
    nan_c, inf_c = int(cur_np[SLOT_NAN]), int(cur_np[SLOT_INF])
    nan_i = max(0, nan_c - stats.get("_seen_nan", 0))
    inf_i = max(0, inf_c - stats.get("_seen_inf", 0))
    stats["_seen_quarantined"] = int(cur_np[SLOT_QUARANTINED])
    stats["_seen_nan"], stats["_seen_inf"] = nan_c, inf_c
    if int(cur_np[SLOT_LAST_BAD]):
        cleared = cur.clone()
        cleared[SLOT_LAST_BAD] = 0
        setattr(metric, HEALTH_STATE, cleared)
        if _obs_bus.enabled():
            _obs_bus.emit(
                "quarantine",
                source=type(metric).__name__,
                policy="raise",
                nan_count=nan_i,
                inf_count=inf_i,
                update_index=metric._update_count,
                path="compiled",
            )
        raise NumericalHealthError(_raise_message(metric, metric._update_count, nan_i, inf_i))


def check_compute_result(metric: Any, value: Any) -> None:
    """The compute-side check: under ``"raise"`` a non-finite result raises;
    under ``"skip"``/``"mask"`` it is recorded in ``health_report()``.
    Skipped before the first update (an empty stream's defaults)."""
    if getattr(metric, "_update_count", 0) == 0:
        return
    leaves, _ = _tree.flatten(value)
    nan_only = getattr(metric, "health_screen", "nonfinite") == "nan"
    nonfinite = False
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
            continue
        if bool(torch.isnan(leaf).any()) or (not nan_only and bool(torch.isinf(leaf).any())):
            nonfinite = True
            break
    metric._health_stats["last_compute_nonfinite"] = nonfinite
    if nonfinite and getattr(metric, "on_bad_input", "propagate") == "raise":
        raise NumericalHealthError(
            f"compute() of {type(metric).__name__} returned a non-finite result (on_bad_input='raise')."
            f" Health counters: {metric.health_report()}"
        )


def metric_report(metric: Any) -> Dict[str, Any]:
    """The body of ``Metric.health_report()``."""
    out: Dict[str, Any] = {
        "on_bad_input": getattr(metric, "on_bad_input", "propagate"),
        "screen": getattr(metric, "health_screen", "nonfinite"),
        "batches_screened": metric._health_stats["batches_screened"],
        "last_compute_nonfinite": metric._health_stats["last_compute_nonfinite"],
    }
    counts = getattr(metric, HEALTH_STATE, None)
    counts_np = np.zeros(N_SLOTS, dtype=np.int64) if counts is None else counts.cpu().numpy()
    for name, slot in _REPORT_SLOTS:
        out[name] = int(counts_np[slot])
    return out
