"""What every driver shares: the run's context, the program's collection,
the guard against the JAX package, and the result line."""
import gc
import json
import math
import sys
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

#: top-level modules that may not be loaded in a run (compared whole: the
#: port's own name, metrics_tpu_torch, begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "metrics_tpu")

CONTROL_DTYPES = ("bfloat16",)


class Run:
    """One run of one cell.

    ``device`` is the card in a benchmark run; the CPU tests pass the CPU,
    where the port runs each kernel op's plain version. ``control`` names a
    lower precision in which the reference stands in the program's place
    for the comparison (the control that has to come out not correct).
    ``fault`` is a callable the CPU tests use to break the timed path
    underneath (it receives the program object the traffic's driver module built).
    """

    def __init__(
        self,
        workload: Dict[str, Any],
        cfg: Dict[str, Any],
        traffic: Dict[str, Any],
        seed: int,
        seconds: float,
        trace: bool,
        device: Any,
        t_start: float,
        control: Optional[str] = None,
        fault: Optional[Callable[[Any], Any]] = None,
        log: Callable[[str], None] = print,
    ) -> None:
        if control is not None and control not in CONTROL_DTYPES:
            raise ValueError(f"control must be one of {CONTROL_DTYPES}, got {control!r}")
        self.workload = workload
        self.cfg = cfg
        self.traffic = traffic
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_start = t_start
        self.control = control
        self.fault = fault
        self.log = log
        self.setup_parts: Dict[str, float] = {}
        self._t_part = t_start
        self.setup_s: Optional[float] = None

    def part(self, name: str) -> None:
        """End one part of the set-up; prints it."""
        now = time.perf_counter()
        self.setup_parts[name] = now - self._t_part
        self._t_part = now
        self.log(f"setup {name}: {self.setup_parts[name]:.3f} s")

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start
        self.log(f"setup_s {self.setup_s:.3f} s: {self.setup_parts}")

    def generator(self, torch):
        """The run's ``torch.Generator`` on its device, seeded from ``--seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed % 2**64)
        return gen

    def rng(self, stream: int):
        """A numpy generator of the run's seed; each use in a run takes its own ``stream``."""
        import numpy as np

        return np.random.default_rng([self.seed % 2**64, stream])

    def on_cuda(self) -> bool:
        return getattr(self.device, "type", str(self.device)) == "cuda"

    def sync(self, torch) -> None:
        if self.on_cuda():
            torch.cuda.synchronize(self.device)

    def reset_peak(self, torch) -> None:
        if self.on_cuda():
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self, torch) -> int:
        return int(torch.cuda.max_memory_allocated(self.device)) if self.on_cuda() else 0


def settle_heap() -> None:
    """Collect, then freeze what set-up left on the heap, so that no full
    collection over the imported modules' objects falls inside the window.

    The collection after the freeze sets the oldest generation's size to
    what is left unfrozen (next to nothing): a full collection then runs
    after its usual number of younger ones, over the window's own objects
    alone. Without it, the threshold stays at the heap's size before the
    freeze, and garbage in reference cycles that reached the oldest
    generation (the program's leaves held by its tree walk's closure) is
    never collected in the window: the memory peak then grows with the
    number of calls the host happened to make."""
    gc.collect()
    gc.freeze()
    gc.collect()


def build_collection(mt, cfg: Dict[str, Any], device) -> Any:
    """The configuration's ``MetricCollection``, built from its file."""
    members = {}
    for key, spec in cfg["collection"].items():
        cls = getattr(mt, spec["class"])
        members[key] = cls(**spec.get("args", {}), device=device)
    return mt.MetricCollection(members)


def forbidden_loaded(names: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded modules (or ``names``) whose top-level name is a forbidden one."""
    names = list(sys.modules) if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN_MODULES)


def finite(x: float) -> Any:
    """A number for the JSON line: infinities and NaN as strings."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def report(
    bench: Dict[str, Any],
    workload: str,
    out: Dict[str, Any],
    setup_s: Optional[float],
    trace: bool,
    device: Dict[str, Any],
    limits: Dict[str, float],
):
    """``(correct, checks, result line)`` of a driver's outcome: the cell's
    end-to-end metrics (``trace`` False) or per-layer ones (``trace`` True)."""
    from portbench.lib import spec
    from portbench.lib.compare import judge

    numbers = out["numbers"]
    correct = judge(numbers, limits) and out["failed"] == 0 and out["compared"] > 0 and out["attempted"] > 0
    checks = {name: {"value": finite(v), "limit": limits.get(name)} for name, v in numbers.items()}
    metrics: Dict[str, Dict[str, Any]] = {}
    breakdown = None
    device = dict(device)
    if trace:
        for m in spec.per_layer(bench, workload):
            value = spec.read_metric(m["name"], out["obs"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        profile = out["profile"]
        device["busy_s"] = profile.busy_s()
        device["window_s"] = profile.window_s
        breakdown = profile.breakdown()
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in spec.end_to_end(bench, workload):
            metrics[m["name"]] = {"value": finite(values[m["name"]]), "unit": m["unit"]}
    line = result_line(correct, out["attempted"], out["failed"], metrics, device, checks, breakdown)
    return correct, checks, line


def result_line(
    correct: bool,
    attempted: int,
    failed: int,
    metrics: Dict[str, Dict[str, Any]],
    device: Dict[str, Any],
    checks: Dict[str, Dict[str, Any]],
    breakdown: Optional[Dict[str, Any]] = None,
) -> str:
    out: Dict[str, Any] = {
        "correct": bool(correct),
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": metrics,
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
