"""Each cell at a tiny size on the port's CPU path, for the benchmark's tests.

Each configuration's and traffic mix's own file holds its cut under the key
``tiny``: the values that replace its own, nested groups merged key by key
(classes, rows, images, tenants, rates). Every code path of a run is the one
the card runs, but with each kernel op's plain version and no CUDA graphs.
"""
import time
from typing import Any, Callable, Dict, Optional

from portbench.lib import harness, spec


def shrunk(full: Dict[str, Any], name: str) -> Dict[str, Any]:
    """``full`` with its ``tiny`` cut merged in; a file without one cannot run on the CPU."""
    if "tiny" not in full:
        raise KeyError(f"{name} has no 'tiny' cut: add one to its file so the CPU tests can run it")

    def merge(base: Dict[str, Any], cut: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(base)
        for key, value in cut.items():
            out[key] = merge(base.get(key, {}), value) if isinstance(value, dict) else value
        return out

    out = merge(full, full["tiny"])
    del out["tiny"]
    return out


def tiny_run(
    workload,
    seed: int = 12345,
    seconds: float = 0.6,
    control: Optional[str] = None,
    fault: Optional[Callable] = None,
    trace: bool = False,
):
    """``(run, outcome, correct, result line)`` of one tiny run of ``workload`` on
    the CPU: a cell's name, or an entry shaped like one of ``BENCHMARK.json``'s
    ``workloads``."""
    import torch

    import metrics_tpu_torch as mt

    bench = spec.load_spec()
    entry = spec.cell(bench, workload) if isinstance(workload, str) else workload
    workload = entry["name"]
    cfg = shrunk(spec.config(bench, entry["config"]), f"configs/{entry['config']}")
    mix = shrunk(spec.traffic(entry["traffic"]), f"traffic/{entry['traffic']}")
    run = harness.Run(
        entry, cfg, mix, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
        control=control, fault=fault, log=lambda m: None,
    )
    out = spec.plugin("drivers", mix["kind"]).run(run, mt, torch)
    device = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": out["peak_bytes"]}
    correct, _, line = harness.report(bench, workload, out, run.setup_s, False, device, spec.limits(workload))
    return run, out, correct, line
