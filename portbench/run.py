"""Runs one cell of the benchmark of ``metrics_tpu_torch`` on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
come from ``BENCHMARK.json`` and the files it names under ``portbench/``.
With ``--trace 0`` the result line holds the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from spans, counters and a
profile of more of the same load after the window. The last line of
standard output is one JSON object; the numbers compared against the
reference end standard error, each beside its limit.

``--control bfloat16`` puts the reference, computed in bfloat16, in the
program's place for the comparison: a control that has to come out not
correct. The benchmark's own runs never pass it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.lib import harness, spec  # noqa: E402


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=harness.CONTROL_DTYPES, default=None)
    return p.parse_args(argv)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def _fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    args = _args(argv)
    bench = spec.load_spec()
    workload = spec.cell(bench, args.workload)
    cfg = spec.config(bench, workload["config"])
    traffic = spec.traffic(workload["traffic"])
    limits = spec.limits(args.workload)
    driver = spec.plugin("drivers", traffic["kind"])

    import torch

    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return _fail(f"the cell needs {chips} CUDA device(s); this machine has {n}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    import metrics_tpu_torch as mt

    run = harness.Run(
        workload, cfg, traffic, args.seed, args.seconds, bool(args.trace), device, T_START,
        control=args.control, log=lambda m: print(m, flush=True),
    )
    run.part("start")
    print(f"card: {_power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    out = driver.run(run, mt, torch)

    loaded = harness.forbidden_loaded()
    if loaded:
        return _fail(f"the JAX package or JAX is loaded in this process: {loaded}")

    device_info = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": chips,
        "memory_peak_bytes": out["peak_bytes"],
    }
    if args.trace and out["profile"] is None:
        return _fail("the traced run has no profile")
    correct, checks, line = harness.report(bench, args.workload, out, run.setup_s, bool(args.trace), device_info, limits)
    print(f"compared {out['compared']} outputs; attempted {out['attempted']}, failed {out['failed']}; correct {correct}", flush=True)
    for name, c in checks.items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
