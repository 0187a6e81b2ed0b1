"""Finds the highest request rate an open-loop bank cell sustains.

    python3 portbench/sweep.py --workload imagenet1k-bank-open80 --seeds <n>,<m> --seconds 10 --rates 2200,2300,2400

runs the cell's traffic at each offered rate and seed in turn (each with its
own set-up, in one process) and prints, per run, what was sent and completed,
the latency's 95th percentile, its mean over each third of the window and
the backlog left at the close: requests sent and not yet complete on the
device. A run sustains its rate where that backlog holds at most
``BACKLOG_S`` seconds of arrivals (four times the router's 50 ms deadline:
a queue that grows through a 10 s window holds far more). The highest rate
that every seed sustains is the sweep's answer; the cell's traffic file then
holds 0.8 of it, as a number. The benchmark's runs never search for one.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.lib import harness, spec  # noqa: E402

BACKLOG_S = 0.2


def sustained(backlog: int, rate: float) -> bool:
    return backlog <= rate * BACKLOG_S


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds, each run at every rate")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", required=True, help="comma-separated offered rates, requests/s")
    args = p.parse_args(argv)
    bench = spec.load_spec()
    workload = spec.cell(bench, args.workload)
    cfg = spec.config(bench, workload["config"])
    traffic = spec.traffic(workload["traffic"])
    if "rate_per_s" not in traffic:
        raise SystemExit(f"{args.workload} is not an open-loop cell")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    import metrics_tpu_torch as mt

    driver = spec.plugin("drivers", traffic["kind"])
    rows = []
    seeds = [int(s) for s in args.seeds.split(",")]
    for rate, seed in ((float(r), s) for r in args.rates.split(",") for s in seeds):
        mix = dict(traffic, rate_per_s=rate)
        run = harness.Run(workload, cfg, mix, seed, args.seconds, False, torch.device("cuda", 0), time.perf_counter(), log=lambda m: None)
        out = driver.run(run, mt, torch)
        obs = out["obs"]
        row = {
            "rate_per_s": rate,
            "seed": seed,
            "sent": out["attempted"],
            "completed_per_s": out["e2e"]["bank_requests_per_s"],
            "p95_ms": out["e2e"]["bank_request_p95_ms"],
            "latency_by_third_ms": obs["latency_by_third_ms"],
            "backlog_at_close": obs["backlog_at_close"],
            "mean_wave": obs["mean_wave"],
            "sustained": sustained(obs["backlog_at_close"], rate),
            "correct": out["numbers"]["counts_off"] == 0 and out["failed"] == 0,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    held = {r["rate_per_s"] for r in rows} - {r["rate_per_s"] for r in rows if not r["sustained"]}
    best = max(held, default=None)
    print(json.dumps({"highest_sustained_per_s": best, "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
