"""Times a serving bank's wave on one NVIDIA GPU, and the staging of a
wave's host requests onto the card.

    python3 -m metrics_tpu_torch.serving.wave_probe --trees A B B A --staging

``--trees``: repo checkouts (each holding a ``metrics_tpu_torch``), run in
the order given, each in a fresh process with its own kernel build (so two
versions are compared within one call, as A, B, B, A). Each run serves
``chip_smoke.py`` phase 19a's bank: the ImageNet-1k collection (top-1 and
top-5 ``Accuracy``, macro ``F1Score``, ``ConfusionMatrix``, C = 1000) in a
``MetricBank`` of 512 tenants, fed waves of 256 requests of ``[64, 1000]``
float32 logits already on the card. It prints one JSON line: per replayed
wave, the wall ms and the host ms in ``apply_batch``, and for the last two
waves, each under ``torch.profiler``, the device ms (kernels, copies and
fills summed) and the device operations.

``--staging``: four processes of a gloo world on the card (``chip_smoke.py``
phase 20's layout) each stack 128 host requests of ``[64, 1000]`` float32
logits and int64 targets onto the card, as a pod bank rank stages the
requests it owns, two ways: ``torch.stack(...).to(device)`` from pageable
memory, and a stack into pinned memory copied with ``non_blocking=True``
(``MetricBank._stack``). Each runs with torch's default threads and with
two threads a process, the variants in turns. It prints one JSON line of
the median host ms (the staging call) and wall ms (to the copy's end) per
setting, over every process's waves.

Prints the card's name and power limit first. Needs a CUDA card.
"""
import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

C = 1000
ROWS = 64
TENANTS = 512
WAVE = 256
PER = 4  # requests a tenant: 8 waves, the first the warm-up and capture
PROFILED = 2  # the last waves, each under the profiler
SEED = 19
STAGE_WORLD = 4
STAGE_OWNED = 128
STAGE_ROUNDS = 6
CHILD_TIMEOUT_S = 600


def _device_totals(prof) -> tuple:
    """Device ms and device operations of a profile (kernels, copies and
    fills; the CPU ops that launched them are left out)."""
    us, ops = 0.0, 0
    for evt in prof.key_averages():
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us:
            us += dev_us
            ops += evt.count
    return us / 1e3, ops


def _wave_child(tree: str) -> dict:
    """One tree's bank waves (run in a process of its own)."""
    sys.path.insert(0, os.path.abspath(tree))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.ops import _build
    from metrics_tpu_torch.serving import MetricBank
    from torch.profiler import ProfilerActivity, profile

    if not os.path.abspath(mt.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"metrics_tpu_torch came from {mt.__file__}, not from {tree}")
    _build.library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    n = TENANTS * PER * ROWS
    logits = torch.from_numpy(rng.standard_normal((n, C), dtype=np.float32)).to(dev)
    target = torch.from_numpy(rng.integers(0, C, n)).to(dev)
    collection = mt.MetricCollection(
        {
            "top1": mt.Accuracy(num_classes=C),
            "top5": mt.Accuracy(num_classes=C, top_k=5),
            "f1": mt.F1Score(num_classes=C, average="macro"),
            "confmat": mt.ConfusionMatrix(num_classes=C),
        }
    )
    bank = MetricBank(collection, capacity=TENANTS, name="wave_probe")
    waves = [(r, s) for r in range(PER) for s in range(0, TENANTS, WAVE)]
    out: dict = {"tree": tree, "wall_ms": [], "host_ms": [], "device_ms": [], "device_ops": []}
    for i, (r, s) in enumerate(waves):
        requests = []
        for t in range(s, s + WAVE):
            b = (r * TENANTS + t) * ROWS
            requests.append((t, (logits[b : b + ROWS], target[b : b + ROWS])))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i >= len(waves) - PROFILED:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                bank.apply_batch(requests)
                torch.cuda.synchronize()
            ms, ops = _device_totals(prof)
            out["device_ms"].append(ms)
            out["device_ops"].append(ops)
            continue
        bank.apply_batch(requests)
        torch.cuda.synchronize()
        if i:
            out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            out["host_ms"].append(bank._last_flush_ms)
    if bank.stats["requests"] != TENANTS * PER:
        raise RuntimeError(f"the bank applied {bank.stats['requests']} requests")
    return out


def _stage(col: list, dev: torch.device, pinned: bool) -> torch.Tensor:
    if not pinned:
        return torch.stack(col).to(dev)
    buf = torch.empty((len(col),) + tuple(col[0].shape), dtype=col[0].dtype, pin_memory=True)
    return torch.stack(col, out=buf).to(dev, non_blocking=True)


def _stage_child(rank: int, port: int, threads: int) -> None:
    """One process of the staging world; rank 0 prints every rank's times."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=STAGE_WORLD, rank=rank)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + rank)
    logits = torch.from_numpy(rng.standard_normal((STAGE_OWNED * ROWS, C), dtype=np.float32))
    target = torch.from_numpy(rng.integers(0, C, STAGE_OWNED * ROWS))
    cols = [
        [logits[i * ROWS : (i + 1) * ROWS] for i in range(STAGE_OWNED)],
        [target[i * ROWS : (i + 1) * ROWS] for i in range(STAGE_OWNED)],
    ]
    times: dict = {"pageable": [], "pinned": []}
    for k in range(STAGE_ROUNDS):
        order = ("pageable", "pinned") if k % 2 == 0 else ("pinned", "pageable")
        for variant in order:
            dist.barrier()
            t0 = time.perf_counter()
            staged = [_stage(col, dev, variant == "pinned") for col in cols]
            host = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            if k:  # the first round allocates the pinned pool
                times[variant].append((host, wall))
            del staged
    got: list = [None] * STAGE_WORLD
    dist.all_gather_object(got, times)
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(got))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _staging() -> dict:
    out = {}
    for threads in (0, 2):
        port = _free_port()
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--stage-child", str(r), str(port), str(threads)],
                stdout=subprocess.PIPE,
                text=True,
            )
            for r in range(STAGE_WORLD)
        ]
        try:
            texts = [p.communicate(timeout=CHILD_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise RuntimeError(f"staging world exited {[p.returncode for p in procs]}")
        ranks = json.loads(texts[0].strip().splitlines()[-1])
        label = "default threads" if not threads else f"{threads} threads a process"
        for variant in ("pageable", "pinned"):
            pairs = [p for r in ranks for p in r[variant]]
            out[f"{label}, {variant}"] = {
                "host_ms": statistics.median(h for h, _ in pairs),
                "wall_ms": statistics.median(w for _, w in pairs),
                "waves": len(pairs),
            }
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trees", nargs="*", default=[])
    parser.add_argument("--staging", action="store_true")
    parser.add_argument("--wave-child")
    parser.add_argument("--stage-child", nargs=3, type=int)
    args = parser.parse_args()
    if args.wave_child:
        print(json.dumps(_wave_child(args.wave_child)))
        return
    if args.stage_child:
        _stage_child(*args.stage_child)
        return
    if not torch.cuda.is_available():
        raise SystemExit("wave_probe needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {smi}", flush=True)
    for tree in args.trees:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--wave-child", tree],
            capture_output=True,
            text=True,
            timeout=CHILD_TIMEOUT_S,
        )
        if res.returncode:
            raise RuntimeError(f"wave run of {tree} exited {res.returncode}:\n{res.stderr[-4000:]}")
        print(res.stdout.strip().splitlines()[-1], flush=True)
    if args.staging:
        print(json.dumps({"staging": _staging()}), flush=True)


if __name__ == "__main__":
    main()
