"""A closed stream of whole evaluation epochs through one ``MetricCollection``.

Traffic parameters (``traffic/<name>.json``, ``"kind": "eval_epochs"``):

* ``batch``: items a batch (images, or rows of logits);
* ``distinct_batches``: full batches of seeded inputs held on the device;
  the stream's batch ``j`` (counted across epochs) reads held batch
  ``j % distinct_batches``, and the split's short last batch its first items;
* ``warmup_epochs``: epochs run in set-up, so every shape is captured;
* ``kept_epochs``: epochs whose every output is kept for the comparison,
  drawn by reservoir sampling from the seed into slots allocated in set-up,
  so that the window allocates nothing that grows with its epochs;
* ``traced_epochs``: epochs under the profiler after the window (``--trace 1``).

An epoch is every batch of the split through ``collection(preds, target)``,
then ``compute()`` and ``reset()``. The window runs whole epochs until
``--seconds`` have passed; its rate, under the configuration's
``rate_metric``, is every row scored over all its time.
"""
import gc
import time

import numpy as np

from portbench.lib import harness
from portbench.lib import spec as _spec
from portbench.lib.compare import Gaps
from portbench.lib.profile import DeviceProfile, label, profiler, warm_profiler
from portbench.lib.roofline import cells_touched, confusion_counts_bytes, select_topk_bytes

INDEX_BYTES = 8  # int64 labels, and int64 argmax predictions, as the inputs give them


def _captures(mc) -> int:
    stats = mc.compile_stats()
    return stats["compiles"] + sum(m["compiles"] for m in stats["members"].values())


class _Plan:
    """Which held batch, and how many of its items, each batch of the stream reads."""

    def __init__(self, split: int, batch: int, distinct: int) -> None:
        self.batch, self.distinct = batch, distinct
        self.sizes = [batch] * (split // batch) + ([split % batch] if split % batch else [])

    @property
    def per_epoch(self) -> int:
        return len(self.sizes)

    def epoch(self, e: int):
        n = self.per_epoch
        return [((e * n + b) % self.distinct, size) for b, size in enumerate(self.sizes)]


def run(run, mt, torch):
    cfg, traffic, device = run.cfg, run.traffic, run.device
    plan = _Plan(cfg["split"], traffic["batch"], traffic["distinct_batches"])
    rows_per_item = cfg["rows_per_item"]
    maker = _spec.plugin("makers", cfg["inputs"]["maker"])
    logits, target = maker.make(cfg["inputs"], plan.distinct * plan.batch, run.generator(torch), device)
    run.sync(torch)
    run.part("inputs")

    def batch_of(d: int, size: int):
        s = d * plan.batch
        return logits[s:s + size], target[s:s + size]

    run.reset_peak(torch)
    mc = harness.build_collection(mt, cfg, device)
    call = mc if run.fault is None else run.fault(mc)
    count_states = cfg.get("count_states", {})
    run.part("build")

    def one_epoch(e: int, slot=None, labels: bool = False):
        for b, (d, size) in enumerate(plan.epoch(e)):
            x, y = batch_of(d, size)
            with label(torch, labels, "forward"):
                out = call(x, y)
            if slot is not None:
                for key, t in slot["forward"][b].items():
                    t.copy_(out[key])
        with label(torch, labels, "compute"):
            res = mc.compute()
        if slot is not None:
            for key, t in slot["compute"].items():
                t.copy_(res[key])
            for key, t in slot["states"].items():
                t.copy_(getattr(mc[key], count_states[key]))
        with label(torch, labels, "reset"):
            mc.reset()

    # set-up: capture every shape of the stream; the first epoch's outputs
    # give the kept slots their shapes (allocated before the window)
    outs = []
    for e in range(traffic["warmup_epochs"]):
        for d, size in plan.epoch(e):
            out = call(*batch_of(d, size))
            if e == 0:
                outs.append({k: v.clone() for k, v in out.items()})
        res = mc.compute()
        if e == 0:
            template = {
                "forward": outs,
                "compute": {k: v.clone() for k, v in res.items()},
                "states": {k: getattr(mc[k], a).clone() for k, a in count_states.items()},
            }
        mc.reset()
    slots = [
        {part: ([{k: torch.zeros_like(v) for k, v in o.items()} for o in val] if part == "forward" else {k: torch.zeros_like(v) for k, v in val.items()})
         for part, val in template.items()}
        for _ in range(traffic["kept_epochs"])
    ]
    del template, outs
    if run.trace and run.on_cuda():
        warm_profiler(torch, device)
    run.sync(torch)
    run.part("warmup")
    harness.settle_heap()
    run.setup_done()
    setup_peak = run.peak_bytes(torch)

    # the window
    from metrics_tpu_torch.obs import trace as obs_trace

    if run.trace:
        obs_trace.clear()
        obs_trace.enable_tracing(fence=False)
    rng = run.rng(1)
    slot_epoch = [None] * len(slots)
    captures0 = _captures(mc)
    run.sync(torch)
    t0 = time.perf_counter()
    e = 0
    ends = []  # host seconds into the window at each epoch's end (no sync)
    while True:
        k = e if e < len(slots) else int(rng.integers(0, e + 1))
        slot = slots[k] if k < len(slots) else None
        if slot is not None:
            slot_epoch[k] = e
        one_epoch(e, slot)
        e += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= run.seconds:
            break
    run.sync(torch)
    elapsed = time.perf_counter() - t0
    epochs = e
    peak = run.peak_bytes(torch)
    obs = {"captures": _captures(mc) - captures0}
    if run.trace:
        spans = obs_trace.span_summary().get("forward", {}).get("MetricCollection")
        obs_trace.disable_tracing()
        if spans:
            obs["forward_host_ms_per_epoch"] = spans["total_s"] * 1e3 / epochs
    rows = epochs * sum(plan.sizes) * rows_per_item
    quarters = np.bincount(np.minimum((np.array(ends) / elapsed * 4).astype(int), 3), minlength=4)
    run.log(
        f"window: {epochs} epochs ({epochs * plan.per_epoch} batches, {rows} rows) in {elapsed:.3f} s;"
        f" epochs ended in each quarter of it {quarters.tolist()}; {obs['captures']} captures;"
        f" memory peak {setup_peak} bytes at the set-up's end, {peak} at the window's"
    )

    profile, traced = None, []
    if run.trace and run.on_cuda():
        mt.reset_kernel_stats()
        with profiler(torch) as prof:
            with torch.profiler.record_function("portbench.window"):
                for t in range(traffic["traced_epochs"]):
                    traced.extend(plan.epoch(epochs + t))
                    one_epoch(epochs + t, labels=True)
                run.sync(torch)
        launches = {op: rec["launches"] for op, rec in mt.kernel_stats().items()}
        profile = DeviceProfile(prof.events())
        obs["launches"] = launches
    del mc, call
    gc.collect()
    if run.on_cuda():
        torch.cuda.empty_cache()

    # the reference, once the program is gone
    ref = _spec.plugin("reference", cfg["reference"])
    ks = ref.top_ks(cfg["collection"])
    c = cfg["classes"]

    def outcomes(dtype):
        return [ref.row_outcomes(*batch_of(d, plan.batch), ks, dtype=dtype) for d in range(plan.distinct)]

    ref_rows = outcomes(torch.float32)
    ctl_rows = outcomes(getattr(torch, run.control)) if run.control else None
    cache = {}

    def counts(rows_of, d: int, size: int):
        key = (id(rows_of), d, size)
        if key not in cache:
            n = size * rows_per_item
            o = rows_of[d]
            tgt = target[d * plan.batch:d * plan.batch + size].reshape(-1)
            cache[key] = {
                "confmat": ref.confusion(tgt, o["pred"][:n], c),
                "hits": {k: int(h[:n].sum()) for k, h in o["hits"].items()},
                "rows": n,
            }
        return cache[key]

    def summed(parts):
        out = {"confmat": sum(p["confmat"] for p in parts), "rows": sum(p["rows"] for p in parts)}
        out["hits"] = {k: sum(p["hits"][k] for p in parts) for k in parts[0]["hits"]}
        return out

    def values(cnt):
        return {key: ref.member_value(s, cnt) for key, s in cfg["collection"].items()}

    epoch_cache = {}

    def epoch_counts(rows_of, e: int):
        sig = (id(rows_of), tuple(plan.epoch(e)))
        if sig not in epoch_cache:
            epoch_cache[sig] = summed([counts(rows_of, d, size) for d, size in plan.epoch(e)])
        return epoch_cache[sig]

    gaps = Gaps()
    for slot, e in zip(slots, slot_epoch):
        if e is None:
            continue
        ep = plan.epoch(e)
        want_c = epoch_counts(ref_rows, e)
        got_c = epoch_counts(ctl_rows, e) if ctl_rows is not None else None
        for b, (d, size) in enumerate(ep):
            want = values(counts(ref_rows, d, size))
            got = values(counts(ctl_rows, d, size)) if got_c is not None else slot["forward"][b]
            for key, w in want.items():
                gaps.value(got.get(key), w)
        want = values(want_c)
        got = values(got_c) if got_c is not None else slot["compute"]
        for key, w in want.items():
            gaps.value(got.get(key), w)
        for key, t in slot["states"].items():
            gaps.counts(got_c["confmat"] if got_c is not None else t, want_c["confmat"])

    if profile is not None:
        touched = {}
        cc_bytes = topk_bytes = 0
        for d, size in traced:
            if (d, size) not in touched:
                n = size * rows_per_item
                tgt = target[d * plan.batch:d * plan.batch + size]
                touched[(d, size)] = cells_touched(tgt, ref_rows[d]["pred"][:n], c)
            n = size * rows_per_item
            cc_bytes += confusion_counts_bytes(n, INDEX_BYTES, touched[(d, size)])
            topk_bytes += select_topk_bytes(n, c)
        batches = len(traced)
        launches = obs["launches"]
        obs["kernel_bytes"] = {
            "confusion_counts": cc_bytes * launches.get("confusion_counts", 0) / batches,
            "select_topk": topk_bytes * launches.get("select_topk", 0) / batches,
        }
        obs["profile"] = profile
    return {
        "e2e": {cfg["rate_metric"]: rows / elapsed, "device_peak_gib": peak / 2**30},
        "obs": obs,
        "numbers": gaps.numbers(),
        "compared": gaps.compared,
        "attempted": epochs * plan.per_epoch,
        "failed": 0,
        "peak_bytes": peak,
        "profile": profile,
    }
