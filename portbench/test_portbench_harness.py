"""The benchmark's own tests, on the CPU: ``python -m pytest portbench -q``.

Each cell runs at a tiny size on the port's CPU path and must come out
correct against the reference; the bfloat16 control and each fault the
cells can have, planted underneath the timed path, must come out not
correct. The rest holds the yardstick's pieces: the result line, the byte
counts of the rooflines, the files the harness finds by name, the loads
and the imports. The test marked ``chip`` runs the control on the card.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.lib import harness, profile, roofline, spec
from portbench.lib.tiny import tiny_run

CELLS = [w["name"] for w in spec.load_spec()["workloads"]]


def _kind(workload: str) -> str:
    return spec.traffic(spec.cell(spec.load_spec(), workload)["traffic"])["kind"]


BANK_CELLS = [w for w in CELLS if _kind(w) == "bank_serve"]
FORBIDDEN = ("jax", "jaxlib", "flax", "metrics_tpu")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_matches_reference_on_cpu(workload):
    run, out, correct, line = tiny_run(workload)
    assert correct, out["numbers"]
    assert out["numbers"] == {"counts_off": 0, "score_gap": out["numbers"]["score_gap"], "missing": 0}
    assert out["numbers"]["score_gap"] < 1e-6
    assert out["attempted"] > 0 and out["failed"] == 0 and out["compared"] > 0
    assert run.setup_s is not None and run.setup_s > 0


@pytest.mark.parametrize("workload", CELLS)
def test_lower_precision_control_is_not_correct(workload):
    _, out, correct, _ = tiny_run(workload, control="bfloat16")
    assert not correct
    assert out["numbers"]["counts_off"] > 0 or out["numbers"]["score_gap"] > spec.limits(workload)["score_gap"]


def _replace_confusion_op(monkeypatch, plain):
    from metrics_tpu_torch.ops import registry

    op = registry.get_op("confusion_counts")
    monkeypatch.setitem(registry._REGISTRY, "confusion_counts", registry.KernelOp(op.name, op.kernel, plain, op.eligible))


def _counting_step_returns_nothing(monkeypatch):
    """The counting step leaves the confusion state as it was."""
    from metrics_tpu_torch.ops import confusion_counts as cc

    def unchanged(preds, target, num_classes, rows=None):
        return torch.zeros_like(cc._confusion_counts_plain(preds, target, num_classes, rows=rows))

    _replace_confusion_op(monkeypatch, unchanged)


def _count_altered_where_produced(monkeypatch):
    """One confusion count comes out one higher than the step counted."""
    from metrics_tpu_torch.ops import confusion_counts as cc

    def altered(preds, target, num_classes, rows=None):
        out = cc._confusion_counts_plain(preds, target, num_classes, rows=rows).clone()
        out.view(-1)[0] += 1
        return out

    _replace_confusion_op(monkeypatch, altered)


def _bank_wave_not_written_back(monkeypatch):
    """A bank's wave runs, and its new rows are never written back: the tenants' state is unchanged."""
    from metrics_tpu_torch.serving import MetricBank

    monkeypatch.setattr(MetricBank, "_write_back", lambda self, staged: None)


def _half(x, y):
    """The first half of the scored rows: of the batch's rows, or of each image's pixel rows."""
    if x.ndim > 2:
        return x[:, :, : x.shape[2] // 2], y[:, : y.shape[1] // 2]
    return x[: len(x) // 2], y[: len(y) // 2]


def _half_the_batch(program):
    """Every call sees half of its rows alone; the metrics' means run over that half."""
    if hasattr(program, "submit"):
        return lambda tenant, x, y: program.submit(tenant, *_half(x, y))
    return lambda x, y: program(*_half(x, y))


FAULTS = {
    "state_unchanged": dict(patch=_counting_step_returns_nothing),
    "half_the_batch": dict(fault=_half_the_batch),
    "count_altered": dict(patch=_count_altered_where_produced),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    plan = FAULTS[fault]
    if "patch" in plan:
        plan["patch"](monkeypatch)
    _, out, correct, _ = tiny_run(workload, fault=plan.get("fault"))
    assert not correct, (fault, out["numbers"])


@pytest.mark.parametrize("workload", BANK_CELLS)
def test_bank_state_left_unchanged_is_not_correct(workload, monkeypatch):
    _bank_wave_not_written_back(monkeypatch)
    _, out, correct, _ = tiny_run(workload)
    assert not correct and out["numbers"]["counts_off"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_result_line_schema(workload):
    bench = spec.load_spec()
    _, out, _, line = tiny_run(workload)
    d = json.loads(line)
    assert list(d)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(d)[-1] == "checks"
    assert set(d["checks"]) == {"counts_off", "score_gap", "missing"}
    assert all(set(c) == {"value", "limit"} for c in d["checks"].values())
    names = {m["name"] for m in spec.end_to_end(bench, workload)}
    assert set(d["metrics"]) == names and "setup_s" in names and len(names) >= 3
    for m in d["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float) and m["value"] >= 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(d["device"])


def _fake_event(start, end, name, device=True):
    return SimpleNamespace(
        time_range=SimpleNamespace(start=start, end=end), name=name, device_type="DeviceType.CUDA" if device else "DeviceType.CPU"
    )


def test_traced_line_reads_per_layer_metrics():
    """A traced outcome's line carries the cell's per-layer metrics and the device's busy and window seconds."""
    bench = spec.load_spec()
    events = [
        _fake_event(0, 1000, "portbench.window", device=False),
        _fake_event(100, 300, "portbench.forward", device=False),
        _fake_event(150, 250, "aten::copy_", device=False),
        _fake_event(50, 60, "void confusion_counts_kernel<long>(...)"),
        _fake_event(60, 100, "void topk_mask_regs_kernel<4>(...)"),
        _fake_event(400, 900, "elementwise"),
    ]
    prof = profile.DeviceProfile(events)
    obs = {
        "profile": prof, "captures": 0, "forward_host_ms_per_epoch": 1.5,
        "kernel_bytes": {"confusion_counts": 3.35e12 * 5e-6, "select_topk": 3.35e12 * 20e-6},
    }
    out = {"numbers": {"counts_off": 0, "score_gap": 0.0, "missing": 0}, "failed": 0, "compared": 1, "attempted": 1, "obs": obs, "profile": prof}
    device = {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1}
    correct, _, line = harness.report(bench, "imagenet1k-stream-b8192", out, 1.0, True, device, spec.limits("imagenet1k-stream-b8192"))
    d = json.loads(line)
    assert correct
    m = {k: v["value"] for k, v in d["metrics"].items()}
    assert m["confusion_counts_roofline.eval"] == pytest.approx(50.0)
    assert m["select_topk_roofline"] == pytest.approx(50.0)
    assert m["device.idle_pct.eval"] == pytest.approx(100.0 * (1 - 550 / 1000))
    assert m["engine.captures.eval"] == 0 and m["collection.forward_host_ms.eval"] == 1.5
    assert d["device"]["busy_s"] == pytest.approx(550e-6) and d["device"]["window_s"] == pytest.approx(1000e-6)
    gaps = dict(d["breakdown"]["idle_gaps"])
    assert gaps["forward / aten::copy_"] == pytest.approx(300e-6)  # 100-400, its middle under the copy
    assert gaps["outside the harness's calls"] == pytest.approx(150e-6)  # 0-50 and 900-1000
    assert d["breakdown"]["device_ops"][0] == ["elementwise", pytest.approx(500e-6)]


def test_roofline_bytes_on_hand_made_shapes():
    assert roofline.confusion_counts_bytes(8192, 8, 3) == 2 * 8192 * 8 + 24
    assert roofline.confusion_counts_bytes(16_777_216, 8, 400) == 268_435_456 + 3200
    assert roofline.select_topk_bytes(8192, 1000) == 8192 * 1000 * 8
    assert roofline.select_topk_bytes(2, 3, score_bytes=8) == 2 * 3 * 12
    t = torch.tensor([0, 0, 1, 2, 2, 2])
    p = torch.tensor([0, 0, 1, 2, 1, 2])
    assert roofline.cells_touched(t, p, 3) == 4  # (0, 0), (1, 1), (2, 2) and (2, 1)
    assert roofline.cells_touched(t, torch.tensor([0, 1, 1, 2, 1, 0]), 3) == 6
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)
    assert roofline.roofline_pct(3.35e12, 2.0) == pytest.approx(50.0)
    assert roofline.roofline_pct(10, 0.0) is None


def test_every_file_is_found_by_name():
    bench = spec.load_spec()
    assert bench["command"] == ["python3", "portbench/run.py"] and bench["paths"] == ["portbench"]
    for c in bench["configs"]:
        cfg = spec.config(bench, c["name"])
        spec.plugin("makers", cfg["inputs"]["maker"])
        spec.plugin("reference", cfg["reference"])
    for w in bench["workloads"]:
        mix = spec.traffic(w["traffic"])
        spec.plugin("drivers", mix["kind"])
        for kind, key in (("arrivals", "arrivals"), ("tenants", "tenants_draw")):
            if key in mix:
                spec.plugin(kind, mix[key])
        assert set(spec.limits(w["name"])) == {"counts_off", "score_gap", "missing"}
        assert spec.limits(w["name"])["counts_off"] == 0
        reported = {m["name"] for m in spec.end_to_end(bench, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = spec.per_layer(bench, w["name"])
        assert layer and all(m["moves"] in reported for m in layer)
    for m in bench["per_layer"]:
        module = spec.plugin("metrics", m["name"])
        assert module.read({}) is None  # a reader that finds nothing returns nothing


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in ("import_module", "__import__"):
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                yield node.args[0].value


HERE = Path(__file__).resolve().parent


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    found = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not found, f"{path} imports {found}"


def test_top_level_names_are_compared_whole():
    port = ["metrics_tpu_torch", "metrics_tpu_torch.serving", "jaxtyping", "flaxen"]
    assert harness.forbidden_loaded(port) == []
    assert harness.forbidden_loaded(port + ["metrics_tpu.ops", "jax.numpy", "jaxlib", "flax"]) == ["flax", "jax.numpy", "jaxlib", "metrics_tpu.ops"]


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")) + sorted((HERE / "makers").glob("*.py")) + [HERE / "lib" / "compare.py", HERE / "lib" / "roofline.py"], ids=lambda p: p.name)
def test_reference_and_inputs_import_nothing_of_the_port(path):
    found = [m for m in _imports(path) if m.split(".")[0] == "metrics_tpu_torch"]
    assert not found, f"{path} imports {found}"


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.lib.tiny import tiny_run\n"
        "from portbench.lib.harness import forbidden_loaded\n"
        "tiny_run('imagenet1k-stream-b8192', seconds=0.2)\n"
        "print(forbidden_loaded())\n"
    ) % str(HERE.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=str(HERE.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_means_no_result(tmp_path):
    """Without a CUDA card the harness exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(HERE.parent),
    )
    assert out.returncode != 0 and "correct" not in out.stdout


def test_arrivals_are_the_same_gaps_in_another_order():
    poisson = spec.plugin("arrivals", "poisson")
    mix = {"rate_per_s": 2000}
    a = poisson.due_times(mix, 2.0, np.random.default_rng(1))
    b = poisson.due_times(mix, 2.0, np.random.default_rng(2))
    assert len(a) == len(b) == 4000 and a[-1] < 2.0 and b[-1] < 2.0
    assert np.allclose(np.sort(np.diff(a, prepend=0)), np.sort(np.diff(b, prepend=0)))
    assert not np.allclose(a, b)
    assert np.mean(np.diff(a)) == pytest.approx(1 / 2000, rel=0.01)
    assert len(poisson.due_times({"rate_per_s": 0.1}, 2.0, np.random.default_rng(1))) == 0


def test_tenant_draws():
    rng = np.random.default_rng(3)
    u = spec.plugin("tenants", "uniform").draw({}, 20000, 512, rng)
    assert u.min() >= 0 and u.max() < 512 and len(np.unique(u)) == 512
    counts = np.bincount(u, minlength=512)
    assert counts.max() < 2 * counts.mean()


def test_reference_values_on_a_hand_made_stream():
    ref = spec.plugin("reference", "multiclass")
    logits = torch.tensor([[3.0, 1.0, 2.0], [0.0, 5.0, 5.0], [1.0, 1.0, 0.5], [0.1, 0.2, 0.3]])
    target = torch.tensor([0, 2, 1, 0])
    o = ref.row_outcomes(logits, target, [1, 2])
    assert o["pred"].tolist() == [0, 1, 0, 2]  # ties go to the lower class
    assert o["hits"][1].tolist() == [True, False, False, False]
    assert o["hits"][2].tolist() == [True, True, True, False]  # rank of the tied target: one above it by index
    cm = ref.confusion(target, o["pred"], 3)
    assert cm.tolist() == [[1, 0, 1], [1, 0, 0], [0, 1, 0]]
    cnt = {"confmat": cm, "hits": {1: 1, 2: 3}, "rows": 4}
    assert float(ref.member_value({"class": "Accuracy", "args": {"top_k": 2}}, cnt)) == 0.75
    f1 = ref.member_value({"class": "F1Score", "args": {"average": "macro"}}, cnt)
    assert float(f1) == pytest.approx((2 * 0.5 * 0.5 / 1.0 + 0 + 0) / 3)
    iou = ref.member_value({"class": "JaccardIndex", "args": {"ignore_index": 2, "reduction": "none"}}, cnt)
    assert iou.tolist() == pytest.approx([1 / 3, 0.0])


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_the_card(workload):
    """The bfloat16 control at the cell's own size: three seeds, each not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    for seed in (3000000017, 3000000029, 3000000041):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(seed), "--seconds", "10", "--trace", "0", "--control", "bfloat16"],
            capture_output=True, text=True, timeout=360, cwd=str(HERE.parent),
        )
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is False
