"""The benchmark's description and the files it names.

``BENCHMARK.json`` at the root of the checkout names the cells. Everything
that belongs to one configuration, traffic mix, per-layer metric or cell
lives in a file of its own under ``portbench/``, found by its name:

* ``configs/<config>.json``: sizes, the collection, the input maker, the reference;
* ``traffic/<traffic>.json``: the mix, read by ``drivers/<kind>.py``;
* ``makers/<maker>.py``, ``reference/<reference>.py``: inputs and the plain reference;
* ``metrics/<per-layer metric>.py``: a reader with ``read(obs) -> float | None``;
* ``limits/<cell>.json``: the limit of each number ``correct`` compares.

A later cell or metric is added by adding files and entries; no file here
lists them.
"""
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _check_name(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def cell(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    for entry in spec["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    """The configuration's file, with its name."""
    for entry in spec["configs"]:
        if entry["name"] == name:
            out = load_json(ROOT / entry["file"])
            out["name"] = name
            return out
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict[str, Any]:
    out = load_json(HERE / "traffic" / f"{_check_name(name)}.json")
    out["name"] = name
    return out


def limits(workload: str) -> Dict[str, float]:
    return load_json(HERE / "limits" / f"{_check_name(workload)}.json")["limits"]


def plugin(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots and dashes)."""
    path = HERE / kind / f"{_check_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    mod_name = "portbench_" + kind + "_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end(spec: Dict[str, Any], workload: str) -> List[Dict[str, Any]]:
    return [m for m in spec["end_to_end"] if _applies(m, workload)]


def per_layer(spec: Dict[str, Any], workload: str) -> List[Dict[str, Any]]:
    """The per-layer metrics this cell reports: those that list it, or list
    no cells and move an end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(spec, workload)}
    out = []
    for m in spec["per_layer"]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif m["moves"] in reported:
            out.append(m)
    return out


def read_metric(name: str, obs: Dict[str, Any]) -> Optional[float]:
    return plugin("metrics", name).read(obs)
