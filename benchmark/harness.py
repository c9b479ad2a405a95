"""Discovery and the result line.

Everything is found by file name under ``benchmark/``:

  * a cell: ``workloads/<cell>.json`` names its configuration, its traffic
    mix, its chips and the limits of its correctness checks;
  * a configuration: ``configs/<config>.json``;
  * a traffic mix: ``traffic/<traffic>.json``, whose ``driver`` names the
    module under ``drivers/`` that runs it;
  * a per-layer metric: ``metrics/<metric>.py``, whose ``read(run)``
    returns the metric's value from a traced run's record, or None where
    the run holds nothing for it (the metric is then left out).

Adding a cell, a configuration, a mix or a metric is adding a file.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
# the top-level modules no run may hold once its window has closed: JAX,
# flax and the JAX package the program was ported from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tee_optical_flow_tpu")


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        known = sorted(p.stem for p in (HERE / kind).glob("*.json"))
        raise KeyError(f"no {kind[:-1]} {name!r} under {HERE / kind} "
                       f"(known: {known})")
    with open(path) as f:
        return json.load(f)


def names(kind: str) -> List[str]:
    """The names of every file of one kind (configs, traffic, workloads,
    metrics)."""
    suffix = ".py" if kind == "metrics" else ".json"
    return sorted(p.name[:-len(suffix)]
                  for p in (HERE / kind).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def load_cell(name: str) -> dict:
    """The cell's file, with its configuration and traffic mix beside it
    under ``config_data`` and ``traffic_data``."""
    cell = dict(load_json("workloads", name), name=name)
    cell["config_data"] = load_json("configs", cell["config"])
    cell["traffic_data"] = load_json("traffic", cell["traffic"])
    return cell


def driver(cell: dict):
    return importlib.import_module(
        f"benchmark.drivers.{cell['traffic_data']['driver']}")


def metric_readers() -> Dict[str, Callable[[dict], Optional[float]]]:
    """{metric name: its module} for every file under metrics/. The file
    name is the metric's name, dots included, so it is loaded by path."""
    readers = {}
    for name in names("metrics"):
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}",
            HERE / "metrics" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        readers[name] = module
    return readers


def per_layer_metrics(run: dict) -> Dict[str, dict]:
    out = {}
    for name, module in metric_readers().items():
        value = module.read(run)
        if value is not None:
            out[name] = {"value": float(value), "unit": module.UNIT}
    return out


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``sys.modules``, each compared
    whole (``tee_optical_flow_torch`` is not ``tee_optical_flow_tpu``)."""
    tops = {name.split(".")[0] for name in (modules or list(sys.modules))}
    return sorted(tops & set(FORBIDDEN_MODULES))


def result_line(run: dict, trace: bool) -> dict:
    """The last line of a run: correct, attempted, failed, metrics, device
    (and breakdown with a trace), then the compared numbers and their
    limits under ``checks``, last."""
    checks = run["checks"]
    correct = (run["failed"] == 0 and run["attempted"] > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    if trace:
        metrics = per_layer_metrics(run)
    else:
        metrics = {name: {"value": float(v), "unit": unit}
                   for name, (v, unit) in run["end_to_end"].items()}
    line = {"correct": bool(correct), "attempted": int(run["attempted"]),
            "failed": int(run["failed"]), "metrics": metrics,
            "device": dict(run["device"])}
    if trace:
        line["device"]["busy_s"] = run["trace"]["busy_s"]
        line["device"]["window_s"] = run["trace"]["window_s"]
        line["breakdown"] = run["trace"]["breakdown"]
    line["checks"] = {name: {"value": c["value"], "limit": c["limit"]}
                      for name, c in checks.items()}
    return line


def check(value: float, limit: float) -> dict:
    return {"value": float(value), "limit": float(limit)}
