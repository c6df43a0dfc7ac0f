"""Finding a cell's parts by name.

BENCHMARK.json, at the root of the checkout, names every part; each part
is a file of its own:

  a configuration  the `file` its entry names (configs/<name>.json)
  a traffic mix    workloads/<traffic>.json
  a metric         metrics/<name>.py: MOVES (the end-to-end metric it
                   moves; None for an end-to-end metric) and
                   read(run) -> float or None

So a later cell, configuration or metric is new files and new entries,
and no edit of what is here.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, as run
    traffic: dict         # the traffic file
    end_to_end: list      # BENCHMARK.json metric entries that this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "workloads" / f"{entry['traffic']}.json").read_text())
    return Cell(
        name=name, chips=int(entry["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def reader(metric: str):
    """The module of metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise KeyError(f"no reader {path.relative_to(ROOT)} for metric {metric!r}")
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
