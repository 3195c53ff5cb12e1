"""Find a cell's configuration, traffic mix and metric readers by name.

BENCHMARK.json names them; each lives in a file of its own under port_bench/:
the configuration at the path its entry gives, the traffic mix at
``traffic/<traffic>.json``, and every metric's reader at
``metrics/<metric name>.py`` (a module with ``read(ctx)``, returning a
number or None where the run has nothing for it to read). A cell, a mix or
a metric is added with new files and entries only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = "port_bench"  # under the checkout's root


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # metric entries of BENCHMARK.json
    per_layer: list
    readers: dict  # metric name -> its reader's path


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, name: str, root: Path) -> Cell:
    """The cell ``name`` of ``bench`` with its files read; raises KeyError
    or FileNotFoundError where one is missing."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / BENCH_DIR / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    readers = {m["name"]: reader_path(m["name"], root) for m in e2e + per_layer}  # all found before the run
    return Cell(name=name, chips=int(cell["chips"]), config=config, traffic=traffic, end_to_end=e2e,
                per_layer=per_layer, readers=readers)


def reader_path(metric: str, root: Path) -> Path:
    path = root / BENCH_DIR / "metrics" / f"{metric}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    return path


def read_metric(path: Path, ctx) -> float | None:
    """Load the reader at ``path`` and read its metric from the run's ``ctx``."""
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)
