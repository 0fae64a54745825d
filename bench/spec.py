"""What a cell is, read from data: ``BENCHMARK.json`` at the root names
each cell's configuration and traffic, and the files under ``bench/`` hold
them, each found by its name.

  bench/configs/<config>.json     the configuration: published keys
                                  (``config``), the program's settings
                                  (``port``), the kernels it builds, and
                                  the family of its reference
  bench/traffic/<traffic>.json    the traffic mix: prompt and output
                                  lengths, the closed loop, how many
                                  served requests the check samples
  bench/workloads/<cell>.json     the cell: its SLO in ms, the controller
                                  and its knobs, the steps it traces
  bench/metrics/<metric>.py       one per-layer metric: ``read(ctx)``;
                                  a metric split by the end-to-end
                                  metric it moves, ``<quantity>.<group>``,
                                  is read by ``<quantity>.py``
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict           # the cell's entry in BENCHMARK.json
    conf: dict            # bench/configs/<config>.json
    traffic: dict         # bench/traffic/<traffic>.json
    knobs: dict           # bench/workloads/<cell>.json
    end_to_end: list      # the end-to-end metrics this cell reports
    per_layer: list       # the per-layer metrics this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict = None) -> Cell:
    bench = bench or benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = _json(ROOT / configs[entry["config"]]["file"])
    return Cell(name, entry, conf,
                _json(BENCH / "traffic" / f"{entry['traffic']}.json"),
                _json(BENCH / "workloads" / f"{name}.json"),
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def quantity(name: str, known) -> str:
    """What a metric measures: its name, or for a metric split by the
    end-to-end metric its cells report, ``<quantity>.<group>``
    (``goodput_rps.gen``, ``engine.p95_ms.score``), the part before the
    group."""
    return name if name in known else name.rsplit(".", 1)[0]


def metric_reader(name: str):
    """The ``read(ctx)`` of ``bench/metrics/<name>.py``, or of its
    quantity's file."""
    files = {p.stem for p in (BENCH / "metrics").glob("*.py")}
    stem = quantity(name, files)
    path = BENCH / "metrics" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
