"""Cells, configurations, traffic mixes, loop kinds and metrics, found
by name.

`BENCHMARK.json` at the root of the checkout names them; everything that
belongs to one of them sits in a file of its own under `kmerbench/`:

- a configuration: the `file` its entry names (`configs/<name>.json`);
- a traffic mix: `traffic/<mix>.json`, parameters read by the general
  generator (`generate`) and by its loop kind;
- a loop kind: `loops/<kind>.py`, named by the mix's `"loop"`, whose
  `Loop` class drives the program (`loop`);
- a per-layer metric: `metrics/<name>.py`, whose `read(view)` the harness
  calls on the traced window, and whose `GROUPS`, where it has them, name
  the device kernels it reads (`kernels`).

So a cell, a configuration, a mix, a loop kind or a metric is added by
adding files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent  # the checkout
PACKAGE = "kmerbench"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list  # the metric entries this cell reports
    per_layer: list


def load(base: Path = ROOT) -> dict:
    return json.loads((Path(base) / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, base: Path = ROOT) -> Cell:
    base = Path(base)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((base / configs[w["config"]]["file"]).read_text())
    mix = json.loads(
        (base / PACKAGE / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=w["chips"], config=config, mix=mix,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def module(folder: str, name: str, base: Path = ROOT):
    """The module of `<folder>/<name>.py`, loaded from its file."""
    path = Path(base) / PACKAGE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder} file {path}")
    mod_spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def names(folder: str, base: Path = ROOT) -> list:
    """The names of the files `<folder>/<name>.py`."""
    return sorted(p.stem for p in (Path(base) / PACKAGE / folder).glob("*.py")
                  if not p.stem.startswith("_"))


def reader(metric: str, base: Path = ROOT):
    """The `read` function of `metrics/<metric>.py`."""
    return module("metrics", metric, base).read


def loop(kind: str, base: Path = ROOT):
    """The `Loop` class of `loops/<kind>.py`."""
    return module("loops", kind, base).Loop
