"""Everything the benchmark runs, found by name: ``BENCHMARK.json`` at
the checkout's root names the cells and metrics; a cell's configuration
is ``configs/<config>.json``, its traffic mix ``traffic/<traffic>.json``,
the mix's driver ``drivers/<driver>.py`` and each metric's reader
``metrics/<metric>.py``.  A new cell, mix, configuration or metric is a
new file and a new entry, never an edit."""
from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent.parent      # portbench/
ROOT = HERE.parent                                          # the checkout


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str, base: pathlib.Path = HERE) -> dict:
    return load_json(base / "configs" / f"{name}.json")


def traffic(name: str, base: pathlib.Path = HERE) -> dict:
    return load_json(base / "traffic" / f"{name}.json")


def _module(path: pathlib.Path, label: str):
    if not path.is_file():
        raise FileNotFoundError(f"{label}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{label}_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, base: pathlib.Path = HERE):
    return _module(base / "drivers" / f"{name}.py", "driver")


def metric(name: str, base: pathlib.Path = HERE):
    return _module(base / "metrics" / f"{name}.py", "metric")


def metrics_for(bench: dict, cell_name: str, traced: bool) -> list:
    """The metric entries a run of ``cell_name`` reports: with ``traced``
    the per-layer ones, else the end-to-end ones.  An end-to-end metric
    with a ``workloads`` key belongs to the cells it lists; a per-layer
    metric without one to every cell that reports the end-to-end metric
    it ``moves``."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]
