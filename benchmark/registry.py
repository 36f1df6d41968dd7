"""Finds the benchmark's parts by the names ``BENCHMARK.json`` gives them.

* a configuration ``<name>``: ``benchmark/configs/<name>.json``; its
  ``family`` names ``benchmark/counts/<family>.py`` (shapes, bytes and
  operations), ``benchmark/reference/<family>.py`` (the plain reference) and
  ``benchmark/systems/<family>.py`` (how the port is built and driven);
* a traffic mix ``<name>``: ``benchmark/traffic/<name>.json``;
* a metric ``<name>``: ``benchmark/metrics/<name>.py``, with ``UNIT`` and
  ``read(run)``, or for ``<quantity>.<part>`` without a file of its own
  ``benchmark/metrics/<quantity>.py``;
* a cell's limits of ``correct``: ``benchmark/limits/<workload>.json``.

A new configuration, mix or metric is a new file and a new entry in
``BENCHMARK.json``; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(*parts: str) -> dict:
    path = os.path.join(HERE, *parts)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no such benchmark file: {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(name: str, bench: dict = None) -> dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json("configs", _checked(name) + ".json")


def traffic(name: str) -> dict:
    return _json("traffic", _checked(name) + ".json")


def limits(workload_name: str) -> dict:
    return _json("limits", _checked(workload_name) + ".json")


def _module(kind: str, name: str):
    path = os.path.join(HERE, kind, _checked(name) + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no such benchmark file: {os.path.relpath(path, ROOT)}")
    mod_name = f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric(name: str):
    """The reader of metric ``name``: a module with ``UNIT`` and ``read(run)``.
    A name ``<quantity>.<part>`` with no file of its own is read by
    ``metrics/<quantity>.py``: one reader for a quantity split by the cells
    (and so the end-to-end metric) it moves."""
    try:
        return _module("metrics", name)
    except FileNotFoundError:
        if "." not in name:
            raise
        return _module("metrics", name.split(".")[0])


def counts(family: str):
    return _module("counts", family)


def reference(family: str):
    return _module("reference", family)


def system(family: str):
    return _module("systems", family)


def metrics_of(cell: str, bench: dict, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    (``trace`` 0) or the per-layer ones (``trace`` 1).  An entry with a
    ``workloads`` key applies to the cells it lists; a per-layer entry
    without one applies where the end-to-end metric it moves is reported."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if ((cell in m["workloads"]) if "workloads" in m else (m["moves"] in names))]
