"""Finds what a cell names, by name: ``BENCHMARK.json`` at the root of the
checkout, a configuration's files under ``configs/``, a traffic mix under
``traffic/`` (with its path and scene kinds under ``path_kinds/`` and
``scene_kinds/``), a cell's limits under ``limits/`` and a per-layer
metric's reader under ``metrics/``. Adding a configuration, a traffic mix, a cell
or a metric is adding files and entries; no file here changes."""
from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Catalog:
    def __init__(self, benchmark_path=None, base=HERE):
        self.base = base
        path = benchmark_path or os.path.join(ROOT, "BENCHMARK.json")
        self.benchmark_path = path
        with open(path) as f:
            self.benchmark = json.load(f)

    def _file(self, *parts):
        return os.path.join(self.base, *parts)

    def workload(self, name) -> dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name) -> dict:
        """The configuration's JSON, with ``settings_path`` resolved."""
        with open(self._file("configs", f"{name}.json")) as f:
            cfg = json.load(f)
        cfg["settings_path"] = self._file("configs", cfg["settings"])
        return cfg

    def traffic(self, name) -> dict:
        with open(self._file("traffic", f"{name}.json")) as f:
            return json.load(f)

    def limits(self, cell) -> dict:
        with open(self._file("limits", f"{cell}.json")) as f:
            return json.load(f)

    def metrics(self, cell, section):
        """The entries of `section` ("end_to_end" or "per_layer") that the
        cell reports: those without a ``workloads`` key and those that
        list it."""
        return [m for m in self.benchmark[section]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric):
        """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
        return load("metrics", metric, self.base).read


_LOADED: dict = {}


def load(group, name, base=HERE):
    """The module in the file ``<base>/<group>/<name>.py``, loaded once:
    a per-layer metric's reader, a camera path kind or a scene kind."""
    path = os.path.join(base, group, f"{name}.py")
    if path not in _LOADED:
        if not os.path.exists(path):
            raise KeyError(f"no {group} file {name}.py under {base}")
        spec = importlib.util.spec_from_file_location(
            f"slambench_{group}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
