"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` resolves to

* ``portbench/configs/<config>.json``: the configuration as it is run (the
  manifest's ``file``), and ``portbench/configs/<config>.py``: the family's
  residuals and draws for the program;
* ``portbench/reference/<config>.py``: its plain float64 reference;
* ``portbench/traffic/<traffic>.json``: the mix's parameters, read by the
  one generator of ``common/mix.py``;
* ``portbench/entries/<entry>.py``: the call into the program that the mix
  names by its ``entry``;
* ``portbench/metrics/<quantity>.py``: the reader of a per-layer metric
  ``<quantity>`` or ``<quantity>.<split>`` (one quantity split by the
  end-to-end metric it moves, as ``device_idle_pct.sweep`` and
  ``device_idle_pct.solve``, has one reader).

Every per-layer entry lists the cells that report it (``workloads``).

A cell whose ``chips`` is above 1 runs as that many ranks, one per card
(``common/ranks.py``).

A later configuration, mix, entry or metric is a new file under its name
and a new entry in ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
from typing import Dict, List, Optional

__all__ = ["Manifest", "Cell", "load_module"]


def load_module(path: pathlib.Path, name: str):
    """The module in ``path``, loaded under ``name`` (file names may hold
    dots, so they are not imported by name)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the mix's parameters
    end_to_end: List[dict]  # the manifest's entries this cell reports
    per_layer: List[dict]
    root: pathlib.Path

    def family(self):
        """The configuration's module (``configs/<config>.py``)."""
        return load_module(self.root / "portbench" / "configs" / f"{self.config_name}.py",
                           f"portbench_config_{self.config_name}")

    def reference(self):
        """The configuration's plain reference (``reference/<config>.py``)."""
        return load_module(self.root / "portbench" / "reference" / f"{self.config_name}.py",
                           f"portbench_reference_{self.config_name}")

    def entry(self):
        """The module of the mix's entry (``entries/<entry>.py``)."""
        name = self.traffic["entry"]
        return load_module(self.root / "portbench" / "entries" / f"{name}.py", f"portbench_entry_{name}")

    def reader(self, metric: str):
        """The reader of one per-layer metric (``metrics/<quantity>.py``,
        the quantity being the metric's name before its first dot)."""
        quantity = metric.split(".", 1)[0]
        return load_module(self.root / "portbench" / "metrics" / f"{quantity}.py", f"portbench_metric_{quantity}")


class Manifest:
    def __init__(self, root: pathlib.Path):
        self.root = pathlib.Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)

    def workloads(self) -> List[str]:
        return [w["name"] for w in self.data["workloads"]]

    def _config_entry(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"configuration {name!r} is not in BENCHMARK.json")

    def cell(self, name: str) -> Cell:
        entry: Optional[Dict] = next((w for w in self.data["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"workload {name!r} is not in BENCHMARK.json (cells: {', '.join(self.workloads())})")
        conf = self._config_entry(entry["config"])
        with open(self.root / conf["file"]) as f:
            config = json.load(f)
        with open(self.root / "portbench" / "traffic" / f"{entry['traffic']}.json") as f:
            traffic = json.load(f)

        end_to_end = [m for m in self.data["end_to_end"] if name in m.get("workloads", [name])]
        for m in self.data["per_layer"]:
            if "workloads" not in m:
                raise ValueError(f"per-layer metric {m['name']!r} lists no workloads")
        per_layer = [m for m in self.data["per_layer"] if name in m["workloads"]]

        return Cell(
            name=name,
            config_name=entry["config"],
            traffic_name=entry["traffic"],
            chips=int(entry["chips"]),
            config=config,
            traffic=traffic,
            end_to_end=end_to_end,
            per_layer=per_layer,
            root=self.root,
        )
