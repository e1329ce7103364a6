"""What ``BENCHMARK.json`` says of one cell, and the files it names.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name the manifest gives:

- ``configs/<config>.json`` (the ``file`` of its ``configs`` entry): the
  deployment: its scene (``scenes/<kind>.py`` and its sizes), dtype,
  gauge, the solver adapter of each traffic kind and the control's;
- ``traffic/<traffic>.json``: the mix: its kind (``kinds/<kind>.py``),
  starts, iterations, accuracy gate, traced and checked
  amounts;
- ``solvers/<solver>.py``: the adapter that drives the program's solver
  (or, for the control, the reference in its place);
- ``layers/<metric>.py``: a per-layer metric's reader; a metric named
  ``<quantity>.<part>`` without a file of its own reads with
  ``layers/<quantity>.py``;
- ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct`` in that cell.

An end-to-end metric ``<quantity>.<part>`` takes the value of the
quantity that the traffic kind's loop measures: a quantity split by cell,
so that each part has a bound of its own.
"""

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]      # the benchmark's folder
ROOT = HERE.parent                              # the checkout


def load_manifest(root=ROOT):
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _for_cell(metric, workload, e2e_names):
    cells = metric.get("workloads")
    if cells is not None:
        return workload in cells
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def stem(metric):
    """The quantity a metric's name measures: the part before the first
    dot."""
    return metric.split(".", 1)[0]


def load_reader(metric, here=HERE):
    """The reader module of a per-layer metric, by its name: its own file,
    else its quantity's."""
    path = here / "layers" / f"{metric}.py"
    if not path.is_file():
        path = here / "layers" / f"{stem(metric)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for per-layer metric {metric!r}: "
                                f"{path}")
    name = f"benchmark.layers.{metric}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest, with its files loaded."""

    def __init__(self, workload, root=ROOT, here=HERE):
        m = load_manifest(root)
        cells = {w["name"]: w for w in m["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        self.name = workload
        self.chips = int(self.workload["chips"])
        cfg = {c["name"]: c for c in m["configs"]}[self.workload["config"]]
        self.config = _read_json(root / cfg["file"])
        self.traffic = _read_json(
            here / "traffic" / f"{self.workload['traffic']}.json")
        self.kind_name = self.traffic["kind"]
        self.kind = importlib.import_module(
            f"benchmark.kinds.{self.kind_name}")
        self.solver_name = self.config["solvers"][self.kind_name]
        self.e2e = [e for e in m["end_to_end"]
                    if _for_cell(e, workload, None)]
        e2e_names = {e["name"] for e in self.e2e}
        self.per_layer = [p for p in m["per_layer"]
                          if _for_cell(p, workload, e2e_names)]
        limits = here / "limits" / f"{workload}.json"
        self.limits = _read_json(limits) if limits.is_file() else {}

    def adapter(self, control=False):
        """The solver adapter of this cell's traffic kind, or the
        configuration's control."""
        name = self.config["control"] if control else self.solver_name
        return importlib.import_module(f"benchmark.solvers.{name}")

    def readers(self):
        return {p["name"]: load_reader(p["name"]) for p in self.per_layer}
