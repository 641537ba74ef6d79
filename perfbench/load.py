"""Finding a cell's parts by name: ``BENCHMARK.json`` names the cell, the
cell names its configuration and traffic, and each lives in a file of its
own (``configs/<name>.json``, ``traffic/<name>.json``); each per-layer
metric is a reader in ``metrics/<name>.py``. Adding a cell, a
configuration, a traffic mix or a metric adds files and entries and edits
none."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


# Every setting a traffic file may hold; the harness reads each of them.
TRAFFIC_KEYS = {"clients", "batch", "k", "predicate_widths", "query_pool",
                "eval_range", "eval_batches", "threads", "notes"}


def traffic(name: str, here: Path = HERE) -> dict:
    """A traffic mix; a setting the harness would not read is refused, so
    that no file asks for what the run silently leaves out."""
    tr = json.loads((Path(here) / "traffic" / f"{name}.json").read_text())
    unknown = sorted(set(tr) - TRAFFIC_KEYS)
    if unknown:
        raise ValueError(f"traffic {name!r}: no setting {unknown} in this "
                         f"harness (it reads {sorted(TRAFFIC_KEYS)})")
    return tr


def end_to_end(bench: dict, cell: str):
    """The end-to-end metrics a cell reports (those without a
    ``workloads`` key, and those that list it)."""
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str, here: Path = HERE
              ) -> Dict[str, Callable]:
    """The per-layer readers a cell runs: name → ``read(records)``.

    A metric without ``workloads`` runs in every cell that reports the
    end-to-end metric it moves.
    """
    moved = {m["name"] for m in end_to_end(bench, cell)}
    out = {}
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if (cell in cells) if cells is not None else m["moves"] in moved:
            out[m["name"]] = reader(m["name"], here)
    return out


def reader(name: str, here: Path = HERE) -> Callable:
    path = Path(here) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
