"""A cell's files, found by the names in ``BENCHMARK.json``: the cell's
entry, its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) and the per-layer metrics that it reports."""

from __future__ import annotations

import json
import os.path as osp

HERE = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(HERE)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """{"cell", "config", "traffic", "end_to_end", "per_layer"} of the cell
    ``name``: its metrics are those of ``BENCHMARK.json`` that list it under
    ``workloads`` or list no ``workloads``."""
    bench = read_json(osp.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]

    def mine(m):
        return name in m.get("workloads", [name])

    return {"cell": cell, "run_seconds": bench["run_seconds"],
            "config": read_json(osp.join(HERE, "configs", cell["config"] + ".json")),
            "traffic": read_json(osp.join(HERE, "traffic", cell["traffic"] + ".json")),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def hocon_text(tree: dict, indent: int = 0) -> str:
    """A JSON object as the HOCON text that the port's and the copy's
    ``ConfigFactory.parse_string`` read (no root braces)."""
    pad = "  " * indent
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.append(f"{pad}{k} {{\n{hocon_text(v, indent + 1)}{pad}}}\n")
        else:
            out.append(f"{pad}{k} = {_value(v)}\n")
    return "".join(out)


def _value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, list):
        return "[ " + " ".join(_value(x) for x in v) + " ]"
    return json.dumps(str(v))
