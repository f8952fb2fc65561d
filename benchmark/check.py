"""The comparison that decides ``correct``: the readings of the port's
first training steps (``drive.check_steps``) against the reference's on
the same scene, weights, frames and draws.

Each number compared is a gap between the two sides:

- ``first_loss_gap``: the largest relative gap of the first step's ①
  curve loss, ② mask loss and ③ main loss;
- ``later_loss_gap``: the same over the later steps;
- ``ray_gap``: over the steps and garments, the largest gap of the rays
  that the surface solve converged, over the reference's ray budget;
- ``grad_gap``: over the leaves, the largest gap between the norms of the
  first gradient, against the reference's norm of that leaf or of the
  median leaf, whichever is larger;
- ``change_gap``: the same for the change of each leaf over the steps,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's (the others move under Adam by round-off alone);
- ``mesh_gap``: the largest difference of the remeshed garments' vertex
  and face counts (exact).

Each cell's limits are in ``limits/<cell>.json``, with the readings they
were set from: the port over a dozen seeds (the lower) and the
reference computed with TF32 on, or a fault, in the port's place (the
upper). A number that a cell does not compare is listed there under
``not_compared`` with its readings and the reason (PERF.md); it is
still read and printed.
"""

from __future__ import annotations

import json
import math
import os.path as osp
import statistics

HERE = osp.dirname(osp.abspath(__file__))

NUMBERS = ("first_loss_gap", "later_loss_gap", "ray_gap", "grad_gap", "change_gap", "mesh_gap")
MOVED = 1e-3          # a leaf moves by its gradient when that is ≥ MOVED × the median leaf's


def _rel(a: float, b: float, base: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / base if base > 0 else (0.0 if a == b else math.inf)


def _leaf_gap(prog: dict, ref: dict, keys) -> float:
    keys = list(keys)
    if set(prog) != set(ref) or not keys:
        return math.inf
    med = statistics.median(ref[k] for k in keys)
    return max(_rel(prog[k], ref[k], max(ref[k], med)) for k in keys)


def _loss_gap(p: dict, r: dict) -> float:
    return max(_rel(p[k], r[k], abs(r[k])) for k in p if not k.endswith(("_rayConv",
                                                                          "_rayBudget")))


def _ray_gap(p: dict, r: dict) -> float:
    return max(_rel(p[k], r[k], r[k.replace("Conv", "Budget")]) for k in p
               if k.endswith("_rayConv"))


def readings(prog: dict, ref: dict) -> dict:
    """{number: value} of the comparison of two ``check_steps`` records."""
    if (len(prog["steps"]) != len(ref["steps"])
            or any(set(p) != set(r) for p, r in zip(prog["steps"], ref["steps"]))
            or set(prog["grad1"]) != set(ref["grad1"])):
        return dict.fromkeys(NUMBERS, math.inf)
    pairs = list(zip(prog["steps"], ref["steps"]))
    g_ref = ref["grad1"]
    med = statistics.median(g_ref.values())
    moved = [k for k, v in g_ref.items() if v >= MOVED * med]
    mesh = max(abs(a - b) for key in ("verts", "faces")
               for a, b in zip(prog["mesh"][key], ref["mesh"][key]))
    return {"first_loss_gap": _loss_gap(*pairs[0]),
            "later_loss_gap": max(_loss_gap(p, r) for p, r in pairs[1:]),
            "ray_gap": max(_ray_gap(p, r) for p, r in pairs),
            "grad_gap": _leaf_gap(prog["grad1"], g_ref, g_ref),
            "change_gap": _leaf_gap(prog["change"], ref["change"], moved),
            "mesh_gap": float(mesh)}


def load_limits(cell: str) -> dict:
    """{number: limit} of a cell (``limits/<cell>.json``): every number but
    those the file lists under ``not_compared``."""
    with open(osp.join(HERE, "limits", cell + ".json")) as f:
        d = json.load(f)
    lim, left = d["limits"], set(d.get("not_compared", {}))
    if set(lim) | left != set(NUMBERS) or set(lim) & left:
        raise ValueError(f"limits/{cell}.json: limits {sorted(lim)} and not compared "
                         f"{sorted(left)}, want each of {list(NUMBERS)} in one of them")
    return lim


def detail(prog: dict, ref: dict) -> dict:
    """What the widest gaps are made of, for the calibration's records: each
    step's relative gap of each loss and converged-ray count, and the three
    leaves with the widest first-gradient and change gaps."""
    steps = [{k: _rel(p[k], r[k], r[k.replace("Conv", "Budget")] if k.endswith("_rayConv")
                      else abs(r[k])) for k in p if not k.endswith("_rayBudget")}
             for p, r in zip(prog["steps"], ref["steps"])]
    out = {"steps": steps}
    for key in ("grad1", "change"):
        r = ref[key]
        med = statistics.median(r.values())
        gaps = {k: _rel(prog[key][k], r[k], max(r[k], med)) for k in r if k in prog[key]}
        out[key] = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    return out


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, [{"name", "value", "limit"}]): correct when every number is
    within its limit."""
    rows = [{"name": k, "value": values[k], "limit": limits[k]} for k in limits]
    return all(r["value"] <= r["limit"] for r in rows), rows
