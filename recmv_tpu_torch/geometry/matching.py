"""Copy of ``recmv_tpu/geometry/matching.py``, kept byte-for-byte apart from this note and
its imports: the port runs where JAX is absent, and importing any
``recmv_tpu`` module imports JAX.

Boundary↔curve correspondence via optimal assignment.

Parity with the reference's OT best-match
(``engineer/utils/garment_structure.py:569-726``: ``best_match`` /
``single_best_match``): the template's labeled boundary loop and the
target feature curve are put in one-to-one correspondence by solving the
assignment problem on their pairwise distance matrix (the reference uses
``ot.dist`` + POT's Hungarian ``linear_assignment``; we use scipy's
Jonker-Volgenant), after resampling the target to the source count;
pairs whose radial directions around the loop centroids disagree
(cos ≤ 0.5) are dropped. This replaces r1's centroid-nearest matching,
which could cross-wire correspondences on elongated loops.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def resample_to_count(pts: np.ndarray, n: int) -> np.ndarray:
    """Index-subsample a target loop to ~n points (reference
    garment_structure.py:584-590 stride trick)."""
    m = len(pts)
    if m <= n:
        return pts
    idx = np.arange(0, m, (m - 1) / n).astype(np.int64)[:n]
    return pts[idx]


def boundary_curve_best_match(source_pts: np.ndarray, target_pts: np.ndarray,
                              similarity_gate: float = 0.5):
    """One-to-one match of a boundary loop onto a target curve.

    source_pts (S,3), target_pts (T,3). Returns (source_sel (M,) indices
    into source_pts, matched_targets (M,3)) with M ≤ S after the
    direction-similarity gate.
    """
    src = np.asarray(source_pts, np.float64)
    tgt = resample_to_count(np.asarray(target_pts, np.float64), len(src))

    d2 = np.sum((src[:, None] - tgt[None]) ** 2, -1)
    # rectangular assignment: every row (or column, whichever smaller)
    # gets exactly one partner
    si, ti = linear_sum_assignment(d2)

    # gate by radial-direction agreement around the two centroids
    sn = src[si] - src.mean(0)
    tn = tgt[ti] - tgt.mean(0)
    cos = np.sum(sn * tn, -1) / (
        np.linalg.norm(sn, axis=-1) * np.linalg.norm(tn, axis=-1) + 1e-12)
    keep = cos > similarity_gate
    if not keep.any():      # degenerate loop: fall back to ungated
        keep = np.ones_like(keep)
    return si[keep], tgt[ti[keep]].astype(np.float32)


def match_template_boundaries(verts: np.ndarray, boundary_labels: dict,
                              curves_by_name: dict,
                              similarity_gate: float = 0.5,
                              outlier_gate: float = 3.0):
    """Best-match every labeled boundary loop to its curve. Returns
    (constraint_vertex_ids (M,), constraint_targets (M,3)) ready for the
    Laplacian editing solve.

    Per loop, handles whose displacement is an extreme outlier
    (> ``outlier_gate`` × the loop's median, and > 5 cm) are dropped:
    a handful of cross-wired correspondences on a distorted loop act as
    point torques on the Laplacian solve and fling interior vertices far
    outside both surfaces (the r3 rim-spill failure). The gate is
    relative, so a genuinely large rigid offset (all handles move far
    together) passes untouched."""
    cids, targets = [], []
    for cname, loop in boundary_labels.items():
        if cname not in curves_by_name:
            continue
        loop = np.asarray(loop)
        sel, tgt = boundary_curve_best_match(
            verts[loop], np.asarray(curves_by_name[cname]), similarity_gate)
        dn = np.linalg.norm(tgt - verts[loop[sel]], axis=1)
        keep = dn <= max(outlier_gate * float(np.median(dn)), 0.05)
        cids.append(loop[sel][keep])
        targets.append(tgt[keep])
    if not cids:
        return np.zeros((0,), np.int64), np.zeros((0, 3), np.float32)
    return np.concatenate(cids), np.concatenate(targets)
