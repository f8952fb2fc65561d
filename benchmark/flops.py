"""The model FLOPs of one training step, worked out from the cell's shapes
and the configuration's widths alone: the GEMMs of each MLP per point and
pass, over the points each part of ``train_step`` sends through it. A
change to how the port does the work (fusion, another precision, padding)
leaves the count as it is; K1–K3 add none (``kernel_work.py``). The
remesh is left out: how many points its seg3d pyramid evaluates depends
on the surface.

Per point, F is one network's forward GEMM FLOPs (2 Σ in·out). A pass
costs, in units of F:

- forward only: 1; forward and backward to the inputs: 2; forward and
  backward to the inputs and the weights: 3;
- the input gradient with ``create_graph`` and a loss on it, backward to
  the weights (the eikonal term, ③'s normals): 6 (forward, the first
  backward, and two GEMMs for each of the two graphs' layers);
- the 3×3 deformer Jacobian with ``create_graph`` and a loss on it: 12
  (forward, three first backwards, two GEMMs for each of the three
  gradient graphs and two for the forward graph).

Points, per garment g with R_g = ⌊sample_pix / G⌋ · N rays, V_g live
vertices (the remesh's, which ``check.py`` holds to the reference's), c_g
curves of S points, and B_g = R_g + surface_sample:

- ①: the translator on N·c_g·S curve points (2), the garment SDF on the
  c_g·S canonical curve points (2);
- ②: the translator on N·V_g vertices (3);
- the solve: solver_times + 1 evaluations of the garment SDF and the
  translator on R_g rays (2 each);
- ③: the pc-sdf on V_g vertices (3), the curve-aware term's draws (3),
  the eikonal on B_g + ⌊B_g / 6⌋ points (6), the offset rigidity on 2·B_g
  points (translator, 12), and on the R_g rays the implicit adjoint (SDF 4,
  translator 6: one forward with four input backwards, then backward to
  the weights), the features (SDF 3), the normals (SDF 6), the Jacobian
  (translator 12) and the render net (3).
"""

from __future__ import annotations

from .weights import layers


def forward_flops(config: dict) -> dict:
    """{"sdf", "translator", "render"}: forward GEMM FLOPs per point."""
    out = {"sdf": 0, "translator": 0, "render": 0}
    for name, _, d_in, d_out, _ in layers(config):
        net = name.split(".")[0]
        if net == "sdf":
            out["sdf"] += 2 * d_in * d_out
        elif net in out:
            out[net] += 2 * d_in * d_out
    return out


def step_flops(config: dict, traffic: dict, live_verts: list) -> float:
    """Model FLOPs of one step without a remesh; ``live_verts`` per garment."""
    f = forward_flops(config)
    S, T, Rn = f["sdf"], f["translator"], f["render"]
    N = traffic["batch"]
    G = len(config["garments"])
    caps = traffic.get("caps", {})
    solver = caps.get("solver_times", config["solver_times"])
    sample = caps.get("surface_sample", config["surface_sample"])
    total = 0
    for gi, g in enumerate(config["garments"]):
        R = max(traffic["sample_pix"] // G, 1) * N
        V = live_verts[gi]
        cs = len(config["garment_curves"][g]) * config["curve_points"]
        B = R + sample
        total += T * 2 * N * cs + S * 2 * cs                          # ①
        total += T * 3 * N * V                                         # ②
        total += (solver + 1) * R * 2 * (S + T)                        # the solve
        ca = config["curve_aware_points"] if gi == G - 1 else 0
        total += S * (3 * V + 3 * ca + 6 * (B + B // 6) + R * (4 + 3 + 6))   # ③ SDF
        total += T * (12 * 2 * B + R * (6 + 12)) + Rn * 3 * R         # ③ translator, render
    return float(total)
