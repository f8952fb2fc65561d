"""Laplacian-editing template deformation (counterpart of
``recmv_tpu/geometry/laplacian.py``): move selected source vertices onto
target positions while keeping the mesh's differential coordinates, by
weighted least squares over the stacked system [L; C] u = [L v; targets]
through its normal equations, then one optional neighbourhood-smoothing
step.

Up to ``DENSE_SOLVE_MAX_N`` vertices the normal equations are dense and
solved with ``torch.linalg.solve`` in float32 (TF32 off, the JAX code's
``Precision.HIGHEST``); above it a matrix-free Jacobi-preconditioned
conjugate gradient solves the same equations, with L and Lᵀ applied as
``index_add_`` over the edge list, stopping as ``jax.scipy.sparse.linalg.cg``
does (relative residual 1e-7, at most max(2000, 20·⌊√n⌋) iterations);
the stop test is computed on the device and read every 32 iterations.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

# Above this vertex count the (n, n) normal equations are not formed.
DENSE_SOLVE_MAX_N = 8192
# The CG's host reads its stop test once in this many iterations.
_CG_CHECK_EVERY = 32


def uniform_laplacian(faces: np.ndarray, num_verts: int) -> np.ndarray:
    """Dense uniform Laplacian (numpy): L_ij = 1/deg(i) for each neighbour
    j, L_ii = −1 where deg(i) > 0 (rows sum to zero)."""
    L = np.zeros((num_verts, num_verts), np.float32)
    faces = np.asarray(faces, np.int64)
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], 0)
    e = np.unique(np.sort(edges, axis=1), axis=0)
    adj = np.zeros((num_verts, num_verts), bool)
    adj[e[:, 0], e[:, 1]] = True
    adj[e[:, 1], e[:, 0]] = True
    deg = adj.sum(1)
    nz = deg > 0
    L[adj] = 1.0
    L[nz] = L[nz] / deg[nz, None]
    L[np.arange(num_verts), np.arange(num_verts)] = np.where(nz, -1.0, 0.0)
    return L


def _mesh_edges(faces, n):
    """Directed edge list (both ways) and vertex degrees (numpy)."""
    faces = np.asarray(faces, np.int64)
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], 0)
    e = np.unique(np.sort(edges, axis=1), axis=0)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    deg = np.bincount(src, minlength=n)
    return src, dst, deg.astype(np.float32)


def _segment_sum(x, ids, n):
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device).index_add_(0, ids, x)


def _laplacian_deform_cg(verts, faces, cid, tgt, constrain_weight, smooth, displacement):
    """(LᵀL + w·CᵀC + 1e-8 I) u = Lᵀ rhs_L + w·Cᵀ rhs_C, matrix-free."""
    dev = verts.device
    n = verts.shape[0]
    src, dst, deg = (torch.as_tensor(a, device=dev) for a in _mesh_edges(faces, n))
    has = (deg > 0).to(torch.float32)[:, None]
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0), 0.0)[:, None]

    def L_apply(x):      # (Lx)_i = mean_{j∈N(i)} x_j − x_i   (deg_i > 0)
        return _segment_sum(x[dst], src, n) * inv_deg - x * has

    def Lt_apply(y):     # (Lᵀy)_j = Σ_{i∈N(j)} y_i/deg_i − y_j·[deg_j > 0]
        return _segment_sum((y * inv_deg)[src], dst, n) - y * has

    w = float(constrain_weight)
    cdiag = _segment_sum(torch.full((cid.shape[0],), w, device=dev), cid, n)[:, None]

    def matvec(x):
        return Lt_apply(L_apply(x)) + cdiag * x + 1e-8 * x

    if displacement:
        atb = _segment_sum(w * (tgt - verts[cid]), cid, n)
    else:
        atb = Lt_apply(L_apply(verts)) + _segment_sum(w * tgt, cid, n)

    # Jacobi preconditioner: diag(LᵀL)_j = [deg_j > 0] + Σ_{i∈N(j)} deg_i⁻²
    d = has + _segment_sum((inv_deg * inv_deg)[src], dst, n) + cdiag + 1e-8
    x = torch.zeros_like(atb)
    r = atb - matvec(x)
    z = r / d
    p = z
    gamma = torch.sum(r * z)
    atol2 = (1e-7 ** 2) * torch.sum(atb * atb)
    for k in range(max(2000, 2 * int(np.sqrt(n)) * 10)):
        # the stop test stays on the device (an iteration past it changes
        # nothing); the host reads it every _CG_CHECK_EVERY iterations
        go = torch.sum(r * r) > atol2
        if k % _CG_CHECK_EVERY == 0 and not bool(go):
            break
        Ap = matvec(p)
        alpha = gamma / torch.sum(p * Ap)
        x = torch.where(go, x + alpha * p, x)
        r = torch.where(go, r - alpha * Ap, r)
        z = r / d
        gamma_new = torch.sum(r * z)
        p = torch.where(go, z + (gamma_new / gamma) * p, p)
        gamma = torch.where(go, gamma_new, gamma)

    if smooth:           # one off-diagonal neighbourhood-averaging step
        x = _segment_sum(x[dst], src, n) * inv_deg
    return verts + x if displacement else x


def laplacian_deform(verts, faces, constraint_ids, constraint_targets,
                     constrain_weight: float = 1.0, smooth: bool = True,
                     displacement: bool = False, device=None) -> torch.Tensor:
    """Solve the Laplacian editing system: verts (N, 3), constraint_ids
    (M,), constraint_targets (M, 3) → deformed vertices (N, 3), a float32
    tensor on ``device`` (that of ``verts`` when it is a tensor, else the
    CUDA card).

    ``displacement=True`` solves for a harmonic-smooth displacement field
    (min ‖L d‖² + w‖d_c − (targets − v_c)‖², u = v + d) instead of keeping
    the Laplacian coordinates; with ``smooth`` the displacement, not the
    positions, is averaged."""
    if device is None:
        device = verts.device if torch.is_tensor(verts) else resolve_device()
    verts = torch.as_tensor(np.asarray(verts.cpu() if torch.is_tensor(verts) else verts,
                                       np.float32), device=device)
    n = verts.shape[0]
    tgt = torch.as_tensor(np.asarray(constraint_targets, np.float32), device=device)
    cid = torch.as_tensor(np.asarray(constraint_ids, np.int64), device=device)
    if n > DENSE_SOLVE_MAX_N:
        return _laplacian_deform_cg(verts, faces, cid, tgt, constrain_weight, smooth,
                                    displacement)
    L = torch.as_tensor(uniform_laplacian(np.asarray(faces), n), device=device)
    m = cid.shape[0]
    C = torch.zeros(m, n, device=device)
    C[torch.arange(m, device=device), cid] = 1.0
    A = torch.cat([L, C], 0)
    if displacement:
        rhs = torch.cat([torch.zeros(n, 3, device=device), tgt - verts[cid]], 0)
    else:
        rhs = torch.cat([L @ verts, tgt], 0)
    w = torch.cat([torch.ones(n, device=device),
                   torch.full((m,), float(constrain_weight), device=device)])
    AtA = A.T @ (A * w[:, None])
    Atb = A.T @ (rhs * w[:, None])
    sol = torch.linalg.solve(AtA + 1e-8 * torch.eye(n, device=device), Atb)
    Ls = L.clone()
    Ls.fill_diagonal_(0.0)
    if smooth:
        sol = Ls @ sol
    return verts + sol if displacement else sol


def sew_upper_bottom(upper_verts, upper_waist_ids, bottom_verts, bottom_faces,
                     bottom_waist_ids, static_ids=None, constrain_weight: float = 1.0,
                     smooth: bool = True, device=None) -> np.ndarray:
    """Sew a bottom garment's waist loop onto the upper garment's waist
    loop by Laplacian editing of the bottom mesh
    (``Laplacian_Deform_upper_and_domn_Optimzier``, reference
    ``engineer/optimizer/lap_deform_optimizer.py:192-300``): the bottom's
    'upper_bottom' loop is best-matched (optimal assignment) to the
    upper's waist loop and pulled there; the bottom's other boundary loops
    (``static_ids``: hemline, cuffs) stay put. The solve runs on
    ``device`` (the CUDA card when none is given) → the deformed bottom
    vertices (N, 3) numpy float32."""
    from .matching import boundary_curve_best_match

    bv = np.asarray(bottom_verts, np.float32)
    waist = np.asarray(bottom_waist_ids, np.int64)
    tgt_loop = np.asarray(upper_verts, np.float32)[np.asarray(upper_waist_ids)]
    sel, matched = boundary_curve_best_match(bv[waist], tgt_loop)
    cids, targets = [waist[sel]], [matched]
    if static_ids is not None and len(static_ids):
        sid = np.asarray(static_ids, np.int64)
        cids.append(sid)
        targets.append(bv[sid])
    out = laplacian_deform(bv, bottom_faces, np.concatenate(cids), np.concatenate(targets),
                           constrain_weight=constrain_weight, smooth=smooth, device=device)
    return out.cpu().numpy()
