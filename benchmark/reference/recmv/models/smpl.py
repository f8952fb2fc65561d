"""SMPL body model (counterpart of ``recmv_tpu/models/smpl.py``): the
model container, the deterministic synthetic humanoid (numpy, copied from
the JAX module) and forward kinematics / LBS in torch.

``load_smpl`` reads licensed SMPL assets (``.pkl`` with latin-1 strings
and scipy sparse matrices made dense, or ``.npz``; pickles that need
``chumpy`` are not read, in either package). ``get_smpl`` returns one
found in ``smpl_dir`` or $SMPL_DATA_DIR and the synthetic body otherwise;
unlike the JAX loader it searches no ``../SMPL/`` default.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..ops.math3d import batch_rodrigues

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int32,
)
NUM_JOINTS = 24


class SMPLModel:
    """Host container; fields are numpy arrays moved to device on use.

    v_template (V,3), shapedirs (V,3,NB), posedirs (V,3,207) or None,
    J_regressor (24,V), weights (V,24), parents (24,), faces (F,3).
    """

    def __init__(self, v_template, shapedirs, posedirs, J_regressor, weights, parents, faces,
                 gender: str = "neutral"):
        self.v_template = np.asarray(v_template, np.float32)
        self.shapedirs = np.asarray(shapedirs, np.float32)
        self.posedirs = None if posedirs is None else np.asarray(posedirs, np.float32)
        self.J_regressor = np.asarray(J_regressor, np.float32)
        self.weights = np.asarray(weights, np.float32)
        self.parents = np.asarray(parents, np.int32)
        self.faces = np.asarray(faces, np.int64)
        self.gender = gender

    @property
    def num_verts(self):
        return self.v_template.shape[0]


# ---------------------------------------------------------------------------
# Synthetic humanoid (deterministic; for tests/benchmarks without assets)
# ---------------------------------------------------------------------------

# Approximate T-pose SMPL joint locations (meters, y-up, pelvis near origin).
_TPOSE_JOINTS = np.array(
    [
        [0.00, -0.20, 0.00],   # 0 pelvis
        [0.07, -0.30, 0.00],   # 1 L hip
        [-0.07, -0.30, 0.00],  # 2 R hip
        [0.00, -0.08, 0.00],   # 3 spine1
        [0.10, -0.70, 0.00],   # 4 L knee
        [-0.10, -0.70, 0.00],  # 5 R knee
        [0.00, 0.05, 0.00],    # 6 spine2
        [0.09, -1.10, -0.02],  # 7 L ankle
        [-0.09, -1.10, -0.02], # 8 R ankle
        [0.00, 0.18, 0.00],    # 9 spine3
        [0.11, -1.16, 0.10],   # 10 L foot
        [-0.11, -1.16, 0.10],  # 11 R foot
        [0.00, 0.38, 0.00],    # 12 neck
        [0.08, 0.30, 0.00],    # 13 L collar
        [-0.08, 0.30, 0.00],   # 14 R collar
        [0.00, 0.50, 0.02],    # 15 head
        [0.18, 0.32, 0.00],    # 16 L shoulder
        [-0.18, 0.32, 0.00],   # 17 R shoulder
        [0.44, 0.32, 0.00],    # 18 L elbow
        [-0.44, 0.32, 0.00],   # 19 R elbow
        [0.70, 0.32, 0.00],    # 20 L wrist
        [-0.70, 0.32, 0.00],   # 21 R wrist
        [0.78, 0.32, 0.00],    # 22 L hand
        [-0.78, 0.32, 0.00],   # 23 R hand
    ],
    dtype=np.float32,
)

_BONE_RADII = {
    (0, 1): 0.09, (0, 2): 0.09, (0, 3): 0.12, (1, 4): 0.07, (2, 5): 0.07,
    (3, 6): 0.12, (4, 7): 0.05, (5, 8): 0.05, (6, 9): 0.12, (7, 10): 0.04,
    (8, 11): 0.04, (9, 12): 0.09, (9, 13): 0.07, (9, 14): 0.07, (12, 15): 0.07,
    (13, 16): 0.06, (14, 17): 0.06, (16, 18): 0.05, (17, 19): 0.05,
    (18, 20): 0.04, (19, 21): 0.04, (20, 22): 0.035, (21, 23): 0.035,
}


def _capsule_sdf(p, a, b, r):
    ab = b - a
    t = np.clip(((p - a) @ ab) / max(float(ab @ ab), 1e-9), 0.0, 1.0)
    return np.linalg.norm(p - (a + t[..., None] * ab), axis=-1) - r


def synthetic_body_sdf(pts: np.ndarray) -> np.ndarray:
    """Union-of-capsules SDF of the synthetic humanoid; used by tests and
    by the synthetic-scene generator as ground truth geometry."""
    d = np.full(pts.shape[0], 1e9, np.float32)
    for (pi, ci), r in _BONE_RADII.items():
        d = np.minimum(d, _capsule_sdf(pts, _TPOSE_JOINTS[pi], _TPOSE_JOINTS[ci], r))
    return d


def synthetic_body_model(n_subdiv: int = 40) -> SMPLModel:
    """Deterministic humanoid with SMPL tensor layout.

    The surface is a UV-sphere warped onto the capsule-union body via
    sphere tracing toward the SDF zero set; skinning weights are inverse
    squared distances to the two nearest bones. This yields a closed
    manifold mesh — adequate for skinning-field construction, IGR
    initialization, and end-to-end tests without licensed assets.
    """
    # UV sphere
    n_lat, n_lon = n_subdiv, n_subdiv
    lat = np.linspace(1e-3, np.pi - 1e-3, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    LAT, LON = np.meshgrid(lat, lon, indexing="ij")
    dirs = np.stack(
        [np.sin(LAT) * np.cos(LON), np.cos(LAT), np.sin(LAT) * np.sin(LON)], axis=-1
    ).reshape(-1, 3).astype(np.float32)
    center = np.array([0.0, -0.2, 0.0], np.float32)

    # March each ray from far outside toward the body along -dir
    verts = center + dirs * 2.0
    for _ in range(48):
        sd = synthetic_body_sdf(verts)
        verts = verts - dirs * np.maximum(sd, 0.0)[:, None] * 0.9
    # faces of the lat-lon grid (two triangles per quad, wrap lon)
    faces = []
    def vid(i, j):
        return i * n_lon + (j % n_lon)
    for i in range(n_lat - 1):
        for j in range(n_lon):
            # winding chosen so face normals point outward (IGR fitting
            # and the mask/normal losses depend on outward orientation)
            faces.append([vid(i, j), vid(i, j + 1), vid(i + 1, j)])
            faces.append([vid(i, j + 1), vid(i + 1, j + 1), vid(i + 1, j)])
    faces = np.asarray(faces, np.int64)

    # Skinning weights: softmax over negative distance to child bones
    V = verts.shape[0]
    dists = np.zeros((V, NUM_JOINTS), np.float32)
    dists[:] = 1e9
    for (pi, ci), r in _BONE_RADII.items():
        d = np.maximum(_capsule_sdf(verts, _TPOSE_JOINTS[pi], _TPOSE_JOINTS[ci], r) + r, 1e-4)
        dists[:, ci] = np.minimum(dists[:, ci], d)
    w = 1.0 / np.maximum(dists, 1e-4) ** 2
    w = np.where(dists > 1e8, 0.0, w)
    w[:, 0] += 1e-6  # ensure nonzero rows
    w = w / w.sum(axis=1, keepdims=True)

    # Joint regressor: joints are fixed functions of nearby verts
    jr = np.zeros((NUM_JOINTS, V), np.float32)
    vd = np.linalg.norm(verts[None, :, :] - _TPOSE_JOINTS[:, None, :], axis=-1)
    nearest = np.argsort(vd, axis=1)[:, :8]
    for j in range(NUM_JOINTS):
        jr[j, nearest[j]] = 1.0 / 8.0

    shapedirs = np.zeros((V, 3, 10), np.float32)
    # beta0 = global scale-ish blendshape so shape optimization has signal
    shapedirs[:, :, 0] = (verts - center) * 0.1
    shapedirs[:, 1, 1] = 0.1  # beta1 = height shift

    return SMPLModel(verts, shapedirs, None, jr, w, SMPL_PARENTS, faces, "synthetic")


def _asset_path(gender: str, smpl_dir: str | None):
    """A licensed asset file in ``smpl_dir`` or $SMPL_DATA_DIR, or None.
    No default directory is searched: without either, nothing is looked up."""
    smpl_dir = smpl_dir or os.environ.get("SMPL_DATA_DIR")
    if not smpl_dir:
        return None
    cands = [
        f"SMPL_{gender.upper()}.pkl",
        f"SMPL_{gender.upper()}.npz",
        f"basicmodel_{'m' if gender == 'male' else 'f' if gender == 'female' else 'neutral'}_lbs_10_207_0_v1.0.0.pkl",
        f"smpl_{gender}.npz",
    ]
    for c in cands:
        p = os.path.join(smpl_dir, c)
        if os.path.isfile(p):
            return p
    return None


def _as_dense(x):
    if hasattr(x, "toarray"):
        return x.toarray()
    if hasattr(x, "todense"):
        return np.asarray(x.todense())
    return np.asarray(x)


def load_smpl(gender: str = "neutral", smpl_dir: str | None = None) -> SMPLModel:
    """Load licensed SMPL assets (``recmv_tpu/models/smpl.py:71-117``):
    ``SMPL_{GENDER}.{pkl,npz}`` / ``basicmodel_*`` / ``smpl_{gender}.npz`` in
    ``smpl_dir`` or $SMPL_DATA_DIR; the first 10 shape directions. Raises
    FileNotFoundError when there is none (no default directory)."""
    path = _asset_path(gender, smpl_dir)
    if path is None:
        raise FileNotFoundError(
            f"No SMPL asset for gender={gender} under {smpl_dir or os.environ.get('SMPL_DATA_DIR')}"
            "; set SMPL_DATA_DIR or use synthetic_body_model() for tests.")
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        shapedirs = _as_dense(data["shapedirs"])[:, :, :10]
        return SMPLModel(
            _as_dense(data["v_template"]), shapedirs, _as_dense(data["posedirs"]),
            _as_dense(data["J_regressor"]), _as_dense(data["weights"]),
            _as_dense(data["kintree_table"])[0] if "kintree_table" in data else SMPL_PARENTS,
            _as_dense(data["f"]), gender,
        )
    data = np.load(path, allow_pickle=True)
    return SMPLModel(
        data["v_template"], data["shapedirs"][:, :, :10],
        data["posedirs"] if "posedirs" in data else None,
        data["J_regressor"], data["weights"],
        data["parents"] if "parents" in data else SMPL_PARENTS,
        data["f"] if "f" in data else data["faces"], gender,
    )


def get_smpl(gender: str = "neutral", smpl_dir: str | None = None) -> SMPLModel:
    """The licensed asset in ``smpl_dir`` or $SMPL_DATA_DIR when one is
    there, else the deterministic synthetic body."""
    if _asset_path(gender, smpl_dir) is not None:
        return load_smpl(gender, smpl_dir)
    return synthetic_body_model()


# ---------------------------------------------------------------------------
# Kinematics and LBS
# ---------------------------------------------------------------------------

def forward_kinematics(rotmats: torch.Tensor, joints: torch.Tensor, parents) -> torch.Tensor:
    """rotmats (B, 24, 3, 3), joints (B, 24, 3) or (24, 3) → world
    transforms A (B, 24, 4, 4) — the reference's make_A chain."""
    parents = np.asarray(parents)
    if joints.ndim == 2:
        joints = joints[None]
    B = rotmats.shape[0]

    def make_A(R, t):
        top = torch.cat([R, t[..., None]], dim=-1)                      # (B, 3, 4)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                              device=R.device).expand(B, 1, 4)
        return torch.cat([top, bottom], dim=-2)

    results = [make_A(rotmats[:, 0], joints[:, 0].expand(B, 3))]
    for i in range(1, parents.shape[0]):
        j_rel = joints[:, i] - joints[:, parents[i]]
        results.append(results[parents[i]] @ make_A(rotmats[:, i], j_rel.expand(B, 3)))
    return torch.stack(results, dim=1)


def relative_transforms(A: torch.Tensor, joints: torch.Tensor) -> torch.Tensor:
    """A − pad(A @ [J; 0]): skinning transforms rest → posed."""
    if joints.ndim == 2:
        joints = joints[None]
    B = A.shape[0]
    J = joints.expand(B, -1, -1)
    Jw0 = torch.cat([J, torch.zeros_like(J[..., :1])], dim=-1)
    init_bone = torch.einsum("bjxy,bjy->bjx", A, Jw0)
    return A - torch.nn.functional.pad(init_bone[..., None], (3, 0))


def smpl_skeleton(model: SMPLModel, betas: torch.Tensor) -> torch.Tensor:
    """betas (NB,) → rest joints (24, 3) of the shaped body."""
    dev = betas.device
    betas = betas.reshape(-1).to(torch.float32)
    v_shaped = torch.as_tensor(model.v_template, device=dev) + torch.einsum(
        "vdn,n->vd", torch.as_tensor(model.shapedirs, device=dev), betas)
    return torch.as_tensor(model.J_regressor, device=dev) @ v_shaped


def smpl_forward(model: SMPLModel, betas: torch.Tensor, pose: torch.Tensor):
    """betas (NB,), pose (B, 24, 3) axis-angle → (verts (B, V, 3),
    joints (B, 24, 3), A (B, 24, 4, 4)); no global translation."""
    dev = pose.device
    betas = betas.reshape(-1).to(torch.float32)
    if pose.ndim == 2:
        pose = pose[None]
    B = pose.shape[0]
    v_shaped = torch.as_tensor(model.v_template, device=dev) + torch.einsum(
        "vdn,n->vd", torch.as_tensor(model.shapedirs, device=dev), betas)
    J = torch.as_tensor(model.J_regressor, device=dev) @ v_shaped
    rotmats = batch_rodrigues(pose.reshape(-1, 3)).reshape(B, NUM_JOINTS, 3, 3)
    v_posed = v_shaped.expand(B, -1, -1)
    if model.posedirs is not None:
        pose_feat = (rotmats[:, 1:] - torch.eye(3, device=dev)).reshape(B, -1)
        v_posed = v_posed + torch.einsum(
            "vdp,bp->bvd", torch.as_tensor(model.posedirs, device=dev), pose_feat)
    A = forward_kinematics(rotmats, J, model.parents)
    A_rel = relative_transforms(A, J)
    T = torch.einsum("vj,bjxy->bvxy", torch.as_tensor(model.weights, device=dev), A_rel)
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvxy,bvy->bvx", T, v_h)[..., :3]
    return verts, A[:, :, :3, 3], A
