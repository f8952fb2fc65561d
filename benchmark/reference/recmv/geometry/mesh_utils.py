"""Copy of ``recmv_tpu/geometry/mesh_utils.py``, kept byte-for-byte apart from this note and
its imports: the port runs where JAX is absent, and importing any
``recmv_tpu`` module imports JAX.

Host-side mesh utilities (numpy) — replaces the reference's
trimesh/openmesh/pymeshlab plumbing for one-time geometry operations.

Covers: boundary detection (``engineer/utils/mesh_utils.py:88-116``),
boundary *loop* extraction + ordering (trimesh ``.outline()`` used by
``Intersect_Free_Curve.extract_edge``, ``garment_structure.py:156-178``),
hole closing with center fans + subdivision (``garment_structure.py:278``),
edge subdivision near boundaries (``dense_boundary``,
``garment_structure.py:857``), mesh merging / slicing
(``engineer/utils/mesh_utils.py:9-87``), and vertex normals.

These run on host between jitted optimization segments (topology events),
so plain numpy is the right tool — no device round trips needed.
"""

from __future__ import annotations

import numpy as np


def undirected_edges(faces: np.ndarray) -> np.ndarray:
    """(F,3) → (3F,2) undirected edge list (unsorted, with duplicates)."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    return e


def boundary_edges(faces: np.ndarray) -> np.ndarray:
    """Edges that belong to exactly one face, as directed (a, b) pairs in
    face winding order — so chained loops inherit the surface orientation."""
    e = undirected_edges(np.asarray(faces, np.int64))
    key = np.minimum(e[:, 0], e[:, 1]) << 32 | np.maximum(e[:, 0], e[:, 1])
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    return e[counts[inv] == 1]


def mesh_boundary_mask(faces: np.ndarray, num_verts: int) -> np.ndarray:
    """Bool (V,): vertex lies on a boundary edge (mesh_utils.py:88)."""
    be = boundary_edges(faces)
    mask = np.zeros(num_verts, bool)
    mask[be.reshape(-1)] = True
    return mask


def largest_component(verts: np.ndarray, faces: np.ndarray):
    """Keep the largest face-connected component (by face count) and
    drop unreferenced vertices. MC extractions of a weakly-constrained
    far-field SDF can carry spurious floating sheets — the reference's
    pymeshlab cleanup removes them before registration; without this the
    NRICP target includes junk geometry."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    faces = np.asarray(faces)
    V = int(faces.max()) + 1 if len(faces) else len(verts)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    adj = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(V, V))
    n, lab = connected_components(adj, directed=False)
    if n <= 1:
        return np.asarray(verts), faces
    fl = lab[faces[:, 0]]
    keep_lab = np.bincount(fl).argmax()
    keep_faces = faces[fl == keep_lab]
    used = np.unique(keep_faces)
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    return np.asarray(verts)[used], remap[keep_faces]


def boundary_loops(faces: np.ndarray) -> list[np.ndarray]:
    """Ordered boundary loops (lists of vertex ids), the trimesh
    ``outline()`` equivalent. Loops follow face winding."""
    be = boundary_edges(faces)
    nxt = {}
    for a, b in be:
        nxt[int(a)] = int(b)
    loops = []
    seen = set()
    for start in list(nxt):
        if start in seen:
            continue
        loop = [start]
        seen.add(start)
        cur = nxt.get(start)
        while cur is not None and cur != start and cur not in seen:
            loop.append(cur)
            seen.add(cur)
            cur = nxt.get(cur)
        if cur == start and len(loop) >= 3:
            loops.append(np.asarray(loop, np.int64))
    return loops


def longest_boundary_loop(faces: np.ndarray, verts: np.ndarray | None = None,
                          by_length: bool = False) -> np.ndarray:
    loops = boundary_loops(faces)
    if not loops:
        raise ValueError("mesh has no boundary")
    if by_length and verts is not None:
        def arclen(l):
            v = verts[l]
            return np.linalg.norm(np.roll(v, -1, 0) - v, axis=1).sum()
        return max(loops, key=arclen)
    return max(loops, key=len)


def close_holes(verts: np.ndarray, faces: np.ndarray, subdivide_times: int = 2):
    """Close every boundary loop with a center-vertex fan, then subdivide
    the new faces ``subdivide_times`` times (garment_structure.py:278-335).
    Returns (verts, faces, new_face_start): faces[new_face_start:] are the
    cap faces (useful for curve-aware sampling on hemline discs)."""
    verts = np.asarray(verts, np.float64).copy()
    faces = np.asarray(faces, np.int64).copy()
    orig_f = faces.shape[0]
    for loop in boundary_loops(faces):
        center = verts[loop].mean(0, keepdims=True)
        cid = verts.shape[0]
        verts = np.concatenate([verts, center], axis=0)
        # boundary directed edges a→b belong to the existing surface; cap
        # faces wind opposite: (b, a, center) keeps consistent orientation
        a = loop
        b = np.roll(loop, -1)
        cap = np.stack([b, a, np.full_like(a, cid)], axis=1)
        faces = np.concatenate([faces, cap], axis=0)
    new_ids = np.arange(orig_f, faces.shape[0])
    for _ in range(subdivide_times):
        verts, faces, new_ids = subdivide_faces(verts, faces, new_ids)
    return verts, faces, orig_f


def subdivide_faces(verts: np.ndarray, faces: np.ndarray, face_ids: np.ndarray):
    """Loop-style 1→4 subdivision of the selected faces (midpoint split),
    with neighbor faces split to stay conforming (trimesh.remesh.subdivide
    semantics for a face subset). Returns (verts, faces, new_face_ids)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    sel = np.zeros(faces.shape[0], bool)
    sel[np.asarray(face_ids, np.int64)] = True

    # midpoints for all edges of selected faces
    f = faces[sel]
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    ek = np.minimum(edges[:, 0], edges[:, 1]) << 32 | np.maximum(edges[:, 0], edges[:, 1])
    uk, first = np.unique(ek, return_index=True)
    mid_of = {}
    new_verts = [verts]
    vid = verts.shape[0]
    for k, fi in zip(uk, first):
        a, b = edges[fi]
        mid_of[int(k)] = vid
        new_verts.append(((verts[a] + verts[b]) / 2.0)[None])
        vid += 1
    verts = np.concatenate(new_verts, axis=0)

    def ekey(a, b):
        a = int(a)
        b = int(b)
        return (min(a, b) << 32) | max(a, b)

    out_faces = []
    new_face_ids = []
    for i, (a, b, c) in enumerate(faces):
        if sel[i]:
            mab = mid_of[ekey(a, b)]
            mbc = mid_of[ekey(b, c)]
            mca = mid_of[ekey(c, a)]
            base = len(out_faces)
            out_faces += [[a, mab, mca], [mab, b, mbc], [mca, mbc, c], [mab, mbc, mca]]
            new_face_ids += [base, base + 1, base + 2, base + 3]
        else:
            # conforming split against any midpoints on shared edges
            mids = [mid_of.get(ekey(a, b)), mid_of.get(ekey(b, c)), mid_of.get(ekey(c, a))]
            vs = [a, b, c]
            present = [m is not None for m in mids]
            n = sum(present)
            if n == 0:
                out_faces.append([a, b, c])
            elif n == 1:
                e = present.index(True)
                m = mids[e]
                v0, v1, v2 = vs[e], vs[(e + 1) % 3], vs[(e + 2) % 3]
                out_faces += [[v0, m, v2], [m, v1, v2]]
            elif n == 2:
                e = present.index(False)
                # edges (e+1), (e+2) have midpoints
                v0, v1, v2 = vs[e], vs[(e + 1) % 3], vs[(e + 2) % 3]
                m12 = mids[(e + 1) % 3]
                m20 = mids[(e + 2) % 3]
                out_faces += [[v0, v1, m12], [v0, m12, m20], [m20, m12, v2]]
            else:
                mab, mbc, mca = mids
                out_faces += [[a, mab, mca], [mab, b, mbc], [mca, mbc, c], [mab, mbc, mca]]
    return verts, np.asarray(out_faces, np.int64), np.asarray(new_face_ids, np.int64)


def dense_boundary(verts: np.ndarray, faces: np.ndarray, times: int = 1):
    """Subdivide faces touching the boundary (garment_structure.py:857):
    densifies template meshes near their feature-line boundaries so curve
    extraction has enough resolution."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    for _ in range(times):
        mask = mesh_boundary_mask(faces, verts.shape[0])
        touch = mask[faces].any(1)
        verts, faces, _ = subdivide_faces(verts, faces, np.where(touch)[0])
    return verts, faces


def merge_meshes(verts_list, faces_list):
    """Concatenate meshes with reindexed faces (mesh_utils.py:61)."""
    verts_out = []
    faces_out = []
    off = 0
    for v, f in zip(verts_list, faces_list):
        verts_out.append(np.asarray(v))
        faces_out.append(np.asarray(f, np.int64) + off)
        off += len(v)
    return np.concatenate(verts_out, 0), np.concatenate(faces_out, 0)


def slice_mesh_by_vertex_ids(verts: np.ndarray, faces: np.ndarray, keep_ids: np.ndarray):
    """Extract the submesh on a vertex subset (slice_garment_mesh,
    mesh_utils.py:9): faces entirely within keep_ids, vertices reindexed.
    Returns (sub_verts, sub_faces, old_vertex_ids)."""
    keep_ids = np.asarray(keep_ids, np.int64)
    keep = np.zeros(verts.shape[0], bool)
    keep[keep_ids] = True
    fmask = keep[faces].all(1)
    sub_f_old = faces[fmask]
    used = np.unique(sub_f_old)
    remap = -np.ones(verts.shape[0], np.int64)
    remap[used] = np.arange(used.shape[0])
    return verts[used], remap[sub_f_old], used


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    np.add.at(vn, faces[:, 0], fn)
    np.add.at(vn, faces[:, 1], fn)
    np.add.at(vn, faces[:, 2], fn)
    n = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.clip(n, 1e-12, None)


def sample_mesh_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                        seed: int = 0):
    """Area-weighted uniform surface sampling: (points (n,3),
    normals (n,3) from the sampled faces). IGR point-set fits consume
    this instead of raw mesh vertices — vertex density is a meshing
    artifact (e.g. subdivided hole-closure fans put most vertices on the
    caps), and a density-biased point set biases the fitted SDF toward
    the oversampled patches."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    area = 0.5 * np.linalg.norm(fn, axis=1)
    p = area / max(area.sum(), 1e-12)
    rng = np.random.RandomState(seed)
    fi = rng.choice(len(faces), size=n, p=p)
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    a, b, c = verts[faces[fi, 0]], verts[faces[fi, 1]], verts[faces[fi, 2]]
    pts = (1 - r1) * a + r1 * (1 - r2) * b + r1 * r2 * c
    nrm = fn[fi] / np.clip(np.linalg.norm(fn[fi], axis=1, keepdims=True),
                           1e-12, None)
    return pts.astype(np.float32), nrm.astype(np.float32)


def vertex_face_adjacency(faces: np.ndarray, num_verts: int):
    """(vertex_index, face_index) flat arrays — the openmesh vertex-face
    index tables the reference builds after each remesh
    (OptimGarmentNetwork.py:715-735)."""
    faces = np.asarray(faces, np.int64)
    fi = np.repeat(np.arange(faces.shape[0]), 3)
    vi = faces.reshape(-1)
    order = np.argsort(vi, kind="stable")
    return vi[order], fi[order]


def connected_components(faces: np.ndarray, num_verts: int) -> np.ndarray:
    """Vertex component labels via union-find (host)."""
    parent = np.arange(num_verts)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b, c in np.asarray(faces, np.int64):
        ra, rb, rc = find(a), find(b), find(c)
        parent[rb] = ra
        parent[find(rc)] = ra
    return np.asarray([find(i) for i in range(num_verts)])


def compute_edges_unique(faces: np.ndarray) -> np.ndarray:
    e = undirected_edges(np.asarray(faces, np.int64))
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)
