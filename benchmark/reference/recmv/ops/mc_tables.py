"""Copy of ``recmv_tpu/ops/mc_tables.py``, kept byte-for-byte apart from this note and
its imports: the port runs where JAX is absent, and importing any
``recmv_tpu`` module imports JAX.

Marching-cubes lookup tables, generated from cube topology.

Instead of embedding the classic Bourke tables verbatim, we derive an
equivalent table set from first principles (verified by the watertight /
orientation / Euler-characteristic tests in tests/test_marching_cubes.py):

For each of the 256 inside/outside corner configurations, the isosurface
intersects the cube on its *cut edges* (edges with one inside endpoint).
On every face (4-cycle of corners, oriented CCW seen from outside the
cube), each maximal run of inside corners contributes one oriented surface
segment from the cut edge *entering* the run to the cut edge *leaving* it
— the marching-squares connectivity with the "separate diagonal insides"
disambiguation, which is exactly the rule classic MC tables use. Every cut
edge is entered on one adjacent face and left on the other (faces traverse
a shared edge in opposite directions), so the segments chain into disjoint
oriented loops; fan-triangulating each loop yields the triangle table.

Corner layout (bit i set ⇔ corner i inside, i.e. value < iso):
    c0=(0,0,0) c1=(1,0,0) c2=(1,1,0) c3=(0,1,0)
    c4=(0,0,1) c5=(1,0,1) c6=(1,1,1) c7=(0,1,1)
Edges (index → corner pair):
    0:(0,1) 1:(1,2) 2:(2,3) 3:(3,0) 4:(4,5) 5:(5,6) 6:(6,7) 7:(7,4)
    8:(0,4) 9:(1,5) 10:(2,6) 11:(3,7)
"""

from __future__ import annotations

import numpy as np

CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.int32,
)

EDGE_CORNERS = np.array(
    [
        [0, 1], [1, 2], [2, 3], [3, 0],
        [4, 5], [5, 6], [6, 7], [7, 4],
        [0, 4], [1, 5], [2, 6], [3, 7],
    ],
    dtype=np.int32,
)

# Face corner cycles, CCW viewed from outside the cube.
_FACES = [
    [0, 3, 2, 1],  # z=0, normal -z
    [4, 5, 6, 7],  # z=1, normal +z
    [0, 1, 5, 4],  # y=0, normal -y
    [3, 7, 6, 2],  # y=1, normal +y
    [0, 4, 7, 3],  # x=0, normal -x
    [1, 2, 6, 5],  # x=1, normal +x
]

_EDGE_OF_PAIR = {}
for _e, (_a, _b) in enumerate(EDGE_CORNERS):
    _EDGE_OF_PAIR[(int(_a), int(_b))] = _e
    _EDGE_OF_PAIR[(int(_b), int(_a))] = _e

MAX_TRIS = 5  # verified below at generation time


def _segments_for_face(face, inside):
    """Oriented segments (enter_edge → leave_edge) on one face for a given
    inside-corner set. Walking the CCW cycle, a segment spans each maximal
    run of inside corners."""
    segs = []
    n = len(face)
    ins = [face[i] in inside for i in range(n)]
    if all(ins) or not any(ins):
        return segs
    for i in range(n):
        # run starts at i: corner inside, previous outside
        if ins[i] and not ins[(i - 1) % n]:
            j = i
            while ins[(j + 1) % n]:
                j = (j + 1) % n
            enter = _EDGE_OF_PAIR[(face[(i - 1) % n], face[i])]
            leave = _EDGE_OF_PAIR[(face[j], face[(j + 1) % n])]
            segs.append((enter, leave))
    return segs


def _loops_for_config(cfg: int):
    inside = {i for i in range(8) if cfg & (1 << i)}
    nxt = {}
    for face in _FACES:
        for enter, leave in _segments_for_face(face, inside):
            assert enter not in nxt
            nxt[enter] = leave
    loops = []
    seen = set()
    for start in list(nxt):
        if start in seen:
            continue
        loop = [start]
        seen.add(start)
        cur = nxt[start]
        while cur != start:
            loop.append(cur)
            seen.add(cur)
            cur = nxt[cur]
        loops.append(loop)
    return loops


def _generate_tables():
    tri_table = np.full((256, MAX_TRIS * 3), -1, dtype=np.int32)
    n_tris = np.zeros(256, dtype=np.int32)
    edge_table = np.zeros(256, dtype=np.int32)
    for cfg in range(256):
        tris = []
        for loop in _loops_for_config(cfg):
            for k in range(1, len(loop) - 1):
                tris.append((loop[0], loop[k], loop[k + 1]))
        assert len(tris) <= MAX_TRIS, (cfg, len(tris))
        n_tris[cfg] = len(tris)
        for t, tri in enumerate(tris):
            tri_table[cfg, 3 * t : 3 * t + 3] = tri
            for e in tri:
                edge_table[cfg] |= 1 << e
    return tri_table, n_tris, edge_table


TRI_TABLE, N_TRIS, EDGE_TABLE = _generate_tables()
