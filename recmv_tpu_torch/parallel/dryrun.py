"""One sharded training step on a tiny synthetic scene (counterpart of the
JAX package's ``__graft_entry__.dryrun_multichip``).

    python -m recmv_tpu_torch.parallel.dryrun --ranks 2 [--backend gloo]
        [--device cpu]

spawns the ranks (``parallel.spawn``, a ``file://`` store), builds the
network on each from one seed, gives it the scene's feature curves, and
runs one whole ``train_step`` (①, ②, seeding, the solve, ③ and the three
updates) over the ('data', 'rays') mesh; rank 0 prints the loss.
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import tempfile

RATIO = {"sdfRatio": 1.0, "deformerRatio": 0.5, "renderRatio": 1.0}
FRAMES, IMAGE, SKINNER_RES = 2, 48, (17, 25, 9)


def _rank_step(rank: int, scene: str, data: int, device) -> dict:
    import numpy as np
    import torch

    from ..config import ConfigFactory
    from ..core.builder import build_opt_net
    from ..core.network import TrainConfig
    from ..data.dataset import get_dataset_and_loader
    from ..data.synthetic import SCENE_CURVES, boundary_ring, shrink_garment_init
    from ..geometry.polygons import uniform_sample_3d
    from .mesh import make_mesh

    mesh = make_mesh(data=data, device=device)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    conf = ConfigFactory.parse_file(os.path.join(root, "configs", "synthetic", "smoke.conf"))
    ds, _ = get_dataset_and_loader(scene, {"deformer": 256, "render": 256}, 2, shuffle=False,
                                   garment_type="synthetic-tube", data_type="synthe")
    cfg = TrainConfig(sample_pix=64, point_radius=0.025, remesh_intersect=8,
                      mc_capacity_v=1 << 12, mc_capacity_f=1 << 13, raster_tile=16,
                      raster_cap_mesh=128, raster_cap_points=128, solver_times=4,
                      surface_sample=64)
    net = build_opt_net(conf, ds, os.path.join(scene, f"result_rank{rank}"),
                        resolutions=((7, 9, 5), (13, 17, 9)), skinner_res=SKINNER_RES,
                        train_cfg=cfg, device=mesh.device)
    shrink_garment_init(net.params)
    rings = {n: uniform_sample_3d(boundary_ring(y, offset=o), 200).astype(np.float32)
             for n, y, o in SCENE_CURVES["synthetic-tube"]}
    net.align_fl(rings, rings, {n: (np.zeros(3, np.float32), np.float32(1.0)) for n in rings})
    net.set_parallel(mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    fids = list(range(FRAMES))
    loss, info = net.train_step(ds.get_batch(fids), fids, RATIO, generator=gen)
    bad = [k for k, v in info.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite outputs on rank {rank}: {bad}")
    return dict(loss=loss, info=info, shape=dict(mesh.shape), comm=dict(mesh.comm))


def dryrun_multichip(n_ranks: int, backend: str = "gloo", device=None) -> dict:
    """One full sharded ``train_step`` over ``n_ranks`` new processes
    (data=2 for an even count, else 1, as the JAX dry run lays out its
    mesh) on a 2-frame 48 px synthetic tube → rank 0's result
    (loss, info, mesh shape, collective counts). ``device`` is each rank's
    (default: its card, ``parallel.make_mesh``)."""
    from ..data.synthetic import generate_scene
    from .mesh import spawn

    data = 2 if n_ranks % 2 == 0 else 1
    work = tempfile.mkdtemp(prefix="recmv_dryrun_")
    try:
        scene = os.path.join(work, "tube")
        generate_scene(scene, n_frames=FRAMES, image_size=IMAGE, skinner_res=SKINNER_RES,
                       device="cpu" if str(device) == "cpu" else None)
        out = spawn(_rank_step, n_ranks, backend, args=(scene, data, device),
                    threads=1 if str(device) == "cpu" else None)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if any(o["info"] != out[0]["info"] for o in out):
        raise AssertionError("the ranks' info differ")
    r0 = out[0]
    print(f"dryrun_multichip({n_ranks}): full train_step loss={r0['loss']:.5f} on mesh "
          f"{r0['shape']} over {backend} (fl={r0['info'].get('fl_loss_total', 0.0):.4f} "
          f"pc={r0['info']['pc_loss_total']:.4f}; {r0['comm']['calls']} collectives, "
          f"{r0['comm']['bytes']} bytes)", flush=True)
    return r0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default=None, help="each rank's device (default: its card)")
    a = ap.parse_args(argv)
    dryrun_multichip(a.ranks, a.backend, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
