"""Novel-pose animation after the 513³ extraction (counterpart of the
repo's ``tools/bench_animation.py``), on the production bench scene and
its cached initialization (``bench_fullstep``'s ``result/bench_init.ckpt``):

1. the ``higher`` extraction: seg3d at the (513, 513, 513) pyramid on the
   card and the host marching cubes into 2^22-vertex buffers, the body and
   every garment (``marching_cube_update(higher=True)``, the path of
   ``infer --quality higher``; the JAX tool calls
   ``marching_cube_update_host``), cold and then warm;
2. the registration (Laplacian curve alignment, the K1 visibility scan,
   NRICP at the production schedules, remesh, refine), once;
3. the animation: the registered garments posed over a synthetic
   novel-pose motion (a lerp between the scene's first and last poses with
   a side sway), in frames per second.

    python -m recmv_tpu_torch.tools.bench_animation [--motion-frames 32]

``--device`` (default ``cuda``; ``cpu`` for the tests) replaces the JAX
tool's ``--platform``; ``--cache-dir`` and ``--exec-cache`` have no
counterpart.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil
import time

import numpy as np

from . import bench_path, device_record, sync, write_record
from .bench_fullstep import build_bench_net


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("--image", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--quality", default="higher", help="extraction pyramid (higher = 513³)")
    ap.add_argument("--motion-frames", type=int, default=32)
    ap.add_argument("--init-epochs", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene", default=bench_path("scenes", "bench"),
                    help="scene path prefix (+ _<image>_<frames>), bench_fullstep's")
    ap.add_argument("--out", default=bench_path("bench_animation.json"))
    return ap.parse_args(argv)


def novel_motion(dataset, T: int) -> tuple:
    """(poses (T, 72), trans (T, 3)): a lerp between the scene's first and
    last poses with a sway of the left hip, every frame a pose the fit never
    saw, at the mean translation."""
    base = dataset.params.poses.reshape(-1, 24, 3)
    tt = np.linspace(0, 1, T, dtype=np.float32)[:, None, None]
    poses = base[0] * (1 - tt) + base[-1] * tt
    poses[:, 1, 2] += 0.2 * np.sin(np.linspace(0, 2 * np.pi, T, dtype=np.float32))
    trans = np.tile(dataset.params.trans.mean(0), (T, 1))
    return poses.reshape(T, 72), trans


def main(argv=None) -> dict:
    from .. import resolve_device
    from ..core.inference import GarmentInference

    args = parse_args(argv)
    args.batch, args.sample_pix = 1, 2048
    dev = resolve_device(args.device)
    dataset, net, t_build, t_init = build_bench_net(args, dev)
    print(f"[bench-anim] build {t_build:.1f}s init {t_init:.1f}s", flush=True)
    ratio = {"sdfRatio": 1.0, "deformerRatio": 1.0, "renderRatio": 1.0}

    times = []
    for _ in range(2):                   # cold, then warm
        t0 = time.time()
        net.marching_cube_update(ratio, higher=True)
        sync(dev)
        times.append(time.time() - t0)
    nv = [int(n) for n in net.mesh.garment_n]
    grid = list(net.seg3d_cfg.resolutions[-1])
    print(f"[bench-anim] extract {grid}: cold {times[0]:.2f}s warm {times[1]:.2f}s nv={nv}",
          flush=True)

    out_dir = osp.join(dataset.root, "result", "bench_anim")
    shutil.rmtree(out_dir, ignore_errors=True)          # register anew: no cache hit
    inf = GarmentInference(net)
    t0 = time.time()
    inf.ensure_registration(ratio, out_dir)
    sync(dev)
    register_s = time.time() - t0
    reg_nv = {g: int(len(v)) for g, (v, _) in inf.registered.items()}

    poses, trans = novel_motion(dataset, args.motion_frames)
    t0 = time.time()
    inf.infer_garment_animation(poses, trans, ratio, out_dir)
    sync(dev)
    anim_s = time.time() - t0
    n_objs = len([f for f in os.listdir(out_dir) if f.endswith(".obj")])
    print(f"[bench-anim] {args.motion_frames} frames in {anim_s:.2f}s "
          f"({args.motion_frames / anim_s:.2f} frames/s), {n_objs} objs", flush=True)

    out = {
        "config": {"image": args.image, "frames": args.frames, "quality": args.quality,
                   "grid": grid, "motion_frames": args.motion_frames},
        **device_record(dev),
        "extract_cold_s": round(times[0], 4),
        "extract_warm_s": round(times[1], 4),
        "extract_verts": nv,
        "register_s": round(register_s, 4),
        "registration_stage_s": {g: {k: round(v, 4) for k, v in t.items()}
                                 for g, t in inf.registration_times.items()},
        "registered_verts": reg_nv,
        "animation_s": round(anim_s, 4),
        "animation_frames_per_s": round(args.motion_frames / anim_s, 4),
        "t_build_s": round(t_build, 2), "t_init_s": round(t_init, 2),
    }
    return write_record(args.out, out)


if __name__ == "__main__":
    main()
