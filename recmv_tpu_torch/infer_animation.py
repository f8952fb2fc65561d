"""Novel-pose garment animation, a CLI of the port (counterpart of the
repo's ``infer_fl_animation.py``): drive the registered garments of a
fitted scene with a SNUG-style motion sequence, using the latent codes
averaged over the scene's frames and the motion's translations offset by
the scene's mean translation.

    python -m recmv_tpu_torch.infer_animation --data-root /path/to/scene \\
        --motion motion.npz [--device cuda] [--out DIR]

The motion is an ``.npz`` with ``pose`` (T, 72) and optionally ``trans``
(T, 3) and ``shape``. The registration is cached in the output directory
(``registry_<garment>.obj``) and made there when it is missing. It runs on
the CUDA card (``--device cuda``, the default) and raises without one;
``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os.path as osp


def main(argv=None):
    """Run the CLI; returns the ``GarmentInference``."""
    p = argparse.ArgumentParser(description="REC-MV garment animation (PyTorch port)")
    p.add_argument("--data-root", required=True)
    p.add_argument("--save-folder", default="result")
    p.add_argument("--motion", required=True, help="npz with pose (T,72) [+trans, shape]")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--quality", default="coarse",
                   choices=["small", "coarse", "medium", "fine", "higher"])
    args = p.parse_args(argv)

    from .core.inference import GarmentInference
    from .data.dataset import SnugAnimationDataset
    from .infer import load_net

    load_args = argparse.Namespace(**vars(args), conf=None, ckpt=None, frames=None,
                                   curves_only=False)
    net, dataset, save_root = load_net(load_args)
    motion = SnugAnimationDataset(args.motion, shape=dataset.params.shape)
    trans = motion.trans + dataset.params.trans.mean(0, keepdims=True)
    out = args.out or osp.join(save_root, "animation")
    inf = GarmentInference(net)
    ratio = {"sdfRatio": 1.0, "deformerRatio": 1.0, "renderRatio": 1.0}
    inf.infer_garment_animation(motion.poses, trans, ratio, out)
    print(f"[animate] wrote {motion.frame_num} frames under {out}")
    return inf


if __name__ == "__main__":
    main()
