"""KNN-propagate the ATR parsing labels into the matting masks
(counterpart of ``preprocess/mask2parsing_mask.py``): every foreground
pixel of each frame's mask takes its nearest nonzero parsing label, cached
as ``mask_parsing_<frame>.npy`` for the dataset (``SceneDataset.
parsing_mask``). Host numpy and scipy; it needs no device.

    python -m recmv_tpu_torch.tools.mask2parsing_mask --data-root <scene> \\
        --garment-type <type>
"""

from __future__ import annotations

import argparse


def main(argv=None) -> list:
    """Run the tool; returns the paths written."""
    from ..data.dataset import SceneDataset

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--garment-type", required=True)
    args = ap.parse_args(argv)
    ds = SceneDataset(args.data_root, {}, garment_type=args.garment_type)
    paths = []
    for i in range(ds.frame_num):
        paths.append(ds.parsing_mask(i))
        print(f"[{i + 1}/{ds.frame_num}] {paths[-1]}")
    return paths


if __name__ == "__main__":
    main()
