"""Score a trained state, a checkpoint of either package, through the
port's registration, export and scoring (``bench_quality.score``).

    python -m recmv_tpu_torch.tools.rescore_quality --ckpt PATH \\
        <bench_quality's flags, --scene and --seed included> [--out OUT]

The scene and the network are built as ``bench_quality`` builds them;
the checkpoint's state is loaded and ``deformerRatio`` set as the last
training step set it (``(opt_times − 1) / 2500 + 0.5``); then
``bench_quality.score`` registers, exports into ``result/rescore_s<seed>/``
and scores, and the record has ``bench_quality``'s scores
(``chamfer_l2_sym_mean`` and the rest). A checkpoint holds no mesh, so
the registration's target is a fresh ``marching_cube_update`` of the
checkpoint's SDF, where a training run (of either package) registers its
training mesh: the last remesh, moved by the vertices' SGD steps since
and extracted from an earlier SDF. The scores of one state then differ
by that mesh (3.4–10.2% on ``tests/test_torch_bench.py``'s one-step
48 px run). On a scene from ``tests/jax_reference.py --export``, ``--ckpt
<scene>/result/jax_final.ckpt`` scores the JAX package's trained state.
"""

from __future__ import annotations

import argparse
import os.path as osp

from . import bench_path, device_record, write_record
from . import bench_quality as bq


def main(argv=None) -> dict:
    from .. import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    own, rest = ap.parse_known_args(argv)
    args = bq.parse_args(rest if "--out" in rest else rest + ["--out", bench_path("rescore.json")])
    dev = resolve_device(args.device)
    scene, _, dataset, _, net = bq.build(args, dev)
    net.load_checkpoint(own.ckpt)
    ratio = {"sdfRatio": 1.0, "deformerRatio": (net.opt_times - 1) / 2500.0 + 0.5,
             "renderRatio": 1.0}
    return write_record(args.out, {
        "ckpt": osp.basename(own.ckpt), "opt_times": net.opt_times,
        "deformer_ratio": ratio["deformerRatio"], **device_record(dev),
        **bq.score(net, ratio, scene, dataset, args, dev,
                   osp.join(scene, "result", f"rescore_s{args.seed}"))})


if __name__ == "__main__":
    main()
