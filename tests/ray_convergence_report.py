"""Converged rays after each package's own initialization, on the CPU.

    python tests/ray_convergence_report.py [--out report.json] [--parted]

Both packages build one 4-frame 48 px synthetic-tube scene from one state
(``test_torch_init._build_init_pair``: smoke.conf, the tiny pyramid, the
port on the JAX geometric init), then each runs its own
``initialize_tmp_sdf`` (its own curve fit, Laplacian and IGR fits with its
own draws; 40 IGR epochs, 20 curve-fit iterations) and takes 4 training
steps with its own draws (the
JAX fused step with keys 0, 1, ...; the port's ``train_step`` with a
``torch.Generator`` seeded 0), on frames (0, 1), (2, 3), (0, 1), ... Prints
and writes each step's ``{garment}_rayConv`` of ``{garment}_rayBudget`` per
package: the comparison of ``ROADMAP.md`` queue 3's converged-ray item.

``--parted`` reports instead, on the state of ``test_torch_init``'s (i)
(the JAX ``initialize_tmp_sdf(nepochs=4, fl_iters=2)`` on the JAX curve
fit of 6 iterations, read by the port from its ``initial_sdf.ckpt``, the
port on the JAX mesh), the ray seeding and surface solve of each package
on every pair of the scene's frames with key 3: live rays, converged
rays per package, and the rays that converge in one package only.
Needs both packages (JAX on the CPU); not a test.
"""

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import conftest  # noqa: E402,F401  (JAX on the CPU)
import jax  # noqa: E402
import torch  # noqa: E402

from test_torch_init import IMG, N_FRAMES, _build_init_pair, _template_curves  # noqa: E402
from test_torch_train import KEY, RATIO, _seed_uniforms  # noqa: E402

INIT_EPOCHS, FL_ITERS, STEPS = 40, 20, 4


def parted(root, net_j, net_t) -> dict:
    """``--parted`` (module docstring) → {"<f0>,<f1>": (live, JAX
    converged, port converged, parted)}."""
    import itertools

    import jax.numpy as jnp
    import numpy as np

    from recmv_tpu.models.camera import ang_threshold
    from recmv_tpu_torch import bridge

    rigid, _, names = net_j.initialize_fl(_template_curves(net_j), n_iters=6)
    os.makedirs(root / "jax" / "fl_init")
    np.savez(str(root / "jax" / "fl_init" / "init_trans_matrix.npz"),
             T=np.stack([np.asarray(rigid[n][0]) for n in names]),
             s=np.stack([np.asarray(rigid[n][1]) for n in names]))
    net_j.initialize_tmp_sdf(nepochs=4, save_dir=str(root / "jax"), fl_iters=2)
    net_t.load_checkpoint(str(root / "jax" / "initial_sdf.ckpt"))
    for net in (net_j, net_t):
        net.mesh = None
        net.marching_cube_update(RATIO)
    bridge.load_mesh(net_t, net_j.mesh.garment_vs, net_j.mesh.garment_fs,
                     net_j.mesh.garment_n, net_j.mesh.garment_fn)
    vs_j, fs_j = tuple(net_j.mesh.garment_vs), tuple(net_j.mesh.garment_fs)
    fns = net_j._get_jitted(2, tuple(v.shape[0] for v in vs_j)
                            + tuple(f.shape[0] for f in fs_j))
    net_j.ang_thred = ang_threshold(net_j._camera(net_j.scene_tree()))
    out = {}
    for fids in itertools.combinations(range(N_FRAMES), 2):
        fids = list(fids)
        batch = net_j.dataset.get_batch(fids)
        solved_j, _ = fns["rays"](net_j._global_params(), jnp.asarray(fids, jnp.int32),
                                  net_j.garment_masks_from_batch(batch),
                                  net_j._ratio_dict(RATIO), jax.random.PRNGKey(KEY), vs_j, fs_j)
        dev = net_t.device_batch(batch)
        uniforms, _ = _seed_uniforms(jax.random.PRNGKey(KEY), 1,
                                     len(fids) * (IMG // net_t.cfg.seed_downscale) ** 2)
        fids_t = torch.tensor(fids)
        with torch.no_grad():
            rays = net_t.find_and_sample_rays(
                fids_t, [dev[k] for k in net_t._garment_mask_keys()], RATIO,
                net_t.mesh.garment_vs, net_t.mesh.garment_fs, uniforms=uniforms)
            solved_t = net_t.solve_surface_points(rays, fids_t, RATIO)
        cj, ct = np.asarray(solved_j[0]["conv"]), solved_t[0]["conv"].numpy()
        out[",".join(map(str, fids))] = (int(np.asarray(solved_j[0]["valid"]).sum()),
                                         int(cj.sum()), int(ct.sum()), int((cj != ct).sum()))
        print(f"frames {fids}: live, JAX, port, parted = {out[','.join(map(str, fids))]}",
              flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--parted", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    root = Path(tempfile.mkdtemp(prefix="ray_conv_"))
    net_j, net_t = _build_init_pair(root, "synthetic-tube")
    if args.parted:
        out = parted(root, net_j, net_t)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
        return out
    garments = list(net_j.statics.garment_names)
    out = {"config": {"init_epochs": INIT_EPOCHS, "fl_iters": FL_ITERS, "steps": STEPS},
           "jax": [], "port": [], "seconds": {}}
    t0 = time.time()
    net_j.initialize_tmp_sdf(nepochs=INIT_EPOCHS, save_dir=str(root / "jax"), fl_iters=FL_ITERS)
    gen = torch.Generator().manual_seed(0)
    net_t.initialize_tmp_sdf(nepochs=INIT_EPOCHS, save_dir=str(root / "port"), fl_iters=FL_ITERS,
                             generator=gen)
    out["seconds"]["init"] = round(time.time() - t0, 1)
    for step in range(STEPS):
        fids = [0, 1] if step % 2 == 0 else [2, 3]
        batch = net_j.dataset.get_batch(fids)
        _, info_j = net_j.train_step(batch, fids, RATIO, jax.random.PRNGKey(step))
        _, info_t = net_t.train_step(batch, fids, RATIO, generator=gen)
        for pkg, info in (("jax", info_j), ("port", info_t)):
            out[pkg].append({g: (int(info[f"{g}_rayConv"]), int(info[f"{g}_rayBudget"]))
                             for g in garments})
        print(f"step {step} frames {fids}: JAX {out['jax'][-1]}, port {out['port'][-1]}",
              flush=True)
    out["seconds"]["all"] = round(time.time() - t0, 1)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
