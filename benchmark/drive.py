"""What the port and the reference share: building a network for a cell
from a package (``recmv_tpu_torch`` or the frozen copy
``benchmark.reference.recmv``, which have the same interface), the
configuration's garment set in both packages' tables, the order of
frames, and the readings of the first training steps that the
comparison (``check.py``) holds against each other."""

from __future__ import annotations

import importlib
import os
import os.path as osp
import time
import zipfile

import numpy as np
import torch

from . import scene
from .spec import hocon_text
from .weights import load_weights

PHASES = ("remesh", "upload", "fl", "pc", "verts", "rays", "solve", "main", "update")
LOSSES = ("fl_loss_total", "pc_loss_total", "m_loss_total")
REF = f"{__package__}.reference.recmv"


def garment_set(config: dict) -> dict:
    """{table of ``config/constants``: {key: entry}} that the configuration
    states: its garment type's pieces (``garments``), annotated curves
    (``curves``) and curve-aware curve (``curve_aware``, None where it
    states none), and each piece's curves (``garment_curves``)."""
    gt = config["garment_type"]
    return {"TEMPLATE_GARMENT": {gt: list(config["garments"])},
            "FL_INFOS": {gt: list(config["curves"])},
            "CURVE_AWARE": {gt: config.get("curve_aware")},
            "FL_EXTRACT": {g: list(c) for g, c in config["garment_curves"].items()}}


def register_garment_set(config: dict) -> None:
    """Add the configuration's entries to the frozen copy's tables where the
    key is absent (no entry where it states none); raises where the copy
    holds another entry. The copy's files stay as they are."""
    constants = importlib.import_module(f"{REF}.config.constants")
    for table, entries in garment_set(config).items():
        have = getattr(constants, table)
        for key, entry in entries.items():
            if key not in have and entry is not None:
                have[key] = entry
            elif have.get(key) != entry:
                raise ValueError(f"the frozen copy's {table}[{key!r}] is {have.get(key)!r}; "
                                 f"configuration {config['name']!r} states {entry!r}")


def check_garment_set(pkg: str, config: dict) -> None:
    """Raise, naming both sides, where package ``pkg``'s tables do not give
    the configuration's garment set (the harness never writes them)."""
    constants = importlib.import_module(f"{pkg}.config.constants")
    wrong = [f"{table}[{key!r}]: {pkg} gives {getattr(constants, table).get(key)!r}, "
             f"the configuration states {entry!r}"
             for table, entries in garment_set(config).items()
             for key, entry in entries.items() if getattr(constants, table).get(key) != entry]
    if wrong:
        raise ValueError(f"{pkg} does not give configuration {config['name']!r}'s garment set: "
                         + "; ".join(wrong))


def build(pkg: str, config: dict, traffic: dict, scene_dir: str, save_root: str, weights: dict,
          device, times: dict | None = None):
    """The dataset and the network of one cell from package ``pkg``: the
    configuration's garment set registered in the frozen copy's tables, its
    HOCON tree, the traffic's batch, pyramid, point
    radius, remesh cadence and loss block, ``weights`` in the networks and
    the scene's curves. ``save_root`` keeps the package's skinner cache
    for the scene (a cache that a killed run left unreadable is removed
    first). ``times``, where given, gets the seconds of the dataset
    (``dataset_s``) and of ``build_opt_net`` (``build_s``), each ending in a
    synchronize. Returns (dataset, network)."""
    if pkg == REF:
        register_garment_set(config)
    hocon = importlib.import_module(f"{pkg}.config")
    builder = importlib.import_module(f"{pkg}.core.builder")
    network = importlib.import_module(f"{pkg}.core.network")
    dataset = importlib.import_module(f"{pkg}.data.dataset")
    conf = hocon.ConfigFactory.parse_string(hocon_text(config["conf"]))
    G = len(config["garments"])
    times = {} if times is None else times
    t = time.perf_counter()
    ds, _ = dataset.get_dataset_and_loader(
        scene_dir, {"deformer": config["translator_condlen"] * (1 + G),
                    "render": config["render_condlen"]},
        traffic["batch"], shuffle=False, garment_type=config["garment_type"], data_type="synthe")
    times["dataset_s"] = time.perf_counter() - t
    _drop_unreadable(save_root)
    pyr = builder.resolution_pyramids(traffic["pyramid"])
    caps = {**builder.scene_caps((ds.W, ds.H), pyr), **traffic.get("caps", {})}
    cfg = network.TrainConfig(sample_pix=traffic["sample_pix"],
                              point_radius=traffic["point_radius"],
                              remesh_intersect=traffic["remesh_intersect"], **caps)
    t = time.perf_counter()
    net = builder.build_opt_net(conf, ds, save_root, resolutions=pyr,
                                skinner_res=tuple(config["skinner_res"]), train_cfg=cfg,
                                device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times["build_s"] = time.perf_counter() - t
    net.conf.set_loss_block(conf.get_config(traffic["loss_block"]))
    net.isfine = bool(traffic["isfine"])
    load_weights(net, weights)
    net.align_fl(*scene.curves(config))
    return ds, net


def _drop_unreadable(save_root: str) -> None:
    if not osp.isdir(save_root):
        return
    for name in os.listdir(save_root):
        if name.endswith(".npz"):
            path = osp.join(save_root, name)
            try:                     # a file cut short has no central directory
                zipfile.ZipFile(path).close()
            except (OSError, zipfile.BadZipFile):
                os.remove(path)


def frame_batches(seed: int, n_frames: int, batch: int):
    """Endless batches of frame indices: epochs of the scene's frames, each
    in an order drawn from the seed."""
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(n_frames)
        for s in range(0, n_frames - batch + 1, batch):
            yield [int(f) for f in perm[s:s + batch]]


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def first_gradients(net) -> dict:
    """{leaf: norm of its first gradient} as the optimizers hold it after one
    step: Adam's and AdamW's first moment over 1 − β1, SGD's momentum."""
    out = {}
    for name, p in net.global_leaves().items():
        st = net.global_opt.state.get(p, {})
        out[name] = st["exp_avg"] / (1.0 - 0.9) if "exp_avg" in st else torch.zeros_like(p)
    for name, p in zip(("curves.scale", "curves.nx_scale"), net.curve_leaves()):
        out[name] = net.curve_opt.state[p]["exp_avg"] / (1.0 - 0.9)
    for i, v in enumerate(net.mesh.garment_vs):
        out[f"verts.{i}"] = net.vert_opt.state[v]["momentum_buffer"]
    return _norms(out)


def state_leaves(net) -> dict:
    """{leaf: tensor} of the state the steps update: the global leaves, the
    curve leaves and the garment vertex buffers."""
    out = dict(net.global_leaves())
    out.update(zip(("curves.scale", "curves.nx_scale"), net.curve_leaves()))
    if net.mesh is not None:
        out.update({f"verts.{i}": v for i, v in enumerate(net.mesh.garment_vs)})
    return out


def step_readings(net, info: dict) -> dict:
    """The losses and the converged rays of one step."""
    out = {k: float(info[k]) for k in LOSSES if k in info}
    for g in net.statics.garment_names:
        out[f"{g}_rayConv"] = float(info[f"{g}_rayConv"])
        out[f"{g}_rayBudget"] = float(info[f"{g}_rayBudget"])
    return out


def check_steps(net, ds, batches: list, ratio: dict, generator, step_fn=None) -> dict:
    """Run the first training steps on ``batches`` and read what the
    comparison needs: each step's losses and converged rays, each leaf's
    first gradient, each leaf's change over all the steps (the garment
    vertices from the remesh of the first step) and the remeshed meshes'
    sizes. ``step_fn(net, batch, fids, ratio, generator, timer)`` runs one
    step (default ``net.train_step``)."""
    step_fn = step_fn or (lambda n, b, f, r, g, t: n.train_step(b, f, r, generator=g, timer=t))
    start = {k: v.detach().clone() for k, v in state_leaves(net).items()}
    rec = {"steps": [], "mesh": None}

    def hook(name):
        if name == "remesh" and rec["mesh"] is None:
            m = net.mesh
            rec["mesh"] = {"verts": list(m.garment_n), "faces": list(m.garment_fn)}
            start.update({f"verts.{i}": v.detach().clone() for i, v in enumerate(m.garment_vs)})

    for k, fids in enumerate(batches):
        batch = ds.get_batch(fids)
        _, info = step_fn(net, batch, fids, ratio, generator, hook)
        rec["steps"].append(step_readings(net, info))
        if k == 0:
            rec["grad1"] = first_gradients(net)
    now = state_leaves(net)
    rec["change"] = _norms({k: now[k].detach() - start[k] for k in now})
    return rec
