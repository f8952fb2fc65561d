"""Parity of the port's forward training-step slice with the JAX package on
one tiny synthetic scene (2 frames, 48 px, skinner field (17, 25, 9)).

Both networks are built on the JAX generator's scene with caps large
enough that nothing overflows; the JAX weights cross into the port
through ``bridge.py``. Each phase is compared on identical inputs: after
the remesh comparison the port takes the JAX meshes, and the solve and
colour phases take the JAX ray batch.

On the CPU the JAX package renders with its XLA backends (subtile
compositing, dense mesh raster), the port with the Pallas semantics; the
two agree to rounding while no cap overflows.

The translator's last layer is zeroed in both networks, so the
deformation is the f32 LBS in both: the translator runs with bf16
operands in both packages, and two bf16 evaluations differ by more than
the seeds' and solves' tolerances below (``tests/test_torch_train.py``
holds the translator itself). The garment SDF's
geometric init is moved to a sphere of radius about 0.3 in both
(``data/synthetic.py`` ``GARMENT_SDF_BIAS``): the default sphere is cut
open by the seg3d box and leaves no rays.

Tolerances (float32): generated masks agree on ≥ 99.5% of pixels;
meshes as vertex sets within 1e-5 (nearest neighbour both ways); soft
masks within 5e-5 absolute (a 0.6-px splat changes by up to 3.3 per
pixel of motion, and the two deformations differ by ~1e-6 px per point);
losses within 1e-5; seeds within 1e-5 on the pixels both sample (≥ 99% of
them: edge pixels can flip between the two rasterizers); on rays both
solves converge (≥ 99% agreement on which), solved points within 1e-4
for ≥ 90% of them and within 1e-3 for all. The solver stops anywhere in
the region |sdf| < 5e-5 and angle < the camera's sub-pixel bound (0.3° at
48 px, about 1e-2 across at the camera's 2.6 distance), so trajectories
that differ by rounding can stop at different points of it.
"""

import os
import sys

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax
import jax.numpy as jnp

from recmv_tpu_torch import bridge
from recmv_tpu_torch.data.synthetic import GARMENT_SDF_BIAS, shrink_garment_init

ROOT = os.path.join(os.path.dirname(__file__), "..")
RATIO = {"sdfRatio": 1.0, "deformerRatio": 0.5, "renderRatio": 1.0}
FIDS = [0, 1]


def _train_cfg(cls, **extra):
    return cls(sample_pix=64, point_radius=0.025, remesh_intersect=8,
               mc_capacity_v=1 << 12, mc_capacity_f=1 << 13,
               raster_tile=16, raster_cap_mesh=4096, raster_cap_points=4096,
               solver_times=20, **extra)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    from recmv_tpu.data.synthetic import generate_scene as jgen
    from recmv_tpu_torch.data.synthetic import generate_scene

    root = tmp_path_factory.mktemp("torch_slice")
    kw = dict(n_frames=2, image_size=48, skinner_res=(17, 25, 9))
    return jgen(str(root / "jax"), **kw), generate_scene(str(root / "port"), device="cpu", **kw)


def test_generated_scenes_agree(scenes):
    from recmv_tpu_torch.data.image import imread

    jdir, tdir = scenes
    for fid in FIDS:
        for sub in ("masks", "imgs"):
            a = imread(os.path.join(jdir, sub, f"{fid}.png"))
            b = imread(os.path.join(tdir, sub, f"{fid}.png"))
            frac = np.mean(np.all(a == b, axis=-1))
            assert frac >= 0.995, (sub, fid, frac)
        pa = np.load(os.path.join(jdir, "parsing_SCH_ATR", f"{fid}.npy"))
        pb = np.load(os.path.join(tdir, "parsing_SCH_ATR", f"{fid}.npy"))
        assert np.mean(pa == pb) >= 0.995


def test_png_reader_matches_opencv(tmp_path):
    import cv2

    from recmv_tpu_torch.data.image import imread
    from recmv_tpu_torch.data.png import imwrite

    rng = np.random.RandomState(0)
    img = (rng.rand(37, 29, 3) * 255).astype(np.uint8)
    img[:10] = 7                                   # flat rows: encoders pick other filters
    p = str(tmp_path / "a.png")
    cv2.imwrite(p, img)
    np.testing.assert_array_equal(imread(p), cv2.imread(p))
    q = str(tmp_path / "b.png")
    imwrite(q, img)
    np.testing.assert_array_equal(cv2.imread(q), img)
    imwrite(q, img[..., 0])
    np.testing.assert_array_equal(cv2.imread(q), cv2.imread(q, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(imread(q)[..., 1], img[..., 0])


@pytest.fixture(scope="module")
def nets(scenes, tmp_path_factory):
    from recmv_tpu.config import ConfigFactory as JConf
    from recmv_tpu.core.builder import build_opt_net as jbuild
    from recmv_tpu.core.network import TrainConfig as JCfg
    from recmv_tpu.data.dataset import get_dataset_and_loader as jdata
    from recmv_tpu_torch.config import ConfigFactory
    from recmv_tpu_torch.core.builder import build_opt_net
    from recmv_tpu_torch.core.network import TrainConfig
    from recmv_tpu_torch.data.dataset import get_dataset_and_loader

    jdir, _ = scenes
    conf_path = os.path.join(ROOT, "configs", "synthetic", "smoke.conf")
    args = ({"deformer": 256, "render": 256}, 2)
    kw = dict(shuffle=False, garment_type="synthetic-tube", data_type="synthe")
    pyr = ((7, 9, 5), (13, 17, 9))
    out = tmp_path_factory.mktemp("torch_slice_nets")
    ds_j, _ = jdata(jdir, *args, **kw)
    net_j = jbuild(JConf.parse_file(conf_path), ds_j, str(out / "jax"), resolutions=pyr,
                   skinner_res=(17, 25, 9), train_cfg=_train_cfg(JCfg, batch_size=2,
                                                            image_size=(48, 48),
                                                            points_per_pixel=4,
                                                            surface_sample=64))
    ds_t, _ = get_dataset_and_loader(jdir, *args, **kw)
    net_t = build_opt_net(ConfigFactory.parse_file(conf_path), ds_t, str(out / "port"),
                          resolutions=pyr, skinner_res=(17, 25, 9),
                          train_cfg=_train_cfg(TrainConfig), device="cpu")

    tr = net_j.params["translator"]
    last = f"lin{len(tr) - 1}"
    tr[last] = {k: jnp.zeros_like(v) for k, v in tr[last].items()}
    gsdf = net_j.params["garment_sdfs"][0]
    last = f"lin{len(gsdf) - 1}"
    gsdf[last] = dict(gsdf[last], b=gsdf[last]["b"].at[0].set(GARMENT_SDF_BIAS))
    bridge.load_jax_params(net_t.params, jax.tree_util.tree_map(
        np.asarray, {k: net_j.params[k] for k in
                     ("sdf", "garment_sdfs", "translator", "render", "skinner")}))
    net_j.marching_cube_update(RATIO)
    net_t.marching_cube_update(RATIO)
    batch_j = ds_j.get_batch(FIDS)
    batch_t = ds_t.get_batch(FIDS)
    return net_j, net_t, batch_j, batch_t


def test_dataset_and_scene_params_match(nets):
    net_j, net_t, batch_j, batch_t = nets
    assert set(batch_j) == set(batch_t)
    for k in batch_j:
        np.testing.assert_array_equal(batch_t[k], batch_j[k], err_msg=k)
    ref = jax.tree_util.tree_map(np.asarray, net_j.scene_tree())
    got = bridge.scene_to_numpy(net_t.scene)
    for k in ("poses", "trans", "shape"):
        np.testing.assert_array_equal(got[k], ref[k])
    for group in ("conds", "camera"):
        for k in ref[group]:
            np.testing.assert_array_equal(got[group][k], ref[group][k])


def test_marching_cube_update_meshes(nets):
    net_j, net_t, _, _ = nets
    assert net_t.mesh.garment_n == [int(n) for n in net_j.mesh.garment_n]
    assert net_t.mesh.garment_fn == [int(n) for n in net_j.mesh.garment_fn]
    for gi, n in enumerate(net_t.mesh.garment_n):
        assert n > 50
        assert net_t.mesh.garment_vs[gi].shape[0] == net_j.mesh.garment_vs[gi].shape[0]
        a = np.asarray(net_j.mesh.garment_vs[gi])[:n]
        b = net_t.mesh.garment_vs[gi][:n].numpy()
        assert cKDTree(a).query(b)[0].max() <= 1e-5
        assert cKDTree(b).query(a)[0].max() <= 1e-5


def _share_jax_mesh(net_j, net_t):
    net_t.mesh.garment_vs = [torch.tensor(np.asarray(v)) for v in net_j.mesh.garment_vs]
    net_t.mesh.garment_fs = [torch.tensor(np.asarray(f)).long() for f in net_j.mesh.garment_fs]


@pytest.fixture(scope="module")
def phases(nets):
    """Run each phase of the forward step in both packages on the JAX
    meshes; the solve and colour phases on the JAX ray batch."""
    net_j, net_t, batch_j, _ = nets
    _share_jax_mesh(net_j, net_t)
    fids_j = jnp.asarray(FIDS, jnp.int32)
    fids_t = torch.tensor(FIDS)
    gparams = net_j._global_params()
    gt_j = net_j.garment_masks_from_batch(batch_j)
    counts_j = jnp.asarray(net_j.mesh.garment_n, jnp.int32)
    vs_j, fs_j = tuple(net_j.mesh.garment_vs), tuple(net_j.mesh.garment_fs)
    dev = net_t.device_batch(batch_j)
    gt_t = [dev[k] for k in net_t._garment_mask_keys()]
    counts_t = torch.as_tensor(net_t.mesh.garment_n)

    pc_j = net_j.pc_branch_loss(vs_j, gparams, fids_j, gt_j, RATIO, counts_j)
    with torch.no_grad():
        pc_t = net_t.pc_branch_loss(net_t.mesh.garment_vs, fids_t, gt_t, RATIO, counts_t)

    key = jax.random.PRNGKey(0)
    rays_j, _ = net_j.find_and_sample_rays(gparams, fids_j, gt_j, RATIO, key, vs_j, fs_j,
                                           def_vs=pc_j[1][2])
    s = net_t.cfg.seed_downscale
    n_pix = len(FIDS) * (48 // s) ** 2
    uniforms = []
    for _ in rays_j:                       # the JAX draws: network.py find_and_sample_rays
        key, sub = jax.random.split(key)
        uniforms.append(torch.tensor(np.asarray(jax.random.uniform(sub, (n_pix,)))))
    with torch.no_grad():
        rays_t = net_t.find_and_sample_rays(fids_t, gt_t, RATIO, net_t.mesh.garment_vs,
                                            net_t.mesh.garment_fs, def_vs=pc_t[1][2],
                                            uniforms=uniforms)

    from recmv_tpu.models.camera import ang_threshold
    net_j.ang_thred = ang_threshold(net_j._camera(net_j.scene_tree()))
    solved_j = net_j.solve_surface_points(gparams, rays_j, fids_j, RATIO)
    rays_from_j = [{k: torch.tensor(np.asarray(v)) for k, v in rd.items()} for rd in rays_j]
    for rd in rays_from_j:
        rd["batch_inds"] = rd["batch_inds"].long()
    with torch.no_grad():
        solved_t = net_t.solve_surface_points(rays_from_j, fids_t, RATIO)
    solved_from_j = [{k: torch.tensor(np.asarray(v)) for k, v in sd.items()} for sd in solved_j]
    for sd in solved_from_j:
        for k in ("batch_inds", "rows", "cols"):
            sd[k] = sd[k].long()
    return dict(pc=(pc_j, pc_t), rays=(rays_j, rays_t), solved=(solved_j, solved_t),
                solved_from_j=solved_from_j, dev=dev, gparams=gparams, fids_j=fids_j)


def test_pc_branch_loss(phases):
    (loss_j, (info_j, masks_j, _)), (loss_t, (info_t, masks_t, _)) = phases["pc"]
    assert float(np.asarray(masks_j).max()) > 0.5
    np.testing.assert_allclose(masks_t.numpy(), np.asarray(masks_j), atol=5e-5)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=1e-5)
    for k, v in info_j.items():
        np.testing.assert_allclose(float(info_t[k]), float(v), atol=1e-5, err_msg=k)


class _GateConf:
    """A config view with ``pc_weight.occlusion_gate`` switched on."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, k):
        return getattr(self._inner, k)

    def get_float(self, path, default=None):
        if path == "pc_weight.occlusion_gate":
            return 1.0
        return self._inner.get_float(path, default)


def test_pc_branch_loss_occlusion_gate(phases, nets):
    """With the gate on, the JAX package scores the IoU through the packed
    [pooled, keep] planes of its device batch; the port takes the body
    mask directly. Same losses, and the gate changes them."""
    net_j, net_t, batch_j, _ = nets
    (_, (info_off, _, _)), _ = phases["pc"]
    fids_j = phases["fids_j"]
    counts_j = jnp.asarray(net_j.mesh.garment_n, jnp.int32)
    dev = phases["dev"]
    confs = net_j.conf, net_t.conf
    net_j.conf, net_t.conf = _GateConf(net_j.conf), _GateConf(net_t.conf)
    try:
        dev_j = net_j._device_batch(batch_j, fids_j)
        pooled = [dev_j[k + "__pooled"] for k in net_j._garment_mask_keys()]
        assert float(jnp.min(pooled[0][..., 1])) == 0.0          # the gate drops pixels
        _, (info_j, _, _) = net_j.pc_branch_loss(
            tuple(net_j.mesh.garment_vs), phases["gparams"], fids_j,
            net_j.garment_masks_from_batch(batch_j), RATIO, counts_j, pooled)
        with torch.no_grad():
            _, (info_t, _, _) = net_t.pc_branch_loss(
                net_t.mesh.garment_vs, torch.tensor(FIDS),
                [dev[k] for k in net_t._garment_mask_keys()], RATIO,
                torch.as_tensor(net_t.mesh.garment_n), body_mask=dev["body"])
    finally:
        net_j.conf, net_t.conf = confs
    for k, v in info_j.items():
        np.testing.assert_allclose(float(info_t[k]), float(v), atol=1e-5, err_msg=k)
    assert abs(float(info_j["tube_mask_loss"]) - float(info_off["tube_mask_loss"])) > 1e-4


def test_find_and_sample_rays(phases):
    rays_j, rays_t = phases["rays"]
    for rj, rt in zip(rays_j, rays_t):
        vj = np.asarray(rj["valid"])
        assert vj.sum() > 10

        def table(r, valid):
            keys = zip(*(np.asarray(r[k])[valid].tolist() for k in ("batch_inds", "rows", "cols")))
            return {k: i for i, k in enumerate(keys)}

        tj = table(rj, vj)
        tt = table({k: v.numpy() for k, v in rt.items()}, rt["valid"].numpy())
        common = sorted(set(tj) & set(tt))
        assert len(common) >= 0.99 * max(len(tj), len(tt))
        ij = [tj[k] for k in common]
        it = [tt[k] for k in common]
        for k in ("init_pts", "rays"):
            a = np.asarray(rj[k])[vj][ij]
            b = rt[k].numpy()[rt["valid"].numpy()][it]
            np.testing.assert_allclose(b, a, atol=1e-5, err_msg=k)


def test_solve_surface_points(phases):
    solved_j, solved_t = phases["solved"]
    for sj, st in zip(solved_j, solved_t):
        cj = np.asarray(sj["conv"])
        ct = st["conv"].numpy()
        assert cj.sum() > 10
        assert np.mean(cj == ct) >= 0.99
        both = cj & ct
        d = np.abs(st["pts"].numpy()[both] - np.asarray(sj["pts"])[both]).max(-1)
        assert np.mean(d <= 1e-4) >= 0.9, np.sort(d)[-5:]
        assert d.max() <= 1e-3


def test_idr_color_loss(phases, nets):
    """The ③ colour block against the same computation assembled from the
    JAX package's functions (``core/network.py`` main_loss, colour part;
    the implicit adjoint is the identity in the forward pass)."""
    from recmv_tpu.core import losses as JL
    from recmv_tpu.models.deformer import cardinal_rays_from_jac, deformer_jacobian
    from recmv_tpu.models.garment_model import make_deform_fn, split_deform_conds
    from recmv_tpu.models.render_net import render_net_apply
    from recmv_tpu.models.sdf import sdf_apply, sdf_gradient

    net_j, net_t, batch_j, _ = nets
    solved_j, _ = phases["solved"]
    gp, fids = phases["gparams"], phases["fids_j"]
    scene = gp["scene"]
    conds = split_deform_conds(scene["conds"]["deformer"][fids], 1)
    imgs = jnp.asarray(batch_j["img"])
    cw = float(net_t.conf.get_float("color_weight"))
    total_ref = 0.0
    for gi, sd in enumerate(solved_j):
        deform = make_deform_fn({"translator": gp["translator"],
                                 "skinner": net_j.params["skinner"]}, net_j.statics,
                                conds[gi + 1], scene["poses"][fids], scene["trans"][fids],
                                RATIO["deformerRatio"], batch_inds=sd["batch_inds"])
        gsdf = gp["garment_sdfs"][gi]
        st = net_j.statics
        _, feat = sdf_apply(gsdf, st.garment_sdf, sd["pts"], 1.0)
        nx = sdf_gradient(gsdf, st.garment_sdf, sd["pts"], 1.0)
        nx = nx / jnp.clip(jnp.linalg.norm(nx, axis=-1, keepdims=True), 1e-9, None)
        crays, _ = cardinal_rays_from_jac(deformer_jacobian(deform, sd["pts"]), sd["rays"])
        colors = render_net_apply(gp["render"], st.render, sd["pts"], nx, crays, feat, ratio=1.0)
        gt = imgs[sd["batch_inds"], sd["rows"], sd["cols"]]
        total_ref += cw * float(JL.color_loss(colors, gt, sd["batch_inds"], sd["conv"], 2))
    with torch.no_grad():
        total, info = net_t.idr_color_loss(phases["solved_from_j"], torch.tensor(FIDS),
                                           phases["dev"], RATIO)
    assert total_ref > 0
    np.testing.assert_allclose(float(total), total_ref, atol=1e-5, rtol=1e-4)


def test_port_forward_step_on_port_scene(scenes, tmp_path):
    """The port alone, end to end on its own scene: scene → dataset →
    builder → remesh → forward_step, with finite outputs and live rays."""
    from recmv_tpu_torch.config import ConfigFactory
    from recmv_tpu_torch.core.builder import build_opt_net
    from recmv_tpu_torch.core.network import TrainConfig
    from recmv_tpu_torch.data.dataset import get_dataset_and_loader

    _, tdir = scenes
    ds, _ = get_dataset_and_loader(tdir, {"deformer": 256, "render": 256}, 2, shuffle=False,
                                   garment_type="synthetic-tube", data_type="synthe")
    net = build_opt_net(ConfigFactory.parse_file(os.path.join(ROOT, "configs", "synthetic",
                                                              "smoke.conf")),
                        ds, str(tmp_path / "result"), resolutions=((7, 9, 5), (13, 17, 9)),
                        skinner_res=(17, 25, 9), train_cfg=_train_cfg(TrainConfig),
                        device="cpu")
    shrink_garment_init(net.params)
    info, solved = net.forward_step(ds.get_batch(FIDS), FIDS, RATIO,
                                    generator=torch.Generator().manual_seed(0))
    assert all(np.isfinite(v) for v in info.values()), info
    assert net.mesh.garment_n[0] > 50
    assert 0.0 < info["tube_mask_loss"] <= 1.0
    assert solved[0]["pts"].shape == (2 * 64, 3)
    assert info["tube_rayConv"] > 0 and info["tube_color_loss"] > 0


def test_get_smpl_searches_only_the_given_directory(tmp_path, monkeypatch):
    """An asset beside the working directory (the JAX loader's ``../SMPL/``
    default) is never looked at; one in ``smpl_dir`` or $SMPL_DATA_DIR is
    loaded."""
    from recmv_tpu_torch.models.smpl import get_smpl, synthetic_body_model

    body = synthetic_body_model(n_subdiv=16)
    (tmp_path / "SMPL").mkdir()
    np.savez(tmp_path / "SMPL" / "SMPL_NEUTRAL.npz", v_template=body.v_template,
             shapedirs=body.shapedirs, J_regressor=body.J_regressor, weights=body.weights,
             parents=body.parents, f=body.faces)
    (tmp_path / "work").mkdir()
    monkeypatch.chdir(tmp_path / "work")
    monkeypatch.delenv("SMPL_DATA_DIR", raising=False)
    assert get_smpl("neutral").gender == "synthetic"
    assert get_smpl("neutral").num_verts != body.num_verts
    model = get_smpl("neutral", str(tmp_path / "SMPL"))
    assert model.gender == "neutral" and model.num_verts == body.num_verts
    monkeypatch.setenv("SMPL_DATA_DIR", str(tmp_path / "SMPL"))
    assert get_smpl("neutral").gender == "neutral"


_ACCESSED = None          # paths touched while a test records them
_AUDITED = {"open", "os.listdir", "os.scandir", "glob.glob", "os.mkdir", "os.remove",
            "os.rename", "os.chmod"}


def _audit(event, args):
    if _ACCESSED is not None and event in _AUDITED and args \
            and isinstance(args[0], (str, bytes, os.PathLike)):
        _ACCESSED.append(os.path.abspath(os.fsdecode(args[0])))


sys.addaudithook(_audit)                  # records only while _ACCESSED is a list


def test_build_opt_net_stays_inside_checkout(scenes, tmp_path, monkeypatch):
    """Run from the checkout's root with no SMPL directory set,
    ``build_opt_net`` touches only the checkout, the scene and its save
    root: nothing in the directory around the checkout."""
    global _ACCESSED
    from recmv_tpu_torch.config import ConfigFactory
    from recmv_tpu_torch.core.builder import build_opt_net
    from recmv_tpu_torch.core.network import TrainConfig
    from recmv_tpu_torch.data.dataset import get_dataset_and_loader

    _, tdir = scenes
    root = os.path.abspath(ROOT)
    monkeypatch.chdir(root)
    monkeypatch.delenv("SMPL_DATA_DIR", raising=False)
    conf = ConfigFactory.parse_file(os.path.join(root, "configs", "synthetic", "smoke.conf"))

    def build(save_root):
        ds, _ = get_dataset_and_loader(tdir, {"deformer": 256, "render": 256}, 2,
                                       shuffle=False, garment_type="synthetic-tube",
                                       data_type="synthe")
        build_opt_net(conf, ds, save_root, resolutions=((7, 9, 5), (13, 17, 9)),
                      skinner_res=(17, 25, 9), train_cfg=_train_cfg(TrainConfig),
                      device="cpu")

    build(str(tmp_path / "warm"))             # lazy imports happen here, unrecorded
    stat = os.stat
    accessed = []

    def recording_stat(path, *args, **kw):
        accessed.append(os.path.abspath(os.fsdecode(path)))
        return stat(path, *args, **kw)

    monkeypatch.setattr(os, "stat", recording_stat)
    _ACCESSED = accessed
    try:
        build(str(tmp_path / "result"))
    finally:
        _ACCESSED = None
        monkeypatch.setattr(os, "stat", stat)
    allowed = [os.path.realpath(p) for p in (root, tdir, tmp_path)]
    outside = sorted({p for p in accessed if not any(
        os.path.realpath(p) == a or os.path.realpath(p).startswith(a + os.sep)
        for a in allowed)})
    assert accessed and not outside, outside


def test_dataset_refuses_tcmr_joints(scenes, tmp_path):
    """A scene's TCMR 2D joints feed the beta pre-fit: a file the dataset
    cannot read raises rather than being ignored (the JAX dataset skips
    it silently), and a readable one is loaded."""
    import pickle
    import shutil

    from recmv_tpu_torch.data.dataset import get_dataset_and_loader

    scene = shutil.copytree(scenes[1], str(tmp_path / "scene"))
    path = os.path.join(scene, "synthetic-tube_tcmr_output.pkl")
    open(path, "wb").close()
    with pytest.raises(EOFError):
        get_dataset_and_loader(scene, {"deformer": 256}, 2, garment_type="synthetic-tube",
                               data_type="synthe")
    joints = np.ones((2, 17, 3), np.float32)
    with open(path, "wb") as f:
        pickle.dump({1: {"frame_ids": np.arange(2), "gt_joints2d": joints,
                         "pose": np.zeros((2, 72), np.float32),
                         "betas": np.zeros((2, 10), np.float32)}}, f)
    ds, _ = get_dataset_and_loader(scene, {"deformer": 256}, 2, garment_type="synthetic-tube",
                                   data_type="synthe")
    assert sorted(ds.gt_joints2d) == [0, 1] and ds.tcmr_frame_ids == [0, 1]
    np.testing.assert_array_equal(ds.gt_joints2d[1], joints[1])
