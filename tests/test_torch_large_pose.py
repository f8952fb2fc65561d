"""Parity of the port's body priors and large-pose stage with the JAX
package, on the CPU: the TCMR reader, ``LargePoseDataset``, ``load_smpl``,
the beta pre-fit and the builder that runs it, one large-pose
``train_step``, and both training CLIs.

(a) the TCMR reader (``utils/pickle_compat``) on a ``joblib.dump`` file, in a
    subprocess where ``import joblib``, ``jax``, ``recmv_tpu`` and ``cv2``
    fail: the same bits as ``joblib.load``; a plain pickle reads; a
    compressed dump raises;
(b) ``LargePoseDataset`` against the JAX one on ``tests/test_data.py``'s
    layout (its ``large_pose_scene``, made by the port's generator), for
    ``a_pose`` True and False: ranges, poses, shape and curve weights
    exact, translations
    within 1e-6 (the OneEuro filter in float64 on float32 inputs, as
    ``test_data.py`` holds it), zeroed ``fl_masks``, the curve-init subset;
(c) ``load_smpl`` on an ``.npz`` and a ``.pkl`` written from the synthetic
    body with seeded random ``posedirs`` and a sparse ``J_regressor``, and
    on a 6,890-vertex model: ``smpl_forward`` within 1e-5 absolute of JAX
    (float32 sums over 207 pose features and 6,890 vertices in another
    order), the skinner within ``test_torch_models``' 1e-5 / 1e-4;
(d) ``smpl_beta_optimizer`` on ``tests/test_beta_optimizer.py``'s synthetic
    joints of betas (1.5, −1.0) moved 3 px in x, 40 Adam steps: betas and
    ``extra_trans`` within 1e-4 of JAX (measured 2.1e-6); then
    ``build_opt_net`` with the
    joints (150 steps): the refined betas, the extra translation and the
    cached skinner's body vertices within 1e-4 of JAX's. The move: the
    scene is left-right symmetric, so with the joints at the scene's own
    translation the gradient of the x translation is rounding noise, and
    Adam's normalized steps turn its sign into ±lr moves (3.4e-4 apart
    after 10 steps, measured);
(e) one large-pose step in each package from one state
    (``test_torch_train._build_pair`` with curves, ``large_pose`` set on
    both): the info scalars, the loss and the Adam-updated leaves within
    ``test_torch_train``'s tolerances, every SDF leaf bit-equal in both,
    the curves and their optimizer untouched, no ``fl_*`` info;
(f) ``python -m recmv_tpu_torch.train`` then ``train_large_pose`` on a
    2-frame-annotated tiny scene: ``large_pose.ckpt`` holds the SDFs of
    ``latest.ckpt`` bit for bit and a moved translator.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recmv_tpu_torch import bridge
from test_torch_train import (RATIO, _assert_info_close, _build_pair, _jax_leaf, _main_draws,
                              _np_tree, _seed_uniforms)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONF = os.path.join(ROOT, "configs", "synthetic", "smoke.conf")
FIDS = [1, 4]
KEY = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tests run beside other pytest workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the TCMR reader without joblib
# ---------------------------------------------------------------------------

_READER = r"""
import pickle, sys
for m in ("joblib", "jax", "recmv_tpu", "cv2"):
    sys.modules[m] = None
from recmv_tpu_torch.utils.pickle_compat import CompressedDumpError, load_joblib

dump, plain, packed, out = sys.argv[1:]
res = {"dump": load_joblib(dump), "plain": load_joblib(plain)}
try:
    load_joblib(packed)
    res["packed"] = "read"
except CompressedDumpError as e:
    res["packed"] = str(e)
res["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in
                        ("joblib", "jax", "recmv_tpu", "cv2") and sys.modules[m] is not None)
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


def test_tcmr_reader_without_joblib(tmp_path):
    joblib = pytest.importorskip("joblib")
    rng = np.random.RandomState(0)
    fids = np.arange(8)
    rec = {1: {"frame_ids": fids,
               "gt_joints2d": np.concatenate([32 + 8 * rng.rand(8, 17, 2),
                                              np.ones((8, 17, 1))], -1).astype(np.float32),
               "pose": np.asfortranarray(rng.randn(8, 72).astype(np.float32)),
               "betas": 0.1 * rng.randn(8, 10).astype(np.float32)}}
    paths = [str(tmp_path / n) for n in ("dump.pkl", "plain.pkl", "packed.pkl", "out.pkl")]
    joblib.dump(rec, paths[0])
    with open(paths[1], "wb") as f:
        pickle.dump(rec, f)
    joblib.dump(rec, paths[2], compress=3)
    out = subprocess.run([sys.executable, "-c", _READER, *paths], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    with open(paths[3], "rb") as f:
        res = pickle.load(f)
    assert res["modules"] == []
    want = joblib.load(paths[0])[1]
    for kind in ("dump", "plain"):
        got = res[kind][1]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, (kind, k)
            np.testing.assert_array_equal(got[k], v, err_msg=f"{kind} {k}")
    assert "zlib-compressed" in res["packed"]


# ---------------------------------------------------------------------------
# (b) LargePoseDataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def large_pose_scene(tmp_path_factory):
    """``tests/test_data.py``'s large-pose scene, from the port's generator:
    8 frames at 64 px, feature-line JSONs on frames 0-3 only, a depth
    ramp 0 → 0.7 in the translation, and a joblib TCMR dump (poses +
    0.01·frame, seeded betas and joints)."""
    joblib = pytest.importorskip("joblib")
    from recmv_tpu_torch.data.synthetic import generate_scene

    out = generate_scene(str(tmp_path_factory.mktemp("lp") / "tube"), n_frames=8,
                         image_size=64, skinner_res=(17, 25, 9), device="cpu")
    for fid in range(4, 8):
        os.remove(os.path.join(out, "featurelines", f"{fid}.json"))
    data = dict(np.load(os.path.join(out, "smpl_rec.npz"), allow_pickle=True))
    trans = np.zeros((8, 3), np.float32)
    trans[:, 2] = np.linspace(0.0, 0.7, 8)
    data["trans"] = trans
    np.savez(os.path.join(out, "smpl_rec.npz"), **data)
    rng = np.random.RandomState(0)
    tc_pose = data["poses"].reshape(8, 72).astype(np.float32)
    tc_pose += 0.01 * np.arange(8, dtype=np.float32)[:, None]
    betas = 0.1 * rng.randn(8, 10).astype(np.float32)
    joints = 32 + 8 * rng.rand(8, 17, 2).astype(np.float32)
    gt_j = np.concatenate([joints, np.ones((8, 17, 1), np.float32)], -1)
    joblib.dump({1: {"frame_ids": np.arange(8), "gt_joints2d": gt_j, "pose": tc_pose,
                     "betas": betas}}, os.path.join(out, "synthetic-tube_tcmr_output.pkl"))
    return out


@pytest.mark.parametrize("a_pose", [True, False])
def test_large_pose_dataset_matches_jax(large_pose_scene, a_pose):
    from recmv_tpu.data.dataset import get_dataset_and_loader as jdata
    from recmv_tpu_torch.data.dataset import LargePoseDataset, get_dataset_and_loader

    kw = dict(garment_type="synthetic-tube", data_type="large_pose", a_pose=a_pose,
              shuffle=False)
    lens = {"deformer": 16}
    ds_j, _ = jdata(large_pose_scene, lens, 2, **kw)
    ds_t, _ = get_dataset_and_loader(large_pose_scene, lens, 2, **kw)
    assert isinstance(ds_t, LargePoseDataset) and ds_t.gt_joints2d is not None
    for k in ("start_idx", "frame_num", "a_pose_start", "a_pose_end", "fl_supervised",
              "tcmr_frame_ids", "fl_weights"):
        assert getattr(ds_t, k) == getattr(ds_j, k), k
    assert ds_t.start_idx == (0 if a_pose else 4) and ds_t.frame_num == 4
    for k in ("poses", "shape"):
        np.testing.assert_array_equal(getattr(ds_t.params, k), getattr(ds_j.params, k),
                                      err_msg=k)
    np.testing.assert_allclose(ds_t.params.trans, ds_j.params.trans, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ds_t.params.conds["deformer"], ds_j.params.conds["deformer"])
    assert sorted(ds_t.gt_joints2d) == sorted(ds_j.gt_joints2d)
    for f in ds_j.gt_joints2d:
        np.testing.assert_array_equal(ds_t.gt_joints2d[f], ds_j.gt_joints2d[f])
    frames = list(range(ds_t.frame_num))
    b_t, b_j = ds_t.get_batch(frames), ds_j.get_batch(frames)
    for k in ("fl_masks", "fl_pts", "mask", "upper_bottom"):
        np.testing.assert_array_equal(b_t[k], b_j[k], err_msg=k)
    assert bool(b_t["fl_masks"].any()) == a_pose
    init_t, init_j = ds_t.get_init_fl_dataset(), ds_j.get_init_fl_dataset()
    assert init_t.sampler_idx == init_j.sampler_idx == [0, 1, 2, 3]
    for i in range(len(init_j)):
        for k in ("fl_masks", "fl_pts"):
            np.testing.assert_array_equal(init_t[i][1][k], init_j[i][1][k])


# ---------------------------------------------------------------------------
# (c) load_smpl and a 6,890-vertex model
# ---------------------------------------------------------------------------

def _asset_arrays(n_verts=None):
    """The synthetic body as SMPL asset arrays, with seeded random posedirs
    and a sparse row-normalized J_regressor; ``n_verts`` tiles its
    vertices (with seeded jitter) up to that count."""
    import scipy.sparse as sp

    from recmv_tpu_torch.models.smpl import synthetic_body_model

    body = synthetic_body_model()
    rng = np.random.RandomState(4)
    idx = np.arange(n_verts or body.num_verts) % body.num_verts
    V = len(idx)
    v = body.v_template[idx] + (0.002 * rng.randn(V, 3) * (idx != np.arange(V))[:, None])
    jr = np.where(rng.rand(24, V) < 0.01, rng.rand(24, V), 0.0)
    jr[np.arange(24), rng.randint(0, V, 24)] += 1.0
    jr /= jr.sum(1, keepdims=True)
    return dict(v_template=v.astype(np.float64),
                shapedirs=np.concatenate([body.shapedirs[idx], 0.01 * rng.randn(V, 3, 6)], -1),
                posedirs=0.01 * rng.randn(V, 3, 207), J_regressor=sp.csc_matrix(jr),
                weights=body.weights[idx].astype(np.float64),
                kintree_table=np.stack([np.where(body.parents < 0, 4294967295,
                                                 body.parents).astype(np.uint32),
                                        np.arange(24, dtype=np.uint32)]),
                f=body.faces.astype(np.uint32))


def _write_assets(tmp_path):
    a = _asset_arrays()
    pkl_dir, npz_dir = tmp_path / "pkl", tmp_path / "npz"
    pkl_dir.mkdir()
    npz_dir.mkdir()
    with open(pkl_dir / "SMPL_NEUTRAL.pkl", "wb") as f:
        pickle.dump(a, f, protocol=2)
    np.savez(npz_dir / "smpl_neutral.npz", v_template=a["v_template"], shapedirs=a["shapedirs"],
             posedirs=a["posedirs"], J_regressor=a["J_regressor"].toarray(),
             weights=a["weights"], parents=a["kintree_table"][0].astype(np.int64),
             f=a["f"].astype(np.int64))
    return str(pkl_dir), str(npz_dir)


def _forward_both(model_j, model_t, seed=0):
    from recmv_tpu.models.smpl import smpl_forward as jfwd
    from recmv_tpu_torch.models.smpl import smpl_forward

    rng = np.random.RandomState(seed)
    betas = rng.randn(10).astype(np.float32)
    pose = (0.3 * rng.randn(3, 24, 3)).astype(np.float32)
    out_j = jfwd(model_j, jnp.asarray(betas), jnp.asarray(pose))
    out_t = smpl_forward(model_t, torch.tensor(betas), torch.tensor(pose))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    return out_t


def test_load_smpl_matches_jax(tmp_path, monkeypatch):
    from recmv_tpu.models.smpl import load_smpl as jload
    from recmv_tpu_torch.models.smpl import get_smpl, load_smpl, synthetic_body_model

    for d in _write_assets(tmp_path):
        m_j, m_t = jload("neutral", d), load_smpl("neutral", d)
        for k in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights", "parents",
                  "faces"):
            np.testing.assert_array_equal(getattr(m_t, k), getattr(m_j, k), err_msg=k)
        assert m_t.shapedirs.shape[-1] == 10 and m_t.parents[0] == -1
        _forward_both(m_j, m_t)
        assert get_smpl("neutral", d).num_verts == m_t.num_verts
        monkeypatch.setenv("SMPL_DATA_DIR", d)
        np.testing.assert_array_equal(get_smpl("neutral").posedirs, m_t.posedirs)
    monkeypatch.delenv("SMPL_DATA_DIR")
    assert get_smpl("neutral").gender == "synthetic"
    assert get_smpl("neutral").num_verts == synthetic_body_model().num_verts
    with pytest.raises(FileNotFoundError):
        load_smpl("neutral", str(tmp_path))


def test_smpl_and_skinner_take_6890_vertices(tmp_path):
    """A 6,890-vertex model (SMPL's count): ``smpl_forward`` with its
    posedirs and the skinner built from it, against JAX."""
    from recmv_tpu.models.skinner import initial_lbs_skinner as jinit
    from recmv_tpu.models.smpl import SMPLModel as JModel
    from recmv_tpu_torch.models.skinner import initial_lbs_skinner
    from recmv_tpu_torch.models.smpl import SMPL_PARENTS, SMPLModel

    a = _asset_arrays(6890)
    args = (a["v_template"], a["shapedirs"][:, :, :10], a["posedirs"],
            a["J_regressor"].toarray(), a["weights"], SMPL_PARENTS, a["f"])
    m_j, m_t = JModel(*args), SMPLModel(*args)
    assert m_t.num_verts == 6890
    verts = _forward_both(m_j, m_t, seed=1)[0]
    assert verts.shape == (3, 6890, 3)
    apose = np.zeros((24, 3), np.float32)
    apose[1, 2], apose[2, 2], apose[16, 2], apose[17, 2] = 0.17, -0.17, -0.79, 0.79
    betas = np.linspace(-0.5, 0.5, 10).astype(np.float32)
    sk_j, vs_j, _ = jinit(m_j, jnp.asarray(betas), apose, resolution=(9, 13, 7),
                          extra_trans=np.asarray([[0.01, -0.02, 0.03]], np.float32))
    sk_t, vs_t, _ = initial_lbs_skinner(m_t, torch.tensor(betas), apose, resolution=(9, 13, 7),
                                        extra_trans=np.asarray([[0.01, -0.02, 0.03]],
                                                               np.float32))
    np.testing.assert_allclose(vs_t.numpy(), np.asarray(vs_j), atol=1e-5, rtol=0)
    ref = bridge.skinner_to_numpy(bridge.skinner_from_jax(sk_j, device="cpu"))
    for k, v in bridge.skinner_to_numpy(sk_t).items():
        np.testing.assert_allclose(v, ref[k], atol=1e-5, rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# (d) the beta pre-fit and the builder that runs it
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def beta_scene(tmp_path_factory):
    """``tests/test_beta_optimizer.py``'s scene (4 frames at 64 px), from the
    port's generator."""
    from recmv_tpu_torch.data.synthetic import generate_scene

    return generate_scene(str(tmp_path_factory.mktemp("beta") / "tube"), n_frames=4,
                          image_size=64, skinner_res=(17, 25, 9), device="cpu")


def _datasets_with_joints(scene, lens, target):
    from recmv_tpu.data.dataset import SceneDataset as JDataset
    from recmv_tpu_torch.data.dataset import SceneDataset
    from test_beta_optimizer import _synthetic_gt_joints

    ds_j = JDataset(scene, conds_lens=lens, garment_type="synthetic-tube")
    ds_t = SceneDataset(scene, conds_lens=lens, garment_type="synthetic-tube")
    joints = _synthetic_gt_joints(ds_j, target)
    for v in joints.values():
        v[:, 0] += 3.0
    ds_j.gt_joints2d = joints
    ds_t.gt_joints2d = {k: v.copy() for k, v in joints.items()}
    return ds_j, ds_t


def test_beta_optimizer_matches_jax(beta_scene):
    from recmv_tpu.core.beta_optimizer import smpl_beta_optimizer as jfit
    from recmv_tpu.models.smpl import get_smpl as jget
    from recmv_tpu_torch.core.beta_optimizer import (fit_frames, reprojection_loss,
                                                     smpl_beta_optimizer)
    from recmv_tpu_torch.core.builder import apose_from_type
    from recmv_tpu_torch.models.smpl import get_smpl

    target = np.zeros(10, np.float32)
    target[0], target[1] = 1.5, -1.0
    ds_j, ds_t = _datasets_with_joints(beta_scene, {"deformer": 16}, target)
    model_t = get_smpl(ds_t.gender)
    b_j, t_j = jfit(jget(ds_j.gender), apose_from_type(0), ds_j, n_iters=40, lr=1e-2)
    b_t, t_t = smpl_beta_optimizer(model_t, apose_from_type(0), ds_t, n_iters=40, lr=1e-2,
                                   device="cpu")
    assert b_t.shape == (10,) and t_t.shape == (1, 3)
    np.testing.assert_allclose(b_t, b_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(t_t, t_j, atol=1e-4, rtol=0)
    frames = fit_frames(ds_t, device="cpu")
    e0 = float(reprojection_loss(model_t, torch.zeros(10), torch.zeros(1, 3), frames))
    e1 = float(reprojection_loss(model_t, torch.tensor(b_t), torch.tensor(t_t), frames))
    assert e1 < 0.5 * e0 and np.abs(b_t).max() > 0.05
    ds_t.gt_joints2d = None
    b0, t0 = smpl_beta_optimizer(model_t, apose_from_type(0), ds_t, device="cpu")
    np.testing.assert_array_equal(b0, ds_t.params.shape)
    assert not t0.any()


def test_builder_runs_the_beta_prefit(beta_scene, tmp_path):
    from recmv_tpu.config import ConfigFactory as JConf
    from recmv_tpu.core.builder import build_opt_net as jbuild
    from recmv_tpu.core.network import TrainConfig as JCfg
    from recmv_tpu_torch.config import ConfigFactory
    from recmv_tpu_torch.core.builder import build_opt_net
    from recmv_tpu_torch.core.network import TrainConfig
    from test_torch_train import _train_cfg

    target = np.zeros(10, np.float32)
    target[0], target[1] = 1.5, -1.0
    ds_j, ds_t = _datasets_with_joints(beta_scene, {"deformer": 256, "render": 256}, target)
    pyr = ((7, 9, 5), (13, 17, 9))
    jbuild(JConf.parse_file(CONF), ds_j, str(tmp_path / "jax"), resolutions=pyr,
           skinner_res=(17, 25, 9), train_cfg=_train_cfg(JCfg, batch_size=2,
                                                         image_size=(64, 64)))
    net = build_opt_net(ConfigFactory.parse_file(CONF), ds_t, str(tmp_path / "port"),
                        resolutions=pyr, skinner_res=(17, 25, 9),
                        train_cfg=_train_cfg(TrainConfig), device="cpu")
    assert abs(float(ds_t.params.shape[0])) > 0.05
    np.testing.assert_allclose(ds_t.params.shape, ds_j.params.shape, atol=1e-4, rtol=0)
    np.testing.assert_allclose(net.scene["shape"].detach().numpy(), ds_t.params.shape)
    c_j = np.load(str(tmp_path / "jax" / "initial_skinner_0.npz"))
    c_t = np.load(str(tmp_path / "port" / "initial_skinner_0.npz"))
    np.testing.assert_allclose(c_t["tmpBodyVs"], c_j["tmpBodyVs"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(c_t["extra_trans"], c_j["extra_trans"], atol=1e-4, rtol=0)
    assert np.abs(c_t["extra_trans"]).max() > 0


# ---------------------------------------------------------------------------
# (e) one large-pose training step
# ---------------------------------------------------------------------------

def test_large_pose_step_matches_jax(tmp_path):
    from recmv_tpu_torch.data.synthetic import generate_scene
    from test_torch_curves import _scene_curves

    scene = generate_scene(str(tmp_path / "scene"), n_frames=6, image_size=48,
                           skinner_res=(17, 25, 9), device="cpu")
    net_j, net_t, ds_j = _build_pair(tmp_path, scene)
    curves_in = _scene_curves()
    net_j.align_fl(*curves_in)
    net_t.align_fl(*curves_in)
    bridge.load_curves(net_t, _np_tree(net_j.params["curves"]), net_j.curve_statics)
    for net in (net_j, net_t):
        net.large_pose = True
        net._init_global_opt()
    net_j.on_phase_change()
    batch = ds_j.get_batch(FIDS)
    before_j = _np_tree(net_j._global_params())
    before_t = {k: v.detach().clone() for k, v in net_t.global_leaves().items()}
    curves_t = {k: v.detach().clone() for k, v in net_t.params["curves"].items()}
    curves_j = _np_tree(net_j.params["curves"])
    s = net_t.cfg.seed_downscale
    key = jax.random.PRNGKey(KEY)
    uniforms, key_m = _seed_uniforms(key, 1, len(FIDS) * (48 // s) ** 2)
    draws = {"uniforms": uniforms,
             "main": _main_draws(net_j, key_m, max(net_t.cfg.sample_pix, 1) * len(FIDS))}
    total_j, info_j = net_j.train_step(batch, FIDS, RATIO, key)
    grads = {}
    step = net_t.global_opt.step

    def keep():
        grads.update({id(p): p.grad.clone() for g in net_t.global_opt.param_groups
                      for p in g["params"]})
        return step()

    net_t.global_opt.step = keep
    total_t, info_t = net_t.train_step(batch, FIDS, RATIO, draws=draws)

    assert not [k for k in list(info_t) + list(info_j) if k.startswith("fl_")]
    assert "gnorm_fl" not in info_t and info_t["remeshed"] == 0.0
    _assert_info_close(info_t, info_j)
    np.testing.assert_allclose(total_t, total_j, rtol=1e-4)
    for k, v in net_t.params["curves"].items():
        assert torch.equal(v, curves_t[k]), k
        np.testing.assert_array_equal(np.asarray(net_j.params["curves"][k]), curves_j[k])
    assert len(net_t.curve_opt.state) == 0

    after_j = _np_tree(net_j._global_params())
    after_t = net_t.global_leaves()
    lr = float(net_t.global_opt.param_groups[0]["lr"])
    frozen = [n for n in after_t if n.startswith(("sdf.", "garment_sdfs."))]
    assert frozen and not any(net_t._trainable[n] for n in frozen)
    moved = 0
    for name in after_t:
        dj = _jax_leaf(after_j, name) - _jax_leaf(before_j, name)
        dt = (after_t[name].detach() - before_t[name]).numpy()
        if not net_t._trainable[name]:
            assert torch.equal(after_t[name].detach(), before_t[name]), name
            np.testing.assert_array_equal(_jax_leaf(after_j, name), _jax_leaf(before_j, name))
            continue
        g = grads[id(after_t[name])].abs().numpy()
        big = (g > 1e-3 * g.max()) & (np.abs(dj) > 0.5 * lr)
        np.testing.assert_allclose(dt[big], dj[big], atol=2e-2 * lr, rtol=0, err_msg=name)
        if name.startswith("translator"):
            moved += int(big.sum())
    assert moved > 1000


# ---------------------------------------------------------------------------
# (f) the two training CLIs
# ---------------------------------------------------------------------------

def test_cli_stages_on_a_large_pose_scene(tmp_path, capsys):
    """Stage 1 (``train``, ``data_type = large_pose``: the A-pose range,
    the beta pre-fit from the scene's TCMR joints) then stage 2
    (``train_large_pose --start-epoch 0``) on a 4-frame scene annotated on
    frames 0 and 1."""
    from recmv_tpu_torch import train, train_large_pose
    from recmv_tpu_torch.config import ConfigFactory, dump_config
    from recmv_tpu_torch.data.synthetic import generate_scene, make_large_pose_scene
    from recmv_tpu_torch.utils.checkpoint import read_checkpoint

    scene = generate_scene(str(tmp_path / "scene"), n_frames=4, image_size=48,
                           skinner_res=(17, 25, 9), device="cpu")
    target = np.zeros(10, np.float32)
    target[0], target[1] = 1.0, -0.5
    make_large_pose_scene(scene, 2, target, device="cpu")
    conf = ConfigFactory.parse_file(CONF)
    conf["train"]["data_type"] = "large_pose"
    conf_path = str(tmp_path / "large_pose.conf")
    with open(conf_path, "w") as f:
        f.write(dump_config(conf))
    common = ["--conf", conf_path, "--data-root", scene, "--device", "cpu", "--quality", "tiny"]
    with pytest.raises(FileNotFoundError, match="requires the a-pose fit"):
        train_large_pose.main(common + ["--start-epoch", "0"])
    net1 = train.main(common + ["--init-epochs", "4", "--fl-iters", "2", "--max-steps", "1"])
    assert net1.dataset.start_idx == 0 and net1.dataset.frame_num == 2
    assert abs(float(net1.dataset.params.shape[0])) > 0.01       # the pre-fit ran
    net2 = train_large_pose.main(common + ["--start-epoch", "0", "--max-steps", "1"])
    out = capsys.readouterr().out
    assert "[large-pose] ep0 step1" in out
    assert net2.large_pose and net2.dataset.start_idx == 2 and net2.opt_times == 2.0
    assert np.isfinite(net2.info["m_loss_total"]) and "fl_loss_total" not in net2.info
    save = os.path.join(scene, "result")
    a, b = (read_checkpoint(os.path.join(save, f)) for f in ("latest.ckpt", "large_pose.ckpt"))
    for k in ("sdf", "garment_sdfs"):
        for x, y in zip(jax.tree_util.tree_leaves(a["params"][k]),
                        jax.tree_util.tree_leaves(b["params"][k])):
            np.testing.assert_array_equal(x, y)
    assert any(np.abs(x - y).max() > 0 for x, y in
               zip(jax.tree_util.tree_leaves(a["params"]["translator"]),
                   jax.tree_util.tree_leaves(b["params"]["translator"])))
    for k, v in a["params"]["curves"].items():
        np.testing.assert_array_equal(b["params"]["curves"][k], v)
