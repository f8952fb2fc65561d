"""The port's counterpart of ``tests/test_ingestion.py``: scenes whose
inputs OpenCV and joblib read for the JAX package load in the port to the
same arrays, on the CPU.

(a) a fake PeopleSnapshot release with JPEG frames in its ``imgs/``
    (masks.hdf5, reconstructed_poses.hdf5, camera.pkl) goes through
    ``preprocess/people_snapshot_process.py`` (which needs ``cv2`` and
    ``h5py``); the port's and the JAX package's ``PeopleSnapshotDataset``
    load the result (each its own copy: the ATR propagation caches into
    the scene) and their batches are equal, key for key;
(b) a scene written by the JAX synthetic generator, its frames re-saved
    as JPEG (baseline 4:2:0, progressive 4:4:4, 4:2:2 with restart
    intervals, PIL's optimized tables), its masks as palette and 1-bit
    PNGs, its normals as 16-bit PNGs and a gzip-compressed TCMR dump
    beside it: both datasets' ``get_batch`` give equal arrays bit for bit
    (img, the masks, normals, ``gt_joints2d``), and one port training step
    on it (the beta pre-fit on the dump's joints included) is finite.
"""

import json
import os
import os.path as osp
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")
joblib = pytest.importorskip("joblib")

sys.path.insert(0, osp.join(osp.dirname(__file__), "torch_fixtures"))
import make_image_fixtures as mk  # noqa: E402

ROOT = osp.join(osp.dirname(__file__), "..")
N_FRAMES = 4
IMG = 48
GARMENT = "synthetic-tube"
CONDS = {"deformer": 256, "render": 256}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tests run beside other pytest workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    from recmv_tpu.data.synthetic import generate_scene

    return generate_scene(str(tmp_path_factory.mktemp("jax_scene") / "tube"), n_frames=N_FRAMES,
                          image_size=IMG, skinner_res=(17, 25, 9))


def _datasets(scene_j, scene_t, data_type):
    from recmv_tpu.data.dataset import get_dataset_and_loader as jload
    from recmv_tpu_torch.data.dataset import get_dataset_and_loader as tload

    ds_j, _ = jload(scene_j, CONDS, 2, shuffle=False, garment_type=GARMENT, data_type=data_type)
    ds_t, _ = tload(scene_t, CONDS, 2, shuffle=False, garment_type=GARMENT, data_type=data_type)
    return ds_j, ds_t


def _assert_batches_equal(ds_j, ds_t, must_have):
    fids = list(range(ds_j.frame_num))
    assert ds_t.frame_num == len(fids)
    assert [osp.basename(n) for n in ds_t.img_ns] == [osp.basename(n) for n in ds_j.img_ns]
    b_j, b_t = ds_j.get_batch(fids), ds_t.get_batch(fids)
    assert set(b_j) == set(b_t) and set(must_have) <= set(b_t), (sorted(b_j), sorted(b_t))
    for k in b_j:
        assert b_t[k].dtype == b_j[k].dtype, k
        np.testing.assert_array_equal(b_t[k], b_j[k], err_msg=k)
    return b_t


def test_people_snapshot_release_with_jpeg_frames(jax_scene, tmp_path):
    """(a): the release's JPEG frames through the preprocessing script,
    then both packages' datasets."""
    release = str(tmp_path / "release")
    os.makedirs(osp.join(release, "imgs"))
    masks = []
    for fid in range(N_FRAMES):
        img = cv2.imread(osp.join(jax_scene, "imgs", f"{fid}.png"))
        cv2.imwrite(osp.join(release, "imgs", f"{fid:04d}.jpg"), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        masks.append(cv2.imread(osp.join(jax_scene, "masks", f"{fid}.png"))[..., 0] > 0)
    rec = np.load(osp.join(jax_scene, "smpl_rec.npz"))
    cam = np.load(osp.join(jax_scene, "camera.npz"))
    with h5py.File(osp.join(release, "masks.hdf5"), "w") as f:
        f.create_dataset("masks", data=np.stack(masks).astype(np.uint8))
    with h5py.File(osp.join(release, "reconstructed_poses.hdf5"), "w") as f:
        f.create_dataset("pose", data=rec["poses"].reshape(N_FRAMES, 72).astype(np.float64))
        f.create_dataset("trans", data=rec["trans"].reshape(N_FRAMES, 3).astype(np.float64))
        f.create_dataset("betas", data=rec["shape"].reshape(-1).astype(np.float64))
    with open(osp.join(release, "camera.pkl"), "wb") as f:
        pickle.dump({"camera_f": np.asarray([cam["fx"], cam["fy"]]),
                     "camera_c": np.asarray([cam["cx"], cam["cy"]]),
                     "camera_t": np.asarray(cam["T"])}, f)

    sys.path.insert(0, osp.join(ROOT, "preprocess"))
    import people_snapshot_process as psp

    out = str(tmp_path / "ps")
    psp.main(["--snapshot-root", release, "--out", out, "--gender", "female"])
    # the raw ATR parsing (no propagated cache) and the curve annotations
    os.makedirs(osp.join(out, "parsing_SCH_ATR"))
    for fid in range(N_FRAMES):
        shutil.copy(osp.join(jax_scene, "parsing_SCH_ATR", f"{fid}.npy"),
                    osp.join(out, "parsing_SCH_ATR", f"{fid}.npy"))
    shutil.copytree(osp.join(jax_scene, "featurelines"), osp.join(out, "featurelines"))
    out_t = str(tmp_path / "ps_port")
    shutil.copytree(out, out_t)

    ds_j, ds_t = _datasets(out, out_t, "people_snap")
    b = _assert_batches_equal(ds_j, ds_t, ("img", "mask", "upper", "body"))
    # the frames are the release's JPEG pixels, as cv2 decoded them
    first = cv2.imread(osp.join(release, "imgs", "0000.jpg")).astype(np.float32)
    np.testing.assert_array_equal(b["img"][0], (first / 255.0 - 0.5) * 2.0)


@pytest.fixture(scope="module")
def jpeg_scene(jax_scene, tmp_path_factory):
    """(b)'s scene: JPEG frames in four modes, palette and 1-bit masks,
    16-bit normals, a gzip-compressed TCMR dump of the synthetic body's
    joints."""
    from PIL import Image

    from recmv_tpu_torch.data.synthetic import tcmr_record

    scene = str(tmp_path_factory.mktemp("jpeg_scene") / "tube")
    shutil.copytree(jax_scene, scene)
    modes = [[cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420],
             [cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
             [cv2.IMWRITE_JPEG_QUALITY, 70, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
             None]
    for fid in range(N_FRAMES):
        png_path = osp.join(scene, "imgs", f"{fid}.png")
        img = cv2.imread(png_path)
        os.remove(png_path)
        jpg = osp.join(scene, "imgs", f"{fid}.jpg")
        if modes[fid] is None:
            Image.fromarray(img[..., ::-1]).save(jpg, quality=85, optimize=True)
        else:
            cv2.imwrite(jpg, img, modes[fid])
        mask = cv2.imread(osp.join(scene, "masks", f"{fid}.png"))[..., 0] > 0
        data = (mk.encode_png(mask.astype(np.uint8), 3, 8, plte=[[0, 0, 0], [255, 255, 255]])
                if fid % 2 == 0 else mk.encode_png(mask.astype(np.uint8), 0, 1))
        with open(osp.join(scene, "masks", f"{fid}.png"), "wb") as f:
            f.write(data)
        normal = cv2.imread(osp.join(scene, "normals", f"{fid}.png"))
        with open(osp.join(scene, "normals", f"{fid}.png"), "wb") as f:
            f.write(mk.encode_png(normal[..., ::-1].astype(np.uint16) * 257 + 128, 2, 16,
                                  interlace=fid == 3))
    with open(osp.join(scene, "scene_meta.json")) as f:
        assert json.load(f)["n_frames"] == N_FRAMES
    joblib.dump(tcmr_record(scene, np.r_[0.5, -0.25, np.zeros(8)], device="cpu"),
                osp.join(scene, f"{GARMENT}_tcmr_output.pkl"), compress=("gzip", 3))
    port = scene + "_port"
    shutil.copytree(scene, port)
    return scene, port


def test_jpeg_scene_batches_equal(jpeg_scene):
    """(b): both datasets on the JPEG-framed scene, bit for bit."""
    scene_j, scene_t = jpeg_scene
    ds_j, ds_t = _datasets(scene_j, scene_t, "synthe")
    assert all(n.endswith(".jpg") for n in ds_t.img_ns)
    assert ds_t.gt_joints2d is not None and sorted(ds_t.gt_joints2d) == sorted(ds_j.gt_joints2d)
    _assert_batches_equal(ds_j, ds_t, ("img", "mask", "upper", "upper_bottom", "bottom", "body",
                                       "normal", "gt_joints2d"))


def test_jpeg_scene_trains_one_finite_step(jpeg_scene):
    """(b): the port builds its network on the scene (the beta pre-fit on
    the gzip dump's joints) and takes one finite training step."""
    from recmv_tpu_torch.config import ConfigFactory
    from recmv_tpu_torch.core.builder import build_opt_net
    from recmv_tpu_torch.core.network import TrainConfig
    from recmv_tpu_torch.data.dataset import get_dataset_and_loader
    from recmv_tpu_torch.data.synthetic import shrink_garment_init

    scene = jpeg_scene[1]
    ds, _ = get_dataset_and_loader(scene, CONDS, 2, shuffle=False, garment_type=GARMENT,
                                   data_type="synthe")
    conf = ConfigFactory.parse_file(osp.join(ROOT, "configs", "synthetic", "smoke.conf"))
    net = build_opt_net(conf, ds, osp.join(scene, "result"),
                        resolutions=((7, 9, 5), (13, 17, 9)), skinner_res=(17, 25, 9),
                        train_cfg=TrainConfig(sample_pix=64, raster_tile=16, surface_sample=64,
                                              solver_times=4, mc_capacity_v=1 << 12,
                                              mc_capacity_f=1 << 13),
                        device="cpu")
    shrink_garment_init(net.params)
    loss, info = net.train_step(ds.get_batch([0, 1]), [0, 1],
                                {"sdfRatio": 1.0, "deformerRatio": 0.5, "renderRatio": 1.0},
                                generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss)), info
    assert all(np.isfinite(v) for v in info.values()), info
