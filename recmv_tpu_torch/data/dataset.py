"""Copy of ``recmv_tpu/data/dataset.py``, kept as it is apart from this
note, its imports and two changes: the port runs where JAX, OpenCV and
joblib are absent, and importing any ``recmv_tpu`` module imports JAX.
Images are read with ``data/image.imread``, which gives ``cv2.imread``'s
arrays for the PNG and JPEG files a scene holds, the TCMR output with
``utils/pickle_compat.load_joblib``, which reads what ``joblib.load``
reads but lz4 dumps; and unlike the JAX package, a TCMR file that cannot
be read raises (``SceneDataset._load_tcmr``).

Scene datasets — host-side data layer.

Parity with reference ``dataset/dataset.py`` (``SceneDataset`` and its
People_Snapshot / Large_Pose / Synthe / Snug / Init_Fl variants): per-frame
images normalized to [-1, 1], foreground masks, ATR parsing-derived
garment masks (upper / bottom / upper_bottom / body), PIFuHD normals,
2D feature-line annotations (uniform 100-point curves with loop
reordering), per-frame SMPL poses/translation/shape, camera intrinsics,
and the *learnable* per-scene parameters.

TPU-native redesign: where the reference stores learnable tensors inside
the torch Dataset (``dataset.py:83-91,253-258``), here all optimizable
state lives in a ``SceneParams`` pytree that the jitted train step takes
and returns — the dataset object only loads frames and owns static
metadata. Per-frame latent codes are initialized in the low-frequency DCT
subspace exactly like the reference (0.1·randn @ DCTSpace(n/5, n)).

Scene folder layout (reference-compatible):
  imgs/%d.{jpg,png}  masks/%d.png  parsing_SCH_ATR/%d.npy
  featurelines/*.json (or mask2fl/*.json)  normals/%d.png
  smpl_rec.npz {poses, trans, shape, gender, vid_seg_indices}
  camera.npz {fx, fy, cx, cy, quat, T}
"""

from __future__ import annotations

import json
import os
import os.path as osp
from dataclasses import dataclass, field
from glob import glob

import numpy as np

from ..config.constants import ATR_PARSING, FL_INFOS
from ..geometry.polygons import uniform_sample
from ..ops.math3d import dct_space
from ..utils.pickle_compat import load_joblib

from .image import imread


# ---------------------------------------------------------------------------
# Learnable per-scene parameters (a pytree managed by the optimizer)
# ---------------------------------------------------------------------------

@dataclass
class SceneParams:
    """All per-scene optimizable state. Entries the config marks as
    non-trainable are kept here too (masked out of the optimizer)."""

    poses: np.ndarray        # (T, 24, 3)
    trans: np.ndarray        # (T, 3)
    shape: np.ndarray        # (10,)
    conds: dict              # name → (T, L) latent codes
    camera: dict             # focal_length(2,), princeple_points(2,), quat(4,), T(3,)

    def tree(self):
        return {
            "poses": self.poses, "trans": self.trans, "shape": self.shape,
            "conds": self.conds, "camera": self.camera,
        }


def init_scene_params(poses, trans, shape, camera_params, conds_lens, frame_num,
                      seed: int = 0) -> SceneParams:
    rng = np.random.RandomState(seed)
    conds = {}
    for name, length in conds_lens.items():
        k = max(frame_num // 5, 1)
        basis = dct_space(k, frame_num)  # (k, T)
        conds[name] = (0.1 * rng.randn(length, k).astype(np.float32) @ basis).T.copy()
    return SceneParams(
        poses=np.asarray(poses, np.float32).reshape(-1, 24, 3),
        trans=np.asarray(trans, np.float32).reshape(-1, 3),
        shape=np.asarray(shape, np.float32).reshape(-1),
        conds=conds,
        camera={k: np.asarray(v, np.float32) for k, v in camera_params.items()},
    )


def trainable_mask(conf, frame_num) -> dict:
    """Which SceneParams leaves receive optimizer updates, from the
    train.opt_* config block (reference train.py / opt_camera_params)."""
    cam_conf = conf.get_config("train.opt_camera") if "train.opt_camera" in conf else None
    return {
        "poses": conf.get_bool("train.opt_pose", False),
        "trans": conf.get_bool("train.opt_trans", False),
        "shape": False,
        "conds": True,
        "camera": {
            "focal_length": cam_conf.get_bool("focal_length") if cam_conf else False,
            "princeple_points": cam_conf.get_bool("princeple_points") if cam_conf else False,
            "cam2world_coord_quat": cam_conf.get_bool("quat") if cam_conf else False,
            "world2cam_coord_trans": cam_conf.get_bool("T") if cam_conf else False,
        },
    }


# ---------------------------------------------------------------------------
# Feature-line IO
# ---------------------------------------------------------------------------

def obtain_feature_lines(path: str) -> dict:
    """labelme-style JSON → {label: (P,2) float32}."""
    with open(path) as f:
        infos = json.load(f)
    out = {}
    for shape in infos["shapes"]:
        out[shape["label"]] = np.asarray(shape["points"], np.float32)
    return out


def check_feature_lines(path: str):
    seen = set()
    with open(path) as f:
        infos = json.load(f)
    for shape in infos["shapes"]:
        assert shape["label"] not in seen, f"label conflict in {path}"
        seen.add(shape["label"])


# ---------------------------------------------------------------------------
# The dataset
# ---------------------------------------------------------------------------

class SceneDataset:
    def __init__(self, data_root, conds_lens=None, garment_type="", fl_sampling=100,
                 curve_sampling=1):
        assert garment_type != ""
        self.root = data_root
        self.garment_type = garment_type
        self.fl_sampling = fl_sampling
        self.curve_sampling = curve_sampling
        self.conds_lens = dict(conds_lens or {})
        self.fl_names = FL_INFOS[garment_type]
        self.require_albedo = False
        self.start_idx = 0

        self._read_data()
        self._load_tcmr()
        self._adjust_sequences()
        self.params = init_scene_params(
            self.poses, self.trans, self.shape, self.camera_params,
            self.conds_lens, self.frame_num,
        )
        self.area_size_statistic()

    # -- reading -----------------------------------------------------------

    def _read_data(self):
        imgs = []
        for ext in (".jpg", ".png"):
            imgs.extend(glob(osp.join(self.root, "imgs/*" + ext)))
        imgs.sort(key=lambda x: int(osp.basename(x).split(".")[0]))
        assert imgs, f"no frames under {self.root}/imgs"
        self.img_ns = imgs
        self.frame_num = len(imgs)
        self.mask_ns = []
        self.parsing_mask_ns = []
        for ind, img_n in enumerate(self.img_ns):
            stem = osp.basename(img_n).split(".")[0]
            assert ind == int(stem)
            self.mask_ns.append(osp.join(self.root, f"masks/{stem}.png"))
            self.parsing_mask_ns.append(osp.join(self.root, f"parsing_SCH_ATR/{stem}.npy"))
            assert osp.isfile(self.mask_ns[-1])
        probe = imread(self.mask_ns[0])
        self.H, self.W = probe.shape[:2]

        data = np.load(osp.join(self.root, "smpl_rec.npz"))
        self.poses = np.asarray(data["poses"], np.float32).reshape(-1, 24, 3)
        self.trans = np.asarray(data["trans"], np.float32).reshape(-1, 3)
        self.shape = np.asarray(data["shape"], np.float32).reshape(-1)
        self.gender = str(data["gender"]) if "gender" in data else "neutral"
        if "vid_seg_indices" in data:
            segs = data["vid_seg_indices"]
            segs = segs.tolist() if isinstance(segs, np.ndarray) else segs
            self.video_segmented_index = list(segs[:-1])
        else:
            self.video_segmented_index = []

        cam = np.load(osp.join(self.root, "camera.npz"))
        self.camera_params = {
            "focal_length": np.asarray([cam["fx"], cam["fy"]], np.float32).reshape(2),
            "princeple_points": np.asarray([cam["cx"], cam["cy"]], np.float32).reshape(2),
            "cam2world_coord_quat": np.asarray(cam["quat"], np.float32).reshape(4),
            "world2cam_coord_trans": np.asarray(cam["T"], np.float32).reshape(3),
        }

        fl_dir = osp.join(self.root, "featurelines")
        if not osp.isdir(fl_dir):
            fl_dir = osp.join(self.root, "mask2fl")
        assert osp.isdir(fl_dir), f"no featurelines/ or mask2fl/ under {self.root}"
        self.read_feature_lines(fl_dir)

    def _load_tcmr(self):
        """TCMR 2D joints for the beta pre-fit (dataset.py:48-79), from
        ``<garment>_tcmr_output.pkl`` when the scene ships one: record 1 of
        the dump, {frame_ids, gt_joints2d, pose, betas}.

        Deliberate departure: the JAX package swallows every exception
        here and then skips the pre-fit without a word. Here a file that
        cannot be read raises (an lz4 dump:
        ``pickle_compat.CompressedDumpError``)."""
        self.gt_joints2d = None
        path = osp.join(self.root, f"{self.garment_type}_tcmr_output.pkl")
        if osp.exists(path):
            data = load_joblib(path)[1]
            self.gt_joints2d = {fid: j for fid, j in
                                zip(data["frame_ids"].tolist(), data["gt_joints2d"])}
            self.tcmr_frame_ids = sorted(data["frame_ids"].tolist())
            self.tcmr_poses = data["pose"]
            self.tcmr_betas = data["betas"]

    def _adjust_sequences(self):
        """Hook for subclasses that rewrite poses/trans/shape from side
        information before the learnable SceneParams are initialized
        (LargePoseDataset); no-op for the base dataset."""

    def read_feature_lines(self, path):
        """Per-frame JSON paths, carrying the last annotation forward for
        unannotated frames (dataset.py:156-178); records which frames have
        their own annotation (fl_supervised)."""
        fl_paths = sorted(glob(osp.join(path, "*.json")),
                          key=lambda x: int(osp.basename(x).split(".")[0]))
        assert fl_paths, f"no feature-line json under {path}"
        self.a_pose_start = int(osp.basename(fl_paths[0]).split(".")[0])
        self.a_pose_end = int(osp.basename(fl_paths[-1]).split(".")[0])
        self.fl_paths = []
        self.fl_supervised = []
        ji = 0
        for fid in range(self.frame_num):
            try:
                jname = int(osp.basename(fl_paths[ji]).split(".")[0])
            except IndexError:
                jname = -1
            if fid == jname:
                self.fl_paths.append(fl_paths[ji])
                self.fl_supervised.append(True)
                ji += 1
            else:
                self.fl_paths.append(fl_paths[max(ji - 1, 0)])
                self.fl_supervised.append(False)
        for p in fl_paths:
            check_feature_lines(p)

    # -- statistics ---------------------------------------------------------

    def area_size_statistic(self):
        """Per-curve projection weights from 2D extent statistics
        (dataset.py:109-153): w = (max_extent / extent)², squared because
        the chamfer is squared."""
        self.fl_weights = {n: 0.0 for n in self.fl_names}
        visible = {n: 0 for n in self.fl_names}
        for idx in range(self.frame_num):
            if idx % self.curve_sampling:
                continue
            fls = obtain_feature_lines(self.fl_paths[idx])
            pts, masks = self.obtain_fl_pts(fls)
            for p, m, name in zip(pts, masks, self.fl_names):
                if not m:
                    continue
                ext = p.max(0) - p.min(0)
                self.fl_weights[name] += max(ext[0], ext[1])
                visible[name] += 1
        max_area = 0.0
        for n in self.fl_names:
            self.fl_weights[n] /= max(visible[n], 1)
            max_area = max(max_area, self.fl_weights[n])
        for n in self.fl_names:
            if self.fl_weights[n] > 0:
                self.fl_weights[n] = (max_area / self.fl_weights[n]) ** 2
            else:
                self.fl_weights[n] = 0.0

    def obtain_fl_pts(self, fls: dict):
        """gt 2D curves → fixed fl_sampling points; reorders open curves
        so the largest gap sits at the wrap point (dataset.py:287-315)."""
        fl_pts, fl_masks = [], []
        for name in self.fl_names:
            if name in fls:
                pts = fls[name]
                dis = ((pts[:-1] - pts[1:]) ** 2).sum(-1)
                gap = ((pts[-1] - pts[0]) ** 2).sum(-1)
                if len(dis) and gap < np.max(dis):
                    mi = int(np.argmax(dis))
                    pts = np.concatenate([pts[mi + 1:], pts[: mi + 1]], axis=0)
                fl_pts.append(uniform_sample(pts, self.fl_sampling).astype(np.float32))
                fl_masks.append(True)
            else:
                fl_pts.append(np.zeros((self.fl_sampling, 2), np.float32))
                fl_masks.append(False)
        return fl_pts, fl_masks

    # -- parsing masks -------------------------------------------------------

    def _mask_parsing_path(self, idx):
        pn = self.parsing_mask_ns[idx]
        return osp.join(osp.dirname(pn), "mask_parsing_" + osp.basename(pn))

    def parsing_mask(self, idx):
        """KNN-propagate ATR labels into the matting mask and cache
        (dataset.py:260-316, preprocess/mask2parsing_mask.py)."""
        from scipy.spatial import cKDTree

        parsing = np.load(self.parsing_mask_ns[idx])
        mask = (imread(self.mask_ns[idx]) > 0).any(-1)
        out = np.zeros_like(mask, np.uint8)
        li, lj = np.nonzero(parsing)
        if len(li):
            labels = parsing[li, lj]
            tree = cKDTree(np.stack([li, lj], 1))
            mi, mj = np.nonzero(mask)
            _, nn = tree.query(np.stack([mi, mj], 1), k=1)
            out[mi, mj] = labels[nn]
        np.save(self._mask_parsing_path(idx), out)
        return self._mask_parsing_path(idx)

    def obtain_parsing_mask(self, mask_parsing: np.ndarray) -> dict:
        """ATR label groups → {upper, bottom, upper_bottom, body} bool
        masks (dataset.py:339-357)."""
        out = {}
        all_g = np.zeros_like(mask_parsing, bool)
        for key, ids in ATR_PARSING.items():
            m = np.zeros_like(mask_parsing, bool)
            for cid in ids:
                m |= mask_parsing == cid
                all_g |= mask_parsing == cid
            out[key] = m
        out["body"] = (mask_parsing > 0) ^ all_g
        return out

    # -- frame access ---------------------------------------------------------

    def __len__(self):
        return self.frame_num

    def __getitem__(self, idx):
        real = idx + self.start_idx
        out = {}
        img = imread(self.img_ns[real]).astype(np.float32)
        out["img"] = (img / 255.0 - 0.5) * 2.0
        mask = (imread(self.mask_ns[real]) > 0).any(-1)
        out["mask"] = mask.astype(np.float32)

        mp_path = self._mask_parsing_path(real)
        if not osp.isfile(mp_path):
            if osp.isfile(self.parsing_mask_ns[real]):
                self.parsing_mask(real)
            else:
                np.save(mp_path, (mask * 4).astype(np.uint8))  # all 'upper'
        mask_parsing = np.load(mp_path)
        out.update({k: v.astype(np.float32) for k, v in
                    self.obtain_parsing_mask(mask_parsing).items()})

        fls = obtain_feature_lines(self.fl_paths[real])
        fl_pts, fl_masks = self.obtain_fl_pts(fls)
        fl_masks = np.asarray(fl_masks, bool)
        if real % self.curve_sampling != 0:
            fl_masks[...] = False
        out["fl_pts"] = np.concatenate([p[None] for p in fl_pts], axis=0)
        out["fl_masks"] = fl_masks

        norm_f = self.img_ns[real].replace("/imgs/", "/normals/")[:-3] + "png"
        if osp.isfile(norm_f):
            normals = imread(norm_f)[:, :, ::-1]
            out["normal"] = 2.0 * normals.astype(np.float32) / 255.0 - 1.0
        if self.gt_joints2d is not None and real in self.gt_joints2d:
            out["gt_joints2d"] = self.gt_joints2d[real]
        return idx, out

    def get_batch(self, fids):
        """Stack frames into batched numpy arrays (replaces DataLoader
        collation; IO is host-side anyway)."""
        outs = [self[int(f)][1] for f in fids]
        keys = set(outs[0]).intersection(*[set(o) for o in outs])
        return {k: np.stack([o[k] for o in outs]) for k in keys}

    def get_batchframe_data(self, name, fids, batchsize):
        """Sliding windows for the DCT pose prior (dataset.py:438-502):
        window of `batchsize` frames centered on each fid, clamped to the
        video (or video-segment) bounds. Returns (windows, center_offsets)."""
        data = getattr(self, name)
        data = np.asarray(data)[: self.frame_num]
        fids = np.asarray(fids)
        bounds = [0] + [b for b in self.video_segmented_index] + [self.frame_num]
        starts = np.empty_like(fids)
        for i, f in enumerate(fids):
            lo, hi = 0, self.frame_num
            for b0, b1 in zip(bounds[:-1], bounds[1:]):
                if b0 <= f < b1:
                    lo, hi = b0, b1
                    break
            assert batchsize < hi - lo
            s = f - batchsize // 2
            s = max(s, lo)
            s = min(s, hi - batchsize)
            starts[i] = s
        win = data[starts[:, None] + np.arange(batchsize)[None]]
        return win, fids - starts

    # -- learnables ----------------------------------------------------------

    def get_grad_parameters(self, idxs, params: SceneParams | None = None):
        p = params or self.params
        idxs = np.asarray(idxs)
        conds = [p.conds[n][idxs + self.start_idx] for n in p.conds]
        return (p.poses[idxs + self.start_idx], p.trans[idxs + self.start_idx], *conds)


class PeopleSnapshotDataset(SceneDataset):
    """PeopleSnapshot scenes: feature lines live in mask2fl/ and annotate
    the self-rotation (A-pose) sub-range; a_pose selects that range,
    otherwise the remainder (dataset.py:503-600)."""

    def __init__(self, data_root, conds_lens=None, garment_type="", fl_sampling=100,
                 curve_sampling=1, a_pose=True):
        super().__init__(data_root, conds_lens, garment_type, fl_sampling, curve_sampling)
        self.a_pose = a_pose
        total = self.frame_num
        if a_pose:
            self.start_idx = self.a_pose_start
            self.frame_num = min(self.a_pose_end - self.a_pose_start + 1, total)
        else:
            self.start_idx = self.a_pose_end + 1
            self.frame_num = total - self.a_pose_end - 1


class LargePoseDataset(SceneDataset):
    """Large-pose stage (reference Large_Pose_SceneDataset,
    dataset.py:681-894). The videoavatars translation is inconsistent on
    large motion, so: depth past the A-pose range is frozen and the whole
    translation OneEuro-smoothed; poses beyond the A-pose range are
    replaced by TCMR estimates; betas = mean TCMR betas over the A-pose
    range. ``a_pose=True`` selects the annotated A-pose sub-range (the
    resume split train_large_pose starts from); ``a_pose=False`` the
    large-motion remainder. Frames without their own feature-line
    annotation get fl_masks zeroed (per-frame supervision flags)."""

    def __init__(self, data_root, conds_lens=None, garment_type="", fl_sampling=100,
                 curve_sampling=1, a_pose=False):
        self.a_pose = a_pose
        super().__init__(data_root, conds_lens, garment_type, fl_sampling,
                         curve_sampling)
        total = self.frame_num
        if a_pose:
            self.start_idx = self.a_pose_start
            self.frame_num = min(self.a_pose_end - self.a_pose_start + 1, total)
        else:
            self.start_idx = self.a_pose_end + 1
            self.frame_num = total - self.a_pose_end - 1
        assert self.frame_num > 0, (
            f"no frames in the {'A-pose' if a_pose else 'large-motion'} "
            f"range [{self.a_pose_start}, {self.a_pose_end}] of {total}")

    def _adjust_sequences(self):
        from ..core.inference import one_euro_smooth

        # freeze depth past the annotated range, then OneEuro-smooth the
        # whole translation track (dataset.py:696-698)
        self.trans[self.a_pose_end:, -1] = self.trans[self.a_pose_end, -1]
        self.trans = one_euro_smooth(self.trans, min_cutoff=0.004, beta=0.7,
                                     d_cutoff=1.0)
        if self.gt_joints2d is not None:
            # frame → TCMR record (reference lower_bound over joints_frame_ids)
            ids = np.asarray(self.tcmr_frame_ids)
            rec = np.searchsorted(ids, np.arange(len(self.poses)), side="left")
            rec = np.clip(rec, 0, len(ids) - 1)
            tp = np.asarray(self.tcmr_poses, np.float32).reshape(-1, 24, 3)[rec]
            self.poses[self.a_pose_end + 1:] = tp[self.a_pose_end + 1:]
            arec = rec[self.a_pose_start:self.a_pose_end + 1]
            self.shape = np.asarray(self.tcmr_betas,
                                    np.float32)[arec].mean(0).reshape(-1)

    def area_size_statistic(self):
        """Curve projection weights from SUPERVISED frames only
        (dataset.py:760-806) — carried-forward annotations would skew the
        extent statistics on large-motion frames."""
        sup = self.curve_sampling
        try:
            self.curve_sampling = 1
            keep = self.fl_paths
            self.fl_paths = [p for p, s in zip(self.fl_paths, self.fl_supervised)
                             if s]
            n, self.frame_num = self.frame_num, len(self.fl_paths)
            super().area_size_statistic()
        finally:
            self.curve_sampling = sup
            self.fl_paths = keep
            self.frame_num = n

    def __getitem__(self, idx):
        i, out = super().__getitem__(idx)
        if not self.fl_supervised[idx + self.start_idx]:
            out["fl_masks"] = np.zeros_like(out["fl_masks"])
        return i, out

    def get_init_fl_dataset(self):
        """Curve-init subset over frames with their own annotation
        (reference get_init_fl_datasets, dataset.py:750-758)."""
        idxs = [i for i, s in enumerate(self.fl_supervised) if s]
        return InitFlDataset(self.root, self.conds_lens, self.garment_type,
                             self.fl_sampling, self.curve_sampling,
                             sampler_idx=idxs)


class SyntheticDataset(SceneDataset):
    """Synthetic scenes (dataset.py:1004-1066) — same layout, gt meshes
    available under gt_meshes/ for Chamfer evaluation."""


class SnugAnimationDataset:
    """Novel-pose animation source (dataset.py:1067-1112): loads a SNUG
    motion (.npz with pose (T,72) / shape) and exposes poses/trans only."""

    def __init__(self, motion_path, shape=None):
        data = np.load(motion_path)
        pose = np.asarray(data["pose"], np.float32)
        self.poses = pose.reshape(-1, 24, 3)
        self.trans = (np.asarray(data["trans"], np.float32)
                      if "trans" in data else np.zeros((len(self.poses), 3), np.float32))
        self.shape = (np.asarray(data["shape"], np.float32).reshape(-1)
                      if "shape" in data else (shape if shape is not None else np.zeros(10, np.float32)))
        self.frame_num = len(self.poses)

    def __len__(self):
        return self.frame_num


class InitFlDataset(SceneDataset):
    """Curve-init subset: only frames with their own feature-line
    annotation (dataset.py:894-1003).

    The reference's fl_optimizer consumes this subset as a DataLoader
    (fl_optimizer.py:121 → get_init_fl_datasets); the rebuilt curve init
    (core/network.py scale_rigid fl init) consumes the same subset
    directly from ``fl_supervised`` in one jitted batch — this class
    provides the dataset-object view of that subset for API parity and
    for :meth:`LargePoseDataset.get_init_fl_dataset`."""

    def __init__(self, data_root, conds_lens=None, garment_type="", fl_sampling=100,
                 curve_sampling=1, sampler_idx=None):
        super().__init__(data_root, conds_lens, garment_type, fl_sampling, curve_sampling)
        self.sampler_idx = list(sampler_idx) if sampler_idx is not None else \
            [i for i, s in enumerate(self.fl_supervised) if s]

    def __len__(self):
        return len(self.sampler_idx)

    def __getitem__(self, i):
        return super().__getitem__(self.sampler_idx[i] - self.start_idx)


# ---------------------------------------------------------------------------
# Samplers (dataset.py:1113-1158)
# ---------------------------------------------------------------------------

class ClipSampler:
    """Yields contiguous clips of batch_size frames.

    Parity note: the reference defines this sampler but leaves it
    unconsumed too — its DataLoader keeps ``sampler=ClipSampler(...)``
    commented out (dataset.py:1113,1179) and trains with the default
    random sampler; contiguous windows for the DCT pose prior come from
    the dataset's sliding-window helper instead
    (:meth:`SceneDataset.get_batchframe_data`)."""

    def __init__(self, dataset_len, batch_size, shuffle=True, seed=0):
        self.n = dataset_len
        self.bs = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        starts = np.arange(0, self.n - self.bs + 1)
        if self.shuffle:
            self.rng.shuffle(starts)
        for s in starts:
            yield np.arange(s, s + self.bs)

    def __len__(self):
        return max(self.n - self.bs + 1, 0)


class RandomSampler:
    """Yields random frame batches."""

    def __init__(self, dataset_len, batch_size, shuffle=True, seed=0):
        self.n = dataset_len
        self.bs = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        order = np.arange(self.n)
        if self.shuffle:
            self.rng.shuffle(order)
        for s in range(0, self.n - self.bs + 1, self.bs):
            yield order[s : s + self.bs]

    def __len__(self):
        return self.n // self.bs


def get_dataset_and_loader(data_root, conds_lens, batch_size, shuffle=True,
                           garment_type="", data_type="people_snap",
                           fl_sampling=100, curve_sampling=1, a_pose=True, seed=0):
    """Factory (dataset.py:1159-1183). Returns (dataset, sampler)."""
    if data_type == "people_snap":
        ds = PeopleSnapshotDataset(data_root, conds_lens, garment_type,
                                   fl_sampling, curve_sampling, a_pose=a_pose)
    elif data_type == "large_pose":
        ds = LargePoseDataset(data_root, conds_lens, garment_type,
                              fl_sampling, curve_sampling, a_pose=a_pose)
    elif data_type == "synthe":
        ds = SyntheticDataset(data_root, conds_lens, garment_type,
                              fl_sampling, curve_sampling)
    else:
        ds = SceneDataset(data_root, conds_lens, garment_type,
                          fl_sampling, curve_sampling)
    sampler = RandomSampler(len(ds), batch_size, shuffle, seed)
    return ds, sampler
