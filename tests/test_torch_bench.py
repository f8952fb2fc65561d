"""The port's benches and quality scorers (``recmv_tpu_torch/tools/``,
``recmv_tpu_torch/bench.py``) on the CPU, against the JAX package where
they compute a number of their own.

(a) the quality scorers (``frame_scores``: symmetric chamfer against the
    GT's lateral and closed surfaces, the one-sided and per-piece mean
    distances; ``seam_gap``) on a 48 px synthetic-two scene with a
    prediction written as obj (the GT vertices moved by a seeded 5 mm
    noise), against the same formulas through ``recmv_tpu.ops.knn`` and
    ``recmv_tpu.geometry.mesh_utils.sample_mesh_surface``: 1e-5 relative;
(b) the training probes (``mc_pred_to_gt``, ``mc_fresh_to_gt``, the
    canonical radial profile) on ``tests/test_torch_train.py``'s bridged
    network pair against the JAX tool's probes: 1e-5 absolute;
(c) the hot step at narrow widths (R = 64) against the JAX ``bench.py``
    hot step: the loss and each leaf's Σ|gradient| within 1e-4 relative
    (float32, TF32 off);
(d) ``step_cost_analysis`` of one SDF forward: exactly 2·rows·Σ in·out;
(e) each tool's ``main`` once on the CPU at a small size: its record's
    keys hold the matching root record's (the JAX package's TPU records,
    read, not edited) less the keys the port dropped; the large-pose
    tool's SDFs do not move; ``eval_chamfer`` and ``compute_CSI`` against
    the JAX formulas;
(f) ``bench_quality --freeze-pose``: the poses, translations and camera
    stay bit-equal over 2 steps (they move without it);
(g) ``ensure_scene`` reuses a scene of the same arguments and regenerates
    one of others.

The tools run the flagship widths (8×512 SDFs), which the CPU pays for:
the file runs torch on two intra-op threads, GT surfaces of 5,000 samples
(100,000 in the tools), the visibility scan at 64², the benches'
skinning field at (17, 25, 9) and the quick NRICP schedules.
"""

import functools
import glob
import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOT = osp.join(osp.dirname(__file__), "..")
RATIO = {"sdfRatio": 1.0, "deformerRatio": 0.5, "renderRatio": 1.0}
N_GT = 5000


@pytest.fixture(scope="module", autouse=True)
def _cpu_sizes():
    """Two intra-op threads, small GT samples, a 64² visibility scan and
    the benches' skinning field at (17, 25, 9)."""
    from recmv_tpu_torch.core import inference
    from recmv_tpu_torch.tools import bench_fullstep, bench_quality

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    saved = (bench_quality.GT_SAMPLES, bench_quality.CANO_SAMPLES, inference.visible_vertex_mask,
             bench_fullstep.SKINNER_RES)
    bench_quality.GT_SAMPLES = bench_quality.CANO_SAMPLES = N_GT
    inference.visible_vertex_mask = functools.partial(saved[2], image=64)
    bench_fullstep.SKINNER_RES = (17, 25, 9)
    yield
    (bench_quality.GT_SAMPLES, bench_quality.CANO_SAMPLES, inference.visible_vertex_mask,
     bench_fullstep.SKINNER_RES) = saved
    torch.set_num_threads(n)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


# ---------------------------------------------------------------------------
# (a) the quality scorers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """A 1-frame 48 px synthetic-two scene, its GT moved by 5 mm noise
    written as each garment's export, labels for the waist loops, and the
    port's scores."""
    from recmv_tpu_torch.data.synthetic import generate_scene
    from recmv_tpu_torch.tools import bench_quality as bq
    from recmv_tpu_torch.utils.io import save_obj

    root = tmp_path_factory.mktemp("scores")
    scene = generate_scene(str(root / "scene"), n_frames=1, image_size=48,
                           skinner_res=(17, 25, 9), garment_type="synthetic-two", device="cpu")
    z = np.load(osp.join(scene, "gt_meshes", "0.npz"))
    rng = np.random.RandomState(0)
    out_dir = str(root / "infer")
    os.makedirs(osp.join(out_dir, "meshs"))
    names = [str(s) for s in z["piece_names"]]
    lo, registered = 0, {}
    for name, size in zip(names, z["piece_sizes"]):
        v = z["verts"][lo:lo + size] + 0.005 * rng.randn(size, 3).astype(np.float32)
        f = z["faces"][(z["faces"] >= lo).all(1) & (z["faces"] < lo + size).all(1)] - lo
        save_obj(osp.join(out_dir, "meshs", f"0000_{name}.obj"), v, f)
        registered[name] = (v.astype(np.float32), f)
        np.savez(osp.join(out_dir, f"registry_{name}_labels.npz"),
                 upper_bottom=rng.choice(size, 40, replace=False))
        lo += size
    port = bq.frame_scores(scene, out_dir, names, 1, "cpu")
    port["seam"] = bq.seam_gap(registered, out_dir, names, "cpu")
    return port, _jax_scores(scene, out_dir, names, registered), names


def _jax_scores(scene, out_dir, names, registered):
    """The JAX tool's scoring formulas (tools/bench_quality.py:397-469)."""
    from recmv_tpu.geometry.mesh_utils import sample_mesh_surface
    from recmv_tpu.ops.knn import chamfer_distance, knn
    from recmv_tpu.utils.io import load_obj

    z = np.load(osp.join(scene, "gt_meshes", "0.npz"))
    verts, faces = z["verts"], z["faces"]
    gt = sample_mesh_surface(verts, faces, N_GT, seed=0)[0]
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]], verts[faces[:, 2]] - verts[faces[:, 0]])
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
    gt_lat = sample_mesh_surface(verts, faces[np.abs(fn[:, 1]) < 0.95], N_GT, seed=0)[0]
    cands = sorted(glob.glob(osp.join(out_dir, "meshs", "0000_*.obj")))
    pred = jnp.asarray(np.concatenate([load_obj(c)[0] for c in cands], 0), jnp.float32)
    out = {"chamfer": float(chamfer_distance(pred, jnp.asarray(gt_lat))),
           "chamfer_closed": float(chamfer_distance(pred, jnp.asarray(gt))),
           "one_sided": float(jnp.mean(jnp.sqrt(knn(pred, jnp.asarray(gt), 1)[0])))}
    sizes = list(z["piece_sizes"])
    for i, g in enumerate(names):
        lo, hi = sum(sizes[:i]), sum(sizes[:i + 1])
        vmask = np.zeros(len(verts), bool)
        vmask[lo:hi] = True
        piece = sample_mesh_surface(verts[lo:hi], faces[vmask[faces].all(1)] - lo, N_GT,
                                    seed=0)[0]
        pg = jnp.asarray(load_obj(osp.join(out_dir, "meshs", f"0000_{g}.obj"))[0], jnp.float32)
        out[g] = float(jnp.mean(jnp.sqrt(knn(pg, jnp.asarray(piece, jnp.float32), 1)[0])))
    labs = {g: np.load(osp.join(out_dir, f"registry_{g}_labels.npz"))["upper_bottom"]
            for g in names}
    up = registered[names[0]][0][labs[names[0]]]
    bp = registered[names[1]][0][labs[names[1]]]
    out["seam"] = float(jnp.mean(jnp.sqrt(knn(jnp.asarray(bp), jnp.asarray(up), 1)[0])))
    return out


@pytest.mark.parametrize("kind", ["chamfer", "chamfer_closed", "one_sided", "upper_tube",
                                  "skirt", "seam"])
def test_scorers_match_jax(scored, kind):
    port, jax_scores, names = scored
    want = jax_scores[kind]
    got = (port["per_garment"][kind][0] if kind in names else
           port[kind] if kind == "seam" else port[kind][0])
    assert want > 0 and _rel(got, want) < 1e-5, (kind, got, want)


# ---------------------------------------------------------------------------
# (b) the training probes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def probes(tmp_path_factory):
    """Both networks on one 4-frame 48 px synthetic-tube scene from one state
    (``test_torch_train._build_pair``), with both packages' probes."""
    from recmv_tpu.geometry.mesh_utils import sample_mesh_surface as jsample
    from recmv_tpu.ops.knn import knn as jknn
    from recmv_tpu_torch.data.synthetic import generate_scene
    from recmv_tpu_torch.tools import bench_quality as bq
    from test_torch_train import _build_pair

    root = tmp_path_factory.mktemp("probes")
    scene = generate_scene(str(root / "scene"), n_frames=4, image_size=48,
                           skinner_res=(17, 25, 9), device="cpu")
    net_j, net_t, _ = _build_pair(root, scene)
    fid = 1
    z = np.load(osp.join(scene, "gt_meshes", f"{fid}.npz"))
    gt = jsample(z["verts"], z["faces"], N_GT, seed=fid)[0]

    def jpose(vs):
        posed = net_j._deform_garment_verts({"translator": net_j.params["translator"]},
                                            net_j.scene_tree(), [jnp.asarray(vs)],
                                            jnp.asarray([fid]), RATIO)[0][0]
        return float(jnp.sqrt(jnp.mean(jknn(posed, jnp.asarray(gt, jnp.float32), 1)[0])))

    g_v, _, g_nv, _ = net_j.discretize_sdf(net_j._ratio_dict(RATIO), -net_j.sdf_shrink)[1]
    fresh_j = np.asarray(g_v[:, :int(g_nv)].T)
    want = {"mc_pred": jpose(net_j.mesh.garment_vs[0][:net_j.mesh.garment_n[0]]),
            "mc_fresh": jpose(fresh_j)}
    # the canonical radial profile (tools/bench_quality.py:186-207)
    pieces, gt_cano, rings = bq.canonical_gt("synthetic-tube")
    gname, _, band, _ = pieces[0]
    d2, idx = jknn(jnp.asarray(fresh_j, jnp.float32), jnp.asarray(gt_cano[gname]), 1)
    nn = gt_cano[gname][np.asarray(idx)[:, 0]]
    rad = fresh_j.copy()
    rad[:, 1] = 0.0
    rad /= np.maximum(np.linalg.norm(rad, axis=1, keepdims=True), 1e-9)
    rc = ((nn - fresh_j) * rad).sum(1)
    q = np.linspace(band[0], band[1], 5)
    want["radial"] = [float(rc[(fresh_j[:, 1] >= a) & (fresh_j[:, 1] < b)].mean())
                      for a, b in zip(q[:-1], q[1:])]
    want["cano_rms"] = float(np.sqrt(np.asarray(d2)[:, 0].mean()))
    meshes = bq.fresh_meshes(net_t, RATIO)
    diag = bq.canonical_diag(net_t, RATIO, pieces, gt_cano, {}, 0, meshes)[gname]
    got = {"mc_pred": bq.mc_pred_to_gt(net_t, RATIO, gt, fid),
           "mc_fresh": bq.mc_fresh_to_gt(net_t, RATIO, gt, fid, meshes),
           "radial": diag["radial"], "cano_rms": diag["cano_rms"],
           "fresh_counts": (len(meshes[0][0]), len(fresh_j))}
    return got, want, net_t


@pytest.mark.parametrize("probe", ["mc_pred", "mc_fresh", "radial", "cano_rms"])
def test_probes_match_jax(probes, probe):
    got, want, _ = probes
    assert got["fresh_counts"][0] == got["fresh_counts"][1]
    np.testing.assert_allclose(got[probe], want[probe], rtol=0, atol=1e-5)
    assert np.all(np.abs(np.asarray(want[probe])) > 0)


# ---------------------------------------------------------------------------
# (c) the hot step, (d) the FLOP counter
# ---------------------------------------------------------------------------

def _jax_hot(params, statics, x, times=20):
    """The JAX ``bench.py`` hot step (bench.py:78-103) at given widths, in
    its two parts: (solve() → (points, converged), loss(points) → (loss,
    {leaf: Σ|gradient|}))."""
    import jax

    from recmv_tpu.core.surface_ps import optimize_surface_points
    from recmv_tpu.models.deformer import cardinal_rays_from_jac, deformer_jacobian
    from recmv_tpu.models.render_net import render_net_apply
    from recmv_tpu.models.sdf import sdf_apply, sdf_value
    from recmv_tpu.models.skinner import skinner_apply
    from recmv_tpu.models.translator import translator_apply

    sdf_static, tr_static, rn_static = statics
    cam, rays, seeds = (jnp.asarray(x[k]) for k in ("cam", "rays", "seeds"))
    bi, gt_rgb = jnp.asarray(x["batch_inds"], jnp.int32), jnp.asarray(x["gt_rgb"])
    cond, poses, trans = (jnp.asarray(x[k]) for k in ("cond", "poses", "trans"))

    def deform(prm, pts):
        off, _ = translator_apply(prm["translator"], tr_static, pts, cond[bi], 1.0)
        return skinner_apply(prm["skinner"], off, poses, trans, batch_inds=bi)

    @jax.jit
    def solve(prm):
        return optimize_surface_points(
            lambda p: sdf_value(prm["sdf"], sdf_static, p, 1.0), lambda p: deform(prm, p), cam,
            rays, seeds, jnp.ones(rays.shape[0], bool), times=times)

    @jax.jit
    def loss(prm, pts):
        def loss_fn(prm):
            sdf, feat = sdf_apply(prm["sdf"], sdf_static, pts, 1.0)
            nx = jax.grad(lambda p: jnp.sum(sdf_value(prm["sdf"], sdf_static, p, 1.0)))(pts)
            nxn = nx / jnp.clip(jnp.linalg.norm(nx, axis=-1, keepdims=True), 1e-9, None)
            jac = deformer_jacobian(lambda p: deform(prm, p), pts)
            crays, _ = cardinal_rays_from_jac(jac, rays)
            rgb = render_net_apply(prm["render"], rn_static, pts, nxn, crays, feat, 1.0)
            return (jnp.mean(jnp.abs(rgb - gt_rgb))
                    + 0.1 * jnp.mean((jnp.linalg.norm(nx, axis=-1) - 1.0) ** 2)
                    + 3.0 * jnp.mean(jnp.abs(sdf)))

        value, grads = jax.value_and_grad(loss_fn)(prm)
        return value, jax.tree_util.tree_map(lambda g: jnp.sum(jnp.abs(g)), grads)

    return (lambda: solve(params)), (lambda pts: loss(params, pts))


def _f32_translators(monkeypatch):
    """Both packages' translators in float32 (they round to bf16 as
    shipped)."""
    import jax

    from recmv_tpu.models import translator as jtr
    from recmv_tpu.models.mlp import linear_apply
    from recmv_tpu_torch.models import translator as ptr

    def jax_offset(params, static, ps, cond, ratio=None):
        x = jnp.concatenate([static.embedder(ps), cond], axis=-1)
        for l in range(len(static.dims) - 1):
            x = linear_apply(params[f"lin{l}"], x)
            x = jax.nn.relu(x) if l < len(static.dims) - 2 else x
        return x

    def port_offset(net, ps, cond, ratio=None):
        x = torch.cat([net.embedder(ps), cond], dim=-1)
        for l, lin in enumerate(net.lins):
            x = lin(x)
            x = torch.relu(x) if l < len(net.lins) - 1 else x
        return x

    monkeypatch.setattr(jtr, "translator_offset", jax_offset)
    monkeypatch.setattr(ptr, "translator_offset", port_offset)


@pytest.mark.parametrize("translator", ["f32", "bf16"])
def test_hot_step_matches_jax(monkeypatch, translator):
    """Narrow widths (SDF 4×64 with 16 features, 8-d latents), R = 64: the
    same weights (the JAX init, bridged) and inputs in both packages. No
    ray converges in 20 solver steps here, and 20 unconverged Newton steps
    amplify rounding on a few rays: the solve's points agree to 1e-5 on at
    least 90% of the rays (58 and 62 of 64 measured) and to 1e-3 on all in
    float32 (4.3e-4 measured), 5e-3 with the bf16 translators (1.0e-3). The loss, each package from its own points, agrees to 1e-4
    relative; at the JAX points the loss and every leaf's Σ|gradient|
    agree to 1e-4 relative with both translators in float32 (the
    skinner's box centre and side, whose gradients are each one sum of
    opposite-signed terms over every point, to 2e-4: 7.1e-5 and 1.02e-4
    measured; the other leaves ≤ 2.7e-5). As shipped, both round the translator to bf16, and two bf16
    evaluations differ by a rounding cascade that the Jacobian's backward
    carries into the translator, render and skinner leaves (up to 5e-3
    measured): there the loss is held to 1e-4 and the SDF leaves to 1e-4
    relative."""
    import jax

    from recmv_tpu.models.render_net import init_render_net
    from recmv_tpu.models.sdf import init_sdf_net
    from recmv_tpu.models.skinner import initial_lbs_skinner
    from recmv_tpu.models.smpl import synthetic_body_model
    from recmv_tpu.models.translator import init_translator
    from recmv_tpu_torch import bench, bridge

    if translator == "f32":
        _f32_translators(monkeypatch)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    sdf_p, sdf_s = init_sdf_net(k1, multires=6, bias=0.6, feature_vector_size=16,
                                dims=(64,) * 4, skip_in=(2,))
    tr_p, tr_s = init_translator(k2, condlen=8, multires=6)
    rn_p, rn_s = init_render_net(k3, condlen=16, multires_v=4)
    apose = np.zeros((24, 3), np.float32)
    apose[1, 2], apose[2, 2], apose[16, 2], apose[17, 2] = 0.17, -0.17, -0.79, 0.79
    sk, _, _ = initial_lbs_skinner(synthetic_body_model(n_subdiv=24), jnp.zeros(10), apose,
                                   resolution=(17, 25, 9))
    params = bench.build_hot_model(sdf_dims=(64,) * 4, features=16, condlen=8, device="cpu")
    for k, tree in (("sdf", sdf_p), ("translator", tr_p), ("render", rn_p)):
        bridge.load_mlp(params[k], jax.tree_util.tree_map(np.asarray, tree))
    params["skinner"] = bridge.skinner_from_jax(sk, device="cpu")
    for f in params["skinner"].__dataclass_fields__:
        getattr(params["skinner"], f).requires_grad_(True)
    x = bench.hot_inputs(64, 2, condlen=8, device="cpu")
    jsolve, jloss = _jax_hot({"sdf": sdf_p, "translator": tr_p, "render": rn_p, "skinner": sk},
                             (sdf_s, tr_s, rn_s), {k: v.numpy() for k, v in x.items()})
    jpts, jconv = jsolve()
    pts, conv = bench.hot_solve(params, x)
    err = np.abs(pts.numpy() - np.asarray(jpts)).max(1)
    assert np.array_equal(conv.numpy(), np.asarray(jconv))
    assert (err < 1e-5).mean() >= 0.9, np.sort(err)[-8:]
    assert err.max() < (1e-3 if translator == "f32" else 5e-3), np.sort(err)[-8:]
    # the whole step, each package from its own points
    assert _rel(float(bench.hot_loss(params, x, pts)[0]), float(jloss(jpts)[0])) < 1e-4
    want_loss, want = jloss(jpts)
    loss, sums = bench.hot_loss(params, x, torch.tensor(np.asarray(jpts)))
    assert _rel(float(loss), float(want_loss)) < 1e-4
    for name, s in sums.items():
        net, rest = name.split(".", 1)
        if translator == "bf16" and net != "sdf":
            continue
        w = (float(getattr(want["skinner"], rest)) if net == "skinner" else
             float(want[net][f"lin{rest.split('.')[1]}"][rest.split(".")[2]]))
        tol = 2e-4 if name in ("skinner.bbox_center", "skinner.bbox_extend") else 1e-4
        assert abs(float(s) - w) <= tol * abs(w), (name, float(s), w)


def test_flop_count_of_an_sdf_forward(probes):
    """One SDF forward at the flagship widths: the counted FLOPs are the
    GEMMs' 2·rows·Σ in·out exactly, and no kernel ran."""
    from recmv_tpu_torch.models.sdf import sdf_value

    _, _, net = probes
    sdf = net.params["sdf"]
    rows = 300
    pts = torch.rand(rows, 3) - 0.5
    cost = net.step_cost_analysis(lambda: sdf_value(sdf, pts, 1.0))
    want = 2 * rows * sum(lin.weight().numel() for lin in sdf.lins)
    assert cost["flops"] == cost["gemm_flops"] == want
    assert cost["kernel_flops"] == {} and cost["bytes accessed"] is None


# ---------------------------------------------------------------------------
# (e) each tool on the CPU, (f) --freeze-pose, (g) ensure_scene
# ---------------------------------------------------------------------------

DROPPED = {"bench_fullstep.json": {"warm_start_s", "warm_start_runs_s"},
           "bench_largepose.json": {"warm_start_s"}, "bench_animation.json": set()}
QUALITY_RECORDS = ("bench_quality.json", "bench_quality_512.json",
                   "bench_quality_512_gateon.json", "bench_quality_two.json",
                   "bench_quality_skirt.json")
BENCH_ARGS = ["--device", "cpu", "--image", "64", "--frames", "4", "--init-epochs", "6"]


def _root_keys(name):
    with open(osp.join(ROOT, name)) as f:
        rec = json.load(f)
    return set(rec) - DROPPED.get(name, set()), set(rec["config"])


def _holds_keys(rec, *names):
    for name in names:
        keys, config = _root_keys(name)
        assert keys <= set(rec), (name, keys - set(rec))
        assert config <= set(rec["config"]), (name, config - set(rec["config"]))
    assert rec["device"] == "cpu" and rec["platform"] == "cpu"


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def quick_registration():
    """``ensure_registration`` with the quality bench's quick schedules."""
    from recmv_tpu_torch.core.inference import GarmentInference
    from recmv_tpu_torch.tools.bench_quality import quick_schedules

    orig = GarmentInference.ensure_registration
    nricp, refine = quick_schedules()
    GarmentInference.ensure_registration = functools.partialmethod(
        orig, nricp_cfg=nricp, refine_cfg=refine)
    yield
    GarmentInference.ensure_registration = orig


def test_fullstep_tool_on_cpu(bench_dir):
    from recmv_tpu_torch.tools import bench_fullstep

    rec = bench_fullstep.main(BENCH_ARGS + [
        "--quality", "small", "--sample-pix", "64", "--steps", "1", "--sustain", "2",
        "--scene", osp.join(bench_dir, "bench"),
        "--out", osp.join(bench_dir, "bench_fullstep.json")])
    _holds_keys(rec, "bench_fullstep.json")
    assert rec["sustained"]["remeshes"] == 1 and rec["sustained"]["all_finite"]
    cost = rec["step_cost"]
    assert cost["gemm_gflops"] > 0 and cost["bytes_accessed"] is None
    assert set(cost["kernel_gflops"]) == {"mesh_tiles", "composite_tiles", "composite_tiles_bwd"}
    assert min(cost["kernel_gflops"].values()) > 0
    assert np.isfinite(rec["sec_per_step_amortized"]) and rec["remesh_warm_s"] > 0


def test_animation_tool_on_cpu(bench_dir, quick_registration):
    """After the fullstep tool on the same scene: it reuses the cached
    initialization."""
    from recmv_tpu_torch.tools import bench_animation, compute_CSI

    rec = bench_animation.main(BENCH_ARGS + [
        "--quality", "small", "--motion-frames", "4", "--scene", osp.join(bench_dir, "bench"),
        "--out", osp.join(bench_dir, "anim.json")])
    _holds_keys(rec, "bench_animation.json")
    assert min(rec["extract_verts"]) > 0 and rec["registered_verts"]["tube"] > 0
    anim = osp.join(bench_dir, "bench_64_4", "result", "bench_anim")
    assert len(glob.glob(osp.join(anim, "000?_tube.obj"))) == 4
    # the CSI over the 4 animated frames, against the JAX tool's formula
    from recmv_tpu.utils.io import load_obj

    seq = [load_obj(p)[0] for p in sorted(glob.glob(osp.join(anim, "000?_tube.obj")))]
    want = np.mean([np.sqrt((((b - a) - (c - b)) ** 2).sum(-1)).sum() / a.shape[0]
                    for a, b, c in zip(seq, seq[1:], seq[2:])])
    os.makedirs(osp.join(bench_dir, "seq"))
    for i, p in enumerate(sorted(glob.glob(osp.join(anim, "000?_tube.obj")))):
        os.link(p, osp.join(bench_dir, "seq", f"{i}.obj"))
    got = compute_CSI.main([osp.join(bench_dir, "seq")])
    assert want > 0 and _rel(got, want) < 1e-6


def test_largepose_tool_on_cpu(bench_dir):
    """On a copy of the fullstep tool's scene, initialization and skinner
    cache where that test ran first (the same synthetic-tube frames: the
    large-pose scene keeps their poses and translations); the tool makes
    the copy a large-pose scene."""
    import shutil

    from recmv_tpu_torch.tools import bench_largepose

    if osp.isdir(osp.join(bench_dir, "bench_64_4", "result")):
        shutil.copytree(osp.join(bench_dir, "bench_64_4"), osp.join(bench_dir, "lp_64_4"),
                        ignore=shutil.ignore_patterns("bench_anim"))
    rec = bench_largepose.main(BENCH_ARGS + [
        "--annotated", "2", "--quality", "small", "--sample-pix", "64", "--steps", "2",
        "--scene", osp.join(bench_dir, "lp"), "--out", osp.join(bench_dir, "lp.json")])
    _holds_keys(rec, "bench_largepose.json")
    assert rec["start_idx"] == 2 and rec["large_motion_frames"] == 2
    assert rec["all_finite"] and rec["sdf_max_abs_delta"] == 0.0


def test_quality_tool_and_evaluation_on_cpu(bench_dir):
    from recmv_tpu_torch.tools import bench_quality, eval_chamfer

    out = osp.join(bench_dir, "q.json")
    rec = bench_quality.main(["--device", "cpu", "--image", "48", "--frames", "2", "--steps", "1",
                              "--init-epochs", "6", "--freeze-pose", "--scene",
                              osp.join(bench_dir, "q"), "--out", out])
    _holds_keys(rec, *QUALITY_RECORDS)
    assert rec["config"]["freeze_pose"] and rec["nricp_schedule"] == "quick-30+15"
    assert np.isfinite(rec["chamfer_l2_sym_mean"]) and rec["chamfer_l2_sym_mean"] > 0
    assert set(rec["mc_pred_to_gt_trend"]) == {"0", "1"}
    assert rec["canonical_diag_final"]["drift"] == {"pose": 0.0, "trans": 0.0, "cam": 0.0}
    with open(out) as f:
        assert json.load(f) == rec
    # eval_chamfer on the exports, against the JAX tool's formula
    from recmv_tpu.ops.knn import chamfer_distance
    from recmv_tpu.utils.io import load_obj

    scene = osp.join(bench_dir, "q_48_2")
    meshs = osp.join(scene, "result", "infer_s0", "meshs")
    got = eval_chamfer.main(["--data-root", scene, "--mesh-dir", meshs, "--device", "cpu"])
    want = np.mean([float(chamfer_distance(
        jnp.asarray(load_obj(osp.join(meshs, f"{fid:04d}_tube.obj"))[0]),
        jnp.asarray(np.load(osp.join(scene, "gt_meshes", f"{fid}.npz"))["verts"])))
        for fid in range(2)])
    assert _rel(got, want) < 1e-5


def test_rescore_tool_scores_a_checkpoint_as_the_quality_tool(bench_dir):
    """After the quality tool's run on the same scene: ``rescore_quality``
    on that run's final checkpoint, with its flags, scores it through the
    same ``bench_quality.score`` at the same ``deformerRatio``: the same
    keys and schedule, and scores within 20% of the run's. They are not
    equal: the run registers its training mesh (extracted at step 0, then
    moved by one SGD step), the tool a fresh extraction of the
    checkpoint's SDF (measured 3.4% apart in ``pred_to_gt``, 10.2% in the
    chamfer against the closed GT)."""
    from recmv_tpu_torch.tools import rescore_quality

    with open(osp.join(bench_dir, "q.json")) as f:
        want = json.load(f)
    scene = osp.join(bench_dir, "q_48_2")
    got = rescore_quality.main([
        "--ckpt", osp.join(scene, "result", "quality_final_s0.ckpt"), "--device", "cpu",
        "--image", "48", "--frames", "2", "--steps", "1", "--init-epochs", "6",
        "--freeze-pose", "--scene", osp.join(bench_dir, "q"),
        "--out", osp.join(bench_dir, "rescore.json")])
    assert got["opt_times"] == 1 and got["deformer_ratio"] == 0.5
    assert osp.isdir(osp.join(scene, "result", "rescore_s0", "meshs"))
    assert got["nricp_schedule"] == want["nricp_schedule"]
    assert set(got["per_garment_pred_to_gt"]) == set(want["per_garment_pred_to_gt"])
    for k in ("pred_to_gt_dist_per_frame", "chamfer_l2_sym_per_frame"):
        assert len(got[k]) == 2
        np.testing.assert_allclose(got[k], want[k], rtol=0.2, err_msg=k)
    for k in ("chamfer_l2_sym_mean", "chamfer_l2_sym_vs_closed_mean"):
        assert got[k] > 0 and _rel(got[k], want[k]) < 0.2, k


def test_fitting_tool_on_cpu(bench_dir):
    from recmv_tpu_torch.data.synthetic import generate_scene
    from recmv_tpu_torch.tools import fitting_garment_meshes

    scene = generate_scene(osp.join(bench_dir, "fit"), n_frames=1, image_size=32,
                           skinner_res=(17, 25, 9), device="cpu")
    rec = fitting_garment_meshes.main(["--data-root", scene, "--quick", "--device", "cpu"])
    assert set(rec) == {"garment", "fit_chamfer_l2", "n_verts", "n_gt_verts", "labels"}
    assert 0 < rec["fit_chamfer_l2"] < 1e-2 and rec["n_verts"] > 0
    assert rec["labels"] == ["bottom_curve", "neck"]
    assert osp.isfile(osp.join(scene, "gt_fits", "fit_report.json"))


def test_hot_step_tool_on_cpu(bench_dir):
    from recmv_tpu_torch import bench

    line = bench.main(["--device", "cpu", "--rays", "32", "--iters", "1", "--bench-dir",
                       bench_dir])
    extra = line["extra"]
    assert {"hot_step_ms", "rays_per_sec_per_chip", "hot_step_gflops", "mfu_pct_vs_f32_peak",
            "baseline_provenance"} <= set(extra)
    assert extra["hot_step_gflops"] > 0 and extra["device"] == "cpu"
    # the port's own fullstep record (the fullstep tool's test writes it into
    # the same directory) is the headline; without it, the hot step's rays/s
    if osp.isfile(osp.join(bench_dir, "bench_fullstep.json")):
        assert line["metric"] == "sec_per_step_amortized_1080p_fine"
        assert line["vs_baseline"] == round(1.5 / line["value"], 3)
        assert "projected_full_sequence" in extra and "fullstep" in extra
    else:
        assert line["metric"] == "rays_per_sec_per_chip"
        assert line["value"] == extra["rays_per_sec_per_chip"]


def test_freeze_pose_keeps_scene_leaves(bench_dir):
    """``freeze_pose`` on smoke.conf: over 2 training steps the poses,
    translations and camera leaves stay bit-equal; without it they move."""
    from recmv_tpu_torch.config import ConfigFactory
    from recmv_tpu_torch.core.builder import build_opt_net
    from recmv_tpu_torch.core.network import TrainConfig
    from recmv_tpu_torch.data.dataset import get_dataset_and_loader
    from recmv_tpu_torch.data.synthetic import ensure_scene, shrink_garment_init
    from recmv_tpu_torch.tools.bench_quality import freeze_pose

    scene = ensure_scene(osp.join(bench_dir, "freeze"), n_frames=2, image_size=48,
                         skinner_res=(17, 25, 9), device="cpu")
    moved = {}
    for frozen in (True, False):
        conf = ConfigFactory.parse_file(osp.join(ROOT, "configs", "synthetic", "smoke.conf"))
        if frozen:
            freeze_pose(conf)
        ds, _ = get_dataset_and_loader(scene, {"deformer": 256, "render": 256}, 2,
                                       shuffle=False, garment_type="synthetic-tube",
                                       data_type="synthe")
        net = build_opt_net(conf, ds, osp.join(scene, f"result_{frozen}"),
                            resolutions=((7, 9, 5), (13, 17, 9)), skinner_res=(17, 25, 9),
                            train_cfg=TrainConfig(sample_pix=64, raster_tile=16,
                                                  surface_sample=64, solver_times=4,
                                                  mc_capacity_v=1 << 12, mc_capacity_f=1 << 13),
                            device="cpu")
        shrink_garment_init(net.params)
        leaves = {k: v for k, v in net.global_leaves().items()
                  if k.startswith(("scene.poses", "scene.trans", "scene.camera"))}
        before = {k: v.detach().clone() for k, v in leaves.items()}
        gen = torch.Generator().manual_seed(0)
        for _ in range(2):
            net.train_step(ds.get_batch([0, 1]), [0, 1], RATIO, generator=gen)
        moved[frozen] = [k for k, v in leaves.items() if not torch.equal(v, before[k])]
    assert moved[True] == []
    assert {"scene.poses", "scene.trans", "scene.camera.focal_length"} <= set(moved[False])


def test_ensure_scene_reuses_or_regenerates(tmp_path):
    from recmv_tpu_torch.data.synthetic import ensure_scene

    kw = dict(n_frames=1, image_size=32, skinner_res=(17, 25, 9), device="cpu")
    scene = ensure_scene(str(tmp_path / "s"), **kw)
    marker = osp.join(scene, "result", "cache.txt")
    os.makedirs(osp.dirname(marker))
    open(marker, "w").close()
    assert ensure_scene(scene, **kw) == scene and osp.isfile(marker)   # reused
    ensure_scene(scene, **dict(kw, image_size=40))                     # other arguments
    assert not osp.exists(marker)
    with open(osp.join(scene, "scene_meta.json")) as f:
        assert json.load(f)["image_size"] == 40


def test_quality_report_sets_a_run_beside_its_record(tmp_path):
    """``quality_vs_records.compare`` on a TPU record against itself and
    against a copy whose trend leaves the band from step 150 on; beside a
    JAX CPU record (``jax_cpu``: the same keys and band), here the TPU
    record with its trend halved and its chamfer 0.8×; and
    ``jax_cpu_record``'s choice among the CPU records of a configuration:
    the one at the run's steps, and none when there is no such record."""
    import copy

    from recmv_tpu_torch.tools.quality_vs_records import CONFIGS, compare, jax_cpu_record

    with open(osp.join(ROOT, CONFIGS["tube512_gateon"][1])) as f:
        record = json.load(f)
    same = compare(record, record)
    assert same["in_band"] and same["trend_leaves_band_at"] is None
    assert same["config_differs"] == {} and same["chamfer_l2_sym_mean"][2] == 1.0
    run = copy.deepcopy(record)
    run["chamfer_l2_sym_mean"] *= 1.4
    run["config"]["steps"] = 400
    for k in run["mc_pred_to_gt_trend"]:
        if int(k) >= 150:
            run["mc_pred_to_gt_trend"][k] *= 1.5
    far = compare(run, record)
    assert not far["in_band"] and far["trend_leaves_band_at"] == 150
    assert far["config_differs"] == {"steps": (400, 500)}
    assert "jax_cpu" not in far

    cpu = copy.deepcopy(record)
    cpu["chamfer_l2_sym_mean"] *= 0.8
    cpu["mc_pred_to_gt_trend"] = {k: v / 2 for k, v in record["mc_pred_to_gt_trend"].items()}
    both = compare(record, record, cpu)
    assert both["in_band"] and both["trend_leaves_band_at"] is None
    beside = both["jax_cpu"]
    assert beside["chamfer_l2_sym_mean"] == (record["chamfer_l2_sym_mean"],
                                             cpu["chamfer_l2_sym_mean"], 1.25)
    assert beside["in_band"] and beside["trend_leaves_band_at"] == 0
    assert beside["mc_pred_to_gt_trend"]["0"][2] == 2.0
    assert beside["config_differs"] == {} and "device" not in beside

    assert jax_cpu_record("two", 120, str(tmp_path)) is None
    for name, steps in (("jax_cpu_two_steps1", 1), ("jax_cpu_two", 120)):
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump({"config": {"steps": steps}}, f)
    assert jax_cpu_record("two", 1, str(tmp_path))["config"]["steps"] == 1
    assert jax_cpu_record("two", 120, str(tmp_path))["config"]["steps"] == 120
    assert jax_cpu_record("two", 7, str(tmp_path)) is None
    os.remove(tmp_path / "jax_cpu_two.json")
    assert jax_cpu_record("two", 120, str(tmp_path)) is None
    assert jax_cpu_record("two", 1, str(tmp_path))["config"]["steps"] == 1


def test_quality_report_sets_the_pallas_scan_record_and_a_fresh_score_beside_a_run(tmp_path):
    """``quality_vs_records``: a run beside the JAX CPU record with the
    port's scan (``jax_cpu_pallas_scan``, read by ``jax_cpu_record(...,
    port_scan=True)``), and ``fresh_vs_training``: a run's scores beside
    ``rescore_quality``'s on its final checkpoint, with fresh / training."""
    import copy

    from recmv_tpu_torch.tools.quality_vs_records import (CONFIGS, compare, fresh_vs_training,
                                                          jax_cpu_record)

    with open(osp.join(ROOT, CONFIGS["two"][1])) as f:
        record = json.load(f)
    scan = copy.deepcopy(record)
    scan["chamfer_l2_sym_mean"] *= 0.5
    with open(tmp_path / "jax_cpu_two_pallas_scan.json", "w") as f:
        json.dump(scan, f)
    assert jax_cpu_record("two", 120, str(tmp_path)) is None
    got = jax_cpu_record("two", 120, str(tmp_path), port_scan=True)
    both = compare(record, record, None, got)
    assert "jax_cpu" not in both and both["jax_cpu_pallas_scan"]["chamfer_l2_sym_mean"][2] == 2.0
    fresh = dict(copy.deepcopy(record), device="card")
    fresh["chamfer_l2_sym_mean"] *= 1.25
    fresh["per_garment_pred_to_gt"]["skirt"] *= 0.5
    fv = fresh_vs_training(record, fresh)
    assert fv["chamfer_l2_sym_mean"] == (record["chamfer_l2_sym_mean"],
                                         fresh["chamfer_l2_sym_mean"], 1.25)
    assert fv["per_garment_pred_to_gt"]["skirt"][2] == 0.5
    assert fv["per_garment_pred_to_gt"]["upper_tube"][2] == 1.0 and fv["device"] == "card"


def test_jax_reference_names_and_exports_a_jax_run(tmp_path, monkeypatch):
    """``tests/jax_reference.py``, the harness that runs the JAX tool on
    the CPU: the record names, the scene directory names the
    two tools give each configuration, and ``--export``: the JAX run's
    scene without its outputs, the skinner cache, the initialization as the
    port's seed-0 cache and the port's ``scene_meta.json``, which the
    port's ``ensure_scene`` then reuses as it is; a run on a directory
    that holds an initialization needs ``--reuse-init``, which deletes the
    scene's cached registration before the tool runs, and the record (the
    tool's JSON with ``jax_cpu``) names no path of this run."""
    from recmv_tpu_torch.data.synthetic import ensure_scene
    import jax_reference as JR

    assert JR.record_name("two", 120) == "jax_cpu_two"
    assert JR.record_name("tube512_gateon", 1) == "jax_cpu_tube512_gateon_steps1"
    assert [JR.scene_of(n)[0] for n in ("tube512_gateon", "two", "skirt")] == [
        "tube512_gateon_512_8", "two_256_8_two", "skirt_256_8_skirt"]
    src = tmp_path / "jax" / "skirt_256_8_skirt"
    for rel in ("imgs/0000.png", "camera.npz", "result/initial_skinner_0.npz",
                "result/quality_init.ckpt", "result/quality_final.ckpt", "result/infer/x.obj",
                "scene_meta.json"):
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_text(rel)
    JR.main(["skirt", "--scene-dir", str(tmp_path / "jax"), "--export", str(tmp_path / "port")])
    out = tmp_path / "port" / "skirt_256_8_skirt"
    assert sorted(p.name for p in (out / "result").iterdir()) == [
        "initial_skinner_0.npz", "jax_final.ckpt", "quality_init_s0.ckpt"]
    assert (out / "result" / "jax_final.ckpt").read_text() == "result/quality_final.ckpt"
    assert (out / "result" / "quality_init_s0.ckpt").read_text() == "result/quality_init.ckpt"
    assert (out / "imgs" / "0000.png").read_text() == "imgs/0000.png"
    assert ensure_scene(str(out), n_frames=8, image_size=256, skinner_res=(33, 57, 17),
                        garment_type="synthetic-skirt") == str(out)
    assert (out / "camera.npz").is_file()
    with pytest.raises(SystemExit, match="holds an initialization"):
        JR.main(["skirt", "--scene-dir", str(tmp_path / "jax")])
    assert (src / "result" / "infer").is_dir()

    def fake_tool(cmd, **kw):          # the JAX tool, as far as its record goes
        assert cmd[:3] == ["taskset", "-c", "1"] and "--platform" in cmd
        assert not (src / "result" / "infer").exists()
        with open(cmd[cmd.index("--out") + 1], "w") as f:
            json.dump({"config": {"steps": int(cmd[cmd.index("--steps") + 1])}}, f)

    monkeypatch.setattr(JR.subprocess, "run", fake_tool)
    monkeypatch.setattr(JR, "RECORDS", str(tmp_path / "records"))
    monkeypatch.setattr(JR, "cpu_model", lambda: "cpu")
    rec = JR.main(["skirt", "--scene-dir", str(tmp_path / "jax"), "--reuse-init", "--cpus", "1"])
    assert rec["config"]["steps"] == 120 and rec["jax_cpu"]["init_reused"]
    assert "<scene>" in rec["jax_cpu"]["command"] and str(tmp_path) not in json.dumps(rec)
    assert (tmp_path / "records" / "jax_cpu_skirt.json").is_file()
    assert "XLA" in rec["jax_cpu"]["scan"]
    # --port-scan: the tool runs in the harness's process with the port's scan
    assert JR.record_name("skirt", 1, port_scan=True) == "jax_cpu_skirt_steps1_pallas_scan"
    rec = JR.main(["skirt", "--scene-dir", str(tmp_path / "jax"), "--reuse-init", "--cpus", "1",
                   "--port-scan"])
    assert "tests/jax_reference.py --tool-with-port-scan --platform cpu" in rec["jax_cpu"][
        "command"] and "Pallas" in rec["jax_cpu"]["scan"]
    assert (tmp_path / "records" / "jax_cpu_skirt_pallas_scan.json").is_file()
