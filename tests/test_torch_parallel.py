"""The port's multi-rank training step (``recmv_tpu_torch/parallel``,
``GarmentOptimNetwork.set_parallel``) on the CPU over gloo, one intra-op
thread per rank, ranks spawned over a ``file://`` store.

(a) the mesh, ``pad_to_devices`` and the slicing helpers, as
    ``tests/test_parallel.py::TestMeshBasics`` holds the JAX ones;
(b) one whole ``train_step`` (① with the curve-aware term, ②, seeding,
    the solve, ③ with the DCT prior, the three updates) on a 48 px
    synthetic tube of 32 frames (more than the DCT window's 30), sharded
    over 2 ranks (data=1) and over 4 ranks (data=2, 3 frames in blocks of
    2 and 1), and over 2 ranks with data=2 on 1 frame (the second data
    block empty, as GSPMD pads) and in the large-pose stage (no ①, the
    SDFs frozen), against the port's single-process step (a process of
    its own) on the same injected draws (the 1-frame step: draws from
    one seeded generator on every rank); the ranks' replicated state bit
    for bit; after the 2-rank step a remesh, which rank 0 extracts and
    broadcasts;
(c) the 4-rank data=2 step on 2 frames against the JAX package's step
    sharded over ``make_mesh(4, data=2)`` (conftest's virtual CPU
    devices; the JAX mesh needs the frames to divide over 'data'), with
    the JAX draws replayed as ``test_torch_curves`` does.

Both packages' SDFs are 8×128 here (the flagship width is 8×512): at 512
the curve-aware term's 50,000 bf16 draws take most of a step on one
thread and the file ran past its minute. The draws are not cut.

Tolerances (float32) and why:
- (b) data=1: info within 1e-5 relative, ray counts equal, every
  parameter within 1e-6 (measured 2.4e-7). ① and ② run whole on every
  rank and only the first rank of the data group keeps them; the per-ray
  terms sum in another order;
- (b) data=2 on 1 frame: as data=1 (② runs whole on rank 0);
- (b) data=2 on 3 frames (the large-pose step too): the same, but for
  the translator's weights and the ② gradient norm. The translator
  takes bf16 operands and, as the JAX transposes do, rounds each weight
  gradient to bf16 where it is summed over the rows; with the frames
  split, each block's partial gradient is rounded apart (measured 4e-3
  of ②'s translator gradient, 1.9e-5 of ``gnorm_pc``). So ``gnorm_pc``
  within 1e-4, and the translator's weights as ``test_torch_train``
  holds Adam updates: the entries whose gradient is above 1e-3 of the
  leaf's largest within 2e-2 of lr, all within 2·lr (Adam's first step
  moves an entry by lr·g/(|g| + 1e-8), so a flipped sign moves it by up
  to 2·lr: 241 of 262,144 entries of one layer measured);
- (c): ``test_torch_train``'s info tolerances (1e-4 relative, gradient
  norms 1e-3), tighter than ``tests/test_parallel.py``'s sharded JAX
  against one device (1e-4 on the branch losses, 2e-2 on the loss), the
  curve-aware value within 5e-6 as ``test_torch_curves``; converged rays
  within ``tests/test_parallel.py``'s max(2, 10%) and budgets equal. The
  pc-sdf value (weighed 0 here, as in ``test_torch_train``) within 1e-2
  relative: at these widths the two packages' bf16 evaluations differ by
  1.3e-5 of 2.8e-3 (``test_torch_train`` measured 1.3e-6 at 8×512), and
  the JAX step gives the same value sharded as on one device (2.7869e-3
  both).
"""

import functools
import hashlib
import os
import threading

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
RATIO = {"sdfRatio": 1.0, "deformerRatio": 0.5, "renderRatio": 1.0}
N_FRAMES, IMG, WIDTH = 32, 48, 128   # more frames than the DCT window's 30: the prior runs
FIDS_B = [0, 1, 2]        # (b): 3 frames, blocks of 2 and 1 over data=2
FIDS_C = [1, 3]           # (c): 2 frames, the JAX mesh divides them
FIDS_E = [2]              # (b): 1 frame, the second data block empty
KEY = 3
PYR = ((7, 9, 5), (13, 17, 9))


def _narrow(module):
    """``module.init_sdf_net`` with 8×WIDTH hidden layers."""
    return functools.partial(module.init_sdf_net, dims=(WIDTH,) * 8)


def _train_cfg(cls):
    return cls(sample_pix=64, point_radius=0.025, remesh_intersect=8, mc_capacity_v=1 << 12,
               mc_capacity_f=1 << 13, raster_tile=16, raster_cap_mesh=4096,
               raster_cap_points=4096, solver_times=20, surface_sample=64)


class _ZeroPcSdf:
    """A config view with the pc-sdf weight at 0 (as ``test_torch_train``'s
    ``_NoPcSdfConf``, for the comparison with JAX)."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, k):
        return getattr(self._inner, k)

    def get_float(self, path, default=None):
        return 0.0 if path == "pc_weight.weight" else self._inner.get_float(path, default)


def _port_net(spec):
    """The port's network on the module's scene on the CPU, built as
    ``test_torch_train._build_pair`` builds it (its skinner cache); each
    case restores the saved state into it (``_restore``)."""
    from recmv_tpu_torch.config import ConfigFactory
    from recmv_tpu_torch.core import network
    from recmv_tpu_torch.core.builder import build_opt_net
    from recmv_tpu_torch.data.dataset import get_dataset_and_loader
    from recmv_tpu_torch.models import garment_model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(garment_model, "init_sdf_net", _narrow(garment_model))
        ds, _ = get_dataset_and_loader(spec["scene"], {"deformer": 256, "render": 256}, 2,
                                       shuffle=False, garment_type="synthetic-tube",
                                       data_type="synthe")
        net = build_opt_net(ConfigFactory.parse_file(spec["conf"]), ds, spec["port_root"],
                            resolutions=PYR, skinner_res=(17, 25, 9),
                            train_cfg=_train_cfg(network.TrainConfig), device="cpu")
    net.base_conf = net.conf
    return net


def _restore(net, spec, case):
    """The module's state in ``net`` for ``case``: the saved checkpoint and
    mesh, the curve-aware term fired, the pc-sdf weight at 0 where the
    case compares with JAX, the large-pose stage where it asks for it."""
    from recmv_tpu_torch.core import network

    net.set_parallel(None)
    net.conf = _ZeroPcSdf(net.base_conf) if case["zero_pc_sdf"] else net.base_conf
    net.load_checkpoint(spec["ckpt"])
    m = np.load(spec["mesh"])
    G = len(net.statics.garment_names)
    net.mesh = network.MeshState(
        body_n=int(m["body_n"]), garment_vs=[torch.tensor(m[f"vs{i}"]) for i in range(G)],
        garment_fs=[torch.tensor(m[f"fs{i}"]) for i in range(G)],
        garment_n=[int(x) for x in m["n"]], garment_fn=[int(x) for x in m["fn"]])
    net.reset_vertex_optimizer()
    net._remeshed_at = net.opt_times
    net.dataset.garment_type = "female_outfit3"
    net.isfine = True
    net.large_pose = case.get("large_pose", False)
    net._init_global_opt()
    return net


def _named_state(net) -> dict:
    out = {k: v.detach().numpy().copy() for k, v in net.global_leaves().items()}
    out.update({f"curves.{k}": v.detach().numpy().copy()
                for k, v in net.params["curves"].items()})
    out.update({f"verts.{i}": v.detach().numpy().copy() for i, v in enumerate(net.mesh.garment_vs)})
    return out


def _digest(net) -> str:
    h = hashlib.sha256()
    for t in net.replicated_tensors():
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _step(net, spec, case):
    """One step (the case's draws, or draws from a generator of its seed)
    → loss, info, the named state after it, the digest of the
    replicated state and the translator weights' Adam gradients (10× the
    first moment after a fresh Adam's first step)."""
    fids = case["fids"]
    gen = torch.Generator().manual_seed(case["seed"]) if "seed" in case else None
    loss, info = net.train_step(spec["batches"][tuple(fids)], fids, RATIO, generator=gen,
                                draws=case.get("draws"))
    grads = {k: 10.0 * net.global_opt.state[p]["exp_avg"].numpy()
             for k, p in net.global_leaves().items() if k.startswith("translator.")}
    return dict(loss=loss, info=dict(info), state=_named_state(net), digest=_digest(net),
                grads=grads)


def _rank_main(rank, path, data, which):
    """One rank: the mesh's facts, then each case ``which`` names (of the
    spec pickled at ``path``) as a sharded step from the module's state
    over a mesh of ``data`` (or the case's own ``data``)."""
    from recmv_tpu_torch.parallel import make_mesh

    spec = torch.load(path, weights_only=False)
    mesh = make_mesh(data=data, device="cpu")
    facts = dict(axis_names=mesh.axis_names, shape=dict(mesh.shape),
                 devices=mesh.devices.tolist(), coord=mesh.coord, device=str(mesh.device))
    try:
        make_mesh(data=3, device="cpu")
        facts["data=3"] = "accepted"
    except ValueError as e:
        facts["data=3"] = f"ValueError: {e}"
    out = dict(facts=facts, steps={})
    net = _port_net(spec)
    for c in which:
        case = spec["cases"][c]
        m = make_mesh(data=case["data"], device="cpu") if "data" in case else mesh
        _restore(net, spec, case).set_parallel(m)
        m.reset_comm()
        r = _step(net, spec, case)
        r["comm"] = dict(m.comm)
        if case.get("remesh"):
            net.marching_cube_update(RATIO)
            r["remesh"] = dict(digest=_digest(net), counts=(net.mesh.body_n, net.mesh.garment_n,
                                                            net.mesh.garment_fn))
        if rank:                              # rank 0's state is compared; the others' digests
            del r["state"], r["grads"]
        out["steps"][c] = r
    return out


def _one_process(_, path, which):
    """The port's single-process steps of the cases ``which`` names (a
    process of its own, beside the JAX compile)."""
    spec = torch.load(path, weights_only=False)
    net = _port_net(spec)
    return {c: _step(_restore(net, spec, spec["cases"][c]), spec, spec["cases"][c])
            for c in which}


def _in_thread(fn, *args, **kwargs):
    """Start ``fn`` in a thread → a call that joins it and returns its
    result (or raises its exception)."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kwargs)
        except BaseException as e:          # noqa: BLE001 - re-raised on join
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()

    def join():
        t.join()
        if "err" in box:
            raise box["err"]
        return box["out"]
    return join


# ---------------------------------------------------------------------------
# the module's state, the reference steps and the spawned ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from recmv_tpu import models as jmodels  # noqa: F401
    from recmv_tpu.models import garment_model as jgm
    from recmv_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from recmv_tpu_torch import bridge
    from recmv_tpu_torch.data.synthetic import generate_scene
    from recmv_tpu_torch.parallel import spawn
    from test_torch_curves import _curve_draws, _scene_curves
    from test_torch_train import _build_pair, _main_draws, _np_tree, _seed_uniforms

    root = tmp_path_factory.mktemp("torch_parallel")
    scene = generate_scene(str(root / "scene"), n_frames=N_FRAMES, image_size=IMG,
                           skinner_res=(17, 25, 9), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        from recmv_tpu_torch.models import garment_model
        mp.setattr(jgm, "init_sdf_net", _narrow(jgm))
        mp.setattr(garment_model, "init_sdf_net", _narrow(garment_model))
        net_j, net_t, ds_j = _build_pair(root, scene)
    curves_in = _scene_curves()
    net_j.align_fl(*curves_in)
    net_t.align_fl(*curves_in)
    bridge.load_curves(net_t, _np_tree(net_j.params["curves"]), net_j.curve_statics)
    for net in (net_j, net_t):
        net.dataset.garment_type = "female_outfit3"
        net.isfine = True
    batches = {tuple(f): ds_j.get_batch(f) for f in (FIDS_B, FIDS_C, FIDS_E)}

    def jax_step():                 # its compile is most of the file's time: started first
        net_j.set_parallel(jax_make_mesh(4, data=2))
        out = net_j.train_step(batches[tuple(FIDS_C)], FIDS_C, RATIO, jax.random.PRNGKey(KEY))
        net_j.set_parallel(None)
        return out

    def draws(fids):
        s = net_t.cfg.seed_downscale
        uniforms, key = _seed_uniforms(jax.random.PRNGKey(KEY), 1, len(fids) * (IMG // s) ** 2)
        curve, key = _curve_draws(key, net_t.curve_statics.v_dirs.shape[1])
        return {"uniforms": uniforms, "curve_aware": curve,
                "main": _main_draws(net_j, key, net_t.cfg.sample_pix * len(fids))}

    case_b = dict(fids=FIDS_B, draws=draws(FIDS_B), zero_pc_sdf=False)
    cases = {"b": case_b, "c": dict(fids=FIDS_C, draws=draws(FIDS_C), zero_pc_sdf=True),
             "e": dict(fids=FIDS_E, seed=KEY, zero_pc_sdf=False, data=2),
             "l": dict(case_b, large_pose=True, data=2), "r": dict(case_b, remesh=True)}
    jax_done = _in_thread(jax_step)
    spec = dict(scene=scene, conf=os.path.join(ROOT, "configs", "synthetic", "smoke.conf"),
                port_root=str(root / "port"), ckpt=str(root / "state.ckpt"),
                mesh=str(root / "mesh.npz"), batches=batches)
    net_t.save_checkpoint(spec["ckpt"], 0)
    G = len(net_t.statics.garment_names)
    np.savez(spec["mesh"], body_n=net_t.mesh.body_n, n=net_t.mesh.garment_n,
             fn=net_t.mesh.garment_fn,
             **{f"vs{i}": net_t.mesh.garment_vs[i].numpy() for i in range(G)},
             **{f"fs{i}": net_t.mesh.garment_fs[i].numpy() for i in range(G)})
    path = str(root / "spec.pt")
    torch.save(dict(spec, cases=cases), path)
    jobs = {2: _in_thread(spawn, _rank_main, 2, "gloo", args=(path, 1, "rel"), threads=1),
            4: _in_thread(spawn, _rank_main, 4, "gloo", args=(path, 2, "bc"), threads=1),
            1: _in_thread(spawn, _one_process, 1, "gloo", args=(path, "bel"), threads=1)}
    loss_j, info_j = jax_done()
    ranks = {n: job() for n, job in jobs.items()}
    return dict(single=ranks.pop(1)[0], ranks=ranks,
                jax=(loss_j, dict(info_j)), names=list(net_t.global_leaves()),
                lr=float(net_t.global_opt.param_groups[0]["lr"]))


# ---------------------------------------------------------------------------
# (a) the mesh and the slicing helpers
# ---------------------------------------------------------------------------

def _mesh(data, rays, rank=0, backend="gloo"):
    from recmv_tpu_torch.parallel import Mesh

    return Mesh(shape={"data": data, "rays": rays}, rank=rank, device=torch.device("cpu"),
                backend=backend)


@pytest.mark.parametrize("world, data", [(2, 1), (4, 2)])
def test_make_mesh_axes(runs, world, data):
    """``make_mesh`` over the process group: axes, shape, the (data, rays)
    array of ranks row-major as the JAX mesh reshapes its devices, each
    rank's coordinate; a data axis that does not divide the world
    refused."""
    for rank, out in enumerate(runs["ranks"][world]):
        f = out["facts"]
        assert f["axis_names"] == ("data", "rays")
        assert f["shape"] == {"data": data, "rays": world // data}
        assert f["devices"] == np.arange(world).reshape(data, world // data).tolist()
        assert f["coord"] == divmod(rank, world // data) and f["device"] == "cpu"
        assert f["data=3"].startswith("ValueError")


def test_make_mesh_needs_a_process_group():
    from recmv_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(data=2)


def test_pad_to_devices():
    """As the JAX ``pad_to_devices``: zeros up to a multiple of the rank
    count, the original size returned; numpy and torch alike."""
    from recmv_tpu_torch.parallel import pad_to_devices

    mesh = _mesh(1, 8)
    x = np.arange(13 * 3, dtype=np.float32).reshape(13, 3)
    xp, n = pad_to_devices(x, mesh)
    assert n == 13 and xp.shape == (16, 3)
    np.testing.assert_array_equal(xp[:13], x)
    assert (xp[13:] == 0).all()
    tp, n = pad_to_devices(torch.from_numpy(x).T, mesh, axis=1)
    assert n == 13 and tp.shape == (3, 16)
    np.testing.assert_array_equal(tp.numpy()[:, :13], x.T)
    assert not tp[:, 13:].any()
    same, n = pad_to_devices(x[:8], mesh)
    assert same is not None and n == 8 and same.shape == (8, 3)


@pytest.mark.parametrize("n", [64, 13, 3])
def test_shard_rays_splits_over_every_rank(n):
    """Rays over data×rays collapsed: equal contiguous shares of the padded
    list, together the list in order; ``ray_share`` the real rows of each."""
    from recmv_tpu_torch.parallel import ray_share, shard_rays

    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3) + 1
    parts = [shard_rays(_mesh(2, 4, rank), x) for rank in range(8)]
    per = -(-n // 8)
    assert all(p.shape == (per, 3) for p in parts)
    got = np.concatenate(parts)
    np.testing.assert_array_equal(got[:n], x)
    assert not got[n:].any()
    spans = [ray_share(n, _mesh(2, 4, rank)) for rank in range(8)]
    assert [hi - lo for lo, hi in spans] == [int((p != 0).any(1).sum()) for p in parts]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert ray_share(n, None) == (0, n)


@pytest.mark.parametrize("n_frames, data, blocks", [
    (3, 2, [(0, 2), (2, 3)]), (4, 2, [(0, 2), (2, 4)]), (1, 2, [(0, 1), (1, 1)]),
    (2, 1, [(0, 2)])])
def test_frame_share(n_frames, data, blocks):
    """Frames over 'data' in contiguous blocks of ceil(n / data); weight 1
    on the first rank of each data group whose block holds a frame, so
    every frame counts once over the ranks; an empty block computes on
    frame 0 with weight 0; on one device the whole batch."""
    from recmv_tpu_torch.parallel import frame_share

    rays = 2
    frames = np.arange(n_frames)
    counted = []
    for rank in range(data * rays):
        sh = frame_share(n_frames, _mesh(data, rays, rank))
        d, r = divmod(rank, rays)
        assert (sh.lo, sh.hi) == blocks[d] and sh.n == n_frames
        assert sh.weight == float(r == 0 and sh.hi > sh.lo)
        if sh.hi == sh.lo:
            assert sh.rows == slice(0, 1)
        counted += list(frames[sh.rows]) * int(sh.weight)
    assert sorted(counted) == list(frames)
    one = frame_share(n_frames, None)
    assert (one.lo, one.hi, one.weight, one.mesh) == (0, n_frames, 1.0, None)


def test_nccl_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="nccl"):
        _mesh(1, 2, backend="nccl").check_device("cpu")
    with pytest.raises(ValueError, match="rank's device"):
        _mesh(1, 2).check_device("cuda:1")


# ---------------------------------------------------------------------------
# (b) the sharded step against the port's single-process step
# ---------------------------------------------------------------------------

def _info_close(got, want, rtol, loose=()):
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith(("_rayConv", "_rayBudget")):
            assert got[k] == v, k
            continue
        tol = 1e-4 if k in loose else rtol
        np.testing.assert_allclose(got[k], v, rtol=tol, atol=1e-7, err_msg=k)


# (world, data, case): the old ids kept for the 3-frame steps
SHARDED = [pytest.param(2, 1, "r", id="2-1"), pytest.param(4, 2, "b", id="4-2"),
           pytest.param(2, 2, "e", id="2-2-empty-block"),
           pytest.param(2, 2, "l", id="2-2-large-pose")]


def _reference(runs, case):
    return runs["single"]["b" if case == "r" else case]


@pytest.mark.parametrize("world, data, case", SHARDED)
def test_sharded_step_matches_one_process(runs, world, data, case):
    """(b) The loss, every info scalar and the ray counts of rank 0 against
    the single-process step on the same draws, ① and the curve-aware term
    included, the large-pose stage without ① and with the DCT prior
    (module docstring)."""
    single, got = _reference(runs, case), runs["ranks"][world][0]["steps"][case]
    assert {"curve_aware_loss", "dct_loss", "tube_rayConv"} <= set(single["info"])
    assert single["info"]["tube_rayConv"] > 0 and single["info"]["curve_aware_loss"] > 0
    assert single["info"]["dct_loss"] > 0
    assert ("fl_loss_total" in single["info"]) == (case != "l")
    split = data > 1 and case != "e"          # with 1 frame ② runs whole on rank 0
    _info_close(got["info"], single["info"], 1e-5, loose=("gnorm_pc",) if split else ())
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-5)


@pytest.mark.parametrize("world, data, case", SHARDED)
def test_sharded_step_parameters_match_one_process(runs, world, data, case):
    """(b) Every global leaf, the curves and the vertex buffers after the
    step within 1e-6 of the single-process step's; where ② splits its
    frames over data=2, the translator's weights as the module docstring
    says."""
    single = _reference(runs, case)
    got = runs["ranks"][world][0]["steps"][case]["state"]
    lr = runs["lr"]
    split = data > 1 and case != "e"          # with 1 frame ② runs whole on rank 0
    assert set(got) == set(single["state"])
    loose = []
    for k, want in single["state"].items():
        if split and k.startswith("translator.") and k.endswith(".W"):
            g = np.abs(single["grads"][k])
            stable = g > 1e-3 * g.max()
            assert stable.mean() > 0.25, k
            np.testing.assert_allclose(got[k][stable], want[stable], rtol=0, atol=2e-2 * lr,
                                       err_msg=k)
            np.testing.assert_allclose(got[k], want, rtol=0, atol=2 * lr * (1 + 1e-3), err_msg=k)
            loose.append(k)
            continue
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-6, err_msg=k)
    assert bool(loose) == split


@pytest.mark.parametrize("world, data", [(2, 1), (4, 2)])
def test_ranks_hold_the_same_state(runs, world, data):
    """(b) After each step every rank's replicated state (leaves, curves,
    the three optimizers' states, mesh buffers) is bit for bit rank 0's,
    and so is its info."""
    outs = runs["ranks"][world]
    for c in outs[0]["steps"]:
        steps = [o["steps"][c] for o in outs]
        assert len({s["digest"] for s in steps}) == 1
        assert all(s["info"] == steps[0]["info"] for s in steps)
        assert steps[0]["comm"]["calls"] > 0


# ---------------------------------------------------------------------------
# (c) the sharded step against the JAX package's sharded step
# ---------------------------------------------------------------------------

def test_sharded_step_matches_jax_sharded(runs):
    """(c) The port's 4-rank data=2 step on 2 frames against the JAX step
    sharded over ``make_mesh(4, data=2)`` with the JAX draws replayed:
    every info scalar, the curve-aware value and the loss (module
    docstring)."""
    from test_torch_train import _assert_info_close

    loss_j, info_j = runs["jax"]
    got = runs["ranks"][4][0]["steps"]["c"]
    info = got["info"]
    assert info_j["fl_loss_total"] > 0 and info["curve_aware_loss"] > 1e-3
    for k, v in info_j.items():
        if k.endswith("_rayConv"):
            assert abs(info[k] - v) <= max(2, 0.1 * v), (k, v, info[k])
        if k.endswith("_rayBudget"):
            assert info[k] == v, k
    bf16 = ("curve_aware_loss", "pc_tube_loss_sdf")
    _assert_info_close(info, {k: v for k, v in info_j.items()
                              if k not in bf16 and not k.endswith("_rayConv")})
    np.testing.assert_allclose(info["pc_tube_loss_sdf"], info_j["pc_tube_loss_sdf"], rtol=1e-2)
    np.testing.assert_allclose(info["curve_aware_loss"], info_j["curve_aware_loss"], atol=5e-6,
                               rtol=0)
    np.testing.assert_allclose(got["loss"], loss_j, rtol=1e-4)


def test_remesh_is_rank_zeros(runs):
    """After the 2-rank step each rank calls ``marching_cube_update``: rank
    0 extracts, the other receives its counts and buffers, and the
    replicated state (the new buffers, the fresh vertex SGD and curve
    AdamW) is the same bits on both; the mesh is the one-process remesh's
    (its live counts)."""
    outs = runs["ranks"][2]
    after = [o["steps"]["r"]["remesh"] for o in outs]
    assert after[0]["digest"] == after[1]["digest"]
    assert after[0]["counts"] == after[1]["counts"]
    assert after[0]["digest"] != outs[0]["steps"]["r"]["digest"]
    assert min(after[0]["counts"][1]) > 100
