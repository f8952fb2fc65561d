"""The port's CUDA kernels against their plain PyTorch versions, and the
port's independence from JAX. This file imports no JAX, so it also runs
where JAX is absent (the repo's ``conftest.py`` imports JAX; skip it
there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests marked ``gpu`` need a CUDA device and skip without one. The CPU
tests hold the kernels' per-warp culls to their promises: the composite
kernels' (``subtile_keep``, the plain model of ``may_touch``) drops only
(pixel, candidate) pairs with raw = 1 − d²/r² ≤ 0, so w == 0 in float32;
the mesh kernel's (``subtile_keep_faces``, the plain model of
``may_cover``) drops only pairs outside the face, and keeps exactly what
its corner test says; and a walk over the culled lists gives the dense
walk's bits in both. Kernel tolerances: the mesh kernel gives the plain
version's bits (zbuf, face ids, barycentrics: the same float32
operations in the same order); composite within 1e-5 absolute (float32,
the plain version's cumulative product and sum run in another order);
the composite's backward within 1e-5 of the largest plain entry (sums
over pixels and candidates in another order), and the same bits on a
second launch (no atomics).
"""

import os
import os.path as osp
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_tris(seed, V, F, size):
    rng = np.random.RandomState(seed)
    verts = np.stack([rng.rand(V) * size, rng.rand(V) * size, 1.0 + rng.rand(V)], 1)
    return verts.astype(np.float32), rng.randint(0, V, (F, 3)).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("tile,cap,F", [(8, 300, 600), (16, 300, 600), (32, 300, 600),
                                        (32, 1024, 2500)])
def test_mesh_tiles_kernel_matches_plain(cuda, tile, cap, F):
    """K1 against its plain version: the same bits in zbuf, face ids and
    barycentrics (the cull drops only pairs whose z candidate is BIG), at
    tile 8, 16 and 32, and at the scene generator's cap of 1024 with tiles
    filled to it (one segment of 53 KB of shared memory)."""
    from recmv_tpu_torch.ops.mesh_raster import _mesh_tiles_torch, mesh_tiles
    from recmv_tpu_torch.ops.rasterizer import mesh_tile_inputs

    verts, faces = _random_tris(5, V=400, F=F, size=256)
    v = np.stack([verts, verts[:, [1, 0, 2]]])             # two frames
    args = mesh_tile_inputs(torch.as_tensor(v, device=cuda),
                            torch.as_tensor(faces, device=cuda), (256, 250), tile=tile,
                            cap=cap) + (tile,)
    before = mesh_tiles.launches
    got = mesh_tiles(*args)
    want = _mesh_tiles_torch(*args)
    torch.cuda.synchronize()
    assert mesh_tiles.launches == before + 1
    # the binning copies a face to at most 3×3 tiles, so at tile 8 the
    # larger faces cover less
    assert (want[1] >= 0).float().mean().item() > (0.2 if tile == 8 else 0.3)
    assert int(args[2].max()) == cap or cap == 300
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_mesh_tiles_kernel_worst_case(cuda):
    """Large faces that reach every sub-tile, at the largest cap the launch
    accepts (65535: every warp lists every candidate, staged in 16
    segments of shared memory): the same bits as the plain version."""
    from recmv_tpu_torch.ops.mesh_raster import MAX_CAP, _mesh_tiles_torch, mesh_tiles
    from recmv_tpu_torch.ops.rasterizer import mesh_tile_inputs

    rng = np.random.RandomState(9)
    F = MAX_CAP
    # bounding boxes from x, y in [-0.9, -0.5] (tile −1, so the binning's
    # 3×3 tiles reach tiles 0 and 1) to 200: each face covers the image
    base = np.array([[-0.9, -0.9], [200.0, -0.9], [-0.9, 200.0]], np.float32)
    xy = base[None] + rng.rand(F, 3, 2).astype(np.float32) * 0.4
    xy[1::2] = xy[1::2, ::-1]                              # both windings
    z = 1.0 + rng.rand(F, 3).astype(np.float32)
    verts = np.concatenate([xy, z[..., None]], -1).reshape(-1, 3)
    faces = np.arange(3 * F, dtype=np.int32).reshape(F, 3)
    args = mesh_tile_inputs(torch.as_tensor(verts, device=cuda)[None],
                            torch.as_tensor(faces, device=cuda), (64, 64), tile=32,
                            cap=MAX_CAP) + (32,)
    assert int(args[2].min()) == MAX_CAP
    got = mesh_tiles(*args)
    want = _mesh_tiles_torch(*args)
    torch.cuda.synchronize()
    assert bool((want[1] >= 0).all())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_mesh_tiles_kernel_on_body_zbuffer(cuda, monkeypatch):
    """The ① body z-buffer: the synthetic body posed to three frames, seen
    by the synthetic scene's camera at 1080², rasterized at 1/4 resolution
    (270², tile 32, cap 512) by ``visibility.mesh_zbuf_image``, which fills
    the empty pixels with each frame's largest vertex depth: the kernel
    gives the plain version's bits, and the kernel launched once."""
    from recmv_tpu_torch.core import visibility
    from recmv_tpu_torch.core.builder import apose_from_type
    from recmv_tpu_torch.data.synthetic import make_camera_params
    from recmv_tpu_torch.models.camera import make_camera
    from recmv_tpu_torch.models.skinner import initial_lbs_skinner, skinner_apply
    from recmv_tpu_torch.models.smpl import synthetic_body_model
    from recmv_tpu_torch.ops import rasterizer
    from recmv_tpu_torch.ops.mesh_raster import _mesh_tiles_torch, mesh_tiles

    sk, body_vs, body_fs = initial_lbs_skinner(synthetic_body_model(),
                                               torch.zeros(10, device=cuda),
                                               apose_from_type(0), (33, 57, 17))
    rng = np.random.RandomState(3)
    poses = torch.as_tensor(0.2 * rng.randn(3, 24, 3).astype(np.float32), device=cuda)
    poses[:, 0, 1] = torch.tensor([0.0, 2.0, 4.0], device=cuda)          # three yaws
    posed = skinner_apply(sk, body_vs[None].expand(3, -1, -1), poses,
                          torch.zeros(3, 3, device=cuda))
    c = make_camera_params(1080)
    cam = make_camera({"focal_length": np.array([c["fx"], c["fy"]]),
                       "princeple_points": np.array([c["cx"], c["cy"]]),
                       "cam2world_coord_quat": c["quat"], "world2cam_coord_trans": c["T"]},
                      (1080, 1080), device=cuda)
    faces = torch.as_tensor(np.asarray(body_fs), device=cuda)
    with torch.no_grad():
        mesh_tiles.launches = 0
        got = visibility.mesh_zbuf_image(cam, posed, faces, (1080, 1080), tile=32, cap=512,
                                         downscale=4)
        assert mesh_tiles.launches == 1
        monkeypatch.setattr(rasterizer, "mesh_tiles", _mesh_tiles_torch)
        want = visibility.mesh_zbuf_image(cam, posed, faces, (1080, 1080), tile=32, cap=512,
                                          downscale=4)
    torch.cuda.synchronize()
    assert got.shape == (3, 270, 270)
    assert torch.equal(got, want)
    for zb in want:
        covered = (zb < zb.max()).float().mean().item()
        assert 0.02 < covered < 0.9


@pytest.mark.gpu
def test_marching_cubes_on_the_card_matches_the_cpu(cuda):
    """The device marching cubes (plain PyTorch ops, no kernel of its own)
    on the card: a seeded noisy sphere at 97 x 113 x 129 gives the CPU
    run's faces and vertex order exactly, the vertices within two float32
    roundings (the card's compiler may contract a product and a sum)."""
    from recmv_tpu_torch.ops.marching_cubes import marching_cubes

    rng = np.random.RandomState(3)
    axes = [np.linspace(-1.0, 1.0, n, dtype=np.float32) for n in (97, 113, 129)]
    z, y, x = np.meshgrid(*axes, indexing="ij")
    vol = (np.sqrt(x * x + y * y + z * z) - 0.6
           + 0.05 * rng.randn(*x.shape)).astype(np.float32)
    spacing = (2 / 128, 2 / 112, 2 / 96)
    v, f = marching_cubes(torch.as_tensor(vol), 0.01, (-1.0,) * 3, spacing, 1 << 20, 1 << 21)
    vc, fc = marching_cubes(torch.as_tensor(vol, device=cuda), 0.01, (-1.0,) * 3, spacing,
                            1 << 20, 1 << 21)
    assert len(v) > 50000
    assert torch.equal(fc.cpu(), f)
    tol = 2 * (max(spacing) * float(np.spacing(np.float32(129)))
               + float(np.spacing(np.float32(v.abs().max().item()))))
    assert (vc.cpu() - v).abs().max().item() <= tol


@pytest.mark.gpu
def test_mesh_tiles_kernel_on_visibility_scan(cuda, monkeypatch):
    """The registration's visibility scan: a seeded closed mesh (an MC
    sphere with noise, ~100k faces, so tiles exceed the cap) seen from the
    12 turntable cameras of ``visible_vertex_mask`` at 512², tile 32, cap
    512: the kernel gives the plain version's bits, the scan is one
    launch, and both give the same visible vertices."""
    from recmv_tpu_torch.core import inference
    from recmv_tpu_torch.native import marching_cubes_host
    from recmv_tpu_torch.ops import rasterizer
    from recmv_tpu_torch.ops.mesh_raster import _mesh_tiles_torch, mesh_tiles

    lin = np.linspace(-0.6, 0.6, 129, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    v, f = marching_cubes_host(np.sqrt(x * x + y * y + z * z) - 0.5, 0.0, (-0.6,) * 3,
                               (lin[1] - lin[0],) * 3)
    v = v + 0.002 * np.random.RandomState(9).randn(*v.shape).astype(np.float32)
    calls = []

    def record(*args):
        calls.append(args)
        return mesh_tiles(*args)

    monkeypatch.setattr(rasterizer, "mesh_tiles", record)
    mesh_tiles.launches = 0
    got = inference.visible_vertex_mask(v, f, device=cuda)
    assert mesh_tiles.launches == 1 and len(calls) == 1
    prm, fid, cnt, Wt, tile = calls[0]
    assert prm.shape[:2] == (12, 256) and prm.shape[3] == 512 and Wt == 16 and tile == 32
    assert int((cnt == 512).sum()) > 0                    # tiles over the cap
    with torch.no_grad():
        k = mesh_tiles(*calls[0])
        p = _mesh_tiles_torch(*calls[0])
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    monkeypatch.setattr(rasterizer, "mesh_tiles", _mesh_tiles_torch)
    want = inference.visible_vertex_mask(v, f, device=cuda)
    np.testing.assert_array_equal(got, want)
    assert 0.3 < got.mean() < 1.0


@pytest.mark.gpu
def test_mesh_tiles_kernel_on_turntable(cuda, monkeypatch):
    """The debug turntable: a seeded closed mesh (an MC sphere with noise,
    ~65k faces, so tiles exceed the cap) from the 8 turntable cameras at
    256², tile 32, cap 256, in one launch: the kernel gives the plain
    version's bits (the cap leaves holes: 4.7% of the pixels covered)."""
    from recmv_tpu_torch.native import marching_cubes_host
    from recmv_tpu_torch.ops import rasterizer
    from recmv_tpu_torch.ops.mesh_raster import _mesh_tiles_torch, mesh_tiles
    from recmv_tpu_torch.utils.debug_vis import turntable_cameras

    lin = np.linspace(-0.6, 0.6, 101, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    v, f = marching_cubes_host(np.sqrt(x * x + y * y + z * z) - 0.5, 0.0, (-0.6,) * 3,
                               (lin[1] - lin[0],) * 3)
    v = v + 0.002 * np.random.RandomState(3).randn(*v.shape).astype(np.float32)
    verts = torch.as_tensor(v, device=cuda)
    scr = torch.stack([rasterizer.screen_with_cam_z(c, verts)
                       for c in turntable_cameras(8, 256, cuda)])
    mesh_tiles.launches = 0
    args = rasterizer.mesh_tile_inputs(scr, torch.as_tensor(f, device=cuda), (256, 256),
                                       tile=32, cap=256) + (32,)
    prm, fid, cnt, Wt, tile = args
    assert prm.shape[:2] == (8, 64) and prm.shape[3] == 256 and Wt == 8
    assert int((cnt == 256).sum()) > 0                    # tiles over the cap
    with torch.no_grad():
        k = mesh_tiles(*args)
        p = _mesh_tiles_torch(*args)
    torch.cuda.synchronize()
    assert mesh_tiles.launches == 1
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert (p[1] >= 0).float().mean().item() > 0.01


@pytest.mark.gpu
def test_composite_kernel_matches_plain(cuda):
    from recmv_tpu_torch.ops.composite import _composite_tiles_torch, composite_tiles

    rng = np.random.RandomState(6)
    B, T, cap, C = 2, 16, 600, 3                          # cap > one 256-candidate chunk
    cx = torch.as_tensor(rng.rand(B, T, cap) * 128, dtype=torch.float32, device=cuda)
    cy = torch.as_tensor(rng.rand(B, T, cap) * 128, dtype=torch.float32, device=cuda)
    cnt = torch.as_tensor(rng.randint(0, cap + 1, (B, T)), dtype=torch.int32, device=cuda)
    val = (torch.arange(cap, device=cuda) < cnt[..., None]).to(torch.float32)
    feat = torch.as_tensor(rng.rand(B, T, C, cap), dtype=torch.float32, device=cuda)
    before = composite_tiles.launches
    got = composite_tiles(cx, cy, val, feat, 1.0 / 900.0, cnt, 4, 32)
    want = _composite_tiles_torch(cx, cy, val, feat, 1.0 / 900.0, cnt, 4, 32)
    torch.cuda.synchronize()
    assert composite_tiles.launches == before + 1
    assert want.max().item() > 0.5
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def _composite_case(rng, dev, B, T, cap, C, tile, Wt):
    span = Wt * tile
    cx = torch.as_tensor(rng.rand(B, T, cap) * span, dtype=torch.float32, device=dev)
    cy = torch.as_tensor(rng.rand(B, T, cap) * span, dtype=torch.float32, device=dev)
    cnt = torch.as_tensor(rng.randint(0, cap + 1, (B, T)), dtype=torch.int32, device=dev)
    cnt[0, 0] = cap
    val = (torch.arange(cap, device=dev) < cnt[..., None]).to(torch.float32)
    feat = torch.as_tensor(rng.rand(B, T, C, cap), dtype=torch.float32, device=dev)
    g = torch.as_tensor(rng.randn(B, T, C, tile * tile), dtype=torch.float32, device=dev)
    return cx, cy, val, feat, cnt, g


@pytest.mark.gpu
@pytest.mark.parametrize("C,tile,need_dfeat,cap", [(1, 32, False, 1536), (2, 32, True, 600),
                                                   (3, 16, True, 100), (2, 8, True, 70)])
def test_composite_bwd_kernel_matches_plain(cuda, C, tile, need_dfeat, cap):
    from recmv_tpu_torch.ops.composite import _composite_tiles_bwd_torch, composite_tiles_bwd

    rng = np.random.RandomState(C + tile)
    Wt = 4
    cx, cy, val, feat, cnt, g = _composite_case(rng, cuda, 2, 12, cap, C, tile, Wt)
    args = (cx, cy, val, feat, 1.0 / 40.0, cnt, Wt, tile, g, need_dfeat)
    before = composite_tiles_bwd.launches
    got = composite_tiles_bwd(*args)
    again = composite_tiles_bwd(*args)
    want = _composite_tiles_bwd_torch(*args)
    torch.cuda.synchronize()
    assert composite_tiles_bwd.launches == before + 2
    assert (got[2] is None) == (not need_dfeat)
    for a, b, c in zip(got, want, again):
        if b is None:
            continue
        assert torch.equal(a, c)
        torch.testing.assert_close(a, b, atol=1e-5 * max(1.0, b.abs().max().item()), rtol=0)


@pytest.mark.gpu
def test_composite_tiles_backward_on_cuda(cuda):
    """The K2 path keeps the graph on the card: the output requires grad and
    its backward launches K3, with the plain versions' gradients."""
    from recmv_tpu_torch.ops.composite import (composite_tiles, composite_tiles_bwd,
                                               composite_tiles_plain)

    rng = np.random.RandomState(3)
    cx, cy, val, feat, cnt, g = _composite_case(rng, cuda, 2, 16, 300, 2, 32, 4)
    grads = []
    for fn in (composite_tiles, composite_tiles_plain):
        x, y, f = (a.clone().requires_grad_(True) for a in (cx, cy, feat))
        before = composite_tiles_bwd.launches
        out = fn(x, y, val, f, 1.0 / 40.0, cnt, 4, 32)
        assert out.requires_grad
        out.backward(g)
        grads.append((x.grad, y.grad, f.grad, composite_tiles_bwd.launches - before))
    torch.cuda.synchronize()
    assert grads[0][3] == 1 and grads[1][3] == 0
    for a, b in zip(grads[0][:3], grads[1][:3]):
        torch.testing.assert_close(a, b, atol=1e-5 * max(1.0, b.abs().max().item()), rtol=0)


@pytest.mark.gpu
def test_wrappers_refuse_bad_inputs(cuda):
    from recmv_tpu_torch import _build
    from recmv_tpu_torch.ops.composite import composite_tiles
    from recmv_tpu_torch.ops.mesh_raster import MAX_CAP, mesh_tiles

    prm = torch.zeros(1, 4, 12, 8, device=cuda)
    cnt = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        mesh_tiles(prm, torch.zeros(1, 4, 8, device=cuda), cnt, 2, 32)      # fid not int32
    with pytest.raises(ValueError):
        mesh_tiles(prm, torch.zeros(1, 4, 8, dtype=torch.int32), cnt, 2, 32)   # on the CPU
    with pytest.raises(ValueError):                                        # cap above 65535
        mesh_tiles(torch.zeros(1, 1, 12, MAX_CAP + 1, device=cuda),
                   torch.zeros(1, 1, MAX_CAP + 1, dtype=torch.int32, device=cuda),
                   cnt[:, :1], 1, 32)
    # the C entry point refuses what the wrapper would catch, before a launch
    zb = torch.empty(1, 4, 24 * 24, device=cuda)
    fo = torch.empty(1, 4, 24 * 24, dtype=torch.int32, device=cuda)
    bc = torch.empty(1, 4, 3, 24 * 24, device=cuda)
    fid = torch.zeros(1, 4, 8, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.kernels()
    for tile, cap in ((24, 8), (32, MAX_CAP + 1)):
        assert lib.mesh_tiles_launch(prm.data_ptr(), fid.data_ptr(), cnt.data_ptr(),
                                     zb.data_ptr(), fo.data_ptr(), bc.data_ptr(), 1, 4, cap,
                                     2, tile, stream) != 0
    c = torch.zeros(1, 4, 8, device=cuda)
    with pytest.raises(ValueError):
        composite_tiles(c, c, c, torch.zeros(1, 4, 9, 8, device=cuda), 1.0, cnt, 2, 32)


def _real_splats(dev, seed, B, image, r_pix, n_pts, tile, C, cap):
    """composite_tile_inputs of a real splat: a blob of screen points (a
    dense disc plus a sparse scatter) at radius r_pix pixels."""
    from recmv_tpu_torch.ops.rasterizer import composite_tile_inputs

    rng = np.random.RandomState(seed)
    ang = rng.rand(B, n_pts) * 2 * np.pi
    rad = np.sqrt(rng.rand(B, n_pts)) * image * 0.3
    xy = np.stack([image / 2 + rad * np.cos(ang), image / 2 + rad * np.sin(ang)], -1)
    xy[:, ::7] = rng.rand(B, len(range(0, n_pts, 7)), 2) * image
    pts = np.concatenate([xy, 1.0 + rng.rand(B, n_pts, 1)], -1).astype(np.float32)
    feats = torch.as_tensor(rng.rand(n_pts, C), dtype=torch.float32, device=dev)
    radius = r_pix * 2.0 / image
    return composite_tile_inputs(torch.as_tensor(pts, device=dev), radius, feats,
                                 (image, image), tile=tile, cap=cap)


@pytest.mark.gpu
@pytest.mark.parametrize("tile,C,r_pix", [(32, 1, 1.62), (16, 2, 1.62), (32, 2, 3.24)])
def test_composite_kernels_on_real_splats(cuda, tile, C, r_pix):
    """K2 and K3 on the candidate lists of a real splat at the mask
    branch's radius: K2 within 1e-5, K3 within 1e-5 of the largest plain
    entry and the same bits on a second launch."""
    from recmv_tpu_torch.ops.composite import (_composite_tiles_bwd_torch,
                                               _composite_tiles_torch, composite_tiles,
                                               composite_tiles_bwd)

    cx, cy, val, feat, inv_r2, cnt, Wt = _real_splats(cuda, tile + C, 3, 256, r_pix, 20000,
                                                      tile, C, 1536)
    args = (cx, cy, val, feat, inv_r2, cnt, Wt, tile)
    got, want = composite_tiles(*args), _composite_tiles_torch(*args)
    assert want.max().item() > 0.5 and int(cnt.max()) > 256
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    gen = torch.Generator(device=cuda).manual_seed(tile)
    g = torch.randn(want.shape, generator=gen, device=cuda)
    for need in (False, True):
        got, again = composite_tiles_bwd(*args, g, need), composite_tiles_bwd(*args, g, need)
        want = _composite_tiles_bwd_torch(*args, g, need)
        torch.cuda.synchronize()
        for a, b, c in zip(got, want, again):
            if b is None:
                continue
            assert torch.equal(a, c)
            torch.testing.assert_close(a, b, atol=1e-5 * max(1.0, b.abs().max().item()), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("C,cap,need_dfeat", [(8, 6000, False), (8, 1536, True)])
def test_composite_kernels_at_their_shared_memory_limits(cuda, C, cap, need_dfeat):
    """Eight channels at caps that make K2 stage its candidates in two
    segments (6000) and make K3 fill shared memory exactly (1536 with the
    feature gradient: segments of 128); both against the plain versions.
    A cap beyond K3's shared memory raises."""
    from recmv_tpu_torch.ops.composite import (_composite_tiles_bwd_torch,
                                               _composite_tiles_torch, composite_tiles,
                                               composite_tiles_bwd)

    rng = np.random.RandomState(C + cap)
    cx, cy, val, feat, cnt, _ = _composite_case(rng, cuda, 1, 4, cap, C, 32, 2)
    g = torch.as_tensor(rng.randn(1, 4, C, 1024), dtype=torch.float32, device=cuda)
    args = (cx, cy, val, feat, 1.0 / 9.0, cnt, 2, 32)
    torch.testing.assert_close(composite_tiles(*args), _composite_tiles_torch(*args),
                               atol=1e-5, rtol=0)
    got, again = composite_tiles_bwd(*args, g, need_dfeat), composite_tiles_bwd(*args, g, need_dfeat)
    want = _composite_tiles_bwd_torch(*args, g, need_dfeat)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        if b is not None:
            assert torch.equal(a, c)
            torch.testing.assert_close(a, b, atol=1e-5 * max(1.0, b.abs().max().item()), rtol=0)
    if need_dfeat:
        big = [torch.zeros(1, 4, 4000, device=cuda) for _ in range(3)]
        with pytest.raises(RuntimeError):
            composite_tiles_bwd(*big, torch.zeros(1, 4, C, 4000, device=cuda), 1.0,
                                torch.zeros(1, 4, dtype=torch.int32, device=cuda), 2, 32,
                                g, True)


def _pixel_warp(tile):
    """The warp of the kernels that owns each pixel p = y·tile + x."""
    from recmv_tpu_torch.ops.composite import SUB_H, SUB_W

    p = torch.arange(tile * tile)
    return (p // tile // SUB_H) * (tile // SUB_W) + (p % tile) // SUB_W


def _pair_keep(cx, cy, inv_r2, cnt, Wt, tile):
    """(B, T, tile², cap) bool: the pixel's warp lists the candidate and
    the candidate is below the tile's count."""
    from recmv_tpu_torch.ops.composite import subtile_keep

    keep = subtile_keep(cx, cy, inv_r2, Wt, tile)[:, :, _pixel_warp(tile)]
    return keep & (torch.arange(cx.shape[2]) < cnt[..., None])[:, :, None, :]


def _raw(cx, cy, inv_r2, Wt, tile):
    """a = d²·inv_r2 and raw = 1 − a per (frame, tile, pixel, candidate),
    in the kernels' float32 operations → (a, raw)."""
    from recmv_tpu_torch.ops.mesh_raster import tile_pixels

    px, py = tile_pixels(cx.shape[1], Wt, tile)
    dx = px[None, :, :, None] - cx[:, :, None, :]
    dy = py[None, :, :, None] - cy[:, :, None, :]
    a = (dx * dx + dy * dy) * torch.tensor(inv_r2, dtype=torch.float32)
    return a, 1.0 - a


def _adversarial(tile, Wt, inv_r2):
    """Centres a few float32 ulps either side of the cull's limit and of
    raw = 0, off each side and corner of every sub-tile box of tile 0 →
    (cx, cy) (1, Wt, n), the same list in every tile."""
    from recmv_tpu_torch.ops.composite import CULL_LIMIT, SUB_H, SUB_W

    inv = np.float32(inv_r2)
    cs = []
    for v in (1.0, CULL_LIMIT):
        e = np.float32(np.sqrt(np.float64(v) / np.float64(inv)))
        for k in range(-6, 7):
            ek = e
            for _ in range(abs(k)):
                ek = np.nextafter(ek, np.float32(np.inf if k > 0 else 0.0))
            cs.append(ek)
    es = np.asarray(cs, np.float32)
    pts = []
    for w in range(tile * tile // 32):
        x0 = np.float32((w % (tile // SUB_W)) * SUB_W)
        y0 = np.float32((w // (tile // SUB_W)) * SUB_H)
        x1, y1 = x0 + np.float32(SUB_W - 1), y0 + np.float32(SUB_H - 1)
        xm, ym = x0 + np.float32(3.5), y0 + np.float32(1.5)
        diag = es / np.float32(np.sqrt(2.0))
        for ex, ey in ((x1 + es, np.full_like(es, ym)), (x0 - es, np.full_like(es, ym)),
                       (np.full_like(es, xm), y1 + es), (np.full_like(es, xm), y0 - es),
                       (x1 + diag, y1 + diag), (x0 - diag, y0 - diag)):
            pts.append(np.stack([ex, ey], -1))
    p = np.concatenate(pts).astype(np.float32)
    cx = np.broadcast_to(p[:, 0], (Wt, len(p)))[None]
    cy = np.broadcast_to(p[:, 1], (Wt, len(p)))[None]
    return torch.as_tensor(np.ascontiguousarray(cx)), torch.as_tensor(np.ascontiguousarray(cy))


@pytest.mark.parametrize("tile", [8, 16, 32])
@pytest.mark.parametrize("r_pix", [1.62, 3.24, 6.3, 30.0])
def test_cull_drops_only_zero_weights(tile, r_pix):
    """Every (pixel, candidate) pair the kernels' cull drops has raw ≤ 0,
    hence w == 0 in float32: on random centres, on a real splat's binned
    lists and on adversarial centres a few ulps either side of the cull's
    limit and of raw = 0."""
    from recmv_tpu_torch.ops.composite import CULL_LIMIT, subtile_keep

    rng = np.random.RandomState(tile + int(r_pix * 10))
    Wt = 2
    inv_r2 = float(np.float32(1.0 / (r_pix * r_pix)))
    lo, hi = -r_pix - 4.0, Wt * tile + r_pix + 4.0
    rand = [torch.as_tensor(lo + rng.rand(2, 2 * Wt, 400) * (hi - lo), dtype=torch.float32)
            for _ in range(2)]
    splat = _real_splats("cpu", tile, 1, 96, r_pix, 3000, tile, 1, 512)
    adv = _adversarial(tile, Wt, inv_r2)
    cases = {"random": (*rand, inv_r2, torch.full((2, 2 * Wt), 400, dtype=torch.int32), Wt),
             "splat": (splat[0], splat[1], splat[4], splat[5], splat[6]),
             "adversarial": (*adv, inv_r2, torch.full((1, Wt), adv[0].shape[2],
                                                       dtype=torch.int32), Wt)}
    for name, (cx, cy, inv, cnt, wt) in cases.items():
        live = (torch.arange(cx.shape[2]) < cnt[..., None])[:, :, None, :]
        keep = _pair_keep(cx, cy, inv, cnt, wt, tile)
        a, raw = _raw(cx, cy, inv, wt, tile)
        dropped = live & ~keep
        assert int(dropped.sum()) > 0, name
        assert bool((raw[dropped] <= 0.0).all()), name
        assert bool((torch.clamp(raw, 0.0, 1.0)[dropped] == 0.0).all()), name
    # the adversarial centres probe both edges: the margin keeps some pairs
    # with w = 0, and some dropped warps' nearest pixel sits within ulps of
    # the limit
    assert int((keep & (raw <= 0.0)).sum()) > 0
    first = torch.argsort(_pixel_warp(tile), stable=True).reshape(-1, 32)   # (warp, lane)
    a_min = a[:, :, first].amin(3)                                          # (B, T, warp, cap)
    dropped_warps = ~subtile_keep(cx, cy, inv_r2, Wt, tile)
    assert int((dropped_warps & (a_min < CULL_LIMIT * (1 + 4e-7))).sum()) > 0
    if r_pix == 1.62 and tile == 32:
        # the cull is tight: a real splat at the mask's radius is listed by
        # few of a tile's 32 warps
        kept = subtile_keep(splat[0], splat[1], splat[4], splat[6], tile)
        live = torch.arange(splat[0].shape[2]) < splat[5][..., None]
        assert (kept & live[:, :, None]).sum().item() < 0.2 * 32 * live.sum().item()


def _walk(cx, cy, val, feat, inv_r2, cnt, Wt, tile, g, keep=None):
    """The kernels' chain, pixel by pixel and candidate by candidate in z
    order, in their float32 operations and order: the forward (K2) and the
    backward (K3) with the same S and T chains. With ``keep`` (B, T, tile²,
    cap) the walk skips every pair it drops, as the kernels' lists do.
    Returns (out, dcx, dcy, dfeat)."""
    from recmv_tpu_torch.ops.composite import EPS
    from recmv_tpu_torch.ops.mesh_raster import tile_pixels

    B, T, cap = cx.shape
    C = feat.shape[2]
    _, raw = _raw(cx, cy, inv_r2, Wt, tile)
    px, py = tile_pixels(T, Wt, tile)
    inv = torch.tensor(inv_r2, dtype=torch.float32)
    step = (torch.arange(cap) < cnt[..., None])[:, :, None, :].expand(B, T, tile * tile, cap)
    if keep is not None:
        step = step & keep
    w = torch.clamp(raw, 0.0, 1.0) * val[:, :, None, :]
    acc = torch.zeros(B, T, C, tile * tile)
    trans = torch.ones(B, T, tile * tile)
    Ts = []
    for k in range(cap):
        Ts.append(trans)
        wk, sk = w[..., k], step[..., k]
        wT = wk * trans
        acc = torch.where(sk[:, :, None], acc + wT[:, :, None] * feat[:, :, :, k, None], acc)
        trans = torch.where(sk, trans * ((1.0 - wk) + EPS), trans)
    S = torch.zeros(B, T, C, tile * tile)
    dcx, dcy, dfeat = torch.zeros(B, T, cap), torch.zeros(B, T, cap), torch.zeros(B, T, C, cap)
    for k in reversed(range(cap)):
        wk, sk, Tk = w[..., k], step[..., k], Ts[k]
        wT = wk * Tk
        dLdw = torch.zeros(B, T, tile * tile)
        for c in range(C):
            dLdw = dLdw + g[:, :, c] * (Tk * feat[:, :, c, k, None] - S[:, :, c] / ((1.0 - wk) + EPS))
        rk = raw[..., k]
        active = ((rk > 0.0) & (rk < 1.0)).to(torch.float32) * val[:, :, k, None]
        dd2 = dLdw * (-inv) * active
        dx = px[None] - cx[:, :, k, None]
        dy = py[None] - cy[:, :, k, None]
        dcx[..., k] = torch.where(sk, dd2 * (-2.0) * dx, 0.0).sum(-1)
        dcy[..., k] = torch.where(sk, dd2 * (-2.0) * dy, 0.0).sum(-1)
        dfeat[..., k] = torch.where(sk[:, :, None], g * wT[:, :, None], 0.0).sum(-1)
        S = torch.where(sk[:, :, None], S + wT[:, :, None] * feat[:, :, :, k, None], S)
    return acc, dcx, dcy, dfeat


@pytest.mark.parametrize("tile", [8, 16, 32])
@pytest.mark.parametrize("r_pix", [1.62, 6.3])
def test_culled_walk_matches_dense(tile, r_pix):
    """The chain walked over the culled lists gives the dense walk's bits
    (forward and backward: a dropped pair only adds exact zeros), and both
    agree with the plain versions of K2 and K3 within the kernels'
    tolerances (1e-5 absolute; 1e-5 of the largest plain entry)."""
    from recmv_tpu_torch.ops.composite import _composite_tiles_bwd_torch, _composite_tiles_torch

    cx, cy, val, feat, inv_r2, cnt, Wt = _real_splats("cpu", tile, 2, 64, r_pix, 1500, tile,
                                                      2, 96)
    rng = np.random.RandomState(tile)
    g = torch.as_tensor(rng.randn(*cx.shape[:2], 2, tile * tile), dtype=torch.float32)
    args = (cx, cy, val, feat, inv_r2, cnt, Wt, tile)
    keep = _pair_keep(cx, cy, inv_r2, cnt, Wt, tile)
    dense, culled = _walk(*args, g), _walk(*args, g, keep)
    assert keep.float().mean().item() < 0.6
    for a, b in zip(dense, culled):
        assert torch.equal(a, b)
    out = _composite_tiles_torch(*args)
    assert out.max().item() > 0.5
    torch.testing.assert_close(culled[0], out, atol=1e-5, rtol=0)
    for a, b in zip(culled[1:], _composite_tiles_bwd_torch(*args, g, True)):
        assert b.abs().max().item() > 0.0
        torch.testing.assert_close(a, b, atol=1e-5 * max(1.0, b.abs().max().item()), rtol=0)


def _sphere_tris(n_lat, n_lon, centre, radius, z0=2.0):
    """A closed UV sphere in screen space (x, y in pixels, z the depth) →
    (verts (V, 3) f32, faces (F, 3) i32): neighbours share edges, and the
    front and back faces have opposite windings on the screen."""
    th = np.linspace(0.0, np.pi, n_lat + 1)[1:-1]
    ph = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    ring = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)], -1).reshape(-1, 3)
    unit = np.concatenate([[[0.0, 0.0, 1.0]], ring, [[0.0, 0.0, -1.0]]])
    V = len(unit)
    faces = []
    for j in range(n_lon):
        k = (j + 1) % n_lon
        faces.append([0, 1 + j, 1 + k])
        faces.append([V - 1, 1 + (n_lat - 2) * n_lon + k, 1 + (n_lat - 2) * n_lon + j])
        for i in range(n_lat - 2):
            a, b = 1 + i * n_lon + j, 1 + i * n_lon + k
            c, d = a + n_lon, b + n_lon
            faces += [[a, c, b], [b, c, d]]
    verts = np.stack([centre[0] + radius * unit[:, 0], centre[1] + radius * unit[:, 1],
                      z0 + 0.3 * unit[:, 2]], 1)
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def _ulps(v, k):
    """float32 ``v`` moved by k ulps."""
    v = np.float32(v)
    for _ in range(abs(k)):
        v = np.nextafter(v, np.float32(np.inf if k > 0 else -np.inf))
    return v


def _edge_probe_tris(tile, rng):
    """Small faces with one edge through a sub-tile corner or a pixel
    centre, moved a few float32 ulps either side of it, at several
    angles, with the third vertex on either side (both windings) →
    (verts (V, 3) f32, faces (F, 3) i32)."""
    from recmv_tpu_torch.ops.mesh_raster import SUB_H, SUB_W

    points = []
    for w in range(min(tile * tile // 32, 6)):
        x0 = (w % (tile // SUB_W)) * SUB_W
        y0 = (w // (tile // SUB_W)) * SUB_H
        points += [(x0, y0), (x0 + SUB_W - 1, y0 + SUB_H - 1), (x0 + SUB_W - 1, y0),
                   (x0 + 3, y0 + 2)]
    verts, faces = [], []
    for X, Y in points:
        for ang in (0.0, np.pi / 2, np.pi / 4, rng.rand() * np.pi):
            d = np.array([np.cos(ang), np.sin(ang)])
            nrm = np.array([-d[1], d[0]])
            for k in (-2, 0, 2):
                a = np.array([X, Y]) + 2.5 * d
                b = np.array([X, Y]) - 3.5 * d
                a = np.array([np.float32(a[0]), _ulps(a[1], k)], np.float32)
                for side in (1.0, -1.0):
                    c = np.array([X, Y]) + side * 2.0 * nrm + 0.5 * d
                    for tri in ((a, b, c), (b, a, c)):
                        faces.append([len(verts), len(verts) + 1, len(verts) + 2])
                        verts += [[*v, 1.0 + rng.rand()] for v in tri]
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def _mesh_case(tile, seed, cap=None):
    """mesh_tiles' arguments on the CPU for a 2×2-tile image: a UV sphere,
    random faces of every size, and the edge probes near tile 0."""
    from recmv_tpu_torch.ops.rasterizer import mesh_tile_inputs

    rng = np.random.RandomState(seed)
    size = 2 * tile
    parts = [_sphere_tris(10, 16, (0.55 * size, 0.45 * size), 0.4 * size),
             _random_tris(seed, V=60, F=80, size=size),
             _edge_probe_tris(tile, rng)]
    tiny = rng.rand(40, 3).astype(np.float32) * [size, size, 1.0] + [0.0, 0.0, 1.0]
    tiny = (tiny[:, None] + rng.randn(40, 3, 3).astype(np.float32) * [1.5, 1.5, 0.0])
    parts.append((tiny.reshape(-1, 3).astype(np.float32),
                  np.arange(120, dtype=np.int32).reshape(40, 3)))
    verts, faces, off = [], [], 0
    for v, f in parts:
        verts.append(v)
        faces.append(f + off)
        off += len(v)
    verts, faces = np.concatenate(verts), np.concatenate(faces)
    cap = cap or len(faces)
    return mesh_tile_inputs(torch.as_tensor(verts)[None], torch.as_tensor(faces), (size, size),
                            tile=tile, cap=cap) + (tile,)


def _edge_values(prm, Wt, tile):
    """The three edge values of every (frame, tile, candidate, pixel) in the
    kernel's float32 operations and order → (3, B, T, cap, tile²)."""
    from recmv_tpu_torch.ops.mesh_raster import tile_pixels

    px, py = tile_pixels(prm.shape[1], Wt, tile)
    P = prm[..., None]
    return torch.stack([P[:, :, 3 * e] * py[None, :, None, :] + P[:, :, 3 * e + 1]
                        * px[None, :, None, :] + P[:, :, 3 * e + 2] for e in range(3)])


@pytest.mark.parametrize("tile", [8, 16, 32])
def test_mesh_cull_drops_only_outside_pairs(tile):
    """K1's exact cull (``subtile_keep_faces``) on a sphere, random faces
    and faces whose edges pass a few ulps either side of sub-tile corners
    and pixel centres, both windings: over each warp's 8×4 box, every edge
    value is largest at the corner the edge's signs pick (the argument in
    ``csrc/mesh_raster.cu``); a warp keeps a candidate exactly when every
    edge is > 0 there; so no (pixel, face) pair that the plain version
    finds inside is dropped."""
    from recmv_tpu_torch.ops.mesh_raster import subtile_keep_faces

    prm, fid, cnt, Wt, _ = _mesh_case(tile, seed=tile)
    B, T, _, cap = prm.shape
    nsub = tile * tile // 32
    w = _edge_values(prm, Wt, tile)                                  # (3, B, T, cap, npix)
    live = (torch.arange(cap) < cnt[..., None])[..., None]
    inside = (w > 0.0).all(0) & live
    keep = subtile_keep_faces(prm, Wt, tile)                         # (B, T, nsub, cap)
    warp = _pixel_warp(tile)
    assert not bool((inside & ~keep[:, :, warp].transpose(2, 3)).any())
    # the box maximum sits at the picked corner, bit for bit
    order = torch.argsort(warp, stable=True).reshape(nsub, 32)       # (warp, lane) → pixel
    wb = w[..., order]                                               # (3, B, T, cap, nsub, 32)
    a, b = prm[:, :, 0::3][:, :, :3], prm[:, :, 1::3][:, :, :3]      # (B, T, 3, cap)
    lane = (torch.where(b >= 0.0, 7, 0) + 8 * torch.where(a >= 0.0, 3, 0)).movedim(2, 0)
    corner = torch.gather(wb, 5, lane[..., None, None].expand(*wb.shape[:5], 1))[..., 0]
    assert torch.equal(wb.amax(5), corner)
    assert torch.equal(keep, (~(corner <= 0.0)).all(0).transpose(2, 3))
    # not vacuous: the cull drops live pairs, and the probes put corner
    # values within ulps of 0 on both sides of the test
    dropped = live[..., 0][:, :, None, :] & ~keep
    assert int(dropped.sum()) > 0
    near = (corner.abs() < 1e-5).movedim(3, 4)                       # (3, B, T, nsub, cap)
    live_w = live[..., 0][:, :, None, :]
    assert int((near & (corner.movedim(3, 4) <= 0.0) & live_w).sum()) > 0
    assert int((near & (corner.movedim(3, 4) > 0.0) & live_w).sum()) > 0


def _mesh_walk(prm, fid, cnt, Wt, tile, keep=None):
    """K1's walk candidate by candidate in z order, in the kernel's float32
    operations: per pixel the strict '<' on z where the pixel is inside.
    With ``keep`` (B, T, cap, tile²) it skips the pairs the cull drops.
    Returns (zbuf, face, bary) as ``mesh_tiles``."""
    B, T, _, cap = prm.shape
    w = _edge_values(prm, Wt, tile)
    npix = tile * tile
    zb = torch.full((B, T, npix), 3.0e38)
    fb = torch.full((B, T, npix), -1, dtype=torch.int32)
    bary = torch.full((B, T, 3, npix), -1.0)
    for k in range(cap):
        wk = w[:, :, :, k]                                           # (3, B, T, npix)
        inside = (wk > 0.0).all(0) & (k < cnt)[..., None]
        if keep is not None:
            inside &= keep[:, :, k]
        iz = wk * prm[:, :, 9:12, k].movedim(2, 0)[..., None]
        zp = 1.0 / torch.clamp(iz[0] + iz[1] + iz[2], min=1e-12)
        better = inside & (zp < zb)
        zb = torch.where(better, zp, zb)
        fb = torch.where(better, fid[:, :, k, None], fb)
        bary = torch.where(better[:, :, None], (iz * zp).movedim(0, 2), bary)
    return torch.where(zb < 3.0e38, zb, -1.0), fb, bary


@pytest.mark.parametrize("tile", [8, 16, 32])
def test_culled_mesh_walk_matches_dense(tile):
    """A walk over the per-warp culled lists gives the same bits (zbuf,
    face, barycentrics) as the plain version's dense argmin, with a cap
    that some tiles fill; the cull keeps few of the live pairs."""
    from recmv_tpu_torch.ops.mesh_raster import _mesh_tiles_torch, subtile_keep_faces

    prm, fid, cnt, Wt, _ = _mesh_case(tile, seed=tile + 1, cap=96)
    assert int(cnt.max()) == 96
    keep = subtile_keep_faces(prm, Wt, tile)[:, :, _pixel_warp(tile)].transpose(2, 3)
    live = (torch.arange(96) < cnt[..., None])[..., None]
    assert (keep & live).sum().item() < 0.6 * live.expand_as(keep).sum().item()
    want = _mesh_tiles_torch(prm, fid, cnt, Wt, tile)
    assert (want[1] >= 0).float().mean().item() > 0.2
    for got in (_mesh_walk(prm, fid, cnt, Wt, tile, keep), _mesh_walk(prm, fid, cnt, Wt, tile)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_port_imports_no_jax():
    """Every module of the port, and ``chip_smoke.py``, imports with JAX,
    the JAX package, joblib and OpenCV made unimportable (the card's
    machine has none of them)."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'recmv_tpu', 'joblib', 'cv2'):\n"
        "    sys.modules[m] = None\n"
        "import recmv_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(recmv_tpu_torch.__path__, "
        "'recmv_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'recmv_tpu',"
        " 'joblib', 'cv2') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 68


def test_build_compiles_only_the_ports_sources(monkeypatch):
    """Every source ``_build`` hands a compiler lies under
    ``recmv_tpu_torch/`` and exists there."""
    from recmv_tpu_torch import _build

    seen = []

    def record(tag, compiler, flags, sources):
        seen.extend(sources)
        raise LookupError(tag)

    monkeypatch.setattr(_build, "_compile", record)
    monkeypatch.setattr(_build, "_LIBS", {})
    for build in (_build.kernels, _build.meshops):
        with pytest.raises(LookupError):
            build()
    pkg = osp.join(ROOT, "recmv_tpu_torch") + os.sep
    assert len(seen) == len(_build.KERNEL_SOURCES) + 1
    for src in seen:
        assert osp.abspath(src).startswith(pkg) and osp.isfile(src), src


@pytest.mark.parametrize("entry", ["generate_scene", "build_opt_net", "GarmentOptimNetwork",
                                   "skinner_from_jax", "scene_from_jax", "laplacian_deform",
                                   "nricp_fit", "visible_vertex_mask", "train_large_pose"])
def test_entry_points_need_a_card_or_a_device(monkeypatch, tmp_path, entry):
    """The port's entry points run on the card when no device is given,
    and raise (never fall back to the CPU) when there is no card. The
    check runs first, so placeholder arguments reach nothing else."""
    from recmv_tpu_torch import bridge
    from recmv_tpu_torch.core.builder import build_opt_net
    from recmv_tpu_torch.core.network import GarmentOptimNetwork
    from recmv_tpu_torch.data.synthetic import generate_scene
    from recmv_tpu_torch.core.inference import visible_vertex_mask
    from recmv_tpu_torch.geometry.laplacian import laplacian_deform
    from recmv_tpu_torch.geometry.nricp import nricp_fit
    from recmv_tpu_torch.train_large_pose import main as train_large_pose

    call = {"generate_scene": lambda: generate_scene(str(tmp_path / "scene")),
            "build_opt_net": lambda: build_opt_net(None, None, str(tmp_path)),
            "GarmentOptimNetwork": lambda: GarmentOptimNetwork(None, None, {}, None, None),
            "skinner_from_jax": lambda: bridge.skinner_from_jax({}),
            "scene_from_jax": lambda: bridge.scene_from_jax({}),
            "laplacian_deform": lambda: laplacian_deform(np.zeros((3, 3)), [[0, 1, 2]], [0],
                                                         np.zeros((1, 3))),
            "nricp_fit": lambda: nricp_fit(np.zeros((3, 3)), [[0, 1, 2]], np.zeros((3, 3))),
            "visible_vertex_mask": lambda: visible_vertex_mask(np.zeros((3, 3)),
                                                               [[0, 1, 2]]),
            "train_large_pose": lambda: train_large_pose(
                ["--conf", "missing.conf", "--data-root", str(tmp_path / "scene")])}[entry]
    if not torch.cuda.is_available():          # no card here: the default must raise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert not (tmp_path / "scene").exists()


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    """Without a CUDA device, or copied alone into an empty directory,
    ``chip_smoke.py`` exits non-zero and prints no result."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(osp.join(ROOT, "chip_smoke.py"), lone)
    env = dict(os.environ, PYTHONPATH="")
    runs = [(str(lone), str(tmp_path))]
    if not torch.cuda.is_available():
        runs.append((osp.join(ROOT, "chip_smoke.py"), ROOT))
    for script, cwd in runs:
        out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
