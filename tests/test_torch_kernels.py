"""The port's CUDA kernels against their plain PyTorch versions, and the
port's independence from JAX. This file imports no JAX, so it also runs
where JAX is absent (the repo's ``conftest.py`` imports JAX; skip it
there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests marked ``gpu`` need a CUDA device and skip without one. Kernel
tolerances: mesh face ids equal except ≤ 1e-4 of pixels (ties on shared
edges), zbuf within 1e-5 where they agree; composite within 1e-5
absolute (float32, the plain version's cumulative product and sum run in
another order); the composite's backward within 1e-5 of the largest
plain entry (sums over pixels and candidates in another order), and the
same bits on a second launch (no atomics).
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
@pytest.mark.parametrize("tile", [16, 32])
def test_mesh_tiles_kernel_matches_plain(cuda, tile):
    from recmv_tpu_torch.ops.mesh_raster import _mesh_tiles_torch, mesh_tiles
    from recmv_tpu_torch.ops.rasterizer import mesh_tile_inputs

    verts, faces = _random_tris(5, V=400, F=600, size=256)
    v = np.stack([verts, verts[:, [1, 0, 2]]])             # two frames
    args = mesh_tile_inputs(torch.as_tensor(v, device=cuda),
                            torch.as_tensor(faces, device=cuda), (256, 250), tile=tile,
                            cap=300) + (tile,)
    before = mesh_tiles.launches
    got = mesh_tiles(*args)
    want = _mesh_tiles_torch(*args)
    torch.cuda.synchronize()
    assert mesh_tiles.launches == before + 1
    same = got[1] == want[1]
    assert (~same).sum().item() <= max(1, int(1e-4 * same.numel()))
    assert (want[1] >= 0).float().mean().item() > 0.3
    torch.testing.assert_close(got[0][same], want[0][same], atol=1e-5, rtol=0)
    torch.testing.assert_close(got[2].movedim(2, -1)[same], want[2].movedim(2, -1)[same],
                               atol=1e-5, rtol=0)


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
    from recmv_tpu_torch.ops.composite import composite_tiles
    from recmv_tpu_torch.ops.mesh_raster import mesh_tiles

    prm = torch.zeros(1, 4, 12, 8, device=cuda)
    cnt = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        mesh_tiles(prm, torch.zeros(1, 4, 8, device=cuda), cnt, 2, 32)      # fid not int32
    with pytest.raises(ValueError):
        mesh_tiles(prm, torch.zeros(1, 4, 8, dtype=torch.int32), cnt, 2, 32)   # on the CPU
    c = torch.zeros(1, 4, 8, device=cuda)
    with pytest.raises(ValueError):
        composite_tiles(c, c, c, torch.zeros(1, 4, 9, 8, device=cuda), 1.0, cnt, 2, 32)


def test_port_imports_no_jax():
    """Every module of the port imports with JAX made unimportable."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['recmv_tpu'] = None\n"
        "import recmv_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(recmv_tpu_torch.__path__, "
        "'recmv_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'recmv_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30


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
