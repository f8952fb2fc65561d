// Per-tile mesh z-buffer (K = 1 face per pixel) for Hopper (sm_90a).
//
// Replaces the TPU kernel recmv_tpu/ops/pallas_raster.py::_mesh_kernel
// (entry mesh_tiles). Each tile's binned candidate faces arrive z-sorted
// near to far with 12 premultiplied coefficients each: three edge
// functions a*py + b*px + c already divided by the signed area, and three
// inverse vertex depths. A pixel is inside a face if all three edge values
// are > 0; its depth is z = 1 / max(sum iz_i, 1e-12) with iz_i = w_i * q_i.
// The kernel keeps a running argmin over z with a strict '<', so the first
// face in z order wins a tie, exactly like the TPU loop, together with the
// winner's face id and perspective barycentrics iz_i * z. Empty pixels
// get -1 everywhere.
//
// What bounds it on the H100: compute. Every pixel evaluates three edge
// functions and a reciprocal for every candidate of its tile (cap 512 on
// the main path), while the bytes read are 52 per candidate per tile.
// Design: one block per (tile, frame), one thread per pixel (tile^2
// threads); the candidates are staged through shared memory in chunks of
// CHUNK so every thread reads each coefficient from shared memory instead
// of device memory; the loop runs to the tile's own candidate count, so
// empty tiles cost nothing. Frames are the grid's y dimension.
// Built with -fmad=false so the arithmetic rounds like the plain PyTorch
// version (separate multiplies and adds, in the same order).

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 256;
constexpr float BIG = 3.0e38f;

__global__ void mesh_tiles_kernel(const float* __restrict__ prm,
                                  const int* __restrict__ fid,
                                  const int* __restrict__ cnt,
                                  float* __restrict__ zbuf,
                                  int* __restrict__ face,
                                  float* __restrict__ bary,
                                  int T, int cap, int Wt, int tile) {
  __shared__ float s_prm[12][CHUNK];
  __shared__ int s_fid[CHUNK];

  const int t = blockIdx.x;
  const long bt = (long)blockIdx.y * T + t;
  const int p = threadIdx.x;
  const int npix = tile * tile;
  const float px = (float)((t % Wt) * tile + p % tile);
  const float py = (float)((t / Wt) * tile + p / tile);
  const float* P = prm + bt * 12 * cap;
  const int* FI = fid + bt * cap;
  const int n = cnt[bt];

  float zbest = BIG;
  int fbest = -1;
  float b0 = -1.0f, b1 = -1.0f, b2 = -1.0f;

  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int m = min(CHUNK, n - c0);
    for (int i = threadIdx.x; i < 12 * m; i += blockDim.x) {
      const int r = i / m, k = i % m;
      s_prm[r][k] = P[(long)r * cap + c0 + k];
    }
    for (int k = threadIdx.x; k < m; k += blockDim.x) s_fid[k] = FI[c0 + k];
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const float w0 = s_prm[0][k] * py + s_prm[1][k] * px + s_prm[2][k];
      const float w1 = s_prm[3][k] * py + s_prm[4][k] * px + s_prm[5][k];
      const float w2 = s_prm[6][k] * py + s_prm[7][k] * px + s_prm[8][k];
      const bool inside = (w0 > 0.0f) && (w1 > 0.0f) && (w2 > 0.0f);
      const float iz0 = w0 * s_prm[9][k];
      const float iz1 = w1 * s_prm[10][k];
      const float iz2 = w2 * s_prm[11][k];
      const float zp = 1.0f / fmaxf(iz0 + iz1 + iz2, 1e-12f);
      const float zsel = inside ? zp : BIG;
      if (zsel < zbest) {
        zbest = zsel;
        fbest = s_fid[k];
        b0 = iz0 * zp;
        b1 = iz1 * zp;
        b2 = iz2 * zp;
      }
    }
    __syncthreads();
  }

  const bool got = zbest < BIG;
  zbuf[bt * npix + p] = got ? zbest : -1.0f;
  face[bt * npix + p] = fbest;
  float* B3 = bary + bt * 3 * npix;
  B3[p] = b0;
  B3[npix + p] = b1;
  B3[2 * npix + p] = b2;
}

}  // namespace

// prm (B, T, 12, cap) f32, fid (B, T, cap) i32, cnt (B, T) i32 →
// zbuf (B, T, tile^2) f32, face (B, T, tile^2) i32, bary (B, T, 3, tile^2) f32.
extern "C" int mesh_tiles_launch(const float* prm, const int* fid, const int* cnt,
                                 float* zbuf, int* face, float* bary,
                                 int B, int T, int cap, int Wt, int tile,
                                 void* stream) {
  dim3 grid(T, B);
  mesh_tiles_kernel<<<grid, tile * tile, 0, (cudaStream_t)stream>>>(
      prm, fid, cnt, zbuf, face, bary, T, cap, Wt, tile);
  return (int)cudaGetLastError();
}
