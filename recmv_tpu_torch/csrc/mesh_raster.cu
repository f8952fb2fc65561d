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
// What bounds it on the H100: bytes. It reads 13 words per listed face and
// writes 5 words per pixel (22 MB on the main path, ~7 us at 3.35 TB/s);
// the covered (pixel, face) pairs are few (74k of the main path's 84M
// pairs of a dense walk), so the work is in finding them.
// Design: evaluate only the pairs that can be covered.
// - One block per (tile, frame), one warp per 8 x 4 pixel sub-tile
//   (tile^2 / 32 warps; lane l at (l % 8, l / 8)). Blocks of 8 warps that
//   walk 4 sub-tiles each were measured 1.6-2.1x slower (chip_ab.py, on the
//   H100): a tile's latency, set by its busiest sub-tiles, decides when
//   the launch ends.
// - The tile's 13 words per candidate are staged into shared memory with
//   asynchronous copies (cp.async), one coalesced row at a time, in one
//   segment when they fit (up to ~4,150 candidates) and else segment by
//   segment in z order.
// - Each warp culls the staged candidates in z order, 32 at a time: lane
//   i tests candidate i against the sub-tile's box, __ballot_sync and the
//   popcount of the lower lanes place each kept candidate in the warp's
//   list in shared memory (uint16), and the warp walks only that list
//   with the arithmetic above.
// - The cull is exact. An edge value w = fl(fl(fl(a*py) + fl(b*px)) + c)
//   (this file is built with -fmad=false, so it rounds in that order) is
//   monotone in py for fixed px and in px for fixed py, because rounding
//   to nearest is monotone: it does not decrease in py when a >= 0 and
//   does not increase when a < 0, and likewise in px with the sign of b.
//   So over the sub-tile's pixels [x0, x0 + 7] x [y0, y0 + 3] the largest
//   w lies at the corner (b >= 0 ? x0 + 7 : x0, a >= 0 ? y0 + 3 : y0),
//   which the cull evaluates with the walk's own expression. When that
//   corner value is <= 0 for any of the three edges, no pixel of the box
//   is inside, every pixel's z candidate is BIG, and BIG < zbest never
//   holds: dropping the pair changes no output bit. A NaN corner value
//   compares false and keeps the candidate. (For finite coefficients whose
//   products and sums stay finite, as the rasterizer's are.)
// - The walk tests the strict '<' only where the pixel is inside, which is
//   where the dense walk's z candidate is not BIG; the outputs are the same
//   bits as a dense walk of every (pixel, candidate) pair.
// No depth early-out: the bins are ordered by quantized mean z, not by
// nearest z, so skipping faces by depth would need its own argument.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int SUB_W = 8, SUB_H = 4;    // a warp's sub-tile of pixels
constexpr int MAX_WARPS = 32;          // warps of a block at tile 32
constexpr int LIST = 256;              // entries of a warp's list in shared memory
constexpr int WORDS = 13;              // 12 coefficients and the face id per candidate
constexpr int SMEM_MAX = 232448;       // bytes of shared memory a block may use
constexpr int MAX_CAP = 65535;         // list entries and counts fit uint16 and int
constexpr float BIG = 3.0e38f;

// The edge value at (px, py), in the walk's order of operations.
__device__ __forceinline__ float edge(const float* s, int seg, int e, int k, float px,
                                      float py) {
  return s[(3 * e) * seg + k] * py + s[(3 * e + 1) * seg + k] * px + s[(3 * e + 2) * seg + k];
}

// false only when, for some edge, the largest value over the sub-tile's
// pixels (at the corner its signs pick) is <= 0.
__device__ __forceinline__ bool may_cover(const float* s, int seg, int k, float x0, float y0) {
  bool keep = true;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float a = s[(3 * e) * seg + k], b = s[(3 * e + 1) * seg + k];
    const float cx = b >= 0.0f ? x0 + (float)(SUB_W - 1) : x0;
    const float cy = a >= 0.0f ? y0 + (float)(SUB_H - 1) : y0;
    keep = keep && !(edge(s, seg, e, k, cx, cy) <= 0.0f);
  }
  return keep;
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
    mesh_tiles_kernel(const float* __restrict__ prm, const int* __restrict__ fid,
                      const int* __restrict__ cnt, float* __restrict__ zbuf,
                      int* __restrict__ face, float* __restrict__ bary, int T, int cap, int Wt,
                      int tile, int seg) {
  extern __shared__ float smem[];
  float* s_prm = smem;                                          // (12, seg)
  int* s_fid = reinterpret_cast<int*>(smem + 12 * seg);         // (seg)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint16_t* s_list = reinterpret_cast<uint16_t*>(smem + WORDS * seg) + warp * LIST;

  const int t = blockIdx.x;
  const long bt = (long)blockIdx.y * T + t;
  const int per_row = tile / SUB_W;
  const int sx = (warp % per_row) * SUB_W, sy = (warp / per_row) * SUB_H;
  const float x0 = (float)((t % Wt) * tile + sx);
  const float y0 = (float)((t / Wt) * tile + sy);
  const float px = x0 + (float)(lane & 7), py = y0 + (float)(lane >> 3);
  const float* P = prm + bt * 12 * cap;
  const int* FI = fid + bt * cap;
  const int n = min(cnt[bt], cap);

  float zbest = BIG;
  int fbest = -1;
  float b0 = -1.0f, b1 = -1.0f, b2 = -1.0f;

  for (int k0 = 0; k0 < n; k0 += seg) {
    const int m = min(seg, n - k0);
#pragma unroll 1
    for (int r = 0; r < 12; ++r)
      for (int i = threadIdx.x; i < m; i += blockDim.x)
        __pipeline_memcpy_async(s_prm + r * seg + i, P + (long)r * cap + k0 + i, sizeof(float));
    for (int i = threadIdx.x; i < m; i += blockDim.x)
      __pipeline_memcpy_async(s_fid + i, FI + k0 + i, sizeof(int));
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    int L = 0;
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      const bool keep = j < m && may_cover(s_prm, seg, j, x0, y0);
      const unsigned ball = __ballot_sync(0xffffffffu, keep);
      if (keep) s_list[L + __popc(ball & ((1u << lane) - 1u))] = (uint16_t)j;
      L += __popc(ball);
      if (L > LIST - 32 || j0 + 32 >= m) {
        __syncwarp();
        for (int i = 0; i < L; ++i) {
          const int k = s_list[i];
          const float w0 = edge(s_prm, seg, 0, k, px, py);
          const float w1 = edge(s_prm, seg, 1, k, px, py);
          const float w2 = edge(s_prm, seg, 2, k, px, py);
          if ((w0 > 0.0f) && (w1 > 0.0f) && (w2 > 0.0f)) {
            const float iz0 = w0 * s_prm[9 * seg + k];
            const float iz1 = w1 * s_prm[10 * seg + k];
            const float iz2 = w2 * s_prm[11 * seg + k];
            const float zp = 1.0f / fmaxf(iz0 + iz1 + iz2, 1e-12f);
            if (zp < zbest) {
              zbest = zp;
              fbest = s_fid[k];
              b0 = iz0 * zp;
              b1 = iz1 * zp;
              b2 = iz2 * zp;
            }
          }
        }
        __syncwarp();
        L = 0;
      }
    }
    __syncthreads();
  }

  const int npix = tile * tile;
  const int p = (sy + (lane >> 3)) * tile + sx + (lane & 7);
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
// tile in {8, 16, 32}, 0 <= cap <= 65535; anything else is refused with
// cudaErrorInvalidValue before a launch.
extern "C" int mesh_tiles_launch(const float* prm, const int* fid, const int* cnt,
                                 float* zbuf, int* face, float* bary,
                                 int B, int T, int cap, int Wt, int tile,
                                 void* stream) {
  if ((tile != 8 && tile != 16 && tile != 32) || cap < 0 || cap > MAX_CAP || B < 1 || T < 1 ||
      Wt < 1)
    return (int)cudaErrorInvalidValue;
  const int nwarp = tile * tile / 32;
  const long list_bytes = (long)nwarp * LIST * sizeof(uint16_t);
  const long per_cand = (long)WORDS * sizeof(float);
  // the whole tile in one segment when it fits, else the most that fits
  const int seg = (int)std::min<long>(cap, (SMEM_MAX - list_bytes) / per_cand);
  const size_t smem = per_cand * seg + list_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mesh_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mesh_tiles_kernel<<<dim3(T, B), nwarp * 32, smem, (cudaStream_t)stream>>>(
      prm, fid, cnt, zbuf, face, bary, T, cap, Wt, tile, seg);
  return (int)cudaGetLastError();
}
