// Per-tile front-to-back point alpha compositing (forward) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel recmv_tpu/ops/pallas_composite.py::_fwd_kernel
// (entry composite_tiles, forward). Each tile's binned candidate points
// arrive z-sorted near to far as (cx, cy, val, feat[C]) in pixel units.
// Per pixel: w_k = clip(1 - d^2 * inv_r2, 0, 1) * val_k and
// out_c = sum_k w_k * T_k * f_kc with T_0 = 1, T_{k+1} = T_k * (1 - w_k + 1e-10).
// The multiplies and adds run in the TPU kernel's order
// (wT = w * T; acc += wT * f; T *= (1 - w) + EPS), and the file is built
// with -fmad=false, so the sums round like the plain PyTorch version's
// products.
//
// What bounds it on the H100: the inputs are small (cx, cy, val, feat of
// the tile's candidates, ~25 MB for the main path's 3 frames of 289 tiles
// at cap 1536), so the bound is bytes, a few microseconds. A dense walk of
// every (pixel, candidate) pair is far above it: a splat of radius r
// touches ~pi r^2 pixels of the tile's 1024 (9 at the mask's r = 1.62 px),
// so ~99% of the pairs have w = 0 and are exact identities of the chain.
// Design: touch only the pairs that can be non-zero.
// - One block per (tile, frame), one thread per pixel (tile^2 threads).
//   A warp owns an 8 x 4 sub-tile of pixels (lane l at (l % 8, l / 8)), so
//   a small splat reaches 1-4 of a tile's 32 warps instead of all of them.
// - The tile's candidates are staged into shared memory once, with
//   asynchronous copies (cp.async), in one segment when they fit (up to
//   ~4,900 candidates at C = 8), else segment by segment.
// - Each warp culls the staged candidates in z order, 32 at a time: lane i
//   tests candidate i against the warp's sub-tile box, __ballot_sync and the
//   popcount of the lower lanes place each kept candidate in the warp's
//   list in shared memory (uint16), and the warp walks only its list.
// - The cull (may_touch) is conservative: with e = the distance from the
//   centre to the sub-tile box per axis (0 inside), it drops a candidate only
//   when (ex*ex + ey*ey) * inv_r2 >= CULL_LIMIT. Rounding to nearest is
//   monotone and the pixels' |px - cx| >= ex hold for the rounded values,
//   so every pixel of the box then computes d2 * inv_r2 >= 1, raw <= 0 and
//   w == 0 in this file's own float32 arithmetic (for finite coordinates).
//   Threshold 1 is already exact by that argument; CULL_LIMIT = 1 + 2^-10
//   adds a margin for any reordering of those roundings.
// - A dropped pair would have been an exact identity (w = 0: wT = 0,
//   acc + 0 = acc, T * (1 + 1e-10f) = T * 1.0f = T), so the output is the
//   same bits as the dense walk of every candidate.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int MAX_C = 8;
constexpr int SUB_W = 8, SUB_H = 4;    // a warp's sub-tile of pixels
constexpr int LIST = 256;              // entries of a warp's list in shared memory
constexpr int SMEM_MAX = 232448;       // bytes of shared memory a block may use
constexpr float EPS = 1e-10f;
constexpr float CULL_LIMIT = 1.0f + 1.0f / 1024.0f;

// false only when no pixel of the sub-tile [bx0, bx0 + 7] x [by0, by0 + 3]
// can see raw = 1 - d^2 * inv_r2 > 0 from the candidate at (cx, cy).
__device__ __forceinline__ bool may_touch(float cx, float cy, float bx0, float by0,
                                          float inv_r2) {
  const float ex = fmaxf(fmaxf(bx0 - cx, cx - (bx0 + (float)(SUB_W - 1))), 0.0f);
  const float ey = fmaxf(fmaxf(by0 - cy, cy - (by0 + (float)(SUB_H - 1))), 0.0f);
  return !((ex * ex + ey * ey) * inv_r2 >= CULL_LIMIT);
}

template <int C>
__global__ void __launch_bounds__(1024)
    composite_fwd_kernel(const float* __restrict__ cx, const float* __restrict__ cy,
                         const float* __restrict__ val, const float* __restrict__ feat,
                         const int* __restrict__ cnt, float* __restrict__ out, float inv_r2,
                         int T, int cap, int Wt, int tile, int seg) {
  extern __shared__ float smem[];
  float* s_cx = smem;
  float* s_cy = smem + seg;
  float* s_val = smem + 2 * seg;
  float* s_f = smem + 3 * seg;  // (C, seg)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint16_t* s_list = reinterpret_cast<uint16_t*>(smem + (3 + C) * seg) + warp * LIST;

  const int t = blockIdx.x;
  const long bt = (long)blockIdx.y * T + t;
  const int per_row = tile / SUB_W;
  const int sx = (warp % per_row) * SUB_W, sy = (warp / per_row) * SUB_H;
  const int x = sx + (lane & 7), y = sy + (lane >> 3);
  const float bx0 = (float)((t % Wt) * tile + sx);
  const float by0 = (float)((t / Wt) * tile + sy);
  const float px = (float)((t % Wt) * tile + x);
  const float py = (float)((t / Wt) * tile + y);
  const long base = bt * cap;
  const float* F = feat + bt * C * cap;
  const int n = min(cnt[bt], cap);

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float trans = 1.0f;

  for (int k0 = 0; k0 < n; k0 += seg) {
    const int m = min(seg, n - k0);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      __pipeline_memcpy_async(s_cx + i, cx + base + k0 + i, sizeof(float));
      __pipeline_memcpy_async(s_cy + i, cy + base + k0 + i, sizeof(float));
      __pipeline_memcpy_async(s_val + i, val + base + k0 + i, sizeof(float));
#pragma unroll
      for (int c = 0; c < C; ++c)
        __pipeline_memcpy_async(s_f + c * seg + i, F + (long)c * cap + k0 + i, sizeof(float));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    int L = 0;
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      const bool keep = j < m && may_touch(s_cx[j], s_cy[j], bx0, by0, inv_r2);
      const unsigned ball = __ballot_sync(0xffffffffu, keep);
      if (keep) s_list[L + __popc(ball & ((1u << lane) - 1u))] = (uint16_t)j;
      L += __popc(ball);
      if (L > LIST - 32 || j0 + 32 >= m) {
        __syncwarp();
        for (int i = 0; i < L; ++i) {
          const int k = s_list[i];
          const float dx = px - s_cx[k];
          const float dy = py - s_cy[k];
          const float d2 = dx * dx + dy * dy;
          const float w = fminf(fmaxf(1.0f - d2 * inv_r2, 0.0f), 1.0f) * s_val[k];
          const float wT = w * trans;
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = acc[c] + wT * s_f[c * seg + k];
          trans = trans * ((1.0f - w) + EPS);
        }
        __syncwarp();
        L = 0;
      }
    }
    __syncthreads();
  }

  const int npix = tile * tile;
  float* O = out + bt * C * npix + y * tile + x;
#pragma unroll
  for (int c = 0; c < C; ++c) O[(long)c * npix] = acc[c];
}

template <int C>
int launch(const float* cx, const float* cy, const float* val, const float* feat,
           const int* cnt, float* out, float inv_r2, int B, int T, int cap, int Wt, int tile,
           cudaStream_t stream) {
  const int nwarp = tile * tile / 32;
  const long list_bytes = (long)nwarp * LIST * sizeof(uint16_t);
  const long per_cand = (long)(3 + C) * sizeof(float);
  // the whole tile in one segment when it fits, else the most that fits
  const int seg = (int)std::min<long>(cap, (SMEM_MAX - list_bytes) / per_cand);
  const size_t smem = per_cand * seg + list_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        composite_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  composite_fwd_kernel<C><<<dim3(T, B), tile * tile, smem, stream>>>(
      cx, cy, val, feat, cnt, out, inv_r2, T, cap, Wt, tile, seg);
  return (int)cudaGetLastError();
}

}  // namespace

// cx, cy, val (B, T, cap) f32, feat (B, T, C, cap) f32, cnt (B, T) i32 →
// out (B, T, C, tile^2) f32. C in 1..8, tile in {8, 16, 32}, cap < 65536.
extern "C" int composite_fwd_launch(const float* cx, const float* cy, const float* val,
                                    const float* feat, const int* cnt, float* out,
                                    float inv_r2, int B, int T, int cap, int C, int Wt,
                                    int tile, void* stream) {
  if (C < 1 || C > MAX_C || (tile != 8 && tile != 16 && tile != 32) || cap < 0 || cap > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1: return launch<1>(cx, cy, val, feat, cnt, out, inv_r2, B, T, cap, Wt, tile, s);
    case 2: return launch<2>(cx, cy, val, feat, cnt, out, inv_r2, B, T, cap, Wt, tile, s);
    case 3: return launch<3>(cx, cy, val, feat, cnt, out, inv_r2, B, T, cap, Wt, tile, s);
    case 4: return launch<4>(cx, cy, val, feat, cnt, out, inv_r2, B, T, cap, Wt, tile, s);
    case 5: return launch<5>(cx, cy, val, feat, cnt, out, inv_r2, B, T, cap, Wt, tile, s);
    case 6: return launch<6>(cx, cy, val, feat, cnt, out, inv_r2, B, T, cap, Wt, tile, s);
    case 7: return launch<7>(cx, cy, val, feat, cnt, out, inv_r2, B, T, cap, Wt, tile, s);
    default: return launch<8>(cx, cy, val, feat, cnt, out, inv_r2, B, T, cap, Wt, tile, s);
  }
}
