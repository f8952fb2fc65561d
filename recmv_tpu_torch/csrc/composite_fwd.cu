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
// What bounds it on the H100: the sequential transmittance chain. T_k
// depends on every earlier candidate, so each pixel walks its tile's
// candidates in order (up to cap 1536 on the main path, 768 per tile at
// full resolution scaled by the render downscale) and the latency of the
// multiply chain, not bandwidth, sets the time.
// Design: one block per (tile, frame), one thread per pixel (tile^2
// threads), so the chains of a tile's 1024 pixels run in parallel; the
// candidates are staged through shared memory in chunks of CHUNK and the
// loop runs to the tile's own count, so empty tiles cost nothing. Frames
// are the grid's y dimension.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 256;
constexpr int MAX_C = 8;
constexpr float EPS = 1e-10f;

__global__ void composite_fwd_kernel(const float* __restrict__ cx,
                                     const float* __restrict__ cy,
                                     const float* __restrict__ val,
                                     const float* __restrict__ feat,
                                     const int* __restrict__ cnt,
                                     float* __restrict__ out,
                                     float inv_r2, int T, int cap, int C,
                                     int Wt, int tile) {
  extern __shared__ float smem[];
  float* s_cx = smem;
  float* s_cy = smem + CHUNK;
  float* s_val = smem + 2 * CHUNK;
  float* s_f = smem + 3 * CHUNK;  // (C, CHUNK)

  const int t = blockIdx.x;
  const long bt = (long)blockIdx.y * T + t;
  const int p = threadIdx.x;
  const int npix = tile * tile;
  const float px = (float)((t % Wt) * tile + p % tile);
  const float py = (float)((t / Wt) * tile + p / tile);
  const long base = bt * cap;
  const float* F = feat + bt * C * cap;
  const int n = cnt[bt];

  float acc[MAX_C];
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0.0f;
  float trans = 1.0f;

  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int m = min(CHUNK, n - c0);
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      s_cx[k] = cx[base + c0 + k];
      s_cy[k] = cy[base + c0 + k];
      s_val[k] = val[base + c0 + k];
    }
    for (int i = threadIdx.x; i < C * m; i += blockDim.x) {
      const int c = i / m, k = i % m;
      s_f[c * CHUNK + k] = F[(long)c * cap + c0 + k];
    }
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const float dx = px - s_cx[k];
      const float dy = py - s_cy[k];
      const float d2 = dx * dx + dy * dy;
      const float w = fminf(fmaxf(1.0f - d2 * inv_r2, 0.0f), 1.0f) * s_val[k];
      const float wT = w * trans;
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < C) acc[c] = acc[c] + wT * s_f[c * CHUNK + k];
      trans = trans * ((1.0f - w) + EPS);
    }
    __syncthreads();
  }

  float* O = out + bt * C * npix;
  for (int c = 0; c < C; ++c) O[(long)c * npix + p] = acc[c];
}

}  // namespace

// cx, cy, val (B, T, cap) f32, feat (B, T, C, cap) f32, cnt (B, T) i32 →
// out (B, T, C, tile^2) f32. C <= 8.
extern "C" int composite_fwd_launch(const float* cx, const float* cy, const float* val,
                                    const float* feat, const int* cnt, float* out,
                                    float inv_r2, int B, int T, int cap, int C,
                                    int Wt, int tile, void* stream) {
  if (C < 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
  dim3 grid(T, B);
  const size_t smem = sizeof(float) * (size_t)(3 + C) * CHUNK;
  composite_fwd_kernel<<<grid, tile * tile, smem, (cudaStream_t)stream>>>(
      cx, cy, val, feat, cnt, out, inv_r2, T, cap, C, Wt, tile);
  return (int)cudaGetLastError();
}
