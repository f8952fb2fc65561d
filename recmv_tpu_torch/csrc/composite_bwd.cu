// Per-tile point alpha compositing, backward (the VJP of composite_fwd.cu)
// for Hopper (sm_90a).
//
// Replaces the TPU kernel recmv_tpu/ops/pallas_composite.py::_bwd_kernel
// (entry composite_tiles, custom-VJP backward). Per pixel p of a tile and
// candidate k (z-sorted near to far):
//   w_k = clip(1 - d^2 * inv_r2, 0, 1) * val_k,
//   T_k = prod_{j<k} (1 - w_j + 1e-10),
//   S_c = sum_{m>k} w_m T_m f_mc,
//   dL/dw_k = sum_c g_c(p) (T_k f_kc - S_c / (1 - w_k + 1e-10)),
// and, summed over the tile's pixels, with active = 0 < 1 - d^2 inv_r2 < 1
// (strict) times val_k:
//   dcx_k = sum_p dL/dw_k * (-inv_r2) * active * (-2)(px - cx_k), dcy_k alike,
//   dfeat_kc = sum_p g_c(p) w_k T_k            (only when asked for).
// Outputs beyond the tile's count are zero.
//
// What bounds it on the H100: the sequential chain over candidates, walked
// twice forward and once in reverse per pixel, and one reduction over the
// tile's pixels per candidate. The TPU kernel keeps w and T for every
// candidate in VMEM ((cap, 8, 128) each, 12.6 MB at cap 1536); that fits
// neither in shared memory nor sensibly in device memory here.
// Design:
// - A tile's pixels are split over G blocks of P = min(128, tile^2) threads,
//   one pixel chain per thread.
// - Forward sweep: each thread keeps T at the start of every chunk of CH
//   candidates as a checkpoint in shared memory (cap / CH per pixel).
// - Reverse sweep, chunk by chunk from the last: recompute the chunk's T
//   from its checkpoint into shared memory, then walk it backwards carrying
//   S. T is never rebuilt by division (T_{k+1} / (1 - w_k)), nor S as a
//   total minus a prefix: both lose all precision near splat centres.
// - Per candidate, the pixel sums are reduced without atomics, so results
//   do not change from run to run: across each warp with __shfl_down_sync
//   (skipped when no lane of the warp has w > 0), then across the block's
//   warps in shared memory in a fixed order, into per-block partial sums;
//   a second kernel adds a tile's G partials in a fixed order.
// The multiplies and adds follow the TPU kernel's order and the file is
// built with -fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int CH = 32;      // candidates per chunk
constexpr int MAX_C = 8;
constexpr int MAX_P = 128;  // pixels (threads) per block
constexpr float EPS = 1e-10f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// grid (T * G, B), block P threads. partial: (B, T, G, NV, cap) with
// NV = 2 (dcx, dcy) or 2 + C (and dfeat).
__global__ void composite_bwd_partial(const float* __restrict__ cx,
                                      const float* __restrict__ cy,
                                      const float* __restrict__ val,
                                      const float* __restrict__ feat,
                                      const int* __restrict__ cnt,
                                      const float* __restrict__ g,
                                      float* __restrict__ partial, float inv_r2,
                                      int T, int cap, int C, int NV, int Wt, int tile,
                                      int G, int n_ck) {
  extern __shared__ float smem[];
  const int P = blockDim.x;
  const int tid = threadIdx.x;
  float* s_ck = smem;                  // (n_ck, P) chunk checkpoints of T
  float* s_T = s_ck + n_ck * P;        // (CH, P) T of the current chunk
  float* s_cx = s_T + CH * P;          // (CH,)
  float* s_cy = s_cx + CH;
  float* s_val = s_cy + CH;
  float* s_f = s_val + CH;             // (C, CH)
  float* s_red = s_f + MAX_C * CH;     // (P / 32, CH, NV) per-warp sums

  const int t = blockIdx.x / G;
  const int pg = blockIdx.x % G;
  const long bt = (long)blockIdx.y * T + t;
  const int npix = tile * tile;
  const int p = pg * P + tid;
  const float px = (float)((t % Wt) * tile + p % tile);
  const float py = (float)((t / Wt) * tile + p / tile);
  const long base = bt * cap;
  const float* F = feat + bt * C * cap;
  const int n = cnt[bt];
  const int nch = (n + CH - 1) / CH;
  const int lane = tid & 31, warp = tid >> 5, nwarp = P >> 5;
  float* out = partial + (bt * G + pg) * (long)NV * cap;

  float gc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) gc[c] = c < C ? g[(bt * C + c) * npix + p] : 0.0f;

  auto stage = [&](int j, int m) {
    const int k0 = j * CH;
    for (int i = tid; i < m; i += P) {
      s_cx[i] = cx[base + k0 + i];
      s_cy[i] = cy[base + k0 + i];
      s_val[i] = val[base + k0 + i];
    }
    for (int i = tid; i < C * m; i += P) {
      const int c = i / m, k = i % m;
      s_f[c * CH + k] = F[(long)c * cap + k0 + k];
    }
  };
  auto weight = [&](int k, float& dx, float& dy, float& raw) {
    dx = px - s_cx[k];
    dy = py - s_cy[k];
    const float d2 = dx * dx + dy * dy;
    raw = 1.0f - d2 * inv_r2;
    return fminf(fmaxf(raw, 0.0f), 1.0f) * s_val[k];
  };

  // forward sweep: T at the start of each chunk
  float trans = 1.0f;
  for (int j = 0; j < nch; ++j) {
    const int m = min(CH, n - j * CH);
    stage(j, m);
    __syncthreads();
    s_ck[j * P + tid] = trans;
    for (int k = 0; k < m; ++k) {
      float dx, dy, raw;
      const float w = weight(k, dx, dy, raw);
      trans = trans * ((1.0f - w) + EPS);
    }
    __syncthreads();
  }

  // reverse sweep, chunk by chunk, carrying S
  float S[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) S[c] = 0.0f;
  for (int j = nch - 1; j >= 0; --j) {
    const int m = min(CH, n - j * CH);
    stage(j, m);
    __syncthreads();
    float tr = s_ck[j * P + tid];
    for (int k = 0; k < m; ++k) {
      float dx, dy, raw;
      const float w = weight(k, dx, dy, raw);
      s_T[k * P + tid] = tr;
      tr = tr * ((1.0f - w) + EPS);
    }
    for (int k = m - 1; k >= 0; --k) {
      float dx, dy, raw;
      const float w = weight(k, dx, dy, raw);
      const float Tk = s_T[k * P + tid];
      const float wT = w * Tk;
      float dLdw = 0.0f;
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < C) dLdw = dLdw + gc[c] * (Tk * s_f[c * CH + k] - S[c] / ((1.0f - w) + EPS));
      const float active = (raw > 0.0f && raw < 1.0f) ? s_val[k] : 0.0f;
      const float dd2 = dLdw * (-inv_r2) * active;
      float* r = s_red + (warp * CH + k) * NV;
      if (__any_sync(0xffffffffu, w > 0.0f)) {
        const float vx = warp_sum(dd2 * (-2.0f) * dx);
        const float vy = warp_sum(dd2 * (-2.0f) * dy);
        if (lane == 0) {
          r[0] = vx;
          r[1] = vy;
        }
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) {
          if (c < NV - 2) {
            const float vf = warp_sum(gc[c] * wT);
            if (lane == 0) r[2 + c] = vf;
          }
        }
      } else if (lane == 0) {
        for (int v = 0; v < NV; ++v) r[v] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < C) S[c] = S[c] + wT * s_f[c * CH + k];
    }
    __syncthreads();
    for (int i = tid; i < m * NV; i += P) {
      const int k = i / NV, v = i % NV;
      float s = 0.0f;
      for (int wi = 0; wi < nwarp; ++wi) s += s_red[(wi * CH + k) * NV + v];
      out[(long)v * cap + j * CH + k] = s;
    }
    __syncthreads();
  }
}

// grid (B * T), block 256: adds a tile's G partials in order; zeros past cnt.
__global__ void composite_bwd_reduce(const float* __restrict__ partial,
                                     const int* __restrict__ cnt, float* __restrict__ dcx,
                                     float* __restrict__ dcy, float* __restrict__ dfeat,
                                     int cap, int C, int NV, int G) {
  const long bt = blockIdx.x;
  const int n = cnt[bt];
  for (int k = threadIdx.x; k < cap; k += blockDim.x) {
    float s[2 + MAX_C];
#pragma unroll
    for (int v = 0; v < 2 + MAX_C; ++v) s[v] = 0.0f;
    if (k < n) {
      for (int pg = 0; pg < G; ++pg) {
        const float* q = partial + (bt * G + pg) * (long)NV * cap;
#pragma unroll
        for (int v = 0; v < 2 + MAX_C; ++v)
          if (v < NV) s[v] += q[(long)v * cap + k];
      }
    }
    dcx[bt * cap + k] = s[0];
    dcy[bt * cap + k] = s[1];
    for (int c = 0; c < NV - 2; ++c) dfeat[(bt * C + c) * cap + k] = s[2 + c];
  }
}

}  // namespace

// Bytes of scratch (partial sums) the launch needs.
extern "C" long composite_bwd_scratch(int B, int T, int cap, int C, int tile, int need_dfeat) {
  const int npix = tile * tile;
  const int P = npix < MAX_P ? npix : MAX_P;
  const int NV = need_dfeat ? 2 + C : 2;
  return (long)sizeof(float) * B * T * (npix / P) * NV * cap;
}

// cx, cy, val (B, T, cap) f32, feat (B, T, C, cap) f32, cnt (B, T) i32,
// g (B, T, C, tile^2) f32 → dcx, dcy (B, T, cap) f32 and, with need_dfeat,
// dfeat (B, T, C, cap) f32. scratch: composite_bwd_scratch(...) bytes.
extern "C" int composite_bwd_launch(const float* cx, const float* cy, const float* val,
                                    const float* feat, const int* cnt, const float* g,
                                    float* dcx, float* dcy, float* dfeat, float* scratch,
                                    float inv_r2, int B, int T, int cap, int C, int Wt,
                                    int tile, int need_dfeat, void* stream) {
  if (C < 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
  const int npix = tile * tile;
  const int P = npix < MAX_P ? npix : MAX_P;
  if (P % 32 != 0 || npix % P != 0) return (int)cudaErrorInvalidValue;
  const int G = npix / P;
  const int NV = need_dfeat ? 2 + C : 2;
  const int n_ck = (cap + CH - 1) / CH;
  const size_t smem = sizeof(float) * ((size_t)n_ck * P + (size_t)CH * P + 3 * CH +
                                       MAX_C * CH + (size_t)(P / 32) * CH * NV);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        composite_bwd_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = (cudaStream_t)stream;
  composite_bwd_partial<<<dim3(T * G, B), P, smem, s>>>(cx, cy, val, feat, cnt, g, scratch,
                                                         inv_r2, T, cap, C, NV, Wt, tile, G,
                                                         n_ck);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  composite_bwd_reduce<<<B * T, 256, 0, s>>>(scratch, cnt, dcx, dcy, dfeat, cap, C, NV, G);
  return (int)cudaGetLastError();
}
