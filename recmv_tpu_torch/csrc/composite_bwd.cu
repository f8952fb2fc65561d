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
// What bounds it on the H100: the bytes are the candidates, the upstream
// gradient and the outputs (~25 MB on the main path, a few microseconds);
// the operations are those of the (pixel, candidate) pairs with w > 0, a
// few per cent of all pairs at the mask's splat radius (1.62 px). A dense
// walk of every pair three times (forward, chunk recompute, reverse) with a
// second kernel adding per-block partial sums through device memory is far
// above both.
// Design: touch only the pairs that can be non-zero, in one kernel.
// - One block per (tile, frame), one thread per pixel (tile^2 threads); a
//   warp owns an 8 x 4 sub-tile (lane l at (l % 8, l / 8)).
// - Candidates go through in segments of SEG (512, 256, 128, 64 or 32, the
//   largest whose buffers fit in shared memory), staged with cp.async and
//   double buffered: the next segment loads while the warps walk this one.
// - Per segment, each warp culls the segment's candidates into its list in
//   shared memory (uint16, z order) with the same conservative test as
//   composite_fwd.cu (may_touch; a dropped pair has raw <= 0, so w = 0,
//   active = 0 and it adds exact zeros), and walks only that list.
// - Chain semantics: T and S are never rebuilt by division or subtraction.
//   The forward sweep keeps T at the start of every segment, per pixel, in
//   shared memory. The reverse sweep takes the segments last to first; in a
//   segment it takes the warp's list in chunks of CH entries from the end,
//   recomputes the chunk's T from the segment's checkpoint into registers
//   with the forward's own multiplies, and walks the chunk backwards
//   carrying S. A chunk runs straight through (entries past the list get
//   w = 0, an exact identity), so one entry's warp sums can overlap the
//   next entry's arithmetic. The recompute costs ~L^2 / (2 CH) weight
//   evaluations for a warp's list of L entries in a segment: small for
//   the mask's splats (a warp lists a few per cent of a segment), large
//   only when every candidate reaches every sub-tile. Each segment costs
//   two block barriers and a reduction pass, so on the main path SEG 512
//   beats 256 (chip_ab_composite.py on an H100: 0.28 against 0.35 ms).
// - Per-candidate sums over pixels without float atomics, so a second
//   launch gives the same bits: across a warp with __shfl_down_sync, into
//   the warp's slot of the candidate in shared memory (slots of warps that
//   did not list it stay exact zeros), then the tile's warps' slots in
//   warp order, written straight to the outputs. No scratch in device
//   memory and no second kernel.
// - Shared memory per block: T checkpoints ceil(cap/SEG) * tile^2 floats,
//   slots tile^2/32 * NV * SEG floats (NV = 2, or 2 + C with dfeat), two
//   staging buffers (3 + C) * SEG floats each, lists tile^2/32 * SEG
//   uint16. At tile 32 that fits caps up to 8,704 for C = 1 without dfeat
//   and 2,176 for C = 8 with dfeat; beyond, the launch returns
//   cudaErrorInvalidConfiguration.
// The multiplies and adds follow the TPU kernel's order and the file is
// built with -fmad=false.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int MAX_C = 8;
constexpr int SUB_W = 8, SUB_H = 4;    // a warp's sub-tile of pixels
constexpr int CH = 8;                  // T values a thread holds in registers
constexpr int SMEM_MAX = 232448;       // bytes of shared memory a block may use
constexpr float EPS = 1e-10f;
constexpr float CULL_LIMIT = 1.0f + 1.0f / 1024.0f;

// The cull of composite_fwd.cu, unchanged (see there for why it is exact).
__device__ __forceinline__ bool may_touch(float cx, float cy, float bx0, float by0,
                                          float inv_r2) {
  const float ex = fmaxf(fmaxf(bx0 - cx, cx - (bx0 + (float)(SUB_W - 1))), 0.0f);
  const float ey = fmaxf(fmaxf(by0 - cy, cy - (by0 + (float)(SUB_H - 1))), 0.0f);
  return !((ex * ex + ey * ey) * inv_r2 >= CULL_LIMIT);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <int C, bool DFEAT>
__global__ void __launch_bounds__(1024)
    composite_bwd_kernel(const float* __restrict__ cx, const float* __restrict__ cy,
                         const float* __restrict__ val, const float* __restrict__ feat,
                         const int* __restrict__ cnt, const float* __restrict__ g,
                         float* __restrict__ dcx, float* __restrict__ dcy,
                         float* __restrict__ dfeat, float inv_r2, int T, int cap, int Wt,
                         int tile, int seg, int nseg_max) {
  constexpr int NV = DFEAT ? 2 + C : 2;
  constexpr int NS = 3 + C;  // staged arrays: cx, cy, val, feat[C]
  extern __shared__ float smem[];
  const int tid = threadIdx.x, npix = blockDim.x, nwarp = npix >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  float* s_ck = smem;                                   // (nseg_max, npix)
  float* s_red = s_ck + (long)nseg_max * npix;          // (nwarp, NV, seg)
  float* s_stage = s_red + nwarp * NV * seg;            // 2 x (NS, seg)
  uint16_t* s_list = reinterpret_cast<uint16_t*>(s_stage + 2 * NS * seg) + warp * seg;
  float* red = s_red + warp * NV * seg;

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
  const int nseg = (n + seg - 1) / seg;

  float gc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gc[c] = g[(bt * C + c) * npix + y * tile + x];

  auto stage = [&](int s, int buf) {
    float* d = s_stage + buf * NS * seg;
    const int k0 = s * seg, m = min(seg, n - k0);
    for (int i = tid; i < m; i += npix) {
      __pipeline_memcpy_async(d + i, cx + base + k0 + i, sizeof(float));
      __pipeline_memcpy_async(d + seg + i, cy + base + k0 + i, sizeof(float));
      __pipeline_memcpy_async(d + 2 * seg + i, val + base + k0 + i, sizeof(float));
#pragma unroll
      for (int c = 0; c < C; ++c)
        __pipeline_memcpy_async(d + (3 + c) * seg + i, F + (long)c * cap + k0 + i,
                                sizeof(float));
    }
  };
  // this warp's list of the m staged candidates it may touch → its length
  auto cull = [&](const float* d, int m) {
    int L = 0;
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      const bool keep = j < m && may_touch(d[j], d[seg + j], bx0, by0, inv_r2);
      const unsigned ball = __ballot_sync(0xffffffffu, keep);
      if (keep) s_list[L + __popc(ball & ((1u << lane) - 1u))] = (uint16_t)j;
      L += __popc(ball);
    }
    __syncwarp();
    return L;
  };
  auto weight = [&](const float* d, int k, float& dx, float& dy, float& raw) {
    dx = px - d[k];
    dy = py - d[seg + k];
    const float d2 = dx * dx + dy * dy;
    raw = 1.0f - d2 * inv_r2;
    return fminf(fmaxf(raw, 0.0f), 1.0f) * d[2 * seg + k];
  };

  // forward sweep: T at the start of each segment
  float trans = 1.0f;
  if (nseg > 0) stage(0, 0);
  __pipeline_commit();
  for (int s = 0; s < nseg; ++s) {
    if (s + 1 < nseg) stage(s + 1, (s + 1) & 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const float* d = s_stage + (s & 1) * NS * seg;
    s_ck[s * npix + tid] = trans;
    const int L = cull(d, min(seg, n - s * seg));
    for (int i = 0; i < L; ++i) {
      float dx, dy, raw;
      const float w = weight(d, s_list[i], dx, dy, raw);
      trans = trans * ((1.0f - w) + EPS);
    }
    __syncthreads();
  }

  // reverse sweep, segment by segment from the last, carrying S
  float S[C];
#pragma unroll
  for (int c = 0; c < C; ++c) S[c] = 0.0f;
  if (nseg > 0) stage(nseg - 1, 0);
  __pipeline_commit();
  for (int r = 0; r < nseg; ++r) {
    const int s = nseg - 1 - r;
    if (r + 1 < nseg) stage(s - 1, (r + 1) & 1);
    __pipeline_commit();
    for (int i = tid; i < nwarp * NV * seg; i += npix) s_red[i] = 0.0f;
    __pipeline_wait_prior(1);
    __syncthreads();
    const float* d = s_stage + (r & 1) * NS * seg;
    const int k0 = s * seg, m = min(seg, n - k0);
    const int L = cull(d, m);
    const float ck = s_ck[s * npix + tid];
    for (int c0 = L > 0 ? ((L - 1) / CH) * CH : -1; c0 >= 0; c0 -= CH) {
      float tr = ck;
      for (int i = 0; i < c0; ++i) {
        float dx, dy, raw;
        const float w = weight(d, s_list[i], dx, dy, raw);
        tr = tr * ((1.0f - w) + EPS);
      }
      // the chunk runs straight through, entries past the list masked
      // (w = 0 there, an exact identity), so the compiler can overlap one
      // entry's warp sums with the next entry's arithmetic
      int ks[CH];
      float Tr[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        ks[j] = s_list[c0 + j < L ? c0 + j : c0];
        Tr[j] = tr;
        float dx, dy, raw;
        const float wj = weight(d, ks[j], dx, dy, raw);
        const float w = c0 + j < L ? wj : 0.0f;
        tr = tr * ((1.0f - w) + EPS);
      }
#pragma unroll
      for (int j = CH - 1; j >= 0; --j) {
        const bool in_list = c0 + j < L;
        const int k = ks[j];
        float dx, dy, raw;
        const float wk = weight(d, k, dx, dy, raw);
        const float w = in_list ? wk : 0.0f;
        const float Tk = Tr[j];
        const float wT = w * Tk;
        float dLdw = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c)
          dLdw = dLdw + gc[c] * (Tk * d[(3 + c) * seg + k] - S[c] / ((1.0f - w) + EPS));
        const float active = (in_list && raw > 0.0f && raw < 1.0f) ? d[2 * seg + k] : 0.0f;
        const float dd2 = dLdw * (-inv_r2) * active;
        const float vx = warp_sum(dd2 * (-2.0f) * dx);
        const float vy = warp_sum(dd2 * (-2.0f) * dy);
        if (lane == 0 && in_list) {
          red[k] = vx;
          red[seg + k] = vy;
        }
        if (DFEAT) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float vf = warp_sum(gc[c] * wT);
            if (lane == 0 && in_list) red[(2 + c) * seg + k] = vf;
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) S[c] = S[c] + wT * d[(3 + c) * seg + k];
      }
    }
    __syncthreads();
    // each candidate's warp slots, in warp order
    for (int i = tid; i < NV * m; i += npix) {
      const int v = i / m, k = i % m;
      float sum = 0.0f;
      for (int wi = 0; wi < nwarp; ++wi) sum += s_red[(wi * NV + v) * seg + k];
      float* o = v == 0 ? dcx + base : v == 1 ? dcy + base : dfeat + (bt * C + v - 2) * cap;
      o[k0 + k] = sum;
    }
    __syncthreads();
  }

  for (int k = n + tid; k < cap; k += npix) {
    dcx[base + k] = 0.0f;
    dcy[base + k] = 0.0f;
    if (DFEAT) {
#pragma unroll
      for (int c = 0; c < C; ++c) dfeat[(bt * C + c) * cap + k] = 0.0f;
    }
  }
}

template <int C, bool DFEAT>
int launch(const float* cx, const float* cy, const float* val, const float* feat,
           const int* cnt, const float* g, float* dcx, float* dcy, float* dfeat, float inv_r2,
           int B, int T, int cap, int Wt, int tile, cudaStream_t stream) {
  constexpr int NV = DFEAT ? 2 + C : 2;
  const int npix = tile * tile, nwarp = npix / 32;
  int seg = 0, nseg_max = 0;
  size_t smem = 0;
  for (int cand : {512, 256, 128, 64, 32}) {
    const int ns = (cap + cand - 1) / cand;
    const size_t bytes = sizeof(float) * ((size_t)ns * npix + (size_t)nwarp * NV * cand +
                                          2 * (size_t)(3 + C) * cand) +
                         sizeof(uint16_t) * (size_t)nwarp * cand;
    if (bytes <= SMEM_MAX) {
      seg = cand;
      nseg_max = ns;
      smem = bytes;
      break;
    }
  }
  if (seg == 0) return (int)cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(composite_bwd_kernel<C, DFEAT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  composite_bwd_kernel<C, DFEAT><<<dim3(T, B), npix, smem, stream>>>(
      cx, cy, val, feat, cnt, g, dcx, dcy, dfeat, inv_r2, T, cap, Wt, tile, seg, nseg_max);
  return (int)cudaGetLastError();
}

template <int C>
int launch_c(const float* cx, const float* cy, const float* val, const float* feat,
             const int* cnt, const float* g, float* dcx, float* dcy, float* dfeat, float inv_r2,
             int B, int T, int cap, int Wt, int tile, int need_dfeat, cudaStream_t stream) {
  return need_dfeat ? launch<C, true>(cx, cy, val, feat, cnt, g, dcx, dcy, dfeat, inv_r2, B, T,
                                      cap, Wt, tile, stream)
                    : launch<C, false>(cx, cy, val, feat, cnt, g, dcx, dcy, dfeat, inv_r2, B,
                                       T, cap, Wt, tile, stream);
}

}  // namespace

// cx, cy, val (B, T, cap) f32, feat (B, T, C, cap) f32, cnt (B, T) i32,
// g (B, T, C, tile^2) f32 → dcx, dcy (B, T, cap) f32 and, with need_dfeat,
// dfeat (B, T, C, cap) f32. C in 1..8, tile in {8, 16, 32}, cap < 65536.
extern "C" int composite_bwd_launch(const float* cx, const float* cy, const float* val,
                                    const float* feat, const int* cnt, const float* g,
                                    float* dcx, float* dcy, float* dfeat, float inv_r2, int B,
                                    int T, int cap, int C, int Wt, int tile, int need_dfeat,
                                    void* stream) {
  if (C < 1 || C > MAX_C || (tile != 8 && tile != 16 && tile != 32) || cap < 0 || cap > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define RECMV_BWD_CASE(NC)                                                                  \
  case NC:                                                                                  \
    return launch_c<NC>(cx, cy, val, feat, cnt, g, dcx, dcy, dfeat, inv_r2, B, T, cap, Wt, \
                        tile, need_dfeat, s);
  switch (C) {
    RECMV_BWD_CASE(1)
    RECMV_BWD_CASE(2)
    RECMV_BWD_CASE(3)
    RECMV_BWD_CASE(4)
    RECMV_BWD_CASE(5)
    RECMV_BWD_CASE(6)
    RECMV_BWD_CASE(7)
    default:
      return launch_c<8>(cx, cy, val, feat, cnt, g, dcx, dcy, dfeat, inv_r2, B, T, cap, Wt,
                         tile, need_dfeat, s);
  }
#undef RECMV_BWD_CASE
}
