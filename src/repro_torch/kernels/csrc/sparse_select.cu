// Sparse candidate-page selection for all m ants: gather the tabu bit and
// the draw at each ant's K candidate cities, weight the page
// tau^alpha * eta^beta, mask, apply the per-mode transform, take the first
// arg-max over the K page positions (pos), and report whether any
// unvisited candidate has positive weight (have).
//
// Replaces repro/kernels/sparse_select.py::sparse_select (_sparse_kernel),
// with its int8/bf16 payload epilogue (quant="int8"/"bf16",
// sparse_select.py:79-85).  The Pallas kernel gathers visited/rand with a
// one-hot batched dot over city tiles because a TPU kernel cannot gather;
// here each lane reads visited[a, cand] and rand[a, cand] directly.
// Bound: bytes -- per (ant, page position) it reads the id (4), tau (4, 2
// or 1, + a 4-byte scale for int8) and eta (4) contiguously, and two
// scattered 32-byte sectors for the gathered tabu byte and draw.  At
// m = 64, K = 20 that is about 0.1 MB, tens of nanoseconds at 3.35 TB/s:
// the launch itself is the cost.
// Design: one warp per ant, kWarps ants per block; lanes stride over the K
// positions (K <= 36 on the sparse route, one or two per lane), keep a
// running (value, index) with the lowest-index tie rule of the dense
// kernels (aco::ArgMax) and a partial sum of w * mask, then one warp
// shuffle reduction.  Ids < 0 are padding, as in the reference oracle:
// they gather visited 0 and draw 0 and keep their page's own tau and eta.
// Ids >= n are not valid input; they are read as padding too, so that no
// load leaves the row.  The int8 payload converts exactly to float and
// multiplies by its per-element scale with __fmul_rn (the oracle's
// dequantise-then-select); bf16 widens exactly.
//
// aco_sparse_walk: the whole sparse construction walk in one launch, the
// port of the reference's lax.scan over the steps (repro/sparse/
// construct.py _construct_sparse / _partial_impl) on the kernel route.
// Ants are independent and tau is read-only during construction, so one
// warp owns one ant for all S steps; the ant's tabu row (n bytes) and the
// city coordinates (8 n bytes, shared by the block) sit in shared memory
// when they fit.  Each step, with every rounding as the plain path rounds:
//   page      lanes gather the candidate page of `cur` (k ids, tau payload,
//             eta, cand_dist) and the O overflow slots (an empty slot maps
//             to cur; its distance is computed lazily from the coordinates
//             as sparse/store._round_ewt does, its eta 1 / max(d, 1e-10));
//   draw      the threefry-2x32 uniform at the K candidates only, in
//             registers (packed: y0 ^ y1 of threefry(key, (0, a n + c));
//             counter: y0 of threefry(key, (a 65536 + c, 0)); then
//             sampling._uniform_from_bits), from the step's key read on the
//             device; greedy draws nothing, an id < 0 draws 0;
//   select    as sparse_select_kernel: transform, lowest-index arg-max and
//             `have`, reduced with xor shuffles so every lane holds them;
//   fallback  the reference's lax.cond, per ant: only an ant with no `have`
//             scans all n cities for the nearest unvisited one below
//             n_actual by lazy distance (first minimum, as torch.argmin);
//   emit      the next city and the edge length, visited[a, next] = 1; on a
//             padded instance steps t >= n_actual emit city t at length 0.
// Bound: latency.  Its bytes (pages, tabu rows and outputs once each) are
// about 2 MB at n = 2392, m = 64, k = 16 + 4, under 1 us at 3.35 TB/s; but
// each of the S steps waits for at least two dependent L2 round trips
// (cur -> page -> overflow coordinates) and a warp reduction.
#include <cuda_bf16.h>
#include <cstdint>
#include <cmath>

#include "aco_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_tau(const float* tau, long long i,
                                          const float*) {
  return tau[i];
}
__device__ __forceinline__ float load_tau(const __nv_bfloat16* tau,
                                          long long i, const float*) {
  return __bfloat162float(tau[i]);
}
__device__ __forceinline__ float load_tau(const int8_t* tau, long long i,
                                          const float* scale) {
  return __fmul_rn((float)tau[i], scale[i]);
}

template <typename T, int MODE>
__global__ void sparse_select_kernel(const T* __restrict__ tau,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ eta,
                                     const int* __restrict__ cand,
                                     const unsigned char* __restrict__ visited,
                                     const float* __restrict__ rand,
                                     int* __restrict__ pos,
                                     int* __restrict__ have, int m, int k,
                                     int n, float alpha, float beta) {
  const int lane = threadIdx.x & 31;
  const int a = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (a >= m) return;  // a whole warp leaves together
  const long long page = (long long)a * k;
  const long long row = (long long)a * n;
  aco::ArgMax best = aco::ArgMax::empty();
  float sum = 0.0f;
  for (int j = lane; j < k; j += 32) {
    const int c = cand[page + j];
    const bool real = c >= 0 && c < n;
    const bool keep = !real || visited[row + c] == 0;
    const float u = real ? rand[row + c] : 0.0f;
    const float w =
        aco::choice(load_tau(tau, page + j, scale), eta[page + j], alpha,
                    beta);
    best.take(aco::transform<MODE>(w, keep, u), j);
    sum = __fadd_rn(sum, __fmul_rn(w, keep ? 1.0f : 0.0f));
  }
  // Every term of `sum` is >= 0, +inf or NaN, so whether it ends > 0 does
  // not depend on the order of the additions.
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(kFull, best.val, off);
    const int i = __shfl_down_sync(kFull, best.idx, off);
    best.take(v, i);
    sum = __fadd_rn(sum, __shfl_down_sync(kFull, sum, off));
  }
  if (lane == 0) {
    pos[a] = best.idx == INT_MAX ? 0 : best.idx;
    have[a] = sum > 0.0f ? 1 : 0;
  }
}

template <typename T>
int launch_mode(const T* tau, const float* scale, const float* eta,
                const int* cand, const unsigned char* visited,
                const float* rand, int* pos, int* have, int m, int k, int n,
                float alpha, float beta, int mode, cudaStream_t s) {
  const int grid = (m + kWarps - 1) / kWarps;
  const int block = kWarps * 32;
  switch (mode) {
    case aco::kIRoulette:
      sparse_select_kernel<T, aco::kIRoulette><<<grid, block, 0, s>>>(
          tau, scale, eta, cand, visited, rand, pos, have, m, k, n, alpha,
          beta);
      break;
    case aco::kGumbel:
      sparse_select_kernel<T, aco::kGumbel><<<grid, block, 0, s>>>(
          tau, scale, eta, cand, visited, rand, pos, have, m, k, n, alpha,
          beta);
      break;
    case aco::kGreedy:
      sparse_select_kernel<T, aco::kGreedy><<<grid, block, 0, s>>>(
          tau, scale, eta, cand, visited, rand, pos, have, m, k, n, alpha,
          beta);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------- the walk

enum Ewt : int { kEuc2d = 0, kCeil2d = 1, kAtt = 2, kRaw = 3 };
enum Draw : int { kPacked = 0, kCounter = 1 };
constexpr int kWalkWarps = 4;
constexpr int kSmemCap = 232448;  // bytes of shared memory a block may use

// sparse/store._round_ewt on one pair: dx*dx + dy*dy with one rounding (the
// reference's compiled multiply-add), the correctly rounded square root.
__device__ __forceinline__ float lazy_dist(float2 p, float2 q, int ewt) {
  const float dx = __fsub_rn(p.x, q.x), dy = __fsub_rn(p.y, q.y);
  const float sq = __fmaf_rn(dy, dy, __fmul_rn(dx, dx));
  if (ewt == kEuc2d) return rintf(__fsqrt_rn(sq));
  if (ewt == kCeil2d) return ceilf(__fsqrt_rn(sq));
  if (ewt == kAtt) {
    const float r = __fsqrt_rn(__fdiv_rn(sq, 10.0f));
    const float t = rintf(r);
    return t < r ? __fadd_rn(t, 1.0f) : t;
  }
  return __fsqrt_rn(sq);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define ACO_TF4(r0, r1, r2, r3)               \
  x0 += x1; x1 = rotl(x1, r0) ^ x0;           \
  x0 += x1; x1 = rotl(x1, r1) ^ x0;           \
  x0 += x1; x1 = rotl(x1, r2) ^ x0;           \
  x0 += x1; x1 = rotl(x1, r3) ^ x0;

// Threefry-2x32, 20 rounds (core/sampling.threefry2x32, jax.random's hash).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  ACO_TF4(13, 15, 26, 6)  x0 += k1; x1 += k2 + 1u;
  ACO_TF4(17, 29, 16, 24) x0 += k2; x1 += k0 + 2u;
  ACO_TF4(13, 15, 26, 6)  x0 += k0; x1 += k1 + 3u;
  ACO_TF4(17, 29, 16, 24) x0 += k1; x1 += k2 + 4u;
  ACO_TF4(13, 15, 26, 6)  x0 += k2; x1 += k0 + 5u;
}
#undef ACO_TF4

// U[lo, lo + span) at (ant a, city c) of the step's (m, n) draw.
__device__ __forceinline__ float draw_at(uint32_t k0, uint32_t k1, int a,
                                         int c, int n, int draw, float lo,
                                         float span) {
  uint32_t x0, x1;
  if (draw == kPacked) {
    const unsigned long long flat = (unsigned long long)a * n + c;
    x0 = (uint32_t)(flat >> 32);
    x1 = (uint32_t)flat;
  } else {
    x0 = (uint32_t)a * 65536u + (uint32_t)c;
    x1 = 0u;
  }
  threefry2x32(k0, k1, x0, x1);
  const uint32_t bits = draw == kPacked ? (x0 ^ x1) : x0;
  const float flo = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                              1.0f);
  return fmaxf(lo, __fmaf_rn(flo, span, lo));
}

// Page payload of row r, position j: int8 scales are per row.
__device__ __forceinline__ float page_tau(const float* t, long long i,
                                          const float*, int) {
  return t[i];
}
__device__ __forceinline__ float page_tau(const __nv_bfloat16* t,
                                          long long i, const float*, int) {
  return __bfloat162float(t[i]);
}
__device__ __forceinline__ float page_tau(const int8_t* t, long long i,
                                          const float* scale, int r) {
  return __fmul_rn((float)t[i], scale[r]);
}

// (value, index) arg-min with torch.argmin's rule: NaN is the smallest,
// ties keep the lowest index.
__device__ __forceinline__ bool min_beats(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v < bv;
  return i < bi;
}

struct WalkArgs {
  const float2* coords;
  const int* cand;
  const float* cand_dist;
  const float* cand_eta;
  const void* tau;
  const float* tau_scale;
  const int* ovf_city;
  const void* ovf_tau;
  const float* ovf_scale;
  const int* start;
  unsigned char* visited;
  const long long* keys;
  int* out_city;
  float* out_dist;
  int* fallbacks;
  int m, n, k, o, steps, n_act, tail, draw, ewt, vis_smem, xy_smem;
  float lo, span, alpha, beta;
};

template <typename T, int MODE>
__global__ void sparse_walk_kernel(WalkArgs g) {
  extern __shared__ __align__(16) unsigned char wsmem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int n = g.n, k = g.k, K = g.k + g.o;
  const int vstride = (n + 15) & ~15;
  const float2* xy = g.coords;
  unsigned char* vbase = wsmem;
  if (g.xy_smem) {
    float2* s_xy = reinterpret_cast<float2*>(wsmem);
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_xy[i] = g.coords[i];
    xy = s_xy;
    vbase = wsmem + (size_t)n * sizeof(float2);
  }
  __syncthreads();
  const int a = blockIdx.x * warps + warp;
  if (a >= g.m) return;  // a whole warp leaves together
  unsigned char* grow = g.visited + (long long)a * n;
  unsigned char* vis = grow;
  if (g.vis_smem) {
    vis = vbase + (size_t)warp * vstride;
    for (int i = lane; i < n; i += 32) vis[i] = grow[i];
  }
  __syncwarp();
  const T* tau = static_cast<const T*>(g.tau);
  const T* ovf_tau = static_cast<const T*>(g.ovf_tau);
  int cur = g.start[a];
  int fb = 0;
  for (int s = 0; s < g.steps; ++s) {
    const int t = s + 1;
    int nxt;
    float d;
    if (t >= g.tail) {
      nxt = t;
      d = 0.0f;
    } else {
      const float2 pc = xy[cur];
      uint32_t k0 = 0u, k1 = 0u;
      if (MODE != aco::kGreedy) {
        k0 = (uint32_t)g.keys[2 * s];
        k1 = (uint32_t)g.keys[2 * s + 1];
      }
      aco::ArgMax best = aco::ArgMax::empty();
      int bcity = 0;
      float bdist = 0.0f, sum = 0.0f;
      for (int j = lane; j < K; j += 32) {
        int c;
        float tv, e, dd;
        if (j < k) {
          const long long i = (long long)cur * k + j;
          c = g.cand[i];
          tv = page_tau(tau, i, g.tau_scale, cur);
          e = g.cand_eta[i];
          dd = g.cand_dist[i];
        } else {
          const long long i = (long long)cur * g.o + (j - k);
          const int oc = g.ovf_city[i];
          c = oc >= 0 ? oc : cur;
          dd = lazy_dist(pc, xy[c < n ? c : cur], g.ewt);
          e = __fdiv_rn(1.0f, fmaxf(dd, 1e-10f));
          tv = page_tau(ovf_tau, i, g.ovf_scale, cur);
        }
        const bool real = c >= 0 && c < n;
        const bool keep = !real || vis[c] == 0;
        const float u = (MODE == aco::kGreedy || !real)
                            ? 0.0f
                            : draw_at(k0, k1, a, c, n, g.draw, g.lo, g.span);
        const float w = aco::choice(tv, e, g.alpha, g.beta);
        const float v = aco::transform<MODE>(w, keep, u);
        if (best.beaten_by(v, j)) {
          best.val = v;
          best.idx = j;
          bcity = c;
          bdist = dd;
        }
        sum = __fadd_rn(sum, __fmul_rn(w, keep ? 1.0f : 0.0f));
      }
      // Every term of `sum` is >= 0, +inf or NaN: whether it ends > 0 does
      // not depend on the order of the additions.
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, best.val, off);
        const int oi = __shfl_xor_sync(kFull, best.idx, off);
        const int oc = __shfl_xor_sync(kFull, bcity, off);
        const float od = __shfl_xor_sync(kFull, bdist, off);
        if (best.beaten_by(ov, oi)) {
          best.val = ov;
          best.idx = oi;
          bcity = oc;
          bdist = od;
        }
        sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, off));
      }
      if (sum > 0.0f) {
        nxt = bcity;
        d = bdist;
      } else {
        // page fault: nearest unvisited real city by lazy distance
        float bv = INFINITY;
        int bi = INT_MAX;
        for (int j = lane; j < n; j += 32) {
          const float v = (vis[j] != 0 || j >= g.n_act)
                              ? INFINITY
                              : lazy_dist(pc, xy[j], g.ewt);
          if (min_beats(v, j, bv, bi)) { bv = v; bi = j; }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(kFull, bv, off);
          const int oi = __shfl_xor_sync(kFull, bi, off);
          if (min_beats(ov, oi, bv, bi)) { bv = ov; bi = oi; }
        }
        nxt = bi;
        d = lazy_dist(pc, xy[nxt], g.ewt);
        ++fb;
      }
    }
    if (lane == 0) {
      g.out_city[(long long)s * g.m + a] = nxt;
      g.out_dist[(long long)s * g.m + a] = d;
      if (nxt >= 0 && nxt < n) vis[nxt] = 1;
    }
    __syncwarp();
    if (nxt >= 0 && nxt < n) cur = nxt;
  }
  if (g.vis_smem) {
    for (int i = lane; i < n; i += 32) grow[i] = vis[i];
  }
  if (lane == 0) g.fallbacks[a] = fb;
}

template <typename T, int MODE>
int launch_walk_kernel(const WalkArgs& g, int warps, size_t smem,
                       cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sparse_walk_kernel<T, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (g.m + warps - 1) / warps;
  sparse_walk_kernel<T, MODE><<<grid, warps * 32, smem, s>>>(g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_walk(const WalkArgs& g, int mode, int warps, size_t smem,
                cudaStream_t s) {
  switch (mode) {
    case aco::kIRoulette:
      return launch_walk_kernel<T, aco::kIRoulette>(g, warps, smem, s);
    case aco::kGumbel:
      return launch_walk_kernel<T, aco::kGumbel>(g, warps, smem, s);
    case aco::kGreedy:
      return launch_walk_kernel<T, aco::kGreedy>(g, warps, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// tau, eta, cand: (m, k) row-major; visited, rand: (m, n); pos, have: (m,).
extern "C" int aco_sparse_select(const float* tau, const float* eta,
                                 const int* cand,
                                 const unsigned char* visited,
                                 const float* rand, int* pos, int* have,
                                 int m, int k, int n, float alpha, float beta,
                                 int mode, void* stream) {
  if (m == 0) return 0;
  return launch_mode<float>(tau, nullptr, eta, cand, visited, rand, pos,
                            have, m, k, n, alpha, beta, mode,
                            static_cast<cudaStream_t>(stream));
}

// The quantised page payload: payload 1 = int8 tau with its (m, k) float32
// scale, 2 = bfloat16 tau (scale unused).
extern "C" int aco_sparse_select_quant(const void* tau, int payload,
                                       const float* scale, const float* eta,
                                       const int* cand,
                                       const unsigned char* visited,
                                       const float* rand, int* pos,
                                       int* have, int m, int k, int n,
                                       float alpha, float beta, int mode,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  if (payload == 1) {
    if (scale == nullptr) return (int)cudaErrorInvalidValue;
    return launch_mode<int8_t>(static_cast<const int8_t*>(tau), scale, eta,
                               cand, visited, rand, pos, have, m, k, n,
                               alpha, beta, mode, s);
  }
  if (payload == 2) {
    return launch_mode<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(tau), nullptr, eta, cand, visited,
        rand, pos, have, m, k, n, alpha, beta, mode, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The sparse walk: S steps for m ants.  coords (n, 2); cand, cand_dist,
// cand_eta, tau (n, k); ovf_city, ovf_tau (n, o); tau_scale / ovf_scale the
// per-row int8 scales (n,) (payload 1 = int8, 2 = bf16, 0 = float32);
// start (m,); visited (m, n) bytes, updated; keys (S, 2) int64; outputs
// out_city / out_dist (S, m) and fallbacks (m,).  n_act bounds the
// fallback scan; steps t = s + 1 >= tail emit city t at length 0.
extern "C" int aco_sparse_walk(
    const float* coords, const int* cand, const float* cand_dist,
    const float* cand_eta, const void* tau, int payload,
    const float* tau_scale, const int* ovf_city, const void* ovf_tau,
    const float* ovf_scale, const int* start, unsigned char* visited,
    const long long* keys, int* out_city, float* out_dist, int* fallbacks,
    int m, int n, int k, int o, int steps, int n_act, int tail, int mode,
    int draw, int ewt, float lo, float span, float alpha, float beta,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  if (n <= 0 || k < 0 || o < 0 || (draw != kPacked && draw != kCounter) ||
      ewt < kEuc2d || ewt > kRaw || (payload == 1 && (!tau_scale ||
                                                      (o > 0 && !ovf_scale))))
    return (int)cudaErrorInvalidValue;
  WalkArgs g{reinterpret_cast<const float2*>(coords), cand, cand_dist,
             cand_eta, tau, tau_scale, ovf_city, ovf_tau, ovf_scale, start,
             visited, keys, out_city, out_dist, fallbacks, m, n, k, o, steps,
             n_act, tail, draw, ewt, 0, 0, lo, span, alpha, beta};
  // Shared memory: coordinates (8 n) and one tabu row (n, rounded to 16)
  // per warp when both fit; else the tabu rows only; else neither.
  const long long vrow = (n + 15) & ~15;
  int warps = kWalkWarps;
  long long smem = 8LL * n + warps * vrow;
  while (warps > 1 && smem > kSmemCap) smem = 8LL * n + --warps * vrow;
  if (smem <= kSmemCap) {
    g.xy_smem = 1;
    g.vis_smem = 1;
  } else {
    warps = kWalkWarps;
    smem = warps * vrow;
    while (warps > 1 && smem > kSmemCap) smem = --warps * vrow;
    if (smem <= kSmemCap) {
      g.vis_smem = 1;
    } else {
      warps = kWalkWarps;
      smem = 0;
    }
  }
  if (payload == 0)
    return launch_walk<float>(g, mode, warps, (size_t)smem, s);
  if (payload == 1)
    return launch_walk<int8_t>(g, mode, warps, (size_t)smem, s);
  if (payload == 2)
    return launch_walk<__nv_bfloat16>(g, mode, warps, (size_t)smem, s);
  return (int)cudaErrorInvalidValue;
}
