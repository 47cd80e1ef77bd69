// The dense fused construction: gather row cur[a] of tau and eta, weight
// tau^alpha * eta^beta, mask visited and phantom (>= n_actual) cities,
// apply the per-mode transform, take the first arg-max.
//
// Replaces repro/kernels/fused_select.py::fused_select (_fused_kernel,
// pallas_call at fused_select.py:176), with its int8/bf16 payload epilogue
// (quant="int8"/"bf16", fused_select.py:52-80).  The Pallas kernel gathers
// rows with one-hot MXU matmuls because a TPU kernel cannot gather
// dynamically; here each block reads its ant's rows directly.  Payloads are
// a template parameter: int8 converts exactly to float and multiplies by
// the row's scale (the reference's "gather, then scale"); bf16 widens
// exactly.  Scale is constant along the row, so both equal dequantising the
// whole matrix first, bit for bit.
//
// aco_fused_walk (the dense route's kernel): the reference's whole
// lax.scan over the n-1 fused steps (repro/core/strategies.py _construct
// over _make_fused_step) in one launch.  tau is read-only during
// construction and each ant depends only on its own tabu row, so one block
// owns one ant for every step, its tabu row (n bytes) in shared memory.
// Each step t:
//   key     fold_in(kc, t), computed in the kernel, one step's key per
//           thread for the next kWalkBlock steps, held in shared memory;
//   row     the block reads row `cur` of the payload and of eta in
//           4-element chunks aligned in the flat array (16-byte float4
//           loads for float32 and eta, 8 bytes for bf16, 4 for int8), so
//           any n and any row start vectorise; both arrays stay in L2;
//   draw    the threefry uniform (aco::draw_at, bitwise sampling.uniform /
//           counter_uniform) is hashed only where its value can change the
//           city's score: iroulette's (w u) keep equals (w 1) keep where
//           keep = 0 or w = 0 (u lies in [1e-6, 1)), and gumbel's score is
//           -1e30 unless keep and w > 0; greedy hashes nothing.  Each warp
//           queues its cities that need a draw in shared memory and its
//           lanes hash the queue in turn, so the hash runs on full warps
//           however the selectable cities lie along the row;
//   select  the lowest-index arg-max over every city (masked ones keep
//           their transformed value, as in the reference: an all-zero
//           iroulette row picks city 0, visited or not), one warp shuffle
//           reduction, one __syncthreads, and every thread reduces the
//           warps' partials itself (double-buffered by step parity);
//   emit    thread 0 writes out[t - t0, a]; every thread marks the pick in
//           the tabu row.  Steps t >= n_actual emit city t.
// The instance axis (the reference's pallas_call under vmap, in the
// batched engine): blockIdx.y is the instance b of a (B, n_rows, n) stack.
// Its payload, scale, eta, start, visited, key and out start b instance
// strides further on, and its n_actual is read from a (B,) device array; a
// block whose instance is inactive returns at once and writes nothing (the
// reference's where-freeze, at no walk cost).  One instance (B = 1, a host
// n_actual) is the single-instance walk: there is one kernel body.
// Bound: operations.  Its bytes (payload, eta, start, the tours) are about
// 9 MB at n = m = 1002 with int8 tau, 2.7 us at 3.35 TB/s; its integer
// work is one threefry hash (about 80 operations) at each (step, ant,
// selectable city), m n (n - 1) / 2 hashes, 2.4 ms at the H100's INT32
// rate.  The levers: every ant resident in one wave at n = m = 1002
// (kWalkBlock = 128 threads and at most 64 registers a thread give 8
// blocks an SM), hashing at selectable cities only on compacted warps,
// vector loads from L2, the tabu row in shared memory.  A prefetch cannot
// help: the next row is known only after the step's arg-max.
//
// Every float operation that the plain versions round separately carries
// an explicit rounding intrinsic (aco_common.cuh).
#include <cuda_bf16.h>
#include <cstdint>

#include "aco_common.cuh"

namespace {

constexpr int kBlock = 256;

// tau payload -> float32 (the dequant epilogue; identity for float32).
__device__ __forceinline__ float load_tau(const float* row, int j, float) {
  return row[j];
}
__device__ __forceinline__ float load_tau(const __nv_bfloat16* row, int j,
                                          float) {
  return __bfloat162float(row[j]);
}
__device__ __forceinline__ float load_tau(const int8_t* row, int j,
                                          float scale) {
  return __fmul_rn((float)row[j], scale);
}

template <typename T, int MODE>
__global__ void fused_select_kernel(const T* __restrict__ tau,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ eta,
                                    int n_rows, const int* __restrict__ cur,
                                    const unsigned char* __restrict__ visited,
                                    const float* __restrict__ rand,
                                    int* __restrict__ out, int n, float alpha,
                                    float beta, int n_act) {
  const int a = blockIdx.x;
  const int c = cur[a];
  // A current city outside [0, n_rows) gathers a zero row, as the
  // reference's one-hot gather does.
  const bool row_ok = c >= 0 && c < n_rows;
  const T* trow = tau + (long long)(row_ok ? c : 0) * n;
  const float srow = scale != nullptr ? scale[row_ok ? c : 0] : 1.0f;
  const float* erow = eta + (long long)(row_ok ? c : 0) * n;
  const long long base = (long long)a * n;
  aco::ArgMax best = aco::ArgMax::empty();
  for (int j = threadIdx.x; j < n; j += kBlock) {
    const float w =
        row_ok ? aco::choice(load_tau(trow, j, srow), erow[j], alpha, beta)
               : 0.0f;
    const bool keep = visited[base + j] == 0 && j < n_act;
    best.take(aco::transform<MODE>(w, keep, rand[base + j]), j);
  }
  best = aco::block_argmax<kBlock>(best);
  if (threadIdx.x == 0) out[a] = best.idx == INT_MAX ? 0 : best.idx;
}

template <typename T, int MODE>
void launch(const T* tau, const float* scale, const float* eta, int n_rows,
            const int* cur, const unsigned char* visited, const float* rand,
            int* out, int m, int n, float alpha, float beta, int n_act,
            cudaStream_t s) {
  fused_select_kernel<T, MODE><<<m, kBlock, 0, s>>>(
      tau, scale, eta, n_rows, cur, visited, rand, out, n, alpha, beta,
      n_act);
}

template <typename T>
int launch_mode(const T* tau, const float* scale, const float* eta,
                int n_rows, const int* cur, const unsigned char* visited,
                const float* rand, int* out, int m, int n, float alpha,
                float beta, int mode, int n_act, cudaStream_t s) {
  switch (mode) {
    case aco::kIRoulette:
      launch<T, aco::kIRoulette>(tau, scale, eta, n_rows, cur, visited, rand,
                                 out, m, n, alpha, beta, n_act, s);
      break;
    case aco::kGumbel:
      launch<T, aco::kGumbel>(tau, scale, eta, n_rows, cur, visited, rand,
                              out, m, n, alpha, beta, n_act, s);
      break;
    case aco::kGreedy:
      launch<T, aco::kGreedy>(tau, scale, eta, n_rows, cur, visited, rand,
                              out, m, n, alpha, beta, n_act, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- the walk

constexpr int kWalkBlock = 128;
constexpr int kWalkWarps = kWalkBlock / 32;
// chunks of 4 cities a thread queues before its warp hashes the queue
constexpr int kBatch = 4;
constexpr int kQueue = 32 * kBatch * 4;  // queue entries per warp
constexpr int kWalkSmemCap = 232448;     // shared memory a block may use

// Four payload values at flat indices 4q .. 4q + 3, as float32.
__device__ __forceinline__ void load4(const float* p, long long q, float,
                                      float v[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p) + q);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, long long q,
                                      float, float v[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p) + q);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xFFFF0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xFFFF0000u);
}
__device__ __forceinline__ void load4(const int8_t* p, long long q,
                                      float scale, float v[4]) {
  const int x = __ldg(reinterpret_cast<const int*>(p) + q);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = __fmul_rn((float)((x << (24 - 8 * i)) >> 24), scale);
}

// Whether the draw at a city with weight w and mask keep can change its
// score (see the note at the top).
template <int MODE>
__device__ __forceinline__ bool needs_draw(float w, bool keep) {
  if (MODE == aco::kIRoulette) return keep && w != 0.0f;
  if (MODE == aco::kGumbel) return keep && w > 0.0f;
  return false;
}

// The score of a city that needs no draw: the transform at u = 1 (its
// value does not depend on u there).
template <int MODE>
__device__ __forceinline__ float score_without_draw(float w, bool keep) {
  if (MODE == aco::kGumbel) return (float)-1e30;
  return aco::transform<MODE>(w, keep, 1.0f);
}

struct FusedWalkArgs {
  const void* tau;     // (B, n_rows, n) payload
  const float* scale;  // int8 per-row scale (B, n_rows), else null
  const float* eta;
  const int* start;
  const unsigned char* visited;  // (B, m, n) starting tabu rows, or null
  const long long* key;          // kc, (B, 2)
  int* out;                      // (B, n - t0, m)
  const int* n_actual;           // (B,) per instance, or null: n_act
  const unsigned char* active;   // (B,) flags, or null: every instance
  int m, n, n_rows, t0, n_act, draw;
  float alpha, beta, lo, span;
};

template <typename T, int MODE>
__global__ void __launch_bounds__(kWalkBlock, 8)
    fused_walk_kernel(FusedWalkArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint2 s_key[kWalkBlock];
  __shared__ float s_val[2][kWalkWarps];
  __shared__ int s_idx[2][kWalkWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int a = blockIdx.x, b = blockIdx.y, n = g.n;
  if (g.active != nullptr && g.active[b] == 0) return;  // the whole block
  const long long plane = (long long)g.n_rows * n;       // instance stride
  const int n_act = g.n_actual != nullptr ? g.n_actual[b] : g.n_act;
  const float* scale_b =
      g.scale != nullptr ? g.scale + (long long)b * g.n_rows : nullptr;
  const float* eta = g.eta + b * plane;
  int* out = g.out + (long long)b * (n - g.t0) * g.m;
  int* q_city = reinterpret_cast<int*>(smem) + warp * kQueue;
  float* q_w =
      reinterpret_cast<float*>(smem) + kWalkWarps * kQueue + warp * kQueue;
  unsigned char* vis = smem + (size_t)kWalkWarps * kQueue * 8;
  const T* tau = static_cast<const T*>(g.tau) + b * plane;
  const int start = g.start[(long long)b * g.m + a];
  const unsigned char* grow =
      g.visited != nullptr ? g.visited + ((long long)b * g.m + a) * n
                           : nullptr;
  for (int j = tid; j < n; j += kWalkBlock)
    vis[j] = (unsigned char)((grow != nullptr && grow[j] != 0) || j == start);
  const uint32_t kc0 = (uint32_t)g.key[2 * b];
  const uint32_t kc1 = (uint32_t)g.key[2 * b + 1];
  __syncthreads();
  int cur = start;
  for (int t = g.t0; t < n; ++t) {
    const int s = t - g.t0;
    int pick;
    if (t >= n_act) {
      pick = t;
    } else {
      if (MODE != aco::kGreedy && s % kWalkBlock == 0) {
        // the keys of steps t .. t + kWalkBlock - 1, one per thread; every
        // thread has read the last ring's keys before the previous step's
        // __syncthreads
        s_key[tid] = aco::fold_in(kc0, kc1, (uint32_t)(t + tid));
        __syncthreads();
      }
      const uint2 k = s_key[s % kWalkBlock];
      // A current city outside [0, n_rows) gathers a zero row, as the
      // one-step kernel does.
      const bool row_ok = cur >= 0 && cur < g.n_rows;
      const long long base = (long long)(row_ok ? cur : 0) * n;
      const long long q0 = base >> 2;
      const int nq = (int)(((base + n - 1) >> 2) - q0 + 1);
      const float srow = scale_b != nullptr ? scale_b[row_ok ? cur : 0] : 1.0f;
      aco::ArgMax best = aco::ArgMax::empty();
      for (int c0 = 0; c0 < nq; c0 += kWalkBlock * kBatch) {
        int queued = 0;
        for (int r = 0; r < kBatch && c0 + r * kWalkBlock < nq; ++r) {
          const int qi = c0 + r * kWalkBlock + tid;
          float tv[4], ev[4];
          if (qi < nq) {
            load4(tau, q0 + qi, srow, tv);
            load4(eta, q0 + qi, 1.0f, ev);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const long long j = 4 * (q0 + qi) + i - base;
            const bool in_row = qi < nq && j >= 0 && j < n;
            bool need = false;
            float w = 0.0f;
            if (in_row) {
              w = row_ok ? aco::choice(tv[i], ev[i], g.alpha, g.beta) : 0.0f;
              const bool keep = vis[j] == 0 && j < n_act;
              need = needs_draw<MODE>(w, keep);
              if (!need) best.take(score_without_draw<MODE>(w, keep), (int)j);
            }
            const unsigned ballot = __ballot_sync(0xFFFFFFFFu, need);
            if (need) {
              const int p = queued + __popc(ballot & ((1u << lane) - 1u));
              q_city[p] = (int)j;
              q_w[p] = w;
            }
            queued += __popc(ballot);
          }
        }
        __syncwarp();
        for (int p = lane; p < queued; p += 32) {
          const int c = q_city[p];
          const float u =
              aco::draw_at(k.x, k.y, a, c, n, g.draw, g.lo, g.span);
          best.take(aco::transform<MODE>(q_w[p], true, u), c);
        }
        __syncwarp();
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_xor_sync(0xFFFFFFFFu, best.val, off);
        const int i = __shfl_xor_sync(0xFFFFFFFFu, best.idx, off);
        best.take(v, i);
      }
      const int par = s & 1;
      if (lane == 0) {
        s_val[par][warp] = best.val;
        s_idx[par][warp] = best.idx;
      }
      __syncthreads();
      aco::ArgMax all = aco::ArgMax::empty();
#pragma unroll
      for (int w = 0; w < kWalkWarps; ++w)
        all.take(s_val[par][w], s_idx[par][w]);
      pick = all.idx == INT_MAX ? 0 : all.idx;
    }
    if (tid == 0) out[(long long)s * g.m + a] = pick;
    // every thread marks the pick itself, so its own next reads see it
    vis[pick] = 1;
    cur = pick;
  }
}

template <typename T, int MODE>
int launch_walk_kernel(const FusedWalkArgs& g, int batch, size_t smem,
                       cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_walk_kernel<T, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_walk_kernel<T, MODE><<<dim3(g.m, batch), kWalkBlock, smem, s>>>(g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_walk(const FusedWalkArgs& g, int batch, int mode, size_t smem,
                cudaStream_t s) {
  switch (mode) {
    case aco::kIRoulette:
      return launch_walk_kernel<T, aco::kIRoulette>(g, batch, smem, s);
    case aco::kGumbel:
      return launch_walk_kernel<T, aco::kGumbel>(g, batch, smem, s);
    case aco::kGreedy:
      return launch_walk_kernel<T, aco::kGreedy>(g, batch, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int walk(const void* tau, int payload, const float* scale, const float* eta,
         int n_rows, const int* start, const unsigned char* visited,
         const long long* key, int* out, int batch, int m, int n, int t0,
         float alpha, float beta, int mode, int draw, float lo, float span,
         int n_actual, const int* n_actual_arr, const unsigned char* active,
         cudaStream_t s) {
  if (m == 0 || batch == 0 || t0 >= n) return 0;
  // every instance's payload and eta start on a 16-byte boundary
  const int item = payload == 0 ? 4 : payload == 1 ? 1 : 2;
  const long long plane = (long long)n_rows * n;
  if (n <= 0 || t0 < 1 || batch < 0 || batch > 65535 ||
      (draw != aco::kPacked && draw != aco::kCounter) ||
      (draw == aco::kCounter && n > 65536) || (payload == 1 && !scale) ||
      (reinterpret_cast<uintptr_t>(tau) | reinterpret_cast<uintptr_t>(eta)) %
          16 != 0 ||
      (batch > 1 && ((plane * item) % 16 != 0 || (plane * 4) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWalkWarps * kQueue * 8 + ((n + 15) & ~15);
  if (smem > kWalkSmemCap) return (int)cudaErrorInvalidValue;
  FusedWalkArgs g{tau,   payload == 1 ? scale : nullptr,
                  eta,   start,
                  visited, key,
                  out,   n_actual_arr,
                  active, m,
                  n,     n_rows,
                  t0,    n_actual,
                  draw,  alpha,
                  beta,  lo,
                  span};
  if (payload == 0) return launch_walk<float>(g, batch, mode, smem, s);
  if (payload == 1) return launch_walk<int8_t>(g, batch, mode, smem, s);
  if (payload == 2)
    return launch_walk<__nv_bfloat16>(g, batch, mode, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// tau, eta: (n_rows, n) row-major; cur: (m,); visited, rand: (m, n).
extern "C" int aco_fused_select(const float* tau, const float* eta,
                                int n_rows, const int* cur,
                                const unsigned char* visited,
                                const float* rand, int* out, int m, int n,
                                float alpha, float beta, int mode,
                                int n_actual, void* stream) {
  if (m == 0) return 0;
  return launch_mode<float>(tau, nullptr, eta, n_rows, cur, visited, rand,
                            out, m, n, alpha, beta, mode, n_actual,
                            static_cast<cudaStream_t>(stream));
}

// The quantised payload: payload 1 = int8 tau with its (n_rows, 1) float32
// scale, 2 = bfloat16 tau (scale unused).
extern "C" int aco_fused_select_quant(const void* tau, int payload,
                                      const float* scale, const float* eta,
                                      int n_rows, const int* cur,
                                      const unsigned char* visited,
                                      const float* rand, int* out, int m,
                                      int n, float alpha, float beta,
                                      int mode, int n_actual, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  if (payload == 1) {
    if (scale == nullptr) return (int)cudaErrorInvalidValue;
    return launch_mode<int8_t>(static_cast<const int8_t*>(tau), scale, eta,
                               n_rows, cur, visited, rand, out, m, n, alpha,
                               beta, mode, n_actual, s);
  }
  if (payload == 2) {
    return launch_mode<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(tau), nullptr, eta, n_rows, cur,
        visited, rand, out, m, n, alpha, beta, mode, n_actual, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The dense walk: every step t = t0 .. n-1 of m ants of `batch` instances
// in one launch.  tau, eta (batch, n_rows, n) float32, every instance's
// plane 16-byte aligned; start (batch, m); visited (batch, m, n) bytes, the
// starting tabu rows, or null (all clear); key the construction keys kc
// (batch, 2) int64; out (batch, n - t0, m).  Steps t >= n_actual emit city
// t, n_actual from n_actual_arr[b] when that is given; active (batch,)
// bytes, or null: an inactive instance is skipped and its out left as it
// was.  draw 0 = packed, 1 = counter.
extern "C" int aco_fused_walk(const float* tau, const float* eta,
                              int n_rows, const int* start,
                              const unsigned char* visited,
                              const long long* key, int* out, int batch,
                              int m, int n, int t0, float alpha, float beta,
                              int mode, int draw, float lo, float span,
                              int n_actual, const int* n_actual_arr,
                              const unsigned char* active, void* stream) {
  return walk(tau, 0, nullptr, eta, n_rows, start, visited, key, out, batch,
              m, n, t0, alpha, beta, mode, draw, lo, span, n_actual,
              n_actual_arr, active, static_cast<cudaStream_t>(stream));
}

// The walk over a quantised payload: payload 1 = int8 tau with its
// (batch, n_rows, 1) float32 scale, 2 = bfloat16 tau (scale unused).
extern "C" int aco_fused_walk_quant(const void* tau, int payload,
                                    const float* scale, const float* eta,
                                    int n_rows, const int* start,
                                    const unsigned char* visited,
                                    const long long* key, int* out,
                                    int batch, int m, int n, int t0,
                                    float alpha, float beta, int mode,
                                    int draw, float lo, float span,
                                    int n_actual, const int* n_actual_arr,
                                    const unsigned char* active,
                                    void* stream) {
  if (payload != 1 && payload != 2) return (int)cudaErrorInvalidValue;
  return walk(tau, payload, scale, eta, n_rows, start, visited, key, out,
              batch, m, n, t0, alpha, beta, mode, draw, lo, span, n_actual,
              n_actual_arr, active, static_cast<cudaStream_t>(stream));
}
