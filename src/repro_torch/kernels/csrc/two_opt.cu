// Per-ant 2-opt move reduction over the flattened (m, M) move operands:
// delta = ((add1 + add2) - rem1) - rem2, a masked move reads as 1e30.
//   best:  least delta, lowest index among equal values (NaN counts as
//          least, as torch.argmin and jnp.argmin take it);
//   first: lowest index with delta < -thr and its delta, or
//          (1e30, INT_MAX) when no move improves.
//
// Replaces repro/kernels/two_opt.py::two_opt_best (_delta_kernel,
// pallas_call at two_opt.py:119).  The Pallas kernel walks (8 x 512) tiles
// and carries a running (value, index) across the tile axis in its output
// block; blocks here run in no order, so each ant is one block that owns
// all M of its moves.
// Bound: bytes -- 4 x 4 (operands) + 1 (valid) bytes per move, ~512 MB at
// m = n = 1002, k = 30 (M = 30060), ~153 us at 3.35 TB/s.
// Design: threads stride over the ant's moves (coalesced reads) keeping a
// running pair in registers; a masked move skips its four operand loads;
// in first mode a thread stops at its first improving move (its later
// moves have larger indices).  One warp-shuffle + shared-memory block
// reduction per ant.  Every float operation is written with an explicit
// rounding intrinsic, in the reference's order.
#include "aco_common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr float kSentinel = 1e30f;
enum : int { kBest = 0, kFirst = 1 };

struct Pair {
  float val;
  int idx;  // INT_MAX = empty
};

// best: least value, then lowest index; NaN is least.
struct LeastFirst {
  __device__ __forceinline__ static bool beats(Pair a, Pair b) {
    if (a.idx == INT_MAX) return false;
    if (b.idx == INT_MAX) return true;
    const bool an = isnan(a.val), bn = isnan(b.val);
    if (an != bn) return an;
    if (!an && a.val != b.val) return a.val < b.val;
    return a.idx < b.idx;
  }
};

// first: lowest index (the value rides along).
struct LowestIndex {
  __device__ __forceinline__ static bool beats(Pair a, Pair b) {
    return a.idx < b.idx;
  }
};

template <class Rule>
__device__ __forceinline__ Pair warp_reduce(Pair p) {
  for (int off = 16; off > 0; off >>= 1) {
    const Pair o{__shfl_down_sync(0xffffffffu, p.val, off),
                 __shfl_down_sync(0xffffffffu, p.idx, off)};
    if (Rule::beats(o, p)) p = o;
  }
  return p;
}

// Block-wide reduction; the result is valid in thread 0.
template <int BLOCK, class Rule>
__device__ __forceinline__ Pair block_reduce(Pair p) {
  static_assert(BLOCK % 32 == 0 && BLOCK <= 1024, "block size");
  __shared__ float s_val[BLOCK / 32];
  __shared__ int s_idx[BLOCK / 32];
  p = warp_reduce<Rule>(p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { s_val[warp] = p.val; s_idx[warp] = p.idx; }
  __syncthreads();
  if (warp == 0) {
    p = lane < BLOCK / 32 ? Pair{s_val[lane], s_idx[lane]}
                          : Pair{kSentinel, INT_MAX};
    p = warp_reduce<Rule>(p);
  }
  return p;
}

template <int MODE>
__global__ void two_opt_kernel(const float* __restrict__ add1,
                               const float* __restrict__ add2,
                               const float* __restrict__ rem1,
                               const float* __restrict__ rem2,
                               const unsigned char* __restrict__ valid,
                               int M, float neg_thr,
                               float* __restrict__ out_val,
                               int* __restrict__ out_idx) {
  const long long base = (long long)blockIdx.x * M;
  Pair p{kSentinel, INT_MAX};
  for (int j = threadIdx.x; j < M; j += kBlock) {
    const long long e = base + j;
    const bool ok = valid[e] != 0;
    if (MODE == kBest) {
      float v = kSentinel;
      if (ok) {
        v = __fsub_rn(__fsub_rn(__fadd_rn(add1[e], add2[e]), rem1[e]),
                      rem2[e]);
      }
      const Pair c{v, j};
      if (LeastFirst::beats(c, p)) p = c;
    } else if (ok) {
      const float d = __fsub_rn(
          __fsub_rn(__fadd_rn(add1[e], add2[e]), rem1[e]), rem2[e]);
      if (d < neg_thr) {
        p = Pair{d, j};
        break;
      }
    }
  }
  if (MODE == kBest) {
    p = block_reduce<kBlock, LeastFirst>(p);
  } else {
    p = block_reduce<kBlock, LowestIndex>(p);
  }
  if (threadIdx.x == 0) {
    const bool none = p.idx == INT_MAX;
    out_val[blockIdx.x] = none ? kSentinel : p.val;
    out_idx[blockIdx.x] = (none && MODE == kBest) ? 0 : p.idx;
  }
}

}  // namespace

// add1, add2, rem1, rem2: (m, M) float32; valid: (m, M) bytes; neg_thr is
// float32(-thr); mode 0 = best, 1 = first.  Outputs val (m,), idx (m,).
extern "C" int aco_two_opt_best(const float* add1, const float* add2,
                                const float* rem1, const float* rem2,
                                const unsigned char* valid, int m, int M,
                                float neg_thr, int mode, float* val,
                                int* idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  switch (mode) {
    case kBest:
      two_opt_kernel<kBest><<<m, kBlock, 0, s>>>(add1, add2, rem1, rem2,
                                                 valid, M, neg_thr, val, idx);
      break;
    case kFirst:
      two_opt_kernel<kFirst><<<m, kBlock, 0, s>>>(add1, add2, rem1, rem2,
                                                  valid, M, neg_thr, val, idx);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
