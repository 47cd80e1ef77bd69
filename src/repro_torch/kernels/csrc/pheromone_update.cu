// Fused pheromone update: out = (1 - rho) * tau + sum_e w_e [frm_e = i][to_e = j]
// over a directed-edge stream; endpoints outside [0, n0) x [0, n1) (the -1
// padding) deposit nothing.  tau may be rectangular (n0, n1).
//
// Replaces repro/kernels/pheromone_update.py::pheromone_update
// (_update_kernel).  The Pallas kernel builds one-hot slabs per output tile
// and reduces them on the MXU (scatter-to-gather); on Hopper the paper's own
// winning version is native: evaporate every cell, then one thread per edge
// does an atomicAdd.
// Bound: bytes -- 8 bytes per cell (read tau, write out) + 12 per edge
// (frm, to, w); at n = m = 1002 (E = 2 m n) about 32 MB, ~9.6 us at 3.35 TB/s.
// Numerics: the evaporation product is rounded on its own (__fmul_rn, no
// FMA with the deposit), as the Pallas kernel and the plain version do.  A
// cell that gets at most one deposit (MMAS, the ACS deposit, AS with one
// ant) is therefore bitwise the plain version.  A cell with several
// deposits (AS with m ants) sums them in atomic order: ulp-close, and not
// reproducible from run to run.
//
// aco_pheromone_update_tours: the same update driven by the deposit tours,
// for the colony step (kernels/pheromone_update.py::pheromone_update_tours).
// The edge stream of core.pheromone.tour_edges / edge_weights is never built:
// the paper's scatter-to-gather (section IV.B) with inverse positions.
//   pass 1  writes, for every city c and ant a, c's (next, previous) tour
//           neighbour into entry (c, a) of an (n, m) table of int pairs (-1
//           for a position >= n_actual, whose deposits weigh 0 and are
//           skipped: +0.0 leaves a non-negative cell as it is).  A block
//           inverts 8 tours in shared memory and writes the 8 ants' entries
//           of a city side by side, so the table is written in whole
//           sectors rather than scattered 8-byte stores.
//   pass 2  one warp owns one row i of tau in shared memory (4 n bytes),
//           initialised to __fmul_rn(decay, tau), and applies the row's
//           deposits in the edge stream's index order: the forward ones
//           (row i -> next) of ants 0..m-1, then the reverse ones (row i ->
//           previous) of ants 0..m-1.  Lanes of a 32-ant chunk that hit the
//           same cell add in lane order: every lane bids for its cell with
//           a shared-memory atomicMin on a per-column tag and the lowest
//           bidder adds its weight (one __fadd_rn), which finishes a chunk
//           with no shared cell; each lane left over then adds, in lane
//           order, the weights of the leftover lanes on its cell (read by
//           shuffles), and the lowest of them writes the sum.  So a
//           cell is ((e + d1) + d2) + ..., the order of the CPU index_add_,
//           and no sum goes through an atomic: bitwise the plain version,
//           run after run.  The finished row is written out once,
//           coalesced.  Latency is what a warp waits on, so the ants'
//           weights sit in shared memory (one copy per block), the
//           neighbour pairs are loaded 8 chunks ahead, and the
//           previous-neighbour ids wait in shared memory for the reverse
//           pass.
// Precondition: every row of tours is a permutation of 0..n-1 (what tour
// construction emits); out-of-range ids are skipped, never written.
// Bound: bytes -- 8 per cell (tau in, out), 4 per (ant, position), 4 per
// ant; 12.0 MB at n = m = 1002, 3.6 us at 3.35 TB/s.  The two neighbour
// tables (8 m n bytes) are an intermediate and stay mostly in L2.
#include "aco_common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void evaporate_kernel(const float* __restrict__ tau,
                                 float* __restrict__ out, long long total,
                                 float decay) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    out[i] = __fmul_rn(decay, tau[i]);
  }
}

__global__ void deposit_kernel(const int* __restrict__ frm,
                               const int* __restrict__ to,
                               const float* __restrict__ w,
                               float* __restrict__ out, long long n_edges,
                               int n0, int n1) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < n_edges; e += (long long)gridDim.x * blockDim.x) {
    const int f = frm[e], t = to[e];
    if (f >= 0 && f < n0 && t >= 0 && t < n1) {
      atomicAdd(out + (long long)f * n1 + t, w[e]);
    }
  }
}


constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 8;
constexpr int kDepth = 8;          // 32-ant chunks loaded ahead per warp
constexpr int kAnts = 8;           // tours inverted per block in pass 1
constexpr int kBlock1 = 1024;      // pass 1's threads per block
constexpr int kSmemCap = 232448;   // bytes of shared memory a block may use

// Pass 1: one block inverts the tours of `na` ants in shared memory, then
// writes nbr[c][a] = (next, previous) tour neighbour of city c in tour a,
// the ants of one city side by side (64 contiguous bytes per city).
__global__ void tour_neighbours_kernel(const int* __restrict__ tours,
                                       int2* __restrict__ nbr, int m, int n,
                                       int n_eff, int ants) {
  extern __shared__ int2 s_nb[];  // [ants][n]
  const int a0 = blockIdx.x * ants;
  const int na = min(ants, m - a0);
  const int total = na * n;
#pragma unroll 4
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int ai = e / n, p = e - ai * n;
    const int* tour = tours + (long long)(a0 + ai) * n;
    const int c = tour[p];
    if (c < 0 || c >= n) continue;
    int2 nb = make_int2(-1, -1);
    if (p < n_eff) {
      nb.x = tour[p == n_eff - 1 ? 0 : p + 1];
      nb.y = tour[p == 0 ? n_eff - 1 : p - 1];
    }
    s_nb[ai * n + c] = nb;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * ants; e += blockDim.x) {
    const int c = e / ants, ai = e - c * ants;
    if (ai < na) nbr[(long long)c * m + a0 + ai] = s_nb[ai * n + c];
  }
}

// Lane k's deposit (cell jk, weight wk) as seen by a lane on cell jj: add
// it when the cells agree, and note whether a lower lane shares the cell.
__device__ __forceinline__ void take_lane(int k, int jj, int lane, int jk,
                                          float wk, float& v, bool& first) {
  const bool same = jj >= 0 && jk == jj;
  v = same ? __fadd_rn(v, wk) : v;
  first = first && !(same && k < lane);
}

// Add the deposit of each lane's ant (cell j, weight ws[base + lane]) to the
// shared-memory row; lanes on the same cell add in lane (= ant) order.
// First every lane bids for its cell's tag with atomicMin and the lowest
// bidder adds: a chunk with no shared cell is done.  The lanes left over
// share a cell with a lower lane; each of them adds, in lane order, the
// weights of the leftover lanes on its cell, and the lowest of them writes
// the sum.  tag[] is INT_MAX between calls.
__device__ __forceinline__ void add_chunk(float* row, int* tag,
                                          const float* ws, int base, int j,
                                          int n, int lane) {
  bool pending = j >= 0 && j < n;
  const float wa = pending ? ws[base + lane] : 0.0f;
  if (pending) atomicMin(tag + j, lane);
  __syncwarp();
  const bool win = pending && tag[j] == lane;
  __syncwarp();
  if (win) {
    row[j] = __fadd_rn(row[j], wa);
    tag[j] = INT_MAX;
    pending = false;
  }
  __syncwarp();
  const unsigned left = __ballot_sync(kFull, pending);
  if (left == 0u) return;
  const int jj = pending ? j : -1;
  float v = pending ? row[j] : 0.0f;
  bool first = pending;
  if (__popc(left) <= 8) {
    for (unsigned g = left; g != 0u; g &= g - 1u) {
      const int k = __ffs(g) - 1;
      take_lane(k, jj, lane, __shfl_sync(kFull, jj, k),
                __shfl_sync(kFull, wa, k), v, first);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      take_lane(k, jj, lane, __shfl_sync(kFull, jj, k),
                __shfl_sync(kFull, wa, k), v, first);
    }
  }
  if (first) row[j] = v;
  __syncwarp();
}

// Pass 2: one warp per row; shared memory holds the ants' weights (block)
// and, per warp, the row, the row's previous-neighbour ids and the tags.
__global__ void row_update_kernel(const float* __restrict__ tau,
                                  const int2* __restrict__ nbr,
                                  const float* __restrict__ w,
                                  float* __restrict__ out, int n, int m,
                                  float decay) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ws = smem;
  float* row = smem + m + (long long)warp * (2 * n + m);
  int* prv = reinterpret_cast<int*>(row + n);
  int* tag = prv + m;
  for (int a = threadIdx.x; a < m; a += blockDim.x) ws[a] = w[a];
  for (int j = lane; j < n; j += 32) tag[j] = INT_MAX;
  __syncthreads();
  for (int i = blockIdx.x * warps + warp; i < n; i += gridDim.x * warps) {
    const long long r = (long long)i * n;
    for (int j = lane; j < n; j += 32) row[j] = __fmul_rn(decay, tau[r + j]);
    __syncwarp();
    // forward deposits, ants in order; the previous-neighbour ids are kept
    // for the reverse pass
    const int2* nb = nbr + (long long)i * m;
    for (int base = 0; base < m; base += 32 * kDepth) {
      int2 v[kDepth];
#pragma unroll
      for (int c = 0; c < kDepth; ++c) {
        const int a = base + c * 32 + lane;
        v[c] = a < m ? nb[a] : make_int2(-1, -1);
      }
#pragma unroll
      for (int c = 0; c < kDepth; ++c) {
        const int a0 = base + c * 32;
        if (a0 >= m) break;  // uniform across the warp
        if (a0 + lane < m) prv[a0 + lane] = v[c].y;
        add_chunk(row, tag, ws, a0, v[c].x, n, lane);
      }
    }
    // reverse deposits, ants in order
    for (int a0 = 0; a0 < m; a0 += 32) {
      add_chunk(row, tag, ws, a0, a0 + lane < m ? prv[a0 + lane] : -1, n,
                lane);
    }
    for (int j = lane; j < n; j += 32) out[r + j] = row[j];
    __syncwarp();
  }
}

}  // namespace

// decay = float32(1 - rho), rounded by the caller as JAX rounds it.
extern "C" int aco_pheromone_update(const float* tau, const int* frm,
                                    const int* to, const float* w, float* out,
                                    int n0, int n1, long long n_edges,
                                    float decay, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n0 * n1;
  if (total > 0) {
    evaporate_kernel<<<aco::grid_for(total, kBlock), kBlock, 0, s>>>(
        tau, out, total, decay);
  }
  if (n_edges > 0 && total > 0) {
    deposit_kernel<<<aco::grid_for(n_edges, kBlock), kBlock, 0, s>>>(
        frm, to, w, out, n_edges, n0, n1);
  }
  return (int)cudaGetLastError();
}

// tau, out: (n, n); tours: (m, n); w: (m,); nbr: scratch of 2 m n ints.
// n_eff = n_actual (the closing edge leaves position n_eff - 1; positions
// >= n_eff deposit nothing), n for an unpadded instance.
extern "C" int aco_pheromone_update_tours(const float* tau, const int* tours,
                                          const float* w, int* nbr,
                                          float* out, int n, int m, int n_eff,
                                          float decay, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (n_eff < 1 || n_eff > n) return (int)cudaErrorInvalidValue;
  int warps = kRowWarps;
  auto bytes = [&](int wp) { return 4LL * (m + (long long)wp * (2 * n + m)); };
  while (warps > 1 && bytes(warps) > kSmemCap) --warps;
  const long long smem = bytes(warps);
  int ants = kAnts;
  while (ants > 1 && 8LL * ants * n > kSmemCap) --ants;
  const long long smem1 = 8LL * ants * n;
  if (smem > kSmemCap || smem1 > kSmemCap) return (int)cudaErrorInvalidValue;
  int2* nb = reinterpret_cast<int2*>(nbr);
  if (m > 0) {
    if (smem1 > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          tour_neighbours_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
      if (e != cudaSuccess) return (int)e;
    }
    tour_neighbours_kernel<<<(m + ants - 1) / ants, kBlock1, (size_t)smem1,
                             s>>>(tours, nb, m, n, n_eff, ants);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (n + warps - 1) / warps;
  row_update_kernel<<<grid, warps * 32, (size_t)smem, s>>>(
      tau, nb, w, out, n, m, decay);
  return (int)cudaGetLastError();
}
