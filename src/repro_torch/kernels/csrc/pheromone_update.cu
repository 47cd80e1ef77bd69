// Fused pheromone update: out = (1 - rho) * tau + sum_e w_e [frm_e = i][to_e = j]
// over a directed-edge stream; endpoints outside [0, n0) x [0, n1) (the -1
// padding) deposit nothing.  tau may be rectangular (n0, n1).
//
// Replaces repro/kernels/pheromone_update.py::pheromone_update
// (_update_kernel).  The Pallas kernel builds one-hot slabs per output tile
// and reduces them on the MXU (scatter-to-gather); on Hopper the paper's own
// winning version is native: evaporate every cell, then one thread per four
// edges (16-byte loads where aligned) does an atomicAdd per edge that lands.
// The deposit grid is the evaporation's programmatic dependent: it loads
// its edges while the evaporation runs and waits for it only to add.
// Bound: bytes -- 8 bytes per cell (read tau, write out) + 12 per edge
// (frm, to, w); at n = m = 1002 (E = 2 m n) about 32 MB, ~9.6 us at 3.35 TB/s.
// What holds it above that on the H100 is the rate of the L2's float
// atomics on scattered cells, about 70 G/s, which index_add_ shares: 2 M
// edges take about 28 us (PERF.md).  Sorting the stream by row tile and
// adding in shared memory instead was slower on the column slabs that the
// city-sharded colony updates (PERF.md).
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
// Tours that are not permutations: construction can emit a city twice
// (an int8 store whose payload is zero over every unvisited city of a
// row), and then a city's (next, previous) pair is not one pair.  Pass 1
// claims each city's entry with an atomicCAS and flags the instance when
// a city comes twice or an id lies outside [0, n); pass 2 then runs the
// exact path for that instance: the warp owning row i scans the edge
// stream, forward edges then reverse ones, ants and positions in order,
// and adds each edge that leaves city i, one after another.  That is the
// CPU index_add_'s order again (bitwise the plain version), at O(m n) per
// row instead of O(m); the flags live past the table in the scratch and
// are cleared by a memset before pass 1.
// The instance axis (the reference's pallas_call under vmap): blockIdx.y of
// both passes is the instance b of a (B, n, n) stack; its tau, tours,
// weights, table and out start b instance strides further on, its n_eff is
// read from a (B,) device array, and a block of an inactive instance
// returns at once and writes nothing (as does one whose n_eff lies outside
// [1, n]).  B = 1 with a host n_eff is the single-instance update: one
// kernel body.
// Bound: bytes -- 8 per cell (tau in, out), 4 per (ant, position), 4 per
// ant; 12.0 MB at n = m = 1002, 3.6 us at 3.35 TB/s.  The two neighbour
// tables (8 m n bytes) are an intermediate and stay mostly in L2.
#include "aco_common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kEdgesPerThread = 4;  // one 16-byte load of each array

// Programmatic dependent launch: the evaporation lets the deposit grid
// start at once, and the deposit grid waits for the evaporation's results
// before it adds to them.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// vec: tau and out are 16-byte aligned.
__global__ void evaporate_kernel(const float* __restrict__ tau,
                                 float* __restrict__ out, long long total,
                                 float decay, bool vec) {
  launch_dependents();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long n4 = vec ? total / 4 : 0;
  for (long long i = i0; i < n4; i += stride) {
    float4 v = __ldcs(reinterpret_cast<const float4*>(tau) + i);
    v.x = __fmul_rn(decay, v.x);
    v.y = __fmul_rn(decay, v.y);
    v.z = __fmul_rn(decay, v.z);
    v.w = __fmul_rn(decay, v.w);
    reinterpret_cast<float4*>(out)[i] = v;
  }
  for (long long i = 4 * n4 + i0; i < total; i += stride) {
    out[i] = __fmul_rn(decay, tau[i]);
  }
}

// Thread k deposits edges [4 k, 4 k + 4).  vec: frm, to and w are 16-byte
// aligned.
__global__ void deposit_kernel(const int* __restrict__ frm,
                               const int* __restrict__ to,
                               const float* __restrict__ w,
                               float* __restrict__ out, long long n_edges,
                               int n0, int n1, bool vec) {
  const long long e0 =
      kEdgesPerThread * (blockIdx.x * (long long)blockDim.x + threadIdx.x);
  int f[kEdgesPerThread], t[kEdgesPerThread];
  float x[kEdgesPerThread];
  if (vec && e0 + kEdgesPerThread <= n_edges) {
    const int4 fv = __ldcs(reinterpret_cast<const int4*>(frm + e0));
    const int4 tv = __ldcs(reinterpret_cast<const int4*>(to + e0));
    const float4 xv = __ldcs(reinterpret_cast<const float4*>(w + e0));
    f[0] = fv.x; f[1] = fv.y; f[2] = fv.z; f[3] = fv.w;
    t[0] = tv.x; t[1] = tv.y; t[2] = tv.z; t[3] = tv.w;
    x[0] = xv.x; x[1] = xv.y; x[2] = xv.z; x[3] = xv.w;
  } else {
#pragma unroll
    for (int k = 0; k < kEdgesPerThread; ++k) {
      const bool in = e0 + k < n_edges;
      f[k] = in ? __ldcs(frm + e0 + k) : -1;
      t[k] = in ? __ldcs(to + e0 + k) : -1;
      x[k] = in ? __ldcs(w + e0 + k) : 0.0f;
    }
  }
  wait_for_primary();
#pragma unroll
  for (int k = 0; k < kEdgesPerThread; ++k) {
    if (f[k] >= 0 && f[k] < n0 && t[k] >= 0 && t[k] < n1) {
      atomicAdd(out + (long long)f[k] * n1 + t[k], x[k]);
    }
  }
}


constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 8;
constexpr int kDepth = 8;          // 32-ant chunks loaded ahead per warp
constexpr int kAnts = 8;           // tours inverted per block in pass 1
constexpr int kBlock1 = 1024;      // pass 1's threads per block
constexpr int kSmemCap = 232448;   // bytes of shared memory a block may use
constexpr int kAbsent = INT_MIN;   // pass 1: a city not met yet in a tour

// Pass 1: one block inverts the tours of `na` ants in shared memory, then
// writes nbr[c][a] = (next, previous) tour neighbour of city c in tour a,
// the ants of one city side by side (64 contiguous bytes per city).  A
// tour that is not a permutation sets bad[b].
__global__ void tour_neighbours_kernel(const int* __restrict__ tours,
                                       int2* __restrict__ nbr, int m, int n,
                                       int n_eff,
                                       const int* __restrict__ n_eff_arr,
                                       const unsigned char* __restrict__ act,
                                       int ants, int* __restrict__ bad) {
  extern __shared__ int2 s_nb[];  // [ants][n]
  __shared__ int s_bad;
  const int b = blockIdx.y;
  if (act != nullptr && act[b] == 0) return;
  if (n_eff_arr != nullptr) n_eff = n_eff_arr[b];
  if (n_eff < 1 || n_eff > n) return;  // no such instance: nothing written
  tours += (long long)b * m * n;
  nbr += (long long)b * n * m;
  const int a0 = blockIdx.x * ants;
  const int na = min(ants, m - a0);
  const int total = na * n;
  if (threadIdx.x == 0) s_bad = 0;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    s_nb[e] = make_int2(kAbsent, kAbsent);
  }
  __syncthreads();
#pragma unroll 4
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int ai = e / n, p = e - ai * n;
    const int* tour = tours + (long long)(a0 + ai) * n;
    const int c = tour[p];
    if (c < 0 || c >= n) {
      s_bad = 1;
      continue;
    }
    int2 nb = make_int2(-1, -1);
    if (p < n_eff) {
      nb.x = tour[p == n_eff - 1 ? 0 : p + 1];
      nb.y = tour[p == 0 ? n_eff - 1 : p - 1];
    }
    // the first position to claim city c keeps its pair; a second one
    // means the tour is not a permutation
    int* slot = reinterpret_cast<int*>(s_nb + ai * n + c);
    if (atomicCAS(slot, kAbsent, nb.x) != kAbsent) {
      s_bad = 1;
      continue;
    }
    slot[1] = nb.y;
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_bad != 0) bad[b] = 1;
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

// The exact path of a row whose instance has a tour that is not a
// permutation: every edge of the stream that leaves city i, forward edges
// (tour[p] -> tour[p + 1], the closing one at n_eff - 1 back to position
// 0) then reverse ones, ants and positions in order, added one after
// another by lane 0; edges of positions >= n_eff weigh 0 and are skipped,
// and an edge to an id outside [0, n) deposits nothing (the plain
// version's mask).
__device__ void stream_row(float* row, const int* __restrict__ tours,
                           const float* ws, int i, int n, int m, int n_eff,
                           int lane) {
  for (int dir = 0; dir < 2; ++dir) {
    for (int a = 0; a < m; ++a) {
      const int* tour = tours + (long long)a * n;
      const float wa = ws[a];
      for (int p0 = 0; p0 < n_eff; p0 += 32) {
        const int p = p0 + lane;
        int src = -1, dst = -1;
        if (p < n_eff) {
          const int c = tour[p];
          const int d = tour[p == n_eff - 1 ? 0 : p + 1];
          src = dir == 0 ? c : d;
          dst = dir == 0 ? d : c;
        }
        unsigned hit = __ballot_sync(kFull, src == i && dst >= 0 && dst < n);
        while (hit != 0u) {  // uniform across the warp
          const int j = __shfl_sync(kFull, dst, __ffs(hit) - 1);
          if (lane == 0) row[j] = __fadd_rn(row[j], wa);
          hit &= hit - 1u;
        }
      }
    }
  }
  __syncwarp();
}

// Pass 2: one warp per row; shared memory holds the ants' weights (block)
// and, per warp, the row, the row's previous-neighbour ids and the tags.
__global__ void row_update_kernel(const float* __restrict__ tau,
                                  const int2* __restrict__ nbr,
                                  const int* __restrict__ tours,
                                  const float* __restrict__ w,
                                  float* __restrict__ out, int n, int m,
                                  float decay, int n_eff,
                                  const int* __restrict__ n_eff_arr,
                                  const unsigned char* __restrict__ active,
                                  const int* __restrict__ bad) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  if (active != nullptr && active[b] == 0) return;
  if (n_eff_arr != nullptr) n_eff = n_eff_arr[b];
  if (n_eff < 1 || n_eff > n) return;
  const bool exact = bad[b] != 0;
  tau += (long long)b * n * n;
  out += (long long)b * n * n;
  nbr += (long long)b * n * m;
  tours += (long long)b * m * n;
  w += (long long)b * m;
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
    if (exact) {
      stream_row(row, tours, ws, i, n, m, n_eff, lane);
      for (int j = lane; j < n; j += 32) out[r + j] = row[j];
      __syncwarp();
      continue;
    }
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
  if (total <= 0) return 0;
  const bool vec_tau = ((reinterpret_cast<uintptr_t>(tau) |
                         reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  evaporate_kernel<<<aco::grid_for(vec_tau ? total / 4 + 1 : total, kBlock),
                     kBlock, 0, s>>>(tau, out, total, decay, vec_tau);
  if (n_edges <= 0) return (int)cudaGetLastError();
  const bool vec_edges = ((reinterpret_cast<uintptr_t>(frm) |
                           reinterpret_cast<uintptr_t>(to) |
                           reinterpret_cast<uintptr_t>(w)) & 15u) == 0;
  const long long threads = (n_edges + kEdgesPerThread - 1) / kEdgesPerThread;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((threads + kBlock - 1) / kBlock));
  cfg.blockDim = dim3(kBlock);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, deposit_kernel, frm, to, w,
                                           out, n_edges, n0, n1, vec_edges);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// tau, out: (batch, n, n); tours: (batch, m, n); w: (batch, m); nbr:
// scratch of 2 batch m n + batch ints (the table, then the instances' flags
// of a tour that is not a permutation).  n_eff = n_actual (the closing edge leaves
// position n_eff - 1; positions >= n_eff deposit nothing), n for an
// unpadded instance; n_eff_arr (batch,), when given, holds each instance's.
// active (batch,) bytes, or null: an inactive instance's out is left as it
// was.
extern "C" int aco_pheromone_update_tours(const float* tau, const int* tours,
                                          const float* w, int* nbr,
                                          float* out, int batch, int n, int m,
                                          int n_eff, const int* n_eff_arr,
                                          const unsigned char* active,
                                          float decay, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || batch == 0) return 0;
  if (batch < 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  if (n_eff_arr == nullptr && (n_eff < 1 || n_eff > n))
    return (int)cudaErrorInvalidValue;
  int warps = kRowWarps;
  auto bytes = [&](int wp) { return 4LL * (m + (long long)wp * (2 * n + m)); };
  while (warps > 1 && bytes(warps) > kSmemCap) --warps;
  const long long smem = bytes(warps);
  int ants = kAnts;
  while (ants > 1 && 8LL * ants * n > kSmemCap) --ants;
  const long long smem1 = 8LL * ants * n;
  if (smem > kSmemCap || smem1 > kSmemCap) return (int)cudaErrorInvalidValue;
  int2* nb = reinterpret_cast<int2*>(nbr);
  int* bad = nbr + 2LL * batch * n * m;
  const cudaError_t cleared = cudaMemsetAsync(bad, 0, sizeof(int) * batch, s);
  if (cleared != cudaSuccess) return (int)cleared;
  if (m > 0) {
    if (smem1 > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          tour_neighbours_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
      if (e != cudaSuccess) return (int)e;
    }
    tour_neighbours_kernel<<<dim3((m + ants - 1) / ants, batch), kBlock1,
                             (size_t)smem1, s>>>(tours, nb, m, n, n_eff,
                                                 n_eff_arr, active, ants,
                                                 bad);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (n + warps - 1) / warps;
  row_update_kernel<<<dim3(grid, batch), warps * 32, (size_t)smem, s>>>(
      tau, nb, tours, w, out, n, m, decay, n_eff, n_eff_arr, active, bad);
  return (int)cudaGetLastError();
}
