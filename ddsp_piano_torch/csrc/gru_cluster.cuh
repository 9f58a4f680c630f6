// What the GRU forward (gru_scan.cu) and backward (gru_scan_bwd.cu)
// cluster kernels share: the (unit, slice) thread layout and its product,
// the reduce-scatter over a unit's eight lanes, the cluster barrier, and
// the launch plan.
//
// Thread (unit j, slice s), s in [0, 8), holds the z, r and h columns of U
// for unit j over its k slice: float4 chunks s, s + 8, s + 16, ... of k, in
// registers for the whole launch. A step's product h U then takes each lane
// KC chunks x rows x 12 FMAs, and reduce_rows leaves row s's sums in lane
// s, which computes row s's gates.
//
// The bf16 instances (the opt-in bf16 control networks) are the kernels'
// template instances with BF16 = true: load_columns<KC, true> rounds the
// lane's columns of U to bfloat16 as it loads them, and
// product<KC, RM, true> rounds each h it reads; the sums stay float32
// (products of two bf16 values are exact in float32). The float32
// instances compile as they did before the bf16 ones existed.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define GRU_SLICES 8          // lanes splitting one unit's k range
#define GRU_MAX_ROWS 8        // lane s of a unit computes row s's gates
#define GRU_MAX_CLUSTER 8     // the portable cluster size
#define GRU_MAX_CHUNKS 8      // float4 chunks of k per lane: u <= 256
#define GRU_UNITS_PER_CTA 32  // the default plan's most units per CTA
#define GRU_MIN_UNITS 16      // and the fewest it spreads them to
#define GRU_SMEM_LIMIT 232448 // shared bytes a CTA can have on sm_90

// x rounded to the nearest bfloat16 (ties to even), as float.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 round_bf16(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                     round_bf16(v.w));
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Ask L2 for the CTA's share of n contiguous floats, one 128-byte line a
// thread.
__device__ __forceinline__ void prefetch_span(const float* p, int n, int rank,
                                              int n_cta) {
  for (int i = (rank * blockDim.x + threadIdx.x) * 32; i < n;
       i += n_cta * blockDim.x * 32) {
    asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p + i));
  }
}

// Lane s of each group of eight receives the sum over the group of v[s]:
// recursive halving, 4 + 2 + 1 shuffles.
__device__ __forceinline__ float reduce_rows(const float v[GRU_MAX_ROWS],
                                             int s) {
  const bool b4 = s & 4, b2 = s & 2, b1 = s & 1;
  float w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = b4 ? v[k] : v[4 + k];
    const float keep = b4 ? v[4 + k] : v[k];
    w[k] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  float x[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = b2 ? w[k] : w[2 + k];
    const float keep = b2 ? w[2 + k] : w[k];
    x[k] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  }
  const float send = b1 ? x[0] : x[1];
  const float keep = b1 ? x[1] : x[0];
  return keep + __shfl_xor_sync(0xffffffffu, send, 1);
}

// U[k0 .. k0+3, col] of a row-major (u, 3u) U.
__device__ __forceinline__ float4 column4(const float* __restrict__ U, int k0,
                                          int col, int ld) {
  return make_float4(U[(size_t)k0 * ld + col], U[(size_t)(k0 + 1) * ld + col],
                     U[(size_t)(k0 + 2) * ld + col],
                     U[(size_t)(k0 + 3) * ld + col]);
}

// The lane's slice of unit j's z, r and h columns (zeros for a lane of no
// unit or past the last chunk), rounded to bfloat16 if BF16.
template <int KC, bool BF16 = false>
__device__ __forceinline__ void load_columns(const float* __restrict__ U,
                                             int u, int j, int s, bool unit_ok,
                                             float4 (&wz)[KC],
                                             float4 (&wr)[KC],
                                             float4 (&wh)[KC]) {
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int q = 0; q < KC; ++q) {
    const int c = s + GRU_SLICES * q;
    const bool ok = unit_ok && c < u / 4;
    wz[q] = ok ? column4(U, 4 * c, j, 3 * u) : zero4;
    wr[q] = ok ? column4(U, 4 * c, u + j, 3 * u) : zero4;
    wh[q] = ok ? column4(U, 4 * c, 2 * u + j, 3 * u) : zero4;
    if (BF16) {
      wz[q] = round_bf16(wz[q]);
      wr[q] = round_bf16(wr[q]);
      wh[q] = round_bf16(wh[q]);
    }
  }
}

// rec = h U over the lane's k slice for RM rows of h in shared memory
// (row stride `stride`), reduced so that lane s holds row s's three
// pre-activations (without the bias). Rows past the cluster's last
// (nrows) repeat it and their sums go unused, so every load is
// unconditional and the compiler can issue them ahead. ROUND_H: each h
// rounded to bfloat16 as it is read.
template <int KC, int RM, bool ROUND_H = false>
__device__ __forceinline__ void product(const float* h, int stride, int u,
                                        int nrows, int s,
                                        const float4 (&wz)[KC],
                                        const float4 (&wr)[KC],
                                        const float4 (&wh)[KC], float* rz,
                                        float* rr, float* rh) {
  float az[GRU_MAX_ROWS], ar[GRU_MAX_ROWS], ah[GRU_MAX_ROWS];
#pragma unroll
  for (int r = 0; r < GRU_MAX_ROWS; ++r) {
    az[r] = 0.0f;
    ar[r] = 0.0f;
    ah[r] = 0.0f;
  }
#pragma unroll
  for (int q = 0; q < KC; ++q) {
    // A lane past the last chunk reads chunk 0 against zero weights.
    const int c = s + GRU_SLICES * q < u / 4 ? s + GRU_SLICES * q : 0;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      float4 hv = *reinterpret_cast<const float4*>(
          h + min(r, nrows - 1) * stride + 4 * c);
      if (ROUND_H) hv = round_bf16(hv);
      az[r] = fmaf(hv.x, wz[q].x, az[r]);
      az[r] = fmaf(hv.y, wz[q].y, az[r]);
      az[r] = fmaf(hv.z, wz[q].z, az[r]);
      az[r] = fmaf(hv.w, wz[q].w, az[r]);
      ar[r] = fmaf(hv.x, wr[q].x, ar[r]);
      ar[r] = fmaf(hv.y, wr[q].y, ar[r]);
      ar[r] = fmaf(hv.z, wr[q].z, ar[r]);
      ar[r] = fmaf(hv.w, wr[q].w, ar[r]);
      ah[r] = fmaf(hv.x, wh[q].x, ah[r]);
      ah[r] = fmaf(hv.y, wh[q].y, ah[r]);
      ah[r] = fmaf(hv.z, wh[q].z, ah[r]);
      ah[r] = fmaf(hv.w, wh[q].w, ah[r]);
    }
  }
  *rz = reduce_rows(az, s);
  *rr = reduce_rows(ar, s);
  *rh = reduce_rows(ah, s);
}

// The compiled row count (1, 2, 4 or 8) that covers `rows`.
static inline int rows_index(int rows) {
  return rows <= 1 ? 0 : rows <= 2 ? 1 : rows <= 4 ? 2 : 3;
}

// A launch's shape for a cluster of n CTAs, `rows` rows and a kernel
// whose shared memory is smem_of(u, units per CTA, rows): float4 chunks
// per lane, units per CTA, threads and shared bytes; false if no kernel
// takes it.
typedef int (*SmemOf)(int u, int m, int rows);

static inline bool launch_shape(int B, int u, int n, int rows, SmemOf smem_of,
                                int* kc, int* m, int* threads, int* smem) {
  if (B < 1 || u < 4 || u % 4 != 0 || n < 1 || n > GRU_MAX_CLUSTER
      || rows < 1 || rows > GRU_MAX_ROWS) {
    return false;
  }
  *kc = (u / 4 + GRU_SLICES - 1) / GRU_SLICES;
  if (*kc > GRU_MAX_CHUNKS) return false;
  *m = (u + n - 1) / n;
  *threads = ((*m * GRU_SLICES + 31) / 32) * 32;
  *smem = smem_of(u, *m, rows);
  // The kernels' __launch_bounds__: 512 threads up to 2 chunks a lane, 256
  // above, so that the weights fit the registers a thread may have.
  return *threads <= (*kc <= 2 ? 512 : 256) && *smem <= GRU_SMEM_LIMIT;
}

static inline cudaLaunchConfig_t launch_config(int n, int clusters,
                                               int threads, int smem,
                                               cudaStream_t stream,
                                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * clusters);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

static inline cudaError_t active_clusters(const void* fn, int n, int threads,
                                          int smem, int* active) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(n, 1, threads, smem, 0, &attr);
  return cudaOccupancyMaxActiveClusters(active, fn, &cfg);
}

// Clusters of n CTAs that the card runs at once with an SM to each CTA:
// the occupancy of a launch asking for more shared memory than two CTAs
// can share. Clusters are placed within GPCs, so this is below 132 / n.
static inline cudaError_t exclusive_clusters(const void* fn, int n,
                                             int threads, int smem,
                                             int* clusters) {
  const int alone = GRU_SMEM_LIMIT / 2 + 1024;
  return active_clusters(fn, n, threads, smem > alone ? smem : alone,
                         clusters);
}

// The launch plan for B rows of width u, for the kernels kernels[rows
// index][chunks - 1] (the float32 instances; their bf16 instances take the
// same plan). The cluster: the smallest power of two that leaves at
// most GRU_UNITS_PER_CTA units to a CTA, doubled while the doubled cluster
// leaves at least GRU_MIN_UNITS units to a CTA and still gives every row a
// cluster of its own SMs (fewer units a CTA, a shorter step; below 16 units
// the exchange with more peers costs more than the product saves, as
// measured at u = 64). Rows per cluster: the fewest that let every cluster
// have SMs of its own; more clusters than that share SMs or wait for a
// second wave. Fills plan[0..7] with the cluster size N, rows per cluster,
// clusters, threads per CTA, shared bytes per CTA, the clusters the card
// keeps resident at once (cudaOccupancyMaxActiveClusters), those among them
// with an SM to each CTA, and units per CTA; returns 0 or a CUDA error code
// (cudaErrorInvalidValue for a shape no plan takes).
static inline int gru_plan(int B, int u, SmemOf smem_of,
                           const void* const (*kernels)[GRU_MAX_CHUNKS],
                           int* plan) {
  int kc, m, threads, smem, active, alone;
  cudaError_t err;
  int n = 1;
  while (n < GRU_MAX_CLUSTER && (u + n - 1) / n > GRU_UNITS_PER_CTA) n *= 2;
  while (2 * n <= GRU_MAX_CLUSTER
         && (u + 2 * n - 1) / (2 * n) >= GRU_MIN_UNITS
         && launch_shape(B, u, 2 * n, GRU_MAX_ROWS, smem_of, &kc, &m,
                         &threads, &smem)) {
    err = exclusive_clusters(kernels[3][kc - 1], 2 * n, threads, smem,
                             &alone);
    if (err != cudaSuccess) return (int)err;
    if (alone < B) break;
    n *= 2;
  }
  if (!launch_shape(B, u, n, GRU_MAX_ROWS, smem_of, &kc, &m, &threads,
                    &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  err = exclusive_clusters(kernels[3][kc - 1], n, threads, smem, &alone);
  if (err != cudaSuccess) return (int)err;
  alone = alone < 1 ? 1 : alone;
  const int r = min(GRU_MAX_ROWS, (B + alone - 1) / alone);
  launch_shape(B, u, n, r, smem_of, &kc, &m, &threads, &smem);
  const void* fn = kernels[rows_index(r)][kc - 1];
  err = exclusive_clusters(fn, n, threads, smem, &alone);
  if (err == cudaSuccess) err = active_clusters(fn, n, threads, smem, &active);
  if (err != cudaSuccess) return (int)err;
  plan[0] = n;
  plan[1] = r;
  plan[2] = (B + r - 1) / r;
  plan[3] = threads;
  plan[4] = smem;
  plan[5] = active;
  plan[6] = alone;
  plan[7] = m;
  return 0;
}

// Set the kernel's shared-memory size and fill the launch of
// ceil(B / rows) clusters of n CTAs.
static inline cudaError_t cluster_launch(const void* fn, int B, int n,
                                         int rows, int threads, int smem,
                                         cudaStream_t stream,
                                         cudaLaunchConfig_t* cfg,
                                         cudaLaunchAttribute* attr) {
  *cfg = launch_config(n, (B + rows - 1) / rows, threads, smem, stream, attr);
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}
