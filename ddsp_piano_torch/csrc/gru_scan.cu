// Keras reset_after GRU recurrence over precomputed input projections.
//
// Replaces: ddsp_piano_tpu/kernels/gru_pallas.py, gru_scan_pallas
// (_gru_kernel): the recurrence of both GRUs on the v2 inference path
// (FiLMContextNetwork GRU(64), MonophonicDeepNetwork GRU(192)) and of the
// dafx22 ContextNetwork and MonophonicNetwork.
//
// Work, per step t and batch row b (gate order [z, r, h]):
//   rec = h U + b_rec                                  (1 x 3u)
//   z = sig(xz + rz); r = sig(xr + rr); hh = tanh(xh + r * rh)
//   h' = z h + (1 - z) hh
// The bias association (rec = h U + b_rec, then + x) is the TPU kernel's
// (gru_pallas.py:66-82) and the plain version's (kernels/gru.py).
//
// Bound on the H100: at the paths' shapes the whole call moves a few MB
// and does 2 * T * B * u * 3u flops (0.8 Gflop for the mono GRU at
// T = 750, B = 16): tens of microseconds at the card's rates. What bounds
// it is the latency of T dependent steps, each a (rows x u) @ (u x 3u)
// product, the gate math and an exchange of h. At u = 192, U is 442 KB,
// twice an SM's shared memory, so one SM cannot hold it.
//
// Design: a thread-block cluster of N CTAs (sm_90) owns `rows` batch rows
// for all T steps (a persistent launch; clusters never talk to each
// other). CTA c owns units I_c (m = ceil(u / N) of them) and the z, r and
// h columns of U that produce them: u x 3m floats, held in registers for
// the whole launch (72 a thread at u = 192, N = 8), so no step reads U
// from memory. Thread (unit j, slice s), s in [0, 8): the eight lanes of a
// unit split the product's k range into interleaved float4 chunks, so no
// thread chains more than 4 ceil(u / 32) dependent FMAs a row, and each
// weight in a register feeds every row. The eight partial sums of each
// (row, gate) are reduced with a reduce-scatter over the eight lanes
// (7 shuffles for 8 rows), after which lane s holds row s's three
// pre-activations and does its gate math itself: no shared-memory round
// trip and no block barrier for the gates.
//
// The shared pieces (the thread layout, the product, the reduction, the
// cluster barrier and the launch plan) are in gru_cluster.cuh.
//
// The exchange: every CTA keeps the whole h (rows x u) in shared memory,
// double-buffered. Lane (j, s) writes its h'[s, j] into buffer (t+1) % 2
// of every CTA of the cluster through distributed shared memory
// (map_shared_rank), then the cluster meets at one barrier a step
// (barrier.cluster.arrive.release / wait.acquire). That barrier publishes
// h_{t+1}, and also proves that every peer has finished reading buffer
// (t+1) % 2 at step t-1, so one barrier a step is enough. Between arrive
// and wait each lane loads step t+1's input projections and asks L2 for
// step t+2's. The plan (gru_scan_plan) picks N, rows and the number of
// clusters; the row stride u + 4 keeps the eight rows' writes in distinct
// banks.
//
// The bf16 instance (BF16 = true; kernels/gru.py gru_scan_plain's bf16
// recurrence): U's columns are rounded to bfloat16 as load_columns loads
// them, and the h that the lanes publish for the product (h0 as it is
// staged, then each h') is rounded too; the sums stay float32. The lane
// that computes h'[s, j] keeps it unrounded in a register for the next
// step's z h. gru_scan_launch's bf16 argument picks the instance.

#include "gru_cluster.cuh"

template <int KC, int RM, bool BF16>
__global__ void __launch_bounds__(KC <= 2 ? 512 : 256)
gru_scan_kernel(const float* __restrict__ x_proj, const float* __restrict__ U,
                const float* __restrict__ rec_bias,
                const float* __restrict__ h0, float* __restrict__ out, int T,
                int B, int u, int rows, int m) {
  extern __shared__ __align__(16) float smem[];   // 2 x rows x (u + 4): h
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / n_cta) * rows;
  const int nrows = min(rows, B - row0);
  const int three_u = 3 * u;
  const int hstride = u + 4;
  const int hplane = rows * hstride;
  const int s = threadIdx.x & (GRU_SLICES - 1);
  const int jl = threadIdx.x / GRU_SLICES;
  const int j = rank * m + jl;
  const bool unit_ok = jl < m && j < u;
  const bool gate_ok = unit_ok && s < nrows;

  float4 wz[KC], wr[KC], wh[KC];
  load_columns<KC, BF16>(U, u, j, s, unit_ok, wz, wr, wh);
  const float bz = unit_ok ? rec_bias[j] : 0.0f;
  const float br = unit_ok ? rec_bias[u + j] : 0.0f;
  const float bh = unit_ok ? rec_bias[2 * u + j] : 0.0f;

  for (int i = threadIdx.x; i < nrows * u; i += blockDim.x) {
    const int r = i / u;
    const float h = h0[(size_t)row0 * u + i];
    smem[r * hstride + (i - r * u)] = BF16 ? round_bf16(h) : h;
  }
  float xz = 0.0f, xr = 0.0f, xh = 0.0f, h_own = 0.0f;
  if (gate_ok) {
    if (BF16) h_own = h0[(size_t)(row0 + s) * u + j];
    const float* x = x_proj + (size_t)(row0 + s) * three_u;
    xz = x[j];
    xr = x[u + j];
    xh = x[2 * u + j];
  }
  if (T > 1) {
    prefetch_span(x_proj + ((size_t)B + row0) * three_u, nrows * three_u,
                  rank, n_cta);
  }
  cluster.sync();   // h0 staged; every CTA of the cluster is running

  for (int t = 0; t < T; ++t) {
    const float* hc = smem + (t & 1) * hplane;
    float rz, rr, rh;
    product<KC, RM>(hc, hstride, u, nrows, s, wz, wr, wh, &rz, &rr, &rh);
    if (gate_ok) {
      const float z = sigmoidf_(xz + (rz + bz));
      const float rg = sigmoidf_(xr + (rr + br));
      const float hh = tanhf(xh + rg * (rh + bh));
      const float h_prev = BF16 ? h_own : hc[s * hstride + j];
      const float h_new = z * h_prev + (1.0f - z) * hh;
      if (BF16) h_own = h_new;
      out[((size_t)t * B + row0 + s) * u + j] = h_new;
      if (t + 1 < T) {
        const float h_pub = BF16 ? round_bf16(h_new) : h_new;
        float* dst = smem + ((t + 1) & 1) * hplane + s * hstride + j;
        for (int p = 0; p < n_cta; ++p) {
          *cluster.map_shared_rank(dst, p) = h_pub;
        }
      }
    }
    if (t + 1 < T) {
      cluster_arrive();
      if (gate_ok) {
        const float* x = x_proj + ((size_t)(t + 1) * B + row0 + s) * three_u;
        xz = x[j];
        xr = x[u + j];
        xh = x[2 * u + j];
      }
      if (t + 2 < T) {
        prefetch_span(x_proj + ((size_t)(t + 2) * B + row0) * three_u,
                      nrows * three_u, rank, n_cta);
      }
      cluster_wait();
    }
  }
}

typedef void (*GruKernel)(const float*, const float*, const float*,
                          const float*, float*, int, int, int, int, int);

#define GRU_KERNELS(RM, BF16)                                             \
  {(const void*)gru_scan_kernel<1, RM, BF16>,                             \
   (const void*)gru_scan_kernel<2, RM, BF16>,                             \
   (const void*)gru_scan_kernel<3, RM, BF16>,                             \
   (const void*)gru_scan_kernel<4, RM, BF16>,                             \
   (const void*)gru_scan_kernel<5, RM, BF16>,                             \
   (const void*)gru_scan_kernel<6, RM, BF16>,                             \
   (const void*)gru_scan_kernel<7, RM, BF16>,                             \
   (const void*)gru_scan_kernel<8, RM, BF16>}

// By float32 or bf16, compiled rows (1, 2, 4, 8) and float4 chunks per
// lane (1 .. 8).
static const void* const kKernels[2][4][GRU_MAX_CHUNKS] = {
    {GRU_KERNELS(1, false), GRU_KERNELS(2, false), GRU_KERNELS(4, false),
     GRU_KERNELS(8, false)},
    {GRU_KERNELS(1, true), GRU_KERNELS(2, true), GRU_KERNELS(4, true),
     GRU_KERNELS(8, true)}};

// Shared bytes: h, double-buffered, rows of u + 4.
static int smem_of(int u, int m, int rows) { return 4 * 2 * rows * (u + 4); }

// The launch plan (gru_plan in gru_cluster.cuh): plan[0..7] = cluster
// size, rows per cluster, clusters, threads per CTA, shared bytes per CTA,
// co-resident clusters, those with an SM to each CTA, units per CTA.
extern "C" int gru_scan_plan(int B, int u, int* plan) {
  return gru_plan(B, u, smem_of, kKernels[0], plan);
}

// cluster and rows: plan[0] and plan[1] of gru_scan_plan for B and u;
// bf16 != 0 launches the bf16 instance.
extern "C" int gru_scan_launch(const float* x_proj, const float* U,
                               const float* rec_bias, const float* h0,
                               float* out, int T, int B, int u, int cluster,
                               int rows, int bf16, cudaStream_t stream) {
  int kc, m, threads, smem;
  if (T < 1 || !launch_shape(B, u, cluster, rows, smem_of, &kc, &m, &threads,
                             &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* fn = kKernels[bf16 != 0][rows_index(rows)][kc - 1];
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_launch(fn, B, cluster, rows, threads, smem,
                                   stream, &cfg, &attr);
  if (err == cudaSuccess) {
    err = cudaLaunchKernelEx(&cfg, (GruKernel)fn, x_proj, U, rec_bias, h0,
                             out, T, B, u, rows, m);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
