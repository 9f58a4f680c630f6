// Backward of the Keras reset_after GRU recurrence: the per-step streams.
//
// Replaces: ddsp_piano_tpu/kernels/gru_pallas.py, _gru_bwd_streams
// (_gru_bwd_kernel), called by gru_scan_pallas_bwd: the gradient of both
// GRUs on the v2 training path (FiLMContextNetwork GRU(64),
// MonophonicDeepNetwork GRU(192)).
//
// Work, per batch row, walking t = T-1 .. 0 with the carry dh (the
// cotangent of h_t accumulated from later steps), gate order [z, r, h]:
//   rec = h_prev U + b_rec                 (recompute; h_prev = hs[t-1] or h0)
//   z = sig(xz + rz); r = sig(xr + rr); hh = tanh(xh + r * rh)
//   dh    += g[t]
//   dz_pre = dh (h_prev - hh) z (1 - z)
//   dpre   = dh (1 - z) (1 - hh^2)         (the stream dxh)
//   drh    = dpre r
//   dr_pre = dpre rh r (1 - r)
//   dh     = dh z + [dz_pre | dr_pre | drh] U^T
// It emits dxz = dz_pre, dxr = dr_pre, dxh = dpre, drh for every step and
// dh0, the final carry. The weight gradients (h_prev^T d*, over T * B) and
// the bias sums are formed outside, by the wrapper, as the TPU wrapper does
// (gru_pallas.py:334-353). The expression order above is the plain
// version's (kernels/gru.py gru_scan_plain_bwd) and the TPU kernel's.
//
// Bound on the H100: at v2 training shapes (T = 750, B = 96, u = 192) the
// call moves ~500 MB and does 2 * 2 * T * B * u * 3u = 32 Gflop of
// products: ~0.15 ms of bytes, ~0.5 ms of float32 operations. What bounds
// it is the latency of the T dependent steps. Only the carry's product
// (the gate cotangents times U^T) lies on that chain: the recompute reads
// h_prev from the saved hs.
//
// Design (the cluster of gru_scan.cu): a cluster of N CTAs owns `rows`
// batch rows for all T steps; CTA c owns units I_c (m of them).
//   - The recompute: thread (unit j, slice s) holds the z, r and h columns
//     of U for unit j over its k slice in registers, as in the forward
//     (the shared pieces are in gru_cluster.cuh); the cluster's rows of
//     h_prev are copied from hs into a triple buffer in shared memory by
//     cp.async three steps ahead, and the eight lanes of a unit
//     reduce-scatter their partials, so that lane s holds row s's
//     pre-activations.
//   - The gates are then local: lane s computes row s's four streams.
//   - The carry needs dh[i] = dhz + sum over all 3u columns k of
//     D[k] U[i, k], where D = [dz_pre | dr_pre | drh]. Of the two ways to
//     split it this takes the all-gather: each CTA keeps the rows of U for
//     its own units (U[I_c, :], m x 3u floats, 55 KB at u = 192, N = 8) in
//     shared memory, and each lane writes its row's three cotangents into
//     every CTA's D buffer (rows x 3u, double-buffered) through
//     distributed shared memory. After one cluster barrier each CTA
//     finishes its units' dot products locally: no transposed copy of U,
//     one summation order per dot, and the carry stays in the registers of
//     the lane that computes the next step's gates. The other way, a
//     reduce-scatter of the rows x u partials, would need N partial slots
//     per unit and a second pass over them.
//   - The recompute of step t-1 does not depend on the carry, so it runs
//     between the barrier's arrive and its wait: one cluster barrier a
//     step, and only the carry product, its reduction and the gate math
//     on the serial chain. The barrier that publishes D_t also proves
//     every peer has finished reading the buffer that step t-1 writes.
//
// The bf16 instance (BF16 = true; kernels/gru.py gru_scan_plain_bwd's bf16
// gradient): the recompute's columns of U are rounded to bfloat16 as
// load_columns loads them and its h_prev as the product reads it; the
// rows of U for the carry are rounded as they are staged, and each lane
// publishes its D rounded; the carry's sums stay float32, and the four
// streams are written unrounded. gru_scan_bwd_launch's bf16 argument
// picks the instance.

#include "gru_cluster.cuh"

// Copy 16 bytes from global to shared memory without passing registers.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int KC, int RM, bool BF16>
__global__ void __launch_bounds__(KC <= 2 ? 512 : 256)
gru_scan_bwd_kernel(const float* __restrict__ x_proj,
                    const float* __restrict__ U,
                    const float* __restrict__ rec_bias,
                    const float* __restrict__ h0,
                    const float* __restrict__ hs,
                    const float* __restrict__ g,
                    float* __restrict__ streams, float* __restrict__ dh0,
                    int T, int B, int u, int rows, int m) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / n_cta) * rows;
  const int nrows = min(rows, B - row0);
  const int three_u = 3 * u;
  const int dstride = three_u + 4;
  const int dplane = rows * dstride;
  float* u_rows = smem;                    // m x 3u: U[j, :] of the units
  float* dbuf = u_rows + m * three_u;      // 2 x rows x (3u + 4): D
  float* pbuf = dbuf + 2 * dplane;         // 3 x rows x u: h_prev
  const int s = threadIdx.x & (GRU_SLICES - 1);
  const int jl = threadIdx.x / GRU_SLICES;
  const int j = rank * m + jl;
  const bool unit_ok = jl < m && j < u;
  const bool gate_ok = unit_ok && s < nrows;
  const size_t plane = (size_t)T * B * u;  // one stream
  float* dxz = streams;
  float* dxr = streams + plane;
  float* dxh = streams + 2 * plane;
  float* drh_out = streams + 3 * plane;

  for (int i = threadIdx.x; i < m * three_u; i += blockDim.x) {
    const int unit = rank * m + i / three_u;
    const float w = unit < u ? U[(size_t)rank * m * three_u + i] : 0.0f;
    u_rows[i] = BF16 ? round_bf16(w) : w;
  }
  float4 wz[KC], wr[KC], wh[KC];
  load_columns<KC, BF16>(U, u, j, s, unit_ok, wz, wr, wh);
  const float bz = unit_ok ? rec_bias[j] : 0.0f;
  const float br = unit_ok ? rec_bias[u + j] : 0.0f;
  const float bh = unit_ok ? rec_bias[2 * u + j] : 0.0f;

  // h_prev of step t (hs[t-1] or h0) for the cluster's rows, staged in
  // buffer t % 3: issued here, landed after this thread's
  // cp_async_wait_all, visible to the CTA after the next cluster barrier.
  auto pbuf_of = [&](int t) { return pbuf + (t % 3) * rows * u; };
  auto stage = [&](int t) {
    const float* src =
        (t > 0 ? hs + (size_t)(t - 1) * B * u : h0) + (size_t)row0 * u;
    float* dst = pbuf_of(t);
    for (int i = threadIdx.x; i < nrows * u / 4; i += blockDim.x) {
      cp_async16(dst + 4 * i, src + 4 * i);
    }
  };
  // The gate lane's inputs of step t (h_prev from its staged buffer).
  float xz = 0.0f, xr = 0.0f, xh = 0.0f, gv = 0.0f, hp = 0.0f;
  auto load_inputs = [&](int t) {
    if (gate_ok) {
      const size_t row = (size_t)t * B + row0 + s;
      xz = x_proj[row * three_u + j];
      xr = x_proj[row * three_u + u + j];
      xh = x_proj[row * three_u + 2 * u + j];
      gv = g[row * u + j];
      hp = pbuf_of(t)[s * u + j];
    }
  };

  for (int t = T - 1; t >= 0 && t >= T - 3; --t) stage(t);
  cp_async_wait_all();
  cluster.sync();   // U's rows and h_prev staged; every CTA is running
  float rz, rr, rh;
  product<KC, RM, BF16>(pbuf_of(T - 1), u, u, nrows, s, wz, wr, wh, &rz,
                        &rr, &rh);
  load_inputs(T - 1);
  float dh = 0.0f;

  for (int t = T - 1; t >= 0; --t) {
    float* dcur = dbuf + (t & 1) * dplane;
    float dhz = 0.0f;
    if (gate_ok) {
      const float rhb = rh + bh;
      const float z = sigmoidf_(xz + (rz + bz));
      const float rg = sigmoidf_(xr + (rr + br));
      const float hh = tanhf(xh + rg * rhb);
      const float d = dh + gv;
      const float dz = d * (hp - hh);
      const float dpre = (d * (1.0f - z)) * (1.0f - hh * hh);
      const float drh = dpre * rg;
      const float dr_pre = (dpre * rhb) * (rg * (1.0f - rg));
      const float dz_pre = dz * (z * (1.0f - z));
      const size_t o = ((size_t)t * B + row0 + s) * u + j;
      dxz[o] = dz_pre;
      dxr[o] = dr_pre;
      dxh[o] = dpre;
      drh_out[o] = drh;
      const float dz_pub = BF16 ? round_bf16(dz_pre) : dz_pre;
      const float dr_pub = BF16 ? round_bf16(dr_pre) : dr_pre;
      const float drh_pub = BF16 ? round_bf16(drh) : drh;
      float* dst = dcur + s * dstride + j;
      for (int p = 0; p < n_cta; ++p) {
        float* peer = cluster.map_shared_rank(dst, p);
        peer[0] = dz_pub;
        peer[u] = dr_pub;
        peer[2 * u] = drh_pub;
      }
      dhz = d * z;
    }
    cp_async_wait_all();   // h_prev of step t-2, issued a step ago
    cluster_arrive();
    if (t > 0) {
      product<KC, RM, BF16>(pbuf_of(t - 1), u, u, nrows, s, wz, wr, wh, &rz,
                            &rr, &rh);
      load_inputs(t - 1);
      if (t > 1) {
        prefetch_span(x_proj + ((size_t)(t - 2) * B + row0) * three_u,
                      nrows * three_u, rank, n_cta);
        prefetch_span(g + ((size_t)(t - 2) * B + row0) * u, nrows * u, rank,
                      n_cta);
      }
    }
    cluster_wait();
    // Every thread has passed its reads of buffer t % 3 (h_prev of step t,
    // read a step ago): refill it with step t-3's.
    if (t > 2) stage(t - 3);
    // The carry: sum over the 3u columns of D[r, k] U[j, k]. Lanes of no
    // unit read the last unit's row; their sums are unused.
    float acc[GRU_MAX_ROWS];
#pragma unroll
    for (int r = 0; r < GRU_MAX_ROWS; ++r) acc[r] = 0.0f;
    const float* urow = u_rows + min(jl, m - 1) * three_u;
#pragma unroll 2
    for (int c = s; c < three_u / 4; c += GRU_SLICES) {
      const float4 w = *reinterpret_cast<const float4*>(urow + 4 * c);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 dv = *reinterpret_cast<const float4*>(
            dcur + min(r, nrows - 1) * dstride + 4 * c);
        acc[r] = fmaf(dv.x, w.x, acc[r]);
        acc[r] = fmaf(dv.y, w.y, acc[r]);
        acc[r] = fmaf(dv.z, w.z, acc[r]);
        acc[r] = fmaf(dv.w, w.w, acc[r]);
      }
    }
    dh = dhz + reduce_rows(acc, s);
  }
  if (gate_ok) dh0[(size_t)(row0 + s) * u + j] = dh;
}

typedef void (*GruBwdKernel)(const float*, const float*, const float*,
                             const float*, const float*, const float*, float*,
                             float*, int, int, int, int, int);

#define GRUB_KERNELS(RM, BF16)                                            \
  {(const void*)gru_scan_bwd_kernel<1, RM, BF16>,                         \
   (const void*)gru_scan_bwd_kernel<2, RM, BF16>,                         \
   (const void*)gru_scan_bwd_kernel<3, RM, BF16>,                         \
   (const void*)gru_scan_bwd_kernel<4, RM, BF16>,                         \
   (const void*)gru_scan_bwd_kernel<5, RM, BF16>,                         \
   (const void*)gru_scan_bwd_kernel<6, RM, BF16>,                         \
   (const void*)gru_scan_bwd_kernel<7, RM, BF16>,                         \
   (const void*)gru_scan_bwd_kernel<8, RM, BF16>}

// By float32 or bf16, compiled rows (1, 2, 4, 8) and float4 chunks per
// lane (1 .. 8).
static const void* const kKernels[2][4][GRU_MAX_CHUNKS] = {
    {GRUB_KERNELS(1, false), GRUB_KERNELS(2, false), GRUB_KERNELS(4, false),
     GRUB_KERNELS(8, false)},
    {GRUB_KERNELS(1, true), GRUB_KERNELS(2, true), GRUB_KERNELS(4, true),
     GRUB_KERNELS(8, true)}};

// Shared bytes: the units' rows of U, D double-buffered in rows of 3u + 4,
// h_prev triple-buffered.
static int smem_of(int u, int m, int rows) {
  return 4 * (m * 3 * u + 2 * rows * (3 * u + 4) + 3 * rows * u);
}

// The launch plan, as gru_scan_plan (gru_plan in gru_cluster.cuh).
extern "C" int gru_scan_bwd_plan(int B, int u, int* plan) {
  return gru_plan(B, u, smem_of, kKernels[0], plan);
}

// cluster and rows: plan[0] and plan[1] of gru_scan_bwd_plan for B and u;
// bf16 != 0 launches the bf16 instance.
extern "C" int gru_scan_bwd_launch(const float* x_proj, const float* U,
                                   const float* rec_bias, const float* h0,
                                   const float* hs, const float* g,
                                   float* streams, float* dh0, int T, int B,
                                   int u, int cluster, int rows, int bf16,
                                   cudaStream_t stream) {
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
    err = cudaLaunchKernelEx(&cfg, (GruBwdKernel)fn, x_proj, U, rec_bias, h0,
                             hs, g, streams, dh0, T, B, u, rows, m);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
