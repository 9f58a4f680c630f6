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
//   dh     = dh z + dz_pre Uz^T + dr_pre Ur^T + drh Uh^T
// It emits dxz = dz_pre, dxr = dr_pre, dxh = dpre, drh for every step and
// dh0, the final carry. The weight gradients (h_prev^T d*, over T * B) and
// the bias sums are formed outside, by the wrapper, as the TPU wrapper does
// (gru_pallas.py:334-353). The expression order above is the plain
// version's (kernels/gru.py gru_scan_plain_bwd) and the TPU kernel's.
//
// Bound on the H100: at v2 training shapes (T = 750, B = 96, u = 192) the
// call moves ~500 MB and does 2 * 2 * T * B * u * 3u = 32 Gflop of
// products: ~0.15 ms of bytes, ~0.5 ms of float32 operations. What bounds
// it is the serial chain of T steps: only the U^T product feeds the carry
// (h_prev comes from the saved hs), but each step still runs, in one block,
// the recompute product, the gate math, the U^T product and the sum, with
// a block barrier between each.
//
// Design (the structure of gru_scan.cu): batch rows are independent, so
// each block owns `rows` rows for all T steps and the carry dh stays in
// registers of the threads that own its (row, unit) items. Per step:
//   A. thread j < 3u: rec[r, j] = sum_k h_prev[r, k] U[k, j] + b[j] for the
//      block's rows (h_prev read from shared memory as float4 broadcasts);
//   B. items (r, i): the gate math; the four streams go to global memory
//      and (dz_pre, dr_pre, drh) overwrite rec[r, i], rec[r, u+i],
//      rec[r, 2u+i] in place (each item owns exactly those three);
//   C. thread (p, i) with p = j / u: part[r, j] = sum_{c < u} d[r, pu + c]
//      U[i, pu + c], the three U^T products; meanwhile h_prev of the next
//      step is loaded into shared memory and its x_proj and g into
//      registers;
//   D. items (r, i): dh = dh z + part_z + part_r + part_h.
// U at u = 192 is 442 KB, twice an SM's shared memory: its first k_staged
// rows are staged once in shared memory with a row stride of 3u + 1, so
// that phase A's column reads (thread j, row k) and phase C's row reads
// (thread i, row i) both fall in distinct banks. The rows past k_staged
// come from global memory, where they stay in the 50 MB L2: phase A reads
// U[k, j] (coalesced over j) and phase C reads a transposed copy
// U^T[j, i] (coalesced over i), so both products read the same weights
// without uncoalesced loads. Splitting U over a thread-block cluster is
// later work (ROADMAP B.2).

#include <cuda_runtime.h>

#define GRUB_MAX_ROWS 8
#define GRUB_MAX_ITEMS ((GRUB_MAX_ROWS + 2) / 3)
#define GRUB_SMEM_LIMIT 232448

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void gru_scan_bwd_kernel(const float* __restrict__ x_proj,
                                    const float* __restrict__ U,
                                    const float* __restrict__ UT,
                                    const float* __restrict__ rec_bias,
                                    const float* __restrict__ h0,
                                    const float* __restrict__ hs,
                                    const float* __restrict__ g,
                                    float* __restrict__ streams,
                                    float* __restrict__ dh0,
                                    int T, int B, int u, int rows,
                                    int k_staged) {
  extern __shared__ __align__(16) float smem[];
  const int three_u = 3 * u;
  const int stride = three_u + 1;
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, B - row0);
  float* hp_s = smem;                        // rows * u
  float* rec_s = hp_s + rows * u;            // rows * 3u: rec, then d
  float* part_s = rec_s + rows * three_u;    // rows * 3u
  float* u_s = part_s + rows * three_u;      // k_staged * (3u + 1)
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int n_items = nrows * u;
  const size_t plane = (size_t)T * B * u;    // one stream
  float* dxz = streams;
  float* dxr = streams + plane;
  float* dxh = streams + 2 * plane;
  float* drh_out = streams + 3 * plane;

  for (int i = tid; i < k_staged * three_u; i += nthreads) {
    const int k = i / three_u;
    const int j = i - k * three_u;
    u_s[k * stride + j] = U[i];
  }
  // h_prev of step T-1.
  for (int i = tid; i < n_items; i += nthreads) {
    const int r = i / u;
    const int c = i - r * u;
    hp_s[i] = (T > 1) ? hs[((size_t)(T - 2) * B + row0 + r) * u + c]
                      : h0[(size_t)(row0 + r) * u + c];
  }
  float xz[GRUB_MAX_ITEMS], xr[GRUB_MAX_ITEMS], xh[GRUB_MAX_ITEMS];
  float gv[GRUB_MAX_ITEMS], dh[GRUB_MAX_ITEMS], dhz[GRUB_MAX_ITEMS];
#pragma unroll
  for (int it = 0; it < GRUB_MAX_ITEMS; ++it) {
    dh[it] = 0.0f;
    dhz[it] = 0.0f;
    const int idx = tid + it * nthreads;
    if (idx < n_items) {
      const int r = idx / u;
      const int c = idx - r * u;
      const size_t row = (size_t)(T - 1) * B + row0 + r;
      xz[it] = x_proj[row * three_u + c];
      xr[it] = x_proj[row * three_u + u + c];
      xh[it] = x_proj[row * three_u + 2 * u + c];
      gv[it] = g[row * u + c];
    }
  }
  __syncthreads();
  const int j = tid;
  const float bj = (j < three_u) ? rec_bias[j] : 0.0f;
  const int p = j / u;                // phase C: which U^T block
  const int ci = j - p * u;           // phase C: output unit

  for (int t = T - 1; t >= 0; --t) {
    // A. Recompute rec = h_prev U + b.
    if (j < three_u) {
      float acc[GRUB_MAX_ROWS];
#pragma unroll
      for (int r = 0; r < GRUB_MAX_ROWS; ++r) acc[r] = 0.0f;
      for (int k = 0; k < u; k += 4) {
        float w0, w1, w2, w3;
        if (k < k_staged) {
          w0 = u_s[k * stride + j];
          w1 = u_s[(k + 1) * stride + j];
          w2 = u_s[(k + 2) * stride + j];
          w3 = u_s[(k + 3) * stride + j];
        } else {
          w0 = U[(size_t)k * three_u + j];
          w1 = U[(size_t)(k + 1) * three_u + j];
          w2 = U[(size_t)(k + 2) * three_u + j];
          w3 = U[(size_t)(k + 3) * three_u + j];
        }
#pragma unroll
        for (int r = 0; r < GRUB_MAX_ROWS; ++r) {
          if (r < nrows) {
            const float4 hv =
                *reinterpret_cast<const float4*>(hp_s + r * u + k);
            acc[r] += hv.x * w0;
            acc[r] += hv.y * w1;
            acc[r] += hv.z * w2;
            acc[r] += hv.w * w3;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < GRUB_MAX_ROWS; ++r) {
        if (r < nrows) rec_s[r * three_u + j] = acc[r] + bj;
      }
    }
    __syncthreads();
    // B. Gate math and the streams; the gate cotangents replace rec.
#pragma unroll
    for (int it = 0; it < GRUB_MAX_ITEMS; ++it) {
      const int idx = tid + it * nthreads;
      if (idx < n_items) {
        const int r = idx / u;
        const int c = idx - r * u;
        float* rec = rec_s + r * three_u;
        const float rh = rec[2 * u + c];
        const float z = sigmoidf_(xz[it] + rec[c]);
        const float rg = sigmoidf_(xr[it] + rec[u + c]);
        const float hh = tanhf(xh[it] + rg * rh);
        const float hp = hp_s[idx];
        const float d = dh[it] + gv[it];
        const float dz = d * (hp - hh);
        const float dpre = (d * (1.0f - z)) * (1.0f - hh * hh);
        const float drh = dpre * rg;
        const float dr_pre = (dpre * rh) * (rg * (1.0f - rg));
        const float dz_pre = dz * (z * (1.0f - z));
        const size_t o = ((size_t)t * B + row0 + r) * u + c;
        dxz[o] = dz_pre;
        dxr[o] = dr_pre;
        dxh[o] = dpre;
        drh_out[o] = drh;
        rec[c] = dz_pre;
        rec[u + c] = dr_pre;
        rec[2 * u + c] = drh;
        dhz[it] = d * z;
      }
    }
    __syncthreads();
    // C. The three U^T products; prefetch the next step's inputs.
    if (j < three_u) {
      float acc[GRUB_MAX_ROWS];
#pragma unroll
      for (int r = 0; r < GRUB_MAX_ROWS; ++r) acc[r] = 0.0f;
      const int col0 = p * u;
      for (int c = 0; c < u; c += 4) {
        float w0, w1, w2, w3;
        if (ci < k_staged) {
          const float* ur = u_s + ci * stride + col0 + c;
          w0 = ur[0];
          w1 = ur[1];
          w2 = ur[2];
          w3 = ur[3];
        } else {
          const float* ut = UT + (size_t)(col0 + c) * u + ci;
          w0 = ut[0];
          w1 = ut[u];
          w2 = ut[2 * u];
          w3 = ut[3 * u];
        }
#pragma unroll
        for (int r = 0; r < GRUB_MAX_ROWS; ++r) {
          if (r < nrows) {
            const float4 dv = *reinterpret_cast<const float4*>(
                rec_s + r * three_u + col0 + c);
            acc[r] += dv.x * w0;
            acc[r] += dv.y * w1;
            acc[r] += dv.z * w2;
            acc[r] += dv.w * w3;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < GRUB_MAX_ROWS; ++r) {
        if (r < nrows) part_s[r * three_u + j] = acc[r];
      }
    }
    if (t > 0) {
      for (int i = tid; i < n_items; i += nthreads) {
        const int r = i / u;
        const int c = i - r * u;
        hp_s[i] = (t > 1) ? hs[((size_t)(t - 2) * B + row0 + r) * u + c]
                          : h0[(size_t)(row0 + r) * u + c];
      }
#pragma unroll
      for (int it = 0; it < GRUB_MAX_ITEMS; ++it) {
        const int idx = tid + it * nthreads;
        if (idx < n_items) {
          const int r = idx / u;
          const int c = idx - r * u;
          const size_t row = (size_t)(t - 1) * B + row0 + r;
          xz[it] = x_proj[row * three_u + c];
          xr[it] = x_proj[row * three_u + u + c];
          xh[it] = x_proj[row * three_u + 2 * u + c];
          gv[it] = g[row * u + c];
        }
      }
    }
    __syncthreads();
    // D. The carry.
#pragma unroll
    for (int it = 0; it < GRUB_MAX_ITEMS; ++it) {
      const int idx = tid + it * nthreads;
      if (idx < n_items) {
        const int r = idx / u;
        const int c = idx - r * u;
        const float* part = part_s + r * three_u;
        dh[it] = dhz[it] + part[c] + part[u + c] + part[2 * u + c];
      }
    }
  }
#pragma unroll
  for (int it = 0; it < GRUB_MAX_ITEMS; ++it) {
    const int idx = tid + it * nthreads;
    if (idx < n_items) dh0[(size_t)row0 * u + idx] = dh[it];
  }
}

// Rows of U staged in shared memory (a multiple of 4, at most u), or -1
// if the per-row buffers alone do not fit.
extern "C" int gru_scan_bwd_staged_rows(int u, int rows) {
  const long fixed = 4L * rows * 7L * u;    // h_prev, rec/d, part
  if (fixed > GRUB_SMEM_LIMIT) return -1;
  const long per_row = 4L * (3L * u + 1);
  long k = (GRUB_SMEM_LIMIT - fixed) / per_row;
  k = k < u ? k : u;
  return (int)(k - k % 4);
}

extern "C" int gru_scan_bwd_launch(const float* x_proj, const float* U,
                                   const float* UT, const float* rec_bias,
                                   const float* h0, const float* hs,
                                   const float* g, float* streams,
                                   float* dh0, int T, int B, int u, int rows,
                                   cudaStream_t stream) {
  if (rows < 1 || rows > GRUB_MAX_ROWS || 3 * u > 1024 || u % 4 != 0
      || T < 1 || B < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int k_staged = gru_scan_bwd_staged_rows(u, rows);
  if (k_staged < 0) return (int)cudaErrorInvalidValue;
  const int smem = 4 * (rows * 7 * u + k_staged * (3 * u + 1));
  cudaError_t err = cudaFuncSetAttribute(
      gru_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((3 * u + 31) / 32) * 32;
  const int blocks = (B + rows - 1) / rows;
  gru_scan_bwd_kernel<<<blocks, threads, smem, stream>>>(
      x_proj, U, UT, rec_bias, h0, hs, g, streams, dh0, T, B, u, rows,
      k_staged);
  return (int)cudaGetLastError();
}
