// Additive oscillator bank from framewise controls, skipping dead partials.
//
// Replaces: ddsp_piano_tpu/kernels/oscillator_pallas.py,
// render_framewise_pallas_skip (_osc_skip_kernel, with the trig of
// _range_reduce / _COS6): the additive synth of the v2 inference path and
// the forward of its training step.
//
// Work: for voice v, frame f and intra-frame sample s (0 <= s < up),
//   out[v, f*up + s] = sum_{k < k_last(v, f)} amp_k(s) * cos(phase_k(s))
//   phase_k(s) = phase0 + w * ((s + 1) f_lo + (f_hi - f_lo) s(s+1)/(2 up))
//   amp_k(s)   = a_lo (1 - h(s)) + a_hi h(s),   h(s) = sin^2(pi s / (2 up))
//   amp_k(s)   = 0 where f_lo + (f_hi - f_lo) s/up >= nyquist
// k_last(v, f) is one past the frame's last active partial, with the TPU
// kernel's predicate (oscillator_pallas.py:317-320): min(f_lo, f_hi) < nyq
// and (a_lo != 0 or a_hi != 0). Inactive partials below it contribute exact
// zeros, so any skip granularity gives the plain render up to the order of
// the sum over partials.
//
// Bound on the H100: issued instructions of the live terms, ~30 float32
// instructions per live (partial, sample) (phase, crossfade, mask, range
// reduction, a degree-6 polynomial, the sum); dead frames (a voice with no
// note, or every partial above Nyquist) are most frames and cost only the
// bytes that find k_last = 0. At the training step's inputs the live terms
// alone take ~0.16 ms at full issue; bytes ~0.06 ms.
//
// Design: one block per (run of FPB = 4 frames, voice), runs fastest (the
// voice allocator fills the low voices first, so the blocks that sound are
// scheduled first and the dead ones fill in behind them). Thread (frame,
// s) renders one output sample; a frame's samples are up / 32 warps, so
// the k_last bound is uniform in each warp.
// 1. All threads load the frames' five control rows in one pass (coalesced;
//    one round trip to memory, so a block that sounds waits once), keep
//    (f_lo, f_hi - f_lo, a_lo, a_hi) as one float4 per cell and phase0 beside
//    it in shared memory, and find each frame's k_last with a warp max and
//    one shared atomic per warp.
// 2. Each thread walks its frame's partials below k_last with two
//    accumulators (even and odd k: two independent chains in flight), two
//    shared loads a term, both broadcasts; dead frames write zeros.
// Measured against other layouts (PERF.md, section 6): splitting a live
// frame's partials into slices across more warps, reading phase0 only for
// live frames in a second pass, and voice-fastest grids were each slower
// on the card at the paths' inputs; the work of the training step already
// fills the card, and each extra pass is another wait per block.
// The per-sample values (h, 1 - h, tri, s + 1, s/up) are one thread's
// constants, read once from the cached table (kernels/oscillator.py).
// Rounding: oscillator_common.cuh (the polynomial and the accumulation
// fused, the phase, crossfade, frequency and reduction not).

#include "oscillator_common.cuh"

#define OSC_FRAMES_PER_BLOCK 4

__device__ __forceinline__ float osc_term(float4 c, float p0, float h,
                                          float omh, float tri, float s1,
                                          float sf, float w_scale,
                                          float nyquist, float acc) {
  // c: f_lo, f_hi - f_lo, a_lo, a_hi
  const float phase = p0 + w_scale * (s1 * c.x + c.y * tri);
  float amp = c.z * omh + c.w * h;
  const float freq = c.x + c.y * sf;
  amp = freq < nyquist ? amp : 0.0f;
  const float x = osc_range_reduce(phase);
  return OSC_MAD(amp, osc_cos6(x * x), acc);
}

__global__ void __launch_bounds__(1024)
osc_skip_kernel(const float* __restrict__ f_lo, const float* __restrict__ f_hi,
                const float* __restrict__ a_lo, const float* __restrict__ a_hi,
                const float* __restrict__ phase0,
                const float* __restrict__ table, float* __restrict__ out,
                int n_frames, int K, int up, float w_scale, float nyquist) {
  extern __shared__ float4 sm4[];
  const int fpb = OSC_FRAMES_PER_BLOCK;
  float4* ctl = sm4;                                         // fpb * K
  float* p0s = reinterpret_cast<float*>(ctl + fpb * K);      // fpb * K
  int* k_last = reinterpret_cast<int*>(p0s + fpb * K);       // fpb
  const int v = blockIdx.y;
  const int frame0 = blockIdx.x * fpb;
  const int nfb = min(fpb, n_frames - frame0);
  const int tid = threadIdx.x;
  const int n = nfb * K;
  const size_t base = ((size_t)v * n_frames + frame0) * K;

  if (tid < fpb) k_last[tid] = 0;
  __syncthreads();
  // 1. Controls and k_last. With K a multiple of 32 (and blockDim.x one by
  //    construction) a warp's cells lie in one frame: one atomic per warp.
  const bool warp_frames = (K & 31) == 0;
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + tid;
    const bool valid = i < n;
    const int f = valid ? i / K : 0;
    int kk = 0;
    if (valid) {
      const float flo = f_lo[base + i];
      const float fhi = f_hi[base + i];
      const float alo = a_lo[base + i];
      const float ahi = a_hi[base + i];
      p0s[i] = phase0[base + i];
      ctl[i] = make_float4(flo, fhi - flo, alo, ahi);
      if (fminf(flo, fhi) < nyquist && (alo != 0.0f || ahi != 0.0f)) {
        kk = i - f * K + 1;
      }
    }
    if (warp_frames) {
      const int m = __reduce_max_sync(0xffffffffu, kk);
      if ((tid & 31) == 0 && m > 0) atomicMax(&k_last[f], m);
    } else if (kk > 0) {
      atomicMax(&k_last[f], kk);
    }
  }
  __syncthreads();

  // 2. Thread (fl, s): sample s of frame fl.
  const int fl = tid / up;
  const int s = tid - fl * up;
  if (fl >= nfb) return;
  const float h = table[OSC_T_H * up + s];
  const float tri = table[OSC_T_TRI * up + s];
  const float s1 = table[OSC_T_S1 * up + s];
  const float sf = table[OSC_T_SF * up + s];
  const float omh = table[OSC_T_OMH * up + s];
  const float4* c = ctl + fl * K;
  const float* p = p0s + fl * K;
  const int kl = k_last[fl];
  float a0 = 0.0f, a1 = 0.0f;
  int k = 0;
  for (; k + 1 < kl; k += 2) {
    a0 = osc_term(c[k], p[k], h, omh, tri, s1, sf, w_scale, nyquist, a0);
    a1 = osc_term(c[k + 1], p[k + 1], h, omh, tri, s1, sf, w_scale, nyquist,
                  a1);
  }
  if (k < kl) {
    a0 = osc_term(c[k], p[k], h, omh, tri, s1, sf, w_scale, nyquist, a0);
  }
  out[((size_t)v * n_frames + frame0 + fl) * up + s] = a0 + a1;
}

// table: the cached OSC_TABLES x up table on the card.
extern "C" int osc_skip_launch(const float* f_lo, const float* f_hi,
                               const float* a_lo, const float* a_hi,
                               const float* phase0, const float* table,
                               float* out, int batch, int n_frames, int K,
                               int up, float w_scale, float nyquist,
                               cudaStream_t stream) {
  const int fpb = OSC_FRAMES_PER_BLOCK;
  if (up < 1 || K < 1 || fpb * up > 1024 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  // Whole warps: the warp max names all 32 lanes; lanes past fpb * up idle.
  const int threads = (fpb * up + 31) / 32 * 32;
  const size_t smem = (sizeof(float4) + sizeof(float)) * fpb * K
                      + sizeof(int) * fpb;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 49152) {
    cudaError_t err = cudaFuncSetAttribute(
        osc_skip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n_frames + fpb - 1) / fpb, batch);
  osc_skip_kernel<<<grid, threads, smem, stream>>>(
      f_lo, f_hi, a_lo, a_hi, phase0, table, out, n_frames, K, up, w_scale,
      nyquist);
  return (int)cudaGetLastError();
}
