// Additive oscillator bank with decaying partials, from framewise controls,
// skipping dead partials (K10).
//
// Replaces: the plain render of the surrogate synth's partials
// (ddsp_piano_tpu/processors/surrogate.py render_framewise_decay, jnp; the
// JAX package has no Pallas site for it): the additive synth of the
// surrogate model's inference path and the forward of its training step.
//
// Work: K1's (oscillator_skip.cu) with an envelope on each term. For voice
// v, frame f and intra-frame sample s (0 <= s < up),
//   out[v, f*up + s] = sum_{k < k_last(v, f)} amp_k(s) env_k(s) cos(phase_k(s))
//   env_k(s)   = exp(log|d_k| (up T + s)),  d_k = decays[v, f, k],
//                T = decay_time[v, f] (frames since the last onset)
//   phase_k(s) = phase0 + w ((s + 1) f_lo + (f_hi - f_lo) s(s+1)/(2 up))
//   amp_k(s)   = a_lo (1 - h(s)) + a_hi h(s), 0 where the partial's
//                frequency f_lo + (f_hi - f_lo) s/up >= nyquist
// k_last(v, f) is one past the frame's last active partial, K1's predicate
// (min(f_lo, f_hi) < nyq and (a_lo != 0 or a_hi != 0)): the envelope is a
// finite factor for decays in [1e-5, 1] (the synth clips them there), so
// inactive partials below k_last add exact zeros, as in K1.
//
// Trig and exp: the plain version (ops/oscillator.py render_framewise_decay)
// takes torch.cos and torch.exp, so this kernel takes K8's cosine, within
// 2 ulp of the float64 cosine up to kOscCosRange (a phase here stays below
// 2 pi (1 + up / 2), ~210 rad at up = 64), and expf; log|d| once a cell.
//
// Bound on the H100: issued instructions of the live terms, K1's ~34 a
// term plus the envelope's multiply and exp (~12); dead frames cost the
// bytes that find k_last = 0 (PERF.md counts K1's operations only, a lower
// bound).
//
// Design: K1's. One block per (run of FPB = 4 frames, voice), runs fastest;
// thread (frame, s) renders one output sample. The block loads its frames'
// controls once into shared memory (float4 (f_lo, f_hi - f_lo, a_lo, a_hi),
// phase0 and log|d| a cell, up T a frame) and finds k_last with a warp max;
// each thread walks its frame's partials below k_last with two
// accumulators. Rounding: oscillator_common.cuh (built with --fmad=false;
// the accumulation fused).

#include "oscillator_common.cuh"

#define OSC_DECAY_FRAMES_PER_BLOCK 4

__device__ __forceinline__ float decay_term(float4 c, float p0, float ld,
                                            float t, float h, float omh,
                                            float tri, float s1, float sf,
                                            float w_scale, float nyquist,
                                            float acc) {
  // c: f_lo, f_hi - f_lo, a_lo, a_hi
  const float env = expf(ld * t);
  float amp = c.z * omh + c.w * h;
  const float freq = c.x + c.y * sf;
  amp = freq < nyquist ? amp : 0.0f;
  amp = amp * env;
  const float phase = p0 + w_scale * (s1 * c.x + c.y * tri);
  return OSC_MAD(amp, osc_cos(phase), acc);
}

__global__ void __launch_bounds__(1024)
osc_decay_kernel(const float* __restrict__ f_lo,
                 const float* __restrict__ f_hi,
                 const float* __restrict__ a_lo,
                 const float* __restrict__ a_hi,
                 const float* __restrict__ phase0,
                 const float* __restrict__ decays,
                 const float* __restrict__ decay_time,
                 const float* __restrict__ table, float* __restrict__ out,
                 int n_frames, int K, int up, float w_scale, float nyquist) {
  extern __shared__ float4 sm4[];
  const int fpb = OSC_DECAY_FRAMES_PER_BLOCK;
  float4* ctl = sm4;                                         // fpb * K
  float* p0s = reinterpret_cast<float*>(ctl + fpb * K);      // fpb * K
  float* lds = p0s + fpb * K;                                // fpb * K
  float* t_base = lds + fpb * K;                             // fpb
  int* k_last = reinterpret_cast<int*>(t_base + fpb);        // fpb
  const int v = blockIdx.y;
  const int frame0 = blockIdx.x * fpb;
  const int nfb = min(fpb, n_frames - frame0);
  const int tid = threadIdx.x;
  const int n = nfb * K;
  const size_t row = (size_t)v * n_frames + frame0;
  const size_t base = row * K;

  if (tid < fpb) {
    k_last[tid] = 0;
    // up T, rounded as the plain version's decay_time * up.
    t_base[tid] = tid < nfb ? decay_time[row + tid] * (float)up : 0.0f;
  }
  __syncthreads();
  // 1. Controls, log|d| and k_last. With K a multiple of 32 (and blockDim.x
  //    one by construction) a warp's cells lie in one frame: one atomic per
  //    warp.
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
      lds[i] = logf(fabsf(decays[base + i]));
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
  const float t = t_base[fl] + (float)s;
  const float4* c = ctl + fl * K;
  const float* p = p0s + fl * K;
  const float* ld = lds + fl * K;
  const int kl = k_last[fl];
  float a0 = 0.0f, a1 = 0.0f;
  int k = 0;
  for (; k + 1 < kl; k += 2) {
    a0 = decay_term(c[k], p[k], ld[k], t, h, omh, tri, s1, sf, w_scale,
                    nyquist, a0);
    a1 = decay_term(c[k + 1], p[k + 1], ld[k + 1], t, h, omh, tri, s1, sf,
                    w_scale, nyquist, a1);
  }
  if (k < kl) {
    a0 = decay_term(c[k], p[k], ld[k], t, h, omh, tri, s1, sf, w_scale,
                    nyquist, a0);
  }
  out[(row + fl) * up + s] = a0 + a1;
}

// table: the cached OSC_TABLES x up table on the card; decay_time (batch,
// n_frames), the other inputs (batch, n_frames, K).
extern "C" int osc_decay_launch(const float* f_lo, const float* f_hi,
                                const float* a_lo, const float* a_hi,
                                const float* phase0, const float* decays,
                                const float* decay_time, const float* table,
                                float* out, int batch, int n_frames, int K,
                                int up, float w_scale, float nyquist,
                                cudaStream_t stream) {
  const int fpb = OSC_DECAY_FRAMES_PER_BLOCK;
  if (up < 1 || K < 1 || fpb * up > 1024 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  // Whole warps: the warp max names all 32 lanes; lanes past fpb * up idle.
  const int threads = (fpb * up + 31) / 32 * 32;
  const size_t smem = (sizeof(float4) + 2 * sizeof(float)) * fpb * K
                      + (sizeof(float) + sizeof(int)) * fpb;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 49152) {
    cudaError_t err = cudaFuncSetAttribute(
        osc_decay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n_frames + fpb - 1) / fpb, batch);
  osc_decay_kernel<<<grid, threads, smem, stream>>>(
      f_lo, f_hi, a_lo, a_hi, phase0, decays, decay_time, table, out,
      n_frames, K, up, w_scale, nyquist);
  return (int)cudaGetLastError();
}
