// Backward of the additive oscillator bank: the five control gradients.
//
// Replaces: ddsp_piano_tpu/kernels/oscillator_pallas.py,
// render_framewise_pallas_skip_vjp (_osc_skip_bwd_kernel, reduce='vpu',
// with the degree-4 gradient trig 'poly4' of _sincos): the gradient of the
// additive synth on the v2 training path.
//
// Work: for voice v, frame f and partial k, with the audio cotangent
// g[v, f*up + s] and, per intra-frame sample s (0 <= s < up),
//   phase = phase0 + w ((s + 1) f_lo + (f_hi - f_lo) s(s+1)/(2 up))
//   mask  = f_lo + (f_hi - f_lo) s/up < nyquist
//   amp   = mask ? a_lo (1 - h(s)) + a_hi h(s) : 0
//   gc    = g mask cos(phase);   gs = g amp (-sin(phase))
// the five sums over the frame's up samples
//   d a_lo = sum gc (1 - h)      d a_hi = sum gc h       d phase0 = sum gs
//   d f_lo = sum gs w ((s + 1) - s(s+1)/(2 up))   d f_hi = sum gs w s(s+1)/(2 up)
// (oscillator_pallas.py:430-454). The skip predicate is Nyquist only, as on
// the TPU: a partial whose frequency is at or above Nyquist over the whole
// frame (min(f_lo, f_hi) >= nyquist) has exactly zero gradient, but a
// silent partial below Nyquist still has amplitude gradients. k_last(v, f)
// is one past the frame's last partial below Nyquist; partials past it get
// zeros without computing.
//
// Bound on the H100: operations. Each computed (partial, sample) costs ~50
// float32 operations (phase, mask, crossfade, range reduction, two degree-4
// polynomials, the two cotangents and five multiply-accumulates) against
// 40 bytes of controls and gradients per (frame, partial) shared by `up`
// samples. Silent voices hold f0 = midi_to_hz(0) ~ 8 Hz, so all their
// partials lie below Nyquist and are computed: the backward skips far less
// than the forward does.
//
// Design: one block per (voice, run of FPB frames); thread (frame, k) owns
// one (frame, partial) cell and walks the frame's up samples, keeping the
// five sums in registers. The frame's cotangent row and the per-sample
// tables sit in shared memory and every lane of a warp reads the same
// sample at once (a broadcast); the controls are loaded and the gradients
// stored coalesced over partials. Partials are warp-contiguous, so whole
// warps past k_last exit together. The trig is Cody-Waite reduction by a
// two-part 2 pi, then the degree-4 _SIN4/_COS4 polynomials.
//
// Built with --fmad=false: every operation rounds as in the plain PyTorch
// version (ops/oscillator.py render_framewise_vjp, trig='poly4'), so each
// term equals the plain version's and only the order of the up-sample sums
// differs. The per-sample tables (h, s(s+1)/(2 up), s + 1, s/up and the two
// frequency weights) are computed by the wrapper with the plain version's
// own expressions.

#include <cuda_runtime.h>

#define OSC_BWD_MAX_FRAMES_PER_BLOCK 4
#define OSC_BWD_TABLES 6

__device__ __forceinline__ void sincos_poly4(float phi, float* s, float* c) {
  const float inv_2pi = 0.15915494309189535f;
  const float two_pi_hi = 6.28125f;
  const float two_pi_lo = 0.0019353071795864769f;
  const float n = rintf(phi * inv_2pi);
  float xr = phi - n * two_pi_hi;
  xr = xr - n * two_pi_lo;
  const float x = xr * inv_2pi;
  const float t = x * x;
  float sa = 3.381005338e+01f;
  sa = sa * t + -7.503236765e+01f;
  sa = sa * t + 8.146544324e+01f;
  sa = sa * t + -4.133763108e+01f;
  sa = sa * t + 6.283166561e+00f;
  float ca = 4.606319347e+01f;
  ca = ca * t + -8.259851900e+01f;
  ca = ca * t + 6.470140570e+01f;
  ca = ca * t + -1.973229255e+01f;
  ca = ca * t + 9.999681959e-01f;
  *s = x * sa;
  *c = ca;
}

__global__ void osc_skip_bwd_kernel(const float* __restrict__ f_lo,
                                    const float* __restrict__ f_hi,
                                    const float* __restrict__ a_lo,
                                    const float* __restrict__ a_hi,
                                    const float* __restrict__ phase0,
                                    const float* __restrict__ g,
                                    const float* __restrict__ table,
                                    float* __restrict__ grads,
                                    int B, int n_frames, int K, int up,
                                    int fpb, float w_scale, float nyquist) {
  extern __shared__ float sm[];
  const int v = blockIdx.y;
  const int frame0 = blockIdx.x * fpb;
  const int nfb = min(fpb, n_frames - frame0);
  const int tid = threadIdx.x;
  float* g_s = sm;                                   // fpb * up
  float* tab = g_s + fpb * up;                       // 6 * up
  int* k_last = (int*)(tab + OSC_BWD_TABLES * up);   // fpb

  if (tid < fpb) k_last[tid] = 0;
  const float* g_row = g + ((size_t)v * n_frames + frame0) * up;
  for (int i = tid; i < nfb * up; i += blockDim.x) g_s[i] = g_row[i];
  for (int i = tid; i < OSC_BWD_TABLES * up; i += blockDim.x) {
    tab[i] = table[i];
  }
  const int fl = tid / K;
  const int k = tid - fl * K;
  const bool in_range = fl < nfb;
  const size_t idx = ((size_t)v * n_frames + frame0 + fl) * K + k;
  float flo = 0.0f, fhi = 0.0f, alo = 0.0f, ahi = 0.0f, p0 = 0.0f;
  if (in_range) {
    flo = f_lo[idx];
    fhi = f_hi[idx];
    alo = a_lo[idx];
    ahi = a_hi[idx];
    p0 = phase0[idx];
  }
  __syncthreads();
  if (in_range && fminf(flo, fhi) < nyquist) atomicMax(&k_last[fl], k + 1);
  __syncthreads();
  if (!in_range) return;

  float d_flo = 0.0f, d_fhi = 0.0f, d_alo = 0.0f, d_ahi = 0.0f, d_p0 = 0.0f;
  if (k < k_last[fl]) {
    const float* h_t = tab;
    const float* tri_t = tab + up;
    const float* s1_t = tab + 2 * up;
    const float* sf_t = tab + 3 * up;
    const float* wlo_t = tab + 4 * up;
    const float* whi_t = tab + 5 * up;
    const float* gf = g_s + fl * up;
    const float df = fhi - flo;
    for (int s = 0; s < up; ++s) {
      const float h = h_t[s];
      const float one_minus_h = 1.0f - h;
      const float phase = p0 + w_scale * (s1_t[s] * flo + df * tri_t[s]);
      const float freq = flo + df * sf_t[s];
      const bool mask = freq < nyquist;
      const float amp = mask ? alo * one_minus_h + ahi * h : 0.0f;
      float sn, cs;
      sincos_poly4(phase, &sn, &cs);
      const float gv = gf[s];
      const float gc = gv * (mask ? cs : 0.0f);
      const float gs = gv * amp * (-sn);
      d_flo += gs * wlo_t[s];
      d_fhi += gs * whi_t[s];
      d_alo += gc * one_minus_h;
      d_ahi += gc * h;
      d_p0 += gs;
    }
  }
  const size_t plane = (size_t)B * n_frames * K;
  grads[idx] = d_flo;
  grads[plane + idx] = d_fhi;
  grads[2 * plane + idx] = d_alo;
  grads[3 * plane + idx] = d_ahi;
  grads[4 * plane + idx] = d_p0;
}

extern "C" int osc_skip_bwd_launch(const float* f_lo, const float* f_hi,
                                   const float* a_lo, const float* a_hi,
                                   const float* phase0, const float* g,
                                   const float* table, float* grads,
                                   int batch, int n_frames, int K, int up,
                                   float w_scale, float nyquist,
                                   cudaStream_t stream) {
  if (K < 1 || K > 1024 || batch > 65535) return (int)cudaErrorInvalidValue;
  int fpb = 1024 / K;
  if (fpb > OSC_BWD_MAX_FRAMES_PER_BLOCK) fpb = OSC_BWD_MAX_FRAMES_PER_BLOCK;
  const int threads = fpb * K;
  const size_t smem = sizeof(float) * (fpb + OSC_BWD_TABLES) * up
                      + sizeof(int) * fpb;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 49152) {
    cudaError_t err = cudaFuncSetAttribute(
        osc_skip_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n_frames + fpb - 1) / fpb, batch);
  osc_skip_bwd_kernel<<<grid, threads, smem, stream>>>(
      f_lo, f_hi, a_lo, a_hi, phase0, g, table, grads, batch, n_frames, K,
      up, fpb, w_scale, nyquist);
  return (int)cudaGetLastError();
}
