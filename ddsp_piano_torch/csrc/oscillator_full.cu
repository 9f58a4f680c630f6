// Additive oscillator bank from framewise controls, every partial computed.
//
// Replaces: ddsp_piano_tpu/kernels/oscillator_pallas.py,
// render_framewise_pallas (_osc_kernel): the round-1 all-partials kernel,
// native cosine, no tile skip and no backward. The JAX package runs it
// under DDSP_PIANO_TPU_PALLAS=1; here MultiInharmonic(oscillator='full').
//
// Work: for voice v, frame f and intra-frame sample s (0 <= s < up),
//   out[v, f*up + s] = sum_{k < K} amp_k(s) * cos(phase_k(s))
//   phase_k(s) = phase0 + w * ((s + 1) f_lo + (f_hi - f_lo) s(s+1)/(2 up))
//   amp_k(s)   = a_lo (1 - h(s)) + a_hi h(s),   h(s) = sin^2(pi s / (2 up))
//   amp_k(s)   = 0 where f_lo + (f_hi - f_lo) s/up >= nyquist
// The TPU kernel pads K to 128 lanes with silent partials; nothing is
// padded here.
//
// Bound on the H100: operations. Each (partial, sample) term costs ~33
// float32 operations (phase 6, crossfade 3, frequency 2, mask 1, cosf's
// fast path ~19: the product by 2/pi, rounding, a three-part Cody-Waite
// reduction, a degree-4 polynomial and the quadrant's sign; accumulate 2)
// against 20 bytes of controls per (frame, partial) shared by `up`
// samples, far above the card's ~20 flop/byte balance point for float32
// outside the tensor cores.
//
// Design (simple and right first): one block per (voice, run of FPB
// frames); thread (frame, s) renders one output sample and loops over all
// K partials. The block stages its frames' five control rows in shared
// memory (coalesced loads), and every thread reads them as broadcasts.
// The cosine is the accurate cosf (phases reach ~300 rad, where __cosf's
// error grows), with no --use_fast_math.
//
// Built with --fmad=false: every operation of the term rounds as in the
// plain PyTorch version (kernels/oscillator.py, render_framewise(trig=
// 'native')), so each term is the plain version's and only the order of
// the sum over partials differs. The per-sample tables (h, s(s+1)/(2 up),
// s + 1, s/up) are computed once by the wrapper with the plain version's
// own expressions.

#include <cuda_runtime.h>

#define OSC_FULL_FRAMES_PER_BLOCK 4

__global__ void osc_full_kernel(const float* __restrict__ f_lo,
                                const float* __restrict__ f_hi,
                                const float* __restrict__ a_lo,
                                const float* __restrict__ a_hi,
                                const float* __restrict__ phase0,
                                const float* __restrict__ table,
                                float* __restrict__ out,
                                int n_frames, int K, int up,
                                float w_scale, float nyquist) {
  extern __shared__ float sm[];
  const int fpb = OSC_FULL_FRAMES_PER_BLOCK;
  const int v = blockIdx.y;
  const int frame0 = blockIdx.x * fpb;
  const int nfb = min(fpb, n_frames - frame0);
  const int tid = threadIdx.x;
  const int n = nfb * K;
  const size_t base = ((size_t)v * n_frames + frame0) * K;
  float* s_flo = sm;
  float* s_fhi = s_flo + fpb * K;
  float* s_alo = s_fhi + fpb * K;
  float* s_ahi = s_alo + fpb * K;
  float* s_ph0 = s_ahi + fpb * K;

  for (int i = tid; i < n; i += blockDim.x) {
    s_flo[i] = f_lo[base + i];
    s_fhi[i] = f_hi[base + i];
    s_alo[i] = a_lo[base + i];
    s_ahi[i] = a_hi[base + i];
    s_ph0[i] = phase0[base + i];
  }
  __syncthreads();

  const int fl = tid / up;
  const int s = tid - fl * up;
  if (fl >= nfb) return;
  const float h = table[s];
  const float tri = table[up + s];
  const float s1 = table[2 * up + s];
  const float s_frac = table[3 * up + s];
  const float one_minus_h = 1.0f - h;
  const int off = fl * K;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float flo = s_flo[off + k];
    const float df = s_fhi[off + k] - flo;
    const float phase = s_ph0[off + k] + w_scale * (s1 * flo + df * tri);
    float amp = s_alo[off + k] * one_minus_h + s_ahi[off + k] * h;
    const float freq = flo + df * s_frac;
    amp = freq < nyquist ? amp : 0.0f;
    acc += amp * cosf(phase);
  }
  out[(size_t)v * n_frames * up + (size_t)(frame0 + fl) * up + s] = acc;
}

extern "C" int osc_full_launch(const float* f_lo, const float* f_hi,
                               const float* a_lo, const float* a_hi,
                               const float* phase0, const float* table,
                               float* out, int batch, int n_frames, int K,
                               int up, float w_scale, float nyquist,
                               cudaStream_t stream) {
  const int fpb = OSC_FULL_FRAMES_PER_BLOCK;
  const int threads = fpb * up;
  if (threads > 1024 || batch > 65535 || K < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 5 * fpb * K;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 49152) {
    cudaError_t err = cudaFuncSetAttribute(
        osc_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n_frames + fpb - 1) / fpb, batch);
  osc_full_kernel<<<grid, threads, smem, stream>>>(
      f_lo, f_hi, a_lo, a_hi, phase0, table, out, n_frames, K, up, w_scale,
      nyquist);
  return (int)cudaGetLastError();
}
