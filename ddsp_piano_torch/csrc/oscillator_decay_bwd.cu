// Backward of the additive oscillator bank with decaying partials (K11):
// the five control gradients, and those of the decays and of the frames
// since the last onset.
//
// Replaces: autograd of the surrogate synth's plain render
// (ddsp_piano_tpu/processors/surrogate.py render_framewise_decay, jnp:
// the JAX package differentiates it with jax.grad).
//
// Work: for voice v, frame f and partial k, with the audio cotangent
// g[v, f*up + s] and, per intra-frame sample s (0 <= s < up),
//   t     = up T + s,  e = exp(log|d| t)   (T = decay_time[v, f], d the
//                                           cell's decay)
//   phase = phase0 + w ((s + 1) f_lo + (f_hi - f_lo) s(s+1)/(2 up))
//   mask  = f_lo + (f_hi - f_lo) s/up < nyquist
//   amp   = mask ? a_lo (1 - h(s)) + a_hi h(s) : 0
//   ge    = g e,  gc = mask ? ge cos(phase) : 0,  gs = -ge amp sin(phase),
//   q     = gc amp
// the seven sums over the frame's up samples
//   d a_lo = sum gc (1 - h)    d a_hi = sum gc h      d phase0 = sum gs
//   d f_lo = sum gs w ((s + 1) - tri)                 d f_hi = sum gs w tri
//   d decays = (sum q t) / d   and, a cell's share of d T,
//   log|d| sum q, which the wrapper sums over the partials and scales by up
// (kernels/oscillator_decay.py; the plain version is ops/oscillator.py
// render_framewise_decay_vjp). The skip predicate is K4's: a partial at or
// above Nyquist over the whole frame has exactly zero gradient.
//
// Bound on the H100: issued instructions, K4's ~50 a sounding (cell,
// sample) and ~30 a silent one, plus the envelope (a multiply-add and an
// exp) and, on sounding cells, the two decay sums. Trig: sincosf, the
// plain version's torch.sin and torch.cos to a few ulp (no range past
// ~210 rad here, so no slow path).
//
// Design: K4's generic kernel. One block per (run of up to 4 frames,
// voice), runs fastest; one thread per (frame, partial) cell keeps its
// seven sums in registers. The frames' cotangent rows and the per-sample
// table sit in shared memory (broadcast reads). Silent cells (both
// amplitudes 0, most of them: voices with no note) take a path of their
// own, chosen per warp by a vote as in K4: gs and q are signed zeros there
// for finite g, so d f_lo, d f_hi, d phase0, d decays and the d T share
// are stored as 0 and only the two amplitude sums are computed.
// Rounding: built with --fmad=false; the sums' multiply-adds fused
// (oscillator_common.cuh).

#include "oscillator_common.cuh"

#define OSC_DECAY_BWD_MAX_FRAMES_PER_BLOCK 4
#define OSC_DECAY_GRADS 7

struct DecayCell {
  float flo, df, alo, ahi, p0, ld, tb;
};

struct DecayBwdArgs {
  const float* f_lo;
  const float* f_hi;
  const float* a_lo;
  const float* a_hi;
  const float* phase0;
  const float* decays;
  const float* decay_time;
  const float* g;
  float* grads;
  int n_frames, K, up, fpb;
  size_t plane;
  float w_scale, nyquist;
};

// One frame's up samples, added to the sums d = (d f_lo, d f_hi, d a_lo,
// d a_hi, d phase0, sum q t, sum q). SOUNDING false: the silent path
// (d[0], d[1], d[4], d[5], d[6] untouched).
template <bool SOUNDING>
__device__ __forceinline__ void decay_bwd_frame(const float* tab, int up,
                                                const float* gf,
                                                const DecayCell& c,
                                                float w_scale, float nyquist,
                                                float (&d)[OSC_DECAY_GRADS]) {
  for (int s = 0; s < up; ++s) {
    const float h = tab[OSC_T_H * up + s];
    const float tri = tab[OSC_T_TRI * up + s];
    const float s1 = tab[OSC_T_S1 * up + s];
    const float sf = tab[OSC_T_SF * up + s];
    const float omh = tab[OSC_T_OMH * up + s];
    const float t = c.tb + (float)s;
    const float ge = gf[s] * expf(c.ld * t);
    const float phase = c.p0 + w_scale * (s1 * c.flo + c.df * tri);
    const bool mask = c.flo + c.df * sf < nyquist;
    float sn, cs;
    sincosf(phase, &sn, &cs);
    const float gc = mask ? ge * cs : 0.0f;
    d[2] = OSC_MAD(gc, omh, d[2]);
    d[3] = OSC_MAD(gc, h, d[3]);
    if (SOUNDING) {
      float amp = c.alo * omh + c.ahi * h;
      amp = mask ? amp : 0.0f;
      const float gs = ge * amp * (-sn);
      const float q = gc * amp;
      d[0] = OSC_MAD(gs, tab[OSC_T_WLO * up + s], d[0]);
      d[1] = OSC_MAD(gs, tab[OSC_T_WHI * up + s], d[1]);
      d[4] += gs;
      d[5] = OSC_MAD(q, t, d[5]);
      d[6] += q;
    }
  }
}

__global__ void __launch_bounds__(1024)
osc_decay_bwd_kernel(const DecayBwdArgs a, const float* __restrict__ table) {
  extern __shared__ float smem[];
  float* g_s = smem;                                   // fpb * up
  float* tab = smem + a.fpb * a.up;                    // OSC_TABLES * up
  const int v = blockIdx.y;
  const int frame0 = blockIdx.x * a.fpb;
  const int nfb = min(a.fpb, a.n_frames - frame0);
  const int tid = threadIdx.x;
  const size_t row = (size_t)v * a.n_frames + frame0;
  const float* g_row = a.g + row * a.up;
  for (int i = tid; i < nfb * a.up; i += blockDim.x) g_s[i] = g_row[i];
  for (int i = tid; i < OSC_TABLES * a.up; i += blockDim.x) tab[i] = table[i];

  const int fl = tid / a.K;
  const int k = tid - fl * a.K;
  const bool in_range = fl < nfb;
  const size_t idx = (row + fl) * a.K + k;
  DecayCell c{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float flo = 0.0f, fhi = 0.0f;
  if (in_range) {
    flo = a.f_lo[idx];
    fhi = a.f_hi[idx];
    c.alo = a.a_lo[idx];
    c.ahi = a.a_hi[idx];
  }
  const bool audible = in_range && fminf(flo, fhi) < a.nyquist;
  const bool compute = __any_sync(0xffffffffu, audible);
  const bool sounding = __any_sync(
      0xffffffffu, audible && (c.alo != 0.0f || c.ahi != 0.0f));
  float dec = 1.0f;
  if (in_range && compute) {
    c.p0 = a.phase0[idx];
    dec = a.decays[idx];
    c.ld = logf(fabsf(dec));
    // up T, rounded as the plain version's decay_time * up.
    c.tb = a.decay_time[row + fl] * (float)a.up;
  }
  c.flo = flo;
  c.df = fhi - flo;
  __syncthreads();

  float d[OSC_DECAY_GRADS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (in_range && compute) {
    const float* gf = g_s + fl * a.up;
    if (sounding) {
      decay_bwd_frame<true>(tab, a.up, gf, c, a.w_scale, a.nyquist, d);
    } else {
      decay_bwd_frame<false>(tab, a.up, gf, c, a.w_scale, a.nyquist, d);
    }
  }
  if (!in_range) return;
  float* out = a.grads + idx;
  out[0] = d[0];
  out[a.plane] = d[1];
  out[2 * a.plane] = d[2];
  out[3 * a.plane] = d[3];
  out[4 * a.plane] = d[4];
  out[5 * a.plane] = d[5] / dec;
  out[6 * a.plane] = c.ld * d[6];
}

// table: the cached OSC_TABLES x up table on the card; decay_time (batch,
// n_frames), g (batch, n_frames * up), the other inputs (batch, n_frames,
// K); grads: OSC_DECAY_GRADS planes of (batch, n_frames, K).
extern "C" int osc_decay_bwd_launch(const float* f_lo, const float* f_hi,
                                    const float* a_lo, const float* a_hi,
                                    const float* phase0, const float* decays,
                                    const float* decay_time, const float* g,
                                    const float* table, float* grads,
                                    int batch, int n_frames, int K, int up,
                                    float w_scale, float nyquist,
                                    cudaStream_t stream) {
  if (K < 1 || K > 1024 || up < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  int fpb = 1024 / K;
  if (fpb > OSC_DECAY_BWD_MAX_FRAMES_PER_BLOCK) {
    fpb = OSC_DECAY_BWD_MAX_FRAMES_PER_BLOCK;
  }
  // Whole warps: the votes name all 32 lanes; lanes past fpb * K idle.
  const int threads = (fpb * K + 31) / 32 * 32;
  const DecayBwdArgs a{f_lo, f_hi, a_lo, a_hi, phase0, decays, decay_time, g,
                       grads, n_frames, K, up, fpb,
                       (size_t)batch * n_frames * K, w_scale, nyquist};
  const dim3 grid((n_frames + fpb - 1) / fpb, batch);
  const size_t smem = sizeof(float) * (fpb + OSC_TABLES) * up;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 49152) {
    cudaError_t err = cudaFuncSetAttribute(
        osc_decay_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  osc_decay_bwd_kernel<<<grid, threads, smem, stream>>>(a, table);
  return (int)cudaGetLastError();
}
