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
// the TPU (:496-501): a partial at or above Nyquist over the whole frame
// (min(f_lo, f_hi) >= nyquist) has exactly zero gradient; a silent partial
// below Nyquist still has amplitude gradients.
//
// Bound on the H100: issued instructions. The data are 40 bytes per
// (frame, partial) cell, shared by `up` samples; the work is ~50 float32
// operations per (cell, sample), and this build cannot fuse the phase and
// the range reduction (one ulp of a 300 rad phase shows in the gradients),
// so the FP32 pipes' issue rate, not the bytes and not the fused-FLOP peak,
// is the floor. What the design does about it:
//
// - Silent cells take a path of their own. A voice with no note holds
//   f0 = midi_to_hz(0) ~ 8 Hz, so all its partials lie below Nyquist, and
//   InHarmonic's (f0 > 20 Hz) gate makes a_lo = a_hi = 0 exactly: most
//   computed cells are silent. There gs = g * 0 * (-sin) is a signed zero
//   for every finite g and finite controls, so d f_lo, d f_hi and d phase0
//   are sums of signed zeros, which equal 0: the kernel stores 0 for them
//   and computes only the phase, the range reduction, the degree-4 cosine,
//   the mask, gc and the two amplitude sums. For a non-finite g the plain
//   version gives NaN there and the kernel 0; the trainer's NaN guard sees
//   a non-finite g through the other gradients of the step. Partials sit
//   on lanes and a warp holds one frame's partials (K a multiple of 32), so
//   a silent frame of a voice is warp-uniform; the path is chosen per warp
//   by a vote, and a warp with one sounding lane takes the full path (its
//   silent lanes' gs are then signed zeros, as in the plain version).
// - Per-sample tables are operands, not loads. For the shipped rates (up =
//   96: maestro_v2, dafx22_24khz; up = 64: dafx22) the sample loop is
//   unrolled over a compile-time `up` and the seven tables arrive as a
//   __grid_constant__ parameter, sample-major (OscTables), so h, 1 - h,
//   tri, s + 1, s/up and the two weights are constant-bank reads at fixed
//   offsets: on sm_90 ptxas turns them into ULDC (mostly 64-bit, two
//   values a read) into uniform registers that the arithmetic takes as
//   operands, ~2 a sample and no memory load (chip_kernel_ab.py counts
//   them in the SASS). g is read from shared memory four samples at a time
//   (one broadcast load). Any other `up` takes a generic instance that
//   reads the tables from memory.
// - The Horner chains and the sums' multiply-adds round once
//   (oscillator_common.cuh); the phase, frequency and reduction do not.
// - Blocks are (run of 4 frames, voice), runs fastest: the voice allocator
//   fills the low voices first, so the sounding (longer) blocks are
//   scheduled first and the rest fill in behind them.
// - One thread per (frame, partial) cell keeps the five sums in registers:
//   no cross-thread reduction. The unrolled samples are independent work
//   for the scheduler. The TPU kernel's reduce='mxu' arm (the up-sums as
//   matrix products) has no sound counterpart here: TF32 keeps ~3 digits,
//   and float32 matrix products would not beat five register sums.

#include "oscillator_common.cuh"

#define OSC_BWD_MAX_FRAMES_PER_BLOCK 4

struct OscCell {
  float flo, df, alo, ahi, p0;
};

// One sample's terms, added to the five sums d = (d f_lo, d f_hi, d a_lo,
// d a_hi, d phase0). SOUNDING false: the silent path (d[0], d[1], d[4]
// untouched).
template <bool SOUNDING>
__device__ __forceinline__ void bwd_sample(float h, float tri, float s1,
                                           float sf, float omh, float wlo,
                                           float whi, float gv,
                                           const OscCell& c, float w_scale,
                                           float nyquist, float (&d)[5]) {
  const float phase = c.p0 + w_scale * (s1 * c.flo + c.df * tri);
  const bool mask = c.flo + c.df * sf < nyquist;
  const float x = osc_range_reduce(phase);
  const float t = x * x;
  // The cosine is computed whatever the mask, then selected: a branch per
  // sample would cut the unrolled samples into blocks the compiler cannot
  // interleave.
  float cs = osc_cos4(t);
  asm("" : "+f"(cs));
  const float gc = gv * (mask ? cs : 0.0f);
  d[2] = OSC_MAD(gc, omh, d[2]);
  d[3] = OSC_MAD(gc, h, d[3]);
  if (SOUNDING) {
    float amp = c.alo * omh + c.ahi * h;
    amp = mask ? amp : 0.0f;
    const float gs = gv * amp * (-osc_sin4(x, t));
    d[0] = OSC_MAD(gs, wlo, d[0]);
    d[1] = OSC_MAD(gs, whi, d[1]);
    d[4] += gs;
  }
}

// A frame's up samples with the tables as constant-bank operands.
template <int UP, bool SOUNDING>
__device__ __forceinline__ void bwd_frame(const OscTables<UP>& tab,
                                          const float* gf, const OscCell& c,
                                          float w_scale, float nyquist,
                                          float (&d)[5]) {
#pragma unroll
  for (int s0 = 0; s0 < UP; s0 += 4) {
    const float4 g4 = *reinterpret_cast<const float4*>(gf + s0);
    const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const OscSample& e = tab.v[s0 + i];
      bwd_sample<SOUNDING>(e.h, e.tri, e.s1, e.sf, e.omh, e.wlo, e.whi,
                           gv[i], c, w_scale, nyquist, d);
    }
  }
}

// The same with a runtime up and the tables read from device memory (every
// lane of a warp reads one address: a broadcast from the cache).
template <bool SOUNDING>
__device__ __forceinline__ void bwd_frame_generic(const float* tab, int up,
                                                  const float* gf,
                                                  const OscCell& c,
                                                  float w_scale,
                                                  float nyquist,
                                                  float (&d)[5]) {
  for (int s = 0; s < up; ++s) {
    bwd_sample<SOUNDING>(tab[OSC_T_H * up + s], tab[OSC_T_TRI * up + s],
                         tab[OSC_T_S1 * up + s], tab[OSC_T_SF * up + s],
                         tab[OSC_T_OMH * up + s], tab[OSC_T_WLO * up + s],
                         tab[OSC_T_WHI * up + s], gf[s], c, w_scale, nyquist,
                         d);
  }
}

struct BwdArgs {
  const float* f_lo;
  const float* f_hi;
  const float* a_lo;
  const float* a_hi;
  const float* phase0;
  const float* g;
  float* grads;
  int n_frames, K, up, fpb;
  size_t plane;
  float w_scale, nyquist;
};

// Thread (fl, k) of block (frame run, voice): stage the frames' cotangent
// rows in g_s, load the cell's controls and vote, per warp, whether any
// lane is below Nyquist (compute) and whether any such lane sounds.
struct BwdThread {
  OscCell c;
  size_t idx;
  int fl;
  bool in_range, compute, sounding;
};

__device__ __forceinline__ BwdThread bwd_prologue(const BwdArgs& a,
                                                  float* g_s) {
  const int v = blockIdx.y;
  const int frame0 = blockIdx.x * a.fpb;
  const int nfb = min(a.fpb, a.n_frames - frame0);
  const int tid = threadIdx.x;
  const float* g_row = a.g + ((size_t)v * a.n_frames + frame0) * a.up;
  for (int i = tid; i < nfb * a.up; i += blockDim.x) g_s[i] = g_row[i];
  BwdThread t;
  t.fl = tid / a.K;
  const int k = tid - t.fl * a.K;
  t.in_range = t.fl < nfb;
  t.idx = ((size_t)v * a.n_frames + frame0 + t.fl) * a.K + k;
  float flo = 0.0f, fhi = 0.0f, alo = 0.0f, ahi = 0.0f, p0 = 0.0f;
  if (t.in_range) {
    flo = a.f_lo[t.idx];
    fhi = a.f_hi[t.idx];
    alo = a.a_lo[t.idx];
    ahi = a.a_hi[t.idx];
  }
  const bool audible = t.in_range && fminf(flo, fhi) < a.nyquist;
  t.compute = __any_sync(0xffffffffu, audible);
  t.sounding = __any_sync(0xffffffffu,
                          audible && (alo != 0.0f || ahi != 0.0f));
  if (t.in_range && t.compute) p0 = a.phase0[t.idx];
  t.c = OscCell{flo, fhi - flo, alo, ahi, p0};
  __syncthreads();
  return t;
}

__device__ __forceinline__ void bwd_store(const BwdArgs& a,
                                          const BwdThread& t,
                                          const float (&d)[5]) {
  if (!t.in_range) return;
#pragma unroll
  for (int i = 0; i < 5; ++i) a.grads[i * a.plane + t.idx] = d[i];
}

// Block (run of fpb frames, voice), runs fastest: the voice allocator
// fills the low voices first, so the sounding voices' blocks (the longer
// ones) are scheduled first.
template <int UP>
__global__ void __launch_bounds__(1024)
osc_skip_bwd_kernel(const BwdArgs a,
                    const __grid_constant__ OscTables<UP> tab) {
  __shared__ __align__(16) float g_s[OSC_BWD_MAX_FRAMES_PER_BLOCK * UP];
  const BwdThread t = bwd_prologue(a, g_s);
  float d[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (t.in_range && t.compute) {
    const float* gf = g_s + t.fl * UP;
    if (t.sounding) {
      bwd_frame<UP, true>(tab, gf, t.c, a.w_scale, a.nyquist, d);
    } else {
      bwd_frame<UP, false>(tab, gf, t.c, a.w_scale, a.nyquist, d);
    }
  }
  bwd_store(a, t, d);
}

__global__ void __launch_bounds__(1024)
osc_skip_bwd_generic_kernel(const BwdArgs a, const float* __restrict__ table) {
  extern __shared__ float g_dyn[];             // fpb * up
  const BwdThread t = bwd_prologue(a, g_dyn);
  float d[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (t.in_range && t.compute) {
    const float* gf = g_dyn + t.fl * a.up;
    if (t.sounding) {
      bwd_frame_generic<true>(table, a.up, gf, t.c, a.w_scale, a.nyquist, d);
    } else {
      bwd_frame_generic<false>(table, a.up, gf, t.c, a.w_scale, a.nyquist,
                               d);
    }
  }
  bwd_store(a, t, d);
}

template <int UP>
static int launch_unrolled(const BwdArgs& a, const float* table_host,
                           dim3 grid, int threads, cudaStream_t stream) {
  OscTables<UP> tab;
  osc_tables_from_rows<UP>(&tab, table_host);
  osc_skip_bwd_kernel<UP><<<grid, threads, 0, stream>>>(a, tab);
  return (int)cudaGetLastError();
}

// table_dev / table_host: the OSC_TABLES x up table on the card and its
// copy in host memory (the unrolled instances take it by value).
extern "C" int osc_skip_bwd_launch(const float* f_lo, const float* f_hi,
                                   const float* a_lo, const float* a_hi,
                                   const float* phase0, const float* g,
                                   const float* table_dev,
                                   const float* table_host, float* grads,
                                   int batch, int n_frames, int K, int up,
                                   float w_scale, float nyquist,
                                   cudaStream_t stream) {
  if (K < 1 || K > 1024 || up < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  int fpb = 1024 / K;
  if (fpb > OSC_BWD_MAX_FRAMES_PER_BLOCK) fpb = OSC_BWD_MAX_FRAMES_PER_BLOCK;
  // Whole warps: the votes name all 32 lanes; lanes past fpb * K idle.
  const int threads = (fpb * K + 31) / 32 * 32;
  const BwdArgs a{f_lo, f_hi, a_lo, a_hi, phase0, g, grads, n_frames, K, up,
                  fpb, (size_t)batch * n_frames * K, w_scale, nyquist};
  const dim3 grid((n_frames + fpb - 1) / fpb, batch);
  if (up == 96) {
    return launch_unrolled<96>(a, table_host, grid, threads, stream);
  }
  if (up == 64) {
    return launch_unrolled<64>(a, table_host, grid, threads, stream);
  }
  const size_t smem = sizeof(float) * fpb * up;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 49152) {
    cudaError_t err = cudaFuncSetAttribute(
        osc_skip_bwd_generic_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  osc_skip_bwd_generic_kernel<<<grid, threads, smem, stream>>>(a, table_dev);
  return (int)cudaGetLastError();
}
