// Additive oscillator bank from framewise controls, every partial computed
// (K8).
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
// Every partial is computed: skipping dead ones is K1's design
// (oscillator_skip.cu). Partials at or above Nyquist add exact zeros, as in
// the TPU kernel, which pads K to 128 lanes; nothing is padded here.
//
// Bound on the H100: operations, and before them issue. A term on the
// common walk (below) costs 30 float32 operations (a fused multiply-add
// counts two): phase 5, crossfade 2, the multiply-accumulate 2 and the
// cosine 21 (osc_cos in oscillator_common.cuh: the quotient 5, the
// three-part reduction 6, r^2 1, the polynomial 9); a frame that tests
// Nyquist at every sample adds 3. Against 20 bytes of controls per (frame,
// partial) shared by `up` samples that is far above the card's ~20
// flop/byte balance point for float32 outside the tensor cores. Only 8 of
// the 22 float32 instructions are fused, and each instruction takes an
// issue slot whether it is float32 or not (the cosine's sign, the shared
// loads, the loop), so issue comes first: ~24 instructions a term.
//
// Design. The first version ran one thread a sample over all K partials:
// ~62 instructions a term, of which five scalar shared loads, the
// difference f_hi - f_lo, an unfused accumulate, the loop's address
// arithmetic, and cosf with the branch around its slow path (PERF.md).
// Now:
// - one block per (run of OSC_FULL_FRAMES_PER_BLOCK frames, voice), one
//   warp a frame, lane j rendering samples j, j + 32, ... (NS = up / 32
//   rounded up, a template), so each control read serves NS samples and
//   the stores stay coalesced;
// - the block stages its frames' cells once, (f_lo, f_hi - f_lo, a_lo,
//   a_hi - a_lo) as a float4 and phase0 beside it: two shared loads a
//   cell, both broadcasts to the whole warp; f_hi - f_lo is the plain
//   version's expression, so the phase and the frequency are its values;
// - the per-sample constants (h, tri, s + 1, s / up) stay in registers;
//   4 cells an iteration at up <= 64 (2 above), two accumulators a sample
//   (even and odd k);
// - the staging pass sorts each frame onto one of three walks, a branch
//   uniform in its warp: a partial whose frequency stays at or above
//   Nyquist over the frame is staged silent (a_lo = a_hi - a_lo = 0: its
//   terms are the exact zeros the test gives), so a frame where none
//   crosses Nyquist needs no test; a frame where one crosses tests every
//   sample; a frame whose phases may reach kOscCosRange (|phase0| +
//   w (up |f_lo| + (up - 1) / 2 |f_hi - f_lo|), or not finite) takes cosf
//   with the test. Elsewhere the cosine is osc_cos, within 2 ulp, without
//   cosf's slow-path branch. No input is wrong on any walk.
//
// Built with --fmad=false: the phase and the frequency round as in the
// plain PyTorch version (kernels/oscillator.py, render_framewise
// (trig='native')); the crossfade is one fused a_lo + (a_hi - a_lo) h (an
// ulp from the plain a_lo (1 - h) + a_hi h), the cosine differs from
// torch.cos by its ulps, and the sum over partials runs in another order
// with one rounding a multiply-add. The per-sample tables (h, tri, s + 1,
// s / up) are the wrapper's cached table (oscillator_common.cuh).

#include "oscillator_common.cuh"

#define OSC_FULL_FRAMES_PER_BLOCK 4
#define OSC_FULL_MAX_NS 8              // up <= 32 * 8 = 256

// A frame's walk: the written-out cosine with no Nyquist test (every cell
// wholly below Nyquist, or wholly at or above it and staged silent), the
// written-out cosine with the test at every sample (a cell crosses
// Nyquist within the frame), or cosf with the test (a phase may leave
// osc_cos's range).
enum { OSC_FULL_PLAIN = 0, OSC_FULL_MASKED = 1, OSC_FULL_COSF = 2 };

// One term into acc. c: f_lo, f_hi - f_lo, a_lo, a_hi - a_lo.
template <int kWalk>
__device__ __forceinline__ float osc_full_term(float4 c, float p0, float h,
                                               float tri, float s1, float sf,
                                               float w_scale, float nyquist,
                                               float acc) {
  const float phase = p0 + w_scale * (s1 * c.x + c.y * tri);
  float amp = __fmaf_rn(c.w, h, c.z);
  if (kWalk != OSC_FULL_PLAIN) {
    const float freq = c.x + c.y * sf;
    amp = freq < nyquist ? amp : 0.0f;
  }
  return OSC_MAD(amp, kWalk == OSC_FULL_COSF ? cosf(phase) : osc_cos(phase),
                 acc);
}

// Lane j's samples j + 32 i (i < NS) of one frame over all K partials,
// kU cells an iteration: into a0 (even k) and a1 (odd k).
template <int NS, int kWalk>
__device__ __forceinline__ void osc_full_walk(
    const float4* __restrict__ c, const float* __restrict__ p, int K,
    const float (&h)[NS], const float (&tri)[NS], const float (&s1)[NS],
    const float (&sf)[NS], float w_scale, float nyquist, float (&a0)[NS],
    float (&a1)[NS]) {
  constexpr int kU = NS <= 2 ? 4 : 2;
  int k = 0;
  for (; k + kU <= K; k += kU) {
    float4 cell[kU];
    float p0[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      cell[u] = c[k + u];
      p0[u] = p[k + u];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float& acc = (u & 1) ? a1[i] : a0[i];
        acc = osc_full_term<kWalk>(cell[u], p0[u], h[i], tri[i], s1[i],
                                   sf[i], w_scale, nyquist, acc);
      }
    }
  }
  for (; k < K; ++k) {
    const float4 cell = c[k];
    const float p0 = p[k];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      a0[i] = osc_full_term<kWalk>(cell, p0, h[i], tri[i], s1[i], sf[i],
                                   w_scale, nyquist, a0[i]);
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(32 * OSC_FULL_FRAMES_PER_BLOCK)
osc_full_kernel(const float* __restrict__ f_lo, const float* __restrict__ f_hi,
                const float* __restrict__ a_lo, const float* __restrict__ a_hi,
                const float* __restrict__ phase0,
                const float* __restrict__ table, float* __restrict__ out,
                int n_frames, int K, int up, float w_scale, float nyquist) {
  extern __shared__ float4 sm4[];
  const int fpb = OSC_FULL_FRAMES_PER_BLOCK;
  float4* ctl = sm4;                                         // fpb * K
  float* p0s = reinterpret_cast<float*>(ctl + fpb * K);      // fpb * K
  int* walk = reinterpret_cast<int*>(p0s + fpb * K);         // fpb
  const int v = blockIdx.y;
  const int frame0 = blockIdx.x * fpb;
  const int nfb = min(fpb, n_frames - frame0);
  const int tid = threadIdx.x;
  const int n = nfb * K;
  const size_t base = ((size_t)v * n_frames + frame0) * K;

  if (tid < fpb) walk[tid] = OSC_FULL_PLAIN;
  __syncthreads();
  // 1. The frames' cells and each frame's walk. A cell's frequency
  //    f_lo + (f_hi - f_lo) s / up is monotone in s (each rounding is), so
  //    its first and last samples tell whether it stays below Nyquist,
  //    stays at or above it (staged silent: its terms are exact zeros, as
  //    the test would make them) or crosses it (the frame takes the test).
  //    A frame whose phases may reach kOscCosRange (or are not finite)
  //    takes cosf.
  const float sf_last = table[OSC_T_SF * up + up - 1];
  const float sf_first = table[OSC_T_SF * up];
  const float s1_max = (float)up;
  const float tri_max = 0.5f * (float)(up - 1);
  for (int i = tid; i < n; i += blockDim.x) {
    const float flo = f_lo[base + i];
    const float df = f_hi[base + i] - flo;
    const float p0 = phase0[base + i];
    const bool first = flo + df * sf_first < nyquist;
    const bool last = flo + df * sf_last < nyquist;
    float alo = a_lo[base + i];
    float da = a_hi[base + i] - alo;
    if (!first && !last) alo = da = 0.0f;
    ctl[i] = make_float4(flo, df, alo, da);
    p0s[i] = p0;
    const float reach = fabsf(p0) + w_scale * (s1_max * fabsf(flo)
                                               + tri_max * fabsf(df));
    if (!(reach < kOscCosRange)) {
      atomicOr(&walk[i / K], OSC_FULL_COSF);
    } else if (first != last) {
      atomicOr(&walk[i / K], OSC_FULL_MASKED);
    }
  }
  __syncthreads();

  // 2. Warp fl renders frame fl; lane j its samples j + 32 i.
  const int fl = tid >> 5;
  const int lane = tid & 31;
  if (fl >= nfb) return;
  float h[NS], tri[NS], s1[NS], sf[NS], a0[NS], a1[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int s = lane + 32 * i;
    const bool valid = s < up;
    h[i] = valid ? table[OSC_T_H * up + s] : 0.0f;
    tri[i] = valid ? table[OSC_T_TRI * up + s] : 0.0f;
    s1[i] = valid ? table[OSC_T_S1 * up + s] : 0.0f;
    sf[i] = valid ? table[OSC_T_SF * up + s] : 0.0f;
    a0[i] = 0.0f;
    a1[i] = 0.0f;
  }
  const float4* c = ctl + fl * K;
  const float* p = p0s + fl * K;
  const int mode = walk[fl];
  if (mode & OSC_FULL_COSF) {
    osc_full_walk<NS, OSC_FULL_COSF>(c, p, K, h, tri, s1, sf, w_scale,
                                     nyquist, a0, a1);
  } else if (mode & OSC_FULL_MASKED) {
    osc_full_walk<NS, OSC_FULL_MASKED>(c, p, K, h, tri, s1, sf, w_scale,
                                       nyquist, a0, a1);
  } else {
    osc_full_walk<NS, OSC_FULL_PLAIN>(c, p, K, h, tri, s1, sf, w_scale,
                                      nyquist, a0, a1);
  }
  float* row = out + ((size_t)v * n_frames + frame0 + fl) * up;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int s = lane + 32 * i;
    if (s < up) row[s] = a0[i] + a1[i];
  }
}

template <int NS>
static int osc_full_launch_ns(dim3 grid, size_t smem, const float* f_lo,
                              const float* f_hi, const float* a_lo,
                              const float* a_hi, const float* phase0,
                              const float* table, float* out, int n_frames,
                              int K, int up, float w_scale, float nyquist,
                              cudaStream_t stream) {
  if (smem > 49152) {
    cudaError_t err = cudaFuncSetAttribute(
        osc_full_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  osc_full_kernel<NS><<<grid, 32 * OSC_FULL_FRAMES_PER_BLOCK, smem,
                        stream>>>(f_lo, f_hi, a_lo, a_hi, phase0, table, out,
                                  n_frames, K, up, w_scale, nyquist);
  return (int)cudaGetLastError();
}

// table: the cached OSC_TABLES x up table on the card. The plan
// (kernels/oscillator.py osc_full_plan): frames a block, samples a lane
// and shared bytes, checked against this source's.
extern "C" int osc_full_launch(const float* f_lo, const float* f_hi,
                               const float* a_lo, const float* a_hi,
                               const float* phase0, const float* table,
                               float* out, int batch, int n_frames, int K,
                               int up, float w_scale, float nyquist,
                               int frames_per_block, int samples_per_lane,
                               int smem, cudaStream_t stream) {
  const int fpb = OSC_FULL_FRAMES_PER_BLOCK;
  const int ns = (up + 31) / 32;
  const size_t want = (sizeof(float4) + sizeof(float)) * fpb * K
                      + sizeof(int) * fpb;
  if (up < 1 || ns > OSC_FULL_MAX_NS || K < 1 || n_frames < 1 || batch < 1
      || batch > 65535 || frames_per_block != fpb || samples_per_lane != ns
      || (size_t)smem != want || want > 232448) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((n_frames + fpb - 1) / fpb, batch);
#define OSC_FULL_CASE(N)                                                     \
  case N:                                                                    \
    return osc_full_launch_ns<N>(grid, want, f_lo, f_hi, a_lo, a_hi, phase0, \
                                 table, out, n_frames, K, up, w_scale,       \
                                 nyquist, stream);
  switch (ns) {
    OSC_FULL_CASE(1)
    OSC_FULL_CASE(2)
    OSC_FULL_CASE(3)
    OSC_FULL_CASE(4)
    OSC_FULL_CASE(5)
    OSC_FULL_CASE(6)
    OSC_FULL_CASE(7)
    OSC_FULL_CASE(8)
  }
#undef OSC_FULL_CASE
  return (int)cudaErrorInvalidValue;
}
