// Shared by the oscillator kernels: the skipping oscillator's forward
// (oscillator_skip.cu, K1) and backward (oscillator_skip_bwd.cu, K4) and
// the all-partials forward (oscillator_full.cu, K8). The per-sample
// tables, the TPU kernels' trig contract (ddsp_piano_tpu/kernels/
// oscillator_pallas.py _range_reduce, _COS6, _SIN4/_COS4) for K1 and K4,
// and for K8 a cosine as accurate as cosf (osc_cos).
//
// Rounding. Both sources are built with --fmad=false, so every operation
// written as a * b + c rounds twice, as the plain PyTorch versions do. The
// phase, the frequency, the crossfade and the Cody-Waite range reduction are
// written that way: one ulp of a 300 rad phase is 3e-5 rad, which the
// gradient checks would see. The Horner chains and the multiply-accumulates
// of the sums use OSC_MAD, one rounding each: there a term moves by an ulp
// of a value below 1, less than the other order of the sums already moves
// the result, and within OSC_TOL / OSC_BWD_TOL (1e-5 of peak).

#pragma once

#include <cuda_runtime.h>

#define OSC_MAD(a, b, c) __fmaf_rn((a), (b), (c))

// Rows of the per-sample table, each `up` floats, computed on the card by
// ops/oscillator.py sample_tables / gradient_tables (bit for bit the plain
// version's values): h = sin^2(pi s / (2 up)), tri = s(s+1)/(2 up), s + 1,
// s / up (the four rows oscillator_full.cu reads too), 1 - h, and the
// frequency weights w ((s + 1) - tri), w tri (kernels/oscillator.py
// osc_tables).
enum { OSC_T_H = 0, OSC_T_TRI, OSC_T_S1, OSC_T_SF, OSC_T_OMH, OSC_T_WLO,
       OSC_T_WHI, OSC_TABLES };

// The table as a kernel parameter (__grid_constant__), for a compile-time
// `up`, sample-major: the values one sample needs lie side by side, so
// pairs of them load as one 64-bit constant read, and a read at a constant
// index is a constant-bank read, not a memory load.
struct OscSample {
  float s1, tri, sf, h, omh, pad, wlo, whi;
};

template <int UP>
struct OscTables {
  OscSample v[UP];
};

// Fill an OscTables from the row-major host copy of the table.
template <int UP>
inline void osc_tables_from_rows(OscTables<UP>* t, const float* rows) {
  for (int s = 0; s < UP; ++s) {
    OscSample& o = t->v[s];
    o.s1 = rows[OSC_T_S1 * UP + s];
    o.tri = rows[OSC_T_TRI * UP + s];
    o.sf = rows[OSC_T_SF * UP + s];
    o.h = rows[OSC_T_H * UP + s];
    o.omh = rows[OSC_T_OMH * UP + s];
    o.pad = 0.0f;
    o.wlo = rows[OSC_T_WLO * UP + s];
    o.whi = rows[OSC_T_WHI * UP + s];
  }
}

// phi / 2pi mod 1, in ~[-0.5, 0.5]: Cody-Waite with a two-part 2 pi,
// every step rounded on its own.
__device__ __forceinline__ float osc_range_reduce(float phi) {
  const float inv_2pi = 0.15915494309189535f;
  const float two_pi_hi = 6.28125f;
  const float two_pi_lo = 0.0019353071795864769f;
  const float n = rintf(phi * inv_2pi);
  float xr = phi - n * two_pi_hi;
  xr = xr - n * two_pi_lo;
  return xr * inv_2pi;
}

// _COS6 in t = x^2.
__device__ __forceinline__ float osc_cos6(float t) {
  float acc = 6.503441062e+00f;
  acc = OSC_MAD(acc, t, -2.595008830e+01f);
  acc = OSC_MAD(acc, t, 6.016310858e+01f);
  acc = OSC_MAD(acc, t, -8.544960659e+01f);
  acc = OSC_MAD(acc, t, 6.493908942e+01f);
  acc = OSC_MAD(acc, t, -1.973920397e+01f);
  acc = OSC_MAD(acc, t, 9.999999875e-01f);
  return acc;
}

// _COS4 in t = x^2.
__device__ __forceinline__ float osc_cos4(float t) {
  float acc = 4.606319347e+01f;
  acc = OSC_MAD(acc, t, -8.259851900e+01f);
  acc = OSC_MAD(acc, t, 6.470140570e+01f);
  acc = OSC_MAD(acc, t, -1.973229255e+01f);
  acc = OSC_MAD(acc, t, 9.999681959e-01f);
  return acc;
}

// x * _SIN4 in t = x^2.
__device__ __forceinline__ float osc_sin4(float x, float t) {
  float acc = 3.381005338e+01f;
  acc = OSC_MAD(acc, t, -7.503236765e+01f);
  acc = OSC_MAD(acc, t, 8.146544324e+01f);
  acc = OSC_MAD(acc, t, -4.133763108e+01f);
  acc = OSC_MAD(acc, t, 6.283166561e+00f);
  return x * acc;
}

// osc_cos(x): cos(x) within 2 ulp for |x| <= kOscCosRange, without cosf's
// slow path. cos(x) = sin(x + pi/2) = (-1)^j sin(r), with j = rint(x / pi
// + 1/2) and r = x - (j - 1/2) pi in ~[-pi/2, pi/2]:
// - j by the 1.5 * 2^23 shifter: the sum rounds u to an integer, whose
//   parity is the low bit of the sum's bits;
// - r by Cody-Waite with a three-part pi (pi_a + pi_b + pi_c, each the
//   float32 rounding of what the earlier parts leave of pi) and fused
//   multiply-adds: the first is exact, so r keeps its relative accuracy
//   near the zeros of the cosine (small r);
// - sin(r) = r + r z P(z), z = r^2, P a minimax cubic for the relative
//   error over |r| <= 1.5775 (6.3e-9 before rounding).
// A float32 emulation of these operations is within 1.97 ulp of the
// float64 cosine over 10^7 inputs up to 2e5 (2.6 ulp up to 1e6; the
// reduction loses bits beyond). tests/test_torch_kernels.py reads these
// constants and holds the emulation to 2 ulp; tests/test_torch_cuda.py
// holds K8's cosine on the card to 2 ulp too. K8 uses it for a frame only
// while a bound on the frame's phases is below kOscCosRange, and cosf
// above.
constexpr float kOscCosRange = 1.0e+05f;
constexpr float kOscCosInvPi = 3.18309873e-01f;
constexpr float kOscCosPiA = 3.14159274e+00f;
constexpr float kOscCosPiB = -8.74227766e-08f;
constexpr float kOscCosPiC = -3.43024902e-15f;
constexpr float kOscCosShift = 1.25829120e+07f;   // 1.5 * 2^23
constexpr float kOscCosS1 = -1.66666597e-01f;
constexpr float kOscCosS2 = 8.33305903e-03f;
constexpr float kOscCosS3 = -1.98090536e-04f;
constexpr float kOscCosS4 = 2.60450179e-06f;

__device__ __forceinline__ float osc_cos(float x) {
  const float u = __fmaf_rn(x, kOscCosInvPi, 0.5f);
  const float shifted = u + kOscCosShift;             // rint(u) + shift
  const unsigned sign = __float_as_uint(shifted) << 31;   // (-1)^j
  const float k = (shifted - kOscCosShift) - 0.5f;     // j - 1/2, exact
  float r = __fmaf_rn(k, -kOscCosPiA, x);
  r = __fmaf_rn(k, -kOscCosPiB, r);
  r = __fmaf_rn(k, -kOscCosPiC, r);
  const float z = r * r;
  float p = __fmaf_rn(kOscCosS4, z, kOscCosS3);
  p = __fmaf_rn(p, z, kOscCosS2);
  p = __fmaf_rn(p, z, kOscCosS1);
  const float s = __fmaf_rn(p, r * z, r);
  return __uint_as_float(__float_as_uint(s) ^ sign);
}
