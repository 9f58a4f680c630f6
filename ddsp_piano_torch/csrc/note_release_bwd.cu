// NoteRelease recurrence with residuals (K6) and its reverse walk (K7).
//
// Replaces: ddsp_piano_tpu/kernels/gru_pallas.py,
//   K6 note_release_scan_pallas_res (_note_release_res_kernel): the
//      forward of the training path, which also streams the pre-update
//      release count `steps` (the one residual the backward cannot rebuild
//      by shifting the outputs);
//   K7 _note_release_bwd_streams / note_release_scan_pallas_bwd
//      (_note_release_bwd_kernel): the gradient of the recurrence.
//
// K6 work, per lane b and step t (the state is (held note, steps)):
//   steps_out[t] = steps
//   activity    = min(max(note, 0), 1)
//   release_end = min(max(steps - threshold, 0), 1)
//   out         = activity * note + (1 - activity) * prev * (1 - release_end)
//   steps'      = (steps + 1) * (1 - activity) * (1 - release_end)
//
// K7 work, per lane, t = T-1 .. 0, with the carry (d_prev, d_steps) of the
// state entering the step (initially the final state's cotangent):
//   g_o = g_out[t] + d_prev;  g_n = d_steps
//   g_e = -(g_o prev + g_n (steps + 1)) (1 - a)
//   g_a = g_o (note - prev (1 - e)) - g_n (steps + 1) (1 - e)
//   dx[t] = g_o a + g_a mask(note)
//   d_prev  = g_o (1 - a) (1 - e)
//   d_steps = g_n (1 - a) (1 - e) + g_e mask(steps - thr)
//   dthr   += g_e (-mask(steps - thr))
// with mask(u) = d/du min(relu(u), 1) under JAX's conventions: 0 at u == 0
// and 0.5 where relu(u) == 1 (gru_pallas.py:533-538). Those ties are hit
// on real data: steps counts whole frames and the threshold 1.1 * 250
// rounds to 275.0 in float32. The per-lane dthr is summed over lanes by the
// wrapper (gru_pallas.py:713-715).
//
// Bound on the H100: neither bytes nor operations. Per (t, lane) K6 moves
// 12 bytes and K7 24 bytes, with ~14 and ~40 flops: at the v2 training
// shape (T = 750, B = 96) that is ~1-2 MB and a few Mflop, microseconds
// at the card's rates. What bounds both is the chain of T dependent steps
// per lane.
//
// Design: as note_release.cu, one thread per lane with the state (K6) or
// the carry and the dthr sum (K7) in registers and the time loop inside
// the thread; the loads of step t do not depend on step t +- 1, so the
// compiler can hoist them. No padding steps exist, so the TPU kernels'
// `live` guard has no counterpart.
//
// Exactness: built with --fmad=false, every multiply and add rounds on its
// own in the order written above, which is the order of the plain PyTorch
// versions (kernels/note_release.py note_release_scan_plain_res and
// note_release_scan_plain_bwd). Both kernels are held bit-exact to them.

#include <cuda_runtime.h>

__device__ __forceinline__ float sat_relu(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float sat_relu_mask(float u) {
  const float r = fmaxf(u, 0.0f);
  const float inner = r < 1.0f ? 1.0f : (r == 1.0f ? 0.5f : 0.0f);
  return u > 0.0f ? inner : 0.0f;
}

__global__ void note_release_res_kernel(const float* __restrict__ x,
                                        const float* __restrict__ threshold,
                                        const float* __restrict__ state0,
                                        float* __restrict__ out,
                                        float* __restrict__ state_out,
                                        float* __restrict__ steps_out,
                                        int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float thr = threshold[0];
  float prev = state0[2 * b];
  float steps = state0[2 * b + 1];
  for (int t = 0; t < T; ++t) {
    const size_t i = (size_t)t * B + b;
    const float note = x[i];
    steps_out[i] = steps;
    const float activity = sat_relu(note);
    const float release_end = sat_relu(steps - thr);
    const float o = activity * note
                    + (1.0f - activity) * prev * (1.0f - release_end);
    steps = (steps + 1.0f) * (1.0f - activity) * (1.0f - release_end);
    prev = o;
    out[i] = o;
  }
  state_out[2 * b] = prev;
  state_out[2 * b + 1] = steps;
}

__global__ void note_release_bwd_kernel(const float* __restrict__ x,
                                        const float* __restrict__ threshold,
                                        const float* __restrict__ prev,
                                        const float* __restrict__ steps,
                                        const float* __restrict__ g_out,
                                        const float* __restrict__ g_state,
                                        float* __restrict__ dx,
                                        float* __restrict__ dthr,
                                        float* __restrict__ dstate0,
                                        int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float thr = threshold[0];
  float d_prev = g_state[2 * b];
  float d_steps = g_state[2 * b + 1];
  float d_thr = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = (size_t)t * B + b;
    const float note = x[i];
    const float p = prev[i];
    const float s = steps[i];
    const float a = sat_relu(note);
    const float u_e = s - thr;
    const float e = sat_relu(u_e);
    const float mask_a = sat_relu_mask(note);
    const float mask_e = sat_relu_mask(u_e);
    const float one_a = 1.0f - a;
    const float one_e = 1.0f - e;
    const float g_o = g_out[i] + d_prev;
    const float g_n = d_steps;
    const float g_e = -(g_o * p + g_n * (s + 1.0f)) * one_a;
    const float g_a = g_o * (note - p * one_e) - g_n * (s + 1.0f) * one_e;
    dx[i] = g_o * a + g_a * mask_a;
    d_prev = g_o * one_a * one_e;
    d_steps = g_n * one_a * one_e + g_e * mask_e;
    d_thr = d_thr + g_e * (-mask_e);
  }
  dthr[b] = d_thr;
  dstate0[2 * b] = d_prev;
  dstate0[2 * b + 1] = d_steps;
}

extern "C" int note_release_res_launch(const float* x, const float* threshold,
                                       const float* state0, float* out,
                                       float* state_out, float* steps_out,
                                       int T, int B, cudaStream_t stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  note_release_res_kernel<<<blocks, threads, 0, stream>>>(
      x, threshold, state0, out, state_out, steps_out, T, B);
  return (int)cudaGetLastError();
}

extern "C" int note_release_bwd_launch(const float* x, const float* threshold,
                                       const float* prev, const float* steps,
                                       const float* g_out,
                                       const float* g_state, float* dx,
                                       float* dthr, float* dstate0, int T,
                                       int B, cudaStream_t stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  note_release_bwd_kernel<<<blocks, threads, 0, stream>>>(
      x, threshold, prev, steps, g_out, g_state, dx, dthr, dstate0, T, B);
  return (int)cudaGetLastError();
}
