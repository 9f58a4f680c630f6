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
// Bound on the H100: the chain of T dependent steps of each lane, not bytes
// or operations. Per (t, lane) K6 moves 12 bytes and K7 24, at the v2
// training shape (T = 750, B = 96) ~0.9 and ~1.4 MB: well under a
// microsecond at the card's rate. The recurrence a step is 3 dependent
// float32 operations in K6 (steps: - thr with the saturation, which
// compiles to one FADD.SAT, 1 -, *; (steps + 1) (1 - a) runs beside it)
// and 5 in K7 (d_steps: * (s + 1), +, * (1 - a), * mask, +), ~12-20 cycles
// at ~4 cycles an operation: 750 steps take ~5-8 us. A thread that loads
// each step's operands from device memory inside the loop waits a memory
// round trip every few steps instead (~50-200 ns a step). With the loads
// off the chain, what paces a step is the consumer warp's own issue: ~48
// instructions a K7 step, one warp, measured ~72 cycles a step (PERF.md).
//
// Design: loads leave the chain. Both kernels stream their inputs (K6: x;
// K7: x, prev, steps, g_out) through the ring of TMA tiles of
// note_release_ring.cuh, which K3 (note_release.cu) shares. A first
// version copied each (step, stream) row of kLanes lanes with its own
// cp.async.bulk: the card took ~30 ns a row copy, one a K6 step and four
// a K7 step, and that paced both kernels (PERF.md).
//
// Exactness: built with --fmad=false, every multiply and add rounds on its
// own in the order written above, which is the order of the plain PyTorch
// versions (kernels/note_release.py note_release_scan_plain_res and
// note_release_scan_plain_bwd). Both kernels are held bit-exact to them.

#include "note_release_ring.cuh"

namespace {

constexpr int kGroup = 8;            // K7: steps whose operands load at once

__device__ __forceinline__ float sat_relu_mask(float u) {
  const float r = fmaxf(u, 0.0f);
  const float inner = r < 1.0f ? 1.0f : (r == 1.0f ? 0.5f : 0.0f);
  return u > 0.0f ? inner : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    note_release_res_kernel(const __grid_constant__ Streams<1> in,
                            const float* __restrict__ threshold,
                            const float* __restrict__ state0,
                            float* __restrict__ out,
                            float* __restrict__ state_out,
                            float* __restrict__ steps_out, int T, int B) {
  const Ring ring = make_ring(T, false);
  const int b0 = blockIdx.x * kLanes;
  if (threadIdx.x >= kLanes) {
    produce<1>(ring, in, b0);
    return;
  }
  forward_walk<true>(ring, threshold, state0, out, state_out, steps_out, B,
                     b0);
}

__global__ void __launch_bounds__(kThreads)
    note_release_bwd_kernel(const __grid_constant__ Streams<4> in,
                            const float* __restrict__ threshold,
                            const float* __restrict__ g_state,
                            float* __restrict__ dx, float* __restrict__ dthr,
                            float* __restrict__ dstate0, int T, int B) {
  const Ring ring = make_ring(T, true);
  const int b0 = blockIdx.x * kLanes;
  if (threadIdx.x >= kLanes) {
    produce<4>(ring, in, b0);
    return;
  }
  const int j = threadIdx.x;
  const bool active = b0 + j < B;
  const int b = b0 + j;
  const float thr = threshold[0];
  float d_prev = active ? g_state[2 * b] : 0.0f;
  float d_steps = active ? g_state[2 * b + 1] : 0.0f;
  float d_thr = 0.0f;
  // One step from its operands: x, prev, steps and g_out at step t.
  auto step = [&](float note, float p, float s, float g, int t) {
    const float a = sat_relu(note);
    const float u_e = s - thr;
    const float e = sat_relu(u_e);
    const float mask_a = sat_relu_mask(note);
    const float mask_e = sat_relu_mask(u_e);
    const float one_a = 1.0f - a;
    const float one_e = 1.0f - e;
    const float g_o = g + d_prev;
    const float g_n = d_steps;
    const float g_e = -(g_o * p + g_n * (s + 1.0f)) * one_a;
    const float g_a = g_o * (note - p * one_e) - g_n * (s + 1.0f) * one_e;
    dx[(size_t)t * B + b] = g_o * a + g_a * mask_a;
    d_prev = g_o * one_a * one_e;
    d_steps = g_n * one_a * one_e + g_e * mask_e;
    d_thr = d_thr + g_e * (-mask_e);
  };
  for (int i = 0; i < ring.n_tiles; ++i) {
    int t0, rows, stage;
    ring.tile(i, &t0, &rows, &stage);
    mbar_wait(ring.full + 8 * stage, (i / kStages) & 1);
    // The tile's four streams (x, prev, steps, g_out), kTile * kLanes
    // floats apart.
    const float* tile = ring.tiles + stage * 4 * kTile * kLanes + j;
    if (active) {
      if (rows == kTile) {
        // kGroup steps' operands into registers, then their walk: left to
        // ptxas, the loads came a step ahead at most (K7 ~18 % slower).
        for (int r0 = kTile - kGroup; r0 >= 0; r0 -= kGroup) {
          float note[kGroup], p[kGroup], s[kGroup], g[kGroup];
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            note[k] = tile[(r0 + k) * kLanes];
            p[k] = tile[(kTile + r0 + k) * kLanes];
            s[k] = tile[(2 * kTile + r0 + k) * kLanes];
            g[k] = tile[(3 * kTile + r0 + k) * kLanes];
          }
#pragma unroll
          for (int k = kGroup - 1; k >= 0; --k) {
            step(note[k], p[k], s[k], g[k], t0 + r0 + k);
          }
        }
      } else {
        for (int r = rows - 1; r >= 0; --r) {
          step(tile[r * kLanes], tile[(kTile + r) * kLanes],
               tile[(2 * kTile + r) * kLanes], tile[(3 * kTile + r) * kLanes],
               t0 + r);
        }
      }
    }
    mbar_arrive(ring.empty + 8 * stage);
  }
  if (active) {
    dthr[b] = d_thr;
    dstate0[2 * b] = d_prev;
    dstate0[2 * b + 1] = d_steps;
  }
}

}  // namespace

// The plan (kernels/note_release.py note_release_plan): lanes a block,
// steps a tile, stages and shared bytes, checked against the ring's
// constants (note_release_ring.cuh). B must be a multiple of 4 and the streams 16-byte aligned
// (the wrapper pads and copies to make them so).
extern "C" int note_release_res_launch(const float* x, const float* threshold,
                                       const float* state0, float* out,
                                       float* state_out, float* steps_out,
                                       int T, int B, int lanes, int tile_t,
                                       int stages, int smem,
                                       cudaStream_t stream) {
  Streams<1> in = {};
  const float* ptr[1] = {x};
  void* args[] = {&in, &threshold, &state0, &out, &state_out, &steps_out,
                  &T,  &B};
  return launch((const void*)note_release_res_kernel, &in, ptr, args, T,
                B, lanes, tile_t, stages, smem, stream);
}

extern "C" int note_release_bwd_launch(const float* x, const float* threshold,
                                       const float* prev, const float* steps,
                                       const float* g_out,
                                       const float* g_state, float* dx,
                                       float* dthr, float* dstate0, int T,
                                       int B, int lanes, int tile_t,
                                       int stages, int smem,
                                       cudaStream_t stream) {
  Streams<4> in = {};
  const float* ptr[4] = {x, prev, steps, g_out};
  void* args[] = {&in, &threshold, &g_state, &dx, &dthr, &dstate0, &T, &B};
  return launch((const void*)note_release_bwd_kernel, &in, ptr, args, T,
                B, lanes, tile_t, stages, smem, stream);
}
