// NoteRelease recurrence (F0ProcessorCell) on Hopper (K3).
//
// Replaces: ddsp_piano_tpu/kernels/gru_pallas.py, note_release_scan_pallas
// (_note_release_kernel), the third kernel of the v2 inference path.
//
// Work: per lane b, walk t = 0..T-1 with the state (held note, release
// frame count):
//   activity    = min(max(note, 0), 1)
//   release_end = min(max(steps - threshold, 0), 1)
//   out         = activity * note + (1 - activity) * prev * (1 - release_end)
//   steps'      = (steps + 1) * (1 - activity) * (1 - release_end)
// and the final state. It is K6 (note_release_bwd.cu) without the stream
// of pre-update steps.
//
// Bound on the H100: neither bytes nor operations. It moves 8 bytes and
// does about a dozen flops per (t, b); at the v2 shape (T = 750, B = 16)
// that is ~100 KB and ~150 kflop, nanoseconds at the card's rates. What
// bounds it is the serial chain of T dependent steps per lane: 3 dependent
// float32 operations a step (steps: - thr with the saturation, one
// FADD.SAT; 1 -; *), ~12 cycles, ~4.5 us over 750 steps.
//
// Design: K6's forward walk on the ring of TMA tiles of
// note_release_ring.cuh (one consumer warp of 32 lanes and one producer
// warp a block; x streamed through 2 stages of 64-step tiles; out stored
// straight to device memory, the final state at the end). The first
// version ran one thread a lane that loaded each step's note from device
// memory inside the loop: the compiler did not issue those loads ahead of
// the chain, so a memory round trip landed every few steps (~55 ns a
// step, PERF.md), as in K6 before its ring.
//
// Exactness: built with --fmad=false, so every multiply and add rounds on
// its own, in the order of the expression above, which is the order of the
// plain PyTorch version (kernels/note_release.py). The kernel is held
// bit-exact against it.

#include "note_release_ring.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
    note_release_kernel(const __grid_constant__ Streams<1> in,
                        const float* __restrict__ threshold,
                        const float* __restrict__ state0,
                        float* __restrict__ out,
                        float* __restrict__ state_out, int T, int B) {
  const Ring ring = make_ring(T, false);
  const int b0 = blockIdx.x * kLanes;
  if (threadIdx.x >= kLanes) {
    produce<1>(ring, in, b0);
    return;
  }
  forward_walk<false>(ring, threshold, state0, out, state_out, nullptr, B,
                      b0);
}

}  // namespace

// The plan (kernels/note_release.py note_release_plan): lanes a block,
// steps a tile, stages and shared bytes, checked against the ring's
// constants (note_release_ring.cuh). B must be a multiple of 4 and x
// 16-byte aligned (the wrapper pads and copies to make them so).
extern "C" int note_release_launch(const float* x, const float* threshold,
                                   const float* state0, float* out,
                                   float* state_out, int T, int B, int lanes,
                                   int tile_t, int stages, int smem,
                                   cudaStream_t stream) {
  Streams<1> in = {};
  const float* ptr[1] = {x};
  void* args[] = {&in, &threshold, &state0, &out, &state_out, &T, &B};
  return launch((const void*)note_release_kernel, &in, ptr, args, T, B,
                lanes, tile_t, stages, smem, stream);
}
