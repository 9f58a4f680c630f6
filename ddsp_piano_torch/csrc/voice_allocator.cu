// Voice allocation state machine on Hopper (K9).
//
// Replaces: no Pallas kernel. On the TPU the allocator is the lax.scan over
// _frame_step in ddsp_piano_tpu/data/midi_encoders_jax.py (:45-131,
// :155-158), one XLA loop. Eagerly in PyTorch the same scan issues some
// 40-50 small operators a frame (kernels/voice_allocator.py, the plain
// version), over 100 000 launches for 10 s of audio at 250 frames/s; this
// kernel is one launch.
//
// Work: per batch row, walk t = 0..T-1 with the state (assigned (n,), the
// note each slot holds; cursor, -1 when full; reorder (n,), the last
// permutation; started). Each frame takes the n highest active pitches,
// ascending (silent entries 0), and their velocities, and writes
// (pitch, velocity)[reorder] to the slots. A frame whose note set equals
// the table reuses the permutation (the fast path); otherwise released
// slots are freed, the cursor restarts at the first released slot when it
// was -1, sustained notes keep their slots, new notes take the free slots
// in ring order from the cursor, silent entries the free slots after them,
// entries beyond the free count the last slot, and the cursor moves to the
// first silent-filled slot, or -1.
//
// Bound on the H100: neither bytes nor operations. It reads 8 bytes and
// writes 8 per (frame, slot): ~0.7 MB for 11 s at n = 16, a fraction of a
// microsecond at 3.35 TB/s. What bounds it is the chain of dependent
// steps from one frame's state to the next: about 3n + 20 dependent
// operations a frame on the slow path (three loops over the n slots whose
// accumulators chain, and the ballots, counts and selects between them),
// n + 4 on the fast path.
//
// Design: one warp a batch row, a lane a voice slot (and, for the frame's
// inputs, a lane an entry c of the sorted top n), n <= 32. The state lives
// in registers. The comparisons among slots become loops of __shfl_sync
// over the n lanes; the any / all tests, the released and free sets, the
// cumulative counts of new and silent entries and the ring ranks become
// __ballot_sync masks and __popc of them; the scatters (the last entry c
// wins a slot, as XLA applies a scatter's updates in order) are loops that
// each slot runs over the n targets. The next frame's inputs are loaded a
// frame ahead only: a fast frame's ~n + 4 dependent operations are shorter
// than a global load's latency, so the load is likely still on the chain
// (staging a tile of frames per row in shared memory would take it off).
//
// Exactness: only comparisons of the input floats, integer counts and
// copies, so the kernel is bit-exact against the plain version for every
// float32 input.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Bits [0, i) set, for 0 <= i <= 32.
__device__ __forceinline__ unsigned bits_below(int i) {
  return static_cast<unsigned>((1ull << i) - 1ull);
}

__global__ void __launch_bounds__(32)
    voice_allocator_kernel(const float* __restrict__ pitches,
                           const float* __restrict__ velocity,
                           float2* __restrict__ out, int T, int n) {
  const int lane = threadIdx.x;
  const bool on = lane < n;
  const unsigned voices = bits_below(n);
  const unsigned below = bits_below(lane);
  const size_t row = static_cast<size_t>(blockIdx.x) * T * n;
  const float* p_in = pitches + row;
  const float* v_in = velocity + row;
  float2* o = out + row;

  float assigned = 0.f;  // slot lane's note (0: free)
  int cursor = 0;
  int reorder = lane;
  bool started = false;

  float p_next = on ? p_in[lane] : 0.f;
  float v_next = on ? v_in[lane] : 0.f;
  for (int t = 0; t < T; ++t) {
    const float pitch = p_next;  // entry c = lane of the frame
    const float vel = v_next;
    if (on && t + 1 < T) {
      p_next = p_in[static_cast<size_t>(t + 1) * n + lane];
      v_next = v_in[static_cast<size_t>(t + 1) * n + lane];
    }

    // Entry lane's pitch against every slot's note, and slot lane's note
    // against every entry's pitch.
    bool in_table = false;  // pitch == assigned[j] for some slot j
    bool keep = false;      // assigned == pitch[j] for some entry j
    int sustained = -1;     // the first j with assigned == pitch[j] != 0
    for (int j = 0; j < n; ++j) {
      const float a_j = __shfl_sync(kFull, assigned, j);
      const float p_j = __shfl_sync(kFull, pitch, j);
      in_table |= pitch == a_j;
      const bool same = assigned == p_j;
      keep |= same;
      if (same && p_j != 0.f && sustained < 0) sustained = j;
    }
    const bool fast =
        started && (__ballot_sync(kFull, in_table) & voices) == voices &&
        (__ballot_sync(kFull, keep) & voices) == voices;

    if (!fast) {  // warp-uniform
      // Release, and the cursor's restart at the first released slot.
      const unsigned released =
          __ballot_sync(kFull, assigned != 0.f && !keep) & voices;
      const float assigned_rel = keep ? assigned : 0.f;
      const int cursor_rel =
          (cursor < 0 && released) ? __ffs(released) - 1 : cursor;
      int reorder_new = sustained >= 0 ? sustained : 0;

      // Free slots and their ranks in ring order from the cursor.
      const unsigned free_mask =
          __ballot_sync(kFull, assigned_rel == 0.f) & voices;
      const int start = cursor_rel > 0 ? cursor_rel : 0;
      const unsigned from_start = voices & ~bits_below(start);
      const unsigned ahead =
          lane >= start ? (from_start & below) : (from_start | below);
      const int rank = __popc(free_mask & ahead);

      // New entries take ranks 0..m-1, silent entries the ranks after.
      const bool is_zero = pitch == 0.f;
      const bool is_new = is_zero ? free_mask == 0u : !in_table;
      const unsigned new_mask = __ballot_sync(kFull, is_new) & voices;
      const unsigned zero_mask =
          __ballot_sync(kFull, is_zero && !is_new) & voices;
      const int n_new = __popc(new_mask);
      const int n_free = __popc(free_mask);
      int want_rank = -1;
      if (is_new) {
        want_rank = __popc(new_mask & below);
      } else if (is_zero) {
        want_rank = __popc(zero_mask & below) + n_new;
      }

      // Lane r: the free slot of rank r (0 where none).
      int slot_of_rank = 0;
      bool found = false;
      for (int j = 0; j < n; ++j) {
        const int rank_j = __shfl_sync(kFull, rank, j);
        if (!found && ((free_mask >> j) & 1u) && rank_j == lane) {
          slot_of_rank = j;
          found = true;
        }
      }
      const int at = min(max(want_rank, 0), n - 1);
      const int slot = __shfl_sync(kFull, slot_of_rank, at);
      const bool assign = on && want_rank >= 0;
      const int target = !assign ? -1 : (want_rank < n_free ? slot : n - 1);
      const bool place = assign && is_new && !is_zero;

      // The scatters: the last entry whose target is this slot.
      float assigned_new = assigned_rel;
      for (int j = 0; j < n; ++j) {
        const int target_j = __shfl_sync(kFull, target, j);
        const int place_j = __shfl_sync(kFull, static_cast<int>(place), j);
        const float p_j = __shfl_sync(kFull, pitch, j);
        if (target_j == lane) {
          reorder_new = j;
          if (place_j) assigned_new = p_j;
        }
      }

      // The cursor: the first silent-filled slot in ring order, or -1.
      const unsigned z =
          __ballot_sync(kFull, is_zero && assign && want_rank < n_free) &
          voices;
      const int first_zero =
          __shfl_sync(kFull, slot_of_rank, min(n_new, n - 1));
      cursor = z ? first_zero : -1;
      assigned = assigned_new;
      reorder = reorder_new;
    }
    started = true;

    const float out_pitch = __shfl_sync(kFull, pitch, reorder);
    const float out_vel = __shfl_sync(kFull, vel, reorder);
    if (on) {
      o[static_cast<size_t>(t) * n + lane] = make_float2(out_pitch, out_vel);
    }
  }
}

}  // namespace

// pitches, velocity: (B, T, n) float32, contiguous; out: (B, T, n, 2).
// One block of one warp a row; n from 1 to 32.
extern "C" int voice_allocator_launch(const float* pitches,
                                      const float* velocity, float* out,
                                      int B, int T, int n,
                                      cudaStream_t stream) {
  if (n < 1 || n > 32 || B < 0 || T < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || T == 0) return 0;
  voice_allocator_kernel<<<B, 32, 0, stream>>>(
      pitches, velocity, reinterpret_cast<float2*>(out), T, n);
  return static_cast<int>(cudaGetLastError());
}
