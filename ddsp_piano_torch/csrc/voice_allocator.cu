// Voice allocation state machine on Hopper (K9).
//
// Replaces: no Pallas kernel. On the TPU the allocator is the lax.scan over
// _frame_step in ddsp_piano_tpu/data/midi_encoders_jax.py (:45-131,
// :155-158), one XLA loop. Eagerly in PyTorch the same scan issues some
// 40-50 small operators a frame (kernels/voice_allocator.py, the plain
// version), over 100 000 launches for 10 s of audio at 250 frames/s; this
// is one call of three kernels on one stream.
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
// The rule the design rests on: if after frame t-1 the table mirrors its
// pitches (every entry is some slot's note, every slot's note some entry's
// pitch; on the fast path it does by definition) and frame t's pitches
// equal frame t-1's entry by entry (float ==), frame t takes the fast path
// and changes nothing. Only == of the pitches enters the state, so this
// holds for every float32 input: NaN compares unequal (such a frame is
// walked), -0.0 == 0.0 on both sides, and velocities never enter the
// state. After a slow frame the table need not mirror the frame (an
// overflow clamp or a duplicate pitch can leave it not), so the walk takes
// the mirror test against the new table before it skips.
//
// Design, three kernels on one stream (the stream orders them; the walk and
// the fill are launched with programmatic stream serialization, so each
// starts launching while the kernel before it runs and waits for it in
// griddepcontrol.wait before it reads that kernel's results):
// 1. Classify, frame-parallel: a warp a (row, 32 frames), a lane a frame;
//    bit t of a row's mask is set when frame t >= 1 equals frame t-1 (clear
//    at frame 0 and past T).
// 2. Walk, a warp a row, a lane a voice slot (and, for the frame's inputs,
//    a lane an entry c of the sorted top n), n <= 32, the state in
//    registers; an instance with n = 16 (every config's polyphony) fixed at
//    compile time, its loops unrolled, and one for any n. The comparisons
//    of entries with slots are a loop of __shfl_sync over the n lanes; the
//    any / all tests, the released and free sets, the cumulative counts and
//    the ring ranks are __ballot_sync masks and __popc of them. The
//    scatters need no loop: entry c of rank r < n_free targets the free
//    slot of ring rank r (one to one), the rest the last slot, so a slot
//    finds the entries that target it from the masks (the r-th set bit of
//    a mask, nth_bit) and keeps the last (the last entry wins a slot, as
//    XLA applies a scatter's updates in order). After a fast frame the walk
//    jumps to the next frame whose bit is clear (__ffs over the
//    complemented words, a ballot to find the next such word among 32)
//    when the table mirrors frame t, and otherwise walks t + 1, whose
//    pitches, when its bit is set, are the ones in its registers. So only
//    frames with a clear bit
//    are loaded: their indices are known from the mask ahead of the walk,
//    and the walk keeps the next kRing of them in flight into a
//    shared-memory ring with cp.async (4 bytes a lane, any n), off the
//    chain. Each walked frame's permutation goes to int8 scratch; a walked
//    frame whose bit was set gets it cleared (atomicAnd), and each 32-frame
//    word gets the last walked frame at or before its end (its anchor).
// 3. Fill, frame-parallel: a thread a (row, frame, slot) finds the last
//    walked frame w <= t (the highest clear bit at or below t in t's word,
//    __clz, else the previous word's anchor) and stores
//    (pitch, velocity)[t][perm[w]], coalesced.
//
// Bound on the H100: the function reads 8 bytes and writes 8 per (frame,
// slot): ~0.7 MB for 11 s at n = 16, a fraction of a microsecond at 3.35
// TB/s; its operations are fewer still. The walk's chain bounds it: about
// n + 4 dependent operations a walked frame's comparisons and fast test
// (the loop's accumulators chain), on the slow path ~40 more (ballots,
// counts, the nth_bit searches and selects between them) and, when frame
// t + 1 equals frame t, n + 4 for the mirror test; a few a skipped 32-frame
// word; plus the three launches. On the card a walked frame takes over a
// microsecond (chip_smoke.py phase 19: card time over frames walked), most
// of it the latency of one warp's dependent shuffles, ballots and branches
// (chip_kernel_ab.py --kernels K9 prints its SASS).
// The frames a roll walks are counted by the plain version
// (allocate_plain(..., return_fast=True)).
//
// Exactness: only comparisons of the input floats, integer counts and
// copies, so the kernels are bit-exact against the plain version for every
// float32 input.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRing = 8;             // walked frames' pitches in flight a row
constexpr int kClassifyThreads = 256;
constexpr int kFillThreads = 256;
constexpr int kServedVoices = 16;  // every config's: a walk of its own

// Bits [0, i) set, for 0 <= i <= 32.
__device__ __forceinline__ unsigned bits_below(int i) {
  return static_cast<unsigned>((1ull << i) - 1ull);
}

// Position of the r-th (from 0) set bit of m, for 0 <= r < popc(m).
__device__ __forceinline__ int nth_bit(unsigned m, int r) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const int c = __popc(m & ((1u << half) - 1u));
    if (r >= c) {
      r -= c;
      m >>= half;
      pos += half;
    }
  }
  return pos;
}

// 4 bytes from device memory to shared address dst, asynchronously.
__device__ __forceinline__ void cp_async4(unsigned dst, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ float ld_shared(unsigned addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Programmatic dependent launch: let the next kernel on the stream start
// launching, and wait until the previous one has finished and its writes
// are visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// All but the newest `pending` of this thread's copy groups have landed.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// 1. Classify: a warp a (row, word of 32 frames).
__global__ void __launch_bounds__(kClassifyThreads)
    voice_allocator_classify(const float* __restrict__ pitches,
                             unsigned* __restrict__ same, int B, int T, int n,
                             int words) {
  const size_t warp =
      (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  launch_dependents();
  if (warp >= static_cast<size_t>(B) * words) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const size_t row = warp / words;
  const int t = static_cast<int>(warp % words) * 32 + lane;
  bool eq = t >= 1 && t < T;
  if (eq) {
    const float* cur = pitches + (row * T + t) * n;
    for (int c = 0; c < n; ++c) eq &= cur[c] == cur[c - n];
  }
  const unsigned bits = __ballot_sync(kFull, eq);
  if (lane == 0) same[warp] = bits;
}

struct VoiceState {
  float assigned;  // slot lane's note (0: free)
  int cursor;
  int reorder;
  bool started;
};

// One frame of the state machine, entry c = lane of the frame against slot
// lane of the table, n <= kMax (kMax = n when n is fixed at compile time);
// returns whether the new table mirrors the frame (on the fast path it
// does, and nothing changed; after a slow frame the test is taken only
// when `need_mirror`, else false).
template <int kMax>
__device__ __forceinline__ bool frame_step(VoiceState& s, float pitch,
                                           int lane, int n,
                                           bool need_mirror) {
  const bool on = lane < n;
  const unsigned voices = bits_below(n);
  const unsigned below = bits_below(lane);

  // Entry lane's pitch against every slot's note, and slot lane's note
  // against every entry's pitch (p[j]: entry j's, in every lane).
  float p[kMax];
  bool in_table = false;  // pitch == assigned[j] for some slot j
  bool keep = false;      // assigned == pitch[j] for some entry j
  unsigned sustain = 0u;  // the j with assigned == pitch[j] != 0
#pragma unroll
  for (int j = 0; j < kMax; ++j) {
    if (j < n) {
      const float a_j = __shfl_sync(kFull, s.assigned, j);
      p[j] = __shfl_sync(kFull, pitch, j);
      in_table |= pitch == a_j;
      const bool same = s.assigned == p[j];
      keep |= same;
      sustain |= static_cast<unsigned>(same && p[j] != 0.f) << j;
    }
  }
  const bool fast =
      s.started && (__ballot_sync(kFull, in_table) & voices) == voices &&
      (__ballot_sync(kFull, keep) & voices) == voices;
  s.started = true;
  if (fast) return true;  // warp-uniform

  // Release, and the cursor's restart at the first released slot.
  const unsigned released =
      __ballot_sync(kFull, s.assigned != 0.f && !keep) & voices;
  const float assigned_rel = keep ? s.assigned : 0.f;
  const int cursor_rel =
      (s.cursor < 0 && released) ? __ffs(released) - 1 : s.cursor;

  // Free slots in ring order from the cursor: those at or after `start`,
  // then those before it; slot lane's rank among them.
  const unsigned free_mask =
      __ballot_sync(kFull, assigned_rel == 0.f) & voices;
  const int start = cursor_rel > 0 ? cursor_rel : 0;
  const unsigned free_hi = free_mask & ~bits_below(start);
  const unsigned free_lo = free_mask & bits_below(start);
  const int n_hi = __popc(free_hi);
  const int n_free = __popc(free_mask);
  const int rank = lane >= start ? __popc(free_hi & below)
                                 : n_hi + __popc(free_lo & below);

  // New entries take ranks 0..m-1, silent entries the ranks after.
  const bool is_zero = pitch == 0.f;
  const bool is_new = is_zero ? free_mask == 0u : !in_table;
  const unsigned new_mask = __ballot_sync(kFull, is_new) & voices;
  const unsigned zero_mask =
      __ballot_sync(kFull, is_zero && !is_new) & voices;
  const unsigned place_mask =
      new_mask & ~__ballot_sync(kFull, is_zero) & voices;
  const int n_new = __popc(new_mask);
  const int n_zero = __popc(zero_mask);
  const int want_rank =
      is_new ? __popc(new_mask & below)
             : (is_zero ? __popc(zero_mask & below) + n_new : -1);

  // The scatters, in closed form. Entry c of rank r < n_free targets the
  // free slot of rank r (a one-to-one map), entries of rank >= n_free the
  // last slot (the overflow clamp); the last entry targeting a slot sets
  // its permutation and the last placing one (new, not silent) its note,
  // as XLA applies a scatter's updates in order. (nth_bit's result is
  // used only where its rank is in range.)
  const int c_new = nth_bit(new_mask, rank);
  const int c_zero = nth_bit(zero_mask, rank - n_new);
  const bool is_free = (free_mask >> lane) & 1u;
  unsigned hits = !is_free ? 0u
                  : rank < n_new ? 1u << c_new
                  : rank - n_new < n_zero ? 1u << c_zero : 0u;
  const int k = max(n_free - n_new, 0);
  const unsigned overflow =
      (n_new > n_free ? new_mask & ~bits_below(nth_bit(new_mask, n_free))
                      : 0u) |
      (n_zero > k ? zero_mask & ~bits_below(nth_bit(zero_mask, k)) : 0u);
  hits |= lane == n - 1 ? overflow : 0u;
  const unsigned placed = hits & place_mask;
  const int last_place = placed ? 31 - __clz(placed) : 0;
  const float p_place = __shfl_sync(kFull, pitch, last_place);
  const int reorder_new =
      hits ? 31 - __clz(hits) : (sustain ? __ffs(sustain) - 1 : 0);
  const float assigned_new = placed ? p_place : assigned_rel;

  // The cursor: the first silent-filled slot in ring order, or -1.
  const bool assign = on && want_rank >= 0;
  const unsigned z =
      __ballot_sync(kFull, is_zero && assign && want_rank < n_free) &
      voices;
  const int r0 = min(n_new, n - 1);
  const int first_zero =
      r0 < n_hi ? nth_bit(free_hi, r0)
                : (r0 < n_free ? nth_bit(free_lo, r0 - n_hi) : 0);
  s.cursor = z ? first_zero : -1;
  s.assigned = assigned_new;
  s.reorder = reorder_new;
  if (!need_mirror) return false;  // warp-uniform

  // Whether the new table mirrors the frame.
  bool in_new = false;
  bool keep_new = false;
#pragma unroll
  for (int j = 0; j < kMax; ++j) {
    if (j < n) {
      in_new |= pitch == __shfl_sync(kFull, assigned_new, j);
      keep_new |= assigned_new == p[j];
    }
  }
  return (__ballot_sync(kFull, in_new) & voices) == voices &&
         (__ballot_sync(kFull, keep_new) & voices) == voices;
}

// The frames of one row whose mask bit is clear, in order. Lane i holds
// word base + i (cur) and base + 32 + i (ahead): a chunk of 1024 frames,
// the next one loaded a chunk ahead (past the row: all bits set).
struct ClearFrames {
  const unsigned* same;
  int words, T, lane, base, word;
  unsigned cur, ahead, pending;  // pending: word's clear bits not handed out

  __device__ unsigned load(int w) const { return w < words ? same[w] : kFull; }

  __device__ void start(const unsigned* row_same, int n_words, int t_max,
                        int lane_id) {
    same = row_same;
    words = n_words;
    T = t_max;
    lane = lane_id;
    base = 0;
    word = 0;
    cur = load(lane);
    ahead = load(32 + lane);
    pending = ~__shfl_sync(kFull, cur, 0);
  }

  // The next clear frame, or T when none is left (warp-uniform).
  __device__ int next() {
    while (pending == 0u) {
      const unsigned later =
          __ballot_sync(kFull, cur != kFull && base + lane > word);
      if (later) {
        const int i = __ffs(later) - 1;
        word = base + i;
        pending = ~__shfl_sync(kFull, cur, i);
      } else {
        if (base + 32 >= words) return T;
        base += 32;
        word = base - 1;
        cur = ahead;
        ahead = load(base + 32 + lane);
      }
    }
    const int f = word * 32 + __ffs(pending) - 1;
    pending &= pending - 1u;
    return min(f, T);
  }
};

// Stage the next clear frame's pitches into ring slot k (lane c copies
// entry c to shared address slot0 + 128 k) as one copy group; lane k keeps
// the frame in `staged`.
__device__ __forceinline__ void stage(ClearFrames& clear, unsigned slot0,
                                      int& staged, int k,
                                      const float* p_in, int n, int T) {
  const int lane = clear.lane;
  const int f = clear.next();
  if (lane == k) staged = f;
  if (lane < n && f < T) {
    cp_async4(slot0 + 128u * k, p_in + static_cast<size_t>(f) * n + lane);
  }
  cp_async_commit();
}

// 2. Walk: a warp a row; kN > 0 fixes n = kN at compile time (its loops
// unrolled), kN = 0 takes n_voices. (A block a row: the register budget of
// one block an SM keeps ptxas from recomputing values in the loop.)
template <int kN>
__global__ void __launch_bounds__(32, 1)
    voice_allocator_walk(const float* __restrict__ pitches,
                         unsigned* same, int* __restrict__ anchor,
                         signed char* __restrict__ perm, int T, int n_voices,
                         int words) {
  __shared__ float ring[kRing][32];
  const int n = kN > 0 ? kN : n_voices;
  const int lane = threadIdx.x;
  const bool on = lane < n;
  const size_t row = blockIdx.x;
  const float* p_in = pitches + row * T * n;
  unsigned* row_same = same + row * words;
  int* row_anchor = anchor + row * words;
  signed char* row_perm = perm + row * T * n;
  launch_dependents();
  wait_for_previous();  // the classify kernel's mask

  // The ring: slot k holds the pitches of frame `staged` of lane k (T:
  // none), one copy group a slot, kRing groups always in flight. The head
  // slot's pitches and frame are read one loaded frame ahead (`ahead`,
  // `next_clear`), so neither read is on the step's chain.
  ClearFrames clear;
  clear.start(row_same, words, T, lane);
  // Lane's entry of ring slot k: shared address slot0 + 128 k.
  const unsigned slot0 =
      static_cast<unsigned>(__cvta_generic_to_shared(&ring[0][lane]));
  int staged = T;
  for (int k = 0; k < kRing; ++k) stage(clear, slot0, staged, k, p_in, n, T);
  cp_async_wait<kRing - 1>();
  float ahead = on ? ld_shared(slot0) : 0.f;
  int next_clear = __shfl_sync(kFull, staged, 0);

  VoiceState state{0.f, 0, lane, false};
  float pitch = 0.f;     // entry lane of the last frame loaded
  bool mirror = false;   // the table mirrors frame t
  int head = 0;
  int t = -1;
  for (;;) {
    const int t_next = mirror ? next_clear : t + 1;
    if (t >= 0) {
      // The words from t's up to t_next's: their last walked frame is t.
      const int to = t_next < T ? t_next >> 5 : words;
#pragma unroll 1
      for (int w = (t >> 5) + lane; w < to; w += 32) row_anchor[w] = t;
    }
    if (t_next >= T) break;
    t = t_next;
    const bool loaded = t == next_clear;
    const int after = head + 1 == kRing ? 0 : head + 1;
    if (loaded) {
      pitch = ahead;
      cp_async_wait<kRing - 2>();  // the slot after the head has landed
      ahead = on ? ld_shared(slot0 + 128u * after) : 0.f;
      next_clear = __shfl_sync(kFull, staged, after);
    } else if (lane == 0) {
      // Equal to frame t - 1 (so `pitch` holds it) but walked.
      atomicAnd(row_same + (t >> 5), ~(1u << (t & 31)));
    }
    // The mirror test decides only whether t + 1 is skipped.
    mirror = frame_step<(kN > 0 ? kN : 32)>(state, pitch, lane, n,
                                            next_clear != t + 1);
    if (on) {
      row_perm[static_cast<size_t>(t) * n + lane] =
          static_cast<signed char>(state.reorder);
    }
    if (loaded) {  // the head's pitches went through the step: refill it
      stage(clear, slot0, staged, head, p_in, n, T);
      head = after;
    }
  }
}

// 3. Fill: a thread a (row, frame, slot).
__global__ void __launch_bounds__(kFillThreads)
    voice_allocator_fill(const float* __restrict__ pitches,
                         const float* __restrict__ velocity,
                         const unsigned* __restrict__ same,
                         const int* __restrict__ anchor,
                         const signed char* __restrict__ perm,
                         float2* __restrict__ out, size_t total, int T, int n,
                         int words) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  wait_for_previous();  // the walk's mask, anchors and permutations
  if (i >= total) return;
  const size_t frame = i / n;  // row * T + t
  const int slot = static_cast<int>(i - frame * n);
  const int t = static_cast<int>(frame % T);
  const size_t row = frame / T;
  const size_t at = row * words + (t >> 5);
  // Walked frames of t's word at or before t (frame 0 is always walked).
  const unsigned walked = ~same[at] & ((2u << (t & 31)) - 1u);
  const int w = walked ? (t & ~31) + 31 - __clz(walked) : anchor[at - 1];
  const size_t src = frame * n + perm[(row * T + w) * n + slot];
  out[i] = make_float2(pitches[src], velocity[src]);
}

}  // namespace

// pitches, velocity: (B, T, n) float32, contiguous; out: (B, T, n, 2);
// scratch from the caller: same and anchor (B, ceil(T / 32)) 32-bit words,
// perm (B, T, n) int8. n from 1 to 32.
extern "C" int voice_allocator_launch(const float* pitches,
                                      const float* velocity, float* out,
                                      unsigned* same, int* anchor,
                                      signed char* perm, int B, int T, int n,
                                      cudaStream_t stream) {
  if (n < 1 || n > 32 || B < 0 || T < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || T == 0) return 0;
  const int words = (T + 31) / 32;
  const size_t classify_blocks =
      (static_cast<size_t>(B) * words * 32 + kClassifyThreads - 1) /
      kClassifyThreads;
  const size_t total = static_cast<size_t>(B) * T * n;
  const size_t fill_blocks = (total + kFillThreads - 1) / kFillThreads;
  if (classify_blocks > INT_MAX || fill_blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  voice_allocator_classify<<<static_cast<unsigned>(classify_blocks),
                             kClassifyThreads, 0, stream>>>(pitches, same, B,
                                                            T, n, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // The walk and the fill launch while the kernel before them runs (each
  // waits for it in griddepcontrol.wait before it reads its results).
  cudaLaunchAttribute after_previous;
  after_previous.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  after_previous.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t walk = {};
  walk.gridDim = dim3(B);
  walk.blockDim = dim3(32);
  walk.stream = stream;
  walk.attrs = &after_previous;
  walk.numAttrs = 1;
  err = n == kServedVoices
            ? cudaLaunchKernelEx(&walk, voice_allocator_walk<kServedVoices>,
                                 pitches, same, anchor, perm, T, n, words)
            : cudaLaunchKernelEx(&walk, voice_allocator_walk<0>, pitches,
                                 same, anchor, perm, T, n, words);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t fill = walk;
  fill.gridDim = dim3(static_cast<unsigned>(fill_blocks));
  fill.blockDim = dim3(kFillThreads);
  err = cudaLaunchKernelEx(&fill, voice_allocator_fill, pitches, velocity,
                           const_cast<const unsigned*>(same),
                           const_cast<const int*>(anchor),
                           const_cast<const signed char*>(perm),
                           reinterpret_cast<float2*>(out), total, T, n,
                           words);
  return static_cast<int>(err);
}
