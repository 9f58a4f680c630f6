// Native voice allocator: 88-key pianoroll -> n_synths monophonic channels.
//
// C++ implementation of the sequential per-frame channel-assignment loop
// (the host-side hot spot of the data pipeline; semantics documented in
// ddsp_piano_torch/data/midi_encoders.py, mirroring the reference algorithm
// at ddsp_piano utils/midi_encoders.py:4-104). A full MAESTRO track is
// hundreds of thousands of frames; the Python loop costs seconds per track
// while this runs in milliseconds, and the loop holds the interpreter lock
// that the data pipeline's thread pools share, where a ctypes call
// releases it.
//
// A copy of ddsp_piano_tpu/native/voice_allocator.cc. Exposed with a plain
// C ABI for ctypes. Built at first use by ddsp_piano_torch/native/__init__.py
// (g++ -O3 -shared -fPIC -std=c++17).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kNumKeys = 88;
constexpr int kMinPitch = 21;

struct Allocator {
  int n;                       // n_synths
  std::vector<double> assigned;  // assigned pitch per channel (0 = free)
  std::vector<int> reorder;
  int assigner = 0;

  explicit Allocator(int n_synths) : n(n_synths), assigned(n_synths, 0.0),
                                     reorder(n_synths) {
    for (int i = 0; i < n; ++i) reorder[i] = i;
  }

  void advance() {
    assigner = (assigner + 1) % n;
    bool any_free = false;
    for (int c = 0; c < n; ++c) any_free |= (assigned[c] == 0.0);
    if (!any_free) {
      assigner = -1;
    } else {
      while (assigned[assigner] != 0.0) assigner = (assigner + 1) % n;
    }
  }

  bool pitch_assigned(double p) const {
    for (int c = 0; c < n; ++c)
      if (assigned[c] == p) return true;
    return false;
  }

  int channel_of(double p) const {
    for (int c = 0; c < n; ++c)
      if (assigned[c] == p) return c;
    return -1;
  }
};

// Matches numpy's set-comparison fast path: the active pitch multiset (as a
// set) equals the assigned set.
bool same_note_set(const double* pitches, const Allocator& a) {
  // unique(pitches) == unique(assigned) as sets (both typically contain 0).
  for (int i = 0; i < a.n; ++i) {
    bool found = false;
    for (int c = 0; c < a.n; ++c)
      if (a.assigned[c] == pitches[i]) { found = true; break; }
    if (!found) return false;
  }
  for (int c = 0; c < a.n; ++c) {
    bool found = false;
    for (int i = 0; i < a.n; ++i)
      if (pitches[i] == a.assigned[c]) { found = true; break; }
    if (!found) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// roll: (n_frames, 88, 2) float32 active/onset-velocity rolls.
// out_conditioning: (n_frames, n_synths, 2) float32.
// out_polyphony: (n_frames,) float32.
void allocate_voices(const float* roll, int64_t n_frames, int n_synths,
                     float* out_conditioning, float* out_polyphony) {
  Allocator alloc(n_synths);
  const int n = n_synths;
  std::vector<double> pitches(n);
  std::vector<double> vels(n);
  std::vector<int> order(kNumKeys);
  std::vector<double> pitched(kNumKeys);
  std::vector<int> reorder(n);

  for (int64_t t = 0; t < n_frames; ++t) {
    const float* frame = roll + t * kNumKeys * 2;
    double poly = 0.0;
    for (int k = 0; k < kNumKeys; ++k) {
      double active = frame[k * 2];
      poly += active;
      pitched[k] = active * (kMinPitch + k);
      order[k] = k;
    }
    out_polyphony[t] = static_cast<float>(poly);
    // Top-n pitches ascending; stable sort matches the numpy
    // implementation's argsort(kind='stable') tie order exactly.
    std::stable_sort(order.begin(), order.end(),
                     [&](int x, int y) { return pitched[x] < pitched[y]; });
    for (int i = 0; i < n; ++i) {
      int k = order[kNumKeys - n + i];
      pitches[i] = pitched[k];
      vels[i] = frame[k * 2 + 1];
    }

    bool fast = (t > 0) && same_note_set(pitches.data(), alloc);
    if (!fast) {
      std::fill(reorder.begin(), reorder.end(), 0);
      // Release channels whose note ended.
      for (int c = 0; c < n; ++c) {
        bool present = false;
        for (int i = 0; i < n; ++i)
          if (pitches[i] == alloc.assigned[c]) { present = true; break; }
        if (!present) {
          alloc.assigned[c] = 0.0;
          if (alloc.assigner == -1) alloc.advance();
        }
      }
      // Sustained notes keep their channel.
      for (int c = 0; c < n; ++c) {
        if (pitches[c] != 0.0 && alloc.pitch_assigned(pitches[c])) {
          reorder[alloc.channel_of(pitches[c])] = c;
        }
      }
      // New notes to free channels (round-robin cursor).
      for (int c = 0; c < n; ++c) {
        if (!alloc.pitch_assigned(pitches[c])) {
          int slot = alloc.assigner < 0 ? n - 1 : alloc.assigner;
          reorder[slot] = c;
          alloc.assigned[slot] = pitches[c];
          alloc.advance();
        }
      }
      // Remaining silent slots.
      for (int c = 0; c < n; ++c) {
        if (pitches[c] == 0.0) {
          int slot = alloc.assigner < 0 ? n - 1 : alloc.assigner;
          reorder[slot] = c;
          alloc.advance();
        }
      }
      alloc.reorder = reorder;
    }
    float* out = out_conditioning + t * n * 2;
    for (int c = 0; c < n; ++c) {
      out[c * 2] = static_cast<float>(pitches[alloc.reorder[c]]);
      out[c * 2 + 1] = static_cast<float>(vels[alloc.reorder[c]]);
    }
  }
}

}  // extern "C"
