"""Hand-written CUDA kernels, with plain versions.

- oscillator.py: skipping additive oscillator (csrc/oscillator_skip.cu)
  and its backward (csrc/oscillator_skip_bwd.cu); the all-partials
  oscillator, forward only (csrc/oscillator_full.cu)
- gru.py: GRU recurrence (csrc/gru_scan.cu) and its backward
  (csrc/gru_scan_bwd.cu)
- note_release.py: NoteRelease recurrence (csrc/note_release.cu), its
  residual-saving forward and its backward (csrc/note_release_bwd.cu)
- oscillator_decay.py: the surrogate synth's skipping oscillator with
  decaying partials (csrc/oscillator_decay.cu) and its backward
  (csrc/oscillator_decay_bwd.cu)
- voice_allocator.py: the serving path's voice allocator
  (csrc/voice_allocator.cu)

Each front door launches its kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors; there is no switch between the two. With
grad enabled, a torch.autograd.Function pairs each forward with its
backward kernel.
"""
