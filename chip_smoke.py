#!/usr/bin/env python3
"""Smoke test of the PyTorch port (ddsp_piano_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. It imports
no JAX and nothing of ddsp_piano_tpu. Phases, one line each (the kernel
checks print one line per kernel); any failure ends the run with a
non-zero exit code and no result line:

1. The card's name and power limit, as nvidia-smi reports them.
2. Build the CUDA kernels from csrc/ (one nvcc per source, in parallel),
   with each kernel's registers and spills.
3. Render a 3 s (750-frame) segment of examples/demo.mid on the CPU
   through the plain path, recording the inputs that reach the forward
   kernels' front doors (K1-K3); then hold each kernel against its plain
   version on the card at exactly those inputs, and time kernel (its call,
   and the card alone), plain version and, where one PyTorch call
   computes the same function, that call. The GRU rows (K2 here, K5 in phase 10) also give the time a step
   and the launch plan: CTAs per cluster, rows per cluster, clusters,
   shared memory and the co-resident clusters.
4. The render path: ``synthesize_midi_file.main`` renders 10 s of demo.mid
   at full width on ``cuda``, with every launch counter set to 0 just
   before and read just after; K1-K3 must have launched. The host voice
   allocator's C++ calls are counted the same way (none: the numpy loop
   ran). Two more renders
   time the forward again: the line gives the median of the three. Each
   launch is then held against its plain version on the card at the
   inputs the run gave it, and timed.
5. The same 3 s segment on the card, against the CPU render of phase 3
   (same initial weights, same injected noise).
6. dafx22 kernels: the 3 s segment through the dafx22 model (16 kHz, 96
   harmonics x 2 substrings) on the CPU plain path, recording the
   oscillator's inputs; the all-partials oscillator (K8) and the skipping
   one (K1) are each held against their plain versions on the card at
   those inputs, K8 against K1, and both are timed with K8's plain
   version and library yardstick, K8 also on the card alone with its
   launch plan; K2 is held and timed at the segment's
   dafx22 GRU inputs.
7. The dafx22 render path: ``synthesize_midi_file.main -c dafx22``
   renders 10 s of demo.mid on ``cuda`` twice, with the default
   oscillator and with ``--oscillator full``, every launch counter set to
   0 just before each run and read just after: the first must launch K1,
   K2 and K3 and not K8, the second K8, K2 and K3 and not K1; the two
   renders must agree. Each forward time is the median of three renders.
   Each launch is held against its plain version at the inputs the run
   gave it, and K8's row of the kernel line (error,
   times, bound) is taken at the full run's oscillator inputs, as in
   phase 6. Then K2 against its plain version step by step at the 10 s
   renders' inputs: the error over the first 750 steps and over the rest.
8. The dafx22 segment on the card against its CPU render of phase 6.
9. Teacher data: ``synthesize_midi_file.main`` renders all of demo.mid
   (weights seed 0) to a 24 kHz wav, and a mini-MAESTRO (csv with a train
   and a validation row over the MIDI and the wav, and a test row over the
   MIDI and the wav's first 11 s) is written under
   build/chip_smoke/mini_maestro/.
10. One full-width training step (batch 6, 3 s) on ``cuda``, recording the
   inputs of the gradient kernels (K4-K7) inside their autograd
   Functions; each is held against its plain version on the card at those
   inputs and timed beside its plain version and its library yardstick.
   K2 and K1 are also held and timed at the step's inputs (B = 96 voice
   rows). K1 and K4 lines give each call's time (median, least-most of
   25); K4's line the shares of sounding and silent cells below Nyquist.
   K6 and K7, and K3 (which shares their ring and plan), are also held
   bit-exact at the launch plan's edge shapes (T 0, 1, a tile less one, a
   tile, a tile and one, 750, 2625; B 1, 6, 16, 96, 100, 160; with release
   ties); their lines, and K3's (phase 3, with its plan), give the card's
   own time (CUDA events between launches queued behind a spin
   kernel) and, beside bound_ms (bytes), the serial-chain bound: T x the
   dependent operations of a step x 4 cycles at the SM clock.
   (chip_kernel_ab.py reads K1's, K3's, K4's, K6's, K7's and K8's time
   on the card alone against another checkout's.)
11. The training path: ``train_single_phase.main`` trains maestro_v2
   (``-b 6 -s 8 -e 1``, phase 1, student weights seed 1) on the
   mini-MAESTRO on ``cuda``, with every launch counter set to 0 just before
   and read just after; K1, K2 and K4-K7 must have launched and the losses
   be finite. Prints the step time and its parts; after phase 25 (a
   trace before a timed render slows it), a torch.profiler view of three
   more steps: the device's busy share, the operators with the most
   device and host time, and each hand-written kernel's device events
   recorded against its launches counted (a shortfall, which the profiler
   has shown for K6 and K7, means busy undercounts).
12. The checkpoint and evaluation path, from phase 11's last_iter
   checkpoint. ``synthesize_midi_file.main --ckpt`` renders 10 s of
   demo.mid on ``cuda`` (counters set to 0 just before, K1-K3 must
   launch; forward and restore times of three renders): the restored
   parameters must equal the checkpoint's, the audio must differ from the
   initial weights' render of phase 4 and equal an in-process render of
   the trainer's final weights with the same generator (1e-6 of peak;
   the gap is printed); the weights go through export_jax_params and
   load_jax_params bit for bit. ``evaluate_model.main --ckpt --duration
   2`` sweeps the 5 test segments at b = 1 and b = 4 (the last batch
   padded), each after a warm-up sweep; the rows must match, the losses
   be finite and within rtol 1e-4 of each other; the b = 4 sweep is
   counted (K1-K3 must launch) and each of its launches held against its
   plain version at its inputs. Prints the sweep's and the eval step's
   ms a segment, and whether ``import tensorflow`` works (a fact of the
   machine, not a check).
13. Gate 2, the teacher-student soak: maestro_v2 at full width, phase 1,
   student weights seed 1, 150 steps of batch 6 x 3 s through the Trainer
   API on phase 9's mini-MAESTRO, 24 batches staged on the card before the
   first step and cycled, every launch counter set to 0 just before the
   first step and read just after the last (K1, K2 and K4-K7 must have
   launched). Prints the loss every 10 steps, the ratio of the mean of
   the last 20 losses to that of the first 20 and the median step time;
   fails on a non-finite loss or a ratio not below 1.
14. The v2 streaming path: ``synthesize_midi_file --streaming
   --chunk_seconds 4`` renders all of demo.mid (5625 frames, padded to 6
   chunks of 1000, plus the flush), counters set to 0 just before and read
   just after: K1, K2 and K3 must launch exactly (chunks + 1) x (1, 2, 1)
   times and no other kernel. Forward median of three; each launch held
   against its plain version at its inputs. The streamed library render
   against the one-shot forward on one full-length noise draw (0.02 of
   peak, correlation above 0.999, all but the flushed frame). Forward
   time and peak memory, streamed against one-shot, on demo.mid and on
   its conditioning tiled to ~180 s.
15. The dafx22 streaming path: ``-c dafx22 --streaming`` on 10 s of
   demo.mid with each oscillator, counted as in phase 14: the Normalize
   sweeps (K2 once a chunk for the context slot, twice and K3 once for the
   mono slot), then the render; K1 with the default oscillator and K8 with
   ``--oscillator full``, never both. Each launch held against its plain
   version; each streamed library render against the one-shot forward on
   one draw.
16. The configurations ported last (enstdkcl_8khz, enstdkcl_32khz,
   multi_instruments, surrogate, maestro_v2_regularized): each renders
   10 s of demo.mid through ``synthesize_midi_file.main -c <name>`` on
   ``cuda`` (enstdkcl_32khz also with ``--oscillator full``), counters and
   peak memory set to 0 just before the counted render and read just
   after: K1 (K8 with ``full``), K2 and K3 must launch and no other
   kernel; the surrogate synth's oscillator is its own, K10. The
   forward is the median of three; each launch is held against its plain
   version at its inputs; the 3 s segment on the card against its CPU
   render (1.1e-4 of peak); the peak memory is printed, and its excess
   over what was allocated before the render.
17. A phase-1 training step of each of those configurations (student
   seed 1; b = 6 x 3 s of demo.mid rendered on the card by the config's
   seed-0 model, no data thread) through the Trainer API, counters set to
   0 just before and read just after: K2, K5, K6, K7 and K1 and K4 (K4
   at up 32 and 128 through its generic kernel), or for the surrogate
   K10 and K11, must launch. Each launch is held against its plain
   version at its inputs, with K4's bound and K2's and K5's plans; three
   more steps are timed with CUDA events; one step's gradients (the
   magnitude term and the regularisers) on the card against the CPU's on
   the same batch and noise draw, each leaf within 1e-3 of its peak (a
   scalar leaf 1e-2), cosine 0.99999.
18. The user's training path from a preprocessing cache, at v2's full
   width on ``cuda``, over phase 9's mini-MAESTRO: ``python -m
   ddsp_piano_torch.preprocess_maestro`` writes the cache (every cached
   array held bit-equal to the port's load_track of its row; its bytes
   and seconds printed); ``train_single_phase.main -b 6 -s 8 -e 1 -k 4
   --profile 4`` trains on it (packed staging), counters set to 0 just
   before and read just after: K1, K2 and K4-K7 must launch, K3 in the
   validation batch, and each launch is held against its plain version at
   its inputs; the Chrome trace must hold device events of the
   hand-written kernels (its top device operations printed); the step's
   CUDA-event median and wall time a step. Then the CLI step (-k 1) on
   the cache against the raw mini-MAESTRO, -k 4 against -k 1, and
   ``--staging`` packed, packed32 and dict with each one's wire bytes a
   step (recorded, not claimed); the three-phase recipe
   ``train_ddsp_piano.main -s 4 -e 1`` (each phase's last_iter written,
   phase 2 holding phase 1's weights); ``--debug_nans`` for 2 steps
   against 2 steps without it (losses within rtol 1e-4, bit-equality
   reported); ``python -m ddsp_piano_torch.configs.gin_test maestro_v2``
   on the card. The phase's seconds are printed.
19. Serving: ``models.serving.make_serving_fn`` with v2 at full width
   over demo.mid's roll (10 s after the 0.5 s warm-up) at b = 1 and b = 8
   (the batch of the JAX package's served number): each batch's serve
   counted (counters set to 0 just before, read just after: K1, K2 twice,
   K3 and the voice allocator K9 once), its audio against the forward on
   the host allocator's conditioning with the same generator (1e-6 of
   peak), its CUDA-event time (median of 3 after a warm-up). K9 held
   bit-exact against its plain version on the demo roll (b = 1 and 8), a
   seeded over-capacity binary roll and unsorted frames with repeated
   pitches, 0.0, -0.0 and NaN (500 frames, T = 1 and T = 33); at the demo
   roll (b = 1 and 8) and the over-capacity roll its call and card times,
   the frames its walk takes and skips (the plain version's counts), its
   chain bound and its stages' bytes; its plain time and bound (bytes or
   operations, of the frames the roll walks) at b = 1.
20. The CSV CLI: ``synthesize_from_csv -d 10 --decompose`` over a two-row
   CSV of demo.mid, v2 at full width on ``cuda``, counted (a row: K1
   twice, the forward's and the stems', K2 twice, K3 and K9 once): eight
   finite 10 s wav files; each launch held against its plain version.
21. Streaming of enstdkcl_8khz, enstdkcl_32khz (each oscillator) and the
   surrogate: ``--streaming`` on 10 s of demo.mid at 4 s chunks, counted
   as in phases 14-15 (the Normalize sweeps, then the render), each
   launch held against its plain version, the streamed library render
   against the one-shot forward on one draw (0.02 of peak); streamed
   against one-shot forward time and peak memory at 10 s, and the
   surrogate's also tiled to ~180 s.
22. The training summaries: ``train_single_phase -c maestro_v2 -b 6 -s 2
   -e 3`` on phase 18's cache, counted (each launch held against its plain
   version), so that epoch 3 runs the full validation; its event file
   read back with the port's reader (``training.events``): each tag the
   JAX CLI writes at its step, each train_loss/total_loss equal to the
   CLI's epoch mean, the last audio summary's WAVs decoded to the first
   validation batch's audio within 1/32767. Prints the writer's ms by
   epoch and the file's bytes.
23. A ``.gin`` model: gin text (i) (v2's widths: 24 kHz, 16 voices, GRU
   64 and 192, NoteRelease; DeepInharmonicity + DictDetuner,
   PartialMasking, BackgroundNoiseFilter, MultiInharmonic and
   NoiseBandNetSynth through polyphonic_dag, the spectral loss with delta
   and loudness terms, LoudnessLoss) written into a temporary directory.
   ``synthesize_midi_file -c <i>.gin`` renders 10 s of demo.mid, counted
   as phase 16 counts (forward, realtime factor, peak memory; each launch
   against its plain version); the 3 s segment on the card against the
   CPU (1.1e-4 of peak); (ii) the same model through a ProcessorGroup
   over the sequential per-voice DAG (``use_sequential_dag``; gin maps
   polyphonic_dag to the folded-voice group), K1 once a voice, against
   (i); an InHarmonic + noise + Add DAG on voice 0 (InHarmonic.get_signal:
   one K1 launch) against the folded group's voice 0; then
   ``train_single_phase -c <i>.gin -b 6 -s 2 -e 1`` on the cache, every
   launch held against its plain version.
24. Data parallelism on the one card (parallel/mesh.py), maestro_v2 at
   full width, global batch 6 x 3 s from phase 18's cache, student
   weights: (a) a process group of one rank over NCCL: 3 Trainer steps
   through its all-reduce equal the single process's steps bit for bit
   (losses and parameters), every launch held against its plain version;
   (b) two ranks on the card over gloo with CUDA tensors (NCCL refuses
   two ranks on one card), started by the port's launcher, each on 3 of
   the 6 rows: the first step's reduced gradients (the v2 loss, and its
   magnitude term alone) against what the reduce sums, the mean of the
   first step on each 3-row half in one process with its rows of the same
   draw (the magnitude term within 1e-6 of each leaf's peak), and against
   the single process's 6-row gradient at the same weights and draw
   (each leaf's gap printed beside the same gap of the halves' mean in
   one process: float32 sums in another order); every cosine at least
   0.999; the losses within rtol 1e-5 of the 6-row step's, the
   parameters bit-equal across the ranks after 3 steps, every launch of
   both ranks counted and held against its plain version; (c)
   ``evaluate_model --n_devices 2`` over the two ranks (-b 4, --duration
   2, phase 11's checkpoint) against ``--n_devices 1``: losses within
   rtol 1e-5, the sweep's launches held too. Prints the gradient buffer's
   bytes and the reduce's CUDA-event ms a step.
25. The host allocator, the bf16 control networks and ffmpeg. (a) The
   C++ voice allocator (ddsp_piano_torch/native, built with the host's
   C++ compiler) bit for bit against the numpy loop on demo.mid's roll at
   16 voices and two over-capacity rolls at 4, each one's ms a frame
   (median of 5); the mini-MAESTRO's train and validation splits
   preprocessed into a cache with 8 workers under each allocator (patched
   into data.io in this process): seconds, C++ calls, the two caches
   bit-equal. (b) Under ``nn.layers.enable_bf16_control()``: the v2 3 s
   segment and one training step on the card, K2's and K5's bf16
   instances held against their bf16 plain versions at those inputs (step
   by step within 1e-5, over the 750 steps within 2e-3, beside the plain
   version's own drift from the CPU at the segment's rows) and timed with
   their bounds; the 10 s render of demo.mid, counted (K2's
   bf16 instance twice), its forward against the float32 one's (CUDA
   events, median of 3 each) and its distance from the float32 render;
   3 training steps from the cache, counted (K5's bf16 instance must
   launch), with finite losses; the switch off again. (c) Whether
   ``ffmpeg`` is on PATH.
26. One training step's gradients (batch 1, 1 s) on ``cuda`` against the
   same step on the CPU plain path (same weights, batch and noise); then
   the step on ``cuda`` with the GRU kernels' plain versions in their
   place, against both, to tell the kernels' share of the gap.
27. One JSON line of kernel numbers (K1's row at the training step's
   inputs, its launches those of the v2 render, the CLI run and phase
   18's run; K2-K7's also phase 18's; K9's those of phases 19-20; each
   kernel's also phases 22-25's; K2's and K5's rows also their bf16
   instance's launches, error, call and card times and bound, from phase
   25), then the result line.

Build outputs, the rendered wav files, the mini-MAESTRO, the training
run's checkpoints and the evaluation CSVs go to build/ in the checkout.
"""

import contextlib
import functools
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEMO_MIDI = os.path.join(ROOT, 'examples', 'demo.mid')
OUT_DIR = os.path.join(ROOT, 'build', 'chip_smoke')

SEED = 0
PIANO_TYPE = 9
SEGMENT_SECONDS = 3.0          # 750 frames, the v2 training segment
MAIN_PATH_SECONDS = 10.0
N_TIMED = 25                   # timed launches per median (after warm-up)
DEV = torch.device('cuda')

# Training: the JAX CLI's defaults (batch 6, 3 s segments), phase 1. The
# teacher is the initial model of seed 0 (synthesize_midi_file's weights);
# the student starts from seed 1.
TRAIN_BATCH = 6
TRAIN_STEPS = 8
STUDENT_SEED = 1
MAESTRO_DIR = os.path.join(OUT_DIR, 'mini_maestro')
GRAD_CHECK_SECONDS = 1.0
EVAL_SECONDS = 2.0             # evaluate_model --duration
EVAL_TRACK_SECONDS = 11.0      # the test row's audio: 5 segments of 2 s
EVAL_SEGMENTS = 5
EVAL_RTOL = 1e-4               # a segment's loss, b = 1 against b = 4
CKPT_RENDER_TOL = 1e-6         # share of peak: the --ckpt render against
                               # an in-process render of the same weights
# Gate 2, the teacher-student soak: SOAK_STEPS steps cycling SOAK_BATCHES
# staged batches; the mean of the last SOAK_WINDOW losses must be below
# that of the first SOAK_WINDOW.
SOAK_STEPS = 150
SOAK_BATCHES = 24
SOAK_WINDOW = 20
# Streaming: the CLI's default chunk; demo.mid's conditioning tiled to
# ~180 s (8 x 22.5 s) for the memory comparison; streamed against one-shot
# within 0.02 of peak and a correlation above 0.999 (tests/
# test_streaming.py:93-98, :257).
STREAM_CHUNK_SECONDS = 4.0
STREAM_LONG_TILES = 8
STREAM_TOL = 0.02
STREAM_MIN_CORR = 0.999

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores and
# HBM bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Whole-slice tolerance, a share of peak (tests/test_torch_render.py).
SLICE_TOL = 1.1e-4
# Kernel vs plain version on the same card. Oscillator (K1, K8): the same
# phase, crossfade, frequency and range reduction, each operation rounded
# on its own as the plain version rounds it; K1's degree-6 polynomial and
# its accumulation round once per multiply-add
# (csrc/oscillator_common.cuh), and the sum over up to 192 partials runs in
# another order. GRU: expf/tanhf against PyTorch's own and another
# dot-product order, over 750 steps of a contracting recurrence.
# NoteRelease: bit-exact.
OSC_TOL = 1e-5                 # share of peak
GRU_TOL = 1e-5                 # absolute (|h| < 1)
# K8 against K1, and the dafx22 render with one against the other: the
# degree-6 polynomial against the native cosine and another order of the
# sum (tests/test_oscillator.py:190), a share of peak.
K8_K1_TOL = 1e-4
# Gradient kernels against their plain versions on the card: the
# oscillator backward computes the plain VJP's phase, mask, crossfade and
# range reduction as the plain version rounds them, its degree-4
# polynomials and its five sums with one rounding per multiply-add, and
# sums the up samples of a frame in another order (share of each
# gradient's peak); the GRU backward differs from its plain version as
# the forward does (expf/tanhf, dot-product order), a share of each
# stream's peak (tests/test_torch_cuda.py); NoteRelease bit-exact.
OSC_BWD_TOL = 1e-5
GRU_BWD_TOL = 1e-5
# One training step on cuda against the CPU plain path, per trainable
# leaf as a share of its peak (tests/test_torch_training.py's whole-step
# tolerances): with the loss's magnitude term alone 1e-3; with the v2
# loss, whose log-magnitude term scales rounding at near-silent STFT bins
# by up to 1e5, 0.1 and a cosine of 0.999 between the two gradients.
STEP_TOL_MAG = 1e-3
STEP_TOL_V2 = 0.1
STEP_MIN_COSINE = 0.999

# Floating-point operations per unit of work, counted from the kernels'
# inner loops (csrc/*.cu).
OSC_FLOPS_PER_TERM = 34        # per live (partial, sample): phase 6,
#   crossfade 3, frequency 2, mask 1, range reduction 8, polynomial 12,
#   multiply-accumulate 2
# K8's operations a term by a frame's walk (csrc/oscillator_full.cu, a
# fused multiply-add two): phase 5, crossfade 2, multiply-accumulate 2 and
# osc_cos 21 (quotient 5, three-part reduction 6, r^2 1, polynomial 9)
# with no Nyquist test, 30; with the test (frequency 2, compare 1), 33;
# cosf's fast path (19) in osc_cos's place, with the test, 31.
OSC_FULL_FLOPS_PER_TERM = {'plain': 30, 'masked': 33, 'cosf': 31}
OSC_COS_RANGE = 1e5            # csrc/oscillator_common.cuh kOscCosRange
GRU_GATE_FLOPS_PER_UNIT = 17   # per (step, row, unit), besides h U + b
NR_FLOPS_PER_STEP = 14         # per (step, lane)
# NoteRelease's serial chain (csrc/note_release_bwd.cu), in dependent
# float32 operations a step as compiled: K3/K6's steps recurrence is - thr
# with max and min (one FADD.SAT in the SASS), 1 -, * ((steps + 1) (1 - a)
# runs beside it; prev's own loop is 3 too); K7's d_steps recurrence
# * (s + 1), +, * (1 - a), * mask, +. At ~4 cycles an operation (assumed,
# not measured) on the SM clock nvidia-smi reads under load. Printed on the
# kernels' lines beside bound_ms, which stays bytes or operations.
NR_CHAIN_OPS = {'note_release': 3, 'note_release_res': 3,
                'note_release_bwd': 5}
CYCLES_PER_DEPENDENT_OP = 4
OSC_BWD_FLOPS_SOUNDING = 50    # per (partial, sample) of a sounding cell
#   below Nyquist: phase 5, frequency and mask 3, crossfade 4, range
#   reduction 8, two degree-4 polynomials 17, cotangents 4, five sums 9
OSC_BWD_FLOPS_SILENT = 30      # per (partial, sample) of a silent cell
#   (a_lo = a_hi = 0) below Nyquist: phase 5, frequency and mask 3, range
#   reduction 8, degree-4 cosine 8, gc 2, two sums 4
GRU_BWD_GATE_FLOPS_PER_UNIT = 34   # per (step, row, unit), besides the
#   recompute h U + b and the chain's three U^T products
NR_BWD_FLOPS_PER_STEP = 40     # per (step, lane)


def fail(message):
    print(f"chip_smoke: {message}", file=sys.stderr)
    sys.exit(1)


def sync():
    torch.cuda.synchronize()


def event_times(fn, n=N_TIMED, warmup=3):
    """CUDA-event ms of each of ``n`` calls of ``fn`` after ``warmup``: from
    before the call's host work to after its last launch, so a call's host
    time counts where the card waits for it."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def median_ms(fn, n=N_TIMED, warmup=3):
    """Median over ``n`` calls of ``fn`` of its CUDA-event time, ms."""
    return statistics.median(event_times(fn, n, warmup))


def card_times(fn, n=N_TIMED, spin_cycles=20_000_000):
    """The card's own time, ms, of each of ``n`` calls of ``fn``, a wrapper
    that launches one kernel. The calls are queued behind a spin kernel
    (torch.cuda._sleep, ~10 ms) that holds the stream while the host
    enqueues them, so the card runs them back to back; a CUDA event between
    each two times one, the gap between two queued launches (~1 us)
    included. Fails unless the host enqueued every call before the spin
    ended (doubling the spin up to twice). torch.profiler is not used here:
    on the H100 machine it recorded from none to 21 of 25 launches of the
    TMA kernels (K6, K7) in some traces."""
    fn()
    sync()
    for _ in range(3):
        before, events = (torch.cuda.Event(enable_timing=True),
                          [torch.cuda.Event(enable_timing=True)
                           for _ in range(n + 1)])
        before.record()
        torch.cuda._sleep(spin_cycles)
        start = time.perf_counter()
        events[0].record()
        for i in range(n):
            fn()
            events[i + 1].record()
        host_ms = (time.perf_counter() - start) * 1e3
        sync()
        if host_ms < 0.8 * before.elapsed_time(events[0]):
            return [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        spin_cycles *= 2
    fail(f"the host took {host_ms:.2f} ms to enqueue {n} calls, longer "
         "than the spin that holds the card")


def spread_text(times):
    """A kernel's call times: median (least-most)."""
    return (f"call {statistics.median(times):.4f} ms ({min(times):.4f}-"
            f"{max(times):.4f}) over {len(times)}")


def bound(flops, nbytes):
    """(least time in ms, what bounds it) on the published peaks."""
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


# -- phase 1 ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def sm_clock_mhz():
    """(SM clock, its maximum), MHz, as nvidia-smi reads them while the
    card runs a queue of float32 matrix products (~1 s)."""
    a = torch.randn(4096, 4096, device=DEV)
    c = torch.empty_like(a)
    for _ in range(400):
        torch.mm(a, a, out=c)
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.sm,clocks.max.sm',
         '--format=csv,noheader,nounits'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    sync()
    clock, most = (float(v) for v in out[0].split(','))
    return clock, most


def spin_clock_mhz(cycles=2_000_000):
    """The SM clock, MHz, that a one-block kernel runs at: torch.cuda._sleep
    spinning ``cycles`` clock ticks, timed by CUDA events (median of 5)."""
    times = event_times(lambda: torch.cuda._sleep(cycles), n=5, warmup=1)
    return cycles / (statistics.median(times) * 1e3)


def chain_bound_ms(kernel, t):
    """The least time of a NoteRelease kernel over ``t`` serial steps: its
    chain of NR_CHAIN_OPS dependent operations a step at the SM clock."""
    return t * NR_CHAIN_OPS[kernel] * CYCLES_PER_DEPENDENT_OP / (
        sm_clock_mhz()[0] * 1e3)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    if not out:
        fail("nvidia-smi reported no card")
    return out[0]


# -- phase 2 ------------------------------------------------------------------


def build_kernels():
    from ddsp_piano_torch.kernels import build

    start = time.perf_counter()
    reports = build.build_all()
    for name in build.SIGNATURES:
        build.library(name)
    seconds = time.perf_counter() - start
    with open(os.path.join(OUT_DIR, 'ptxas.log'), 'w') as f:
        for name, log in reports.items():
            f.write(f"== {name}\n{log}\n")
    usage = []
    for name, log in sorted(reports.items()):
        regs = [ln.split('Used')[1].strip() for ln in log.splitlines()
                if 'Used' in ln and 'registers' in ln]
        spills = [ln.strip() for ln in log.splitlines()
                  if 'spill' in ln and ' 0 bytes spill' not in ln]
        usage.append(f"{name}: {'; '.join(regs)}"
                     + (f" SPILLS {spills}" if spills else ''))
    return seconds, usage


# -- phase 3 ------------------------------------------------------------------


# The kernel front doors as the modules of the main path import them.
FRONT_DOORS = (
    ('ddsp_piano_torch.processors.inharm', 'render_framewise_skip',
     'oscillator_skip'),
    ('ddsp_piano_torch.processors.inharm', 'render_framewise_full',
     'oscillator_full'),
    ('ddsp_piano_torch.processors.surrogate', 'render_framewise_decay_skip',
     'oscillator_decay'),
    ('ddsp_piano_torch.nn.layers', 'gru_scan', 'gru_scan'),
    ('ddsp_piano_torch.models.sub_modules', 'note_release_scan',
     'note_release'),
)
RENDER_KERNELS = ('oscillator_skip', 'gru_scan', 'note_release')
# The kernel wrappers that the training step's autograd Functions call.
TRAIN_DOORS = (
    ('ddsp_piano_torch.kernels.oscillator', 'render_framewise_skip_cuda',
     'oscillator_skip'),
    ('ddsp_piano_torch.kernels.gru', 'gru_scan_cuda', 'gru_scan'),
    ('ddsp_piano_torch.kernels.note_release', 'note_release_scan_res_cuda',
     'note_release_res'),
    ('ddsp_piano_torch.kernels.oscillator', 'render_framewise_skip_bwd_cuda',
     'oscillator_skip_bwd'),
    ('ddsp_piano_torch.kernels.gru', 'gru_scan_bwd_cuda', 'gru_scan_bwd'),
    ('ddsp_piano_torch.kernels.note_release', 'note_release_scan_bwd_cuda',
     'note_release_bwd'),
    ('ddsp_piano_torch.kernels.oscillator_decay',
     'render_framewise_decay_cuda', 'oscillator_decay'),
    ('ddsp_piano_torch.kernels.oscillator_decay',
     'render_framewise_decay_bwd_cuda', 'oscillator_decay_bwd'),
)
TRAIN_KERNELS = ('oscillator_skip', 'gru_scan', 'oscillator_skip_bwd',
                 'gru_scan_bwd', 'note_release_res', 'note_release_bwd')


def segment_inputs(device, upsampling):
    from ddsp_piano_torch.data.io import load_midi_as_conditioning

    inputs = load_midi_as_conditioning(DEMO_MIDI,
                                       duration=SEGMENT_SECONDS - 0.5,
                                       warm_up_duration=0.5)
    features = {
        'conditioning': torch.from_numpy(inputs['conditioning']).to(device),
        'pedal': torch.from_numpy(inputs['pedal']).to(device),
        'piano_model': torch.tensor([[PIANO_TYPE]], device=device),
    }
    n_samples = inputs['conditioning'].shape[1] * upsampling
    noise = 2.0 * torch.rand((16, n_samples), generator=torch.Generator(
        ).manual_seed(SEED + 1)) - 1.0
    return features, noise.to(device)


# What phases 5, 8 and 16 compare: the two stems, then the controls they
# come from (those the configuration has).
SEGMENT_OUTPUTS = ('wet', 'dry', 'f0_hz', 'inharm_coef', 'extended_pitch',
                   'amplitudes', 'harmonic_distribution', 'magnitudes',
                   'reverb_ir', 'decays', 'decay_time')


def _copy(args):
    """A copy of a call's arguments that later in-place work cannot
    change."""
    if isinstance(args, torch.Tensor):
        return args.detach().clone()
    if isinstance(args, tuple) and hasattr(args, '_fields'):
        return type(args)(*(_copy(a) for a in args))
    if isinstance(args, (tuple, list)):
        return type(args)(_copy(a) for a in args)
    return args


@contextlib.contextmanager
def capturing(capture, doors=FRONT_DOORS):
    """Record the inputs of every front door in ``doors``, by kernel name,
    in the dict ``capture`` (None records nothing). Calls made while a
    CUDA graph is captured (the Trainer's step graphs) run nothing and are
    not recorded: a Trainer's first step on a card records the eager
    warm-up's calls, and its replays call no front door."""
    patched = []
    doors = doors if capture is not None else ()
    for module_name, attr, kernel in doors:
        module = importlib.import_module(module_name)
        original = getattr(module, attr)

        def recorder(*args, _original=original, _kernel=kernel):
            if not (torch.cuda.is_available()
                    and torch.cuda.is_current_stream_capturing()):
                capture.setdefault(_kernel, []).append(_copy(args))
            return _original(*args)

        setattr(module, attr, recorder)
        patched.append((module, attr, original))
    try:
        yield
    finally:
        for module, attr, original in patched:
            setattr(module, attr, original)


def render_segment(device, capture=None, config='maestro_v2'):
    """The 3 s segment through the port's model on ``device``, recording
    the kernel front doors' inputs in ``capture``."""
    from ddsp_piano_torch.configs import get_model

    model = get_model(config, inference=True, duration=SEGMENT_SECONDS,
                      device=device, seed=SEED)
    features, noise = segment_inputs(
        device, model.sample_rate // model.frame_rate)
    with capturing(capture), torch.inference_mode():
        outs = model(features, noise=noise)
    outs['wet'] = outs['audio_synth'][0]
    outs['dry'] = outs['add']['signal'][0]
    return {k: outs[k].float().cpu().numpy() for k in SEGMENT_OUTPUTS
            if k in outs}


def to_card(args, device=None):
    """A call's arguments with every tensor on ``device`` (the card's,
    DEV, by default)."""
    if isinstance(args, torch.Tensor):
        return args.detach().to(DEV if device is None else device)
    if isinstance(args, tuple) and hasattr(args, '_fields'):
        return type(args)(*(to_card(a, device) for a in args))
    if isinstance(args, (tuple, list)):
        return type(args)(to_card(a, device) for a in args)
    return args


def to_cpu(args):
    return to_card(args, torch.device('cpu'))


def check_oscillator(calls, where='the v2 segment'):
    from ddsp_piano_torch.kernels import oscillator as kosc

    (controls, up, sr), = calls
    controls = to_card(controls)
    b, n_frames, k = controls.f_lo.shape
    kernel = lambda: kosc.render_framewise_skip_cuda(controls, up, sr)
    with torch.inference_mode():
        got = kernel()
        want = kosc.render_framewise_plain(controls, up, sr)
        sync()
        peak = want.abs().max().item()
        err = (got - want).abs().max().item()
        if not (np.isfinite(err) and err <= OSC_TOL * peak):
            fail(f"oscillator kernel at {(b, n_frames, k)} differs from its "
                 f"plain version: {err} > {OSC_TOL} x peak {peak}")
        del got, want
        times = event_times(kernel)
        card_ms = statistics.median(card_times(kernel))
        plain_ms = median_ms(lambda: kosc.render_framewise_plain(controls, up,
                                                                 sr))
        library_ms = library_osc_ms(controls, up, sr)
    live = live_cells(controls, sr)
    bound_ms, bound_by = osc_bound(OSC_FLOPS_PER_TERM * live * up, controls,
                                   up)
    detail = (f"controls 5 x {(b, n_frames, k)}, live partials "
              f"{live}/{controls.f_lo.numel()}, max err / peak "
              f"{err / peak:.3g}; {spread_text(times)}; card {card_ms:.4f} "
              f"ms")
    return dict(name='oscillator_skip', max_abs_err=err,
                ms=statistics.median(times), plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, card_ms=card_ms), detail


def library_osc_ms(controls, up, sr):
    """The library yardstick of the oscillators: torch.cos of the
    materialised phases, times the amplitudes, summed over partials."""
    f_lo, f_hi, a_lo, a_hi, phase0 = controls
    s = torch.arange(up, device=DEV, dtype=torch.float32)
    h = (torch.sin((np.pi / (2.0 * up)) * s) ** 2)[None, None, :, None]
    s = s[None, None, :, None]
    df = (f_hi - f_lo)[:, :, None, :]
    tri = s * (s + 1.0) * (0.5 / up)
    phase = phase0[:, :, None, :] + (2.0 * np.pi / sr) * (
        (s + 1.0) * f_lo[:, :, None, :] + df * tri)
    amp = (a_lo[:, :, None, :] * (1.0 - h) + a_hi[:, :, None, :] * h) * (
        f_lo[:, :, None, :] + df * (s / up) < sr / 2.0)
    return median_ms(lambda: torch.sum(amp * torch.cos(phase), -1))


def live_cells(controls, sr):
    """(frame, partial) cells that sound: below Nyquist and not silent."""
    f_lo, f_hi, a_lo, a_hi, _ = controls
    return ((torch.minimum(f_lo, f_hi) < sr / 2.0)
            & ((a_lo != 0) | (a_hi != 0))).sum().item()


def osc_bound(flops, controls, up):
    """An oscillator's bound: its operations, against five control reads
    and one audio write."""
    b, n_frames, k = controls.f_lo.shape
    return bound(flops, 4 * (5 * b * n_frames * k + b * n_frames * up))


def osc_full_walks(controls, up, sr):
    """K8's frames by walk, as its staging pass sorts them: 'cosf' where a
    phase may reach OSC_COS_RANGE, else 'masked' where a partial crosses
    Nyquist within the frame (its frequency at the frame's first and last
    sample on two sides), else 'plain'."""
    from ddsp_piano_torch.kernels import oscillator as kosc

    f_lo, f_hi, _, _, phase0 = controls
    sf = kosc.osc_tables(up, sr, f_lo.device)[0][3]
    df = f_hi - f_lo
    nyquist = sr / 2.0
    crosses = (f_lo + df * sf[0] < nyquist) != (f_lo + df * sf[up - 1]
                                               < nyquist)
    reach = phase0.abs() + (2.0 * np.pi / sr) * (
        float(up) * f_lo.abs() + (0.5 * (up - 1)) * df.abs())
    cosf = (~(reach < OSC_COS_RANGE)).any(-1)
    masked = crosses.any(-1) & ~cosf
    return dict(plain=int((~cosf & ~masked).sum()), masked=int(masked.sum()),
                cosf=int(cosf.sum()))


def check_oscillator_full(calls):
    """K8 and K1 at one recorded call's dafx22 oscillator inputs: each
    against its plain version, K8 against K1; times of both, K8's plain
    version and the library yardstick. Returns K8's row and a detail line
    with K1's numbers."""
    from ddsp_piano_torch.kernels import oscillator as kosc

    (controls, up, sr), = calls
    controls = to_card(controls)
    b, n_frames, k = controls.f_lo.shape
    with torch.inference_mode():
        got = kosc.render_framewise_full_cuda(controls, up, sr)
        want = kosc.render_framewise_full_plain(controls, up, sr)
        skip = kosc.render_framewise_skip_cuda(controls, up, sr)
        skip_want = kosc.render_framewise_plain(controls, up, sr)
        sync()
        peak = want.abs().max().item()
        err = (got - want).abs().max().item()
        skip_err = (skip - skip_want).abs().max().item()
        cross = (got - skip).abs().max().item()
        for what, e, tol in (('K8 against its plain version', err, OSC_TOL),
                             ('K1 against its plain version', skip_err,
                              OSC_TOL),
                             ('K8 against K1', cross, K8_K1_TOL)):
            if not (np.isfinite(e) and e <= tol * peak):
                fail(f"dafx22 oscillator inputs: {what} differs by {e} > "
                     f"{tol} x peak {peak}")
        fn = lambda: kosc.render_framewise_full_cuda(controls, up, sr)
        ms = median_ms(fn)
        card_ms = statistics.median(card_times(fn))
        plain_ms = median_ms(lambda: kosc.render_framewise_full_plain(
            controls, up, sr))
        skip_ms = median_ms(lambda: kosc.render_framewise_skip_cuda(
            controls, up, sr))
        library_ms = library_osc_ms(controls, up, sr)
    terms = b * n_frames * up * k
    walks = osc_full_walks(controls, up, sr)
    bound_ms, bound_by = osc_bound(
        sum(OSC_FULL_FLOPS_PER_TERM[w] * n * up * k
            for w, n in walks.items()), controls, up)
    live = live_cells(controls, sr)
    skip_bound, skip_by = osc_bound(OSC_FLOPS_PER_TERM * live * up,
                                    controls, up)
    plan = kosc.osc_full_plan(b, n_frames, k, up)
    detail = (f"dafx22 controls 5 x {(b, n_frames, k)}, up {up}, {terms} "
              f"terms; plan: {plan['frames_per_block']} frames (warps) a "
              f"block, {plan['samples_per_lane']} samples a lane, grid "
              f"{plan['grid']}, {plan['smem_bytes']} B shared; frames by "
              f"walk {walks}; card "
              f"{card_ms:.4f} ms; max err / peak: K8 {err / peak:.3g}, K1 "
              f"{skip_err / peak:.3g}, K8 vs K1 {cross / peak:.3g}; K1 here "
              f"{skip_ms:.4f} ms (live partials {live}/{b * n_frames * k}, "
              f"bound {skip_bound:.5f} ms, {skip_by})")
    return dict(name='oscillator_full', max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, card_ms=card_ms), detail


def _library_gru(x_proj, rec_kernel, rec_bias, h0):
    """torch.nn.GRU (cuDNN) set up to compute the same recurrence: PyTorch's
    GRU is the reset-after form, with gates ordered [r, z, n] where Keras
    orders [z, r, h]; its input projection is a permutation of x_proj."""
    t, b, three_u = x_proj.shape
    u = three_u // 3
    order = torch.cat([torch.arange(u, 2 * u), torch.arange(0, u),
                       torch.arange(2 * u, 3 * u)]).to(DEV)
    gru = torch.nn.GRU(three_u, u).to(DEV)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.eye(three_u, device=DEV)[order])
        gru.bias_ih_l0.zero_()
        gru.weight_hh_l0.copy_(rec_kernel.t()[order])
        gru.bias_hh_l0.copy_(rec_bias[order])
    h0 = h0[None].contiguous()
    return lambda: gru(x_proj, h0)[0]


def plan_text(kernel, b, u):
    """The launch plan a GRU kernel takes at B rows of width u."""
    from ddsp_piano_torch.kernels import gru as kgru

    p = kgru.launch_plan(kernel, b, u)
    return (f"plan N={p['cluster']} R={p['rows']}: {p['clusters']} clusters "
            f"of {p['threads']} threads, {p['smem_bytes']} B shared a CTA, "
            f"{p['active_clusters']} co-resident, {p['exclusive_clusters']} "
            f"with an SM to each CTA")


def gru_bound(t, b, u):
    """K2's bound at (T, B, u): h U + b and the gates a (step, row); the
    x_proj read, hs written, weights read once."""
    three_u = 3 * u
    flops = t * b * (2 * u * three_u + three_u + GRU_GATE_FLOPS_PER_UNIT * u)
    nbytes = 4 * (t * b * three_u + t * b * u + u * three_u + three_u
                  + b * u)
    return bound(flops, nbytes)


def gru_bwd_bound(t, b, u):
    """K5's bound at (T, B, u): the recomputed h U + b, the chain's three
    U^T products and the gates a (step, row); its inputs read and five
    streams written once."""
    three_u = 3 * u
    flops = t * b * (4 * u * three_u + 2 * three_u
                     + GRU_BWD_GATE_FLOPS_PER_UNIT * u)
    nbytes = 4 * (t * b * three_u + 2 * t * b * u + 2 * u * three_u
                  + three_u + b * u + 4 * t * b * u + b * u)
    return bound(flops, nbytes)


def check_gru(calls):
    from ddsp_piano_torch.kernels import gru as kgru

    rows = []
    for args in calls:
        args = to_card(args)
        x_proj, rec_kernel, rec_bias, h0 = args[:4]
        t, b, three_u = x_proj.shape
        u = three_u // 3
        library = _library_gru(x_proj, rec_kernel, rec_bias, h0)
        with torch.inference_mode():
            got = kgru.gru_scan_cuda(*args)
            want = kgru.gru_scan_plain(*args)
            sync()
            err = (got - want).abs().max().item()
            if not (np.isfinite(err) and err <= GRU_TOL):
                fail(f"GRU kernel (u={u}, B={b}) differs from its plain "
                     f"version: {err} > {GRU_TOL}")
            lib_err = (library() - want).abs().max().item()
            fn = lambda: kgru.gru_scan_cuda(*args)
            ms = median_ms(fn)
            card_ms = statistics.median(card_times(fn))
            plain_ms = median_ms(lambda: kgru.gru_scan_plain(*args), n=20,
                                 warmup=1)
            library_ms = median_ms(library)
        rows.append(dict(u=u, b=b, t=t, err=err, lib_err=lib_err, ms=ms,
                         card_ms=card_ms, plain_ms=plain_ms,
                         library_ms=library_ms,
                         bound=gru_bound(t, b, u),
                         plan=plan_text('gru_scan', b, u)))
    total = dict(name='gru_scan', max_abs_err=max(r['err'] for r in rows))
    for key in ('ms', 'card_ms', 'plain_ms', 'library_ms'):
        total[key] = sum(r[key] for r in rows)
    total['bound_ms'] = sum(r['bound'][0] for r in rows)
    by = {r['bound'][1] for r in rows}
    total['bound_by'] = by.pop() if len(by) == 1 else 'operations'
    detail = '; '.join(
        f"u={r['u']} x_proj ({r['t']}, {r['b']}, {3 * r['u']}): "
        f"err {r['err']:.3g} (cuDNN {r['lib_err']:.3g}), {r['ms']:.4f} ms = "
        f"{1e3 * r['ms'] / r['t']:.3f} us/step, card {r['card_ms']:.4f} ms, "
        f"plain {r['plain_ms']:.3f} "
        f"ms, cuDNN {r['library_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms "
        f"({r['bound'][1]}); {r['plan']}" for r in rows)
    return total, detail


def print_gru_row(where, row, detail):
    print(f"kernel gru_scan at {where}: {detail}; sum {row['ms']:.4f} ms "
          f"(cuDNN {row['library_ms']:.4f} ms)", flush=True)


def gru_error_by_length(calls, head=750):
    """Each recorded GRU call's kernel against its plain version, the error
    split at step ``head``: the recurrence is causal, so the first ``head``
    steps of a longer run are a run of ``head`` steps on the same inputs."""
    from ddsp_piano_torch.kernels import gru as kgru

    parts = []
    with torch.inference_mode():
        for args in calls:
            got, want = kgru.gru_scan_cuda(*args), kgru.gru_scan_plain(*args)
            diff = (got - want).abs()
            t, b, u = got.shape
            parts.append(
                f"u={u} T={t}: max err steps < {head} "
                f"{diff[:head].max().item():.3g}, steps >= {head} "
                f"{diff[head:].max().item() if t > head else 0.0:.3g}; "
                f"max |h| {want.abs().max().item():.4f}")
    return '; '.join(parts)


def check_note_release(calls):
    from ddsp_piano_torch.kernels import note_release as knr

    (x, threshold, state0), = calls
    x, threshold, state0 = to_card((x, threshold, state0))
    t, b, _ = x.shape
    with torch.inference_mode():
        got, got_state = knr.note_release_scan_cuda(x, threshold, state0)
        want, want_state = knr.note_release_scan_plain(x, threshold, state0)
        sync()
        if not (torch.equal(got, want) and torch.equal(got_state,
                                                       want_state)):
            fail("NoteRelease kernel is not bit-exact against its plain "
                 "version")
        fn = lambda: knr.note_release_scan_cuda(x, threshold, state0)
        ms = median_ms(fn)
        card_ms = statistics.median(card_times(fn))
        plain_ms = median_ms(lambda: knr.note_release_scan_plain(
            x, threshold, state0), n=20, warmup=1)
    bound_ms, bound_by = bound(NR_FLOPS_PER_STEP * t * b,
                               4 * (2 * t * b + 1 + 4 * b))
    chain = chain_bound_ms('note_release', t)
    plan = knr.note_release_plan('note_release', t, b)
    return dict(name='note_release', max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, card_ms=card_ms, chain_bound_ms=chain), (
        f"x ({t}, {b}, 1), bit-exact; plan lanes {plan['lanes']} tile_t "
        f"{plan['tile_t']} stages {plan['stages']} blocks {plan['blocks']} "
        f"smem {plan['smem_bytes']}; card {card_ms:.4f} ms; chain bound "
        f"{chain:.4f} ms ({t} steps x {NR_CHAIN_OPS['note_release']} "
        f"dependent operations x {CYCLES_PER_DEPENDENT_OP} cycles at "
        f"{sm_clock_mhz()[0]:g} MHz)")


def print_full_row(where, row, detail):
    print(f"kernel oscillator_full at the dafx22 {where}'s inputs: {detail}; "
          f"max_abs_err {row['max_abs_err']:.3g}; kernel_ms {row['ms']:.4f} "
          f"card_ms {row['card_ms']:.4f} plain_ms {row['plain_ms']:.4f} "
          f"library_ms {row['library_ms']:.4f} bound_ms "
          f"{row['bound_ms']:.5f} ({row['bound_by']})", flush=True)


KERNEL_SOURCES = {
    'oscillator_skip': ('cuda', 'ddsp_piano_torch/csrc/oscillator_skip.cu',
                        'ddsp_piano_tpu/kernels/oscillator_pallas.py:356'),
    'gru_scan': ('cuda', 'ddsp_piano_torch/csrc/gru_scan.cu',
                 'ddsp_piano_tpu/kernels/gru_pallas.py:138'),
    'note_release': ('cuda', 'ddsp_piano_torch/csrc/note_release.cu',
                     'ddsp_piano_tpu/kernels/gru_pallas.py:451'),
    'oscillator_skip_bwd': (
        'cuda', 'ddsp_piano_torch/csrc/oscillator_skip_bwd.cu',
        'ddsp_piano_tpu/kernels/oscillator_pallas.py:519'),
    'gru_scan_bwd': ('cuda', 'ddsp_piano_torch/csrc/gru_scan_bwd.cu',
                     'ddsp_piano_tpu/kernels/gru_pallas.py:313'),
    'note_release_res': ('cuda', 'ddsp_piano_torch/csrc/note_release_bwd.cu',
                         'ddsp_piano_tpu/kernels/gru_pallas.py:618'),
    'note_release_bwd': ('cuda', 'ddsp_piano_torch/csrc/note_release_bwd.cu',
                         'ddsp_piano_tpu/kernels/gru_pallas.py:673'),
    'oscillator_full': ('cuda', 'ddsp_piano_torch/csrc/oscillator_full.cu',
                        'ddsp_piano_tpu/kernels/oscillator_pallas.py:217'),
    # No Pallas site: the lax.scan over the allocator's frame step.
    'voice_allocator': ('cuda', 'ddsp_piano_torch/csrc/voice_allocator.cu',
                        'ddsp_piano_tpu/data/midi_encoders_jax.py:155'),
}


# -- phase 4 ------------------------------------------------------------------


def expected_partials(pitches):
    """Partial frequencies (Hz) of the played pitches under the model's own
    tuning (piano PIANO_TYPE), below Nyquist."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.ops import core

    model = get_model('maestro_v2', inference=True, device='cpu', seed=SEED)
    pitch = torch.tensor(sorted(pitches), dtype=torch.float32)[None, :, None]
    ids = torch.tensor([[PIANO_TYPE]])
    with torch.inference_mode():
        f0, inharm = model.inharm_model(pitch, ids)
        freqs, _ = core.get_inharmonic_freq(f0, inharm, 128)
    freqs = freqs.flatten().numpy()
    return freqs[freqs < model.sample_rate / 2.0]


def spectral_peaks(audio, sample_rate, n_peaks=5, guard_hz=5.0):
    """The ``n_peaks`` strongest local maxima of the magnitude spectrum, at
    least ``guard_hz`` apart, with the spectrum's bin width."""
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    freqs = np.fft.rfftfreq(len(audio), 1.0 / sample_rate)
    guard = int(guard_hz / freqs[1])
    peaks = []
    for i in np.argsort(spec)[::-1]:
        if all(abs(i - j) > guard for j in peaks):
            peaks.append(i)
        if len(peaks) == n_peaks:
            break
    return freqs[peaks], freqs[1]


def path_kernels(capture, what):
    """[(kernel, input shape, ms, err)] for each kernel launch a main path
    made, at the inputs it made it with: the kernel held against its plain
    version on the card (oscillators within OSC_TOL of peak, ``err`` a share
    of peak; the GRU within GRU_TOL, absolute; NoteRelease bit-exact), then
    its CUDA-event time."""
    from ddsp_piano_torch.kernels import (gru, note_release, oscillator,
                                          oscillator_decay)
    from ddsp_piano_torch.ops.oscillator import render_framewise_decay

    pairs = {'oscillator_skip': (oscillator.render_framewise_skip_cuda,
                                 oscillator.render_framewise_plain),
             'oscillator_full': (oscillator.render_framewise_full_cuda,
                                 oscillator.render_framewise_full_plain),
             'oscillator_decay': (oscillator_decay.render_framewise_decay_cuda,
                                  render_framewise_decay),
             'gru_scan': (gru.gru_scan_cuda, gru.gru_scan_plain),
             'note_release': (note_release.note_release_scan_cuda,
                              note_release.note_release_scan_plain)}
    rows = []
    with torch.inference_mode():
        for kernel, calls in sorted(capture.items()):
            cuda, plain = pairs[kernel]
            for args in calls:
                got, want = cuda(*args), plain(*args)
                sync()
                if kernel == 'note_release':
                    err, ok = 0.0, all(torch.equal(a, w)
                                       for a, w in zip(got, want))
                elif kernel == 'gru_scan':
                    err = (got - want).abs().max().item()
                    ok = np.isfinite(err) and err <= GRU_TOL
                else:
                    # A share of peak; absolute where the input is silent
                    # (a streamed render's padded chunks and its flush).
                    err = (got - want).abs().max().item()
                    peak = want.abs().max().item()
                    err = err / peak if peak > 0 else err
                    ok = np.isfinite(err) and err <= OSC_TOL
                shape = tuple(args[0][0].shape if kernel.startswith(
                    'oscillator') else args[0].shape)
                if not ok:
                    fail(f"{what}: {kernel} at its inputs {shape} differs "
                         f"from its plain version by {err}")
                ms = median_ms(lambda: cuda(*args))
                rows.append((kernel, shape, ms, err))
    return rows


def kernels_line(rows):
    return '; '.join(f"{k} {shape} {ms:.4f} ms (err {err:.3g})"
                     for k, shape, ms, err in rows)


def grouped_kernels_line(rows):
    """kernels_line with the launches of one kernel at one shape merged:
    their count, median ms and largest error."""
    groups = {}
    for k, shape, ms, err in rows:
        groups.setdefault((k, shape), []).append((ms, err))
    return '; '.join(
        f"{k} {shape} x{len(v)} {statistics.median(m for m, _ in v):.4f} ms "
        f"(err at most {max(e for _, e in v):.3g})"
        for (k, shape), v in groups.items())


def main_path():
    from ddsp_piano_torch import native
    from ddsp_piano_torch import synthesize_midi_file as cli
    from ddsp_piano_torch.data.io import load_midi_as_conditioning
    from ddsp_piano_torch.kernels import build

    out = os.path.join(OUT_DIR, 'demo.wav')
    args = cli.process_args(['-d', str(MAIN_PATH_SECONDS), '-u', '--seed',
                             str(SEED), '--piano_type', str(PIANO_TYPE),
                             '--device', DEV.type, DEMO_MIDI, out])
    shapes = {}
    with capturing(shapes):
        cli.main(args)                    # warm-up: cuFFT plans, cuBLAS
    sync()
    build.reset_launches()
    native.reset_calls()
    start = time.perf_counter()
    result = cli.main(args)
    sync()
    wall = time.perf_counter() - start
    launches = dict(build.LAUNCHES)
    allocator_calls = native.CALLS['allocate_voices']
    forwards = [result['seconds']] + timed_renders(cli, args)
    missing = [k for k in RENDER_KERNELS if launches[k] == 0]
    if missing:
        fail(f"the render path launched no {missing} kernel: {launches}")
    kernel_ms = path_kernels(shapes, 'main path')
    audio, dry, sr = result['audio'], result['dry'], result['sample_rate']
    if audio.shape != (int(MAIN_PATH_SECONDS * sr),):
        fail(f"audio of shape {audio.shape}")
    for name, x in (('wet', audio), ('dry', dry)):
        rms = float(np.sqrt(np.mean(x.astype(np.float64) ** 2)))
        if not np.isfinite(x).all() or rms <= 1e-4:
            fail(f"{name} audio not finite or silent (rms {rms})")
    cond = load_midi_as_conditioning(DEMO_MIDI, duration=MAIN_PATH_SECONDS)
    pitches = set(np.unique(cond['conditioning'][..., 0])) - {0.0}
    partials = expected_partials(pitches)
    peaks, bin_hz = spectral_peaks(dry, sr)
    miss = [p for p in peaks if np.abs(partials - p).min() > 2 * bin_hz]
    if miss:
        fail(f"dry spectral peaks {miss} Hz lie on no partial of the "
             f"played notes")
    forward = statistics.median(forwards)
    return dict(launches=launches, wall=wall, forward=forward,
                allocator_calls=allocator_calls,
                forwards=forwards, kernel_ms=kernel_ms, calls=shapes,
                audio=audio,
                rtf=MAIN_PATH_SECONDS / forward, peaks=peaks,
                bin_hz=bin_hz, n_pitches=len(pitches))


def timed_renders(cli, args, n=2):
    """The forward seconds of ``n`` more renders with ``args``, after the
    counted one: the render's time outside the kernels is host work that
    moves by milliseconds between renders of the same code."""
    return [cli.main(args)['seconds'] for _ in range(n)]


def forwards_text(forwards):
    return ' / '.join(f"{1e3 * f:.1f}" for f in forwards)


# -- phase 7 ------------------------------------------------------------------


DAFX22_PATH_KERNELS = {'skip': ('oscillator_skip', 'gru_scan', 'note_release'),
                       'full': ('oscillator_full', 'gru_scan', 'note_release')}


def dafx22_path():
    """``synthesize_midi_file -c dafx22`` on 10 s of demo.mid, once per
    oscillator, each after a warm-up render of its own; the counters are
    set to 0 just before each timed run and read just after."""
    from ddsp_piano_torch import synthesize_midi_file as cli
    from ddsp_piano_torch.kernels import build

    runs = {}
    for oscillator, kernels in DAFX22_PATH_KERNELS.items():
        out = os.path.join(OUT_DIR, f'demo_dafx22_{oscillator}.wav')
        args = cli.process_args(['-c', 'dafx22', '-d', str(MAIN_PATH_SECONDS),
                                 '-u', '--seed', str(SEED), '--piano_type',
                                 str(PIANO_TYPE), '--oscillator', oscillator,
                                 '--device', DEV.type, DEMO_MIDI, out])
        shapes = {}
        with capturing(shapes):
            cli.main(args)
        sync()
        build.reset_launches()
        result = cli.main(args)
        sync()
        launches = dict(build.LAUNCHES)
        forwards = [result['seconds']] + timed_renders(cli, args)
        other = DAFX22_PATH_KERNELS['full' if oscillator == 'skip'
                                    else 'skip'][0]
        missing = [k for k in kernels if launches[k] == 0]
        if missing or launches[other]:
            fail(f"dafx22 --oscillator {oscillator}: launches {launches} "
                 f"(must launch {kernels}, not {other})")
        audio, sr = result['audio'], result['sample_rate']
        if sr != 16000 or audio.shape != (int(MAIN_PATH_SECONDS * sr),):
            fail(f"dafx22 audio of shape {audio.shape} at {sr} Hz")
        for name, x in (('wet', audio), ('dry', result['dry'])):
            rms = float(np.sqrt(np.mean(x.astype(np.float64) ** 2)))
            if not np.isfinite(x).all() or rms <= 1e-4:
                fail(f"dafx22 {name} audio not finite or silent (rms {rms})")
        forward = statistics.median(forwards)
        runs[oscillator] = dict(
            launches=launches, forward=forward, forwards=forwards,
            rtf=MAIN_PATH_SECONDS / forward, audio=audio,
            dry=result['dry'], calls=shapes, kernel_ms=path_kernels(
                shapes, f'dafx22 --oscillator {oscillator}'))
    errs = {}
    for stem in ('audio', 'dry'):
        want = runs['skip'][stem]
        errs[stem] = float(np.abs(runs['full'][stem] - want).max()
                           / np.abs(want).max())
        if not errs[stem] <= K8_K1_TOL:
            fail(f"dafx22 {stem} render with --oscillator full differs from "
                 f"the default by {errs[stem]} of peak > {K8_K1_TOL}")
    return runs, errs


# -- phase 9 ------------------------------------------------------------------


def teacher_data():
    """The teacher's render of demo.mid (initial weights of seed 0, piano
    0) and a mini-MAESTRO over it: a train and a validation row, and a
    test row whose audio is the render's first EVAL_TRACK_SECONDS."""
    from ddsp_piano_torch import synthesize_midi_file as cli
    from ddsp_piano_torch.data import audio_io

    if os.path.isdir(MAESTRO_DIR):
        shutil.rmtree(MAESTRO_DIR)
    os.makedirs(MAESTRO_DIR)
    wav = os.path.join(MAESTRO_DIR, 'demo.wav')
    args = cli.process_args(['--seed', '7', '--piano_type', '0', '--device',
                             DEV.type, DEMO_MIDI, wav])
    result = cli.main(args)
    shutil.copy(DEMO_MIDI, os.path.join(MAESTRO_DIR, 'demo.midi'))
    seconds = len(result['audio']) / result['sample_rate']
    with open(os.path.join(MAESTRO_DIR, 'maestro-v3.0.0.csv'), 'w') as f:
        f.write('canonical_composer,canonical_title,split,year,'
                'midi_filename,audio_filename,duration\n')
        for split in ('train', 'validation'):
            f.write(f'Demo,demo,{split},2018,demo.midi,demo.wav,'
                    f'{seconds}\n')
        f.write(f'Demo,demo,test,2018,demo.midi,demo_test.wav,'
                f'{EVAL_TRACK_SECONDS}\n')
    sr = result['sample_rate']
    audio_io.write_wav(os.path.join(MAESTRO_DIR, 'demo_test.wav'),
                       result['audio'][:int(EVAL_TRACK_SECONDS * sr)], sr)
    rms = float(np.sqrt(np.mean(result['audio'].astype(np.float64) ** 2)))
    if not (np.isfinite(result['audio']).all() and rms > 1e-4):
        fail(f"teacher render not finite or silent (rms {rms})")
    return seconds, rms


def first_batch(batch_size, seconds=SEGMENT_SECONDS):
    """The first batch of the mini-MAESTRO's train split, unshuffled."""
    from ddsp_piano_torch.data import pipeline

    batches = pipeline.get_dataset(MAESTRO_DIR, split='train',
                                   duration=seconds, batch_size=batch_size,
                                   shuffle=False, infinite_generator=False,
                                   sample_rate=24000, max_polyphony=16,
                                   num_parallel_calls=1)
    batch = next(batches)
    batches.close()
    return batch


# -- phase 10 -----------------------------------------------------------------


def train_step_inputs():
    """One full-width training step on the card, recording the inputs of
    every kernel its autograd Functions launch."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.training.trainer import Trainer

    model = get_model('maestro_v2', device=DEV, seed=STUDENT_SEED)
    trainer = Trainer(model, first_phase=True, seed=STUDENT_SEED)
    batch = first_batch(TRAIN_BATCH)
    capture = {}
    with capturing(capture, TRAIN_DOORS):
        losses = trainer.train_step(batch)
    sync()
    total = float(losses['total_loss'])
    if not np.isfinite(total):
        fail(f"training step loss {total}")
    missing = [k for k in TRAIN_KERNELS if k not in capture]
    if missing:
        fail(f"the training step called no {missing} kernel")
    return capture, total


def check_oscillator_bwd(calls):
    from ddsp_piano_torch.kernels import oscillator as kosc

    (controls, g, up, sr), = calls
    got = kosc.render_framewise_skip_bwd_cuda(controls, g, up, sr)
    want = kosc.render_framewise_vjp_plain(controls, g, up, sr)
    sync()
    errs, rel = [], []
    for name, a, w in zip(controls._fields, got, want):
        peak = w.abs().max().item()
        err = (a - w).abs().max().item()
        if not (np.isfinite(err) and err <= OSC_BWD_TOL * max(peak, 1e-30)):
            fail(f"oscillator backward kernel differs from its plain "
                 f"version in d{name}: {err} > {OSC_BWD_TOL} x peak {peak}")
        errs.append(err)
        rel.append(err / max(peak, 1e-30))
    silent = osc_bwd_cells(controls, sr)[1]
    if not all(bool((d[silent] == 0).all()) for d in (got.f_lo, got.f_hi,
                                                       got.phase0)):
        fail("oscillator backward kernel: a silent cell's d f_lo, d f_hi or "
             "d phase0 is not 0")
    del got, want
    kernel = lambda: kosc.render_framewise_skip_bwd_cuda(controls, g, up, sr)
    times = event_times(kernel)
    card_ms = statistics.median(card_times(kernel))
    plain_ms = median_ms(lambda: kosc.render_framewise_vjp_plain(
        controls, g, up, sr), n=5, warmup=1)
    library_ms, slices = library_osc_bwd_ms(controls, g, up, sr)
    bound_ms, bound_by, n_sounding, n_silent = osc_bwd_bound(controls, up,
                                                             sr)
    computed = n_sounding + n_silent
    detail = (f"controls 5 x {tuple(controls.f_lo.shape)}, g "
              f"{tuple(g.shape)}; cells below Nyquist {computed}/"
              f"{controls.f_lo.numel()}: sounding {n_sounding} "
              f"({100 * n_sounding / max(computed, 1):.1f} %), silent "
              f"{n_silent} ({100 * n_silent / max(computed, 1):.1f} %); max "
              f"err / peak {max(rel):.3g}; {spread_text(times)}; card "
              f"{card_ms:.4f} ms; library = autograd of the library forward "
              f"over {slices}")
    return dict(name='oscillator_skip_bwd', max_abs_err=max(errs),
                ms=statistics.median(times),
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, card_ms=card_ms), detail


def osc_bwd_cells(controls, sr):
    """K4's cells below Nyquist (at either end of the frame), and those of
    them that are silent (a_lo = a_hi = 0)."""
    f_lo, f_hi, a_lo, a_hi, _ = controls
    audible = torch.minimum(f_lo, f_hi) < sr / 2.0
    return audible, audible & (a_lo == 0) & (a_hi == 0)


def osc_bwd_bound(controls, up, sr):
    """K4's bound at its inputs, from the sounding and silent cells it
    computes: (ms, what bounds it, sounding cells, silent cells)."""
    b, n_frames, k = controls.f_lo.shape
    audible, silent = osc_bwd_cells(controls, sr)
    n_silent = silent.sum().item()
    n_sounding = audible.sum().item() - n_silent
    flops = (OSC_BWD_FLOPS_SOUNDING * n_sounding
             + OSC_BWD_FLOPS_SILENT * n_silent) * up
    nbytes = 4 * (10 * b * n_frames * k + b * n_frames * up)
    return bound(flops, nbytes) + (n_sounding, n_silent)


def library_osc_bwd_ms(controls, g, up, sr, rows=8):
    """torch.autograd.grad of check_oscillator's library expression
    (torch.cos of the materialised phases times the amplitudes, summed over
    partials), over slices of ``rows`` voice rows: its (rows, frames, up,
    K) intermediates would take several GB each for all 96. Returns the
    summed time and the slicing."""
    b = controls.f_lo.shape[0]
    s = torch.arange(up, device=DEV, dtype=torch.float32)
    h = (torch.sin((np.pi / (2.0 * up)) * s) ** 2)[None, None, :, None]
    s = s[None, None, :, None]
    tri = s * (s + 1.0) * (0.5 / up)
    total = 0.0
    for start in range(0, b, rows):
        parts = [c[start:start + rows].detach().requires_grad_()
                 for c in controls]
        f_lo, f_hi, a_lo, a_hi, phase0 = parts
        df = (f_hi - f_lo)[:, :, None, :]
        phase = phase0[:, :, None, :] + (2.0 * np.pi / sr) * (
            (s + 1.0) * f_lo[:, :, None, :] + df * tri)
        amp = (a_lo[:, :, None, :] * (1.0 - h)
               + a_hi[:, :, None, :] * h) * (
            f_lo[:, :, None, :] + df * (s / up) < sr / 2.0)
        out = torch.sum(amp * torch.cos(phase), -1).reshape(
            parts[0].shape[0], -1)
        gs = g[start:start + rows]
        total += median_ms(lambda: torch.autograd.grad(
            out, parts, gs, retain_graph=True), n=5, warmup=1)
        del out, phase, amp, parts
    return total, f"{-(-b // rows)} slices of {rows} voice rows"


def check_gru_bwd(calls):
    from ddsp_piano_torch.kernels import gru as kgru

    rows = []
    for args in calls:
        x_proj, rec_kernel, rec_bias, h0, hs, g = args[:6]
        t, b, three_u = x_proj.shape
        u = three_u // 3
        got = kgru.gru_scan_bwd_cuda(*args)
        want = kgru.gru_scan_plain_bwd(*args)
        sync()
        # Each stream (dxz, dxr, dxh, drh, dh0) against its own peak.
        errs = [(a - w).abs().max().item() for a, w in zip(got, want)]
        peaks = [w.abs().max().item() for w in want]
        medians = [w.abs().median().item() for w in want]
        rel = max(e / max(p, 1e-30) for e, p in zip(errs, peaks))
        err, peak = max(errs), max(peaks)
        if not (np.isfinite(rel) and rel <= GRU_BWD_TOL):
            fail(f"GRU backward kernel (u={u}, B={b}) differs from its plain "
                 f"version: {rel} of a stream's peak > {GRU_BWD_TOL} (errors "
                 f"{errs}, peaks {peaks})")
        fn = lambda: kgru.gru_scan_bwd_cuda(*args)
        ms = median_ms(fn)
        card_ms = statistics.median(card_times(fn))
        plain_ms = median_ms(lambda: kgru.gru_scan_plain_bwd(*args), n=5,
                             warmup=1)
        x = x_proj.detach().requires_grad_()
        h = h0.detach().requires_grad_()
        library = _library_gru(x, rec_kernel, rec_bias, h)
        with torch.enable_grad():
            fwd_ms = median_ms(library)
            fwd_bwd_ms = median_ms(lambda: torch.autograd.grad(
                library(), [x, h], g))
        rows.append(dict(u=u, b=b, t=t, err=err, peak=peak, rel=rel,
                         median=(min(medians), max(medians)), ms=ms,
                         card_ms=card_ms, plain_ms=plain_ms,
                         library_ms=fwd_bwd_ms - fwd_ms,
                         bound=gru_bwd_bound(t, b, u),
                         plan=plan_text('gru_scan_bwd', b, u)))
    total = dict(name='gru_scan_bwd', max_abs_err=max(r['err'] for r in rows))
    for key in ('ms', 'card_ms', 'plain_ms', 'library_ms'):
        total[key] = sum(r[key] for r in rows)
    total['bound_ms'] = sum(r['bound'][0] for r in rows)
    by = {r['bound'][1] for r in rows}
    total['bound_by'] = by.pop() if len(by) == 1 else 'operations'
    detail = '; '.join(
        f"u={r['u']} ({r['t']}, {r['b']}): err {r['err']:.3g}, at most "
        f"{r['rel']:.3g} of a stream's peak (peaks up to {r['peak']:.3g}, "
        f"median |stream| {r['median'][0]:.3g}-{r['median'][1]:.3g}), "
        f"{r['ms']:.4f} ms = "
        f"{1e3 * r['ms'] / r['t']:.3f} us/step, card {r['card_ms']:.4f} ms, "
        f"plain {r['plain_ms']:.3f} ms, cuDNN backward "
        f"{r['library_ms']:.4f} ms, bound "
        f"{r['bound'][0]:.5f} ms ({r['bound'][1]}); {r['plan']}"
        for r in rows)
    return total, detail + "; the chain of 750 serial steps bounds it"


# K6 / K7 launch-plan edges: lengths as (tiles, steps) of the plan's tile,
# and lanes (tests/test_torch_cuda.py holds the same shapes).
NR_EDGE_T = ((0, 0), (0, 1), (1, -1), (1, 0), (1, 1), (0, 750), (0, 2625))
NR_EDGE_B = (1, 6, 16, 96, 100, 160)


def note_release_edge_inputs(t, b, seed, device=None):
    """K6's inputs at (t, b) on ``device`` (DEV by default): notes of 1-11
    steps with gaps of 1-15, an integral threshold (5) and initial release
    counts on it and one below it, so steps - thr lands on 0 and 1; and
    seeded cotangents for K7. tests/test_torch_cuda.py uses it too."""
    rng = np.random.RandomState(seed)
    x = np.zeros((t, b, 1), np.float32)
    for lane in range(b):
        start = int(rng.randint(0, 4))
        while start < t:
            held = int(rng.randint(1, 12))
            x[start:start + held, lane, 0] = rng.randint(30, 90)
            start += held + int(rng.randint(1, 16))
    s0 = np.zeros((b, 2), np.float32)
    s0[:, 0] = rng.randint(30, 90, b)
    s0[:, 1] = np.array([4.0, 5.0, 6.0, 0.0])[np.arange(b) % 4]
    g_out = rng.randn(t, b, 1).astype(np.float32)
    g_state = rng.randn(b, 2).astype(np.float32)
    device = DEV if device is None else device
    card = lambda a: torch.from_numpy(a).to(device)
    return (card(x), torch.tensor([5.0], device=device), card(s0),
            card(g_out), card(g_state))


def check_note_release_edges():
    """K3, K6 and K7 bit-exact against their plain versions at every
    launch-plan edge (the three share the ring's plan); returns the shapes
    checked and the tie cells seen."""
    from ddsp_piano_torch.kernels import note_release as knr

    shapes, ties = [], [0, 0]
    for b in NR_EDGE_B:
        tile_t = knr.note_release_plan('note_release_res', 1, b)['tile_t']
        for tiles, steps in NR_EDGE_T:
            t = tiles * tile_t + steps
            x, thr, s0, g_out, g_state = note_release_edge_inputs(
                t, b, seed=t * 1000 + b)
            got_k3 = knr.note_release_scan_cuda(x, thr, s0)
            got = knr.note_release_scan_res_cuda(x, thr, s0)
            want = knr.note_release_scan_plain_res(x, thr, s0)
            prev = torch.cat([s0[None, :, 0], want[0][:-1, :, 0]],
                             dim=0)[:t]
            args = (x, thr, prev, want[2], g_out, g_state)
            got_b = knr.note_release_scan_bwd_cuda(*args)
            want_b = knr.note_release_scan_plain_bwd(*args)
            sync()
            for name, a, w in (('K3', got_k3, want[:2]), ('K6', got, want),
                               ('K7', got_b, want_b)):
                if not all(torch.equal(i, j) for i, j in zip(a, w)):
                    fail(f"NoteRelease {name} is not bit-exact against its "
                         f"plain version at T={t}, B={b}")
            u = want[2] - thr
            ties[0] += int((u == 0).sum())
            ties[1] += int((u == 1).sum())
            shapes.append((t, b))
    return shapes, ties


def check_note_release_pair(capture):
    from ddsp_piano_torch.kernels import note_release as knr

    (x, thr, s0), = capture['note_release_res']
    (bx, bthr, prev, steps, g_out, g_state), = capture['note_release_bwd']
    t, b, _ = x.shape
    got = knr.note_release_scan_res_cuda(x, thr, s0)
    want = knr.note_release_scan_plain_res(x, thr, s0)
    got_b = knr.note_release_scan_bwd_cuda(bx, bthr, prev, steps, g_out,
                                           g_state)
    want_b = knr.note_release_scan_plain_bwd(bx, bthr, prev, steps, g_out,
                                             g_state)
    sync()
    if not all(torch.equal(a, w) for a, w in zip(got, want)):
        fail("NoteRelease residual kernel (K6) is not bit-exact against its "
             "plain version")
    if not all(torch.equal(a, w) for a, w in zip(got_b, want_b)):
        fail("NoteRelease backward kernel (K7) is not bit-exact against its "
             "plain version")
    u = want[2] - thr
    ties = int((u == 0).sum()), int((u == 1).sum())
    shapes, edge_ties = check_note_release_edges()
    rows = []
    for name, fn, plain, args, flops, nbytes in (
            ('note_release_res', knr.note_release_scan_res_cuda,
             knr.note_release_scan_plain_res, (x, thr, s0),
             NR_FLOPS_PER_STEP * t * b, 4 * (3 * t * b + 1 + 4 * b)),
            ('note_release_bwd', knr.note_release_scan_bwd_cuda,
             knr.note_release_scan_plain_bwd,
             (bx, bthr, prev, steps, g_out, g_state),
             NR_BWD_FLOPS_PER_STEP * t * b, 4 * (5 * t * b + 1 + 5 * b))):
        call = lambda: fn(*args)
        ms = median_ms(call)
        card_ms = statistics.median(card_times(call))
        plain_ms = median_ms(lambda: plain(*args), n=5, warmup=1)
        bound_ms, bound_by = bound(flops, nbytes)
        plan = knr.note_release_plan(name, t, b)
        rows.append(dict(name=name, max_abs_err=0.0, ms=ms,
                         plain_ms=plain_ms, library_ms=None,
                         bound_ms=bound_ms, bound_by=bound_by,
                         card_ms=card_ms,
                         chain_bound_ms=chain_bound_ms(name, t),
                         plan=plan))
    detail = (f"x ({t}, {b}, 1), threshold {float(thr):g}, release ties "
              f"steps - thr == 0 at {ties[0]} and == 1 at {ties[1]} (step, "
              f"lane) cells; both bit-exact, and with K3 at the plan's "
              f"{len(shapes)} edge shapes (T {sorted({s[0] for s in shapes})}"
              f", B {list(NR_EDGE_B)}; ties {edge_ties[0]} / "
              f"{edge_ties[1]}); chain bound: {t} steps x "
              f"{NR_CHAIN_OPS['note_release_res']} (K6) or "
              f"{NR_CHAIN_OPS['note_release_bwd']} (K7) dependent operations "
              f"x {CYCLES_PER_DEPENDENT_OP} cycles at {sm_clock_mhz()[0]:g} "
              f"MHz (max {sm_clock_mhz()[1]:g})")
    return rows, detail


def kernel_ms_per_step(capture):
    """CUDA-event ms of every kernel launch of one training step, at the
    step's own inputs: {kernel: summed ms}."""
    from ddsp_piano_torch.kernels import gru, note_release, oscillator

    launch = {
        'oscillator_skip': oscillator.render_framewise_skip_cuda,
        'gru_scan': gru.gru_scan_cuda,
        'note_release_res': note_release.note_release_scan_res_cuda,
        'oscillator_skip_bwd': oscillator.render_framewise_skip_bwd_cuda,
        'gru_scan_bwd': gru.gru_scan_bwd_cuda,
        'note_release_bwd': note_release.note_release_scan_bwd_cuda,
    }
    return {kernel: sum(median_ms(lambda: launch[kernel](*args), n=10)
                        for args in calls)
            for kernel, calls in capture.items()}


# -- phase 11 -----------------------------------------------------------------


def training_path():
    from ddsp_piano_torch import train_single_phase as cli
    from ddsp_piano_torch.kernels import build

    exp = os.path.join(OUT_DIR, 'train_exp')
    if os.path.isdir(exp):
        shutil.rmtree(exp)
    args = cli.process_args(['-b', str(TRAIN_BATCH), '-s', str(TRAIN_STEPS),
                             '-e', '1', '--seed', str(STUDENT_SEED),
                             '--device', DEV.type, MAESTRO_DIR, exp])
    build.reset_launches()
    start = time.perf_counter()
    result = cli.main(args, record_timeline=True)
    sync()
    wall = time.perf_counter() - start
    launches = dict(build.LAUNCHES)
    missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
    if missing:
        fail(f"the training path launched no {missing} kernel: {launches}")
    losses = result['step_losses']
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"training losses {losses}")
    if result['val_losses'] is None or not np.isfinite(
            result['val_losses']['total_loss']):
        fail(f"validation losses {result['val_losses']}")
    if not os.path.isfile(os.path.join(exp, 'phase_1', 'last_iter',
                                       'ckpt.pt')):
        fail("the training path wrote no last_iter checkpoint")
    times = result['trainer'].step_times()[1:]
    parts = [statistics.median(p) for p in zip(*times)]
    return dict(launches=launches, wall=wall, losses=losses,
                trainer=result['trainer'],
                val=result['val_losses']['total_loss'], step_ms=parts[0],
                fwd_ms=parts[1], bwd_ms=parts[2], opt_ms=parts[3])


# Each launch counter's kernels, by a piece of their symbol names (the
# profiler's device events carry the demangled names).
KERNEL_SYMBOLS = {'oscillator_skip': 'osc_skip_kernel',
                  'oscillator_skip_bwd': 'osc_skip_bwd',
                  'oscillator_full': 'osc_full_kernel',
                  'gru_scan': 'gru_scan_kernel',
                  'gru_scan_bwd': 'gru_scan_bwd_kernel',
                  'note_release': 'note_release_kernel',
                  'note_release_res': 'note_release_res_kernel',
                  'note_release_bwd': 'note_release_bwd_kernel'}


def profile_training_steps(n_steps=3):
    """torch.profiler over ``n_steps`` full-width training steps after two
    warm-up steps: wall ms per step, the device's busy share (the union of
    kernel and copy intervals on the device's timeline), the operators
    with the most device and host time, and, per hand-written kernel, the
    launches its counter saw against the device events the profiler
    recorded (the profiler has lost launches of K6 and K7 on the H100: a
    shortfall means the busy time undercounts)."""
    from torch.profiler import ProfilerActivity, profile

    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.kernels import build
    from ddsp_piano_torch.training.trainer import Trainer

    model = get_model('maestro_v2', device=DEV, seed=STUDENT_SEED)
    trainer = Trainer(model, first_phase=True, seed=STUDENT_SEED)
    batch = trainer.stage(first_batch(TRAIN_BATCH))
    for _ in range(2):
        trainer.train_step(batch)
    sync()
    activities = [ProfilerActivity.CPU]
    if DEV.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    counted = dict(build.LAUNCHES)
    with profile(activities=activities) as prof:
        start = time.perf_counter()
        for _ in range(n_steps):
            trainer.train_step(batch)
        sync()
        wall_ms = (time.perf_counter() - start) * 1e3 / n_steps
    launched = {k: build.LAUNCHES[k] - counted[k] for k in KERNEL_SYMBOLS}
    recorded = {k: sum(1 for e in prof.events()
                       if e.device_type.name == 'CUDA' and piece in e.name)
                for k, piece in KERNEL_SYMBOLS.items()}
    intervals = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type.name == 'CUDA' and e.time_range.end
        > e.time_range.start)
    busy, last = 0.0, None
    for lo, hi in intervals:
        if last is None or lo > last:
            busy += hi - lo
            last = hi
        elif hi > last:
            busy += hi - last
            last = hi
    busy_ms = busy / 1e3 / n_steps
    table = prof.key_averages()
    by_device = sorted(table, key=lambda e: -e.self_device_time_total)[:10]
    by_host = sorted(table, key=lambda e: -e.self_cpu_time_total)[:10]
    fmt = lambda e, t: f"{e.key[:48]} {t / 1e3 / n_steps:.2f} ({e.count // n_steps})"
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                device=[fmt(e, e.self_device_time_total) for e in by_device],
                host=[fmt(e, e.self_cpu_time_total) for e in by_host],
                launches={k: (recorded[k], n) for k, n in launched.items()
                          if n or recorded[k]})


# -- phase 12 -----------------------------------------------------------------


def ckpt_render(ckpt, trainer, initial_audio):
    """``synthesize_midi_file --ckpt`` of the training path's last_iter on
    10 s of demo.mid, counters set to 0 just before the first render and
    read just after: the restored parameters must equal the checkpoint's,
    the audio an in-process render of the trainer's final weights with the
    same generator (CKPT_RENDER_TOL of peak), not the initial weights'
    render; then the weights through export_jax_params and
    load_jax_params into a model of other initial weights, bit for bit."""
    from ddsp_piano_torch import synthesize_midi_file as cli
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.data.io import load_midi_as_conditioning
    from ddsp_piano_torch.kernels import build
    from ddsp_piano_torch.params import export_jax_params, load_jax_params
    from ddsp_piano_torch.training.checkpoints import load_ckpt

    args = cli.process_args(['--ckpt', ckpt, '-d', str(MAIN_PATH_SECONDS),
                             '--seed', str(SEED), '--piano_type',
                             str(PIANO_TYPE), '--device', DEV.type,
                             DEMO_MIDI, os.path.join(OUT_DIR,
                                                     'demo_ckpt.wav')])
    sync()
    build.reset_launches()
    result = cli.main(args)
    sync()
    launches = dict(build.LAUNCHES)
    missing = [k for k in RENDER_KERNELS if launches[k] == 0]
    if missing:
        fail(f"the --ckpt render launched no {missing} kernel: {launches}")
    runs = [result] + [cli.main(args) for _ in range(2)]
    model, audio = result['model'], result['audio']
    saved = load_ckpt(ckpt)['model']
    state = model.state_dict()
    wrong = sorted(set(saved) ^ set(state)) + [
        k for k in saved if k in state
        and not torch.equal(state[k].cpu(), saved[k])]
    if wrong:
        fail(f"the --ckpt render's parameters differ from the checkpoint's: "
             f"{wrong[:5]}")
    sr = result['sample_rate']
    if audio.shape != (int(MAIN_PATH_SECONDS * sr),) or not np.isfinite(
            audio).all():
        fail(f"--ckpt render of shape {audio.shape}, or not finite")
    from_initial = float(np.abs(audio - initial_audio).max()
                         / np.abs(initial_audio).max())
    if not from_initial > 1e-3:
        fail(f"the --ckpt render is the initial weights' render "
             f"({from_initial} of peak apart)")

    inputs = load_midi_as_conditioning(DEMO_MIDI,
                                       duration=MAIN_PATH_SECONDS,
                                       warm_up_duration=0.5)
    mine = get_model('maestro_v2', inference=True,
                     duration=inputs['duration'], device=DEV)
    mine.load_state_dict(trainer.model.state_dict())
    features = {
        'conditioning': torch.from_numpy(inputs['conditioning']).to(DEV),
        'pedal': torch.from_numpy(inputs['pedal']).to(DEV),
        'piano_model': torch.tensor([[PIANO_TYPE]], device=DEV)}
    with torch.inference_mode():
        want = mine(features, generator=torch.Generator(
            device=DEV).manual_seed(SEED))['audio_synth'][0].cpu().numpy()
    want = want[int(0.5 * sr):]
    gap = float(np.abs(audio - want).max() / np.abs(want).max())
    if not gap <= CKPT_RENDER_TOL:
        fail(f"the --ckpt render differs from an in-process render of the "
             f"trainer's weights by {gap} of peak > {CKPT_RENDER_TOL}")

    other = get_model('maestro_v2', inference=True, device=DEV,
                      seed=SEED + 99)
    load_jax_params(other, export_jax_params(model))
    moved = [n for n, p in other.named_parameters()
             if not torch.equal(p, dict(model.named_parameters())[n])]
    if moved:
        fail(f"export_jax_params / load_jax_params changed {moved[:5]}")
    return dict(launches=launches, forwards=[r['seconds'] for r in runs],
                restores=[r['restore_seconds'] for r in runs],
                from_initial=from_initial, gap=gap,
                n_params=len(state))


def evaluation_sweeps(ckpt):
    """``evaluate_model --ckpt ... --duration 2`` over the mini-MAESTRO's
    test row (5 segments) at b = 1 and b = 4, each after a warm-up sweep;
    the warm-up of b = 4 records the kernels' inputs, and the counters are
    set to 0 just before the timed b = 4 sweep and read just after. The two
    CSVs must hold the same rows, their losses within EVAL_RTOL and
    finite; K1-K3 must have launched; each launch is held against its
    plain version at its inputs. The eval step alone (the batch on the
    card, CUDA events) is timed at both sizes."""
    from ddsp_piano_torch import evaluate_model as cli
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.data import pipeline
    from ddsp_piano_torch.kernels import build
    from ddsp_piano_torch.training.checkpoints import restore_params
    from ddsp_piano_torch.training.evaluation import (FEATURES,
                                                      build_segment_eval_fn)

    def sweep(batch_size, name):
        return cli.main(cli.process_args(
            ['--ckpt', ckpt, '--duration', str(EVAL_SECONDS), '-b',
             str(batch_size), '--device', DEV.type, MAESTRO_DIR,
             os.path.join(OUT_DIR, 'eval', name)]))

    sweep(1, 'warm_b1')
    b1 = sweep(1, 'b1')
    shapes = {}
    with capturing(shapes):
        sweep(4, 'warm_b4')
    sync()
    build.reset_launches()
    b4 = sweep(4, 'b4')
    sync()
    launches = dict(build.LAUNCHES)
    missing = [k for k in RENDER_KERNELS if launches[k] == 0]
    if missing:
        fail(f"the b=4 evaluation sweep launched no {missing} kernel: "
             f"{launches}")
    rows1, rows4 = b1['rows'], b4['rows']
    if len(rows1) != EVAL_SEGMENTS or b4['batches'] != 2:
        fail(f"{len(rows1)} segments in {b4['batches']} batches of 4")
    strip = lambda rows: [(r['filename'], r['piano_model']) for r in rows]
    if strip(rows1) != strip(rows4):
        fail(f"the sweeps' rows differ: {strip(rows1)} / {strip(rows4)}")
    loss1 = np.array([r['loss_val'] for r in rows1])
    loss4 = np.array([r['loss_val'] for r in rows4])
    rel = float(np.max(np.abs(loss4 - loss1) / np.abs(loss1)))
    if not (np.isfinite(loss1).all() and np.isfinite(loss4).all()
            and rel <= EVAL_RTOL):
        fail(f"segment losses b=1 {loss1} against b=4 {loss4}")
    kernel_ms = path_kernels(shapes, 'the b=4 evaluation sweep')

    model = get_model('maestro_v2', inference=True, duration=EVAL_SECONDS,
                      device=DEV)
    restore_params(model, ckpt)
    eval_step = build_segment_eval_fn(model)
    segments = list(pipeline.get_test_dataset(
        MAESTRO_DIR, duration=EVAL_SECONDS, batch_size=1,
        sample_rate=model.sample_rate, max_polyphony=model.n_synths))
    step_ms = {}
    for b in (1, 4):
        batch, _, _ = next(cli.batched_segments(iter(segments), b))
        batch = {k: torch.from_numpy(batch[k]).to(DEV)
                 for k in FEATURES + ('audio',)}
        step_ms[b] = median_ms(lambda: eval_step(batch, list(range(b))),
                               n=10) / b
    return dict(b1=b1, b4=b4, loss=loss1, rel=rel, launches=launches,
                kernel_ms=kernel_ms, step_ms=step_ms)


def tensorflow_line():
    """Whether ``import tensorflow`` works here, asked of a child process
    that sees no card (an environment fact, not a check)."""
    try:
        proc = subprocess.run(
            [sys.executable, '-c', 'import tensorflow as tf; '
             'print(tf.__version__)'], capture_output=True, text=True,
            timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES='',
                                  TF_CPP_MIN_LOG_LEVEL='3'))
    except subprocess.TimeoutExpired:
        return "import tensorflow: timed out after 300 s"
    if proc.returncode == 0:
        return f"import tensorflow: works (version {proc.stdout.strip()})"
    last = (proc.stderr.strip().splitlines() or ['?'])[-1]
    return f"import tensorflow: fails ({last})"


# -- phase 26 -----------------------------------------------------------------


def step_gradients(device, batch, noise, logmag_weight,
                   config='maestro_v2'):
    """The total loss and each trainable leaf's gradient (zeros for a leaf
    the step does not reach) of one phase-1 step from the student weights
    on ``device``."""
    from ddsp_piano_torch.configs import config_rates, get_model
    from ddsp_piano_torch.training.trainer import Trainer

    seconds = (batch['conditioning'].shape[1]
               / config_rates(config)['frame_rate'])
    model = get_model(config, device=device, seed=STUDENT_SEED,
                      duration=seconds)
    model.loss_objs[0].logmag_weight = logmag_weight
    trainer = Trainer(model, first_phase=True)
    losses = trainer.forward_backward(
        {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
        noise=noise.to(device))
    return (float(losses['total_loss']),
            {n: (torch.zeros(p.shape) if p.grad is None
                 else p.grad.detach().cpu())
             for n, p in trainer.named_params})


@contextlib.contextmanager
def plain_gru(dtype=torch.float32):
    """The GRU kernels' plain versions in their place, on the card too,
    computing in ``dtype`` and returning float32."""
    from ddsp_piano_torch.kernels import gru as kgru

    saved = kgru.gru_scan_cuda, kgru.gru_scan_bwd_cuda
    cast = lambda args: (a.to(dtype) if torch.is_tensor(a) else a
                         for a in args)
    kgru.gru_scan_cuda = lambda *args: kgru.gru_scan_plain(
        *cast(args)).float()
    kgru.gru_scan_bwd_cuda = lambda *args: tuple(
        s.float() for s in kgru.gru_scan_plain_bwd(*cast(args)))
    try:
        yield
    finally:
        kgru.gru_scan_cuda, kgru.gru_scan_bwd_cuda = saved


def gradient_gap(got, want):
    """Per leaf, max-abs difference over the leaf's peak in ``want``; the
    cosine between the two whole gradients."""
    errs = {k: ((got[k] - g).abs().max()
                / max(g.abs().max().item(), 1e-30)).item()
            for k, g in want.items()}
    a = torch.cat([g.flatten() for g in got.values()]).double()
    b = torch.cat([g.flatten() for g in want.values()]).double()
    return errs, float(a @ b / (a.norm() * b.norm()))


def gradient_check():
    """One step's gradients at batch 1, 1 s: cuda against the CPU plain
    path, with the v2 loss and with its magnitude term alone. Two more
    steps on cuda with the GRU kernels' plain versions in their place, in
    float32 and in float64, tell the kernels' share of the gap from the
    rest of the path's, and how far a GRU that rounds otherwise (here, less)
    moves the gradients."""
    batch = first_batch(1, seconds=GRAD_CHECK_SECONDS)
    batch.pop('filename', None)
    n_samples = batch['audio'].shape[-1]
    noise = 2.0 * torch.rand((16, n_samples), generator=torch.Generator(
        ).manual_seed(SEED + 2)) - 1.0
    out = {}
    for name, logmag_weight in (('magnitudes', 0.0), ('v2', 1.0)):
        loss_gpu, grads_gpu = step_gradients(DEV, batch, noise,
                                             logmag_weight)
        loss_cpu, grads_cpu = step_gradients('cpu', batch, noise,
                                             logmag_weight)
        with plain_gru():
            _, grads_plain_gru = step_gradients(DEV, batch, noise,
                                                logmag_weight)
        with plain_gru(torch.float64):
            _, grads_f64_gru = step_gradients(DEV, batch, noise,
                                              logmag_weight)
        errs, cosine = gradient_gap(grads_gpu, grads_cpu)
        worst = max(errs, key=errs.get)
        witness = {}
        for key, (got, want) in (
                ('plain_gru_vs_cpu', (grads_plain_gru, grads_cpu)),
                ('kernels_vs_plain_gru', (grads_gpu, grads_plain_gru)),
                ('f64_gru_vs_plain_gru', (grads_f64_gru, grads_plain_gru))):
            gap = gradient_gap(got, want)[0]
            leaf = max(gap, key=gap.get)
            witness[key] = (leaf, gap[leaf])
        tol = STEP_TOL_MAG if name == 'magnitudes' else STEP_TOL_V2
        if not (np.isfinite(loss_gpu) and errs[worst] <= tol
                and abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu)
                and (name == 'magnitudes' or cosine >= STEP_MIN_COSINE)):
            fail(f"{name} loss: cuda step differs from the cpu step: loss "
                 f"{loss_gpu} vs {loss_cpu}, worst leaf {worst} "
                 f"{errs[worst]} of its peak (tolerance {tol}), cosine "
                 f"{cosine}")
        out[name] = dict(loss_gpu=loss_gpu, loss_cpu=loss_cpu,
                         worst=worst, worst_err=errs[worst],
                         median_err=statistics.median(errs.values()),
                         cosine=cosine, n_leaves=len(errs), **witness)
    return out


# -- phases 5 and 8 -----------------------------------------------------------


def compare_segment(config, cpu):
    """The 3 s segment rendered on the card against its CPU render."""
    gpu = render_segment(DEV, config=config)
    errs = {k: float(np.abs(gpu[k] - cpu[k]).max()
                     / max(np.abs(cpu[k]).max(), 1e-30))
            for k in cpu}
    for stem in ('wet', 'dry'):
        if not errs[stem] <= SLICE_TOL:
            fail(f"{config}: {stem} render on cuda differs from the cpu "
                 f"render by {errs[stem]} of peak > {SLICE_TOL}; max-abs / "
                 f"peak of each output: {errs}")
    print(f"{config} cuda vs cpu plain, {SEGMENT_SECONDS:g} s: max-abs / "
          f"peak wet {errs['wet']:.3g}, dry {errs['dry']:.3g} (tolerance "
          f"{SLICE_TOL:g}); " + ', '.join(
              f"{k} {errs[k]:.3g}" for k in ('f0_hz', 'amplitudes',
                                            'reverb_ir', 'decays',
                                            'decay_time') if k in errs),
          flush=True)


# -- phase 13 -----------------------------------------------------------------


def soak_batches(trainer, n):
    """``n`` batches of the mini-MAESTRO's train split (shuffled), staged
    on the card before the soak, so that the data thread's cost stays out
    of it."""
    from ddsp_piano_torch.data import pipeline

    batches = pipeline.get_dataset(MAESTRO_DIR, split='train',
                                   duration=SEGMENT_SECONDS,
                                   batch_size=TRAIN_BATCH, shuffle=True,
                                   sample_rate=24000, max_polyphony=16,
                                   num_parallel_calls=1,
                                   shuffle_buffer_segments=16,
                                   seed=STUDENT_SEED)
    staged = [trainer.stage(next(batches)) for _ in range(n)]
    batches.close()
    return staged


def gate2_soak():
    """Teacher-student soak: maestro_v2 at full width, phase 1, student
    weights of seed 1, SOAK_STEPS steps of batch 6 x 3 s through the
    Trainer API on phase 9's mini-MAESTRO (the seed-0 teacher's render of
    demo.mid), cycling SOAK_BATCHES batches staged ahead. Fails on a
    non-finite loss or unless the mean of the last SOAK_WINDOW losses is
    below the mean of the first SOAK_WINDOW."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.kernels import build
    from ddsp_piano_torch.training.trainer import Trainer

    model = get_model('maestro_v2', device=DEV, seed=STUDENT_SEED)
    trainer = Trainer(model, first_phase=True, seed=STUDENT_SEED,
                      record_timeline=True)
    staged = soak_batches(trainer, SOAK_BATCHES)
    sync()
    build.reset_launches()
    losses = []
    start = time.perf_counter()
    for step in range(SOAK_STEPS):
        losses.append(trainer.train_step(staged[step % len(staged)])[
            'total_loss'])
    sync()
    wall = time.perf_counter() - start
    launches = dict(build.LAUNCHES)
    missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
    if missing:
        fail(f"the soak launched no {missing} kernel: {launches}")
    trainer.check_pending()
    losses = torch.stack(losses).float().cpu().numpy()
    if not np.isfinite(losses).all():
        fail(f"soak: non-finite losses at steps "
             f"{np.flatnonzero(~np.isfinite(losses)).tolist()}")
    head = float(np.mean(losses[:SOAK_WINDOW]))
    tail = float(np.mean(losses[-SOAK_WINDOW:]))
    if not tail < head:
        fail(f"soak: the mean of the last {SOAK_WINDOW} losses {tail:.4f} is "
             f"not below the mean of the first {SOAK_WINDOW} {head:.4f}")
    step_ms = statistics.median(t[0] for t in trainer.step_times()[1:])
    return dict(losses=losses, head=head, tail=tail, ratio=tail / head,
                step_ms=step_ms, wall_ms=1e3 * wall / SOAK_STEPS,
                launches=launches)


# -- phases 14-15 -------------------------------------------------------------


STREAM_KERNELS = ('oscillator_skip', 'gru_scan', 'note_release')


def demo_features(seconds=None, tiles=1):
    """demo.mid's conditioning on the card (all of it, or ``seconds`` after
    the 0.5 s warm-up), tiled ``tiles`` times along time."""
    from ddsp_piano_torch.data.io import load_midi_as_conditioning

    inputs = load_midi_as_conditioning(DEMO_MIDI, duration=seconds,
                                       warm_up_duration=0.5)
    tile = lambda x: torch.from_numpy(np.concatenate([x] * tiles, axis=1))
    return {'conditioning': tile(inputs['conditioning']).to(DEV),
            'pedal': tile(inputs['pedal']).to(DEV),
            'piano_model': torch.tensor([[PIANO_TYPE]], device=DEV)}


def stream_against_one_shot(model, features, chunk_frames, what):
    """The streamed render (uniform chunks) against the one-shot forward of
    the same model on the same features and one full-length noise draw:
    all but the flushed last frame within STREAM_TOL of peak, correlation
    above STREAM_MIN_CORR, wet and dry. Returns the wet and dry gaps."""
    from ddsp_piano_torch.models.streaming import StreamingSynthesizer

    up = model.sample_rate // model.frame_rate
    n_samples = features['conditioning'].shape[1] * up
    noise = 2.0 * torch.rand((model.n_synths, n_samples), device=DEV,
                             generator=torch.Generator(device=DEV
                                                       ).manual_seed(SEED)
                             ) - 1.0
    with torch.inference_mode():
        one = model(features, noise=noise)
        wet, dry = StreamingSynthesizer(model, chunk_frames
                                        ).synthesize_scanned(
            features, noise=noise, return_dry=True)
    gaps = {}
    for stem, got, want in (('wet', wet, one['audio_synth']),
                            ('dry', dry, one['add']['signal'])):
        a = want[0, :-up].double().cpu().numpy()
        b = got[0, :-up].double().cpu().numpy()
        err = float(np.abs(b - a).max() / np.abs(a).max())
        corr = float(np.corrcoef(a, b)[0, 1])
        if not (err <= STREAM_TOL and corr > STREAM_MIN_CORR):
            fail(f"{what}: streamed {stem} differs from the one-shot render "
                 f"by {err} of peak (tolerance {STREAM_TOL}), correlation "
                 f"{corr} (least {STREAM_MIN_CORR})")
        gaps[stem] = (err, corr)
    return gaps


def render_cost(fn, n=3):
    """(median forward seconds over ``n`` calls, peak bytes the card
    allocated above what was allocated before) of ``fn`` under
    inference_mode, each call after a sync."""
    times, peaks = [], []
    for _ in range(n):
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        with torch.inference_mode():
            out = fn()
        sync()
        times.append(time.perf_counter() - start)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        del out
    return statistics.median(times), max(peaks), times


def streaming_costs(model, chunk_frames, tiles=(1, STREAM_LONG_TILES),
                    seconds=None, model_for=None):
    """Forward time and peak memory, streamed (uniform chunks) against
    one-shot, on demo.mid (all of it, or ``seconds`` after the warm-up)
    and on all of its conditioning tiled (to ~180 s at 8 tiles); the noise
    drawn from a generator, as the CLI draws it. ``model_for(seconds)`` builds the
    model for a length (a z encoder is built for one), else ``model``."""
    from ddsp_piano_torch.models.streaming import (StreamingSynthesizer,
                                                   pad_to_chunks)

    costs = {}
    for n_tiles in tiles:
        name = 'demo' if n_tiles == 1 else 'tiled'
        features = pad_to_chunks(
            demo_features(seconds if n_tiles == 1 else None, tiles=n_tiles),
            chunk_frames)
        seconds_in = features['conditioning'].shape[1] / model.frame_rate
        if model_for is not None:
            model = model_for(seconds_in)
        gen = lambda: torch.Generator(device=DEV).manual_seed(SEED)
        streamer = StreamingSynthesizer(model, chunk_frames)
        row = {'seconds': seconds_in}
        for kind, fn in (
                ('one_shot', lambda: model(features, generator=gen())[
                    'audio_synth']),
                ('streamed', lambda: streamer.synthesize_scanned(
                    features, generator=gen()))):
            fn_time, peak, times = render_cost(fn)
            row[kind] = dict(forward=fn_time, peak=peak, times=times,
                             rtf=seconds_in / fn_time)
        costs[name] = row
        del features
        torch.cuda.empty_cache()
    return costs


def streaming_cli(config, seconds, oscillator, expected):
    """``synthesize_midi_file -c config --streaming --chunk_seconds
    STREAM_CHUNK_SECONDS`` on demo.mid: a warm-up run records the kernels'
    inputs; the counters are set to 0 just before the counted run and read
    just after; ``expected(chunks)`` gives each kernel's launches, which
    must be exact (every other kernel 0). Each launch is then held against
    its plain version at its inputs, and timed."""
    from ddsp_piano_torch import synthesize_midi_file as cli
    from ddsp_piano_torch.kernels import build

    out = os.path.join(OUT_DIR, f'demo_{config}_{oscillator}_stream.wav')
    argv = ['-c', config, '--streaming', '--chunk_seconds',
            str(STREAM_CHUNK_SECONDS), '-u', '--seed', str(SEED),
            '--piano_type', str(PIANO_TYPE), '--oscillator', oscillator,
            '--device', DEV.type]
    if seconds is not None:
        argv += ['-d', str(seconds)]
    args = cli.process_args(argv + [DEMO_MIDI, out])
    shapes = {}
    with capturing(shapes):
        cli.main(args)
    sync()
    build.reset_launches()
    result = cli.main(args)
    sync()
    launches = dict(build.LAUNCHES)
    want = dict.fromkeys(launches, 0)
    want.update(expected(result['chunks']))
    if launches != want:
        fail(f"{config} --streaming --oscillator {oscillator}: launches "
             f"{launches}, expected {want} for {result['chunks']} chunks")
    forwards = [result['seconds']] + timed_renders(cli, args)
    audio, sr = result['audio'], result['sample_rate']
    for name, x in (('wet', audio), ('dry', result['dry'])):
        rms = float(np.sqrt(np.mean(x.astype(np.float64) ** 2)))
        if not np.isfinite(x).all() or rms <= 1e-4:
            fail(f"{config} streamed {name} audio not finite or silent "
                 f"(rms {rms})")
    if os.path.getsize(out + '_unreverbed.wav') < audio.size:
        fail("the streamed render wrote no dry stem")
    seconds_out = len(audio) / sr
    forward = statistics.median(forwards)
    return dict(launches=launches, chunks=result['chunks'],
                forward=forward, forwards=forwards,
                rtf=seconds_out / forward, seconds=seconds_out,
                model=result['model'], bounds=bounds_line(shapes),
                kernel_ms=path_kernels(
                    shapes, f'{config} --streaming --oscillator {oscillator}'))


def v2_streaming():
    """Phase 14: the v2 streaming render of all of demo.mid through the
    CLI (K1, K2, K3 exactly (chunks + 1) x (1, 2, 1) times), the streamed
    library render against the one-shot on one draw, and streamed against
    one-shot forward time and peak memory at demo.mid and ~180 s."""
    from ddsp_piano_torch.models.streaming import pad_to_chunks

    run = streaming_cli('maestro_v2', None, 'skip', lambda n: {
        'oscillator_skip': n + 1, 'gru_scan': 2 * (n + 1),
        'note_release': n + 1})
    model = run.pop('model')
    chunk_frames = int(STREAM_CHUNK_SECONDS * model.frame_rate)
    run['gaps'] = stream_against_one_shot(
        model, pad_to_chunks(demo_features(), chunk_frames), chunk_frames,
        'v2 streaming')
    run['costs'] = streaming_costs(model, chunk_frames)
    return run


def dafx22_streaming():
    """Phase 15: ``-c dafx22 --streaming`` on 10 s of demo.mid with each
    oscillator: the Normalize sweeps (context: K2 a chunk; mono: K2 twice
    and K3 a chunk) then the render; K1 or K8, never both. Each run's
    streamed library render against the one-shot on one draw."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.models.streaming import pad_to_chunks

    runs = {}
    for oscillator, osc_kernel in (('skip', 'oscillator_skip'),
                                   ('full', 'oscillator_full')):
        run = streaming_cli('dafx22', MAIN_PATH_SECONDS, oscillator,
                            lambda n, k=osc_kernel: {
                                k: n + 1, 'gru_scan': 3 * n + 2 * (n + 1),
                                'note_release': n + (n + 1)})
        model = run.pop('model')
        chunk_frames = int(STREAM_CHUNK_SECONDS * model.frame_rate)
        features = pad_to_chunks(demo_features(MAIN_PATH_SECONDS),
                                 chunk_frames)
        # dafx22's z encoder is built for one length: the padded one.
        whole = get_model('dafx22', inference=True, device=DEV, seed=SEED,
                          duration=features['conditioning'].shape[1]
                          / model.frame_rate, oscillator=oscillator)
        run['gaps'] = stream_against_one_shot(
            whole, features, chunk_frames,
            f'dafx22 streaming --oscillator {oscillator}')
        runs[oscillator] = run
    return runs


def streaming_line(what, run):
    gaps = '; '.join(f"{stem} {err:.3g} (correlation {corr:.7f})"
                     for stem, (err, corr) in run['gaps'].items())
    return (f"{what}: demo.mid {run['seconds']:g} s in {run['chunks']} "
            f"chunks of {STREAM_CHUNK_SECONDS:g} s + the flush, on cuda; "
            f"forward {1e3 * run['forward']:.1f} ms ({run['rtf']:.1f}x "
            f"realtime; median of {forwards_text(run['forwards'])} ms); "
            f"launches {run['launches']}; streamed against one-shot "
            f"(library, one draw; all but the last frame): {gaps} "
            f"(tolerance {STREAM_TOL:g}); kernels at their own inputs, "
            f"each against its plain version: "
            + grouped_kernels_line(run['kernel_ms']))


def costs_line(costs, what='v2'):
    parts = []
    for name, row in costs.items():
        one, st = row['one_shot'], row['streamed']
        parts.append(
            f"{name} ({row['seconds']:g} s): one-shot "
            f"{1e3 * one['forward']:.1f} ms ({one['rtf']:.1f}x), peak "
            f"{one['peak'] / 2**20:.1f} MiB; streamed "
            f"{1e3 * st['forward']:.1f} ms ({st['rtf']:.1f}x), peak "
            f"{st['peak'] / 2**20:.1f} MiB; forwards ms one-shot "
            f"{forwards_text(one['times'])}, streamed "
            f"{forwards_text(st['times'])}")
    return (f'{what} streamed against one-shot (library API, medians of 3, '
            'peak memory above the model\'s): ' + ' | '.join(parts))


# -- phases 16-17 -------------------------------------------------------------


# The configurations ported last, each rendered with the default oscillator
# and enstdkcl_32khz also with the all-partials one (K8 at up = 128).
CONFIG_RENDERS = (('enstdkcl_8khz', 'skip'), ('enstdkcl_32khz', 'skip'),
                  ('enstdkcl_32khz', 'full'), ('multi_instruments', 'skip'),
                  ('surrogate', 'skip'), ('maestro_v2_regularized', 'skip'))
NEW_CONFIGS = ('enstdkcl_8khz', 'enstdkcl_32khz', 'multi_instruments',
               'surrogate', 'maestro_v2_regularized')
STEP_TIMED = 3                 # timed steps after the counted one
# A scalar leaf's gradient (NoteRelease's release_duration, the FDN's t60
# and tone) is one sum over every (row, frame) cell, with cancellation;
# the L1 magnitude term's sign flips where the card's and the CPU's
# magnitudes tie move it by more than a wide leaf's (measured 1.04e-3 of
# its peak for enstdkcl_8khz's release_duration). Held within
# STEP_TOL_SCALAR; every other leaf within STEP_TOL_MAG; the whole
# gradient's cosine at least STEP_MIN_COSINE_MAG.
STEP_TOL_SCALAR = 1e-2
STEP_MIN_COSINE_MAG = 0.99999


def render_kernels(config, oscillator):
    """The kernels a render of ``config`` launches. The surrogate synth
    renders its decaying partials with K10."""
    if config == 'surrogate':
        return ('oscillator_decay', 'gru_scan', 'note_release')
    return (f'oscillator_{oscillator}', 'gru_scan', 'note_release')


def step_kernels(config):
    """The kernels a phase-1 training step of ``config`` launches."""
    gru_nr = ('gru_scan', 'gru_scan_bwd', 'note_release_res',
              'note_release_bwd')
    if config == 'surrogate':
        return ('oscillator_decay', 'oscillator_decay_bwd') + gru_nr
    return ('oscillator_skip', 'oscillator_skip_bwd') + gru_nr


def check_launches(what, launches, want):
    missing = [k for k in want if launches.get(k, 0) == 0]
    unwanted = [k for k, n in launches.items() if n and k not in want]
    if missing or unwanted:
        fail(f"{what}: launches {launches} (must launch {list(want)} and "
             f"no other kernel)")


def memory_peak_mib(before):
    """(torch.cuda.max_memory_allocated, and its excess over ``before``,
    what was allocated when the peak was reset), MiB: the excess is the
    path's own, the rest what earlier phases and the path's model hold."""
    peak = torch.cuda.max_memory_allocated()
    return peak / 2 ** 20, (peak - before) / 2 ** 20


def launch_bound(kernel, args):
    """(ms, what bounds it) of one K1, K8, K10, K2 or K3 launch at its
    inputs, as the kernel lines reckon it (K10 at K1's count, a lower
    bound); None for another kernel."""
    if kernel == 'oscillator_decay':
        # K1's count of the same live terms: the envelope left out.
        controls, up, sr = args[0], args[3], args[4]
        return osc_bound(OSC_FLOPS_PER_TERM * live_cells(controls, sr) * up,
                         controls, up)
    if kernel in ('oscillator_skip', 'oscillator_full'):
        controls, up, sr = args[:3]
        if kernel == 'oscillator_skip':
            return osc_bound(OSC_FLOPS_PER_TERM * live_cells(controls, sr)
                             * up, controls, up)
        k = controls.f_lo.shape[-1]
        return osc_bound(sum(OSC_FULL_FLOPS_PER_TERM[w] * n * up * k
                             for w, n in osc_full_walks(controls, up,
                                                        sr).items()),
                         controls, up)
    if kernel == 'gru_scan':
        t, b, three_u = args[0].shape
        return gru_bound(t, b, three_u // 3)
    if kernel == 'note_release':
        t, b, _ = args[0].shape
        return bound(NR_FLOPS_PER_STEP * t * b, 4 * (2 * t * b + 1 + 4 * b))
    return None


def bounds_line(capture):
    """Each K1, K8, K2 and K3 shape of a capture with its bound."""
    seen = {}
    for kernel, calls in sorted(capture.items()):
        for args in calls:
            shape = tuple(args[0][0].shape if kernel.startswith(
                'oscillator') else args[0].shape)
            if (kernel, shape) not in seen:
                seen[kernel, shape] = launch_bound(kernel, to_card(args))
    return '; '.join(f"{k} {shape} {b[0]:.5f} ms ({b[1]})"
                     for (k, shape), b in seen.items() if b is not None)


def config_render(config, oscillator, label=None):
    """``synthesize_midi_file -c config`` on 10 s of demo.mid on the card,
    after a warm-up render that records the front doors' inputs; counters
    and peak memory set to 0 just before the counted render and read just
    after. Each launch is then held against its plain version at its
    inputs. ``label`` names the output file (default: the config)."""
    from ddsp_piano_torch import synthesize_midi_file as cli
    from ddsp_piano_torch.kernels import build

    out = os.path.join(OUT_DIR, f'demo_{label or config}_{oscillator}.wav')
    args = cli.process_args(['-c', config, '-d', str(MAIN_PATH_SECONDS),
                             '-u', '--seed', str(SEED), '--piano_type',
                             str(PIANO_TYPE), '--oscillator', oscillator,
                             '--device', DEV.type, DEMO_MIDI, out])
    what = f"{label or config} --oscillator {oscillator}"
    shapes = {}
    with capturing(shapes):
        cli.main(args)
    sync()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    build.reset_launches()
    result = cli.main(args)
    sync()
    launches = dict(build.LAUNCHES)
    peak_mib = memory_peak_mib(before)
    check_launches(what, launches, render_kernels(config, oscillator))
    forwards = [result['seconds']] + timed_renders(cli, args)
    audio, dry, sr = result['audio'], result['dry'], result['sample_rate']
    if audio.shape != (int(MAIN_PATH_SECONDS * sr),):
        fail(f"{what}: audio of shape {audio.shape} at {sr} Hz")
    rms = float(np.sqrt(np.mean(dry.astype(np.float64) ** 2)))
    if not (np.isfinite(audio).all() and np.abs(audio).max() > 0
            and np.isfinite(dry).all() and rms > 1e-4):
        fail(f"{what}: audio not finite, or silent (dry rms {rms})")
    forward = statistics.median(forwards)
    return dict(launches={k: n for k, n in launches.items() if n},
                forward=forward, forwards=forwards,
                rtf=MAIN_PATH_SECONDS / forward, peak_mib=peak_mib, sr=sr,
                kernel_ms=path_kernels(shapes, what),
                bounds=bounds_line(shapes))


def config_renders():
    """Phase 16: each configuration's render on the card, its launches
    checked, then its 3 s segment against the CPU's."""
    for config, oscillator in CONFIG_RENDERS:
        r = config_render(config, oscillator)
        print(f"{config} path, --oscillator {oscillator}: demo.mid "
              f"{MAIN_PATH_SECONDS:g} s at {r['sr']} Hz on cuda, forward "
              f"{r['forward'] * 1e3:.1f} ms ({r['rtf']:.1f}x realtime; "
              f"median of {forwards_text(r['forwards'])} ms), peak memory "
              f"{r['peak_mib'][0]:.1f} MiB (max_memory_allocated), "
              f"{r['peak_mib'][1]:.1f} above what was allocated before the "
              f"render; launches "
              f"{r['launches']}; kernels at its own inputs, each against "
              f"its plain version: " + grouped_kernels_line(r['kernel_ms'])
              + f"; bounds {r['bounds']}", flush=True)
        if oscillator == 'skip':
            compare_segment(config, render_segment('cpu', config=config))


def teacher_batch(config):
    """TRAIN_BATCH consecutive SEGMENT_SECONDS segments of demo.mid as a
    training batch, the target rendered on the card by the config's
    initial weights of seed SEED (its training-time model): numpy arrays,
    as the data pipeline gives them."""
    from ddsp_piano_torch.configs import config_rates, get_model
    from ddsp_piano_torch.data.io import load_midi_as_conditioning

    rates = config_rates(config)
    n_frames = int(SEGMENT_SECONDS * rates['frame_rate'])
    inputs = load_midi_as_conditioning(
        DEMO_MIDI, n_synths=rates['n_synths'],
        frame_rate=rates['frame_rate'],
        duration=TRAIN_BATCH * SEGMENT_SECONDS)
    batch = {'conditioning': inputs['conditioning'][0].reshape(
                 TRAIN_BATCH, n_frames, rates['n_synths'], 2),
             'pedal': inputs['pedal'][0].reshape(TRAIN_BATCH, n_frames, 4),
             'piano_model': np.full((TRAIN_BATCH, 1), PIANO_TYPE, np.int32)}
    teacher = get_model(config, device=DEV, seed=SEED,
                        duration=SEGMENT_SECONDS)
    with torch.inference_mode():
        audio = teacher({k: torch.from_numpy(v).to(DEV)
                         for k, v in batch.items()},
                        generator=torch.Generator(device=DEV).manual_seed(
                            SEED + 3))['audio_synth']
    batch['audio'] = audio.cpu().numpy()
    return batch


def step_path_kernels(capture, what, timed=True):
    """[(kernel, input shape, ms, err, note)] for each kernel launch of a
    training step, at its inputs: held against its plain version on the
    card (K1 within OSC_TOL of peak; K2 GRU_TOL absolute; K4 each control
    gradient within OSC_BWD_TOL of its peak; K5 each stream within
    GRU_BWD_TOL of its peak; K3, K6, K7 bit-exact), then, if ``timed``,
    its CUDA-event time (else ms is None). The note gives K4's bound (its
    sounding and silent cells) and K2's and K5's plan, time a step and
    bound."""
    from ddsp_piano_torch.kernels import (gru, note_release, oscillator,
                                          oscillator_decay)
    from ddsp_piano_torch.ops import oscillator as plain_osc

    def flat(fn):
        """K11 and its plain version with their DecayGrads as one
        tuple."""
        def call(*args):
            grads = fn(*args)
            return tuple(grads.controls) + (grads.decays, grads.decay_time)
        return call

    pairs = {
        'oscillator_skip': (oscillator.render_framewise_skip_cuda,
                            oscillator.render_framewise_plain),
        'oscillator_decay': (oscillator_decay.render_framewise_decay_cuda,
                             plain_osc.render_framewise_decay),
        'oscillator_decay_bwd': (
            flat(oscillator_decay.render_framewise_decay_bwd_cuda),
            flat(plain_osc.render_framewise_decay_vjp)),
        'gru_scan': (gru.gru_scan_cuda, gru.gru_scan_plain),
        'note_release': (note_release.note_release_scan_cuda,
                         note_release.note_release_scan_plain),
        'note_release_res': (note_release.note_release_scan_res_cuda,
                             note_release.note_release_scan_plain_res),
        'oscillator_skip_bwd': (oscillator.render_framewise_skip_bwd_cuda,
                                oscillator.render_framewise_vjp_plain),
        'gru_scan_bwd': (gru.gru_scan_bwd_cuda, gru.gru_scan_plain_bwd),
        'note_release_bwd': (note_release.note_release_scan_bwd_cuda,
                             note_release.note_release_scan_plain_bwd)}
    rows = []
    for kernel, calls in sorted(capture.items()):
        cuda, plain = pairs[kernel]
        for args in calls:
            with torch.no_grad():
                got, want = cuda(*args), plain(*args)
            sync()
            if kernel.startswith('note_release'):
                err = 0.0
                ok = all(torch.equal(a, w) for a, w in zip(got, want))
            elif kernel == 'gru_scan':
                err = (got - want).abs().max().item()
                ok = np.isfinite(err) and err <= GRU_TOL
            elif kernel in ('oscillator_skip', 'oscillator_decay'):
                err = ((got - want).abs().max()
                       / want.abs().max().clamp_min(1e-30)).item()
                ok = np.isfinite(err) and err <= OSC_TOL
            else:
                err = max(((a - w).abs().max()
                           / w.abs().max().clamp_min(1e-30)).item()
                          for a, w in zip(got, want))
                ok = np.isfinite(err) and err <= (
                    OSC_BWD_TOL if kernel in ('oscillator_skip_bwd',
                                              'oscillator_decay_bwd')
                    else GRU_BWD_TOL)
            del got, want
            shape = tuple(args[0][0].shape if kernel.startswith(
                'oscillator') else args[0].shape)
            if not ok:
                fail(f"{what}: {kernel} at its inputs {shape} differs from "
                     f"its plain version by {err}")
            if not timed:
                rows.append((kernel, shape, None, err, ''))
                continue
            ms = median_ms(lambda: cuda(*args), n=10)
            note = ''
            if kernel in ('oscillator_skip', 'oscillator_decay'):
                bound_ms, by = launch_bound(kernel, args)
                note = f" bound {bound_ms:.5f} ms ({by})"
            elif kernel == 'oscillator_skip_bwd':
                controls, _, up, sr = args
                bound_ms, by, sounding, silent = osc_bwd_bound(controls, up,
                                                               sr)
                note = (f" up={up}, cells sounding {sounding} silent "
                        f"{silent}, bound {bound_ms:.5f} ms ({by})")
            elif kernel in ('gru_scan', 'gru_scan_bwd'):
                t, b, three_u = args[0].shape
                u = three_u // 3
                bound_ms, by = (gru_bound if kernel == 'gru_scan'
                                else gru_bwd_bound)(t, b, u)
                note = (f" u={u} B={b}, {1e3 * ms / t:.3f} us/step, bound "
                        f"{bound_ms:.5f} ms ({by}); "
                        + plan_text(kernel, b, u))
            rows.append((kernel, shape, ms, err, note))
    return rows


def config_step(config):
    """Phase 17 for one configuration: a phase-1 training step (student
    seed STUDENT_SEED) on its teacher's batch on the card, counted and its
    kernel launches held against their plain versions; STEP_TIMED more
    steps timed with CUDA events; one step's gradients (the spectral
    loss's magnitude term and the regularisers) on the card against the
    CPU's on the same batch and noise draw."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.kernels import build
    from ddsp_piano_torch.training.trainer import Trainer

    what = f"{config} training step"
    batch = teacher_batch(config)
    model = get_model(config, device=DEV, seed=STUDENT_SEED,
                      duration=SEGMENT_SECONDS)
    trainer = Trainer(model, first_phase=True, seed=STUDENT_SEED)
    capture = {}
    sync()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    build.reset_launches()
    with capturing(capture, TRAIN_DOORS):
        losses = trainer.train_step(batch)
    sync()
    launches = {k: n for k, n in build.LAUNCHES.items() if n}
    peak_mib = memory_peak_mib(before)
    loss = float(losses['total_loss'])
    if not np.isfinite(loss):
        fail(f"{what}: loss {loss}")
    check_launches(what, launches, step_kernels(config))
    rows = step_path_kernels(capture, what)
    del capture
    staged = {k: torch.from_numpy(v).to(DEV) for k, v in batch.items()}
    step_ms = []
    for _ in range(STEP_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_step(staged)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    trainer.check_pending()
    del trainer, model, staged
    noise = noise_draw(config, TRAIN_BATCH, batch['audio'].shape[-1])
    loss_gpu, grads_gpu = step_gradients(DEV, batch, noise, 0.0, config)
    loss_cpu, grads_cpu = step_gradients('cpu', batch, noise, 0.0, config)
    errs, cosine = gradient_gap(grads_gpu, grads_cpu)
    worst = max(errs, key=errs.get)
    over = {k: e for k, e in errs.items()
            if e > (STEP_TOL_SCALAR if grads_cpu[k].numel() == 1
                    else STEP_TOL_MAG)}
    if not (np.isfinite(loss_gpu) and not over
            and cosine >= STEP_MIN_COSINE_MAG
            and abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu)):
        fail(f"{what}: cuda step differs from the cpu step: loss "
             f"{loss_gpu} vs {loss_cpu}, leaves over their tolerance "
             f"({STEP_TOL_MAG}, scalars {STEP_TOL_SCALAR}) {over}, cosine "
             f"{cosine}")
    return dict(loss=loss, launches=launches, peak_mib=peak_mib, rows=rows,
                step_ms=step_ms, loss_gpu=loss_gpu,
                loss_cpu=loss_cpu, worst=worst, worst_err=errs[worst],
                median_err=statistics.median(errs.values()), cosine=cosine,
                n_leaves=len(errs))


def noise_draw(config, batch_size, n_samples):
    """The noise synth's draw for a batch: (n_synths x batch, n_samples),
    from a seed, on the host."""
    from ddsp_piano_torch.configs import config_rates

    rows = config_rates(config)['n_synths'] * batch_size
    return 2.0 * torch.rand((rows, n_samples), generator=torch.Generator(
        ).manual_seed(SEED + 4)) - 1.0


def config_steps():
    """Phase 17: a training step of each configuration ported last."""
    for config in NEW_CONFIGS:
        r = config_step(config)
        print(f"{config} training step (b={TRAIN_BATCH}, "
              f"{SEGMENT_SECONDS:g} s, phase 1, student seed {STUDENT_SEED}, "
              f"on its seed-{SEED} teacher's batch) on cuda: loss "
              f"{r['loss']:.4f}; launches {r['launches']}; step "
              f"{statistics.median(r['step_ms']):.2f} ms (median of "
              + ' / '.join(f"{t:.2f}" for t in r['step_ms'])
              + f", CUDA events); peak memory {r['peak_mib'][0]:.1f} MiB, "
              f"{r['peak_mib'][1]:.1f} above what was allocated before the "
              f"step; "
              f"kernels at its inputs, each against its plain version: "
              + '; '.join(f"{k} {shape} {ms:.4f} ms (err {err:.3g}){note}"
                          for k, shape, ms, err, note in r['rows'])
              + f"; gradients (magnitude term and regularisers, "
              f"{r['n_leaves']} leaves) cuda vs cpu: loss "
              f"{r['loss_gpu']:.6f} vs {r['loss_cpu']:.6f}, worst leaf "
              f"{r['worst']} {r['worst_err']:.3g} of its peak (tolerance "
              f"{STEP_TOL_MAG:g}, scalars {STEP_TOL_SCALAR:g}), median "
              f"{r['median_err']:.3g}, cosine {r['cosine']:.7f}", flush=True)


# -- main ---------------------------------------------------------------------

# -- phase 18 -----------------------------------------------------------------


CACHE_DIR = os.path.join(OUT_DIR, 'maestro_cache')
CACHE_STEPS = 8                # -s of the phase's CLI runs
CACHE_K = 4                    # -k of its main run
CACHE_PROFILE = 4              # --profile of its main run
RECIPE_STEPS = 4
DEBUG_NANS_STEPS = 2
DEBUG_NANS_RTOL = 1e-4         # a loss, as phase 17 holds a step's loss
# K3 launches in the CLI run's validation batch.
CACHE_DOORS = TRAIN_DOORS + (
    ('ddsp_piano_torch.kernels.note_release', 'note_release_scan_cuda',
     'note_release'),)
CACHE_KERNELS = TRAIN_KERNELS + ('note_release',)


def preprocess_cache():
    """``python -m ddsp_piano_torch.preprocess_maestro`` of the
    mini-MAESTRO (a child process, as a user runs it), every cached array
    against the port's load_track of its row: (bytes, seconds, tracks)."""
    from ddsp_piano_torch.data import pipeline

    if os.path.isdir(CACHE_DIR):
        shutil.rmtree(CACHE_DIR)
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'ddsp_piano_torch.preprocess_maestro',
         MAESTRO_DIR, CACHE_DIR], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    seconds = time.perf_counter() - start
    if proc.returncode:
        fail(f"preprocess_maestro failed: {proc.stderr[-2000:]}")
    n_tracks = 0
    for split in ('validation', 'train'):
        with open(os.path.join(CACHE_DIR, f'index_{split}.json')) as f:
            index = json.load(f)
        rows, _, models = pipeline.dataset_from_csv(
            os.path.join(MAESTRO_DIR, 'maestro-v3.0.0.csv'), split=split)
        if len(rows) != len(index['tracks']):
            fail(f"cache {split}: {len(index['tracks'])} tracks for "
                 f"{len(rows)} rows")
        for row, name in zip(rows, index['tracks']):
            cached = dict(np.load(os.path.join(CACHE_DIR, name)))
            want = pipeline.load_track(row, MAESTRO_DIR, models, 24000, 250,
                                       16)
            if sorted(cached) != sorted(want) or not all(
                    np.array_equal(cached[k], np.asarray(want[k]))
                    and cached[k].dtype == np.asarray(want[k]).dtype
                    for k in want):
                fail(f"cache {split}/{name} differs from load_track")
            n_tracks += 1
    size = sum(os.path.getsize(os.path.join(CACHE_DIR, n))
               for n in os.listdir(CACHE_DIR))
    return size, seconds, n_tracks


def cli_run(data, name, flags, capture=None, steps=CACHE_STEPS, epochs=1):
    """``train_single_phase.main -b TRAIN_BATCH -s steps -e epochs`` with
    ``flags`` on ``data`` (student seed STUDENT_SEED), counters set to 0
    just before and read just after; its CUDA-event step median and wall
    time a step (the span of the last epoch's steps on the card over
    their count), both over the last epoch's steps; the run's peak
    memory (memory_peak_mib)."""
    from ddsp_piano_torch import train_single_phase as cli
    from ddsp_piano_torch.kernels import build

    exp = os.path.join(OUT_DIR, 'cache_exp', name)
    if os.path.isdir(exp):
        shutil.rmtree(exp)
    args = cli.process_args(['-b', str(TRAIN_BATCH), '-s', str(steps),
                             '-e', str(epochs), '--seed', str(STUDENT_SEED),
                             '--device', DEV.type] + flags + [data, exp])
    sync()
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    start = time.perf_counter()
    with capturing(capture, CACHE_DOORS):
        result = cli.main(args, record_timeline=True)
    sync()
    wall = time.perf_counter() - start
    peak_mib = memory_peak_mib(before)
    launches = {k: n for k, n in build.LAUNCHES.items() if n}
    losses = result['step_losses']
    if len(losses) != steps * epochs or not np.isfinite(losses).all():
        fail(f"{name}: training losses {losses}")
    if result.get('nan'):
        fail(f"{name}: {result['nan']}")
    events = result['trainer'].timeline[-steps:]
    events[-1][3].synchronize()
    step_ms = statistics.median(e[0].elapsed_time(e[3]) for e in events[1:])
    span_ms = events[0][0].elapsed_time(events[-1][3]) / steps
    return dict(result=result, launches=launches, wall=wall,
                step_ms=step_ms, wall_step_ms=span_ms, exp=exp,
                peak_mib=peak_mib)


def trace_kernels(path, top=8):
    """From a Chrome trace: the hand-written kernels' device events by
    counter name, and the ``top`` device operations by summed time."""
    with open(path) as f:
        events = [e for e in json.load(f).get('traceEvents', [])
                  if e.get('cat') == 'kernel']
    found = {k: sum(1 for e in events if piece in e.get('name', ''))
             for k, piece in KERNEL_SYMBOLS.items()}
    by_name = {}
    for e in events:
        by_name[e['name']] = by_name.get(e['name'], 0.0) + e.get('dur', 0.0)
    return found, sorted(by_name.items(), key=lambda kv: -kv[1])[:top]


def staging_bits(batch):
    """A host batch through each --staging on the card: the packed lanes'
    decode (packed and packed32) against the dict staging, bit for bit."""
    from ddsp_piano_torch.training.staging import BatchPacker
    from ddsp_piano_torch.training.trainer import BatchStager

    want = BatchStager(DEV)(batch)
    for wire in (True, False):
        packer = BatchPacker(batch, wire=wire)
        lanes = torch.from_numpy(packer.pack(batch).view(np.int16)).to(DEV)
        got = packer.unpack(lanes)
        sync()
        bad = [k for k in want if not (got[k].dtype == want[k].dtype
                                       and torch.equal(got[k], want[k]))]
        if bad or sorted(got) != sorted(want):
            fail(f"--staging {'packed' if wire else 'packed32'}: the card's "
                 f"decode differs from the dict batch at {bad}")
    return BatchPacker(batch).encodings()


def wire_bytes(batch):
    """Bytes a step puts on the host-to-device link for each --staging."""
    from ddsp_piano_torch.training.staging import BatchPacker

    return {'packed': BatchPacker(batch).wire_bytes(TRAIN_BATCH),
            'packed32': BatchPacker(batch, wire=False).wire_bytes(
                TRAIN_BATCH),
            'dict': sum(np.asarray(v).nbytes for k, v in batch.items()
                        if k != 'filename')}


def recipe_run():
    """``train_ddsp_piano.main -s RECIPE_STEPS -e 1`` on the cache: each
    phase's last_iter checkpoint, phase 2 holding phase 1's weights."""
    from ddsp_piano_torch import train_ddsp_piano as recipe

    exp = os.path.join(OUT_DIR, 'cache_exp', 'recipe')
    if os.path.isdir(exp):
        shutil.rmtree(exp)
    start = time.perf_counter()
    results = recipe.main(recipe.process_args(
        ['-s', str(RECIPE_STEPS), '-e', '1', '--seed', str(STUDENT_SEED),
         '--device', DEV.type, CACHE_DIR, exp]))
    sync()
    seconds = time.perf_counter() - start
    saved = []
    for phase in (1, 2, 3):
        path = os.path.join(exp, f'phase_{phase}', 'last_iter', 'ckpt.pt')
        if not os.path.isfile(path):
            fail(f"the recipe wrote no {path}")
        saved.append(torch.load(path, map_location='cpu',
                                weights_only=True))
    if [s['step'] for s in saved] != [RECIPE_STEPS * p for p in (1, 2, 3)]:
        fail("the recipe's phases ended at steps "
             f"{[s['step'] for s in saved]}")
    if not all(torch.equal(saved[1]['model'][k], v)
               for k, v in saved[0]['model'].items()):
        fail("the recipe's phase 2 does not hold phase 1's weights")
    losses = [r['step_losses'] for r in results]
    if not all(len(v) == RECIPE_STEPS and np.isfinite(v).all()
               for v in losses):
        fail(f"the recipe's losses {losses}")
    return seconds, [v[-1] for v in losses]


def cache_path():
    """Phase 18: the training path as a user runs it, from the cache."""
    phase_start = time.perf_counter()
    size, prep_seconds, n_tracks = preprocess_cache()
    batch = first_batch(TRAIN_BATCH)
    capture = {}
    main = cli_run(CACHE_DIR, 'k4_profile', [
        '-k', str(CACHE_K), '--profile', str(CACHE_PROFILE)], capture)
    launches = main['launches']
    missing = [k for k in CACHE_KERNELS if launches.get(k, 0) == 0]
    if missing:
        fail(f"the cache path launched no {missing} kernel: {launches}")
    rows = step_path_kernels(capture, 'the cache path', timed=False)
    del capture
    trace = main['result'].get('profile')
    if not trace or not os.path.isfile(trace):
        fail(f"--profile wrote no trace ({trace})")
    found, top = trace_kernels(trace)
    if not any(found.values()):
        fail(f"the trace {trace} holds no device event of a hand-written "
             "kernel")
    runs = {}
    for name, data, flags in (
            ('cache', CACHE_DIR, []), ('raw', MAESTRO_DIR, []),
            ('cache_k4', CACHE_DIR, ['-k', str(CACHE_K)]),
            ('packed32', CACHE_DIR, ['--staging', 'packed32']),
            ('dict', CACHE_DIR, ['--staging', 'dict'])):
        r = cli_run(data, name, flags)
        runs[name] = dict(step_ms=r['step_ms'], wall_step_ms=r['wall_step_ms'])
    recipe_seconds, recipe_losses = recipe_run()
    plain = cli_run(CACHE_DIR, 'nans_off', [], steps=DEBUG_NANS_STEPS)
    traced = cli_run(CACHE_DIR, 'nans_on', ['--debug_nans'],
                     steps=DEBUG_NANS_STEPS)
    want = plain['result']['step_losses']
    got = traced['result']['step_losses']
    if not np.allclose(got, want, rtol=DEBUG_NANS_RTOL, atol=0):
        fail(f"--debug_nans losses {got} against {want}")
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'ddsp_piano_torch.configs.gin_test',
         'maestro_v2'], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    gin_seconds = time.perf_counter() - start
    if proc.returncode or 'train step ok on cuda' not in proc.stdout:
        fail(f"gin_test maestro_v2 failed: {proc.stdout[-1000:]} "
             f"{proc.stderr[-2000:]}")
    return dict(size=size, prep_seconds=prep_seconds, n_tracks=n_tracks,
                launches=launches, rows=rows, trace=trace, found=found,
                top=top, step_ms=main['step_ms'],
                wall_step_ms=main['wall_step_ms'], runs=runs,
                wire=wire_bytes(batch), encodings=staging_bits(batch),
                recipe_seconds=recipe_seconds, recipe_losses=recipe_losses,
                nans=(got, want, got == want), gin_seconds=gin_seconds,
                gin_last=proc.stdout.strip().splitlines()[-1],
                seconds=time.perf_counter() - phase_start)


def checked_line(rows):
    """The launches of one kernel at one shape merged: their count and
    largest error against the plain version."""
    groups = {}
    for k, shape, _, err, _ in rows:
        groups.setdefault((k, shape), []).append(err)
    return '; '.join(f"{k} {shape} x{len(v)} (err at most {max(v):.3g})"
                     for (k, shape), v in groups.items())


def cache_path_lines(c):
    runs = c['runs']
    ratio = lambda a, b: runs[a]['step_ms'] / runs[b]['step_ms']
    return [
        f"cache path: preprocess_maestro of the mini-MAESTRO, {c['n_tracks']} "
        f"tracks, {c['size']} bytes in {c['prep_seconds']:.2f} s, each "
        f"cached array bit-equal to load_track",
        f"cache path: train_single_phase -b {TRAIN_BATCH} -s {CACHE_STEPS} "
        f"-e 1 -k {CACHE_K} --profile {CACHE_PROFILE} on the cache: launches "
        f"{c['launches']}; every launch against its plain version: "
        + checked_line(c['rows'])
        + f"; step median {c['step_ms']:.2f} ms (CUDA events), wall "
        f"{c['wall_step_ms']:.2f} ms a step",
        f"cache path trace {os.path.relpath(c['trace'], ROOT)}: hand-written "
        f"kernels' device events {c['found']}; top device operations (ms "
        f"over {CACHE_PROFILE} steps): " + '; '.join(
            f"{name[:60]} {us / 1e3:.3f}" for name, us in c['top']),
        f"cache path CLI step (-b {TRAIN_BATCH} -s {CACHE_STEPS}, median of "
        "steps 2 on, CUDA events / wall a step): " + '; '.join(
            f"{k} {v['step_ms']:.2f} / {v['wall_step_ms']:.2f} ms"
            for k, v in runs.items())
        + f"; cache against raw {ratio('cache', 'raw'):.3f}, -k {CACHE_K} "
        f"against -k 1 {ratio('cache_k4', 'cache'):.3f}, packed32 against "
        f"packed {ratio('packed32', 'cache'):.3f}, dict against packed "
        f"{ratio('dict', 'cache'):.3f}; wire bytes a step "
        f"{c['wire']}; packed encodings {c['encodings']}, the card's decode "
        f"of packed and packed32 bit-equal to the dict batch",
        f"cache path recipe: train_ddsp_piano -s {RECIPE_STEPS} -e 1, "
        f"phases 1-3 in {c['recipe_seconds']:.1f} s, last losses "
        + ', '.join(f"{v:.4f}" for v in c['recipe_losses'])
        + "; phase 2 holds phase 1's weights",
        f"cache path --debug_nans: {DEBUG_NANS_STEPS} steps' losses "
        f"{[round(v, 6) for v in c['nans'][0]]} against "
        f"{[round(v, 6) for v in c['nans'][1]]} without it (rtol "
        f"{DEBUG_NANS_RTOL:g}); bit-equal: {c['nans'][2]}",
        f"cache path gin_test maestro_v2 on cuda: {c['gin_last']} "
        f"({c['gin_seconds']:.1f} s); phase {c['seconds']:.1f} s",
    ]


# -- phases 19-21 -------------------------------------------------------------


SERVE_BATCHES = (1, 8)         # b = 8: the batch of the JAX served number
SERVE_TIMED = 3                # CUDA-event median of 3, after a warm-up
# A share of peak: the served audio against the forward on the host
# allocator's conditioning (bit-identical) with the same generator, as the
# --ckpt render is held against an in-process render.
SERVE_TOL = CKPT_RENDER_TOL
SERVE_KERNELS = {'oscillator_skip': 1, 'gru_scan': 2, 'note_release': 1,
                 'voice_allocator': 1}
VA_VOICES = 16                 # v2's polyphony
VA_CHURN = (4, 500)            # rows and frames of the over-capacity roll
# Unsorted frames with repeated pitches, 0.0, -0.0 and NaN (3 rows each):
# case -> (seed, frames).
VA_ODD = {'odd roll': (0, 500), 'odd roll T=1': (1, 1),
          'odd roll T=33': (2, 33)}
CSV_ROWS = (('demo.mid', 3, 'Johann Sebastian Bach'),
            ('demo.mid', 7, 'Frederic Chopin'))
# Per row: K1, K2, K3 and K9 launches of the CLI with --decompose (the
# forward, then the stems' one additive call).
CSV_KERNELS = {'oscillator_skip': 2, 'gru_scan': 2, 'note_release': 1,
               'voice_allocator': 1}
STREAM_CONFIGS = (('enstdkcl_8khz', 'skip'), ('enstdkcl_32khz', 'skip'),
                  ('enstdkcl_32khz', 'full'), ('surrogate', 'skip'))


def va_walk(n, t, n_fast, n_skipped):
    """A row's frames in K9's walk, (slow, walked fast), from the plain
    version's counts: every slow frame is walked, and every fast frame
    the skip rule does not skip."""
    return t - n_fast, n_fast - n_skipped


def va_ops(n, t, slow, fast):
    """K9's operations over one row, counted from its source: classify 2 n
    a frame (compares and ands); the walk per (walked frame, lane) 7 n +
    10 on the fast path (the comparison loop: two shuffles, two compares,
    two ors and a select a slot; the ballots) and 13 n + 120 on the slow
    one (besides those, ~110 for the ballots, counts, the nth_bit searches
    and selects of the closed-form scatter, and 6 n for the mirror test);
    the fill ~20 a (frame, slot) (the index arithmetic, the mask test,
    __clz, the gathers)."""
    return 2 * n * t + n * (fast * (7 * n + 10) + slow * (13 * n + 120)) \
        + 20 * n * t


def va_stage_bytes(n, t, slow, fast):
    """K9's traffic over one row by stage (classify, walk, fill): the
    classify reads the pitches and writes a 4-byte word per 32 frames;
    the walk reads the words and the pitches of the frames it loads (at
    most the walked ones), writes each walked frame's int8 permutation and
    each word's anchor; the fill reads pitches, velocities, words, anchors
    and the walked permutations, and writes (pitch, velocity) a (frame,
    slot)."""
    words = -(-t // 32)
    walked = slow + fast
    return (4 * t * n + 4 * words,
            4 * words + 4 * walked * n + walked * n + 4 * words,
            8 * t * n + 8 * words + walked * n + 8 * t * n)


def va_chain(n, slow, fast):
    """K9's dependent operations over one row's walk: n + 4 a walked fast
    frame (the comparison loop's accumulators chain, the fast test), n +
    44 a slow one (~40 more for the ballots, counts, nth_bit searches and
    selects between them). Not counted, so that this stays a lower bound:
    the mirror test after a slow frame that the next frame equals (n + 4),
    and a few operations a skipped 32-frame word."""
    return slow * (n + 44) + fast * (n + 4)


VA_TIMED = tuple(f'demo roll b={b}' for b in SERVE_BATCHES) + (
    'over-capacity binary roll',)


def check_voice_allocator(cases):
    """K9 against its plain version on the card, bit for bit (NaN payloads
    and signed zeros included), at each case's (pitches, velocity); at
    each case of VA_TIMED the call and card times (the card time of its
    three kernels), the frames its walk takes (slow, fast) and skips, its
    chain bound and its stages' bytes; the plain time at the first. The
    kernels line's row: the first case, its bound (bytes or operations, of
    the frames this roll walks)."""
    from ddsp_piano_torch.kernels import voice_allocator as va

    walks = {}
    with torch.inference_mode():
        for what, (p, v) in cases.items():
            got = va.allocate_cuda(p, v)
            want, n_fast, n_skipped = va.allocate_plain(p, v,
                                                        return_fast=True)
            sync()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                bad = int((got.view(torch.int32) != want.view(torch.int32))
                          .any(-1).sum())
                fail(f"voice_allocator at {what} {tuple(p.shape)}: {bad} "
                     f"(frame, slot) entries differ from its plain version")
            b, t, n = p.shape
            walks[what] = [va_walk(n, t, f, k) + (k,) for f, k in zip(
                n_fast.tolist(), n_skipped.tolist())]
        timed = {}
        for what in VA_TIMED:
            p, v = cases[what]
            timed[what] = dict(
                ms=median_ms(lambda: va.allocate_cuda(p, v)),
                card=statistics.median(card_times(
                    lambda: va.allocate_cuda(p, v))))
        p, v = cases[VA_TIMED[0]]
        plain = statistics.median(event_times(
            lambda: va.allocate_plain(p, v), n=1, warmup=0))
    clock = sm_clock_mhz()[0]
    parts = []
    for what in VA_TIMED:
        b, t, n = cases[what][0].shape
        rows = walks[what]
        chain = max(va_chain(n, slow, fast) for slow, fast, _ in rows)
        stages = [sum(x) for x in zip(*(va_stage_bytes(n, t, slow, fast)
                                        for slow, fast, _ in rows))]
        timed[what].update(
            chain=chain,
            chain_ms=chain * CYCLES_PER_DEPENDENT_OP / (clock * 1e3),
            ops=sum(va_ops(n, t, slow, fast) for slow, fast, _ in rows),
            nbytes=16 * b * t * n)
        r = timed[what]
        parts.append(
            f"at {what} {(b, t, n)}: {r['ms']:.4f} ms, card {r['card']:.4f} "
            f"ms; walked slow / fast, skipped, a row "
            + ', '.join(f"{s}/{f} {k}" for s, f, k in rows[:4])
            + (' ...' if len(rows) > 4 else '')
            + f"; chain_bound_ms {r['chain_ms']:.5f} ({r['chain']} dependent "
            f"operations x {CYCLES_PER_DEPENDENT_OP} cycles at {clock:.0f} "
            f"MHz); stage bytes classify / walk / fill "
            + ' / '.join(str(x) for x in stages))
    first = timed[VA_TIMED[0]]
    bound_ms, bound_by = bound(first['ops'], first['nbytes'])
    row = dict(name='voice_allocator', max_abs_err=0.0, ms=first['ms'],
               card_ms=first['card'], plain_ms=plain, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None)
    detail = (f"bit-exact against its plain version at "
              + ', '.join(f"{w} {tuple(c[0].shape)}"
                          for w, c in cases.items())
              + '; ' + '; '.join(parts))
    return row, detail


def serving_path():
    """Phase 19: make_serving_fn over demo.mid's roll (10 s after the
    0.5 s warm-up) with v2 at full width, at b = 1 and 8 (the roll
    repeated, a piano a row): K9 bit-exact against its plain version on
    the demo roll, a seeded over-capacity binary roll and the VA_ODD
    frames, and timed at VA_TIMED (check_voice_allocator); each batch's
    warm-up serve records the K1, K2 and K3 inputs, and each of those
    launches is held against its plain version at them; each batch's
    counted serve (counters set to 0 just before, read just after: K1,
    K2 twice, K3 and K9 once, no other kernel), its served audio against
    the forward on the host allocator's conditioning with the same
    generator, and its CUDA-event serve time."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.data.io import load_midi_as_roll
    from ddsp_piano_torch.data.midi_encoders import MIDIRoll2Conditioning
    from ddsp_piano_torch.data.midi_encoders_device import top_voices
    from ddsp_piano_torch.data.rolls import churn_roll, odd_voices
    from ddsp_piano_torch.kernels import build
    from ddsp_piano_torch.models.serving import make_serving_fn

    demo = load_midi_as_roll(DEMO_MIDI, duration=MAIN_PATH_SECONDS,
                             warm_up_duration=0.5)
    frames = demo['roll'].shape[1]
    model = get_model('maestro_v2', inference=True, device=DEV, seed=SEED,
                      duration=frames / 250)
    serve = make_serving_fn(model, seed=SEED)
    host, _ = MIDIRoll2Conditioning(model.n_synths)(demo['roll'][0].copy())
    host = host.astype(np.float32)
    churn = np.stack([churn_roll(s, VA_VOICES, VA_CHURN[1])
                      for s in range(VA_CHURN[0])])
    cases = {}
    runs = {}
    for b in SERVE_BATCHES:
        roll = torch.from_numpy(np.repeat(demo['roll'], b, 0)).to(DEV)
        pedal = torch.from_numpy(np.repeat(demo['pedal'], b, 0)).to(DEV)
        piano = (PIANO_TYPE + torch.arange(b, device=DEV)[:, None]) % 10
        cases[f'demo roll b={b}'] = top_voices(roll, VA_VOICES)
        shapes = {}
        with capturing(shapes):
            serve(roll, pedal, piano)
        sync()
        build.reset_launches()
        audio = serve(roll, pedal, piano)
        sync()
        launches = {k: n for k, n in build.LAUNCHES.items() if n}
        if launches != SERVE_KERNELS:
            fail(f"serve at b={b}: launches {launches}, expected "
                 f"{SERVE_KERNELS}")
        features = {'conditioning': torch.from_numpy(
                        np.repeat(host[None], b, 0)).to(DEV),
                    'pedal': pedal, 'piano_model': piano}
        with torch.inference_mode():
            want = model(features, generator=torch.Generator(
                device=DEV).manual_seed(SEED))['audio_synth']
        up = model.sample_rate // model.frame_rate
        if tuple(audio.shape) != (b, frames * up) or not bool(
                torch.isfinite(audio).all()):
            fail(f"serve at b={b}: audio {tuple(audio.shape)}, or not finite")
        gap = ((audio - want).abs().max() / want.abs().max()).item()
        if not gap <= SERVE_TOL:
            fail(f"serve at b={b}: {gap} of peak from the forward on the "
                 f"host allocator's conditioning (tolerance {SERVE_TOL})")
        times = event_times(lambda: serve(roll, pedal, piano),
                            n=SERVE_TIMED, warmup=1)
        runs[b] = dict(launches=launches, gap=gap, times=times,
                       ms=statistics.median(times),
                       rtf=b * frames / 250 / (statistics.median(times)
                                               / 1e3),
                       kernel_ms=path_kernels(shapes, f'serve b={b}'),
                       bounds=bounds_line(shapes))
    cases['over-capacity binary roll'] = top_voices(
        torch.from_numpy(churn).to(DEV), VA_VOICES)
    for what, (seed, frames_odd) in VA_ODD.items():
        cases[what] = tuple(torch.from_numpy(a).to(DEV) for a in odd_voices(
            seed, 3, frames_odd, VA_VOICES))
    row, detail = check_voice_allocator(cases)
    return dict(runs=runs, row=row, detail=detail, seconds=frames / 250)


def csv_path():
    """Phase 20: ``python -m ddsp_piano_torch.synthesize_from_csv -d 10
    --decompose`` over a two-row CSV of demo.mid with v2 at full width on
    ``cuda``, counters set to 0 just before and read just after (a row: K1
    twice, the forward's and the stems', K2 twice, K3 and K9 once): the
    eight wav files finite and 10 s each; each launch held against its
    plain version at its inputs."""
    import csv

    from ddsp_piano_torch import synthesize_from_csv as csv_cli
    from ddsp_piano_torch.kernels import build

    directory = os.path.join(OUT_DIR, 'csv')
    os.makedirs(directory, exist_ok=True)
    csv_file = os.path.join(directory, 'performances.csv')
    with open(csv_file, 'w', newline='') as f:
        writer = csv.writer(f)
        writer.writerow(csv_cli.REQUIRED_COLUMNS)
        writer.writerows(CSV_ROWS)
    args = csv_cli.process_args(
        ['-d', str(MAIN_PATH_SECONDS), '--decompose', '--device', DEV.type,
         os.path.dirname(DEMO_MIDI), csv_file, os.path.join(directory, 'out')])
    shapes = {}
    sync()
    build.reset_launches()
    start = time.perf_counter()
    with capturing(shapes):
        written = csv_cli.main(args)
    sync()
    seconds = time.perf_counter() - start
    launches = {k: n for k, n in build.LAUNCHES.items() if n}
    want = {k: n * len(CSV_ROWS) for k, n in CSV_KERNELS.items()}
    if launches != want:
        fail(f"synthesize_from_csv --decompose: launches {launches}, "
             f"expected {want}")
    if len(written) != 4 * len(CSV_ROWS):
        fail(f"synthesize_from_csv wrote {sorted(written)}")
    n_samples = int(MAIN_PATH_SECONDS * 24000)
    for path, audio in written.items():
        if audio.shape != (n_samples,) or not np.isfinite(audio).all() or (
                not np.abs(audio).max() > 0):
            fail(f"{path}: {audio.shape} samples, not finite or silent")
    rms = {os.path.basename(p): float(np.sqrt(np.mean(a.astype(
        np.float64) ** 2))) for p, a in written.items()}
    return dict(launches=launches, seconds=seconds, rms=rms,
                kernel_ms=path_kernels(shapes, 'synthesize_from_csv'),
                bounds=bounds_line(shapes))


def stream_launches(config, oscillator):
    """The launches of a ``--streaming`` render of n chunks (and the
    flush): each Normalize sweep runs the control path to its slot (K2 a
    chunk for the context slot; the surrogate's mono slot, ahead of its
    GRU, adds K2 and K3 a chunk), then the render (K2 twice, K3 and the
    oscillator, K10 for the surrogate, once a chunk)."""
    def expected(n):
        if config == 'surrogate':
            return {'oscillator_decay': n + 1,
                    'gru_scan': 2 * n + 2 * (n + 1),
                    'note_release': n + (n + 1)}
        return {f'oscillator_{oscillator}': n + 1,
                'gru_scan': n + 2 * (n + 1), 'note_release': n + 1}
    return expected


def config_streaming():
    """Phase 21: ``--streaming`` of 10 s of demo.mid at 4 s chunks for
    enstdkcl_8khz, enstdkcl_32khz (each oscillator) and the surrogate, as
    phases 14-15: launches exact, each launch against its plain version,
    the streamed library render against the one-shot forward on one draw;
    streamed against one-shot forward time and peak memory at 10 s, and
    the surrogate's also tiled to ~180 s."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.models.streaming import pad_to_chunks

    runs = {}
    for config, oscillator in STREAM_CONFIGS:
        start = time.perf_counter()
        run = streaming_cli(config, MAIN_PATH_SECONDS, oscillator,
                            stream_launches(config, oscillator))
        model = run.pop('model')
        chunk_frames = int(STREAM_CHUNK_SECONDS * model.frame_rate)
        features = pad_to_chunks(demo_features(MAIN_PATH_SECONDS),
                                 chunk_frames)
        build_for = functools.partial(get_model, config, inference=True,
                                      device=DEV, seed=SEED,
                                      oscillator=oscillator)
        # A z encoder is built for one length: the padded one.
        run['gaps'] = stream_against_one_shot(
            build_for(duration=features['conditioning'].shape[1]
                      / model.frame_rate), features, chunk_frames,
            f'{config} streaming --oscillator {oscillator}')
        if oscillator == 'skip':
            tiles = (1, STREAM_LONG_TILES) if config == 'surrogate' else (1,)
            run['costs'] = streaming_costs(
                model, chunk_frames, tiles=tiles, seconds=MAIN_PATH_SECONDS,
                model_for=lambda s: build_for(duration=s))
        run['phase_seconds'] = time.perf_counter() - start
        runs[config, oscillator] = run
    return runs



# -- phases 22-23 -------------------------------------------------------------


SUMMARY_STEPS = 2              # -s of the summaries run
SUMMARY_EPOCHS = 3             # -e: epoch 3 takes the full validation
SUMMARY_CLIPS = 4              # the audio summary's clips (max_outputs)
GIN_STEPS = 2                  # -s of the gin model's training run
GIN_SHIFT = 1234               # the noise bands' loop shift of the segments


def summary_tags(loss_keys, steps, epochs):
    """The (tag, step) sequence the JAX CLI writes (train_single_phase.py:
    248-315): train_loss at each epoch's first step; while the step after
    the epoch is below 3 epochs, one batch's audio at that step; after
    that val_loss, the audio, the spectrogram and the tuning curves at the
    epoch's first step. The v2 joint tuning gives both curves."""
    tags = []
    for epoch in range(epochs):
        first = epoch * steps
        tags += [(f'train_loss/{k}', first) for k in loss_keys]
        if first + steps < 3 * steps:
            tags.append(('synthesized_audio', first + steps))
            continue
        tags += [(f'val_loss/{k}', first) for k in loss_keys]
        tags += [('synthesized_audio', first), ('spectrogram', first),
                 ('tuning/inharmonicity', first), ('tuning/tuning', first)]
    return tags


def summaries_path():
    """Phase 22: ``train_single_phase -c maestro_v2 -b 6 -s 2 -e 3`` on the
    cache, counted; its event file read back with the port's reader: each
    tag the JAX CLI writes at its step, each train_loss/total_loss equal
    to the CLI's epoch mean, the last audio summary's WAVs decoded to the
    first validation batch's audio (re-rendered with the same generator)
    within 1/32767. Every kernel launch of the run held against its plain
    version at its inputs."""
    from ddsp_piano_torch.data import pipeline
    from ddsp_piano_torch.training import events

    capture = {}
    run = cli_run(CACHE_DIR, 'summaries', [], capture, steps=SUMMARY_STEPS,
                  epochs=SUMMARY_EPOCHS)
    rows = step_path_kernels(capture, 'the summaries run', timed=False)
    del capture
    result = run['result']
    trainer = result['trainer']
    path = result['events']
    start = time.perf_counter()
    evs = events.read_events(path)
    read_ms = 1e3 * (time.perf_counter() - start)
    if evs[0]['file_version'] != 'brain.Event:2':
        fail(f"{path}: first record {evs[0]}")
    seen = [(v['tag'], e['step']) for e in evs[1:] for v in e['values']]
    want = summary_tags(trainer.model.loss_keys(), SUMMARY_STEPS,
                        SUMMARY_EPOCHS)
    if seen != want:
        fail(f"summaries: tags {seen}, the JAX CLI's {want}")
    values = [v for e in evs[1:] for v in e['values']]
    totals = [events.value_array(v) for v in values
              if v['tag'] == 'train_loss/total_loss']
    means = [np.float32(m['total_loss']) for m in result['train_means']]
    if totals != means:
        fail(f"summaries: train_loss/total_loss {totals}, epoch means "
             f"{means}")
    clips = events.value_array([v for v in values
                                if v['tag'] == 'synthesized_audio'][-1])
    val_batch = next(iter(pipeline.get_validation_dataset(
        CACHE_DIR, batch_size=TRAIN_BATCH,
        max_polyphony=trainer.model.n_synths,
        sample_rate=trainer.model.sample_rate)))
    _, audio = trainer.validation_step(val_batch)
    peak = max(float(np.abs(audio).max()), 1.0)
    wav_err = 0.0
    for i, (wav, _) in enumerate(clips):
        decoded, rate = events.decode_wav(wav)
        if rate != trainer.model.sample_rate:
            fail(f"summaries: a WAV at {rate} Hz")
        wav_err = max(wav_err, float(np.abs(decoded[:, 0]
                                            - audio[i] / peak).max()))
    if len(clips) != min(SUMMARY_CLIPS, len(audio)) or \
            not wav_err <= 1.0 / 32767:
        fail(f"summaries: {len(clips)} clips, decoded against the "
             f"validation audio {wav_err} > 1/32767")
    images = [v for v in values if v['plugin_name'] == 'images']
    for v in images:
        events.decode_png(events.value_array(v)[0])
    return dict(launches=run['launches'], rows=rows,
                summary_ms=result['summary_ms'], bytes=os.path.getsize(path),
                n_values=len(values), n_images=len(images),
                wav_err=wav_err, n_clips=len(clips), read_ms=read_ms,
                step_ms=run['step_ms'])


def gin_text_v2():
    """Gin text (i): a v2-width polyphonic model (24 kHz, 16 voices; the
    FiLM context with GRU 64, the mono network with GRU 192, NoteRelease)
    with DeepInharmonicity + DictDetuner for the tuning, PartialMasking,
    BackgroundNoiseFilter, MultiInharmonic and NoiseBandNetSynth through
    polyphonic_dag, the v2 FDN reverb, the spectral loss with delta-time
    and loudness terms, and the loudness loss. Written here, not copied
    from the reference's configs."""
    return """# A v2-width polyphonic model reaching the gin-only modules.
import ddsp_piano

sample_rate = 24000
frame_rate = 250
n_synths = 16
n_instruments = 10
duration = 3.0
inference = False

get_model.model = @PianoModel()

PianoModel.note_release = @NoteRelease()
NoteRelease.frame_rate = %frame_rate

PianoModel.context_network = @FiLMContextNetwork()
FiLMContextNetwork:
    n_instruments = %n_instruments
    n_synths = %n_synths
    layer_dim = 64
    context_dim = 32

PianoModel.background_noise_model = @BackgroundNoiseFilter()
BackgroundNoiseFilter:
    n_instruments = %n_instruments
    n_filters = 64
    duration = %duration
    frame_rate = %frame_rate

PianoModel.parallelizer = @Parallelizer()
Parallelizer.n_synths = %n_synths
Parallelizer.global_keys = ('conditioning', 'context', 'piano_model')

PianoModel.inharm_model = @DeepInharmonicity()
DeepInharmonicity.ch = 32
DeepInharmonicity.n_layers = 4
PianoModel.detuner = @DictDetuner()

PianoModel.monophonic_network = @MonophonicDeepNetwork()
MonophonicDeepNetwork:
    rnn_channels = 192
    ch = 64
    layers_per_stack = 3
    context_dim = 32
    output_splits = (('amplitudes', 1),
                     ('harmonic_distribution', 128),
                     ('magnitudes', 64))

PianoModel.harmonic_masking = @PartialMasking()
PartialMasking.n_partials = 96

PianoModel.reverb_model = @MultiInstrumentFeedbackDelayReverb()
MultiInstrumentFeedbackDelayReverb.n_instruments = %n_instruments
MultiInstrumentFeedbackDelayReverb.sample_rate = %sample_rate

PianoModel.processor_group = @ProcessorGroup()
ProcessorGroup.dag = @polyphonic_dag()
polyphonic_dag:
    additive = @additive/MultiInharmonic()
    noise = @noise/NoiseBandNetSynth()
    reverb = @reverb/Reverb()
    additive_controls = ('amplitudes', 'harmonic_distribution',
                         'inharm_coef', 'f0_hz')
    noise_controls = ('magnitudes',)
    reverb_controls = ('reverb_ir',)
    n_synths = %n_synths
additive/MultiInharmonic:
    name = 'additive'
    frame_rate = %frame_rate
    sample_rate = %sample_rate
noise/NoiseBandNetSynth:
    name = 'noise'
    n_band = 64
    upsampling = 96
    sample_rate = %sample_rate
reverb/Reverb.add_dry = True

PianoModel.losses = [@SpectralLoss(), @LoudnessLoss()]
SpectralLoss:
    loss_type = 'L1'
    mag_weight = 1.0
    logmag_weight = 1.0
    delta_time_weight = 0.1
    loudness_weight = 0.01
    name = 'audio_stft_loss'
LoudnessLoss:
    target_key = 'add'
    synth_key = 'reverb'
    sample_rate = %sample_rate
    name = 'loudness_loss'
"""


def gin_segment(path, device, use_sequential_dag=False, capture=None,
                doors=FRONT_DOORS):
    """The 3 s segment through the gin model on ``device`` (initial
    weights of seed SEED; the noise bands' loop shift GIN_SHIFT): its
    outputs on the host, and the forward's seconds."""
    from ddsp_piano_torch.configs import get_model

    model = get_model(path, inference=True, duration=SEGMENT_SECONDS,
                      device=device, seed=SEED)
    features, _ = segment_inputs(device,
                                 model.sample_rate // model.frame_rate)
    with capturing(capture, doors), torch.inference_mode():
        outs = model(features, noise=GIN_SHIFT,
                     use_sequential_dag=use_sequential_dag)
    return model, features, outs


def gin_path():
    """Phase 23: gin text (i) written into a temporary directory and read
    by configs.get_model. (i) renders 10 s of demo.mid through
    ``synthesize_midi_file -c <i>.gin`` (counted; each launch held against
    its plain version; forward median of three; peak memory); its 3 s
    segment on the card against the CPU's; (ii) the same model through a
    ProcessorGroup over the sequential per-voice DAG
    (``use_sequential_dag``: gin maps ``polyphonic_dag`` to the
    folded-voice group, so the sequential group is the model's own
    ``as_sequential_group``), counted (K1 once a voice) and against (i);
    voice 0 through a ProcessorGroup of InHarmonic (its get_signal: K1
    through the framewise front door), the noise bands and Add, against
    the folded group's voice 0; then ``train_single_phase -c <i>.gin -b 6
    -s 2 -e 1`` on the cache, counted, every launch held against its plain
    version; then ``evaluate_model -c <i>.gin --duration 2`` over the
    mini-MAESTRO's test row at b = 1 and b = 4 (the noise bands' loop shift
    from each segment's draw), the same rows, losses finite and within
    EVAL_RTOL, the b = 4 sweep counted and its launches held against their
    plain versions."""
    import tempfile

    from ddsp_piano_torch import evaluate_model as ecli
    from ddsp_piano_torch import processors
    from ddsp_piano_torch.kernels import build

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'model_i.gin')
        with open(path, 'w') as f:
            f.write(gin_text_v2())
        out = {'render': config_render(path, 'skip', label='gin')}

        _, _, cpu = gin_segment(path, 'cpu')
        model, features, vec = gin_segment(path, DEV)
        errs = {stem: float((a.cpu() - b).abs().max() / b.abs().max())
                for stem, a, b in (
                    ('wet', vec['audio_synth'], cpu['audio_synth']),
                    ('dry', vec['add']['signal'], cpu['add']['signal']))}
        if not max(errs.values()) <= SLICE_TOL:
            fail(f"gin (i): the segment on cuda against the cpu {errs}")
        out['segment'] = errs

        capture = {}
        sync()
        build.reset_launches()
        _, _, seq = gin_segment(path, DEV, use_sequential_dag=True,
                                capture=capture)
        sync()
        launches = {k: n for k, n in build.LAUNCHES.items() if n}
        want = {'oscillator_skip': model.n_synths, 'gru_scan': 2,
                'note_release': 1}
        if launches != want:
            fail(f"gin (ii): launches {launches}, expected {want}")
        seq_err = {stem: float((a - b).abs().max() / b.abs().max())
                   for stem, a, b in (
                       ('wet', seq['audio_synth'], vec['audio_synth']),
                       ('dry', seq['add']['signal'], vec['add']['signal']))}
        if not max(seq_err.values()) <= SLICE_TOL:
            fail(f"gin (ii): sequential against folded-voice {seq_err}")
        out['sequential'] = dict(
            launches=launches, err=seq_err,
            kernel_ms=path_kernels(capture, 'gin (ii)'),
            shapes=sorted({tuple(c[0][0].shape)
                           for c in capture['oscillator_skip']}))
        del capture

        group = model.processor_group
        with torch.inference_mode():
            forwards = {}
            for dag in (False, True):
                times = []
                for _ in range(3):
                    sync()
                    start = time.perf_counter()
                    model(features, noise=GIN_SHIFT, use_sequential_dag=dag)
                    sync()
                    times.append(time.perf_counter() - start)
                forwards['sequential' if dag else 'folded'] = \
                    statistics.median(times)
            out['forwards'] = forwards
            voices = model.parallelizer.voice_views(vec)
            keys = [f'{c}_0' for c in group.additive_controls]
            inharmonic = processors.InHarmonic(
                frame_rate=model.frame_rate, sample_rate=model.sample_rate)
            dag = processors.ProcessorGroup([
                (inharmonic, keys), (group.noise, ['magnitudes_0']),
                (processors.Add(), ['noise/signal', 'inharmonic/signal'])])
            capture = {}
            doors = (('ddsp_piano_torch.kernels.oscillator',
                      'render_framewise_skip', 'oscillator_skip'),)
            sync()
            build.reset_launches()
            with capturing(capture, doors):
                got = dag(voices, noise=[GIN_SHIFT])['signal']
            sync()
            dag_launches = {k: n for k, n in build.LAUNCHES.items() if n}
            if dag_launches != {'oscillator_skip': 1}:
                fail(f"gin InHarmonic DAG: launches {dag_launches}")
            controls = group.additive.get_controls(*(voices[k] for k in keys))
            want_sig = (group.additive.get_signal(**controls)
                        + group.noise(voices['magnitudes_0'], noise=GIN_SHIFT))
            dag_err = float((got - want_sig).abs().max()
                            / want_sig.abs().max())
            if not dag_err <= SLICE_TOL:
                fail(f"gin InHarmonic + Add against voice 0: {dag_err}")
            out['inharmonic'] = dict(
                launches=dag_launches, err=dag_err,
                kernel_ms=path_kernels(capture, 'gin InHarmonic DAG'))
        del model, features, vec, voices, seq, cpu, group, dag

        capture = {}
        run = cli_run(CACHE_DIR, 'gin', ['-c', path], capture,
                      steps=GIN_STEPS)
        missing = [k for k in CACHE_KERNELS if run['launches'].get(k, 0) == 0]
        if missing:
            fail(f"the gin training run launched no {missing}: "
                 f"{run['launches']}")
        out['train'] = dict(launches=run['launches'],
                            rows=step_path_kernels(capture, 'gin training',
                                                   timed=False),
                            step_ms=run['step_ms'],
                            wall_step_ms=run['wall_step_ms'],
                            losses=run['result']['step_losses'],
                            wall=run['wall'], peak_mib=run['peak_mib'])

        def sweep(batch_size):
            return ecli.main(ecli.process_args(
                ['-c', path, '--duration', str(EVAL_SECONDS), '-b',
                 str(batch_size), '--device', DEV.type, MAESTRO_DIR,
                 os.path.join(OUT_DIR, 'eval', f'gin_b{batch_size}')]))

        capture = {}
        b1 = sweep(1)
        sync()
        build.reset_launches()
        with capturing(capture):
            b4 = sweep(4)
        sync()
        launches = {k: n for k, n in build.LAUNCHES.items() if n}
        missing = [k for k in RENDER_KERNELS if launches.get(k, 0) == 0]
        if missing:
            fail(f"the gin evaluation sweep launched no {missing}: "
                 f"{launches}")
        strip = lambda rows: [(r['filename'], r['piano_model'])
                              for r in rows]
        if (len(b1['rows']) != EVAL_SEGMENTS
                or strip(b1['rows']) != strip(b4['rows'])):
            fail(f"gin evaluation rows {strip(b1['rows'])} / "
                 f"{strip(b4['rows'])}")
        loss1 = np.array([r['loss_val'] for r in b1['rows']])
        loss4 = np.array([r['loss_val'] for r in b4['rows']])
        rel = float(np.max(np.abs(loss4 - loss1) / np.abs(loss1)))
        if not (np.isfinite(loss1).all() and np.isfinite(loss4).all()
                and rel <= EVAL_RTOL):
            fail(f"gin evaluation losses b=1 {loss1} against b=4 {loss4}")
        out['evaluate'] = dict(
            launches=launches, loss=loss1, rel=rel,
            kernel_ms=path_kernels(capture, 'the gin evaluation sweep'))
    return out


# -- phase 24 -----------------------------------------------------------------


PARALLEL_STEPS = 3             # steps of each data-parallel run
PARALLEL_RANKS = 2             # gloo ranks sharing the one card
# The reduced gradient of the magnitude term against the mean of the
# parts' gradients in one process, a share of each leaf's peak: the same
# rows through the same kernels, summed in the reduce's order for two
# ranks (a + b); NCCL's ring sums three ranks' parts in another order.
PARALLEL_PARTS_TOL = 1e-6
PARALLEL_NCCL_PARTS_TOL = 1e-5
PARALLEL_LOSS_RTOL = 1e-5
PARALLEL_EVAL_BATCH = 4
PARALLEL_EVAL_RTOL = 1e-5


def cache_batches(n, batch_size=TRAIN_BATCH):
    """The first ``n`` batches of the cache's train split, unshuffled."""
    from ddsp_piano_torch.data import pipeline

    batches = pipeline.get_dataset(CACHE_DIR, split='train',
                                   duration=SEGMENT_SECONDS,
                                   batch_size=batch_size, shuffle=False,
                                   sample_rate=24000, max_polyphony=16,
                                   num_parallel_calls=1)
    out = [{k: v for k, v in next(batches).items() if k != 'filename'}
           for _ in range(n)]
    batches.close()
    return out


def parallel_first_step(batch, device, parts=1):
    """The first step's losses and gradients (the v2 loss, and its
    magnitude term alone) from the student weights, with step 0's noise
    draw: in a process group, the rank's reduced ones. With ``parts`` > 1
    in one process, what the reduce of that many ranks computes: the sum
    of the first step on each equal part of the rows, with its rows of
    the draw, divided by the parts."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.processors.noise import uniform_noise
    from ddsp_piano_torch.training.trainer import Trainer

    model = get_model('maestro_v2', device=device, seed=STUDENT_SEED)
    trainer = Trainer(model, first_phase=True)
    b, n = batch['audio'].shape
    out = {}
    for name, logmag_weight in (('v2', 1.0), ('magnitudes', 0.0)):
        model.loss_objs[0].logmag_weight = logmag_weight
        if parts == 1:
            losses = trainer.forward_backward(
                batch, generator=trainer.noise_generator(0))
            out[name] = ({k: float(v) for k, v in losses.items()},
                         {k: p.grad.detach().cpu().clone()
                          for k, p in trainer.named_params})
            continue
        draw = uniform_noise((model.n_synths * b, n),
                             trainer.noise_generator(0), device)
        total_losses, total = None, None
        per = b // parts
        for i in range(parts):
            rows = slice(i * per, (i + 1) * per)
            losses = trainer.forward_backward(
                {k: v[rows] for k, v in batch.items()},
                noise=draw.view(model.n_synths, b, n)[:, rows].reshape(-1, n))
            grads = {k: p.grad.detach().clone()
                     for k, p in trainer.named_params}
            if total is None:
                total_losses, total = losses, grads
            else:
                total_losses = {k: total_losses[k] + v
                                for k, v in losses.items()}
                total = {k: total[k] + g for k, g in grads.items()}
        out[name] = ({k: float(v / parts) for k, v in total_losses.items()},
                     {k: (g / parts).cpu() for k, g in total.items()})
    return out


def gradient_stats(got, want):
    """(worst leaf, its error as a share of its peak, the median leaf's,
    the cosine, whether every leaf is bit-equal)."""
    errs, cosine = gradient_gap(got, want)
    worst = max(errs, key=errs.get)
    return (worst, errs[worst], statistics.median(errs.values()), cosine,
            all(torch.equal(got[k], w) for k, w in want.items()))


def parallel_steps(batches, device, capture=None):
    """PARALLEL_STEPS Trainer steps from the student weights (a rank's in
    a process group), counters set to 0 just before and read just after:
    losses, launches, parameters, step and reduce times."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.kernels import build
    from ddsp_piano_torch.training.trainer import Trainer

    model = get_model('maestro_v2', device=device, seed=STUDENT_SEED)
    trainer = Trainer(model, first_phase=True, record_timeline=True)
    sync()
    build.reset_launches()
    with capturing(capture, CACHE_DOORS):
        losses = [float(trainer.train_step(b)['total_loss'])
                  for b in batches]
        trainer.check_pending()
    sync()
    launches = {k: n for k, n in build.LAUNCHES.items() if n}
    missing = [k for k in TRAIN_KERNELS if launches.get(k, 0) == 0]
    if missing:
        fail(f"the data-parallel steps launched no {missing} kernel: "
             f"{launches}")
    return dict(losses=losses, launches=launches,
                params={n: p.detach().cpu().clone()
                        for n, p in model.named_parameters()},
                step_ms=[t[0] for t in trainer.step_times()],
                reduce_ms=trainer.reduce_times(),
                reduce_bytes=trainer.reduce_bytes)


def parallel_eval(flags, name, capture=None):
    """``evaluate_model --ckpt <phase 11's> --duration 2 -b 4`` over the
    test row, counted: (its rows, its launches)."""
    from ddsp_piano_torch import evaluate_model as cli
    from ddsp_piano_torch.kernels import build

    ckpt = os.path.join(OUT_DIR, 'train_exp', 'phase_1', 'last_iter')
    sync()
    build.reset_launches()
    with capturing(capture, CACHE_DOORS):
        result = cli.main(cli.process_args(
            ['--ckpt', ckpt, '--duration', str(EVAL_SECONDS), '-b',
             str(PARALLEL_EVAL_BATCH), '--device', DEV.type] + flags
            + [MAESTRO_DIR, os.path.join(OUT_DIR, 'eval', name)]))
    sync()
    launches = {k: n for k, n in build.LAUNCHES.items() if n}
    missing = [k for k in RENDER_KERNELS if launches.get(k, 0) == 0]
    if missing:
        fail(f"the {name} evaluation launched no {missing} kernel: "
             f"{launches}")
    return result['rows'], launches


def parallel_rank(batches):
    """Phase 24 (b) and (c) in one of two gloo ranks sharing the card:
    the first step's reduced gradients, PARALLEL_STEPS steps on the rank's
    rows (each launch held against its plain version at its inputs) and
    the evaluation sweep's rows (its launches held too)."""
    from ddsp_piano_torch.device import set_f32_precision
    from ddsp_piano_torch.parallel import mesh

    set_f32_precision()
    device = mesh.local_device(DEV)
    rank = mesh.rank()
    rows = [mesh.slice_local_batch(b) for b in batches]
    first = parallel_first_step(rows[0], device)
    capture = {}
    steps = parallel_steps(rows, device, capture)
    checked = step_path_kernels(capture, f'rank {rank} of the data-parallel '
                                'steps', timed=False)
    capture = {}
    eval_rows, eval_launches = parallel_eval(
        ['--n_devices', str(PARALLEL_RANKS)], 'parallel_ranks', capture)
    checked += step_path_kernels(capture, f'rank {rank} of the evaluation',
                                 timed=False)
    return dict(rank=rank, first=first, steps=steps, checked=checked,
                eval_rows=eval_rows, eval_launches=eval_launches)


def parallel_path():
    """Phase 24: data parallelism on the one card."""
    import tempfile

    from ddsp_piano_torch.parallel import mesh

    phase_start = time.perf_counter()
    batches = cache_batches(PARALLEL_STEPS)
    out = {}
    # (a) a process group of one rank over NCCL: the reduce path against
    # the single process, bit for bit.
    want = parallel_steps(batches, DEV)
    capture = {}
    card = torch.cuda.current_device() if DEV.type == 'cuda' else None
    with tempfile.TemporaryDirectory() as tmp:
        mesh.init_rank(0, 1, mesh.Hosts(), DEV.type,
                       'file://' + os.path.join(tmp, 'rendezvous'),
                       card=card)
        try:
            got = parallel_steps(batches, DEV, capture)
        finally:
            mesh.end_rank()
    bits = got['losses'] == want['losses'] and all(
        torch.equal(got['params'][n], v) for n, v in want['params'].items())
    if not bits:
        fail(f"a one-rank NCCL group's steps differ from the single "
             f"process's: losses {got['losses']} against {want['losses']}")
    out['one_rank'] = dict(got, checked=step_path_kernels(
        capture, 'the one-rank group', timed=False), single=want)
    del capture

    # (b) and (c): two gloo ranks on the card, against the single process
    # on the global batch.
    reference = parallel_first_step(batches[0], DEV)
    halves = parallel_first_step(batches[0], DEV, parts=PARALLEL_RANKS)
    # The float32 control: the halves' mean against the whole batch's
    # gradient in one process, no process group.
    control = {name: gradient_stats(halves[name][1], reference[name][1])
               for name in reference}
    eval_want, eval_launches = parallel_eval(['--n_devices', '1'],
                                             'parallel_single')
    start = time.perf_counter()
    try:
        ranks = mesh.launch(parallel_rank, PARALLEL_RANKS, (batches,),
                            DEV.type, backend='gloo',
                            cards=[card] * PARALLEL_RANKS)
    except Exception as e:  # noqa: BLE001 - a rank's failure, whatever
        fail(f"the two-rank run failed: {e}")
    ranks_seconds = time.perf_counter() - start
    grads = {}
    for r in ranks:
        for name, (losses, leaves) in r['first'].items():
            for key, value in reference[name][0].items():
                if not np.isclose(losses[key], value,
                                  rtol=PARALLEL_LOSS_RTOL, atol=0):
                    fail(f"rank {r['rank']}: first-step {name} {key} "
                         f"{losses[key]} against {value} in one process")
            whole = gradient_stats(leaves, reference[name][1])
            parts = gradient_stats(leaves, halves[name][1])
            grads.setdefault(name, []).append((whole, parts))
            if name == 'magnitudes' and parts[1] > PARALLEL_PARTS_TOL:
                fail(f"rank {r['rank']}: the reduced gradient of the "
                     f"magnitude term, {parts[0]}, is {parts[1]:.3g} of its "
                     "peak from the halves' mean in one process")
            if min(whole[3], parts[3]) < STEP_MIN_COSINE:
                fail(f"rank {r['rank']}: the {name} reduced gradient's "
                     f"cosine {whole[3]} / {parts[3]} to one process's")
        for n, v in ranks[0]['steps']['params'].items():
            if not torch.equal(r['steps']['params'][n], v):
                fail(f"the ranks' {n} differ after {PARALLEL_STEPS} steps")
        got_loss = np.array([x['loss_val'] for x in r['eval_rows']])
        want_loss = np.array([x['loss_val'] for x in eval_want])
        if (len(got_loss) != len(want_loss)
                or not np.allclose(got_loss, want_loss,
                                   rtol=PARALLEL_EVAL_RTOL, atol=0)):
            fail(f"rank {r['rank']}: evaluation losses {got_loss} against "
                 f"{want_loss} from one rank")
    out.update(ranks=ranks, grads=grads, control=control,
               ranks_seconds=ranks_seconds,
               eval_rel=float(np.max(np.abs(got_loss - want_loss)
                                     / np.abs(want_loss))),
               seconds=time.perf_counter() - phase_start)
    return out


def parallel_launches(p):
    """Phase 24's launches by kernel: the one-rank group's steps and each
    rank's steps and evaluation sweep."""
    total = dict(p['one_rank']['launches'])
    for r in p['ranks']:
        for launches in (r['steps']['launches'], r['eval_launches']):
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
    return total


def parallel_lines(p):
    a = p['one_rank']
    ms = lambda v: statistics.median(v) if v else float('nan')
    lines = [
        f"data-parallel (a): a one-rank NCCL group on the card, "
        f"{PARALLEL_STEPS} steps of maestro_v2 b={TRAIN_BATCH} x "
        f"{SEGMENT_SECONDS:g} s from the cache: losses and parameters bit "
        f"for bit the single process's ({', '.join(f'{v:.6f}' for v in a['losses'])}); "
        f"launches {a['launches']}; every launch against its plain version: "
        + checked_line(a['checked'])
        + f"; gradient buffer {a['reduce_bytes']} bytes, reduce "
        f"{ms(a['reduce_ms']):.4f} ms a step (CUDA events, median); step "
        f"{ms(a['step_ms'][1:]):.2f} ms against {ms(a['single']['step_ms'][1:]):.2f} "
        "in one process"]
    for r in p['ranks']:
        st = r['steps']
        lines.append(
            f"data-parallel (b): rank {r['rank']} of {PARALLEL_RANKS} gloo "
            f"ranks on the card, {TRAIN_BATCH // PARALLEL_RANKS} of the "
            f"{TRAIN_BATCH} rows, {PARALLEL_STEPS} steps: launches "
            f"{st['launches']}, evaluation launches {r['eval_launches']}; "
            "every launch against its plain version: "
            + checked_line(r['checked'])
            + f"; gradient buffer {st['reduce_bytes']} bytes, reduce "
            f"{ms(st['reduce_ms']):.3f} ms a step (CUDA events, median; "
            f"gloo through the host); step {ms(st['step_ms'][1:]):.2f} ms")
    stats = lambda x: (f"worst {x[0]} {x[1]:.3g} of its peak, median leaf "
                       f"{x[2]:.3g}, cosine {x[3]:.9f}, bit-equal {x[4]}")
    for name, v in p['grads'].items():
        lines.append(
            f"data-parallel (b): the first step's reduced {name} gradient, "
            f"against the single process's {TRAIN_BATCH}-row gradient at "
            "the same weights and draw: " + '; '.join(
                f"rank {i} {stats(whole)}" for i, (whole, _) in enumerate(v))
            + f"; against the mean of its two {TRAIN_BATCH // 2}-row halves "
            "in one process (what the reduce sums): " + '; '.join(
                f"rank {i} {stats(parts)}" for i, (_, parts) in enumerate(v))
            + f"; the halves' mean against the {TRAIN_BATCH}-row gradient in "
            f"one process (float32 control): {stats(p['control'][name])}")
    lines.append(
        f"data-parallel (b): losses within rtol {PARALLEL_LOSS_RTOL:g} of "
        f"the single process's; the magnitude term's gradient within "
        f"{PARALLEL_PARTS_TOL:g} of each leaf's peak of the halves' mean, "
        f"both gradients' cosines at least {STEP_MIN_COSINE}; parameters "
        f"bit-equal across the ranks after {PARALLEL_STEPS} steps")
    lines.append(
        f"data-parallel (c): evaluate_model --n_devices {PARALLEL_RANKS} -b "
        f"{PARALLEL_EVAL_BATCH} --duration {EVAL_SECONDS:g} over gloo ranks "
        f"on the card against --n_devices 1: losses within "
        f"{p['eval_rel']:.3g} (rtol {PARALLEL_EVAL_RTOL:g}); the ranks' run "
        f"{p['ranks_seconds']:.1f} s (spawn included); phase "
        f"{p['seconds']:.1f} s")
    return lines


def slice_launches(s, g):
    """This slice's launches by kernel: the summaries run, and the gin
    render's counted run, the sequential DAG, the InHarmonic DAG, the gin
    training run and the gin evaluation sweep."""
    total = {}
    for launches in (s['launches'], g['render']['launches'],
                     g['sequential']['launches'],
                     g['inharmonic']['launches'], g['train']['launches'],
                     g['evaluate']['launches']):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total


def summaries_line(sm, seconds):
    return (
        f"summaries path: train_single_phase -c maestro_v2 -b {TRAIN_BATCH}"
        f" -s {SUMMARY_STEPS} -e {SUMMARY_EPOCHS} on the cache, cuda: "
        f"launches {sm['launches']}; every launch against its plain "
        f"version: " + checked_line(sm['rows'])
        + f"; event file {sm['bytes']} bytes, {sm['n_values']} values "
        f"({sm['n_images']} images) read back by the port's reader in "
        f"{sm['read_ms']:.1f} ms, each tag of the JAX CLI at its step, "
        f"train_loss/total_loss equal to the CLI's epoch means, "
        f"{sm['n_clips']} WAVs against the validation audio "
        f"{sm['wav_err']:.3g} (tolerance 1/32767); the writer "
        + ' / '.join(f"{ms:.1f}" for ms in sm['summary_ms'])
        + f" ms by epoch; step median {sm['step_ms']:.2f} ms; phase "
        f"{seconds:.1f} s")


def gin_lines(g, seconds):
    r, q, tr, ev = (g['render'], g['sequential'], g['train'],
                    g['evaluate'])
    return [
        f"gin path (i): synthesize_midi_file -c <i>.gin, demo.mid "
        f"{MAIN_PATH_SECONDS:g} s at {r['sr']} Hz on cuda, forward "
        f"{r['forward'] * 1e3:.1f} ms ({r['rtf']:.1f}x realtime; median "
        f"of {forwards_text(r['forwards'])} ms), peak memory "
        f"{r['peak_mib'][0]:.1f} MiB, {r['peak_mib'][1]:.1f} above what "
        f"was allocated before; launches {r['launches']}; kernels at "
        f"their own inputs, each against its plain version: "
        + grouped_kernels_line(r['kernel_ms']) + f"; bounds {r['bounds']}",
        f"gin path: the {SEGMENT_SECONDS:g} s segment on cuda against the "
        f"cpu, wet {g['segment']['wet']:.3g}, dry {g['segment']['dry']:.3g}"
        f" of peak (tolerance {SLICE_TOL:g}); (ii) the sequential DAG: "
        f"launches {q['launches']} (K1 shapes {q['shapes']}), against (i) "
        f"wet {q['err']['wet']:.3g}, dry {q['err']['dry']:.3g}; forward "
        f"folded {1e3 * g['forwards']['folded']:.1f} ms, sequential "
        f"{1e3 * g['forwards']['sequential']:.1f} ms (wall, median of 3); "
        f"kernels: " + grouped_kernels_line(q['kernel_ms'])
        + f"; InHarmonic + Add DAG on voice 0 against the folded group's "
        f"{g['inharmonic']['err']:.3g} of peak, launches "
        f"{g['inharmonic']['launches']}: "
        + grouped_kernels_line(g['inharmonic']['kernel_ms']),
        f"gin path: train_single_phase -c <i>.gin -b {TRAIN_BATCH} -s "
        f"{GIN_STEPS} -e 1 on the cache, cuda: losses "
        f"{[round(v, 4) for v in tr['losses']]}, step "
        f"{tr['step_ms']:.2f} ms (CUDA events, the second step), wall "
        f"{tr['wall']:.1f} s, peak memory {tr['peak_mib'][0]:.1f} MiB, "
        f"{tr['peak_mib'][1]:.1f} above what was allocated before; launches {tr['launches']}; every launch "
        f"against its plain version: " + checked_line(tr['rows']),
        f"gin path: evaluate_model -c <i>.gin --duration {EVAL_SECONDS:g} "
        f"over the test row, cuda: segment losses "
        f"{[round(float(v), 5) for v in ev['loss']]}, b = 4 against b = 1 "
        f"{ev['rel']:.3g} (tolerance {EVAL_RTOL:g}); b = 4 launches "
        f"{ev['launches']}; each against its plain version: "
        + grouped_kernels_line(ev['kernel_ms'])
        + f"; phase {seconds:.1f} s"]


# -- phase 25 -----------------------------------------------------------------

ALLOC_TIMED = 5                # runs of each allocator a median
ALLOC_WORKERS = 8              # preprocess_into_cache's num_workers
ALLOC_CACHE_DIR = os.path.join(OUT_DIR, 'allocator_cache')
ALLOC_ROLLS = (('demo.mid', 16), ('over-capacity roll', 4),
               ('churn roll', 4))
# K2's bf16 instance against its bf16 plain version step by step,
# absolute (|h| < 1); K5's, a share of each stream's peak. Over a whole
# run of 750 steps each drifts from its plain version as far as the plain
# version on the card drifts from itself on the CPU: a state an ulp apart
# rounds to bf16 values 2^-8 apart now and then (measured at the v2
# segment's and the training step's shapes: K2 up to 6.15e-4 against the
# plain version's 5.73e-4, K5 3.34e-4 of a stream's peak against 2.3e-4).
GRU_BF16_TOL = 1e-5
GRU_BWD_BF16_TOL = 1e-5
GRU_BF16_RUN_TOL = 2e-3
BF16_TIMED = 3                 # renders a median, each switch
BF16_CPU_ROWS = 16             # the most rows the plain version runs on the CPU
BF16_STEPS = 3


def allocator_path():
    """Phase 25 (a): the C++ host allocator bit for bit against the numpy
    loop (outputs equal, dtypes and shapes too) on demo.mid's roll at 16
    voices and two over-capacity rolls at 4; each one's ms a frame, median
    of ALLOC_TIMED runs; then the mini-MAESTRO's train and validation
    splits preprocessed into a cache with ALLOC_WORKERS workers under each
    allocator (patched into data.io in this process), their seconds, and
    the two caches bit-equal."""
    from ddsp_piano_torch import native
    from ddsp_piano_torch.data import io as dio
    from ddsp_piano_torch.data import midi_encoders, pipeline, rolls

    if not native.available():
        fail("the C++ voice allocator is not available: no C++ compiler")
    inputs = {'demo.mid': dio.load_midi_as_roll(DEMO_MIDI)['roll'][0],
              'over-capacity roll': rolls.held_notes_roll(99, 200, 80),
              'churn roll': rolls.churn_roll(0, 4, 500)}
    cases = []
    for name, n in ALLOC_ROLLS:
        roll = inputs[name]
        native.reset_calls()
        got = midi_encoders.roll_to_conditioning(roll, n, 'always')
        calls = native.CALLS['allocate_voices']
        want = midi_encoders.roll_to_conditioning(roll, n, 'never')
        if calls != 1 or native.CALLS['allocate_voices'] != 1:
            fail(f"{name}: {native.CALLS} C++ allocator calls, not one")
        for a, w in zip(got, want):
            if (a.shape != w.shape or a.dtype != np.float32
                    or not np.array_equal(a, w)):
                fail(f"{name}: the C++ allocator's output differs from the "
                     "numpy loop's")
        ms = {}
        for mode in ('always', 'never'):
            times = []
            for _ in range(ALLOC_TIMED):
                start = time.perf_counter()
                midi_encoders.roll_to_conditioning(roll, n, mode)
                times.append(time.perf_counter() - start)
            ms[mode] = 1e3 * statistics.median(times) / len(roll)
        cases.append((name, len(roll), n, ms))
    real = dio.roll_to_conditioning
    seconds, calls, caches = {}, {}, {}
    for mode in ('always', 'never'):
        cache = caches[mode] = os.path.join(ALLOC_CACHE_DIR, mode)
        shutil.rmtree(cache, ignore_errors=True)
        dio.roll_to_conditioning = functools.partial(real, use_native=mode)
        native.reset_calls()
        try:
            start = time.perf_counter()
            for split in ('train', 'validation'):
                pipeline.preprocess_into_cache(
                    cache, MAESTRO_DIR, split=split, sample_rate=24000,
                    max_polyphony=16, num_workers=ALLOC_WORKERS,
                    verbose=False)
            seconds[mode] = time.perf_counter() - start
        finally:
            dio.roll_to_conditioning = real
        calls[mode] = native.CALLS['allocate_voices']
    if calls['always'] < 2 or calls['never'] != 0:
        fail(f"C++ allocator calls while preprocessing: {calls}")
    names = sorted(os.listdir(caches['always']))
    if names != sorted(os.listdir(caches['never'])):
        fail("the two allocators' caches hold other files")
    for name in names:
        if name.endswith('.npz'):
            a, b = (np.load(os.path.join(caches[m], name))
                    for m in ('always', 'never'))
            if sorted(a) != sorted(b) or not all(
                    a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                    for k in a):
                fail(f"cache {name} differs between the allocators")
    return dict(cases=cases, seconds=seconds, calls=calls,
                tracks=sum(n.endswith('.npz') for n in names))


def check_gru_bf16(calls, kernel):
    """Each recorded call of K2 (``kernel`` 'gru_scan') or K5
    ('gru_scan_bwd') with the bf16 switch, against its bf16 plain version
    on the card: step by step (gru_scan_plain_steps /
    gru_scan_plain_bwd_steps, each step from the kernel's own earlier
    ones) within GRU_BF16_TOL (K2, absolute) or GRU_BWD_BF16_TOL (K5, a
    share of each stream's peak), and over the whole run within
    GRU_BF16_RUN_TOL, beside the plain version's own distance from its
    run on the CPU; its call and card times and bound."""
    from ddsp_piano_torch.kernels import gru as kgru

    forward = kernel == 'gru_scan'
    cuda, plain, steps, tol = (
        (kgru.gru_scan_cuda, kgru.gru_scan_plain, kgru.gru_scan_plain_steps,
         GRU_BF16_TOL) if forward else
        (kgru.gru_scan_bwd_cuda, kgru.gru_scan_plain_bwd,
         kgru.gru_scan_plain_bwd_steps, GRU_BWD_BF16_TOL))

    def gap(got, want):
        if forward:
            return (got - want).abs().max().item()
        return max(((a - w).abs().max() / w.abs().max().clamp_min(1e-30)
                    ).item() for a, w in zip(got, want))

    rows = []
    for args in calls:
        args = to_card(args)
        if args[-1] is not True:
            fail(f"{kernel} was called without bf16 under the switch")
        t, b, three_u = args[0].shape
        u = three_u // 3
        with torch.no_grad():
            got = cuda(*args)
            if forward:
                step_err = gap(got, steps(*args[:4], got, True))
            else:
                step_err = gap(got, steps(*args[:6], got, True))
            want = plain(*args)
            run_err = gap(got, want)
            # The plain version's own drift, on the CPU, at the segment's
            # rows (the step's 96 take seconds there).
            floor = (gap(want, to_card(plain(*to_cpu(args))))
                     if b <= BF16_CPU_ROWS else None)
            sync()
            del got, want
        if not (np.isfinite(step_err) and step_err <= tol
                and run_err <= GRU_BF16_RUN_TOL):
            fail(f"{kernel}'s bf16 instance (u={u}, B={b}) differs from its "
                 f"bf16 plain version: {step_err} step by step (tolerance "
                 f"{tol}), {run_err} over the run (tolerance "
                 f"{GRU_BF16_RUN_TOL})")
        fn = lambda: cuda(*args)
        rows.append(dict(u=u, b=b, t=t, err=step_err, run_err=run_err,
                         floor=floor, ms=median_ms(fn),
                         card_ms=statistics.median(card_times(fn)),
                         bound=(gru_bound if forward else gru_bwd_bound)(
                             t, b, u)))
    total = {'bf16_max_abs_err': max(r['err'] for r in rows),
             'bf16_ms': sum(r['ms'] for r in rows),
             'bf16_card_ms': sum(r['card_ms'] for r in rows),
             'bf16_bound_ms': sum(r['bound'][0] for r in rows)}
    detail = '; '.join(
        f"u={r['u']} ({r['t']}, {r['b']}): err step by step {r['err']:.3g}, "
        f"over the run {r['run_err']:.3g} (the plain version on the card "
        "against the CPU " + ('not run' if r['floor'] is None
                              else f"{r['floor']:.3g}")
        + f"), {r['ms']:.4f} ms = "
        f"{1e3 * r['ms'] / r['t']:.3f} us/step, card {r['card_ms']:.4f} "
        f"ms, bound {r['bound'][0]:.5f} ms ({r['bound'][1]})" for r in rows)
    return total, detail


def bf16_path():
    """Phase 25 (b): under nn.layers.enable_bf16_control(), the v2 3 s
    segment on the card and one full-width training step, recording K2's
    and K5's inputs, each held against its bf16 plain version and timed;
    the 10 s render of demo.mid (counted: K2's bf16 instance twice), its
    forward against the float32 one's (CUDA events, median of BF16_TIMED
    each) and its distance from the float32 render as a share of peak;
    BF16_STEPS training steps from the cache (counted: K5's bf16 instance
    launched), with finite losses. The switch is off again at the end."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.kernels import build
    from ddsp_piano_torch.nn import layers
    from ddsp_piano_torch.training.trainer import Trainer

    launches = {}

    def count():
        for counts, prefix in ((build.LAUNCHES, ''),
                               (build.BF16_LAUNCHES, 'bf16 ')):
            for k, n in counts.items():
                launches[prefix + k] = launches.get(prefix + k, 0) + n
        build.reset_launches()

    layers.enable_bf16_control(True)
    try:
        build.reset_launches()
        capture = {}
        render_segment(DEV, capture)
        count()
        step_capture, _ = train_step_inputs()
        count()
        rows = {'gru_scan': check_gru_bf16(
                    capture['gru_scan'] + step_capture['gru_scan'],
                    'gru_scan'),
                'gru_scan_bwd': check_gru_bf16(step_capture['gru_scan_bwd'],
                                               'gru_scan_bwd')}
        del capture, step_capture

        features = demo_features(MAIN_PATH_SECONDS)
        model = get_model('maestro_v2', inference=True, device=DEV,
                          seed=SEED, duration=features['conditioning'].shape[1]
                          / 250)
        noise = 2.0 * torch.rand(
            (model.n_synths, features['conditioning'].shape[1] * 96),
            device=DEV, generator=torch.Generator(device=DEV).manual_seed(
                SEED)) - 1.0

        def render():
            with torch.inference_mode():
                return model(features, noise=noise)['audio_synth'][0]

        build.reset_launches()
        bf16_audio = render()
        sync()
        render_bf16 = dict(build.BF16_LAUNCHES)
        count()
        if render_bf16['gru_scan'] != 2:
            fail(f"the bf16 render launched K2's bf16 instance "
                 f"{render_bf16['gru_scan']} times, not twice")
        forwards = {'bf16': event_times(render, n=BF16_TIMED, warmup=1)}
        layers.enable_bf16_control(False)
        f32_audio = render()
        forwards['float32'] = event_times(render, n=BF16_TIMED, warmup=1)
        build.reset_launches()
        layers.enable_bf16_control(True)
        if not bool(torch.isfinite(bf16_audio).all()):
            fail("the bf16 render is not finite")
        peak = f32_audio.abs().max().item()
        gap = (bf16_audio - f32_audio).abs().max().item() / peak
        del model, bf16_audio, f32_audio

        student = get_model('maestro_v2', device=DEV, seed=STUDENT_SEED)
        trainer = Trainer(student, first_phase=True, seed=STUDENT_SEED)
        batches = cache_batches(BF16_STEPS)
        build.reset_launches()
        losses = [float(trainer.train_step(b)['total_loss'])
                  for b in batches]
        sync()
        steps_bf16 = dict(build.BF16_LAUNCHES)
        count()
        if not all(np.isfinite(losses)):
            fail(f"bf16 training losses {losses}")
        if steps_bf16['gru_scan_bwd'] < 2 * BF16_STEPS:
            fail(f"{BF16_STEPS} bf16 training steps launched K5's bf16 "
                 f"instance {steps_bf16['gru_scan_bwd']} times")
        del trainer, student
    finally:
        layers.enable_bf16_control(False)
    for kernel, (total, _) in rows.items():
        total['bf16_launches'] = launches.get('bf16 ' + kernel, 0)
    return dict(rows=rows, forwards=forwards, gap=gap, losses=losses,
                launches={k: v for k, v in launches.items()
                          if not k.startswith('bf16 ')},
                bf16_launches={k[5:]: v for k, v in launches.items()
                               if k.startswith('bf16 ')},
                render_bf16=render_bf16, steps_bf16=steps_bf16)


def ffmpeg_line():
    """Whether ``ffmpeg`` is on PATH (non-wav input needs it), and its
    version line."""
    found = shutil.which('ffmpeg')
    if found is None:
        return ("ffmpeg: not on PATH (non-wav audio raises; the decode is "
                "held on the CPU with a stub)")
    out = subprocess.run([found, '-version'], capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return f"ffmpeg: {found} ({out[0] if out else 'no version line'})"


def phase25_lines(a, f):
    lines = [
        "host allocator: the C++ allocator bit for bit the numpy loop's; ms "
        f"a frame, median of {ALLOC_TIMED}: " + '; '.join(
            f"{name} ({frames} frames, {n} voices) C++ "
            f"{ms['always']:.6f}, numpy {ms['never']:.6f} "
            f"({ms['never'] / ms['always']:.0f}x)"
            for name, frames, n, ms in a['cases'])
        + f"; preprocess_into_cache of the mini-MAESTRO (train and "
        f"validation, {a['tracks']} tracks, {ALLOC_WORKERS} workers): C++ "
        f"{a['seconds']['always']:.3f} s ({a['calls']['always']} calls), "
        f"numpy {a['seconds']['never']:.3f} s; the caches bit-equal"]
    med = lambda v: statistics.median(v)
    for kernel, (row, detail) in f['rows'].items():
        lines.append(
            f"kernel {kernel} bf16 instance at the bf16 v2 segment's and "
            f"training step's inputs, against its bf16 plain version: "
            f"{detail}; launches {row['bf16_launches']}")
    lines.append(
        f"bf16 control networks: v2 demo.mid {MAIN_PATH_SECONDS:g} s on "
        f"cuda, forward {med(f['forwards']['bf16']):.2f} ms (median of "
        + ' / '.join(f"{v:.2f}" for v in f['forwards']['bf16'])
        + f") against float32 {med(f['forwards']['float32']):.2f} ms "
        f"(" + ' / '.join(f"{v:.2f}" for v in f['forwards']['float32'])
        + f"); the bf16 render {f['gap']:.3g} of peak from the float32 one; "
        f"render bf16 launches {f['render_bf16']}; {BF16_STEPS} bf16 training "
        f"steps, losses " + ', '.join(f"{v:.4f}" for v in f['losses'])
        + f", bf16 launches {f['steps_bf16']}; the switch off again")
    return lines


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test needs one NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        import ddsp_piano_torch  # noqa: F401
    except ImportError as e:
        fail(f"run from the root of a ddsp_piano_torch checkout ({e})")
    from ddsp_piano_torch.device import set_f32_precision

    set_f32_precision()
    os.makedirs(OUT_DIR, exist_ok=True)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()

    print(card_line(), flush=True)

    seconds, usage = build_kernels()
    print(f"build: {seconds:.1f} s; " + ' | '.join(usage), flush=True)

    t0 = time.perf_counter()
    capture = {}
    cpu = render_segment('cpu', capture)
    print(f"cpu render of the {SEGMENT_SECONDS:g} s segment: "
          f"{time.perf_counter() - t0:.1f} s; front-door calls "
          f"{ {k: len(v) for k, v in capture.items()} }", flush=True)
    kernels = []
    for kernel, check in (('oscillator_skip', check_oscillator),
                          ('gru_scan', check_gru),
                          ('note_release', check_note_release)):
        row, detail = check(capture[kernel])
        kernels.append(row)
        library = ('none' if row['library_ms'] is None
                   else f"{row['library_ms']:.4f}")
        print(f"kernel {kernel}: {detail}; max_abs_err "
              f"{row['max_abs_err']:.3g}; kernel_ms {row['ms']:.4f} "
              f"plain_ms {row['plain_ms']:.4f} library_ms {library} "
              f"bound_ms {row['bound_ms']:.5f} ({row['bound_by']})",
              flush=True)
    del capture

    m = main_path()
    print(f"main path: demo.mid {MAIN_PATH_SECONDS:g} s on cuda, forward "
          f"{m['forward'] * 1e3:.1f} ms ({m['rtf']:.1f}x realtime; median of "
          f"{forwards_text(m['forwards'])} ms), wall "
          f"{m['wall']:.2f} s; launches {m['launches']}; host allocator "
          f"calls: C++ {m['allocator_calls']} (none: the numpy loop); dry "
          f"peaks "
          f"{np.round(m['peaks'], 2).tolist()} Hz on partials of "
          f"{m['n_pitches']} pitches (+-{2 * m['bin_hz']:.2f} Hz)",
          flush=True)
    print("main path kernels at its own inputs, each against its plain "
          "version (err: oscillator a share of peak, GRU absolute): "
          + kernels_line(m['kernel_ms'])
          + f"; sum {sum(r[2] for r in m['kernel_ms']):.3f} ms of the "
          f"{m['forward'] * 1e3:.1f} ms forward", flush=True)

    compare_segment('maestro_v2', cpu)
    del cpu

    t0 = time.perf_counter()
    capture = {}
    cpu = render_segment('cpu', capture, config='dafx22')
    print(f"dafx22 cpu render of the {SEGMENT_SECONDS:g} s segment: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    row, detail = check_oscillator_full(capture['oscillator_skip'])
    print_full_row('segment', row, detail)
    row, detail = check_gru(capture['gru_scan'])
    print_gru_row("the dafx22 segment's inputs", row, detail)
    del capture

    runs, osc_errs = dafx22_path()
    for oscillator, r in runs.items():
        print(f"dafx22 path, --oscillator {oscillator}: demo.mid "
              f"{MAIN_PATH_SECONDS:g} s on cuda, forward "
              f"{r['forward'] * 1e3:.1f} ms ({r['rtf']:.1f}x realtime; "
              f"median of {forwards_text(r['forwards'])} ms); "
              f"launches {r['launches']}; kernels at its own inputs, each "
              f"against its plain version: " + kernels_line(r['kernel_ms']),
              flush=True)
    print("GRU kernel against its plain version by step, at the 10 s "
          "renders' inputs: v2 " + gru_error_by_length(m['calls']['gru_scan'])
          + "; dafx22 " + gru_error_by_length(
              runs['skip']['calls']['gru_scan']), flush=True)
    print(f"dafx22 --oscillator full vs skip: max-abs / peak wet "
          f"{osc_errs['audio']:.3g}, dry {osc_errs['dry']:.3g} (tolerance "
          f"{K8_K1_TOL:g})", flush=True)
    row, detail = check_oscillator_full(
        runs['full']['calls']['oscillator_full'])
    kernels.append(row)
    print_full_row('main path', row, detail)

    compare_segment('dafx22', cpu)
    del cpu

    t0 = time.perf_counter()
    seconds, rms = teacher_data()
    print(f"teacher: demo.mid {seconds:g} s rendered (weights seed 0, piano "
          f"0, rms {rms:.4f}) into a mini-MAESTRO in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    capture, loss = train_step_inputs()
    print(f"training step (b={TRAIN_BATCH}, {SEGMENT_SECONDS:g} s) on cuda: "
          f"total loss {loss:.4f}; kernel calls "
          f"{ {k: len(v) for k, v in capture.items()} }", flush=True)
    step_kernel_ms = kernel_ms_per_step(capture)
    row, detail = check_gru(capture['gru_scan'])
    print_gru_row("the training step's inputs", row, detail)
    # K1's row of the kernel line: the step's inputs (all but one of its
    # launches on the two paths are the CLI run's steps).
    row, detail = check_oscillator(capture['oscillator_skip'],
                                   'the training step')
    kernels[[r['name'] for r in kernels].index('oscillator_skip')] = row
    print(f"kernel oscillator_skip at the training step's inputs: {detail}; "
          f"max_abs_err {row['max_abs_err']:.3g}; kernel_ms {row['ms']:.4f} "
          f"plain_ms {row['plain_ms']:.4f} library_ms "
          f"{row['library_ms']:.4f} bound_ms {row['bound_ms']:.5f} "
          f"({row['bound_by']})", flush=True)
    for kernel, check in (('oscillator_skip_bwd', check_oscillator_bwd),
                          ('gru_scan_bwd', check_gru_bwd)):
        row, detail = check(capture[kernel])
        kernels.append(row)
        print(f"kernel {kernel}: {detail}; max_abs_err "
              f"{row['max_abs_err']:.3g}; kernel_ms {row['ms']:.4f} "
              f"plain_ms {row['plain_ms']:.4f} library_ms "
              f"{row['library_ms']:.4f} bound_ms {row['bound_ms']:.5f} "
              f"({row['bound_by']})", flush=True)
    rows, detail = check_note_release_pair(capture)
    kernels.extend(rows)
    for row in rows:
        plan = row.pop('plan')
        print(f"kernel {row['name']}: {detail}; plan lanes {plan['lanes']} "
              f"tile_t {plan['tile_t']} stages {plan['stages']} blocks "
              f"{plan['blocks']} smem {plan['smem_bytes']}; kernel_ms {row['ms']:.4f} card_ms "
              f"{row['card_ms']:.4f} plain_ms {row['plain_ms']:.4f} "
              f"library_ms none bound_ms {row['bound_ms']:.7f} "
              f"({row['bound_by']}) chain_bound_ms "
              f"{row['chain_bound_ms']:.5f}", flush=True)
    del capture

    t = training_path()
    per_step = sum(step_kernel_ms.values())
    print(f"training path: train_single_phase -b {TRAIN_BATCH} -s "
          f"{TRAIN_STEPS} -e 1 on cuda, wall {t['wall']:.1f} s; launches "
          f"{t['launches']}; total loss {t['losses'][0]:.4f} -> "
          f"{t['losses'][-1]:.4f}, validation {t['val']:.4f}", flush=True)
    print(f"training step, median of steps 2-{TRAIN_STEPS} (CUDA events): "
          f"{t['step_ms']:.2f} ms = forward {t['fwd_ms']:.2f} + backward "
          f"{t['bwd_ms']:.2f} + clip and Adam {t['opt_ms']:.2f}; kernels "
          f"{per_step:.2f} ms ({100 * per_step / t['step_ms']:.1f} %): "
          + ', '.join(f"{k} {v:.3f}" for k, v in sorted(
              step_kernel_ms.items())), flush=True)

    ckpt = os.path.join(OUT_DIR, 'train_exp', 'phase_1', 'last_iter')
    c = ckpt_render(ckpt, t.pop('trainer'), m['audio'])
    print(f"checkpoint path: synthesize_midi_file --ckpt {ckpt} on cuda, "
          f"demo.mid {MAIN_PATH_SECONDS:g} s: forward "
          f"{1e3 * statistics.median(c['forwards']):.1f} ms (median of "
          f"{forwards_text(c['forwards'])} ms), restore "
          + ' / '.join(f"{1e3 * r:.1f}" for r in c['restores'])
          + f" ms; launches {c['launches']}; {c['n_params']} parameters "
          f"equal to the checkpoint's; against the initial weights' render "
          f"{c['from_initial']:.3g} of peak, against an in-process render of "
          f"the trainer's weights {c['gap']:.3g} (tolerance "
          f"{CKPT_RENDER_TOL:g}); export_jax_params / load_jax_params "
          f"round trip bit-exact", flush=True)
    e = evaluation_sweeps(ckpt)
    print(f"evaluation path: evaluate_model --ckpt --duration "
          f"{EVAL_SECONDS:g} on cuda, {EVAL_SEGMENTS} segments: sweep "
          f"{1e3 * e['b1']['seconds'] / EVAL_SEGMENTS:.1f} ms a segment at "
          f"b=1, {1e3 * e['b4']['seconds'] / EVAL_SEGMENTS:.1f} at b=4 "
          f"(wall, data loading included); eval step alone (CUDA events) "
          f"{e['step_ms'][1]:.2f} ms a segment at b=1, {e['step_ms'][4]:.2f} "
          f"at b=4; losses {np.round(e['loss'], 4).tolist()}, b=4 against "
          f"b=1 within {e['rel']:.3g} (rtol {EVAL_RTOL:g}); b=4 launches "
          f"{e['launches']}; its kernels at their inputs, each against its "
          f"plain version: " + kernels_line(e['kernel_ms']), flush=True)
    print(tensorflow_line(), flush=True)

    soak = gate2_soak()
    print(f"gate 2 soak: maestro_v2 b={TRAIN_BATCH} x {SEGMENT_SECONDS:g} s, "
          f"phase 1, student seed {STUDENT_SEED}, {SOAK_STEPS} steps over "
          f"{SOAK_BATCHES} staged batches of the mini-MAESTRO: loss every 10 "
          f"steps " + ', '.join(f"{v:.4f}" for v in soak['losses'][::10])
          + f", last {soak['losses'][-1]:.4f}; mean of the first "
          f"{SOAK_WINDOW} {soak['head']:.4f}, of the last {SOAK_WINDOW} "
          f"{soak['tail']:.4f}, ratio {soak['ratio']:.4f}; step median "
          f"{soak['step_ms']:.2f} ms (CUDA events), wall "
          f"{soak['wall_ms']:.2f} ms a step; launches {soak['launches']}",
          flush=True)

    stream = v2_streaming()
    print(streaming_line('v2 streaming path', stream), flush=True)
    print(costs_line(stream['costs']), flush=True)
    for oscillator, r in dafx22_streaming().items():
        print(streaming_line(f'dafx22 streaming path, --oscillator '
                             f'{oscillator}', r)
              + f"; K2 launches {r['launches']['gru_scan']} (the Normalize "
              f"sweeps {3 * r['chunks']}, the render "
              f"{2 * (r['chunks'] + 1)})", flush=True)

    config_renders()
    config_steps()

    cache = cache_path()
    for line in cache_path_lines(cache):
        print(line, flush=True)

    t0 = time.perf_counter()
    serving = serving_path()
    for b, r in serving['runs'].items():
        print(f"serving path: make_serving_fn, v2 at full width, demo.mid's "
              f"roll ({serving['seconds']:g} s) x b={b} on cuda: serve "
              f"{r['ms']:.2f} ms (CUDA events, median of "
              + ' / '.join(f"{x:.2f}" for x in r['times'])
              + f" ms after a warm-up; {r['rtf']:.1f}x realtime over the "
              f"batch's audio); launches {r['launches']}; against the "
              f"forward on the host allocator's conditioning {r['gap']:.3g} "
              f"of peak (tolerance {SERVE_TOL:g}); kernels at their own "
              "inputs, each against its plain version: "
              + grouped_kernels_line(r['kernel_ms'])
              + f"; bounds {r['bounds']}", flush=True)
    row = serving['row']
    kernels.append(row)
    print(f"kernel voice_allocator: {serving['detail']}; max_abs_err 0; "
          f"kernel_ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
          f"library_ms none bound_ms {row['bound_ms']:.7f} "
          f"({row['bound_by']}); phase {time.perf_counter() - t0:.1f} s",
          flush=True)

    c = csv_path()
    print(f"CSV path: synthesize_from_csv -d {MAIN_PATH_SECONDS:g} "
          f"--decompose, {len(CSV_ROWS)} rows of demo.mid, v2 on cuda: "
          f"{c['seconds']:.1f} s (data and wav writes included); launches "
          f"{c['launches']}; rms " + ', '.join(
              f"{k} {v:.4f}" for k, v in sorted(c['rms'].items()))
          + "; kernels at their own inputs, each against its plain "
          "version: " + grouped_kernels_line(c['kernel_ms'])
          + f"; bounds {c['bounds']}", flush=True)

    streams = config_streaming()
    for (config, oscillator), r in streams.items():
        print(streaming_line(f'{config} streaming path, --oscillator '
                             f'{oscillator}', r)
              + f"; bounds {r['bounds']}; phase part "
              f"{r['phase_seconds']:.1f} s", flush=True)
        if 'costs' in r:
            print(costs_line(r['costs'], config), flush=True)

    t0 = time.perf_counter()
    sm = summaries_path()
    print(summaries_line(sm, time.perf_counter() - t0), flush=True)
    t0 = time.perf_counter()
    g = gin_path()
    for line in gin_lines(g, time.perf_counter() - t0):
        print(line, flush=True)
    this_slice = slice_launches(sm, g)

    par = parallel_path()
    for line in parallel_lines(par):
        print(line, flush=True)
    for k, n in parallel_launches(par).items():
        this_slice[k] = this_slice.get(k, 0) + n

    t0 = time.perf_counter()
    alloc = allocator_path()
    low = bf16_path()
    for line in phase25_lines(alloc, low):
        print(line, flush=True)
    print(ffmpeg_line() + f"; phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    for k, n in low['launches'].items():
        this_slice[k] = this_slice.get(k, 0) + n
    for row in kernels:
        if row['name'] in low['rows']:
            row.update(low['rows'][row['name']][0])

    prof = profile_training_steps()
    if not prof['busy_ms'] > 0:
        fail("the profiler recorded no device time over the training steps")
    print(f"profile of {TRAIN_BATCH}-row training steps (torch.profiler): "
          f"wall {prof['wall_ms']:.2f} ms per step, device busy "
          f"{prof['busy_ms']:.2f} ms "
          f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f} %); most device "
          f"ms per step (calls): {'; '.join(prof['device'])}", flush=True)
    print(f"most host ms per step (calls): {'; '.join(prof['host'])}",
          flush=True)
    lost = sum(n - got for got, n in prof['launches'].values())
    print("hand-written kernels in the profile, device events recorded / "
          "launches counted: " + ', '.join(
              f"{k} {got}/{n}" for k, (got, n) in sorted(
                  prof['launches'].items()))
          + ("; complete" if lost == 0 else
             f"; {lost} launches not recorded: device busy undercounts"),
          flush=True)

    g = gradient_check()
    print("gradients, cuda vs cpu plain (b=1, "
          f"{GRAD_CHECK_SECONDS:g} s, {g['v2']['n_leaves']} trainable "
          "leaves): " + '; '.join(
              f"{name} loss {r['loss_gpu']:.6f} vs {r['loss_cpu']:.6f}, "
              f"worst leaf {r['worst']} {r['worst_err']:.3g} of its peak, "
              f"median {r['median_err']:.3g}, cosine {r['cosine']:.7f}"
              for name, r in g.items())
          + f" (tolerances {STEP_TOL_MAG:g} magnitudes; {STEP_TOL_V2:g} and "
          f"cosine {STEP_MIN_COSINE} v2)", flush=True)
    print("gradients with the GRU kernels' plain versions on cuda, worst "
          "leaf of each pair as a share of its peak: " + '; '.join(
              f"{name} loss: them against the cpu {r['plain_gru_vs_cpu']}, "
              f"the kernels against them {r['kernels_vs_plain_gru']}, them "
              f"in float64 against them {r['f64_gru_vs_plain_gru']}"
              for name, r in g.items()), flush=True)

    for row in kernels:
        route, source, replaces = KERNEL_SOURCES[row['name']]
        if row['name'] == 'voice_allocator':
            launches = (sum(r['launches'][row['name']]
                            for r in serving['runs'].values())
                        + c['launches'][row['name']])
        elif row['name'] == 'oscillator_full':
            launches = runs['full']['launches'][row['name']]
        elif row['name'] == 'oscillator_skip':
            launches = (m['launches'][row['name']]
                        + t['launches'][row['name']])
        else:
            launches = (m['launches'] if row['name'] in RENDER_KERNELS
                        else t['launches'])[row['name']]
        if row['name'] in CACHE_KERNELS:
            launches += cache['launches'][row['name']]
        launches += this_slice.get(row['name'], 0)
        row.update(route=route, source=source, replaces=replaces,
                   launches=launches)
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'card_ms',
            'bf16_launches', 'bf16_max_abs_err', 'bf16_ms', 'bf16_card_ms',
            'bf16_bound_ms')
    print(json.dumps({'kernels': [{k: row[k] for k in keys if k in row}
                                  for row in kernels]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': count}}))


if __name__ == '__main__':
    main()
