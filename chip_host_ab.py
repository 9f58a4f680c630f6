#!/usr/bin/env python3
"""Same-call A/B of the v2 render forward and the serve on one NVIDIA GPU,
this checkout against another checkout's: the paths whose time outside the
kernels is host work, so a change to the Python around the kernels shows
here first.

    python3 chip_host_ab.py --other build/ab/parent [--pairs 10]

``--other`` is the root of another checkout of the repository, e.g. a
parent commit unpacked with ``git archive <commit> | tar -x -C
build/ab/parent``. It imports no JAX and nothing of ddsp_piano_tpu. Each
arm runs in a fresh process that imports ddsp_piano_torch from its own
checkout (building its kernels there) and times, with maestro_v2 at full
width, seed 0, piano 9:

- ``render_b1``: the forward on demo.mid's conditioning (10 s, b = 1),
  as chip_smoke.py phase 4 renders it;
- ``serve_b1``, ``serve_b8``: make_serving_fn over demo.mid's roll (10 s
  after the 0.5 s warm-up) at b = 1 and 8, as chip_smoke.py phase 19;
- ``midi_to_conditioning``: data.io.load_midi_as_conditioning of all of
  demo.mid (5500 frames: the MIDI parse, the pianoroll and the host voice
  allocator), host only;
- ``train_raw_step``: ``train_single_phase.main -b 6 -s 8 -e 1`` (v2 at
  full width, student seed 1) on the raw mini-MAESTRO folder of
  chip_smoke.py phase 9, which this script writes first: the span from
  the first step's start to the last step's end on the card's clock
  (the trainer's CUDA-event timeline) over the 8 steps, so the data
  thread's waits count (``span``), and the whole CLI call's wall time in
  seconds (``cli``).

The first three are three warm-up calls, then the median of 25 calls of
the wall time (host clock, the card synchronised before and after) and of
the CUDA events around the call; ``midi_to_conditioning`` the same of its
wall time alone. The pairs alternate which checkout runs first. Per
metric, the script prints both checkouts' medians and quartiles over the
pairs and the pairs this checkout is faster in. An arm that fails or
gives non-finite audio or losses ends the run with a non-zero exit code.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# Each metric's clocks.
METRICS = {'render_b1': ('wall', 'events'), 'serve_b1': ('wall', 'events'),
           'serve_b8': ('wall', 'events'), 'midi_to_conditioning': ('wall',),
           'train_raw_step': ('span', 'cli')}
SECONDS = 10.0
PIANO = 9
REPEATS = 25
TRAIN_STEPS = 8
MAESTRO_DIR = os.path.join(ROOT, 'build', 'chip_smoke', 'mini_maestro')


def timed(fn, torch):
    """(wall ms, CUDA-event ms), medians of REPEATS calls after three."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    walls, events = [], []
    for _ in range(REPEATS):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        events.append(start.elapsed_time(end))
    return statistics.median(walls), statistics.median(events)


def host_timed(fn):
    """Wall ms of a host-only call, the median of REPEATS after three."""
    for _ in range(3):
        fn()
    walls = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        fn()
        walls.append(1e3 * (time.perf_counter() - t0))
    return (statistics.median(walls),)


def train_raw_step(root, torch):
    """(span ms a step, CLI seconds) of the train CLI on the raw
    mini-MAESTRO folder."""
    import tempfile

    from ddsp_piano_torch import train_single_phase as cli

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as exp:
        args = cli.process_args(['-b', '6', '-s', str(TRAIN_STEPS), '-e', '1',
                                 '--seed', '1', '--device', 'cuda',
                                 MAESTRO_DIR, exp])
        start = time.perf_counter()
        result = cli.main(args, record_timeline=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    losses = np.asarray(result['step_losses'])
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise SystemExit(f"{root}: training losses {losses}")
    events = result['trainer'].timeline[-TRAIN_STEPS:]
    events[-1][3].synchronize()
    return (events[0][0].elapsed_time(events[-1][3]) / TRAIN_STEPS,
            seconds)


def arm(root):
    """The three timings of the checkout at ``root``, as a dict."""
    sys.path.insert(0, root)
    import torch

    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.data.io import (load_midi_as_conditioning,
                                          load_midi_as_roll)
    from ddsp_piano_torch.device import set_f32_precision
    from ddsp_piano_torch.models.serving import make_serving_fn

    set_f32_precision()
    dev = torch.device('cuda')
    midi = os.path.join(root, 'examples', 'demo.mid')
    out = {}

    cond = load_midi_as_conditioning(midi, duration=SECONDS)
    model = get_model('maestro_v2', inference=True, device=dev, seed=0,
                      duration=cond['conditioning'].shape[1] / 250)
    features = {k: torch.from_numpy(cond[k].astype(np.float32)).to(dev)
                for k in ('conditioning', 'pedal')}
    features['piano_model'] = torch.tensor([[PIANO]], device=dev)
    generator = torch.Generator(device=dev)

    def render():
        with torch.inference_mode():
            return model(features,
                         generator=generator.manual_seed(0))['audio_synth']

    if not bool(torch.isfinite(render()).all()):
        raise SystemExit(f"{root}: the render is not finite")
    out['render_b1'] = timed(render, torch)
    del model

    demo = load_midi_as_roll(midi, duration=SECONDS, warm_up_duration=0.5)
    model = get_model('maestro_v2', inference=True, device=dev, seed=0,
                      duration=demo['roll'].shape[1] / 250)
    serve = make_serving_fn(model, seed=0)
    for b in (1, 8):
        roll = torch.from_numpy(np.repeat(demo['roll'], b, 0)).to(dev)
        pedal = torch.from_numpy(np.repeat(demo['pedal'], b, 0)).to(dev)
        piano = (PIANO + torch.arange(b, device=dev)[:, None]) % 10
        if not bool(torch.isfinite(serve(roll, pedal, piano)).all()):
            raise SystemExit(f"{root}: the serve at b={b} is not finite")
        out[f'serve_b{b}'] = timed(lambda: serve(roll, pedal, piano), torch)
    del model, serve
    out['midi_to_conditioning'] = host_timed(
        lambda: load_midi_as_conditioning(midi))
    out['train_raw_step'] = train_raw_step(root, torch)
    return out


def run_arm(root):
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           '--arm', root], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout + proc.stderr)
        raise SystemExit(f"the arm of {root} failed ({proc.returncode})")
    line = [l for l in proc.stdout.splitlines() if l.startswith('{')][-1]
    return json.loads(line)


def quartiles(values):
    q1, q3 = np.percentile(values, [25, 75])
    return f"{statistics.median(values):.3f} ({q1:.3f}-{q3:.3f})"


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--other', help="root of the checkout to compare "
                        "this one with")
    parser.add_argument('--pairs', type=int, default=10)
    parser.add_argument('--arm', help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.arm:
        print(json.dumps(arm(os.path.abspath(args.arm))), flush=True)
        return
    if not args.other:
        parser.error("--other is required")
    other = os.path.abspath(args.other)
    sys.path.insert(0, ROOT)
    import chip_smoke
    from ddsp_piano_torch.device import set_f32_precision

    set_f32_precision()
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    chip_smoke.build_kernels()
    seconds, _ = chip_smoke.teacher_data()
    print(f"mini-MAESTRO written: demo.mid's {seconds:g} s teacher render "
          f"in {MAESTRO_DIR}", flush=True)
    pairs = []
    for i in range(args.pairs):
        order = (other, ROOT) if i % 2 == 0 else (ROOT, other)
        got = {root: run_arm(root) for root in order}
        print(f"pair {i + 1}: " + json.dumps(
            {'other': got[other], 'this': got[ROOT]}), flush=True)
        pairs.append((got[other], got[ROOT]))
    for metric, clocks in METRICS.items():
        for k, clock in enumerate(clocks):
            theirs = [o[metric][k] for o, _ in pairs]
            ours = [t[metric][k] for _, t in pairs]
            wins = sum(t < o for o, t in zip(theirs, ours))
            unit = 's' if clock == 'cli' else 'ms'
            print(f"{metric} {clock} {unit}: other {quartiles(theirs)}, this "
                  f"{quartiles(ours)}; this faster in {wins} of "
                  f"{len(pairs)} pairs", flush=True)


if __name__ == '__main__':
    main()
