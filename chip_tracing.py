#!/usr/bin/env python3
"""The cost of the program's spans, and where the card sits idle, in the
benchmark's cells on one NVIDIA GPU.

    python3 chip_tracing.py [--cells v2.serve-b8,dafx22.serve-b8,v2.train-b6]
        [--seed N] [--seconds 5] [--repeats 3] [--units 8]
        [--out build/chip_tracing]

Each cell of BENCHMARK.json is set up as ``portbench/run.py`` sets it up
(its configuration, mix, seeded weights and inputs; ``portbench/`` is
read, not changed), with ddsp_piano_torch.tracing on from before the
model is built, so that set-up's spans are kept: ``setup.model``
(configs.get_model) and ``kernels.load`` (the kernels' build and load).
After the warm-up the script measures, in turn:

- ``off`` and ``spans``: the pace of the cell's loop (requests or steps a
  second) over ``--seconds`` with tracing off, and with tracing on and no
  profiler; ``--repeats`` windows of each, alternating (off, spans,
  spans, off, ...);
- ``host_profiled``: ``--units`` requests or steps under torch.profiler
  recording the host and the device, tracing off, as the benchmark's
  traced sub-window records them: its pace and the card's idle share;
- ``device_profiled``: ``--units`` more under torch.profiler recording the
  device alone, tracing on: its pace and idle share; the card's idle
  time a unit by the innermost span open at each instant
  (``tracing.idle_by_span``), summed into the layers of PERF.md's
  "Tracing" table; the kernel and graph launches and the spans a unit;
  in a training cell the share of its steps replayed from the step's
  CUDA graphs (``Trainer.graph_replays``); the share of the launch calls
  that fall inside a unit's root spans (``serve.request``; ``train.step``
  or ``train.stage``), which shows the spans and the profile on one
  clock.

First, one line of the host microseconds an empty span costs, tracing
off and on. Then one JSON line a cell goes to standard output and to
``<out>/<cell>.json``. It imports no JAX and nothing of ddsp_piano_tpu.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from ddsp_piano_torch import tracing  # noqa: E402

# The layers of an idle interval, by the innermost span open in it.
LAYERS = {
    'serve': {'upload': ('serve.upload',),
              'launch': ('serve.request', 'serve.allocate', 'model.forward',
                         'model.networks', 'model.synthesis',
                         'kernels.load'),
              'caller': (tracing.CALLER,)},
    'train': {'stage': ('train.stage',),
              'forward': ('train.forward', 'model.forward',
                          'model.networks', 'model.synthesis',
                          'model.losses', 'kernels.load'),
              'backward': ('train.backward',),
              'update': ('train.update', 'train.step', 'train.reduce'),
              'caller': (tracing.CALLER,)},
}
ROOTS = {'serve': ('serve.request',), 'train': ('train.step', 'train.stage')}


def serve_cell(cell, seed, device):
    """(one unit: a request of the pool in turn, the loop's kind)."""
    from portbench import generator, program
    from portbench.reference import piano as reference

    mix, config = cell.mix, cell.config
    duration = float(mix['seconds_per_row'])
    ref = reference.build(config, True, duration, seed, 'cpu')
    model = program.model(config, ref.state_dict(), inference=True,
                          duration=duration, device=device)
    pool = generator.batches(mix, int(mix['pool_requests']),
                             config['build']['frame_rate'], seed)
    n_samples = int(round(duration * config['build']['sample_rate']))
    draw = torch.Generator(device=device).manual_seed(
        program.torch_seed(seed, 'noise'))
    noise = 2.0 * torch.rand((model.n_synths * int(mix['batch']), n_samples),
                             generator=draw, device=device) - 1.0
    serve = program.serving_fn(model, seed)
    requests = itertools.cycle(pool)

    def unit():
        r = next(requests)
        serve(r['roll'], r['pedal'], r['piano_model'], noise=noise).cpu()

    return unit


def train_cell(cell, seed, device):
    from portbench import program
    from portbench.loops import train as loop
    from portbench.reference import piano as reference

    mix, config = cell.mix, cell.config
    ref = reference.build(config, False, float(mix['seconds_per_row']),
                          seed, 'cpu')
    model = program.model(config, ref.state_dict(), inference=False,
                          duration=float(mix['seconds_per_row']),
                          device=device)
    pool = loop.host_batches(cell, seed, device)
    noises = loop.noise_pool(cell, seed, model.n_synths, device)
    trainer = program.trainer(model, mix, seed, record_timeline=False)
    feed = trainer.device_prefetch(itertools.cycle(pool), packed=True)

    def unit():
        trainer.train_step(next(feed), noise=noises[trainer.step
                                                    % len(noises)])

    unit.trainer = trainer
    return unit


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize()


def pace(unit, seconds, device):
    """Units a second over ``seconds``, the card synchronised at both
    ends."""
    sync(device)
    start = time.perf_counter()
    n = 0
    while time.perf_counter() - start < seconds:
        unit()
        n += 1
    sync(device)
    return n / (time.perf_counter() - start)


def profiled(unit, n, device, activities):
    """(the profiler, the window's (start_ns, end_ns) on the spans'
    clock, its pace in units a second) over n units."""
    from torch.profiler import profile

    sync(device)
    with profile(activities=activities) as prof:
        start = time.time_ns()
        for _ in range(n):
            unit()
        sync(device)
        end = time.time_ns()
    return prof, (start, end), n / ((end - start) * 1e-9)


def span_cost(n=200000):
    """Host microseconds of one empty span (enter and exit), tracing off
    and on (no profiler running), and of the bare loop around them."""
    out = {}
    for arm in ('loop', 'off', 'on'):
        recorder = tracing.enable() if arm == 'on' else None
        start = time.perf_counter()
        if arm == 'loop':
            for _ in range(n):
                pass
        else:
            for _ in range(n):
                with tracing.span('x'):
                    pass
        out[arm] = (time.perf_counter() - start) / n * 1e6
        tracing.disable()
        del recorder
    return out


def idle_share(busy, window):
    lo, hi = window
    covered = sum(b - a for a, b in tracing._union(busy, lo, hi))
    return 1.0 - covered / (hi - lo)


def measure(name, seed, seconds, repeats, n_units, device):
    from torch.profiler import ProfilerActivity

    from portbench import harness

    cell = harness.load_cell(name)
    kind = cell.mix['loop']
    recorder = tracing.enable()
    tick = time.perf_counter()
    unit = (serve_cell if kind == 'serve' else train_cell)(cell, seed,
                                                           device)
    for _ in range(3):
        unit()
    sync(device)
    out = {'cell': name, 'seed': seed,
           'setup_s_with_pool': time.perf_counter() - tick,
           'setup_model_s': sum(s.end_ns - s.start_ns for s in
                                recorder.named('setup.model')) * 1e-9,
           'setup_kernels_s': sum(s.end_ns - s.start_ns for s in
                                  recorder.named('kernels.load')) * 1e-9}
    tracing.disable()

    paces = {'off': [], 'spans': []}
    for i in range(repeats):
        for arm in (('off', 'spans') if i % 2 == 0 else ('spans', 'off')):
            if arm == 'spans':
                tracing.enable()
            paces[arm].append(pace(unit, seconds, device))
            tracing.disable()
    for arm, values in paces.items():
        out[f'{arm}_units_per_s'] = values
        out[f'{arm}_ms'] = 1e3 / statistics.median(values)

    host = [ProfilerActivity.CPU]
    card = [ProfilerActivity.CUDA] if device.type == 'cuda' else []
    prof, window, rate = profiled(unit, n_units, device, host + card)
    busy, _ = tracing.profile_activity(prof)
    out['host_profiled_ms'] = 1e3 / rate
    out['host_profiled_idle_pct'] = 100.0 * idle_share(busy, window)
    del prof

    trainer = getattr(unit, 'trainer', None)
    replays = trainer.graph_replays if trainer is not None else 0
    recorder = tracing.enable()
    prof, window, rate = profiled(unit, n_units, device, card or host)
    tracing.disable()
    if trainer is not None:
        out['replay_share'] = (trainer.graph_replays - replays) / n_units
    busy, launches = tracing.profile_activity(prof)
    spans = [s for s in recorder.spans
             if s.end_ns > window[0] and s.start_ns < window[1]]
    idle = tracing.idle_by_span(spans, busy, window)
    hits, total = tracing.inside(spans, launches, ROOTS[kind])
    out.update(
        device_profiled_ms=1e3 / rate,
        device_profiled_idle_pct=100.0 * idle_share(busy, window),
        idle_ms_by_span={k: 1e3 * v / n_units for k, v in
                         sorted(idle.items(), key=lambda kv: -kv[1])},
        idle_ms={layer: 1e3 * sum(idle.get(s, 0.0) for s in names)
                 / n_units for layer, names in LAYERS[kind].items()},
        idle_ms_total=1e3 * sum(idle.values()) / n_units,
        launches_per_unit=total / n_units,
        spans_per_unit=len(spans) / n_units,
        launches_inside_pct=100.0 * hits / max(total, 1),
        device_events=len(busy))
    out['idle_ms_unplaced'] = out['idle_ms_total'] - sum(
        out['idle_ms'].values())
    del prof, unit
    import gc
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--cells',
                        default='v2.serve-b8,dafx22.serve-b8,v2.train-b6')
    parser.add_argument('--seed', type=int, default=3000000101)
    parser.add_argument('--seconds', type=float, default=5.0)
    parser.add_argument('--repeats', type=int, default=3)
    parser.add_argument('--units', type=int, default=8)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--out', default=os.path.join(ROOT, 'build',
                                                      'chip_tracing'))
    args = parser.parse_args(argv)
    for var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS'):
        os.environ[var] = '1'
    torch.set_num_threads(1)
    device = torch.device(args.device)
    out_dir = args.out
    os.makedirs(out_dir, exist_ok=True)
    print(json.dumps({'span_us': span_cost()}), flush=True)
    for k, name in enumerate(args.cells.split(',')):
        result = measure(name, args.seed + k, args.seconds, args.repeats,
                         args.units, device)
        if device.type == 'cuda':
            result['card'] = torch.cuda.get_device_name(0)
        line = json.dumps(result)
        print(line, flush=True)
        with open(os.path.join(out_dir, f'{name}.json'), 'w') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
