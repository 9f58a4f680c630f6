"""Batch serving: a closed loop of one client over a pool of seeded
requests, each a batch of rolls rendered by the port's serving entry
(``make_serving_fn(model)(roll, pedal, piano_model, noise=...)``) and
copied back to the host.

Set-up builds the model with the benchmark's weights, draws the pool and
the noise synth's uniform draw from the seed, and serves two requests of
the pool's shape. The pool is the benchmark's input, not the program's
set-up: its seconds are left out of setup_s. The window serves the pool in
order, round and round, for the run's seconds; each request is timed from
the call with the host's numpy roll to its audio in host memory. After
the window, the served audio of a seeded sample of the pool's requests is
compared with the reference's render of the same inputs, every time each
was served.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import generator, harness, program, yardstick
from portbench.reference import piano as reference


def _serve_request(serve, request, noise):
    """One request: (audio on the host, seconds to the serve's return,
    seconds to the audio on the host)."""
    t0 = time.perf_counter()
    out = serve(request['roll'], request['pedal'], request['piano_model'],
                noise=noise)
    t1 = time.perf_counter()
    audio = out.cpu().numpy()
    return audio, t1 - t0, time.perf_counter() - t0


def _gap(served: np.ndarray, want: np.ndarray) -> float:
    """The widest gap between served and reference audio, each row as a
    share of the reference row's peak."""
    if served.shape != want.shape or not np.all(np.isfinite(served)):
        return float('inf')
    err = np.abs(served.astype(np.float64) - want).max(axis=-1)
    return float((err / np.abs(want).max(axis=-1)).max())


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        clock: harness.Clock, device: torch.device):
    mix, config = cell.mix, cell.config
    duration = float(mix['seconds_per_row'])
    ref = reference.build(config, True, duration, seed, 'cpu')
    model = program.model(config, ref.state_dict(), inference=True,
                          duration=duration, device=device)
    rate = config['build']['frame_rate']
    tick = time.perf_counter()
    pool = generator.batches(mix, int(mix['pool_requests']), rate, seed)
    pool_s = time.perf_counter() - tick
    b = int(mix['batch'])
    n_samples = int(round(duration * config['build']['sample_rate']))
    draw = torch.Generator(device=device).manual_seed(
        program.torch_seed(seed, 'noise'))
    noise = 2.0 * torch.rand((model.n_synths * b, n_samples),
                             generator=draw, device=device) - 1.0
    serve = program.serving_fn(model, seed)
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 0x636865636B])
    checked = sorted(rng.choice(len(pool), int(mix['check_requests']),
                                replace=False).tolist())
    for _ in range(2):
        _serve_request(serve, pool[0], noise)
    program.synchronize(device)
    setup_s = clock.seconds() - pool_s

    kept: Dict[int, List[np.ndarray]] = {i: [] for i in checked}
    latencies, enqueue, failed = [], [], 0
    program.reset_peak(device)
    prof = None
    launches0 = program.launches()
    if trace:
        order = [checked[i % len(checked)]
                 for i in range(int(mix['traced_requests']))]
        prof = program.profiler(device)
        prof.__enter__()
    else:
        order = None
    start = time.perf_counter()
    i = 0
    while (i < len(order)) if order is not None else (
            time.perf_counter() - start < seconds):
        p = order[i] if order is not None else i % len(pool)
        audio, t_enq, t_all = _serve_request(serve, pool[p], noise)
        latencies.append(t_all)
        enqueue.append(t_enq)
        if audio.shape != (b, n_samples):
            failed += 1
        if p in kept:
            kept[p].append(audio)
        i += 1
    elapsed = time.perf_counter() - start
    if prof is not None:
        prof.__exit__(None, None, None)
    launches = {k: v - launches0.get(k, 0)
                for k, v in program.launches().items()}
    device_info = harness.device_block(cell.chips, None) \
        if device.type == 'cuda' else None
    del model, serve, noise
    program.release(device)

    # The reference, on the same inputs.
    ref.to(device)
    ref_noise = 2.0 * torch.rand(
        (ref.n_synths * b, n_samples),
        generator=torch.Generator(device=device).manual_seed(
            program.torch_seed(seed, 'noise')), device=device) - 1.0
    gap, counts = 0.0, []
    for p in checked:
        with reference.matmul_precision(False), \
                yardstick.Count(ref) as count:
            cond = reference.conditioning(pool[p]['roll'], ref.n_synths)
            want = reference.render(ref, cond, pool[p]['pedal'],
                                    pool[p]['piano_model'], ref_noise)
        want = want.double().cpu().numpy()
        counts.append(count)
        for served in kept[p]:
            gap = max(gap, _gap(served, want))
    correct = failed == 0 and all(kept[p] for p in checked) \
        and gap <= cell.limits['audio_gap']
    result = {'correct': bool(correct), 'attempted': len(latencies) + failed,
              'failed': failed}
    if trace:
        t = harness.Trace(kind='serve', window_s=elapsed,
                          units=len(order), launches=launches)
        harness.read_profile(prof, t)
        by_entry = {p: c for p, c in zip(checked, counts)}
        t.spans['serve.enqueue'] = enqueue
        t.spans['serve.request'] = latencies
        for p in order:
            for k, v in by_entry[p].bounds().items():
                t.bounds[k] = t.bounds.get(k, 0.0) + v
            t.model_flops += by_entry[p].forward_flops()
        t.peak_bytes = device_info['memory_peak_bytes']
        result['metrics'] = harness.per_layer_metrics(cell, t)
        result['device'] = harness.device_block(cell.chips, t)
        result['device']['memory_peak_bytes'] = t.peak_bytes
        result['breakdown'] = {'device_ops': [list(x) for x in t.top_ops],
                               'idle_gaps': [list(x) for x in t.idle_gaps]}
    else:
        audio_s = b * duration * len(latencies)
        metrics = {'audio_s_per_s': audio_s / elapsed,
                   'serve_p95_ms': harness.p95(latencies) * 1e3,
                   'setup_s': setup_s}
        result['metrics'] = {m['name']: {'value': metrics[m['name']],
                                         'unit': m['unit']}
                             for m in cell.end_to_end}
        result['device'] = device_info
    return result, {'audio_gap': (gap, cell.limits['audio_gap'])}
