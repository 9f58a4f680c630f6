"""Training: the port's Trainer stepping on packed batches staged one ahead
by ``Trainer.device_prefetch(..., packed=True)``, the train CLI's path,
on one card or data-parallel over several (one process a card, launched
by ``parallel.mesh.launch`` as the CLIs launch their ranks).

Set-up builds the model with the benchmark's weights and the Trainer, draws
a pool of batches from the seed (rolls through the reference's voice
allocator; target audio rendered once by the reference with the weights of
seed + 1, peak-normalised to 0.5 and rounded to 16-bit PCM as a cache
holds it) and a noise draw for each, and takes the first three steps
through the window's own feed: the checked steps. The pool is the
benchmark's input, not the program's set-up: rank 0 makes it once and
hands it to the other ranks, and its seconds are left out of setup_s. The
window goes on stepping through the same feed. Afterwards the reference
takes the three checked steps from the same weights on the same batches
and draws, and the first step's loss, the first step's change of the
parameters and their change over the three are compared (step_checks).
"""

from __future__ import annotations

import itertools
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import generator, harness, program, yardstick
from portbench.reference import piano as reference

CHECKED_STEPS = 3
ADAM_B1 = 0.9
ADAM_EPS = 1e-8
# Where the first clipped gradient's element is at least this, Adam's
# first step, lr g / (|g| + eps), is within 1 % of lr sign(g) whatever the
# clip's common factor (PERF.md).
SATURATED = 100.0 * ADAM_EPS


def host_batches(cell: harness.Cell, seed: int, device) -> List[Dict]:
    """The pool of host batches: conditioning, pedal, piano_model and the
    teacher's target audio, float32 / int32 numpy as the cache yields
    them."""
    mix, config = cell.mix, cell.config
    duration = float(mix['seconds_per_row'])
    rows = generator.batches(mix, int(mix['pool_batches']),
                             config['build']['frame_rate'], seed)
    teacher = reference.build(config, False, duration, seed + 1, device)
    n = teacher.n_synths
    out = []
    for i, r in enumerate(rows):
        cond = reference.conditioning(r['roll'], n)
        b = cond.shape[0]
        draw = torch.Generator(device=device).manual_seed(
            program.torch_seed(seed, f'teacher{i}'))
        n_samples = int(round(duration * config['build']['sample_rate']))
        noise = 2.0 * torch.rand((n * b, n_samples), generator=draw,
                                 device=device) - 1.0
        with reference.matmul_precision(False):
            audio = reference.render(teacher, cond, r['pedal'],
                                     r['piano_model'], noise)
        audio = audio.double().cpu().numpy()
        audio *= 0.5 / np.maximum(np.abs(audio).max(-1, keepdims=True),
                                  1e-12)
        pcm = np.clip(np.round(audio * 32768.0), -32768, 32767)
        out.append({'audio': (pcm.astype(np.int16).astype(np.float32)
                              / np.float32(32768.0)),
                    'conditioning': cond.astype(np.float32),
                    'pedal': r['pedal'], 'piano_model': r['piano_model']})
    del teacher
    return out


def noise_pool(cell: harness.Cell, seed: int, n_synths: int, device
               ) -> List[torch.Tensor]:
    """A uniform draw in [-1, 1) for each pool batch, (n_synths x batch,
    n_samples), on ``device``: the global batch's, of which each rank's
    Trainer keeps its rows."""
    mix = cell.mix
    b = int(mix['batch'])
    n_samples = int(round(float(mix['seconds_per_row'])
                          * cell.config['build']['sample_rate']))
    draw = torch.Generator(device=device).manual_seed(
        program.torch_seed(seed, 'noise'))
    return [2.0 * torch.rand((n_synths * b, n_samples), generator=draw,
                             device=device) - 1.0
            for _ in range(int(mix['pool_batches']))]


def leaf_gaps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Each leaf's gap between two norms, against the reference leaf's
    norm or the median leaf's, whichever is larger."""
    return np.abs(got - want) / np.maximum(want, np.median(want))


def scale_free_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The median leaf's gap between two sets of leaf norms up to one
    common factor: each leaf's ratio of norms against the median ratio.
    The global-norm clip scales every leaf by one factor that one or two
    dominant leaves set (PERF.md); this measure does not see it."""
    ratios = got / want
    middle = np.median(ratios)
    if not middle > 0:
        return 1.0
    return float(np.median(np.abs(ratios / middle - 1.0)))


def kept_leaves(want: Dict) -> np.ndarray:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's (Adam moves the others by round-off alone)."""
    return want['grad_norms'] >= 1e-3 * np.median(want['grad_norms'])


def first_step_gap(first_step: List[torch.Tensor], want: Dict) -> float:
    """The first step's change of the parameters against the reference's,
    over the elements whose reference gradient is SATURATED: the norm of
    the difference over the norm of the reference's. Adam moves each such
    element by about the learning rate along the gradient's sign, so a
    step of the wrong sign reads 2, of the wrong size its share off, and a
    step left out 1."""
    num = den = 0.0
    for got, ref, grad in zip(first_step, want['first_step'],
                              want['first_grad']):
        mask = grad.abs() >= SATURATED
        ref = ref.double()[mask]
        num += float(torch.sum((got.double()[mask] - ref) ** 2))
        den += float(torch.sum(ref ** 2))
    return float(np.sqrt(num / den)) if den > 0 else float('inf')


def step_checks(losses: List[float], change: np.ndarray,
                first_step: List[torch.Tensor], want: Dict
                ) -> Dict[str, float]:
    """The numbers compared between the checked steps and the
    reference's (PERF.md says why these and not each step's loss and the
    first gradient): the first step's loss, the first step's change of the
    saturated elements (direction and size), and the parameters' change
    over the steps by the median of the kept leaves."""
    keep = kept_leaves(want)
    return {
        'loss0_gap': abs(losses[0] - want['losses'][0])
        / abs(want['losses'][0]),
        'step_gap': first_step_gap(first_step, want),
        'update_median_gap': float(np.median(
            leaf_gaps(change, want['change_norms'])[keep]))}


def gradient_gap(grads: np.ndarray, want: Dict) -> float:
    """The first clipped gradient's leaf norms against the reference's by
    the median leaf, up to the clip's common factor: printed beside the
    checks, not compared (PERF.md)."""
    keep = kept_leaves(want)
    return scale_free_gap(grads[keep], want['grad_norms'][keep])


def _rank(cell: harness.Cell, seed: int, seconds: float, trace: bool,
          t0: float, device) -> Dict:
    """One rank's run (the whole run on one card). Returns its readings;
    rank 0's carry the checks and the metrics."""
    from ddsp_piano_torch.parallel import mesh

    mix, config = cell.mix, cell.config
    device = mesh.local_device(device)
    rank, world = mesh.rank(), mesh.world_size()
    duration = float(mix['seconds_per_row'])
    ref = reference.build(config, False, duration, seed, 'cpu')
    model = program.model(config, ref.state_dict(), inference=False,
                          duration=duration, device=device)
    tick = time.time()
    made = [host_batches(cell, seed, device) if rank == 0 else None]
    if world > 1:
        torch.distributed.broadcast_object_list(made, 0)
    pool = made[0]
    pool_s = time.time() - tick
    noises = noise_pool(cell, seed, model.n_synths, device)
    trainer = program.trainer(model, mix, seed, record_timeline=trace)
    feed = trainer.device_prefetch(
        trainer.distribute_dataset(itertools.cycle(pool)), packed=True)
    P = len(pool)

    names = [n for n, _ in trainer.named_params]
    start = [p.detach().clone() for p in trainer.params]
    losses, grads, first_step = [], None, None
    for k in range(CHECKED_STEPS):
        losses.append(trainer.train_step(next(feed), noise=noises[k % P]))
        if k == 0:
            # The gradient as Adam took it: its first moment over 1 - b1
            # (nothing, where the step left no moment).
            grads = reference.leaf_norms([
                trainer.optimizer.state.get(p, {}).get(
                    'exp_avg', torch.zeros_like(p)) / (1.0 - ADAM_B1)
                for p in trainer.params])
            first_step = [(p.detach() - s).cpu()
                          for p, s in zip(trainer.params, start)]
    change = [(p.detach() - s).cpu() for p, s in zip(trainer.params, start)]
    losses = [float(l['total_loss']) for l in losses]
    del start
    step = CHECKED_STEPS
    # Warm-up of the step's host and device paths, then a calibration.
    for _ in range(2):
        trainer.train_step(next(feed), noise=noises[step % P])
        step += 1
    program.synchronize(device)
    if world > 1:
        torch.distributed.barrier()
    setup_s = time.time() - t0 - pool_s

    program.reset_peak(device)
    launches0 = program.launches()
    waits, prof = [], None
    n_traced = int(mix['traced_steps'])
    if trace:
        prof = program.profiler(device)
        prof.__enter__()
    if world > 1 and not trace:
        # Every rank takes the same number of steps: rank 0's count for
        # the run's seconds at the warm-up's pace.
        tick = time.perf_counter()
        for _ in range(3):
            trainer.train_step(next(feed), noise=noises[step % P])
            step += 1
        program.synchronize(device)
        pace = (time.perf_counter() - tick) / 3
        count = torch.tensor([max(1, int(round(seconds / pace)))],
                             device=device)
        torch.distributed.broadcast(count, 0)
        torch.distributed.barrier()
        n_steps = int(count)
    else:
        n_steps = n_traced if trace else None
    begin = time.perf_counter()
    done = 0
    while (done < n_steps) if n_steps is not None else (
            time.perf_counter() - begin < seconds):
        tick = time.perf_counter()
        batch = next(feed)
        waits.append(time.perf_counter() - tick)
        trainer.train_step(batch, noise=noises[step % P])
        step += 1
        done += 1
    program.synchronize(device)
    if world > 1:
        torch.distributed.barrier()
    elapsed = time.perf_counter() - begin
    if prof is not None:
        prof.__exit__(None, None, None)
    trainer.check_pending()
    launches = {k: v - launches0.get(k, 0)
                for k, v in program.launches().items()}
    out = {'steps': done, 'elapsed': elapsed, 'setup_s': setup_s,
           'peak': (int(torch.cuda.max_memory_allocated(device))
                    if device.type == "cuda" else 0)}
    if trace:
        t = harness.Trace(kind='dp' if world > 1 else 'train',
                          window_s=elapsed, units=done, launches=launches)
        harness.read_profile(prof, t)
        times = trainer.step_times()[-done:]
        t.spans['train.forward'] = [x[1] * 1e-3 for x in times]
        t.spans['train.backward'] = [x[2] * 1e-3 for x in times]
        t.spans['train.update'] = [x[3] * 1e-3 for x in times]
        t.spans['train.data_wait'] = waits
        if world > 1:
            reduces = trainer.reduce_times()[-done:]
            t.spans['dp.reduce'] = [x * 1e-3 for x in reduces]
        out['trace'] = t
        out['traced_batches'] = [(CHECKED_STEPS + 2 + i) % P
                                 for i in range(done)]
    del feed, trainer, model
    program.release(device)
    if rank != 0:
        out['forbidden'] = harness.forbidden_modules()
        return {k: v for k, v in out.items() if k != 'trace'} | (
            {'busy_s': out['trace'].busy_s,
             'reduce_ms': float(np.mean(out['trace'].spans['dp.reduce']))
             * 1e3} if trace else {})

    # The reference's checked steps, on rank 0's card.
    ref.to(device)
    with reference.matmul_precision(False):
        want = reference.train_steps(
            ref, pool[:CHECKED_STEPS], noises[:CHECKED_STEPS],
            float(mix['learning_rate']), float(mix['grad_clip_norm']),
            blocks=world)
    if want['names'] != names:
        raise RuntimeError("the reference's trainable leaves differ from "
                           "the Trainer's")
    out['checks'] = step_checks(losses, reference.leaf_norms(change),
                                first_step, want)
    out['gradient_gap'] = gradient_gap(grads, want)
    out['readings'] = {'losses': losses, 'first_step': first_step,
                       'change': change, 'want': want}
    if trace and world == 1:
        # The yardstick's counts at the traced batches, at the weights of
        # the reference's checked steps (the Trainer's at the sub-window).
        t = out['trace']
        for b in sorted(set(out['traced_batches'])):
            features = {key: torch.from_numpy(value).to(device)
                        for key, value in pool[b].items()}
            with torch.no_grad(), yardstick.Count(ref) as count:
                ref(features, noise=noises[b], training=True)
            n = out['traced_batches'].count(b)
            for k, v in count.bounds(backward=True).items():
                t.bounds[k] = t.bounds.get(k, 0.0) + n * v
            t.model_flops += n * count.training_flops()
    out['forbidden'] = harness.forbidden_modules()
    return out


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        clock: harness.Clock, device: torch.device, rank_fn=None,
        keep: Dict = None):
    """The cell's run; ``rank_fn`` (a module-level function, default
    _rank) runs each rank. The result's 'forbidden' lists the modules of
    JAX or the JAX package that any rank had loaded. ``keep``, a dict,
    receives rank 0's readings of the checked steps."""
    from ddsp_piano_torch.parallel import mesh

    rank_fn = rank_fn or _rank
    world = int(cell.mix.get('ranks', 1))
    t0 = time.time() - clock.seconds()
    if world == 1:
        ranks = [rank_fn(cell, seed, seconds, trace, t0, device)]
    else:
        ranks = mesh.launch(rank_fn, world,
                            (cell, seed, seconds, trace, t0, device.type),
                            device_type=device.type)
    head = ranks[0]
    checks = {k: (v, cell.limits[k]) for k, v in head['checks'].items()}
    correct = all(v <= limit for v, limit in checks.values())
    result = {'correct': bool(correct), 'attempted': head['steps'],
              'failed': 0,
              'forbidden': sorted(set().union(*(r['forbidden']
                                                for r in ranks)))}
    if keep is not None:
        keep.update(head['readings'])
    print(f"reading gradient_gap: {head['gradient_gap']!r} (not compared)",
          file=sys.stderr)
    peak = max(r['peak'] for r in ranks)
    if trace:
        t = head['trace']
        t.peak_bytes = peak
        if world > 1:
            t.busy_s = float(np.mean([t.busy_s] + [r['busy_s']
                                                   for r in ranks[1:]]))
            t.spans['dp.reduce_slowest'] = [max(
                [float(np.mean(t.spans['dp.reduce']))]
                + [r['reduce_ms'] * 1e-3 for r in ranks[1:]])]
        result['metrics'] = harness.per_layer_metrics(cell, t)
        result['breakdown'] = {'device_ops': [list(x) for x in t.top_ops],
                               'idle_gaps': [list(x) for x in t.idle_gaps]}
    else:
        rate = head['steps'] * int(cell.mix['batch']) / head['elapsed']
        metrics = {'train_segments_per_s': rate,
                   'dp_train_segments_per_s': rate,
                   'setup_s': head['setup_s']}
        result['metrics'] = {m['name']: {'value': metrics[m['name']],
                                         'unit': m['unit']}
                             for m in cell.end_to_end}
    if device.type == 'cuda':
        result['device'] = {'platform': 'gpu',
                            'kind': torch.cuda.get_device_name(0),
                            'count': world, 'memory_peak_bytes': peak}
        if trace:
            result['device'].update(busy_s=t.busy_s, window_s=t.window_s)
    return result, checks
