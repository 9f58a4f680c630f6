"""The readings that the limits of ``correct`` are set from, on the cards:
for each seed, the numbers a sound run of the cell compares, and the same
numbers of the control (the reference put in the program's place and
computed with TF32 matmuls, the nearest precision below the
configurations' float32 with TF32 off).

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--control-seeds 4 5 6] [--look-seeds 2] [--seconds 2]

Every run of one call shares the process, so the kernels load once. The
program's runs are the cell's own (loops/<loop>.py) with a short
window; the control's compare at the cell's own sizes. For a training
cell, each of --look-seeds (among --seeds) also takes the reference's
checked steps on the host's CPU, and sets the program's gaps beside the
reference's own between the card and the CPU.
One JSON line a reading. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import generator, harness, program  # noqa: E402
from portbench.loops import serve, train  # noqa: E402
from portbench.reference import piano as reference  # noqa: E402


def serve_control(cell: harness.Cell, seed: int, device) -> dict:
    """The served audio's gap when the reference in TF32 takes the
    program's place, on the request the cell's run would check."""
    mix, config = cell.mix, cell.config
    duration = float(mix['seconds_per_row'])
    pool = generator.batches(mix, int(mix['pool_requests']),
                             config['build']['frame_rate'], seed)
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 0x636865636B])
    p = sorted(rng.choice(len(pool), int(mix['check_requests']),
                          replace=False).tolist())[0]
    ref = reference.build(config, True, duration, seed, device)
    b = int(mix['batch'])
    n_samples = int(round(duration * config['build']['sample_rate']))
    noise = 2.0 * torch.rand(
        (ref.n_synths * b, n_samples),
        generator=torch.Generator(device=device).manual_seed(
            program.torch_seed(seed, 'noise')), device=device) - 1.0
    cond = reference.conditioning(pool[p]['roll'], ref.n_synths)
    out = {}
    for tf32 in (False, True):
        with reference.matmul_precision(tf32):
            out[tf32] = reference.render(ref, cond, pool[p]['pedal'],
                                         pool[p]['piano_model'], noise)
        out[tf32] = out[tf32].double().cpu().numpy()
    return {'audio_gap': serve._gap(out[True], out[False])}


def train_control(cell: harness.Cell, seed: int, device) -> dict:
    """The checked steps' numbers when the reference takes the program's
    place: in TF32 (the control), and in float32 with each of the faults
    a training cell can have planted in it: half of each batch left out
    (the loss the mean over the rest), the update applied with the wrong
    sign (gradient ascent), a learning rate 1.4 times the mix's and, with
    several ranks, the exchange left out (rank 0's gradient alone). A
    state left unchanged reads 1 by the two change measures and needs no
    run."""
    mix, config = cell.mix, cell.config
    duration = float(mix['seconds_per_row'])
    pool = train.host_batches(cell, seed, device)[:train.CHECKED_STEPS]
    ref = reference.build(config, False, duration, seed, device)
    noises = train.noise_pool(cell, seed, ref.n_synths,
                              device)[:train.CHECKED_STEPS]
    start = {k: v.clone() for k, v in ref.state_dict().items()}
    world = int(mix.get('ranks', 1))
    n = ref.n_synths

    def steps(tf32, rows=None, blocks=world, lr_scale=1.0):
        ref.load_state_dict(start)
        batches, draws = pool, noises
        if rows is not None:
            batches = [{k: v[:rows] for k, v in b.items()} for b in pool]
            draws = [d.reshape(n, -1, d.shape[-1])[:, :rows].reshape(
                n * rows, -1) for d in noises]
        with reference.matmul_precision(tf32):
            return reference.train_steps(
                ref, batches, draws, lr_scale * float(mix['learning_rate']),
                float(mix['grad_clip_norm']), blocks=blocks)

    def as_program(run, want):
        return dict(train.step_checks(run['losses'], run['change_norms'],
                                      run['first_step'], want),
                    gradient_gap=train.gradient_gap(run['grad_norms'], want))

    want = steps(False)
    b = int(mix['batch'])
    out = {'control': as_program(steps(True), want),
           'half_batch': as_program(steps(False, rows=b // 2, blocks=1),
                                    want),
           'ascent': as_program(steps(False, lr_scale=-1.0), want),
           'lr_x1.4': as_program(steps(False, lr_scale=1.4), want)}
    if world > 1:
        out['no_exchange'] = as_program(
            steps(False, rows=b // world, blocks=1), want)
    return out


def sign_flips(got, want) -> float:
    """The share of the elements that the reference moved whose change
    has the other sign on the other side."""
    moved = flipped = 0
    for a, b in zip(got, want):
        mask = b != 0
        moved += int(mask.sum())
        flipped += int((torch.sign(a[mask]) != torch.sign(b[mask])).sum())
    return flipped / max(moved, 1)


def train_look(cell: harness.Cell, seed: int, got: dict, device) -> dict:
    """The reference's checked steps on the host's CPU beside its steps on
    the card (``got['want']``), and the program's (``got``) against the
    card's: each step's loss, the first gradient's worst leaf, the change's
    median and worst leaf, the step's gap and the share of moved elements
    whose change has the other sign."""
    mix, config = cell.mix, cell.config
    card = got['want']
    pool = train.host_batches(cell, seed, device)[:train.CHECKED_STEPS]
    ref = reference.build(config, False, float(mix['seconds_per_row']),
                          seed, 'cpu')
    noises = [n.cpu() for n in train.noise_pool(
        cell, seed, ref.n_synths, device)[:train.CHECKED_STEPS]]
    cpu = reference.train_steps(ref, pool, noises,
                                float(mix['learning_rate']),
                                float(mix['grad_clip_norm']),
                                blocks=int(mix.get('ranks', 1)))
    keep = train.kept_leaves(card)

    def gaps(side, losses, first_step, change):
        change_norms = reference.leaf_norms(change)
        update = train.leaf_gaps(change_norms, card['change_norms'])[keep]
        return {
            f'{side}_loss_gaps': [abs(a - b) / abs(b) for a, b in
                                  zip(losses, card['losses'])],
            f'{side}_step_gap': train.first_step_gap(first_step, card),
            f'{side}_update_median_gap': float(np.median(update)),
            f'{side}_update_worst_gap': float(update.max()),
            f'{side}_sign_flips': sign_flips(change, card['change'])}

    grad = train.leaf_gaps(cpu['grad_norms'], card['grad_norms'])
    saturated = sum(int((g.abs() >= train.SATURATED).sum())
                    for g in card['first_grad'])
    return dict(
        gaps('program', got['losses'], got['first_step'], got['change']),
        **gaps('cpu', cpu['losses'], cpu['first_step'], cpu['change']),
        cpu_grad_worst_gap=float(grad.max()),
        cpu_grad_worst_leaf=card['names'][int(grad.argmax())],
        saturated_share=saturated / sum(g.numel()
                                        for g in card['first_grad']))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='*', default=[])
    parser.add_argument('--control-seeds', type=int, nargs='*', default=[])
    parser.add_argument('--look-seeds', type=int, nargs='*', default=[])
    parser.add_argument('--seconds', type=float, default=2.0)
    args = parser.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = torch.device('cuda')
    loop = serve if cell.mix['loop'] == 'serve' else train
    for seed in args.seeds:
        tick = time.perf_counter()
        kept = {} if loop is train else None
        result, checks = loop.run(cell, seed, args.seconds, False,
                                    harness.Clock(), device,
                                    **({} if kept is None else {'keep': kept}))
        readings = {k: v for k, (v, _) in checks.items()}
        print(json.dumps({'cell': cell.name, 'seed': seed, 'side': 'program',
                          'correct': result['correct'],
                          'checks': readings,
                          'seconds': time.perf_counter() - tick}),
              flush=True)
        program.release(device)
        if kept and seed in args.look_seeds:
            tick = time.perf_counter()
            look = train_look(cell, seed, kept, device)
            print(json.dumps({'cell': cell.name, 'seed': seed,
                              'side': 'look', 'checks': look,
                              'seconds': time.perf_counter() - tick}),
                  flush=True)
        kept = None
        program.release(device)
    control = serve_control if cell.mix['loop'] == 'serve' \
        else train_control
    for seed in args.control_seeds:
        tick = time.perf_counter()
        checks = control(cell, seed, device)
        print(json.dumps({'cell': cell.name, 'seed': seed, 'side': 'control',
                          'checks': checks,
                          'seconds': time.perf_counter() - tick}),
              flush=True)
        program.release(device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
