"""The full DDSP-Piano training recipe: three phases of train_single_phase.

    python -m ddsp_piano_torch.train_ddsp_piano [-s 15904] [-e EPOCHS]
        [--seed N] [--device cuda|cpu] maestro_path exp_dir [config]

Counterpart of the root train_ddsp_piano.sh, run in this process:

- phase 1: the networks and the reverb (7 epochs, lr 1e-3, batch 6);
- phase 2: the frequency modules only (3 epochs, lr 1e-5, batch 3),
  restored from phase 1's last_iter;
- phase 3: phase 1's modules again (10 epochs, lr 1e-3, batch 6),
  restored from phase 2's last_iter.

Every phase runs with --auto_resume, so that running the recipe again
resumes the interrupted phase from its own last_iter and skips the phases
that are done. ``-s`` is each epoch's steps (15904 by default);
``-e`` replaces every phase's epochs (for a short run); the config (a
registered name or a ``.gin`` file's path) is maestro_v2 unless named.
"""

from __future__ import annotations

import argparse
import logging
import os

# (phase, batch size, epochs, learning rate) of train_ddsp_piano.sh.
PHASES = ((1, 6, 7, 1e-3), (2, 3, 3, 1e-5), (3, 6, 10, 1e-3))


def process_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--steps_per_epoch', '-s', type=int, default=15904,
                        help="Steps per epoch in every phase. "
                             "(default: %(default)s)")
    parser.add_argument('--epochs', '-e', type=int, default=None,
                        help="Epochs of every phase, in place of the "
                             "recipe's 7, 3 and 10.")
    parser.add_argument('--seed', type=int, default=0,
                        help="Seed of the initial weights and of the noise "
                             "draws. (default: %(default)s)")
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help="Device to train on (default: %(default)s)")
    parser.add_argument('maestro_path', type=str,
                        help="Path to the MAESTRO dataset folder (or "
                             "preprocessed cache dir).")
    parser.add_argument('exp_dir', type=str,
                        help="Folder to store the three phases' results.")
    parser.add_argument('config', nargs='?', default='maestro_v2',
                        help="Model config name or .gin file path. "
                             "(default: %(default)s)")
    return parser.parse_args(argv)


def phase_argv(args, phase: int, batch_size: int, epochs: int,
               lr: float) -> list:
    """train_single_phase's arguments for one phase of the recipe."""
    argv = ['--config', args.config, '--phase', str(phase),
            '--batch_size', str(batch_size),
            '--epochs', str(epochs if args.epochs is None else args.epochs),
            '--lr', str(lr), '--steps_per_epoch', str(args.steps_per_epoch),
            '--seed', str(args.seed), '--device', args.device]
    if phase > 1:
        argv += ['--restore',
                 os.path.join(args.exp_dir, f'phase_{phase - 1}',
                              'last_iter')]
    return argv + ['--auto_resume', args.maestro_path, args.exp_dir]


def main(args) -> list:
    """Run the three phases; returns train_single_phase.main's result of
    each."""
    from ddsp_piano_torch import train_single_phase

    results = []
    for phase, batch_size, epochs, lr in PHASES:
        argv = phase_argv(args, phase, batch_size, epochs, lr)
        logging.getLogger(__name__).info(
            "Phase %d: train_single_phase %s", phase, ' '.join(argv))
        results.append(train_single_phase.main(
            train_single_phase.process_args(argv)))
    return results


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    main(process_args())
