"""Train the PyTorch DDSP-Piano model for one training phase.

    python -m ddsp_piano_torch.train_single_phase [-b 6] [-s STEPS]
        [-e EPOCHS] [--lr LR] [-c maestro_v2] [-p PHASE] [-r CKPT]
        [--auto_resume] [--val_path PATH] [--seed N] [--device cuda|cpu]
        maestro_path exp_dir

The flags mean what they mean for the JAX package's train_single_phase.py:
epochs x steps of Adam on the multi-scale spectral loss, odd phases
training the networks and even phases the frequency modules, with the NaN
guard and the last / best / crashed / stopped checkpoints under
``<exp_dir>/phase_<N>/``, in the port's own format (``ckpt.pt``). The
steps run on ``cuda`` unless --device cpu is given; --seed seeds the
initial weights and the per-step noise draws. Losses go to the log.

Options whose machinery is not ported are refused unless left at their
default: -k/--steps_per_dispatch, --staging, --profile, --debug_nans,
--n_devices and the multi-host flags.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

log = logging.getLogger(__name__)
osjoin = os.path.join

# Flags of the JAX CLI that the port takes only at their default.
UNPORTED_DEFAULTS = {
    'steps_per_dispatch': 1, 'staging': 'packed', 'profile': 0,
    'debug_nans': False, 'n_devices': None, 'coordinator_address': None,
    'num_processes': None, 'process_id': None,
}


def process_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--batch_size', '-b', type=int, default=6,
                        help="Number of elements per batch. "
                             "(default: %(default)s)")
    parser.add_argument('--steps_per_epoch', '-s', type=int, default=5000,
                        help="Number of steps of gradient descent per epoch. "
                             "(default: %(default)s)")
    parser.add_argument('--epochs', '-e', type=int, default=128,
                        help="Number of epochs. (default: %(default)s)")
    parser.add_argument('--lr', type=float, default=0.001,
                        help="Learning rate. (default: %(default)s)")
    parser.add_argument('--config', '-c', default='maestro_v2',
                        help="Model config name.")
    parser.add_argument('--phase', '-p', type=int, default=1,
                        help="Training phase strategy to apply. Even phases "
                             "fine-tune only the frequency sub-modules. "
                             "(default: %(default)s)")
    parser.add_argument('--restore', '-r', type=str, default=None,
                        help="Restore training state from a checkpoint "
                             "folder written by this trainer.")
    parser.add_argument('--auto_resume', action='store_true',
                        help="Resume from <exp_dir>/phase_<N>/last_iter if "
                             "a checkpoint exists there; takes precedence "
                             "over --restore once the phase has its own "
                             "checkpoint.")
    parser.add_argument('--val_path', type=str, default=None,
                        help="Path to the validation data (if different "
                             "from maestro_path).")
    parser.add_argument('--seed', type=int, default=0,
                        help="Seed of the initial weights and of the noise "
                             "draws. (default: %(default)s)")
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help="Device to train on (default: %(default)s)")
    parser.add_argument('--steps_per_dispatch', '-k', type=int, default=1,
                        help="Not ported: must stay 1.")
    parser.add_argument('--staging', choices=('packed', 'packed32', 'dict'),
                        default='packed',
                        help="Not ported (batches go to the card as one "
                             "pinned buffer): must stay 'packed'.")
    parser.add_argument('--profile', type=int, default=0,
                        help="Not ported: must stay 0.")
    parser.add_argument('--debug_nans', action='store_true',
                        help="Not ported (the loss guard is always on).")
    parser.add_argument('--n_devices', type=int, default=None,
                        help="Not ported: one device.")
    parser.add_argument('--coordinator_address', type=str, default=None,
                        help="Not ported: one host.")
    parser.add_argument('--num_processes', type=int, default=None,
                        help="Not ported: one host.")
    parser.add_argument('--process_id', type=int, default=None,
                        help="Not ported: one host.")
    parser.add_argument('maestro_path', type=str,
                        help="Path to the MAESTRO dataset folder (or "
                             "preprocessed cache dir).")
    parser.add_argument('exp_dir', type=str,
                        help="Folder to store experiment results and logs.")
    return parser.parse_args(argv)


def _refuse_unported(args):
    for name, default in UNPORTED_DEFAULTS.items():
        if getattr(args, name) != default:
            raise SystemExit(f"--{name} is not ported to ddsp_piano_torch "
                             f"yet; leave it at its default ({default!r}).")


def main(args, record_timeline: bool = False) -> dict:
    """Train. Returns the trainer, the total loss of every step (floats)
    and the last validation losses."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.data import pipeline
    from ddsp_piano_torch.device import resolve_device
    from ddsp_piano_torch.training.checkpoints import (latest_checkpoint,
                                                       read_meta)
    from ddsp_piano_torch.training.trainer import NanLossError, Trainer

    _refuse_unported(args)
    device = resolve_device(args.device)
    first_phase = (args.phase % 2) == 1
    model = get_model(args.config, device=device, seed=args.seed,
                      first_phase=first_phase)
    trainer = Trainer(model, learning_rate=args.lr, first_phase=first_phase,
                      seed=args.seed, record_timeline=record_timeline)

    val_path = args.maestro_path if args.val_path is None else args.val_path
    dataset_kwargs = dict(batch_size=args.batch_size,
                          max_polyphony=model.n_synths,
                          sample_rate=model.sample_rate)
    host_iterator = pipeline.Prefetcher(pipeline.get_training_dataset(
        args.maestro_path, seed=0, **dataset_kwargs))
    train_iterator = trainer.device_prefetch(host_iterator)

    exp_dir = osjoin(args.exp_dir, f'phase_{args.phase}')
    restore_from = args.restore
    resumed_this_phase = False
    if args.auto_resume and latest_checkpoint(osjoin(exp_dir, 'last_iter')):
        restore_from = osjoin(exp_dir, 'last_iter')
        resumed_this_phase = True
    if restore_from is not None:
        trainer.restore(restore_from)
        log.info("Restored model from %s at step %d", restore_from,
                 trainer.step)

    phase_start_step = trainer.step
    lowest_val_loss = float('inf')
    start_epoch = 0
    result = {'trainer': trainer, 'step_losses': [], 'val_losses': None}
    if resumed_this_phase:
        meta = read_meta(restore_from)
        phase_start_step = int(meta.get('phase_start_step',
                                        phase_start_step))
        lowest_val_loss = float(meta.get('lowest_val_loss', lowest_val_loss))
        start_epoch = max(
            0, (trainer.step - phase_start_step) // args.steps_per_epoch)
        if start_epoch >= args.epochs:
            log.info("Phase %d already completed %d/%d epochs (step %d); "
                     "nothing to do.", args.phase, start_epoch, args.epochs,
                     trainer.step)
            host_iterator.close()
            return result
    phase_meta = lambda: {'phase_start_step': int(phase_start_step),
                          'lowest_val_loss': float(lowest_val_loss)}
    for sub in ('logs', 'last_iter', 'best_iter'):
        os.makedirs(osjoin(exp_dir, sub), exist_ok=True)

    loss_keys = model.loss_keys()
    try:
        for epoch in range(start_epoch, args.epochs):
            epoch_losses = []
            for _ in range(args.steps_per_epoch):
                epoch_losses.append(trainer.train_step(next(train_iterator)))
            # One wait per epoch for the losses of all its steps.
            totals = torch.stack([
                torch.stack([losses[k] for k in loss_keys])
                for losses in epoch_losses]).cpu()
            result['step_losses'] += totals[:, -1].tolist()
            means = dict(zip(loss_keys, totals.mean(dim=0).tolist()))
            log.info("Epoch %d training loss: %.4f (%s)", epoch,
                     means['total_loss'], means)
            trainer.save(osjoin(exp_dir, 'last_iter'), meta=phase_meta())
            log.info("Last iteration model saved at %s",
                     osjoin(exp_dir, 'last_iter'))

            val_dataset = pipeline.get_validation_dataset(val_path,
                                                          **dataset_kwargs)
            if trainer.step < 3 * args.steps_per_epoch:
                # Early on, one validation batch only (its audio is the
                # JAX trainer's summary).
                val_batch = next(iter(val_dataset), None)
                if val_batch is not None:
                    result['val_losses'], _ = trainer.validation_step(
                        val_batch)
                    log.info("Validation loss (one batch): %.4f",
                             result['val_losses']['total_loss'])
                continue

            epoch_val = {k: 0.0 for k in loss_keys}
            val_steps = 0
            for val_batch in val_dataset:
                val_losses, _ = trainer.validation_step(val_batch)
                for k in loss_keys:
                    epoch_val[k] += val_losses[k]
                val_steps += 1
            if val_steps == 0:
                continue
            result['val_losses'] = {k: v / val_steps
                                    for k, v in epoch_val.items()}
            log.info("Validation loss: %.4f",
                     result['val_losses']['total_loss'])
            if epoch_val['audio_stft_loss'] < lowest_val_loss:
                lowest_val_loss = epoch_val['audio_stft_loss']
                trainer.save(osjoin(exp_dir, 'best_iter'),
                             meta=phase_meta())
    except NanLossError as e:
        trainer.save(osjoin(exp_dir, 'crashed_iter'), state=e.state)
        log.error("%s", e)
        result['nan'] = str(e)
    except KeyboardInterrupt:
        try:
            trainer.save(osjoin(exp_dir, 'stopped_iter'))
        except NanLossError as e:
            trainer.save(osjoin(exp_dir, 'crashed_iter'), state=e.state)
            log.error("%s", e)
    finally:
        host_iterator.close()
    return result


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    main(process_args())
