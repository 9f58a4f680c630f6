"""Train the PyTorch DDSP-Piano model for one training phase.

    python -m ddsp_piano_torch.train_single_phase [-b 6] [-s STEPS]
        [-k K] [--staging packed|packed32|dict] [-e EPOCHS] [--lr LR]
        [-c maestro_v2] [-p PHASE] [-r CKPT] [--auto_resume]
        [--val_path PATH] [--profile N] [--debug_nans] [--seed N]
        [--device cuda|cpu] [--n_devices N] [--coordinator_address ADDR
        --num_processes N --process_id I] maestro_path exp_dir

The flags mean what they mean for the JAX package's train_single_phase.py:
epochs x steps of Adam on the multi-scale spectral loss, odd phases
training the networks and even phases the frequency modules, with the NaN
guard and the last / best / crashed / stopped checkpoints under
``<exp_dir>/phase_<N>/``, in the port's own format (``ckpt.pt``). The
steps run on ``cuda`` unless --device cpu is given; --seed seeds the
initial weights and the per-step noise draws. -c takes a config name or
a ``.gin`` file's path. Losses go to the log, and TensorBoard summaries
to ``<exp_dir>/phase_<N>/logs/`` (``tensorboard --logdir`` there), with
the JAX CLI's tags at its steps: ``train_loss/<key>`` each epoch, then
the ``synthesized_audio`` of one validation batch while the step is
below 3 epochs, and after that ``val_loss/<key>``, ``synthesized_audio``,
``spectrogram`` and ``tuning/<name>``.

-k runs K steps on one staged block (Trainer.train_steps; the NaN guard's
crashed_iter then comes from before the block). --staging chooses how a
batch goes to the card: 'packed' (one pinned copy of 16-bit wire lanes,
decoded on the card bit-exactly), 'packed32' (the same with exact 32-bit
lanes) or 'dict' (one copy a key); all three give the same numbers.
--profile N writes a Chrome trace of N steps (after one untraced step)
into <exp_dir>/phase_<N>/profile/trace.json. --debug_nans traps a
non-finite value in the module (or backward function) that makes it.

Data parallelism (parallel/mesh.py): --batch_size is the global batch,
and the run takes the largest number of cards up to --n_devices (default:
every visible card) that divides it, one rank (process) a card; a step
over R ranks is the step of one card on the global batch. With one card
(or --device cpu and no --n_devices) the run is a single process, as
always. On the CPU --n_devices is the number of gloo ranks. Over several
hosts, each host runs this CLI with --coordinator_address (host:port of
process 0, or $MASTER_ADDR:$MASTER_PORT), --num_processes and
--process_id; every card of every host takes part. Each host reads
batch_size / num_processes rows a step from its own stream (seeded with
its index), each rank keeps its rows, and every rank reads the same
validation batches and keeps its rows. Rank 0 alone writes summaries and
checkpoints and, with --profile, the trace.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

log = logging.getLogger(__name__)
osjoin = os.path.join

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
                        help="Model config name or .gin file path.")
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
                        help="Optimization steps per staged block: K > 1 "
                             "stages K batches as one copy and runs them "
                             "with Trainer.train_steps (the same numbers "
                             "as K single steps; the NaN guard's "
                             "crashed_iter coarsens to K steps). "
                             "steps_per_epoch should be divisible by K. "
                             "(default: %(default)s)")
    parser.add_argument('--staging', choices=('packed', 'packed32', 'dict'),
                        default='packed',
                        help="How batches go to the card: 'packed' "
                             "(default) as one pinned copy of 16-bit wire "
                             "lanes, each key in the narrowest encoding "
                             "that round-trips it bit for bit, decoded on "
                             "the card; 'packed32' with exact 32-bit lanes "
                             "for every key; 'dict' one copy a key. All "
                             "three give the same numbers.")
    parser.add_argument('--profile', type=int, default=0, metavar='N',
                        help="Write a torch.profiler Chrome trace of N "
                             "training steps into <exp_dir>/phase_<N>/"
                             "profile/trace.json, then train normally.")
    parser.add_argument('--debug_nans', action='store_true',
                        help="Trap a non-finite value in the module or "
                             "backward function that makes it (slower; "
                             "the per-step loss guard is always on).")
    parser.add_argument('--n_devices', type=int, default=None,
                        help="Cards of the data-parallel run, one rank "
                             "each; the largest count up to this that "
                             "divides the batch (default: all visible "
                             "cards; on the CPU, gloo ranks, default 1).")
    parser.add_argument('--coordinator_address', type=str, default=None,
                        help="host:port of process 0 for a multi-host run "
                             "(or a file:// path every host sees). Also "
                             "read from $MASTER_ADDR and $MASTER_PORT. "
                             "--batch_size is the GLOBAL batch; each host "
                             "loads batch_size/num_processes elements.")
    parser.add_argument('--num_processes', type=int, default=None,
                        help="Total number of hosts in the multi-host "
                             "run.")
    parser.add_argument('--process_id', type=int, default=None,
                        help="This host's index in [0, num_processes).")
    parser.add_argument('maestro_path', type=str,
                        help="Path to the MAESTRO dataset folder (or "
                             "preprocessed cache dir).")
    parser.add_argument('exp_dir', type=str,
                        help="Folder to store experiment results and logs.")
    return parser.parse_args(argv)


def main(args, record_timeline: bool = False) -> dict:
    """Train. Returns the trainer, the total loss of every step (floats),
    the last validation losses, the summaries' event file and the
    milliseconds the summaries took each epoch, the epochs' mean training
    losses and, with --profile, the trace's path. Called in a rank of a
    process group, it trains as that rank. When it starts the host's ranks
    itself, it returns local rank 0's result in the form of
    :func:`portable_result`, with every local rank's under 'ranks'."""
    from ddsp_piano_torch.device import resolve_device
    from ddsp_piano_torch.parallel import mesh

    k_steps = max(1, args.steps_per_dispatch)
    if k_steps > args.steps_per_epoch:
        raise SystemExit(f"--steps_per_dispatch {k_steps} exceeds "
                         f"--steps_per_epoch {args.steps_per_epoch}")
    device = resolve_device(args.device)
    result = mesh.run(train, (args, record_timeline), args.batch_size,
                      args.n_devices, device, args.coordinator_address,
                      args.num_processes, args.process_id,
                      portable=portable_result)
    if isinstance(result, list):
        return dict(result[0], ranks=result)
    return result


def portable_result(result: dict) -> dict:
    """A rank's result as host objects: the trainer's step, parameters
    (on the host) and, with a timeline, step and reduce times and the wall
    time a step on the card (the span of steps 2 on over their count) in
    place of the trainer."""
    from ddsp_piano_torch.parallel import mesh

    out = {k: v for k, v in result.items() if k != 'trainer'}
    trainer = result['trainer']
    out.update(rank=mesh.rank(), step=trainer.step,
               reduce_bytes=trainer.reduce_bytes,
               params={n: p.detach().cpu()
                       for n, p in trainer.model.named_parameters()})
    if trainer.timeline is not None:
        out.update(step_times=trainer.step_times(),
                   reduce_times=trainer.reduce_times())
        timeline = trainer.timeline
        if len(timeline) > 1:
            out['wall_step_ms'] = timeline[1][0].elapsed_time(
                timeline[-1][3]) / (len(timeline) - 1)
    return out


def train(args, record_timeline: bool = False) -> dict:
    """The training run of one process: the only one, or one rank."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.data import pipeline
    from ddsp_piano_torch.device import resolve_device
    from ddsp_piano_torch.parallel import mesh
    from ddsp_piano_torch.training import debug, summaries
    from ddsp_piano_torch.training.checkpoints import (latest_checkpoint,
                                                       read_meta)
    from ddsp_piano_torch.training.trainer import NanLossError, Trainer

    k_steps = max(1, args.steps_per_dispatch)
    device = mesh.local_device(resolve_device(args.device))
    is_lead = mesh.rank() == 0
    first_phase = (args.phase % 2) == 1
    model = get_model(args.config, device=device, seed=args.seed,
                      first_phase=first_phase)
    nan_hooks = debug.enable_debug_nans(model) if args.debug_nans else []
    trainer = Trainer(model, learning_rate=args.lr, first_phase=first_phase,
                      seed=args.seed, record_timeline=record_timeline)

    val_path = args.maestro_path if args.val_path is None else args.val_path
    # --batch_size is the global batch. Each host reads its share from its
    # own stream and each rank keeps its rows; every rank reads the same
    # validation batches and keeps its rows.
    dataset_kwargs = dict(batch_size=args.batch_size,
                          max_polyphony=model.n_synths,
                          sample_rate=model.sample_rate)
    host_iterator = pipeline.Prefetcher(pipeline.get_training_dataset(
        args.maestro_path, **{**dataset_kwargs,
                              'batch_size': (args.batch_size
                                             // mesh.process_count()),
                              'seed': mesh.process_index()}))
    rank_batches = trainer.distribute_dataset(host_iterator)
    packed = args.staging != 'dict'
    trainer.pack_wire = args.staging != 'packed32'
    if k_steps == 1:
        train_iterator = trainer.device_prefetch(rank_batches,
                                                 packed=packed)
        step_fn = trainer.train_step
    else:
        train_iterator = trainer.block_prefetch(rank_batches, k_steps,
                                                packed=packed)
        step_fn = trainer.train_steps
        if args.steps_per_epoch % k_steps:
            log.warning(
                "steps_per_epoch=%d is not divisible by "
                "steps_per_dispatch=%d; running %d steps per epoch.",
                args.steps_per_epoch, k_steps,
                (args.steps_per_epoch // k_steps) * k_steps)

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
            debug.disable_debug_nans(nan_hooks)
            return result
    phase_meta = lambda: {'phase_start_step': int(phase_start_step),
                          'lowest_val_loss': float(lowest_val_loss)}
    # Every rank computes the same losses and summaries; rank 0 alone
    # writes them and the checkpoints. The others flush the NaN guard
    # where rank 0 saves.
    if is_lead:
        for sub in ('logs', 'last_iter', 'best_iter'):
            os.makedirs(osjoin(exp_dir, sub), exist_ok=True)
    writer = (summaries.SummaryWriter(osjoin(exp_dir, 'logs')) if is_lead
              else summaries.NullWriter())
    result.update(events=writer.path, summary_ms=[], train_means=[])

    def save(sub):
        if is_lead:
            trainer.save(osjoin(exp_dir, sub), meta=phase_meta())
        else:
            trainer.check_pending()

    loss_keys = model.loss_keys()
    try:
        if args.profile > 0:
            # The steady-state step: one untraced step (block) first, then
            # ceil(N / K) dispatches under the trace.
            n_profile = -(-args.profile // k_steps)
            step_fn(next(train_iterator))
            if is_lead:
                with debug.profile_trace(osjoin(exp_dir, 'profile'),
                                         device) as path:
                    for _ in range(n_profile):
                        step_fn(next(train_iterator))
                result['profile'] = path
                log.info("Profiler trace (%d steps) written to %s",
                         n_profile * k_steps, path)
            else:
                for _ in range(n_profile):
                    step_fn(next(train_iterator))
        for epoch in range(start_epoch, args.epochs):
            step = trainer.step    # the epoch's first step, as in JAX
            epoch_losses = []
            for _ in range(args.steps_per_epoch // k_steps):
                losses = step_fn(next(train_iterator))
                epoch_losses.append(torch.stack(
                    [losses[k].reshape(-1) for k in loss_keys], dim=-1))
            # One wait per epoch for the losses of all its steps.
            totals = torch.cat(epoch_losses).cpu()
            result['step_losses'] += totals[:, -1].tolist()
            means = dict(zip(loss_keys, totals.mean(dim=0).tolist()))
            log.info("Epoch %d training loss: %.4f (%s)", epoch,
                     means['total_loss'], means)
            result['train_means'].append(means)
            tic = time.perf_counter()
            writer.scalars('train_loss', means, step)
            summary_s = time.perf_counter() - tic
            save('last_iter')
            log.info("Last iteration model saved at %s",
                     osjoin(exp_dir, 'last_iter'))

            val_dataset = pipeline.get_validation_dataset(val_path,
                                                          **dataset_kwargs)
            if trainer.step < 3 * args.steps_per_epoch:
                # Early on, one validation batch only (its audio is the
                # JAX trainer's summary).
                val_batch = next(iter(val_dataset), None)
                if val_batch is not None:
                    result['val_losses'], audio_synth = \
                        trainer.validation_step(
                            trainer.distribute_batch(val_batch))
                    log.info("Validation loss (one batch): %.4f",
                             result['val_losses']['total_loss'])
                    tic = time.perf_counter()
                    writer.audio('synthesized_audio', audio_synth,
                                 model.sample_rate, trainer.step)
                    summary_s += time.perf_counter() - tic
                result['summary_ms'].append(1e3 * summary_s)
                continue

            epoch_val = {k: 0.0 for k in loss_keys}
            val_steps = 0
            first_val = None
            for val_batch in val_dataset:
                val_losses, audio_synth = trainer.validation_step(
                    trainer.distribute_batch(val_batch))
                for k in loss_keys:
                    epoch_val[k] += val_losses[k]
                if val_steps == 0:
                    first_val = (val_batch['audio'], audio_synth)
                val_steps += 1
            if val_steps == 0:
                result['summary_ms'].append(1e3 * summary_s)
                continue
            result['val_losses'] = {k: v / val_steps
                                    for k, v in epoch_val.items()}
            log.info("Validation loss: %.4f",
                     result['val_losses']['total_loss'])
            tic = time.perf_counter()
            writer.scalars('val_loss', result['val_losses'], step)
            writer.audio('synthesized_audio', first_val[1],
                         model.sample_rate, step)
            writer.spectrogram_summary(np.asarray(first_val[0]),
                                       first_val[1], step,
                                       sample_rate=model.sample_rate)
            writer.curves(model, step)
            summary_s += time.perf_counter() - tic
            if epoch_val['audio_stft_loss'] < lowest_val_loss:
                lowest_val_loss = epoch_val['audio_stft_loss']
                save('best_iter')
            tic = time.perf_counter()
            writer.flush()
            result['summary_ms'].append(
                1e3 * (summary_s + time.perf_counter() - tic))
    except NanLossError as e:
        if is_lead:
            trainer.save(osjoin(exp_dir, 'crashed_iter'), state=e.state)
        log.error("%s", e)
        result['nan'] = str(e)
    except KeyboardInterrupt:
        if not is_lead:
            raise
        try:
            trainer.save(osjoin(exp_dir, 'stopped_iter'))
        except NanLossError as e:
            trainer.save(osjoin(exp_dir, 'crashed_iter'), state=e.state)
            log.error("%s", e)
    finally:
        writer.close()
        host_iterator.close()
        debug.disable_debug_nans(nan_hooks)
    return result


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    main(process_args())
