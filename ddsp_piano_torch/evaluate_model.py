"""Evaluate a trained model on the MAESTRO test set.

    python -m ddsp_piano_torch.evaluate_model [-c maestro_v2] [--ckpt PATH]
        [-wu S] [-w] [--duration S] [-b N] [--n_devices N]
        [--device cuda|cpu] maestro_dir out_dir

Counterpart of the JAX package's evaluate_model.py. The test split is cut
into --duration segments; each segment's multi-scale spectral loss after a
forward of the model goes to ``spectral_losses.csv`` (rewritten every 32
batches) and ``spectral.csv`` (at the end), with the columns filename,
piano_model and loss_val, in segment order. Segments are packed into
batches of --batch_size; the last batch is padded by repeating its last
segment and the pad rows are dropped. Each segment draws its noise from
its global segment index, so the CSV does not depend on the batch size.
--get_wav writes each segment's audio as ``wav/<track>_<index:04d>.wav``.
--ckpt takes what the synthesize CLI takes (the port's ckpt.pt or a TF
checkpoint). The sweep runs on ``cuda`` unless --device cpu is given.
Each batch is split over the largest number of cards up to --n_devices
(default: every visible card; on the CPU, gloo ranks, default 1) that
divides --batch_size, one rank a card (parallel/mesh.py): each rank draws
its rows' noise from their global segment indices, the losses (and the
audio, with --get_wav) are gathered in order, and rank 0 writes the CSVs
and the WAVs, the same as one rank's.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import time

import numpy as np
import torch

log = logging.getLogger(__name__)
osjoin = os.path.join

CSV_COLUMNS = ('filename', 'piano_model', 'loss_val')
CSV_EVERY = 32


def process_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--config', '-c', type=str, default='maestro_v2',
                        help="Model config name or .gin file path. "
                             "(default: %(default)s)")
    parser.add_argument('--ckpt', type=str, default=None,
                        help="Checkpoint to load: the port's ckpt.pt (file "
                             "or directory) or a TF checkpoint.")
    parser.add_argument('--warm_up', '-wu', type=float, default=0.5,
                        help="Warm-up duration (in s, default: %(default)s;"
                             " taken for the reference's argument list, as "
                             "the JAX CLI takes it: segments are not "
                             "cropped)")
    parser.add_argument('--get_wav', '-w', action='store_true',
                        help="Write each segment's audio as a wav file.")
    parser.add_argument('--duration', type=float, default=10.0,
                        help="Segment duration (default: %(default)s)")
    parser.add_argument('--batch_size', '-b', type=int, default=4,
                        help="Segments per forward (default: %(default)s)")
    parser.add_argument('--n_devices', type=int, default=None,
                        help="Cards to split each batch over, one rank "
                             "each (default: all visible; on the CPU, gloo "
                             "ranks, default 1).")
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help="Device to evaluate on (default: %(default)s)")
    parser.add_argument('maestro_dir', type=str,
                        help="Path to the MAESTRO dataset.")
    parser.add_argument('out_dir', type=str,
                        help="Folder for evaluation outputs.")
    return parser.parse_args(argv)


def batched_segments(dataset, batch_size):
    """Group batch-1 segment dicts into batches of ``batch_size``.

    Yields (batch dict without 'filename', the segments' metadata rows,
    n_valid). The last group is padded by repeating its final segment, so
    every batch has one shape; callers drop the pad rows.
    """
    group = []
    for seg in dataset:
        group.append(seg)
        if len(group) == batch_size:
            yield _concat_group(group, batch_size)
            group = []
    if group:
        yield _concat_group(group, batch_size)


def _concat_group(group, batch_size):
    n_valid = len(group)
    padded = group + [group[-1]] * (batch_size - n_valid)
    batch = {k: np.concatenate([g[k] for g in padded])
             for k in padded[0] if k != 'filename'}
    metas = [{'filename': str(g['filename'][0][0]),
              'piano_model': int(g['piano_model'][0][0])} for g in group]
    return batch, metas, n_valid


def write_csv(path, rows):
    with open(path, 'w', newline='') as f:
        writer = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
        writer.writeheader()
        writer.writerows(rows)


def main(args) -> dict:
    """Run the sweep. Returns the CSV rows (dicts), the number of batches
    and the sweep's wall seconds (data loading included): every rank's
    (the same rows); when it starts the ranks itself, local rank 0's, with
    every rank's under 'ranks'."""
    from ddsp_piano_torch.device import resolve_device
    from ddsp_piano_torch.parallel import mesh

    device = resolve_device(args.device)
    result = mesh.run(evaluate, (args,), args.batch_size, args.n_devices,
                      device)
    if isinstance(result, list):
        return dict(result[0], ranks=result)
    return result


def _gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x``, in rank order (x itself with one
    rank)."""
    import torch.distributed as dist

    from ddsp_piano_torch.parallel import mesh

    if mesh.world_size() == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def evaluate(args) -> dict:
    """The sweep of one process: the only one, or one rank."""
    from ddsp_piano_torch import configs
    from ddsp_piano_torch.data import audio_io, pipeline
    from ddsp_piano_torch.device import resolve_device
    from ddsp_piano_torch.parallel import mesh
    from ddsp_piano_torch.training.checkpoints import restore_params
    from ddsp_piano_torch.training.evaluation import (FEATURES,
                                                      build_segment_eval_fn)

    device = mesh.local_device(resolve_device(args.device))
    is_lead = mesh.rank() == 0
    rows_of_rank = mesh.local_batch_slice(args.batch_size)
    model = configs.get_model(args.config, inference=True,
                              duration=args.duration, device=device)
    restore_params(model, args.ckpt)
    eval_step = build_segment_eval_fn(model)
    test_dataset = pipeline.get_test_dataset(
        args.maestro_dir, duration=args.duration, batch_size=1,
        sample_rate=model.sample_rate, max_polyphony=model.n_synths)

    if is_lead:
        os.makedirs(args.out_dir, exist_ok=True)
        if args.get_wav:
            os.makedirs(osjoin(args.out_dir, 'wav'), exist_ok=True)

    # The losses stay on the device until a CSV is written: waiting for
    # each batch's would hold the host back behind the card.
    evaluations = []

    def to_rows():
        rows = []
        for losses, metas in evaluations:
            values = losses.cpu().tolist()
            rows += [dict(meta, loss_val=values[j])
                     for j, meta in enumerate(metas)]
        return rows

    n_segments = n_batches = 0
    start = time.perf_counter()
    for i, (batch, metas, n_valid) in enumerate(
            batched_segments(test_dataset, args.batch_size)):
        # Pad rows take the last valid segment's index (they are dropped).
        # A rank evaluates its rows, with their global segment indices.
        seg_indices = [n_segments + min(j, n_valid - 1)
                       for j in range(args.batch_size)][rows_of_rank]
        tensors = {k: torch.from_numpy(batch[k][rows_of_rank]).to(device)
                   for k in FEATURES + ('audio',)}
        losses, audio = eval_step(tensors, seg_indices)
        losses = _gather(losses)
        evaluations.append((losses[:n_valid], metas))
        n_segments += n_valid
        n_batches += 1
        if i % CSV_EVERY == 0 and is_lead:
            write_csv(osjoin(args.out_dir, 'spectral_losses.csv'), to_rows())
            log.info("segment %d: loss %.4f", n_segments, float(losses[0]))
        if args.get_wav:
            audio = _gather(audio)
            if not is_lead:
                continue
            audio = audio.cpu().numpy()
            for j, meta in enumerate(metas):
                # Every segment of a track shares its filename; the global
                # segment index tells them apart.
                base = meta['filename'].split('/')[-1]
                name = f"{base}_{n_segments - n_valid + j:04d}.wav"
                audio_io.write_wav(osjoin(args.out_dir, 'wav', name),
                                   audio[j], model.sample_rate)
    rows = to_rows()
    seconds = time.perf_counter() - start
    if not is_lead:
        return {'rows': rows, 'batches': n_batches, 'seconds': seconds}
    write_csv(osjoin(args.out_dir, 'spectral.csv'), rows)
    if rows:
        log.info("Evaluated %d segments; mean spectral loss %.4f",
                 len(rows), float(np.mean([r['loss_val'] for r in rows])))
    return {'rows': rows, 'batches': n_batches, 'seconds': seconds}


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    main(process_args())
