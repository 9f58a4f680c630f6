"""Evaluate a trained model on the MAESTRO test set.

    python -m ddsp_piano_torch.evaluate_model [-c maestro_v2] [--ckpt PATH]
        [-wu S] [-w] [--duration S] [-b N] [--device cuda|cpu]
        maestro_dir out_dir

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
--n_devices is refused unless left at its default: the port runs on one
device.
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
                        help="Not ported: the port evaluates on one device.")
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
    and the sweep's wall seconds (data loading included)."""
    from ddsp_piano_torch import configs
    from ddsp_piano_torch.data import audio_io, pipeline
    from ddsp_piano_torch.device import resolve_device
    from ddsp_piano_torch.training.checkpoints import restore_params
    from ddsp_piano_torch.training.evaluation import (FEATURES,
                                                      build_segment_eval_fn)

    if args.n_devices is not None:
        raise SystemExit("--n_devices is not ported to ddsp_piano_torch yet; "
                         "leave it at its default (one device).")
    device = resolve_device(args.device)
    model = configs.get_model(args.config, inference=True,
                              duration=args.duration, device=device)
    restore_params(model, args.ckpt)
    eval_step = build_segment_eval_fn(model)
    test_dataset = pipeline.get_test_dataset(
        args.maestro_dir, duration=args.duration, batch_size=1,
        sample_rate=model.sample_rate, max_polyphony=model.n_synths)

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
        seg_indices = [n_segments + min(j, n_valid - 1)
                       for j in range(args.batch_size)]
        tensors = {k: torch.from_numpy(batch[k]).to(device)
                   for k in FEATURES + ('audio',)}
        losses, audio = eval_step(tensors, seg_indices)
        evaluations.append((losses[:n_valid], metas))
        n_segments += n_valid
        n_batches += 1
        if i % CSV_EVERY == 0:
            write_csv(osjoin(args.out_dir, 'spectral_losses.csv'), to_rows())
            log.info("segment %d: loss %.4f", n_segments, float(losses[0]))
        if args.get_wav:
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
    write_csv(osjoin(args.out_dir, 'spectral.csv'), rows)
    if rows:
        log.info("Evaluated %d segments; mean spectral loss %.4f",
                 len(rows), float(np.mean([r['loss_val'] for r in rows])))
    return {'rows': rows, 'batches': n_batches, 'seconds': seconds}


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    main(process_args())
