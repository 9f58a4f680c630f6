"""Preprocess the MAESTRO dataset into a per-track feature cache.

    python -m ddsp_piano_torch.preprocess_maestro [-sr 24000] [-fr 250]
        [-p 16] [--splits validation train] [--num_workers 8]
        maestro_path out_dir

Each row of a split becomes a compressed ``track_<split>_<i:05d>.npz``
(audio, conditioning, pedal, polyphony, piano_model, filename) beside an
``index_<split>.json``, the layout that ``train_single_phase`` and
``evaluate_model`` read when their data path holds an index. The cache's
sample rate must be the model's (24000 for maestro_v2). Host-only numpy:
no device is used.
"""

from __future__ import annotations

import argparse
import logging
import os

log = logging.getLogger(__name__)


def process_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--sample_rate', '-sr', type=int, default=24000,
                        help="Audio sample rate (default: %(default)s)")
    parser.add_argument('--frame_rate', '-fr', type=int, default=250,
                        help="Conditioning frame rate "
                             "(default: %(default)s)")
    parser.add_argument('--polyphony', '-p', type=int, default=16,
                        help="Polyphonic capacity (default: %(default)s)")
    parser.add_argument('--splits', nargs='+',
                        default=['validation', 'train'],
                        help="Dataset splits to preprocess.")
    parser.add_argument('--num_workers', type=int, default=8)
    parser.add_argument('maestro_path', type=str,
                        help="Path to the maestro-v3.0.0 folder.")
    parser.add_argument('out_dir', type=str,
                        help="Output cache directory.")
    return parser.parse_args(argv)


def main(args) -> dict:
    """Write the cache; returns each split's index."""
    from ddsp_piano_torch.data import pipeline

    os.makedirs(args.out_dir, exist_ok=True)
    indexes = {}
    for split in args.splits:
        log.info("Preprocessing split %r ...", split)
        indexes[split] = pipeline.preprocess_into_cache(
            args.out_dir, args.maestro_path, split=split,
            sample_rate=args.sample_rate, frame_rate=args.frame_rate,
            max_polyphony=args.polyphony, num_workers=args.num_workers)
        log.info("Cached %d %s tracks into %s",
                 len(indexes[split]['tracks']), split, args.out_dir)
    return indexes


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    main(process_args())
