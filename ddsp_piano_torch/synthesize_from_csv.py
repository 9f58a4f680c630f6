"""Synthesize the MIDI performances listed in a CSV file.

    python -m ddsp_piano_torch.synthesize_from_csv
        [-c CONFIG] [--ckpt PATH] [-d S] [-wu S] [-n DBFS] [-dc]
        [--device cuda|cpu] maestro_dir csv_file out_dir

Counterpart of the JAX package's synthesize_from_csv.py, with its
arguments; --config takes a registered config name or a ``.gin`` file's
path. Each CSV row
(columns mid_file, piano_model, canonical_composer) is read from
maestro_dir, its voices allocated on the device (K9 on the card; the
host allocator's conditioning, bit for bit), rendered in one forward
(noise from a generator seeded 0, as the JAX CLI's fixed key) on
``cuda`` unless --device cpu is given, and
written as ``<piano_model><last word of composer>.wav``, the warm-up
cropped. The piano index is the row's piano_model in the sorted unique
values of the column. --decompose also writes the dry mix
(``_unreverbed``), the additive synth re-run on each voice's controls and
summed (``_additive``) and each voice's filtered noise with voice i's own
generator, seeded i, summed (``_substractive``, spelled as the JAX CLI
spells it). The CSV is read with the standard library's csv module.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

log = logging.getLogger(__name__)

REQUIRED_COLUMNS = ('mid_file', 'piano_model', 'canonical_composer')


def process_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--config', '-c', type=str, default='maestro_v2',
                        help="Model config name or .gin file path. "
                             "(default: %(default)s)")
    parser.add_argument('--ckpt', type=str, default=None,
                        help="Checkpoint to load: the port's ckpt.pt (file "
                             "or directory) or a TF checkpoint (prefix or "
                             "directory). (default: initial weights)")
    parser.add_argument('--duration', '-d', type=float, default=10.0,
                        help="Maximum duration of synthesized audio. "
                             "(default: %(default)s)")
    parser.add_argument('--warm_up', '-wu', type=float, default=0.5,
                        help="Warm-up duration (in s, default: %(default)s)")
    parser.add_argument('-n', '--normalize', type=float, default=None,
                        help="Normalize the output audio to the given "
                             "level (dBFS).")
    parser.add_argument('--decompose', '-dc', action='store_true',
                        help="Generate isolated piano elements audio.")
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help="Device to synthesize on (default: %(default)s)")
    parser.add_argument('maestro_dir', type=str,
                        help="Path to the maestro dataset directory.")
    parser.add_argument('csv_file', type=str,
                        help=".csv file listing MIDI files to synthesize.")
    parser.add_argument('out_dir', type=str,
                        help="Folder for the synthesized wav files.")
    return parser.parse_args(argv)


def _typed(values: Sequence[str]) -> list:
    """A column's values as pandas reads them: ints if every value is
    one, else floats if every value is one, else the strings."""
    for kind in (int, float):
        try:
            return [kind(v) for v in values]
        except ValueError:
            continue
    return list(values)


def read_rows(csv_file: str) -> List[Dict[str, object]]:
    """The CSV's rows, piano_model typed as pandas would type the column;
    raises SystemExit when a required column is missing."""
    with open(csv_file, newline='') as f:
        reader = csv.DictReader(f)
        columns = set(reader.fieldnames or ())
        rows = list(reader)
    missing = set(REQUIRED_COLUMNS) - columns
    if missing:
        raise SystemExit(
            f"{csv_file} is missing columns {sorted(missing)}; this "
            f"CLI expects a performance listing with columns "
            f"{sorted(REQUIRED_COLUMNS)} (not the MAESTRO metadata csv).")
    for row, piano in zip(rows, _typed([r['piano_model'] for r in rows])):
        row['piano_model'] = piano
    return rows


def render_stems(model, outputs: Dict[str, object],
                 noise: Optional[Sequence[torch.Tensor]] = None):
    """The ``_additive`` and ``_substractive`` stems, each (b, n_samples),
    re-rendered per voice from a forward's stacked (n_synths, b, ...)
    controls and summed in voice order (synthesize_from_csv.py:78-94 of
    the JAX package). The additive synth renders every voice in one call
    (K1 on the card). Voice i's noise comes from a generator seeded i, or
    from ``noise[i]``, a (b, n_samples) uniform draw in [-1, 1)."""
    group = model.processor_group
    n_synths = model.n_synths
    add_ctrl = group.additive.get_controls(
        *(group._fold(outputs[k]) for k in group.additive_controls))
    voices = group.additive.get_signal(**add_ctrl)
    voices = voices.reshape(n_synths, -1, voices.shape[-1])
    additive = voices[0]
    for i in range(1, n_synths):
        additive = additive + voices[i]
    substractive = None
    for i in range(n_synths):
        ctrl = group.noise.get_controls(
            *(outputs[k][i] for k in group.noise_controls))
        if noise is None:
            generator = torch.Generator(device=model.device).manual_seed(i)
            signal = group.noise.get_signal(**ctrl, generator=generator)
        else:
            signal = group.noise.get_signal(**ctrl, noise=noise[i])
        substractive = signal if substractive is None else (
            substractive + signal)
    return additive, substractive


def main(args) -> Dict[str, np.ndarray]:
    """Render every row; returns {written wav path: its audio}."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.data import audio_io
    from ddsp_piano_torch.data.io import load_midi_as_roll
    from ddsp_piano_torch.data.midi_encoders_device import (
        roll_to_conditioning_device)
    from ddsp_piano_torch.device import resolve_device
    from ddsp_piano_torch.training.checkpoints import restore_params

    device = resolve_device(args.device)
    rows = read_rows(args.csv_file)
    model = get_model(args.config, inference=True,
                      duration=args.duration + args.warm_up, device=device)
    restore_params(model, args.ckpt)
    sample_rate = model.sample_rate
    crop = int(args.warm_up * sample_rate)
    piano_models = np.sort(np.unique([r['piano_model'] for r in rows]))
    os.makedirs(args.out_dir, exist_ok=True)
    written: Dict[str, np.ndarray] = {}

    def save(path, audio):
        audio = audio[0, crop:].cpu().numpy()
        audio_io.write_wav(path, audio, sample_rate)
        if args.normalize is not None:
            audio_io.normalize_audio(path, args.normalize)
        written[path] = audio

    for row in rows:
        log.info("Loading file %s", row['mid_file'])
        inputs = load_midi_as_roll(
            os.path.join(args.maestro_dir, row['mid_file']),
            frame_rate=model.frame_rate, duration=args.duration,
            warm_up_duration=args.warm_up)
        piano_model = row['piano_model']
        composer = str(row['canonical_composer']).split(' ')[-1]
        index = int(np.where(piano_models == piano_model)[0][0])
        log.info("Synthesizing %s%s (%.1f s)...", piano_model, composer,
                 inputs['duration'] - args.warm_up)
        stem = os.path.join(args.out_dir, f'{piano_model}{composer}')
        with torch.inference_mode():
            conditioning, _ = roll_to_conditioning_device(
                torch.from_numpy(inputs['roll']).to(device), model.n_synths)
            features = {
                'conditioning': conditioning,
                'pedal': torch.from_numpy(inputs['pedal']).to(device),
                'piano_model': torch.tensor([[index]], device=device),
            }
            outs = model(features, generator=torch.Generator(
                device=device).manual_seed(0))
            save(stem + '.wav', outs['audio_synth'])
            if args.decompose:
                save(stem + '_unreverbed.wav', outs['add']['signal'])
                additive, substractive = render_stems(model, outs)
                save(stem + '_additive.wav', additive)
                save(stem + '_substractive.wav', substractive)
    return written


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    main(process_args())
