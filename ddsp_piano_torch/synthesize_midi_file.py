"""Synthesize a MIDI file to audio with the PyTorch DDSP-Piano model.

    python -m ddsp_piano_torch.synthesize_midi_file
        [-c maestro_v2|dafx22|dafx22_24khz] [--ckpt PATH] [--piano_type N]
        [-wu S] [-d S] [-n DBFS] [-u] [--seed N] [--oscillator skip|full]
        [--streaming [--chunk_seconds S]] [--device cuda|cpu]
        midi_file out.wav

The flags mean what they mean for the JAX package's synthesize_midi_file.py.
The MIDI is read at the config's frame rate and polyphony, then the model
is built for the file's duration (dafx22's z encoder is built for one
length). The forward runs once, on ``cuda`` unless --device cpu is given,
under torch.inference_mode(). --ckpt loads the weights of a checkpoint:
the port's own (a ``ckpt.pt`` file, or a directory holding one, as the
train CLI writes them) or a TF object checkpoint (a prefix, or a
directory holding ``.index`` files; reading it needs TensorFlow). Without
--ckpt the weights are the Keras-style initial weights (seed 0). --seed
seeds the noise synth. --oscillator full renders every partial with the all-partials
kernel (forward only), as DDSP_PIANO_TPU_PALLAS=1 does in the JAX package;
the default skips silent and above-Nyquist partials. --streaming renders
chunk by chunk, for every registered config (models/streaming.py, the
uniform-chunk driver, as the JAX CLI's synthesize_scanned): the file is
right-padded to whole chunks of
--chunk_seconds, the card holds one chunk's controls at a time, and the
audio is cropped to the file's samples.
"""

from __future__ import annotations

import argparse
import logging
import time

import torch

log = logging.getLogger(__name__)


def process_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('-c', '--config', type=str, default='maestro_v2',
                        help="Model config name or .gin file path. "
                             "(default: %(default)s)")
    parser.add_argument('--ckpt', type=str, default=None,
                        help="Checkpoint to load: the port's ckpt.pt (file "
                             "or directory) or a TF checkpoint (prefix or "
                             "directory). (default: initial weights)")
    parser.add_argument('--piano_type', type=int, default=9,
                        help="Piano model (from 0 to 9). "
                             "(default: %(default)s)")
    parser.add_argument('-wu', '--warm_up', type=float, default=0.5,
                        help="Warm-up duration (in s, default: %(default)s)")
    parser.add_argument('-d', '--duration', type=float, default=None,
                        help="Maximum duration of synthesized audio.")
    parser.add_argument('-n', '--normalize', type=float, default=None,
                        help="Normalize audio to this amount of dBFS.")
    parser.add_argument('-u', '--unreverbed', action='store_true',
                        help="Also generate dry piano audio, without reverb.")
    parser.add_argument('--seed', type=int, default=0,
                        help="RNG seed for the noise synthesizer.")
    parser.add_argument('--streaming', action='store_true',
                        help="Render in fixed-size chunks with carried "
                             "state (bounded memory for any file length).")
    parser.add_argument('--chunk_seconds', type=float, default=4.0,
                        help="Streaming chunk length (default: "
                             "%(default)s).")
    parser.add_argument('--oscillator', choices=('skip', 'full'),
                        default='skip',
                        help="Additive oscillator: skip silent partials, "
                             "or compute them all (forward only). "
                             "(default: %(default)s)")
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help="Device to synthesize on (default: %(default)s)")
    parser.add_argument('midi_file', type=str,
                        help="Piano MIDI file to synthesize.")
    parser.add_argument('out_file', type=str, help="Save audio as wav file.")
    return parser.parse_args(argv)


def render_streaming(model, features, chunk_seconds: float,
                     generator: torch.Generator):
    """Streamed (wet, dry, chunks): the conditioning right-padded to whole
    chunks, the audio cropped to the unpadded frames' samples."""
    from ddsp_piano_torch.models.streaming import (StreamingSynthesizer,
                                                   pad_to_chunks)

    chunk_frames = int(chunk_seconds * model.frame_rate)
    if chunk_frames < 1:
        raise SystemExit(
            f"--chunk_seconds {chunk_seconds} is below one frame period "
            f"(1/{model.frame_rate} s).")
    padded = pad_to_chunks(features, chunk_frames)
    audio, dry = StreamingSynthesizer(model, chunk_frames).synthesize_scanned(
        padded, generator=generator, return_dry=True)
    n_samples = features['conditioning'].shape[1] * (model.sample_rate
                                                     // model.frame_rate)
    return (audio[:, :n_samples], dry[:, :n_samples],
            padded['conditioning'].shape[1] // chunk_frames)


def main(args) -> dict:
    """Render and write the wav(s). Returns the wet and dry audio (numpy,
    warm-up cropped), the sample rate, the forward's wall seconds, the
    restore's wall seconds, the model and, with --streaming, the chunk
    count."""
    from ddsp_piano_torch.configs import config_rates, get_model
    from ddsp_piano_torch.data import audio_io
    from ddsp_piano_torch.data.io import load_midi_as_conditioning
    from ddsp_piano_torch.device import resolve_device
    from ddsp_piano_torch.training.checkpoints import restore_params

    device = resolve_device(args.device)
    rates = config_rates(args.config)
    inputs = load_midi_as_conditioning(args.midi_file,
                                       duration=args.duration,
                                       warm_up_duration=args.warm_up,
                                       frame_rate=rates['frame_rate'],
                                       n_synths=rates['n_synths'])
    model = get_model(args.config, inference=True,
                      duration=inputs['duration'], device=device,
                      oscillator=args.oscillator)
    start = time.perf_counter()
    restore_params(model, args.ckpt)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    restore_seconds = time.perf_counter() - start
    features = {
        'conditioning': torch.from_numpy(inputs['conditioning']).to(device),
        'pedal': torch.from_numpy(inputs['pedal']).to(device),
        'piano_model': torch.tensor([[args.piano_type]], device=device),
    }
    generator = torch.Generator(device=device).manual_seed(args.seed)
    chunks = None
    start = time.perf_counter()
    with torch.inference_mode():
        if args.streaming:
            audio, dry, chunks = render_streaming(
                model, features, args.chunk_seconds, generator)
        else:
            outs = model(features, generator=generator)
            audio, dry = outs['audio_synth'], outs['add']['signal']
        audio, dry = audio[0].cpu().numpy(), dry[0].cpu().numpy()
    seconds = time.perf_counter() - start

    sample_rate = model.sample_rate
    crop = int(args.warm_up * sample_rate)
    audio, dry = audio[crop:], dry[crop:]
    audio_io.write_wav(args.out_file, audio, sample_rate)
    if args.normalize is not None:
        audio_io.normalize_audio(args.out_file, args.normalize)
    if args.unreverbed:
        dry_file = args.out_file + '_unreverbed.wav'
        audio_io.write_wav(dry_file, dry, sample_rate)
        if args.normalize is not None:
            audio_io.normalize_audio(dry_file, args.normalize)
    log.info("Audio saved at %s.", args.out_file)
    result = {'audio': audio, 'dry': dry, 'sample_rate': sample_rate,
              'seconds': seconds, 'restore_seconds': restore_seconds,
              'model': model}
    if chunks is not None:
        result['chunks'] = chunks
    return result


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    main(process_args())
