"""Config smoke test: build a config, print its parameters by slot, run a
forward on a dummy batch and one training step.

    python -m ddsp_piano_torch.configs.gin_test <config> [--duration 1.0]
        [--batch_size 2] [--device cuda|cpu]

Counterpart of ddsp_piano_tpu/configs/gin_test.py: ``<config>`` is a
registered config name or a ``.gin`` file's path.
"""

from __future__ import annotations

import argparse


def process_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('config', type=str,
                        help='Config name or .gin file path.')
    parser.add_argument('--duration', type=float, default=1.0)
    parser.add_argument('--batch_size', type=int, default=2)
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help="Device to run on (default: %(default)s)")
    return parser.parse_args(argv)


def main(args) -> dict:
    """Returns the parameter counts by slot, the forward's audio shape and
    losses, and the training step's losses."""
    import numpy as np
    import torch

    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.data.pipeline import get_dummy_data
    from ddsp_piano_torch.device import resolve_device
    from ddsp_piano_torch.training.trainer import Trainer

    device = resolve_device(args.device)
    model = get_model(args.config, duration=args.duration, device=device)

    slots = {}
    for name, p in model.named_parameters():
        slot = name.split('.')[0]
        slots[slot] = slots.get(slot, 0) + p.numel()
    print(f"config {args.config}: sample_rate={model.sample_rate}, "
          f"n_synths={model.n_synths}, parameters={sum(slots.values()):,}")
    for slot, n in slots.items():
        print(f"  {slot:28s} {n:>10,} params")

    feats = get_dummy_data(batch_size=args.batch_size, duration=args.duration,
                           sample_rate=model.sample_rate,
                           frame_rate=model.frame_rate,
                           n_synths=model.n_synths)
    batch = {k: torch.from_numpy(v).to(device) for k, v in feats.items()}
    with torch.no_grad():
        outs = model(batch, generator=torch.Generator(
            device=device).manual_seed(0), training=True)
    losses = {k: float(v) for k, v in outs['losses'].items()}
    print("forward ok:", tuple(outs['audio_synth'].shape))
    print("losses:", {k: round(v, 4) for k, v in losses.items()})

    trainer = Trainer(model, first_phase=True)
    step = trainer.train_step(feats)
    trainer.check_pending()
    step = {k: float(v) for k, v in step.items()}
    if not np.isfinite(step['total_loss']):
        raise SystemExit(f"training step loss {step['total_loss']}")
    print(f"train step ok on {device}:", round(step['total_loss'], 4))
    return dict(slots=slots, audio_shape=tuple(outs['audio_synth'].shape),
                losses=losses, step_losses=step)


if __name__ == '__main__':
    main(process_args())
