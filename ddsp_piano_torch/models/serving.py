"""Serving: raw pianoroll -> audio on the model's device.

Counterpart of ddsp_piano_tpu/models/serving.py. The reference allocates
voices on the host (a numpy loop) before the forward; here the whole chain
(88-key roll -> polyphonic conditioning through the device allocator,
data/midi_encoders_device.py, K9 on the card -> control networks ->
synthesis -> reverb) runs on the model's device, with no host round trip
between the roll and the audio.

The weights are the model's own: load a checkpoint into it first with
``training.checkpoints.restore_params`` (the JAX function's ``params=``
override).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ddsp_piano_torch.data.midi_encoders_device import (
    roll_to_conditioning_device)


def make_serving_fn(model, seed: int = 0) -> Callable:
    """Build serve(roll (b, T, 88, 2), pedal (b, T, 4), piano_model (b, 1)
    int) -> audio (b, T * sample_rate / frame_rate), on the model's device.

    The inputs (tensors on any device, or arrays) are moved to the
    model's device. The active channel is binarized first: the device
    allocator then gives the host allocator's conditioning for every roll
    (models/serving.py:40-46 of the JAX package). Every call draws its
    noise from a generator seeded with ``seed`` (the JAX function's fixed
    key), or takes ``noise``, the (n_synths * b, n_samples) uniform draw
    in [-1, 1), as the tests inject it. The forward runs under
    torch.inference_mode()."""
    device = model.device
    n_synths = model.n_synths

    def serve(roll, pedal, piano_model,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.inference_mode():
            roll = torch.as_tensor(roll, dtype=torch.float32, device=device)
            roll = torch.stack([(roll[..., 0] > 0).to(torch.float32),
                                roll[..., 1]], dim=-1)
            conditioning, _ = roll_to_conditioning_device(roll, n_synths)
            features = {
                'conditioning': conditioning,
                'pedal': torch.as_tensor(pedal, dtype=torch.float32,
                                         device=device),
                'piano_model': torch.as_tensor(piano_model, device=device),
            }
            generator = None
            if noise is None:
                generator = torch.Generator(device=device).manual_seed(seed)
            return model(features, noise=noise,
                         generator=generator)['audio_synth']

    return serve
