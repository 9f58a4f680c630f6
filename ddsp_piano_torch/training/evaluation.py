"""The per-segment evaluation protocol of the evaluation CLI.

Counterpart of ddsp_piano_tpu/training/evaluation.py:17-44: each segment's
multi-scale spectral loss after a forward of the model, as the reference's
evaluation runs it (training-mode forward, per-segment loss). The port's
``training`` flag only adds the batch's losses to the outputs, so the
forward here runs without it and the loss is taken per segment.

Each segment's noise draw comes from its global segment index, so a
segment's loss, and the CSV, do not depend on how the sweep packs segments
into batches. A noise synth that loops noise bands (NoiseBandNetSynth)
takes each row's loop shift from that row's draw.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

FEATURES = ('conditioning', 'pedal', 'piano_model')


def segment_noise(seg_indices: Sequence[int], n_synths: int, n_samples: int,
                  device) -> torch.Tensor:
    """(b, n_synths, n_samples) uniform draws in [-1, 1), row i from a
    generator on ``device`` seeded with segment index ``seg_indices[i]``."""
    rows = []
    for seg_idx in seg_indices:
        generator = torch.Generator(device=device).manual_seed(int(seg_idx))
        rows.append(2.0 * torch.rand((n_synths, n_samples),
                                     generator=generator, device=device,
                                     dtype=torch.float32) - 1.0)
    return torch.stack(rows)


def build_segment_eval_fn(model, loss_name: str = 'audio_stft_loss'
                          ) -> Callable:
    """``eval_fn(batch, seg_indices, noise=None)`` for a PianoModel.

    ``batch`` holds (b, ...) tensors on the model's device (conditioning,
    pedal, piano_model and the target audio), ``seg_indices`` the b global
    segment indices. ``noise`` optionally replaces the draws with
    (b, n_synths, n_samples) given ones (the tests inject the JAX
    package's). Returns the (b,) per-segment losses and the (b, samples)
    wet audio.
    """
    spec_loss = next(loss for loss in model.loss_objs
                     if loss.name == loss_name)

    def eval_fn(batch: Dict[str, torch.Tensor], seg_indices: Sequence[int],
                noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b = batch['conditioning'].shape[0]
        n_samples = batch['audio'].shape[-1]
        if noise is None:
            noise = segment_noise(seg_indices, model.n_synths, n_samples,
                                  model.device)
        # The processor group folds voices as (n_synths, batch): row
        # s * b + i is segment i's voice s.
        folded = noise.transpose(0, 1).reshape(model.n_synths * b, n_samples)
        with torch.inference_mode():
            outs = model({k: batch[k] for k in FEATURES}, noise=folded)
            synth = outs[spec_loss.output_key]
            if spec_loss.extract_signal:
                synth = synth['signal']
            losses = spec_loss.compute_per_element(batch['audio'], synth)
        return losses, outs['audio_synth']

    return eval_fn
