"""TensorBoard summaries of training: scalars, audio, spectrograms and
tuning curves.

Counterpart of ddsp_piano_tpu/training/summaries.py, written with the
port's own event-file writer (training/events.py) instead of tf.summary:
the same tags, the same scalar values, the same audio bytes. Images are
drawn here as numpy rasters (the JAX package draws them with
matplotlib); the numbers behind them are the JAX package's: the log
magnitude spectrogram of :func:`_log_magnitude_spectrogram` and the
curves of :func:`tuning_curve_figures`. :class:`NullWriter` takes the
writer's place in the ranks of a data-parallel run that do not write.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ddsp_piano_torch.training import events

# A dark-to-light ramp for the spectrogram images (black, purple, red,
# orange, pale yellow; magma-like), interpolated in RGB.
_RAMP = np.array([[0, 0, 4], [81, 18, 124], [183, 55, 121],
                  [252, 137, 97], [252, 253, 191]], np.float64)


def _to_uint8(image: np.ndarray) -> np.ndarray:
    """tf.image.convert_image_dtype(x, uint8, saturate=True) of a float
    image: trunc(clip(x * 255.5, 0, 255)); uint8 passes."""
    image = np.asarray(image)
    if image.dtype == np.uint8:
        return image
    return np.clip(np.asarray(image, np.float32) * np.float32(255.5), 0.0,
                   255.0).astype(np.uint8)


def _colorize(values: np.ndarray) -> np.ndarray:
    """(h, w) floats -> (h, w, 3) uint8 through the ramp, from each
    image's own minimum to maximum (imshow's default normalisation)."""
    lo, hi = float(values.min()), float(values.max())
    t = (values - lo) / (hi - lo) if hi > lo else np.zeros_like(values)
    pos = np.clip(t, 0.0, 1.0) * (len(_RAMP) - 1)
    idx = np.minimum(pos.astype(np.int64), len(_RAMP) - 2)
    frac = (pos - idx)[..., None]
    rgb = _RAMP[idx] * (1.0 - frac) + _RAMP[idx + 1] * frac
    return np.round(rgb).astype(np.uint8)


def _log_magnitude_spectrogram(audio: np.ndarray, frame: int = 1024,
                               hop: int = 256) -> np.ndarray:
    """(n_frames, frame // 2 + 1) log(|rfft| + 1e-6) of Hann-windowed
    frames, the last frame's indices clamped to the signal (summaries.py:
    92-99, the same numpy arithmetic)."""
    n_frames = max((len(audio) - frame) // hop + 1, 1)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame)[None, :]
    idx = np.minimum(idx, len(audio) - 1)
    frames = audio[idx] * np.hanning(frame)
    mag = np.abs(np.fft.rfft(frames, axis=-1))
    return np.log(mag + 1e-6)


def spectrogram_image(audio: np.ndarray, audio_synth: np.ndarray
                      ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """The first batch element of the target and of the synthesized audio,
    each a log magnitude spectrogram with frequency upwards, target above
    synthesized. Returns the RGB image and the two spectrograms."""
    specs = {name: _log_magnitude_spectrogram(np.asarray(a)[0])
             for name, a in (('original', audio),
                             ('synthesized', audio_synth))}
    panels = [_colorize(spec.T[::-1]) for spec in specs.values()]
    gap = np.full((4, panels[0].shape[1], 3), 255, np.uint8)
    return np.concatenate([panels[0], gap, panels[1]], axis=0), specs


def curve_image(x: np.ndarray, y: np.ndarray, log_y: bool = False,
                height: int = 200, width: int = 300) -> np.ndarray:
    """A line plot of y against x as a (height, width) uint8 image: white
    ground, a grey frame, the curve in black (log10 of y with
    ``log_y``)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if log_y:
        y = np.log10(y)
    image = np.full((height, width), 255, np.uint8)
    m = 8
    image[m, m:width - m] = image[height - m - 1, m:width - m] = 160
    image[m:height - m, m] = image[m:height - m, width - m - 1] = 160
    lo, hi = float(np.min(y)), float(np.max(y))
    span = hi - lo if hi > lo else 1.0
    xs = np.linspace(0.0, 1.0, 4 * width)
    ys = np.interp(xs * (x[-1] - x[0]) + x[0], x, y)
    cols = np.round(m + xs * (width - 2 * m - 1)).astype(np.int64)
    rows = np.round(height - m - 1 - (ys - lo) / span
                    * (height - 2 * m - 1)).astype(np.int64)
    image[rows, cols] = 0
    return image


class NullWriter:
    """No-op writer for every rank but rank 0 in a data-parallel run
    (every rank computes the same summaries; rank 0 writes them)."""

    path = None

    def __getattr__(self, name):
        return lambda *a, **k: None


class SummaryWriter:
    """Event-file writer of the train CLI's summaries: one file under
    ``logdir``."""

    def __init__(self, logdir: str):
        self._writer = events.EventFileWriter(logdir)

    @property
    def path(self) -> str:
        return self._writer.path

    def scalar(self, tag: str, value: float, step: int):
        self._writer.scalar(tag, value, step)

    def scalars(self, prefix: str, values: Dict[str, float], step: int):
        for k, v in values.items():
            self.scalar(f'{prefix}/{k}', v, step)

    def audio(self, tag: str, audio: np.ndarray, sample_rate: int,
              step: int, max_outputs: int = 4):
        """audio (batch, n_samples): the first ``max_outputs`` clips,
        divided by their peak when it is above 1 (summaries.py:40-49)."""
        audio = np.asarray(audio, np.float32)
        peak = np.abs(audio).max() or 1.0
        audio = (audio / max(peak, 1.0))[..., np.newaxis]
        self._writer.audio(tag, audio[:max_outputs], sample_rate, step)

    def image(self, tag: str, image: np.ndarray, step: int):
        """image: (h, w[, c]) uint8, or float in [0, 1]."""
        self._writer.image(tag, [_to_uint8(image)], step)

    def spectrogram_summary(self, audio: np.ndarray, audio_synth: np.ndarray,
                            step: int, sample_rate: int = 16000,
                            tag: str = 'spectrogram'
                            ) -> Dict[str, np.ndarray]:
        """Target and synthesized spectrograms as one image; returns the
        two spectrograms."""
        del sample_rate
        image, specs = spectrogram_image(audio, audio_synth)
        self.image(tag, image, step)
        return specs

    def curves(self, model, step: int, prefix: str = 'tuning'
               ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """The model's tuning curves as images '<prefix>/<name>'; returns
        the curves."""
        curves = tuning_curve_figures(model)
        for name, (x, y) in curves.items():
            self.image(f'{prefix}/{name}',
                       curve_image(x, y, log_y=name == 'inharmonicity'),
                       step)
        return curves

    def flush(self):
        self._writer.flush()

    def close(self):
        self._writer.close()


def tuning_curve_figures(model) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """The learned inharmonicity and tuning over MIDI 21-108, from the
    model's ``inharm_model`` (summaries.py:102-140): {'inharmonicity':
    (pitches, max(B, 1e-8)), 'tuning': (pitches, cents from equal
    temperament)}, the y values of the JAX package's plotted lines. The
    tuning curve needs an inharm_model that also gives f0 (the v2 joint
    tuning); the ET reference is ops.core.midi_to_hz."""
    import torch

    from ddsp_piano_torch.ops import core

    module = getattr(model, 'inharm_model', None)
    if module is None:
        return {}
    pitches = np.arange(21, 109, dtype=np.float32)
    device = model.device
    try:
        with torch.no_grad():
            outs = module.apply_features({
                'extended_pitch': torch.from_numpy(pitches.reshape(1, -1, 1)
                                                   ).to(device),
                'piano_model': torch.zeros((1, 1), dtype=torch.int32,
                                           device=device)})
    except (KeyError, TypeError):
        return {}
    inharm = outs['inharm_coef'][0, :, 0].cpu().numpy()
    curves = {'inharmonicity': (pitches, np.maximum(inharm, 1e-8))}
    if 'f0_hz' in outs:
        f0 = outs['f0_hz'][0, :, 0].cpu().numpy()
        et = core.midi_to_hz(torch.from_numpy(pitches)).numpy()
        curves['tuning'] = (pitches, 1200.0 * np.log2(
            np.maximum(f0, 1e-6) / et))
    return curves
