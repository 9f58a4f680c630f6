"""Piano model sub-modules.

The modules that maestro_v2 and dafx22 build, counterparts of
ddsp_piano_tpu/models/sub_modules.py: ContextNetwork (:52-87),
FiLMContextNetwork (:123-171), OneHotZEncoder (:174-216),
MultiInstrumentReverb (:253-292), MultiInstrumentFeedbackDelayReverb
(:295-370), MonophonicNetwork (:378-412), MonophonicDeepNetwork
(:415-462), Parallelizer (:470-523), InharmonicityNetwork (:538-582),
JointParametricInharmTuning (:623-680), Detuner (:716-741), and
F0ProcessorCell and NoteRelease (:875-933). Attribute names follow the
JAX params pytree.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn as tnn

from portbench.reference import nn
from portbench.reference.kernels.note_release import note_release_scan
from portbench.reference.ops import core
from portbench.reference.processors.reverb import FeedbackDelayNetwork

MIDI_NORM = 128.0


def _collapse_last_axis(x: torch.Tensor) -> torch.Tensor:
    """(b, t, n, c) -> (b, t, n*c)."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def _norm_conditioning(conditioning: torch.Tensor) -> torch.Tensor:
    """Scale (..., 2) pitch/velocity pairs by [1/128, 1]. 1/128 is exact,
    so this is the JAX package's product, without a host-to-device copy of
    the scale (which would synchronise the stream)."""
    return torch.cat([conditioning[..., :1] * (1.0 / MIDI_NORM),
                      conditioning[..., 1:]], dim=-1)


def _split_outputs(x: torch.Tensor, output_splits) -> tuple:
    outs = nn.split_to_dict(x, output_splits)
    return tuple(outs[k] for k, _ in output_splits)


class ContextNetwork(nn.DictModule):
    """Global context from conditioning, pedal and z: a config-driven layer
    list (dafx22: Dense32 leaky -> GRU64 -> Normalize), then a dense_out
    head split into ``output_splits``. ``normalize_pitch`` scales the
    conditioning's pitches by 1/128 first (enstdkcl_32khz,
    multi_instruments)."""

    input_keys = ('conditioning', 'pedal', 'z')

    def __init__(self, layers: Sequence[tnn.Module], out_features: int,
                 output_splits=(('context', 32),), normalize_pitch=False):
        super().__init__()
        self.model = tnn.Sequential(*layers)
        self.output_splits = tuple(output_splits)
        self.output_keys = tuple(k for k, _ in self.output_splits)
        self.normalize_pitch = normalize_pitch
        self.dense_out = nn.Dense(sum(v[1] for v in self.output_splits),
                                  out_features)

    def _inputs(self, conditioning, pedal, z):
        if self.normalize_pitch:
            conditioning = _norm_conditioning(conditioning)
        return torch.cat([_collapse_last_axis(conditioning), pedal, z],
                         dim=-1)

    def forward(self, conditioning, pedal, z):
        x = self._inputs(conditioning, pedal, z)
        return _split_outputs(self.dense_out(self.model(x)),
                              self.output_splits)


class OneHotZEncoder(nn.DictModule):
    """Instrument id -> z embedding and the global inharmonicity and
    detuning scalars, each resampled (linear) to duration * frame_rate
    frames: the model is built for one duration."""

    input_keys = ('piano_model',)
    output_keys = ('z', 'global_inharm', 'global_detuning')

    def __init__(self, n_instruments=16, z_dim=16, duration=None,
                 frame_rate=250):
        super().__init__()
        self.n_instruments = n_instruments
        self.duration = duration
        self.frame_rate = frame_rate
        self.embedding = nn.Embedding(n_instruments, z_dim)
        self.inharm_embedding = nn.Embedding(n_instruments, 1)
        self.detune_embedding = nn.Embedding(n_instruments, 1)

    @property
    def n_frames(self) -> int:
        return int(self.duration * self.frame_rate) if self.duration else 1

    def forward(self, piano_model):
        if self.n_instruments == 1:
            piano_model = torch.zeros_like(torch.as_tensor(piano_model))
        outs = []
        for emb in (self.embedding, self.inharm_embedding,
                    self.detune_embedding):
            x = emb(piano_model)
            if x.dim() == 2:
                x = x[:, None, :]
            outs.append(core.resample(x, self.n_frames))
        return tuple(outs)


class MultiInstrumentReverb(nn.DictModule):
    """A learned raw IR per recording environment; at inference its tail
    past ``decay_start`` samples is faded by exp(-4 t)."""

    input_keys = ('piano_model',)
    output_keys = ('reverb_ir',)

    def __init__(self, n_instruments=16, reverb_duration=1.5,
                 sample_rate=16000, inference=False):
        super().__init__()
        self.n_instruments = n_instruments
        self.reverb_length = int(reverb_duration * sample_rate)
        self.inference = inference
        self.reverb_dict = nn.Embedding(n_instruments, self.reverb_length,
                                        embeddings_init='normal',
                                        init_mean=0.0, init_stddev=1e-6)

    def exponential_decay_mask(self, ir):
        """The mask of sub_modules.py:277-282: 1 for the first 16000
        samples (at every rate), then exp(-4 t) for t from 0 to 1; evaluated
        in float64 and rounded once (the same on every device)."""
        decay_start = 16000
        t = torch.linspace(0.0, 1.0, self.reverb_length - decay_start,
                           dtype=torch.float64, device=ir.device)
        mask = torch.cat([torch.ones(decay_start, dtype=torch.float64,
                                     device=ir.device),
                          torch.exp(-4.0 * t)]).float()
        return ir * mask[None, :]

    def forward(self, piano_model):
        if self.n_instruments == 1:
            piano_model = torch.zeros_like(torch.as_tensor(piano_model))
        ir = self.reverb_dict(piano_model)
        if ir.dim() == 3:
            ir = ir[:, 0]
        if self.inference:
            ir = self.exponential_decay_mask(ir)
        return ir


class FiLMContextNetwork(nn.DictModule):
    """Context network with per-input heads and a piano-id FiLM layer."""

    input_keys = ('conditioning', 'pedal', 'piano_model')
    output_keys = ('context',)

    def __init__(self, n_instruments=10, n_synths=16, layer_dim=64,
                 context_dim=32):
        super().__init__()
        self.conditioning_head = nn.FcStack(32, n_synths * 2, layers=2)
        self.pedal_head = nn.FcStack(16, 4, layers=2)
        self.piano_id_head = nn.Embedding(n_instruments, 32)
        self.main_model = tnn.Sequential(
            nn.Dense(layer_dim, 32 + 16, activation='leaky_relu'),
            nn.GRU(layer_dim, layer_dim),
            nn.Dense(layer_dim, layer_dim),
            nn.LayerNormalization(layer_dim),
            nn.Activation('leaky_relu'),
        )
        self.film_input_reshape = nn.Dense(layer_dim * 2, 32)
        self.output_layer = nn.FcStack(context_dim, layer_dim, layers=2)

    def forward(self, conditioning, pedal, piano_model):
        conditioning = _collapse_last_axis(_norm_conditioning(conditioning))
        cond_feat = self.conditioning_head(conditioning)
        pedal_feat = self.pedal_head(pedal)
        piano_feat = self.piano_id_head(piano_model)
        features = self.main_model(torch.cat([cond_feat, pedal_feat], -1))
        piano_feat = self.film_input_reshape(piano_feat)
        film_coef, film_bias = torch.chunk(piano_feat, 2, dim=-1)
        features = features * film_coef + film_bias
        return self.output_layer(features)


class MultiInstrumentFeedbackDelayReverb(nn.DictModule):
    """Per-instrument FDN parameter embeddings -> (b, 2 * sr) reverb IR.
    The JAX package vmaps the per-instance IR over the batch; here the
    batch is a leading dimension of the FDN math."""

    input_keys = ('piano_model',)
    output_keys = ('reverb_ir',)

    _EMBEDDINGS = ('_input_gain', '_output_gain', '_gain_allpass',
                   '_delays_allpass', '_time_rev_0_sec', '_alpha_tone',
                   '_early_ir')

    def __init__(self, n_instruments=10, sample_rate=16000, delay_lines=8,
                 early_ir_length=200, regularize_early=False):
        super().__init__()
        self.n_instruments = n_instruments
        self.regularize_early = regularize_early

        def emb(width, mean, std):
            return nn.Embedding(n_instruments, width,
                                embeddings_init='normal', init_mean=mean,
                                init_stddev=std)

        self._input_gain = emb(delay_lines, 0.25, 0.1)
        self._output_gain = emb(delay_lines, 0.25, 0.1)
        self._gain_allpass = emb(4 * delay_lines, 0.25, 0.1)
        self._delays_allpass = emb(4 * delay_lines, 400.0, 60.0)
        self._time_rev_0_sec = emb(1, 2.0, 0.5)
        self._alpha_tone = emb(1, 0.0, 0.1)
        self._early_ir = emb(early_ir_length, 0.0, 0.1)
        self.reverb_model = FeedbackDelayNetwork(
            sampling_rate=sample_rate, delay_lines=delay_lines,
            early_ir_length=early_ir_length)

    @staticmethod
    def _reshape_embedding(e, splits=4):
        """(b, 4n) -> (b, n, 4): chunk the last axis, chunk index last."""
        return torch.stack(torch.chunk(e, splits, dim=-1), dim=-1)

    def regularization(self) -> torch.Tensor:
        """L1 penalty on the early IR embeddings when regularize_early
        (sub_modules.py:367-370), else 0."""
        emb = self._early_ir.embeddings
        if not self.regularize_early:
            return emb.new_zeros(())
        return 1e-1 * torch.sum(core.abs_(emb))

    def forward(self, piano_model):
        if self.n_instruments == 1:
            piano_model = torch.zeros_like(torch.as_tensor(piano_model))
        ids = torch.as_tensor(piano_model)[..., 0]                 # (b,)
        gather = lambda name: getattr(self, name)(ids)
        return self.reverb_model.get_ir(
            input_gain=gather('_input_gain'),
            output_gain=gather('_output_gain'),
            gain_allpass=self._reshape_embedding(gather('_gain_allpass')),
            delays_allpass=self._reshape_embedding(
                gather('_delays_allpass')),
            time_rev_0_sec=torch.relu(gather('_time_rev_0_sec')),
            alpha_tone=torch.sigmoid(gather('_alpha_tone')),
            early_ir=gather('_early_ir'))


class MonophonicNetwork(nn.DictModule):
    """Monophonic controls from the folded per-voice inputs: a
    config-driven layer list (dafx22: Dense128 leaky -> GRU192 -> Dense192
    leaky -> Normalize), then a dense_out head split into
    ``output_splits``."""

    input_keys = ('conditioning', 'extended_pitch', 'context')

    def __init__(self, layers: Sequence[tnn.Module], out_features: int,
                 output_splits=(('amplitudes', 1),
                                ('harmonic_distribution', 96),
                                ('magnitudes', 64))):
        super().__init__()
        self.model = tnn.Sequential(*layers)
        self.output_splits = tuple(output_splits)
        self.output_keys = tuple(k for k, _ in self.output_splits)
        self.dense_out = nn.Dense(sum(v[1] for v in self.output_splits),
                                  out_features)

    @staticmethod
    def _inputs(conditioning, extended_pitch, context):
        return torch.cat([extended_pitch / MIDI_NORM,
                          _norm_conditioning(conditioning), context], dim=-1)

    def forward(self, conditioning, extended_pitch, context):
        x = self._inputs(conditioning, extended_pitch, context)
        return _split_outputs(self.dense_out(self.model(x)),
                              self.output_splits)


class MonophonicDeepNetwork(nn.DictModule):
    """3 input FcStacks -> GRU -> skip concat -> out FcStack -> dense_out."""

    input_keys = ('conditioning', 'extended_pitch', 'context')

    def __init__(self, rnn_channels=192, ch=64, layers_per_stack=3,
                 context_dim=32,
                 output_splits=(('amplitudes', 1),
                                ('harmonic_distribution', 96),
                                ('magnitudes', 64))):
        super().__init__()
        self.output_splits = tuple(output_splits)
        self.output_keys = tuple(k for k, _ in self.output_splits)
        self.input_stacks = tnn.ModuleList([
            nn.FcStack(ch, 1, layers=layers_per_stack),
            nn.FcStack(ch, 2, layers=layers_per_stack),
            nn.FcStack(ch, context_dim, layers=layers_per_stack),
        ])
        self.model = nn.GRU(rnn_channels, 3 * ch)
        self.out_stack = nn.FcStack(ch, 3 * ch + rnn_channels,
                                    layers=layers_per_stack)
        self.dense_out = nn.Dense(sum(v[1] for v in self.output_splits), ch)

    def forward(self, conditioning, extended_pitch, context):
        xp = self.input_stacks[0](extended_pitch / MIDI_NORM)
        xc = self.input_stacks[1](_norm_conditioning(conditioning))
        xz = self.input_stacks[2](context)
        x = self.model(torch.cat([xp, xc, xz], dim=-1))
        x = self.out_stack(torch.cat([xp, xc, xz, x], dim=-1))
        return _split_outputs(self.dense_out(x), self.output_splits)


class Parallelizer:
    """Fold the polyphony axis into the batch axis and back.

    Global features (batch, time, ...) are repeated for every voice and
    per-voice rank-4 features (batch, time, n_synths, c) transposed, so
    everything becomes (n_synths * batch, time, ...); mono outputs unfold
    to stacked (n_synths, batch, ...).
    """

    def __init__(self, n_synths: int = 16,
                 global_keys: Tuple[str, ...] = ('conditioning', 'context',
                                                 'global_inharm',
                                                 'global_detuning'),
                 mono_keys: Tuple[str, ...] = ('f0_hz', 'inharm_coef',
                                               'amplitudes',
                                               'harmonic_distribution',
                                               'magnitudes')):
        self.n_synths = n_synths
        self.global_keys = tuple(global_keys)
        self.mono_keys = tuple(mono_keys)

    def put_polyphony_axis_at_first(self, x: torch.Tensor) -> torch.Tensor:
        if 2 <= x.dim() <= 3:
            return x[None].expand(self.n_synths, *x.shape)
        if x.dim() == 4:
            return x.permute(2, 0, 1, 3)
        raise ValueError(f"Cannot parallelize rank-{x.dim()} feature")

    def parallelize(self, features: dict) -> dict:
        features = dict(features)
        for k in self.global_keys:
            x = self.put_polyphony_axis_at_first(features[k])
            features[k] = x.reshape((x.shape[0] * x.shape[1],)
                                    + tuple(x.shape[2:]))
        return features

    def unparallelize(self, features: dict, batch_size: int) -> dict:
        features = dict(features)
        for k in self.mono_keys:
            x = features[k]
            stacked = x.reshape((self.n_synths, batch_size)
                                + tuple(x.shape[1:]))
            features[k] = stacked
        return features


# Rigaud et al. (DAFx-11) two-asymptote initial values, frozen
# (sub_modules.py:530-535).
_TREBLE_SLOPE = 9.26e-2
_TREBLE_INTERCEPT = -13.64
_BASS_SLOPE = -8.47e-2
_BASS_INTERCEPT = -5.82


class InharmonicityNetwork(nn.DictModule):
    """beta(m) = sum over the two bridges of exp(slope (m/128 + offset)),
    from frozen Rigaud slopes and offsets plus trainable L1-regularised
    modifiers, with a model-specific weight on the bass bridge through
    global_inharm."""

    input_keys = ('extended_pitch', 'global_inharm?')
    output_keys = ('inharm_coef',)
    FROZEN = ('slopes', 'offsets')

    def __init__(self):
        super().__init__()
        for name, width in (('model_specific_weight', 1), ('slopes', 2),
                            ('offsets', 2), ('slopes_modifier', 2),
                            ('offsets_modifier', 2)):
            setattr(self, name, tnn.Parameter(torch.zeros(width)))

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            for p in (self.model_specific_weight, self.slopes_modifier,
                      self.offsets_modifier):
                p.zero_()
            self.slopes.copy_(torch.tensor(
                [_TREBLE_SLOPE * MIDI_NORM, _BASS_SLOPE * MIDI_NORM]))
            self.offsets.copy_(torch.tensor(
                [_TREBLE_INTERCEPT / (MIDI_NORM * _TREBLE_SLOPE),
                 _BASS_INTERCEPT / (MIDI_NORM * _BASS_SLOPE)]))

    def forward(self, extended_pitch, global_inharm=None):
        return self._inharm(extended_pitch, global_inharm)

    def _inharm(self, extended_pitch, global_inharm=None):
        reduced = core.f32(extended_pitch) / MIDI_NORM
        slopes = self.slopes + self.slopes_modifier
        offsets = self.offsets + self.offsets_modifier
        asymptotes = slopes * (reduced + offsets)
        if global_inharm is not None:
            gi = 10.0 * core.f32(global_inharm)
            gi = torch.cat([torch.zeros_like(gi), gi], dim=-1)
            asymptotes = asymptotes + self.model_specific_weight * gi
        return torch.sum(core.rounded(torch.exp, asymptotes), dim=-1,
                         keepdim=True)

    def regularization(self) -> torch.Tensor:
        return 0.1 * (torch.sum(core.abs_(self.slopes_modifier))
                      + torch.sum(core.abs_(self.offsets_modifier)))


class Detuner(nn.DictModule):
    """One f0 per substring: midi_to_hz(pitch + tanh(dense(pitch / 128)) +
    tanh(global_detuning)), the dense zero-initialised. Without
    ``use_detune`` (phase 1 of training) every substring sits at the
    pitch."""

    input_keys = ('extended_pitch', 'global_detuning?')
    output_keys = ('f0_hz',)

    def __init__(self, n_substrings=2, use_detune=True):
        super().__init__()
        self.use_detune = use_detune
        self.layer = nn.Dense(n_substrings, 1, kernel_init='zeros')

    def forward(self, extended_pitch, global_detuning=None):
        extended_pitch = core.f32(extended_pitch)
        if self.use_detune:
            detuning = core.rounded(torch.tanh,
                                    self.layer(extended_pitch / MIDI_NORM))
            if global_detuning is not None:
                detuning = detuning + core.rounded(torch.tanh,
                                                   global_detuning)
            extended_pitch = extended_pitch + detuning
        return core.midi_to_hz(extended_pitch)


class JointParametricInharmTuning(nn.DictModule):
    """Per-instrument parametric inharmonicity + Railsback detuning with
    frozen pretrained parameters; one f0 per voice (one substring)."""

    input_keys = ('extended_pitch', 'piano_model')
    output_keys = ('f0_hz', 'inharm_coef')

    WEIGHT_NAMES = ('alpha_b', 'beta_b', 'alpha_t', 'beta_t', 'pitch_ref',
                    'K', 'alpha')

    def __init__(self, n_instruments=10, pretrained_weights=None):
        super().__init__()
        self.pretrained_weights = pretrained_weights
        for w in self.WEIGHT_NAMES:
            self.add_module(w, nn.Embedding(n_instruments, 1))

    def reset_parameters(self, generator: torch.Generator):
        if self.pretrained_weights is None:
            return
        with torch.no_grad():
            for w in self.WEIGHT_NAMES:
                emb = getattr(self, w).embeddings
                emb.copy_(torch.tensor(self.pretrained_weights[w],
                                       dtype=torch.float32))

    def _lookup(self, name, piano_model):
        return getattr(self, name)(piano_model)

    def get_inharm(self, pitch, piano_model):
        bass = (self._lookup('alpha_b', piano_model) * pitch
                + self._lookup('beta_b', piano_model))
        treble = (self._lookup('alpha_t', piano_model) * pitch
                  + self._lookup('beta_t', piano_model))
        return core.rounded(torch.exp, bass) + core.rounded(torch.exp, treble)

    def get_deviation_from_ET(self, pitch, piano_model):
        ref = self._lookup('pitch_ref', piano_model)
        ratio = core.midi_to_hz(pitch) / core.midi_to_hz(ref)
        rho = 1.0 + self._lookup('K', piano_model) * (
            (1.0 - core.rounded(torch.tanh, (pitch - ref)
                                / self._lookup('alpha', piano_model))) / 2.0)
        detuning = 1.0 + self.get_inharm(ref, piano_model) * (
            ratio * rho) ** 2
        detuning = detuning / (
            1.0 + self.get_inharm(pitch, piano_model) * rho ** 2)
        return core.rounded(torch.sqrt, detuning)

    def forward(self, extended_pitch, piano_model):
        extended_pitch = core.f32(extended_pitch)
        inharm_coef = self.get_inharm(extended_pitch, piano_model)
        detuning = self.get_deviation_from_ET(extended_pitch, piano_model)
        return core.midi_to_hz(extended_pitch) * detuning, inharm_coef


class F0ProcessorCell(tnn.Module):
    """Holds the note-release parameter (release_duration, seconds)."""

    def __init__(self, frame_rate=250):
        super().__init__()
        self.frame_rate = frame_rate
        self.release_duration = tnn.Parameter(torch.tensor(1.1))

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.release_duration.fill_(1.1)

    def threshold(self) -> torch.Tensor:
        """release_duration * frame_rate, in float32 as sub_modules.py:927
        computes it: the kernel's ties depend on this exact value."""
        return (self.release_duration * self.frame_rate).reshape(1)


class NoteRelease(nn.DictModule):
    """Extend active pitch conditioning through the release."""

    input_keys = ('conditioning',)
    output_keys = ('extended_pitch',)

    def __init__(self, frame_rate=250):
        super().__init__()
        self.cell = F0ProcessorCell(frame_rate=frame_rate)

    def forward(self, conditioning, initial_state: Optional[torch.Tensor]
                = None, return_state: bool = False):
        """(b, t, 2) conditioning -> (b, t, 1) extended pitch; with
        ``return_state`` also the final (b, 2) [held note, release steps],
        which streaming synthesis carries into the next chunk."""
        active_pitch = conditioning[..., 0:1]                 # (b, t, 1)
        b = active_pitch.shape[0]
        x = active_pitch.transpose(0, 1).contiguous()         # (t, b, 1)
        state0 = (active_pitch.new_zeros((b, 2)) if initial_state is None
                  else initial_state)
        ys, state = note_release_scan(x, self.cell.threshold(), state0)
        if return_state:
            return ys.transpose(0, 1), state
        return ys.transpose(0, 1)
