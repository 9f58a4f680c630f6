"""Streaming (chunked) synthesis with carried state.

Counterpart of ddsp_piano_tpu/models/streaming.py. A long file renders
chunk by chunk at a fixed chunk length, so the card holds one chunk's
(voice, frame, partial) controls and audio at a time instead of the whole
file's. Between chunks the driver carries:

- the GRU hidden states of the context and monophonic networks (K2's h0),
- the NoteRelease state [held note, release steps] (K3's state0),
- the surrogate synth's frames since the last onset,
- the oscillator phase of every (voice, partial), in float64, with one
  frame of control lookahead so that chunk boundaries are sample-exact
  (K1's, or K8's, phase0 offset by it),
- the reverb's convolution tail (ir_len - 1 samples), overlap-added into
  the following chunks. The reverb's IR (a learned one, the v2 FDN's from
  its embeddings, or the ENSTDkCl models' standalone trainable FDN's) is
  made once a render, not once a chunk.

The v2 networks normalise per step (Keras LayerNormalization) and stream
exactly. The ``Normalize`` layers (dafx22, the ENSTDkCl models, the
surrogate) pool their statistics over the whole sequence: with
``exact_normalize`` (the default) the driver first sweeps the file once
per Normalize layer, through the control path only, for the whole-file
mean and variance, then renders every chunk with them fixed; without it
each chunk normalises with its own statistics (faster, approximate).
The filtered-noise synth is chunk-local (its FIR edges at chunk
boundaries sit at the noise floor), as is the surrogate synth's decay
envelope, whose time base is the carried onset counter.

Noise: each chunk draws from one explicit ``torch.Generator`` (advanced
chunk by chunk), or the caller passes the draws: one full-length
(n_synths * b, n_frames * up) tensor that the driver slices to each
chunk's rendered window (so a streamed and a one-shot render can share a
draw), or a list with one draw per chunk, the flush last (the JAX
package's per-chunk draws, for the tests).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from ddsp_piano_torch import nn
from ddsp_piano_torch.models import sub_modules as sm
from ddsp_piano_torch.models.dag import VectorizedPolyphonicProcessorGroup
from ddsp_piano_torch.ops import core, oscillator
from ddsp_piano_torch.processors.reverb import Reverb
from ddsp_piano_torch.processors.surrogate import (SurrogateAdditive,
                                                   render_decay)

Noise = Union[None, torch.Tensor, Sequence[torch.Tensor]]


class StreamingSynthesizer:
    """Chunked inference driver for a PianoModel with the vectorized
    processor group.

    Args:
        model: the PianoModel (its device is the render's).
        chunk_frames: frames per chunk.
        exact_normalize: whole-file statistics for the Normalize layers
            (a control-path sweep per layer first); False normalises each
            chunk with its own.
    """

    def __init__(self, model, chunk_frames: int = 250,
                 exact_normalize: bool = True):
        group = model.processor_group
        if not isinstance(group, VectorizedPolyphonicProcessorGroup):
            raise ValueError("Streaming requires the vectorized polyphonic "
                             "processor group.")
        if chunk_frames < 1:
            raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
        self.model = model
        self.chunk_frames = int(chunk_frames)
        self.exact_normalize = exact_normalize
        # (ir_len, fft_len, add_dry) of the reverb operator, set by
        # _static_features.
        self._reverb_meta = None
        self._norm_slots = self._find_norm_slots()

    def _find_norm_slots(self):
        """[('context' | 'mono', layer index)] of the whole-sequence
        Normalize layers in the streamed layer lists, in dataflow order
        (every context slot feeds the mono network)."""
        slots = []
        ctx = self.model.context_network
        if isinstance(ctx, (sm.ContextNetwork, sm.SimpleContextNet)):
            slots += [('context', i) for i, layer in enumerate(ctx.model)
                      if isinstance(layer, nn.Normalize)]
        mono = self.model.monophonic_network
        if isinstance(mono, sm.MonophonicNetwork):
            slots += [('mono', i) for i, layer in enumerate(mono.model)
                      if isinstance(layer, nn.Normalize)]
        return slots

    # -- the networks, with carried state ----------------------------------

    def _context_forward(self, features, states, norm_stats=None,
                         stop_after=None):
        """Context network with threaded GRU state: (context, new_states,
        prenorm); with ``stop_after`` the chain ends at that Normalize
        slot's input capture and ``context`` is None."""
        ctx = self.model.context_network
        if isinstance(ctx, sm.FiLMContextNetwork):
            conditioning = sm._collapse_last_axis(
                sm._norm_conditioning(features['conditioning']))
            cond_feat = ctx.conditioning_head(conditioning)
            pedal_feat = ctx.pedal_head(features['pedal'])
            piano_feat = ctx.piano_id_head(features['piano_model'])
            x, new_states = nn.apply_with_state(
                ctx.main_model, torch.cat([cond_feat, pedal_feat], dim=-1),
                states)
            coef, bias = torch.chunk(ctx.film_input_reshape(piano_feat), 2,
                                     dim=-1)
            return ctx.output_layer(x * coef + bias), new_states, {}
        if isinstance(ctx, sm.SimpleContextNet):
            x, new_states, prenorm = nn.apply_stream(
                ctx.model, features['pedal'], states, norm_stats=norm_stats,
                stop_after=stop_after)
            if stop_after is not None:
                return None, new_states, prenorm
            return (ctx.film(ctx.dense_out(x), features.get('z')),
                    new_states, prenorm)
        x = ctx._inputs(features['conditioning'], features['pedal'],
                        features['z'])
        x, new_states, prenorm = nn.apply_stream(
            ctx.model, x, states, norm_stats=norm_stats,
            stop_after=stop_after)
        if stop_after is not None:
            return None, new_states, prenorm
        outs = nn.split_to_dict(ctx.dense_out(x), ctx.output_splits)
        return outs['context'], new_states, prenorm

    def _mono_net_forward(self, conditioning, extended_pitch, context,
                          states, norm_stats=None, stop_after=None):
        """Monophonic network with threaded GRU state: (outputs dict,
        new_states, prenorm), outputs None with ``stop_after``."""
        mono = self.model.monophonic_network
        if isinstance(mono, sm.MonophonicDeepNetwork):
            xp = mono.input_stacks[0](extended_pitch / sm.MIDI_NORM)
            xc = mono.input_stacks[1](sm._norm_conditioning(conditioning))
            xz = mono.input_stacks[2](context)
            x, h = mono.model(torch.cat([xp, xc, xz], dim=-1),
                              initial_state=states[0] if states else None,
                              return_state=True)
            new_states = [h]
            x = mono.out_stack(torch.cat([xp, xc, xz, x], dim=-1))
            prenorm = {}
        else:
            x = mono._inputs(conditioning, extended_pitch, context)
            x, new_states, prenorm = nn.apply_stream(
                mono.model, x, states, norm_stats=norm_stats,
                stop_after=stop_after)
            if stop_after is not None:
                return None, new_states, prenorm
        return (nn.split_to_dict(mono.dense_out(x), mono.output_splits),
                new_states, prenorm)

    def _global_z(self, features) -> None:
        """The z encoder's constant embeddings, resampled to the chunk's
        frame count (in place)."""
        model = self.model
        if model.z_encoder is None:
            return
        z, gi, gd = model.z_encoder(features['piano_model'])
        n_frames = features['conditioning'].shape[1]
        features['z'] = core.resample(z[:, :1], n_frames)
        features['global_inharm'] = core.resample(gi[:, :1], n_frames)
        features['global_detuning'] = core.resample(gd[:, :1], n_frames)

    # -- one chunk ------------------------------------------------------------

    def _chunk_forward(self, features, state: Dict[str, Any],
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None):
        """One chunk: features (b, C, ...) -> ((audio, dry mix), new state).

        Chunk protocol: with a carried previous frame this chunk renders
        frames [kC - 1, (k + 1) C - 1), C frames; the first chunk of
        :meth:`synthesize` has none and renders [0, C - 1). With
        ``state['first']`` (:meth:`synthesize_scanned`'s uniform chunks)
        the first chunk renders C frames whose first duplicates frame 0:
        its phase advance is cancelled and its samples silenced, and the
        driver drops them."""
        model = self.model
        group = model.processor_group
        n_synths = model.n_synths
        batch = features['conditioning'].shape[0]
        up = group.additive.upsampling
        sample_rate = group.additive.sample_rate

        feats = dict(features)
        self._global_z(feats)
        norm_stats = features.get('_norm_stats') or {}
        context, ctx_states, _ = self._context_forward(
            feats, state.get('context_states'),
            norm_stats=norm_stats.get('context'))
        feats['context'] = context
        if model.background_noise_model is not None:
            feats.update(model.background_noise_model.apply_features(feats))
        feats = model.parallelizer.parallelize(feats)
        extended, nr_state = model.note_release(
            feats['conditioning'],
            initial_state=state.get('note_release_state'), return_state=True)
        feats['extended_pitch'] = extended
        for slot in ('inharm_model', 'detuner'):
            module = getattr(model, slot)
            if module is not None:
                feats.update(module.apply_features(feats))
        mono_outs, mono_states, _ = self._mono_net_forward(
            feats['conditioning'], extended, feats['context'],
            state.get('mono_states'), norm_stats=norm_stats.get('mono'))
        feats.update(mono_outs)
        surrogate_time = None
        if model.surrogate_module is not None:
            # The frames-since-onset counter, carried across chunks.
            feats['decays'], feats['decay_time'], surrogate_time = (
                model.surrogate_module(
                    feats['conditioning'], extended,
                    initial_state=state.get('surrogate_time'),
                    return_state=True))
        if model.harmonic_masking is not None:
            feats.update(model.harmonic_masking.apply_features(feats))

        # Synthesis over the window [previous frame, this chunk's frames];
        # the last frame is only the interpolation endpoint.
        ctrl_keys = group.additive_controls + group.noise_controls
        now = {k: feats[k] for k in ctrl_keys}
        prev = state.get('prev_controls')
        first = bool(state.get('first', False))
        if first:
            prev = {k: v[:, :1] for k, v in now.items()}
        windowed = (now if prev is None else
                    {k: torch.cat([prev[k], now[k]], dim=1)
                     for k in ctrl_keys})
        new_prev = {k: v[:, -1:] for k, v in now.items()}

        controls = group.additive.get_controls(
            *(windowed[k] for k in group.additive_controls))
        surrogate = isinstance(group.additive, SurrogateAdditive)
        fold = (group.additive.fold_controls if surrogate
                else group.additive.fold_substrings)
        freqs, amps = fold(controls['amplitudes'],
                           controls['harmonic_distribution'],
                           controls['harmonic_shifts'], controls['f0_hz'])
        initial_phase = state.get('osc_phase')
        if first:
            # Start the duplicated frame one advance early, so that frame 0
            # starts at phase 0 as in the one-shot render.
            initial_phase = -oscillator.phase_increments(
                freqs[:, :1], freqs[:, :1], up, sample_rate)
        osc = oscillator.framewise_osc_controls(
            freqs, amps, up, sample_rate, initial_phase=initial_phase,
            lookahead=True)
        if surrogate:
            # The decay envelope is frame-local: its controls align with
            # the rendered frames (the lookahead endpoint dropped).
            sig_add = render_decay(
                osc, controls['decays'][:, :-1],
                controls['decay_time'][:, :-1], up, sample_rate)
        else:
            sig_add = group.additive.render(osc)
        new_phase = oscillator.framewise_final_phase(
            osc, up, sample_rate, initial_phase=initial_phase)

        noise_ctrl = group.noise.get_controls(
            *(windowed[k][:, :-1] for k in group.noise_controls))
        sig_noise = group.noise.get_signal(**noise_ctrl, noise=noise,
                                           generator=generator)
        n_samples = sig_add.shape[-1]
        mix = (sig_add + sig_noise).reshape(n_synths, batch,
                                            n_samples).sum(dim=0)
        if first:
            # The duplicated frame's samples: silent, so that they reach
            # neither the reverb nor its carried tail.
            mix = torch.cat([torch.zeros_like(mix[:, :up]), mix[:, up:]],
                            dim=1)

        audio, new_tail = mix, state.get('reverb_tail')
        if group.reverb is not None:
            audio, new_tail = self._reverb_chunk(
                features['_reverb_ir_fft'], mix, new_tail)

        new_state = {
            'context_states': ctx_states,
            'mono_states': mono_states,
            'note_release_state': nr_state,
            'osc_phase': new_phase,
            'prev_controls': new_prev,
            'reverb_tail': new_tail,
        }
        if surrogate_time is not None:
            new_state['surrogate_time'] = surrogate_time
        return (audio, mix), new_state

    def _reverb_chunk(self, ir_fft, mix, tail):
        """The chunk's full linear convolution with the IR's spectrum: the
        first n samples plus the carried tail, and the new tail (the
        unconsumed old tail shifted, plus this chunk's spill)."""
        n_samples = mix.shape[-1]
        ir_len, fft_len, add_dry = self._reverb_meta
        wet = torch.fft.irfft(torch.fft.rfft(mix, n=fft_len) * ir_fft,
                              n=fft_len)[:, :n_samples + ir_len - 1]
        tail_len = ir_len - 1
        if tail is None:
            tail = mix.new_zeros((mix.shape[0], tail_len))
        audio = wet[:, :n_samples].clone()
        used = min(tail_len, n_samples)
        audio[:, :used] += tail[:, :used]
        carry = mix.new_zeros((mix.shape[0], tail_len))
        if tail_len > n_samples:
            carry[:, :tail_len - n_samples] = tail[:, n_samples:]
        new_tail = carry + wet[:, n_samples:]
        if add_dry:
            audio = audio + mix
        return audio, new_tail

    # -- whole-file Normalize statistics ------------------------------------

    def _stats_chunk(self, features, states, stats, net, idx):
        """The control path of one chunk up to Normalize slot (net, idx):
        (per-row sum, per-row sum of squares, new states), in float64;
        ``stats`` fixes every earlier slot's statistics."""
        model = self.model
        feats = dict(features)
        self._global_z(feats)
        if net == 'context':
            _, ctx_states, prenorm = self._context_forward(
                feats, states['context'], norm_stats=stats.get('context'),
                stop_after=idx)
            new_states = {'context': ctx_states}
        else:
            context, ctx_states, _ = self._context_forward(
                feats, states['context'], norm_stats=stats.get('context'))
            feats['context'] = context
            feats = model.parallelizer.parallelize(feats)
            extended, nr_state = model.note_release(
                feats['conditioning'], initial_state=states['note_release'],
                return_state=True)
            _, mono_states, prenorm = self._mono_net_forward(
                feats['conditioning'], extended, feats['context'],
                states['mono'], norm_stats=stats.get('mono'), stop_after=idx)
            new_states = {'context': ctx_states, 'note_release': nr_state,
                          'mono': mono_states}
        x = prenorm[idx].double()
        axes = tuple(range(1, x.dim()))
        return (torch.sum(x, dim=axes), torch.sum(torch.square(x), dim=axes),
                new_states)

    def _one_stats_sweep(self, features, stats, net, idx, n_chunks):
        """Sweep the file once: (mean, var), each (rows, 1, 1) float32, of
        slot (net, idx)'s input over the whole file."""
        C = self.chunk_frames
        states = {'context': None, 'note_release': None, 'mono': None}
        s = ss = 0.0
        for i in range(n_chunks):
            chunk = {'conditioning': features['conditioning'][:, i * C:
                                                            (i + 1) * C],
                     'pedal': features['pedal'][:, i * C:(i + 1) * C],
                     'piano_model': features['piano_model']}
            s_i, ss_i, new_states = self._stats_chunk(chunk, states, stats,
                                                      net, idx)
            states.update(new_states)
            s, ss = s + s_i, ss + ss_i
        n = self._stats_count(net, idx) * n_chunks
        mean = s / n
        var = torch.clamp(ss / n - torch.square(mean), min=0.0)
        return mean.float()[:, None, None], var.float()[:, None, None]

    def _stats_count(self, net, idx) -> float:
        """Elements a chunk gives slot (net, idx) in one row."""
        module = (self.model.context_network if net == 'context'
                  else self.model.monophonic_network)
        return float(self.chunk_frames * module.model[idx].features)

    def _norm_stats_all(self, features, n_chunks):
        """{net: {index: (mean, var)}} of every Normalize slot, in dataflow
        order (each sweep fixes the statistics of the slots before it)."""
        stats: Dict[str, Dict[int, Any]] = {}
        for net, idx in self._norm_slots:
            stats.setdefault(net, {})[idx] = self._one_stats_sweep(
                features, stats, net, idx, n_chunks)
        return stats

    # -- loop-invariant features ----------------------------------------------

    def _static_features(self, features) -> Dict[str, Any]:
        """The reverb IR and its spectrum: the reverb models read the piano
        model only and the standalone FDN its own parameters, so they are
        computed once a render, not once a chunk."""
        model = self.model
        static: Dict[str, Any] = {}
        if model.reverb_model is not None:
            static.update(model.reverb_model.apply_features(
                {'piano_model': features['piano_model']}))
        if model.processor_group.reverb is not None:
            static['_reverb_ir_fft'] = self._reverb_operator(static)
        return static

    def _reverb_operator(self, static: Dict[str, Any]) -> torch.Tensor:
        """The chunk-invariant spectrum of the reverb's IR: a supplied IR,
        dry tap masked, or the standalone trainable FDN's IR, synthesised
        here once (its get_signal adds no dry path). Records (ir_len,
        fft_len, add_dry) in ``_reverb_meta``."""
        group = self.model.processor_group
        rev = group.reverb
        if isinstance(rev, Reverb):
            ir = Reverb.mask_dry_ir(
                core.f32(static[group.reverb_controls[0]]))
            add_dry = rev.add_dry
        else:
            ir = core.f32(rev.trained_ir())
            add_dry = False
        n_samples = self.chunk_frames * group.additive.upsampling
        ir_len = ir.shape[-1]
        fft_len = _fft_length(n_samples + ir_len - 1)
        self._reverb_meta = (ir_len, fft_len, add_dry)
        return torch.fft.rfft(ir, n=fft_len)

    # -- drivers --------------------------------------------------------------

    def _prepare(self, features):
        C = self.chunk_frames
        total = features['conditioning'].shape[1]
        if total % C != 0:
            raise ValueError(f"total frames {total} must be divisible by "
                             f"chunk_frames {C}")
        static = self._static_features(features)
        if self.exact_normalize and self._norm_slots:
            static['_norm_stats'] = self._norm_stats_all(features, total // C)
        return total, static

    def _chunk_features(self, features, static, start):
        C = self.chunk_frames
        return {'conditioning': features['conditioning'][:, start:start + C],
                'pedal': features['pedal'][:, start:start + C],
                'piano_model': features['piano_model'], **static}

    def _flush_features(self, features, static):
        """A chunk of the last frame repeated: it renders the final frame
        with a clamped interpolation endpoint."""
        C = self.chunk_frames
        last = lambda k: features[k][:, -1:].expand(
            -1, C, *features[k].shape[2:])
        return {'conditioning': last('conditioning'), 'pedal': last('pedal'),
                'piano_model': features['piano_model'], **static}

    def _chunk_noise(self, noise: Noise, index: int, first_frame: int,
                     n_frames: int) -> Optional[torch.Tensor]:
        """The draw of chunk ``index``, which renders ``n_frames`` frames
        from ``first_frame``: None, the caller's per-chunk draw, or the
        window of a full-length draw (zeros outside the file)."""
        if noise is None:
            return None
        if not isinstance(noise, torch.Tensor):
            return noise[index]
        up = self.model.processor_group.additive.upsampling
        lo, hi = first_frame * up, (first_frame + n_frames) * up
        total = noise.shape[-1]
        piece = noise[:, max(lo, 0):min(hi, total)]
        return F.pad(piece, (max(0, -lo), max(0, hi - total)))

    def _generator(self, noise: Noise, generator):
        if noise is None and generator is None:
            return torch.Generator(device=self.model.device).manual_seed(0)
        return generator

    def synthesize(self, features: Dict[str, Any], noise: Noise = None,
                   generator: Optional[torch.Generator] = None,
                   return_dry: bool = False):
        """Render a full-length features dict chunk by chunk.

        features: conditioning (1, T, n_synths, 2), pedal (1, T, 4),
        piano_model (1, 1), T a multiple of chunk_frames. Returns (1, T up)
        audio on the model's device, sample-aligned with the one-shot
        forward (the lookahead does not delay the output); the final frame
        is flushed with a clamped interpolation endpoint. With return_dry,
        (audio, dry mix). The first chunk renders C - 1 frames."""
        C = self.chunk_frames
        total, static = self._prepare(features)
        generator = self._generator(noise, generator)
        state: Dict[str, Any] = {}
        chunks: List[torch.Tensor] = []
        dry_chunks: List[torch.Tensor] = []
        for i, start in enumerate(range(0, total, C)):
            first_frame, n_frames = (0, C - 1) if i == 0 else (start - 1, C)
            (audio, dry), state = self._chunk_forward(
                self._chunk_features(features, static, start), state,
                self._chunk_noise(noise, i, first_frame, n_frames), generator)
            chunks.append(audio)
            dry_chunks.append(dry)
        (audio, dry), _ = self._chunk_forward(
            self._flush_features(features, static), state,
            self._chunk_noise(noise, total // C, total - 1, C), generator)
        up = audio.shape[-1] // C
        chunks.append(audio[:, :up])
        dry_chunks.append(dry[:, :up])
        out = torch.cat(chunks, dim=1)
        if not return_dry:
            return out
        return out, torch.cat(dry_chunks, dim=1)

    def _zero_state(self, features, static) -> Dict[str, Any]:
        """The carried state before the first uniform chunk: zeros of the
        state's shapes, read from the modules (no chunk runs to find them),
        and ``first``."""
        model = self.model
        group = model.processor_group
        device = model.device
        batch = features['conditioning'].shape[0]
        rows = model.n_synths * batch
        zeros = lambda *shape, dtype=torch.float32: torch.zeros(
            shape, dtype=dtype, device=device)

        def gru_states(sequential, n):
            return [zeros(n, layer.units) if isinstance(layer, nn.GRU)
                    else None for layer in sequential]

        ctx = model.context_network
        ctx_layers = (ctx.main_model if isinstance(ctx, sm.FiLMContextNetwork)
                      else ctx.model)
        mono = model.monophonic_network
        mono_states = ([zeros(rows, mono.model.units)]
                       if isinstance(mono, sm.MonophonicDeepNetwork)
                       else gru_states(mono.model, rows))
        widths = dict(mono.output_splits)
        f0_module = (model.detuner if model.detuner is not None
                     else model.inharm_model)
        n_substrings = (f0_module.layer.kernel.shape[-1]
                        if isinstance(f0_module, sm.Detuner) else 1)
        widths.update(inharm_coef=1, f0_hz=n_substrings)
        if model.surrogate_module is not None:
            widths.update(decays=widths['harmonic_distribution'],
                          decay_time=1)
        n_partials = widths['harmonic_distribution'] * n_substrings
        state = {
            'context_states': gru_states(ctx_layers, batch),
            'mono_states': mono_states,
            'note_release_state': zeros(rows, 2),
            'osc_phase': zeros(rows, 1, n_partials, dtype=torch.float64),
            'prev_controls': {
                k: zeros(rows, 1, widths[k])
                for k in group.additive_controls + group.noise_controls},
            'reverb_tail': None,
            'first': True,
        }
        if model.surrogate_module is not None:
            state['surrogate_time'] = zeros(rows, 1, 1)
        if group.reverb is not None:
            state['reverb_tail'] = zeros(batch, self._reverb_meta[0] - 1)
        return state

    def synthesize_scanned(self, features: Dict[str, Any], noise: Noise = None,
                           generator: Optional[torch.Generator] = None,
                           return_dry: bool = False):
        """The same render over uniform C-frame chunks (the JAX package's
        lax.scan driver): the first chunk renders a duplicate of frame 0
        ahead of its frames, which is dropped. Same arguments and output
        as :meth:`synthesize`."""
        C = self.chunk_frames
        total, static = self._prepare(features)
        generator = self._generator(noise, generator)
        state = self._zero_state(features, static)
        n_chunks = total // C
        chunks: List[torch.Tensor] = []
        dry_chunks: List[torch.Tensor] = []
        for i in range(n_chunks):
            (audio, dry), state = self._chunk_forward(
                self._chunk_features(features, static, i * C), state,
                self._chunk_noise(noise, i, i * C - 1, C), generator)
            chunks.append(audio)
            dry_chunks.append(dry)
        (audio, dry), _ = self._chunk_forward(
            self._flush_features(features, static), state,
            self._chunk_noise(noise, n_chunks, total - 1, C), generator)
        up = audio.shape[-1] // C
        out = torch.cat(chunks + [audio[:, :up]], dim=1)[:, up:]
        if not return_dry:
            return out
        return out, torch.cat(dry_chunks + [dry[:, :up]], dim=1)[:, up:]


def pad_to_chunks(features: Dict[str, Any], chunk_frames: int
                  ) -> Dict[str, Any]:
    """The features with conditioning and pedal right-padded with silence
    to a whole number of chunks."""
    pad = -features['conditioning'].shape[1] % chunk_frames
    out = dict(features)
    for k in ('conditioning', 'pedal'):
        x = features[k]
        out[k] = torch.cat([x, x.new_zeros((x.shape[0], pad)
                                           + tuple(x.shape[2:]))], dim=1)
    return out


def _fft_length(n: int) -> int:
    return int(2 ** math.ceil(math.log2(n)))
