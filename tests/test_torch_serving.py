"""Serving and the CSV CLI, JAX package vs port, on the CPU.

The device allocator's plain version (data/midi_encoders_device.py,
kernels/voice_allocator.py) bit for bit against the JAX package's
roll_to_conditioning_jax on seeded rolls: binary within and over capacity
at 4 and 16 voices, non-binary (the key * active collisions on which JAX
diverges from the host allocator) and sparse (fewer active keys than
voices: the stable sort's ties). K9's schedule (classify, walk the
frames the skip rule does not skip, fill) emulated in plain torch, bit
for bit against the plain loop. make_serving_fn against the port's
forward on the host allocator's conditioning (bit-equal) and against the
JAX package's make_serving_fn (1.1e-4 of peak, JAX's draw injected), and
synthesize_from_csv: its files, the missing-column error and the
--decompose stems against the JAX CLI's per-voice sums. Models at 4 voices,
16 harmonics and 0.5 s.
"""

import csv
import os

import numpy as np
import pytest
import threadpoolctl

torch = pytest.importorskip('torch')
torch.set_num_threads(1)
# numpy's BLAS too, for the whole worker (xdist collects every file):
# threaded OpenBLAS stalls at each call's barrier on a loaded host.
threadpoolctl.threadpool_limits(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ddsp_piano_torch import configs  # noqa: E402
from ddsp_piano_torch import synthesize_from_csv as csv_cli  # noqa: E402
from ddsp_piano_torch.data import audio_io  # noqa: E402
from ddsp_piano_torch.data.io import load_midi_as_conditioning  # noqa: E402
from ddsp_piano_torch.data.midi_encoders import (  # noqa: E402
    MIDIRoll2Conditioning)
from ddsp_piano_torch.data.rolls import (  # noqa: E402
    churn_roll, held_notes_roll, odd_voices)
from ddsp_piano_torch.data.midi_encoders_device import (  # noqa: E402
    roll_to_conditioning_device, top_voices)
from ddsp_piano_torch.kernels import voice_allocator as tva  # noqa: E402
from ddsp_piano_torch.models.serving import make_serving_fn  # noqa: E402
from ddsp_piano_torch.params import load_jax_params  # noqa: E402
from ddsp_piano_tpu.data.midi_encoders_jax import (  # noqa: E402
    roll_to_conditioning_jax)

EXAMPLES = os.path.join(os.path.dirname(__file__), '..', 'examples')
SMALL = {'n_synths': 4, 'n_harmonics': 16, 'n_noise_bands': 16}
FRAMES = 125
# Against the JAX package's render: 1.1e-4 of peak (ROADMAP C.2, the
# floor of its float32 phase cumsum).
RENDER_TOL = 1.1e-4


# -- rolls --------------------------------------------------------------------


def _non_binary_roll(seed):
    """Active values in {0.5, 1, 2, 3} (dyadic or small, so the
    polyphony sums are exact) and key 21 at 2.0 colliding with key 42's
    pitch (21 * 2 == 42), which make_serving_fn binarizes away."""
    roll = held_notes_roll(seed, 150, density=70)
    scale = np.random.RandomState(seed).choice(
        np.float32([0.5, 1.0, 2.0, 3.0]), size=roll.shape[:2])
    roll[..., 0] *= scale
    roll[:, [0, 21], 0] = 1.0
    roll[40:, 0, 0] = 2.0
    roll[:, [0, 21], 1] = 0.5
    return roll


def _sparse_roll(seed):
    """At most 3 active keys, and velocities on silent keys: which of
    the tied zero entries fill the top n decides the output."""
    rng = np.random.RandomState(seed)
    roll = np.zeros((60, 88, 2), np.float32)
    roll[..., 1] = rng.rand(60, 88)
    for key, (s, e) in zip(rng.choice(88, 3, replace=False),
                           [(0, 30), (10, 50), (25, 60)]):
        roll[s:e, key, 0] = 1.0
    return roll


ROLLS = {
    'binary': lambda seed, n: held_notes_roll(seed, 150),
    'over_capacity': lambda seed, n: churn_roll(seed, n, 40),
    'non_binary': lambda seed, n: _non_binary_roll(seed),
    'sparse': lambda seed, n: _sparse_roll(seed),
}


@pytest.mark.parametrize('kind,n', [('binary', 4), ('binary', 16),
                                    ('over_capacity', 4),
                                    ('over_capacity', 16),
                                    ('non_binary', 4), ('non_binary', 16),
                                    ('sparse', 16)])
def test_plain_allocator_matches_jax(kind, n):
    """Three rows in one batch, each against roll_to_conditioning_jax on
    its own: conditioning and polyphony bit for bit."""
    rolls = [ROLLS[kind](seed, n) for seed in (1, 2, 3)]
    frames = min(r.shape[0] for r in rolls)
    rolls = np.stack([r[:frames] for r in rolls])
    got_c, got_p = roll_to_conditioning_device(torch.from_numpy(rolls), n)
    assert got_c.shape == (3, frames, n, 2) and got_p.shape == (3, frames)
    fn = jax.jit(roll_to_conditioning_jax, static_argnums=1)
    for i, roll in enumerate(rolls):
        want_c, want_p = fn(roll, n)
        np.testing.assert_array_equal(got_c[i].numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_p[i].numpy(), np.asarray(want_p))
    if kind == 'over_capacity':
        assert (got_p > n).any()
    if kind == 'sparse':
        assert (got_p < n).all()
    if kind == 'non_binary':
        # The collision makes JAX (and the port) part from the host
        # allocator: the case serving binarizes away.
        host, _ = MIDIRoll2Conditioning(n)(rolls[0].copy())
        assert not np.array_equal(got_c[0].numpy(), host)


def test_top_voices_sort_ties_as_jax():
    """The stable ascending sort of active * key: with fewer active keys
    than voices the silent keys tie at 0 and fill the top n in key order,
    as jnp.argsort(stable=True) fills it; the velocities of those silent
    keys come along."""
    roll = np.stack([_sparse_roll(seed) for seed in (4, 5)])
    pitches, velocity = top_voices(torch.from_numpy(roll), 16)
    pitched = roll[..., 0] * np.arange(21, 109, dtype=np.float32)
    order = np.asarray(jnp.argsort(jnp.asarray(pitched), axis=-1,
                                   stable=True))[..., -16:]
    np.testing.assert_array_equal(
        pitches.numpy(), np.take_along_axis(pitched, order, -1))
    np.testing.assert_array_equal(
        velocity.numpy(), np.take_along_axis(roll[..., 1], order, -1))


def test_allocator_front_door():
    """CPU tensors take the plain loop; the CUDA wrapper raises on more
    voices than a warp has lanes and on CPU tensors, before any build."""
    p = torch.zeros(1, 5, 4)
    torch.testing.assert_close(tva.allocate(p, p), tva.allocate_plain(p, p),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match='CUDA tensors'):
        tva.allocate_cuda(p, p)
    wide = torch.zeros(1, 5, tva.MAX_VOICES + 1)
    with pytest.raises(ValueError, match='1 to 32 voices'):
        tva.allocate_cuda(wide, wide)
    with pytest.raises(ValueError, match=r'\(b, T, 88, 2\)'):
        roll_to_conditioning_device(torch.zeros(1, 5, 87, 2), 4)


def test_plain_allocator_counts_fast_frames():
    """allocate_plain(return_fast=True): each row's frames on the fast
    path (the note set of the table, after the first frame) and those K9's
    walk skips (equal to the frame before, whose table mirrors it), and
    the same conditioning as without it."""
    p = torch.zeros(2, 10, 4)
    p[:, :, 2:] = torch.tensor([60.0, 64.0])
    p[1, 5:, 1] = 55.0
    v = torch.rand(2, 10, 4, generator=torch.Generator().manual_seed(0))
    out, fast, skipped = tva.allocate_plain(p, v, return_fast=True)
    assert fast.tolist() == [9, 8]
    # After the slow frames 0 and 5 the tables mirror their frames.
    assert skipped.tolist() == [9, 8]
    torch.testing.assert_close(out, tva.allocate_plain(p, v), rtol=0, atol=0)


# -- K9's schedule, emulated --------------------------------------------------


def _word_bits(words):
    """(b, W) 32-bit words (int64) -> (b, 32 W) bools, bit k of word w at
    frame 32 w + k."""
    return ((words[..., None] >> torch.arange(32)) & 1).bool().flatten(-2)


def _emulate_k9(pitches, velocity, mirrors=True):
    """csrc/voice_allocator.cu's three stages in plain torch: classify
    (bit t of a row's words: frame t >= 1 equals frame t - 1), the walk
    (a row at a time: when the new table mirrors frame t jump to the next
    clear bit, else walk t + 1 with the pitches last loaded, clearing its
    bit; each walked frame's permutation, each word's anchor), then the
    fill (the last walked frame at or before t in t's word, else the
    previous word's anchor). ``mirrors=False`` drops the rule's condition
    that the table mirrors the frame before a skipped one. Returns (out,
    the skipped frames (b, T))."""
    b, t_max, n = pitches.shape
    words = -(-t_max // 32)
    same = torch.zeros(b, 32 * words, dtype=torch.bool)
    same[:, 1:t_max] = (pitches[:, 1:] == pitches[:, :-1]).all(2)
    mask = (same.view(b, words, 32).long() << torch.arange(32)).sum(2)
    perm = torch.zeros(b, t_max, n, dtype=torch.long)
    anchor = torch.full((b, words), -1)
    skipped = torch.zeros(b, t_max, dtype=torch.bool)
    for r in range(b):
        clear = iter(torch.nonzero(~_word_bits(mask[r])[:t_max])
                     .flatten().tolist())
        head = next(clear, t_max)
        state = (torch.zeros(1, n), torch.zeros(1, dtype=torch.long),
                 torch.arange(n)[None], torch.zeros(1, dtype=torch.bool))
        mirror, t, pitch = False, -1, None
        while True:
            jump = mirror if mirrors else t >= 0
            t_next = head if jump else t + 1
            if t >= 0:
                stop = t_next // 32 if t_next < t_max else words
                anchor[r, t // 32:stop] = t
            skipped[r, t + 1:t_next] = True
            if t_next >= t_max:
                break
            t = t_next
            if t == head:
                pitch = pitches[r, t][None]
                head = next(clear, t_max)
            else:
                mask[r, t // 32] &= ~(1 << (t % 32))
            state, _, _ = tva._frame_step(state, pitch, torch.zeros(1, n))
            perm[r, t] = state[2][0]
            mirror = bool(tva.mirrors(state[0], pitch))
    frames = torch.arange(32 * words)
    walked = ~_word_bits(mask)
    last = torch.where(walked, frames, -1).view(b, words, 32).cummax(2)[0]
    before = torch.cat([torch.full((b, 1), -1), anchor[:, :-1]], 1)
    w = torch.where(last >= 0, last, before[:, :, None]).view(b, -1)
    w = w[:, :t_max, None].expand(b, t_max, n)
    order = perm.gather(1, w)
    out = torch.stack([pitches.gather(2, order), velocity.gather(2, order)],
                      -1)
    return out, skipped


def _bits(x):
    return x.view(torch.int32)


def _k9_case(kind):
    if kind == 'held':
        rolls = np.stack([held_notes_roll(s, 400) for s in range(4)])
        return top_voices(torch.from_numpy(rolls), 16)
    if kind == 'churn':
        rolls = np.stack([churn_roll(s, 16, 64) for s in range(3)])
        return top_voices(torch.from_numpy(rolls), 16)
    seed, rows, frames, n = {'odd_4': (4, 3, 300, 4),
                             'odd_16': (16, 3, 300, 16),
                             'T1': (5, 3, 1, 16),
                             'T33': (6, 3, 33, 16)}[kind]
    return tuple(torch.from_numpy(a) for a in odd_voices(seed, rows, frames,
                                                         n))


@pytest.mark.parametrize('kind', ['held', 'churn', 'odd_4', 'odd_16', 'T1',
                                  'T33'])
def test_k9_schedule_matches_plain(kind):
    """K9's schedule (classify, walk with the skip rule, fill), emulated,
    bit for bit against the plain loop: held notes (400 frames, not a
    multiple of 32), over-capacity churn, unsorted frames with repeated
    pitches, 0.0, -0.0 and NaN at 4 and 16 voices, T = 1 and T = 33.
    Every frame the rule skips is one _frame_step takes on the fast path,
    and the plain version counts the skipped frames as the walk does."""
    pitches, velocity = _k9_case(kind)
    want, _, n_skipped = tva.allocate_plain(pitches, velocity,
                                            return_fast=True)
    got, skipped = _emulate_k9(pitches, velocity)
    assert torch.equal(_bits(got), _bits(want))
    assert skipped.sum(1).tolist() == n_skipped.tolist()
    b, t_max, n = pitches.shape
    state = (torch.zeros(b, n), torch.zeros(b, dtype=torch.long),
             torch.arange(n).expand(b, n), torch.zeros(b, dtype=torch.bool))
    for t in range(t_max):
        state, _, fast = tva._frame_step(state, pitches[:, t],
                                         velocity[:, t])
        assert bool((fast | ~skipped[:, t]).all()), t
    if kind in ('held', 'odd_4'):
        assert skipped.sum() > b * t_max // 3


def test_k9_schedule_needs_mirrors():
    """Skipping every frame equal to its predecessor, without the rule's
    condition that the table mirrors the frame before, is wrong: on the
    unsorted roll with repeated pitches at 4 voices a table after a slow
    frame need not mirror it (the overflow clamp), and the output
    differs."""
    pitches, velocity = _k9_case('odd_4')
    got, _ = _emulate_k9(pitches, velocity, mirrors=False)
    assert not torch.equal(_bits(got),
                           _bits(tva.allocate_plain(pitches, velocity)))


# -- serving ------------------------------------------------------------------


def _serving_roll():
    """Two rows: the random roll and an over-capacity one (4 voices),
    active values 0.7 (binarized by serving), 125 frames."""
    rolls = np.stack([held_notes_roll(6, FRAMES),
                      churn_roll(7, 4, FRAMES)])
    rolls[..., 0] *= 0.7
    return rolls


def _pedal_piano(b=2):
    pedal = np.zeros((b, FRAMES, 4), np.float32)
    pedal[:, 50:, 0] = 0.8
    return pedal, np.array([[3], [7]], np.int32)[:b]


@pytest.fixture(scope='module')
def v2_small():
    return configs.get_model('maestro_v2', inference=True, duration=0.5,
                             device='cpu', **SMALL)


def test_serving_equals_host_allocated_forward(v2_small):
    """serve on a (non-binary) roll equals the forward on the host
    allocator's conditioning of the binarized roll, bit for bit, with the
    same injected draw; without a draw each call re-seeds its generator
    (the JAX function's fixed key)."""
    model = v2_small
    rolls = _serving_roll()
    pedal, piano = _pedal_piano()
    binary = np.stack([(rolls[..., 0] > 0).astype(np.float32),
                       rolls[..., 1]], -1)
    cond = np.stack([MIDIRoll2Conditioning(4)(r.copy())[0] for r in binary])
    feats = {'conditioning': torch.from_numpy(cond.astype(np.float32)),
             'pedal': torch.from_numpy(pedal),
             'piano_model': torch.from_numpy(piano)}
    up = model.sample_rate // model.frame_rate
    noise = 2.0 * torch.rand(
        (4 * 2, FRAMES * up), generator=torch.Generator().manual_seed(1)) - 1
    serve = make_serving_fn(model, seed=5)
    got = serve(torch.from_numpy(rolls), pedal, piano, noise=noise)
    with torch.inference_mode():
        want = model(feats, noise=noise)['audio_synth']
        seeded = model(feats, generator=torch.Generator().manual_seed(5))
    assert got.shape == (2, FRAMES * up)
    assert want.abs().max() > 1e-3
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    first = serve(rolls, pedal, piano)
    torch.testing.assert_close(first, serve(rolls, pedal, piano), rtol=0,
                               atol=0)
    torch.testing.assert_close(first, seeded['audio_synth'], rtol=0, atol=0)


class _EagerServingJax:
    """The ``jax`` name of the JAX serving module with its jit the
    identity: the serving graph runs op by op, as the JAX render of
    tests/test_torch_render.py (jitted, XLA contracts the tuning's
    multiply-adds and moves partial frequencies by an ulp)."""

    @staticmethod
    def jit(fn, **_):
        return fn

    def __getattr__(self, name):
        return getattr(jax, name)


class _RoundedTanhJnp:
    """The ``jnp`` name of the JAX sub_modules with tanh evaluated in
    float64 and rounded once, as the port's tuning evaluates it
    (ops.core.rounded): the JAX package's float32 tanh on the CPU is off
    by an ulp at some arguments, and the v2 tuning's one-ulp f0 then
    moves a 0.5 s render by up to 8.8e-4 of peak (this file's serving
    roll, pitch 96 on piano 7; ROADMAP C.6). Traced calls get jnp's."""

    @staticmethod
    def tanh(x):
        if isinstance(x, jax.core.Tracer):
            return jnp.tanh(x)
        return jnp.asarray(np.tanh(np.asarray(x, np.float64)).astype(
            np.float32))

    def __getattr__(self, name):
        return getattr(jnp, name)


def _recording_noise(jmodel, draws):
    """Record every draw of the JAX model's noise synth."""
    noise = jmodel.processor_group.noise
    original = noise._noise

    def record(rng, batch, n_samples):
        x = original(rng, batch, n_samples)
        draws.append(torch.from_numpy(np.array(x)))
        return x

    noise._noise = record
    return lambda: setattr(noise, '_noise', original)


@pytest.fixture(scope='module')
def v2_pair():
    """The JAX v2 model at small widths, its PRNGKey(0) init and the port's
    model with those parameters."""
    from ddsp_piano_tpu.configs import get_model as jax_get_model

    jmodel = jax_get_model('maestro_v2', duration=0.5, inference=True,
                           **SMALL)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    # The networks, the FDN IR and the convolution run jitted (their
    # outputs carry no phase); the tuning, the additive synth and the
    # noise synth (whose draws the tests record) op by op
    # (tests/test_torch_configs.py's _render).
    for net in (jmodel.context_network, jmodel.monophonic_network,
                jmodel.reverb_model):
        net.apply = jax.jit(net.apply, static_argnames='training')
    reverb = jmodel.processor_group.reverb
    reverb.get_signal = jax.jit(reverb.get_signal)
    model = configs.get_model('maestro_v2', inference=True, duration=0.5,
                              device='cpu', **SMALL)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jmodel, params, model


def _peak_err(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def test_serving_matches_jax(v2_pair, monkeypatch):
    """make_serving_fn against the JAX package's, JAX's noise draw
    injected and its tuning's tanh correctly rounded (_RoundedTanhJnp):
    1.1e-4 of peak (measured 3.7e-5)."""
    from ddsp_piano_tpu.models import serving as jserving
    from ddsp_piano_tpu.models import sub_modules as jsm

    jmodel, params, model = v2_pair
    monkeypatch.setattr(jserving, 'jax', _EagerServingJax())
    monkeypatch.setattr(jsm, 'jnp', _RoundedTanhJnp())
    # One row: the shapes of test_decompose_stems_match_jax's forward, so
    # that the op-by-op JAX side compiles its operators once for both.
    rolls = _serving_roll()[:1]
    pedal, piano = _pedal_piano(b=1)
    draws = []
    restore = _recording_noise(jmodel, draws)
    try:
        want = jserving.make_serving_fn(jmodel, params, seed=3)(
            jnp.asarray(rolls), jnp.asarray(pedal), jnp.asarray(piano))
    finally:
        restore()
    assert len(draws) == 1
    got = make_serving_fn(model, seed=3)(rolls, pedal, piano,
                                         noise=draws[0])
    assert np.abs(np.asarray(want)).max() > 1e-3
    assert _peak_err(got, want) <= RENDER_TOL


# -- synthesize_from_csv ------------------------------------------------------


def _write_csv(path, rows, columns=csv_cli.REQUIRED_COLUMNS):
    with open(path, 'w', newline='') as f:
        writer = csv.writer(f)
        writer.writerow(columns)
        writer.writerows(rows)


@pytest.fixture
def small_models(monkeypatch):
    """configs.get_model at 4 voices, 16 harmonics (the CLI looks it up
    when it runs)."""
    original = configs.get_model
    monkeypatch.setattr(configs, 'get_model',
                        lambda *a, **k: original(*a, **{**SMALL, **k}))


def test_csv_cli_writes_each_row(tmp_path, small_models):
    """Two rows over examples/demo.mid: four files a row with --decompose,
    named <piano_model><last word of composer>, the warm-up cropped; the
    piano index is the row's piano_model among the column's sorted values,
    sorted as numbers (3 before 10)."""
    csv_file = str(tmp_path / 'perf.csv')
    _write_csv(csv_file, [('demo.mid', 10, 'Frédéric Chopin'),
                          ('demo.mid', 3, 'Johann Sebastian Bach')])
    out_dir = tmp_path / 'out'
    written = csv_cli.main(csv_cli.process_args(
        ['-d', '0.5', '-wu', '0.2', '--decompose', '--device', 'cpu',
         EXAMPLES, csv_file, str(out_dir)]))
    names = sorted(f'{stem}{suffix}.wav' for stem in ('10Chopin', '3Bach')
                   for suffix in ('', '_unreverbed', '_additive',
                                  '_substractive'))
    assert sorted(os.listdir(out_dir)) == names
    assert sorted(os.path.basename(p) for p in written) == names
    for path, audio in written.items():
        assert audio.shape == (12000,), path
        assert np.isfinite(audio).all(), path
        assert audio_io.read_wav(path)[0].shape[0] == 12000
    # Different pianos: indices 1 (10) and 0 (3) of the sorted column.
    chopin = written[str(out_dir / '10Chopin.wav')]
    bach = written[str(out_dir / '3Bach.wav')]
    assert not np.array_equal(chopin, bach)
    dry = written[str(out_dir / '3Bach_unreverbed.wav')]
    assert np.sqrt(np.mean(dry ** 2)) > 1e-4
    assert [r['piano_model'] for r in csv_cli.read_rows(csv_file)] == [10, 3]


def test_csv_cli_allocates_as_the_host():
    """The CLI's path, demo.mid's roll with the warm-up silence through the
    device allocator, gives load_midi_as_conditioning's conditioning and
    pedal bit for bit (16 voices, 3 s + 0.2 s)."""
    from ddsp_piano_torch.data.io import load_midi_as_roll

    demo = os.path.join(EXAMPLES, 'demo.mid')
    want = load_midi_as_conditioning(demo, duration=3.0,
                                     warm_up_duration=0.2)
    got = load_midi_as_roll(demo, duration=3.0, warm_up_duration=0.2)
    cond, _ = roll_to_conditioning_device(torch.from_numpy(got['roll']), 16)
    assert got['duration'] == want['duration']
    assert (want['conditioning'][..., 0] > 0).sum(-1).max() >= 3
    np.testing.assert_array_equal(cond.numpy(), want['conditioning'])
    np.testing.assert_array_equal(got['pedal'], want['pedal'])


def test_csv_cli_refuses_missing_columns(tmp_path):
    csv_file = str(tmp_path / 'maestro.csv')
    _write_csv(csv_file, [('a.midi', 'b.wav')],
               columns=('midi_filename', 'audio_filename'))
    with pytest.raises(SystemExit, match=r"missing columns \['canonical_"
                                         r"composer', 'mid_file', "
                                         r"'piano_model'\]"):
        csv_cli.main(csv_cli.process_args(
            ['--device', 'cpu', EXAMPLES, csv_file, str(tmp_path / 'o')]))


def test_decompose_stems_match_jax(v2_pair):
    """--decompose's stems from a forward's controls, against the JAX
    CLI's render_stems run op by op on the JAX forward's: _additive, the
    per-voice additive.apply sum, within the render tolerance; and
    _substractive, the per-voice noise with PRNGKey(i), its draws
    injected, within 1e-4 of peak (the magnitudes come from two float32
    networks)."""
    jmodel, params, model = v2_pair
    inputs = load_midi_as_conditioning(
        os.path.join(EXAMPLES, 'demo.mid'), n_synths=4, duration=0.3,
        warm_up_duration=0.2)
    feats = {'conditioning': inputs['conditioning'],
             'pedal': inputs['pedal'],
             'piano_model': np.array([[2]], np.int32)}
    draws = []
    restore = _recording_noise(jmodel, draws)
    try:
        jout = jmodel(params, {k: jnp.asarray(v) for k, v in feats.items()},
                      rng=jax.random.PRNGKey(0))
        group = jmodel.processor_group
        want_add, want_noise = 0.0, 0.0
        for i in range(4):
            want_add = want_add + group.additive.apply(
                {}, jout[f'amplitudes_{i}'],
                jout[f'harmonic_distribution_{i}'],
                jout[f'inharm_coef_{i}'], jout[f'f0_hz_{i}'])
            want_noise = want_noise + group.noise.apply(
                {}, jout[f'magnitudes_{i}'], rng=jax.random.PRNGKey(i))
    finally:
        restore()
    assert len(draws) == 5              # the forward's, then one a voice
    with torch.inference_mode():
        tout = model({k: torch.from_numpy(v) for k, v in feats.items()},
                     noise=draws[0])
        got_add, got_noise = csv_cli.render_stems(model, tout,
                                                  noise=draws[1:])
    assert got_add.shape == got_noise.shape == (1, 12000)
    assert _peak_err(got_add, want_add) <= RENDER_TOL
    assert _peak_err(got_noise, want_noise) <= 1e-4
