"""The training summaries: the port's TensorBoard event files against the
JAX package's tf.summary writer, and the train CLI's tags, on the CPU.

The same inputs go through the JAX SummaryWriter and the port's. TF's own
reader (tf.compat.v1.train.summary_iterator, which checks each record's
CRC) reads both files: the same (tag, step) sequence, float32-equal
scalars, byte-identical WAVs, equal image pixels. TensorBoard's
EventAccumulator loads the port's file, and the port's reader returns
what TF's returns. The images' numbers are held against JAX's:
the log-magnitude spectrogram within 1e-6, the tuning curves within 1e-6
of the ydata of JAX's matplotlib lines, for a dafx22-like model and a v2
model from JAX params.
"""

import glob
import os

import numpy as np
import pytest
import threadpoolctl

torch = pytest.importorskip('torch')
torch.set_num_threads(1)
# numpy's BLAS too, for the whole worker (xdist collects every file):
# threaded OpenBLAS stalls at each call's barrier on a loaded host.
threadpoolctl.threadpool_limits(1)

from ddsp_piano_torch.training import events  # noqa: E402
from ddsp_piano_torch.training import summaries  # noqa: E402
from test_torch_train_cli import cache, small  # noqa: E402,F401

tf = pytest.importorskip('tensorflow')


def _tf_records(path):
    """(tag, step, plugin, payload) of each summary value, by TF's reader:
    a float for a scalar, the WAV bytes for audio, the decoded pixels for
    an image."""
    out = []
    for e in tf.compat.v1.train.summary_iterator(path):
        for v in e.summary.value:
            plugin = v.metadata.plugin_data.plugin_name
            t = tf.make_ndarray(v.tensor)
            if plugin == 'scalars':
                payload = np.float32(t)
            elif plugin == 'audio':
                payload = [bytes(w) for w in t[:, 0]]
            else:
                payload = [tf.io.decode_png(p).numpy() for p in t[2:]]
            out.append((v.tag, e.step, plugin, payload))
    return out


def _write_both(tmp_path):
    """The same summaries through the JAX writer and the port's."""
    from ddsp_piano_tpu.training.summaries import SummaryWriter as JWriter

    rs = np.random.RandomState(0)
    loud = (rs.uniform(-1.7, 1.7, (6, 2000))).astype(np.float32)
    quiet = (0.3 * rs.uniform(-1.0, 1.0, (2, 1000))).astype(np.float32)
    quiet[0, :4] = [0.5, -0.5, 1.5 / 32768, -2.5 / 32768]   # roundf ties
    image = (rs.rand(5, 7, 3) * 255).astype(np.uint8)
    ramp = np.linspace(0.0, 1.0, 12, dtype=np.float32).reshape(3, 4, 1)
    paths = {}
    for name, cls in (('jax', JWriter), ('port', summaries.SummaryWriter)):
        w = cls(str(tmp_path / name))
        w.scalars('train_loss', {'audio_stft_loss': 3.25,
                                 'total_loss': np.float32(1.0) / 3}, 10)
        w.scalar('val_loss/total_loss', 2.0 ** -30, 0)
        w.audio('synthesized_audio', loud, 16000, 20)
        w.audio('synthesized_audio', quiet, 24000, 30, max_outputs=1)
        w.image('image', image, 40)
        w.image('ramp', ramp, -5)
        w.flush()
        paths[name] = glob.glob(str(tmp_path / name / '*tfevents*'))[0]
    return paths


def test_event_file_matches_tf_writer(tmp_path):
    paths = _write_both(tmp_path)
    want, got = _tf_records(paths['jax']), _tf_records(paths['port'])
    assert [r[:3] for r in got] == [r[:3] for r in want]
    for (tag, step, plugin, a), (_, _, _, b) in zip(got, want):
        if plugin == 'scalars':
            assert a == b, tag
        elif plugin == 'audio':
            assert a == b, (tag, step)
        else:
            assert len(a) == len(b) == 1
            np.testing.assert_array_equal(a[0], b[0])
    # The first record: the file version, as TF writes it.
    first = next(iter(tf.compat.v1.train.summary_iterator(paths['port'])))
    assert first.file_version == 'brain.Event:2'
    assert os.path.basename(paths['port']).startswith('events.out.tfevents.')


def test_event_file_loads_in_tensorboard_and_own_reader(tmp_path):
    from tensorboard.backend.event_processing import event_accumulator

    paths = _write_both(tmp_path)
    acc = event_accumulator.EventAccumulator(
        os.path.dirname(paths['port']), size_guidance={'tensors': 0})
    acc.Reload()
    tags = acc.Tags()['tensors']
    assert sorted(tags) == ['image', 'ramp', 'synthesized_audio',
                            'train_loss/audio_stft_loss',
                            'train_loss/total_loss', 'val_loss/total_loss']
    assert acc.SummaryMetadata('synthesized_audio').plugin_data.plugin_name \
        == 'audio'
    assert [e.step for e in acc.Tensors('synthesized_audio')] == [20, 30]
    # The port's reader returns what TF's reader returns.
    want = _tf_records(paths['port'])
    got = []
    evs = events.read_events(paths['port'])
    assert evs[0]['file_version'] == 'brain.Event:2'
    for e in evs[1:]:
        for v in e['values']:
            payload = events.value_array(v)
            if v['plugin_name'] == 'audio':
                payload = [wav for wav, _ in payload]
            elif v['plugin_name'] == 'images':
                payload = [events.decode_png(p) for p in payload]
            got.append((v['tag'], e['step'], v['plugin_name'], payload))
    assert [r[:3] for r in got] == [r[:3] for r in want]
    for a, b in zip(got, want):
        if a[2] == 'images':
            np.testing.assert_array_equal(a[3][0], b[3][0])
        else:
            assert a[3] == b[3]
    # A flipped byte fails the CRC.
    raw = bytearray(open(paths['port'], 'rb').read())
    raw[-10] ^= 1
    with pytest.raises(ValueError, match='CRC'):
        list(events.iter_records(bytes(raw)))


def test_wav_matches_tf_encode_wav():
    """tf.audio.encode_wav's bytes, ties and clipping included; the
    decoder inverts the quantisation."""
    x = np.array([0.0, 0.5, -0.5, 1.0, -1.0, 1.3, -1.3, 1.5 / 32768,
                  -1.5 / 32768, 2.5 / 32768, 0.1], np.float32)
    for channels in (1, 2):
        clip = np.stack([x, x[::-1]], axis=1)[:, :channels]
        assert events.encode_wav(clip, 16000) == tf.audio.encode_wav(
            clip, 16000).numpy()
    audio, rate = events.decode_wav(events.encode_wav(x, 8000))
    assert rate == 8000
    assert np.abs(audio[:5, 0] - x[:5]).max() <= 1.0 / 32767


def test_log_magnitude_spectrogram_matches_jax():
    from ddsp_piano_tpu.training.summaries import \
        _log_magnitude_spectrogram as jax_spec

    rs = np.random.RandomState(1)
    for n in (500, 4000, 24000):
        a = rs.randn(n).astype(np.float32)
        got = summaries._log_magnitude_spectrogram(a)
        np.testing.assert_allclose(got, jax_spec(a), rtol=1e-6, atol=1e-6)
    image, specs = summaries.spectrogram_image(rs.randn(2, 4000),
                                               rs.randn(2, 4000))
    assert image.dtype == np.uint8 and image.shape[2] == 3
    assert set(specs) == {'original', 'synthesized'}


def _jax_curves(jmodel, params):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    from ddsp_piano_tpu.training.summaries import tuning_curve_figures

    figs = tuning_curve_figures(jmodel, params)
    out = {name: np.asarray(fig.axes[0].lines[0].get_ydata())
           for name, fig in figs.items()}
    for fig in figs.values():
        plt.close(fig)
    return out


@pytest.mark.parametrize('config', ['dafx22', 'maestro_v2'])
def test_tuning_curves_match_jax(config):
    """The y values of the JAX figures' lines within 1e-6 (relative to
    each curve's peak): dafx22's inharmonicity network (one curve, its
    modifiers nudged from zero) and v2's pretrained joint tuning (both
    curves), each from JAX params. The JAX tuning's float32 tanh is
    rounded once from float64 as the port's is (ROADMAP C.6)."""
    import jax

    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.params import load_jax_params
    from ddsp_piano_tpu.configs import get_model as jax_get_model
    from ddsp_piano_tpu.models import sub_modules as jsm
    from test_torch_serving import _RoundedTanhJnp

    jmodel = jax_get_model(config, duration=0.5)
    # The curves read only the tuning slot's parameters.
    params = {'inharm_model': jax.tree.map(
        np.asarray, jmodel.inharm_model.init(jax.random.PRNGKey(0)))}
    if config == 'dafx22':
        params['inharm_model']['slopes_modifier'] = np.array(
            [0.01, -0.02], np.float32)
    model = get_model(config, duration=0.5, device='cpu')
    load_jax_params(model.inharm_model, params['inharm_model'])
    saved = jsm.jnp
    jsm.jnp = _RoundedTanhJnp()
    try:
        want = _jax_curves(jmodel, params)
    finally:
        jsm.jnp = saved
    got = summaries.tuning_curve_figures(model)
    assert sorted(got) == sorted(want) == (
        ['inharmonicity'] if config == 'dafx22'
        else ['inharmonicity', 'tuning'])
    for name, (x, y) in got.items():
        np.testing.assert_array_equal(x, np.arange(21, 109))
        scale = np.abs(want[name]).max()
        assert np.abs(y - want[name]).max() <= 1e-6 * scale, name


def test_train_cli_writes_the_jax_tags(cache, small, tmp_path):
    """Four epochs of one step: epochs 1-2 (step < 3) write train_loss and
    one batch's synthesized_audio, epochs 3-4 train_loss, val_loss,
    synthesized_audio, spectrogram and tuning/*, each at the JAX CLI's
    step; train_loss equals the CLI's epoch mean, and the WAV decodes to
    the validation audio within 1/32767."""
    from ddsp_piano_torch import train_single_phase as cli
    from ddsp_piano_torch.data import pipeline

    result = cli.main(cli.process_args(
        ['-b', '1', '-s', '1', '-e', '4', '--device', 'cpu', cache,
         str(tmp_path)]))
    evs = events.read_events(result['events'])
    seen = [(v['tag'], e['step']) for e in evs[1:] for v in e['values']]
    keys = result['trainer'].model.loss_keys()
    want = []
    for epoch in range(4):
        want += [(f'train_loss/{k}', epoch) for k in keys]
        if epoch + 1 < 3:
            want.append(('synthesized_audio', epoch + 1))
        else:
            want += [(f'val_loss/{k}', epoch) for k in keys]
            want += [('synthesized_audio', epoch), ('spectrogram', epoch),
                     ('tuning/inharmonicity', epoch),
                     ('tuning/tuning', epoch)]
    assert seen == want
    means = [v for e in evs for v in e['values']
             if v['tag'] == 'train_loss/total_loss']
    assert [events.value_array(v) for v in means] == [
        np.float32(m['total_loss']) for m in result['train_means']]
    assert len(result['summary_ms']) == 4
    # The last epoch's audio: the first validation batch, re-rendered.
    (wav, _), = events.value_array([
        v for e in evs for v in e['values']
        if v['tag'] == 'synthesized_audio'][-1])
    _, audio = result['trainer'].validation_step(next(iter(
        pipeline.get_validation_dataset(cache, batch_size=1,
                                        max_polyphony=4,
                                        sample_rate=24000))))
    decoded, rate = events.decode_wav(wav)
    assert rate == 24000
    peak = max(np.abs(audio).max(), 1.0)
    assert np.abs(decoded[:, 0] - audio[0] / peak).max() <= 1.0 / 32767
