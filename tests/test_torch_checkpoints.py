"""The port's checkpoints against the JAX package's, on the CPU.

- tf_name_map names the same TF variables, with the same shapes, as the
  JAX package's map, for every registered config (N_VARIABLES). Like the
  JAX map it covers the model's slots, not the processor group (the
  ENSTDkCl models' trainable FDN reverb has no TF name).
- A TF checkpoint written by either package is read by the other bit for
  bit; the JAX params tree of the port's weights (export_jax_params) has
  the structure of PianoModel.init's tree, loads back bit for bit and
  renders in the JAX package as the port renders.
- restore_params tells a TF prefix, a TF directory and the port's
  ckpt.pt (file or directory) apart; the synthesize and export CLIs and
  Trainer.restore_tf go through it.
"""

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

from ddsp_piano_torch.configs import get_model  # noqa: E402
from ddsp_piano_torch.params import (export_jax_params,  # noqa: E402
                                     load_jax_params)
from ddsp_piano_torch.training import checkpoints  # noqa: E402

DEMO_MIDI = os.path.join(os.path.dirname(__file__), '..', 'examples',
                         'demo.mid')
N_VARIABLES = {'maestro_v2': 104, 'dafx22': 32, 'dafx22_24khz': 32,
               'enstdkcl_8khz': 24, 'enstdkcl_32khz': 27,
               'multi_instruments': 70, 'surrogate': 45,
               'maestro_v2_regularized': 104}
# The configurations the TF round trips run on: the first two ported and
# each one ported since (the 24 kHz dafx22 and the regularized v2 differ
# from their base configs in widths or a loss only).
TF_CONFIGS = ['maestro_v2', 'dafx22', 'enstdkcl_8khz', 'enstdkcl_32khz',
              'multi_instruments', 'surrogate']


def _tf():
    return pytest.importorskip('tensorflow')


def _jax_model(config, duration=0.5, **kwargs):
    from ddsp_piano_tpu.configs import get_model as jax_get_model
    return jax_get_model(config, duration=duration, **kwargs)


def _port_model(config, seed=0, duration=0.5, **kwargs):
    return get_model(config, device='cpu', seed=seed, duration=duration,
                     **kwargs)


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _assert_params_equal(got, want):
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        torch.testing.assert_close(got[name], value, rtol=0, atol=0,
                                   msg=name)


def _assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('config', sorted(N_VARIABLES))
def test_tf_name_map_matches_jax(config):
    from ddsp_piano_tpu.training import checkpoints as jax_checkpoints

    jmodel = _jax_model(config)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    want = jax_checkpoints.tf_name_map(jmodel, shapes)
    got = checkpoints.tf_name_map(_port_model(config))
    assert sorted(got) == sorted(want)
    assert len(got) == N_VARIABLES[config]
    params = dict(_port_model(config).named_parameters())
    for tf_name, (slot, path) in want.items():
        node = shapes[slot]
        for p in path:
            node = node[p]
        assert tuple(params[got[tf_name]].shape) == tuple(node.shape), tf_name


@pytest.mark.parametrize('config', TF_CONFIGS)
def test_import_of_jax_export_is_bit_exact(tmp_path, config):
    """The JAX package's export_tf_weights of PRNGKey(3) init weights,
    read by the port: every parameter the TF map names equals
    load_jax_params of the same tree, with nothing missing, mismatched or
    unused; the others (the processor group's) keep their values."""
    _tf()
    from ddsp_piano_tpu.training import checkpoints as jax_checkpoints

    jmodel = _jax_model(config)
    tree = jmodel.init(jax.random.PRNGKey(3))
    prefix = jax_checkpoints.export_tf_weights(jmodel, tree,
                                               str(tmp_path / 'ckpt-0'))
    model = _port_model(config, seed=1)
    before = _params(model)
    report = checkpoints.import_tf_weights(model, prefix)
    assert len(report['matched']) == N_VARIABLES[config]
    assert not (report['missing'] or report['mismatched']
                or report['unused']), report
    want = _params(load_jax_params(_port_model(config, seed=2),
                                   jax.tree.map(np.asarray, tree)))
    mapped = set(checkpoints.tf_name_map(model).values())
    got = _params(model)
    _assert_params_equal({n: got[n] for n in mapped},
                         {n: want[n] for n in mapped})
    _assert_params_equal({n: v for n, v in got.items() if n not in mapped},
                         {n: v for n, v in before.items()
                          if n not in mapped})


@pytest.mark.parametrize('config', TF_CONFIGS)
def test_export_read_by_jax_is_bit_exact(tmp_path, config):
    """The port's export_tf_weights, read by the JAX package's
    import_tf_weights: the JAX tree equals export_jax_params of the port's
    model, but for the processor group, which no TF name covers and which
    keeps the JAX init's values."""
    _tf()
    from ddsp_piano_tpu.training import checkpoints as jax_checkpoints

    model = _port_model(config, seed=5)
    prefix = checkpoints.export_tf_weights(model, str(tmp_path / 'ckpt-0'))
    jmodel = _jax_model(config)
    init = jmodel.init(jax.random.PRNGKey(4))
    back, report = jax_checkpoints.import_tf_weights(jmodel, init, prefix)
    assert not (report['missing'] or report['mismatched']
                or report['unused']), report
    want = export_jax_params(model)
    want['processor_group'] = jax.tree.map(np.asarray,
                                           init['processor_group'])
    _assert_trees_equal(back, want)


@pytest.mark.parametrize('config', sorted(N_VARIABLES))
def test_jax_params_round_trip(config):
    """export_jax_params has PianoModel.init's tree structure (empty trees
    for the stateless modules) and load_jax_params takes it back bit for
    bit."""
    model = _port_model(config, seed=6)
    tree = export_jax_params(model)
    shapes = jax.eval_shape(_jax_model(config).init, jax.random.PRNGKey(0))
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    for (path, leaf), want in zip(jax.tree_util.tree_leaves_with_path(tree),
                                  jax.tree.leaves(shapes)):
        assert leaf.dtype == np.float32, jax.tree_util.keystr(path)
        assert leaf.shape == want.shape, jax.tree_util.keystr(path)
    back = load_jax_params(_port_model(config, seed=7), tree)
    _assert_params_equal(_params(back), _params(model))


def _conditioning(n_frames=250):
    cond = np.zeros((1, n_frames, 16, 2), np.float32)
    for voice, (pitch, start) in enumerate([(43, 10), (55, 10), (59, 70),
                                            (62, 130), (67, 190)]):
        cond[:, start:, voice, 0] = pitch
        cond[:, start:start + 8, voice, 1] = 0.7
    return cond


def test_exported_params_render_in_jax_as_in_the_port():
    """The JAX package renders the port's seed-8 weights, handed over by
    export_jax_params, as the port renders them: 1 s of the conditioning of
    test_torch_render.py with the JAX noise draw injected, the GRU networks
    jitted and the rest op by op, within that file's 1.1e-4 of peak."""
    jmodel = _jax_model('maestro_v2', duration=1.0, inference=True)
    for net in (jmodel.context_network, jmodel.monophonic_network):
        net.apply = jax.jit(net.apply, static_argnames='training')
    model = _port_model('maestro_v2', seed=8, duration=1.0, inference=True)
    params = jax.tree.map(jnp.asarray, export_jax_params(model))
    cond = _conditioning()
    rng = jax.random.PRNGKey(7)
    jout = jmodel(params, {'conditioning': jnp.asarray(cond),
                           'pedal': jnp.zeros((1, 250, 4)),
                           'piano_model': jnp.asarray([[3]], np.int32)},
                  rng=rng)
    noise = jax.random.uniform(jax.random.fold_in(rng, 1), (16, 24000),
                               jnp.float32, -1.0, 1.0)
    with torch.inference_mode():
        tout = model({'conditioning': torch.from_numpy(cond),
                      'pedal': torch.zeros(1, 250, 4),
                      'piano_model': torch.tensor([[3]])},
                     noise=torch.from_numpy(np.array(noise)))
    for got, want in ((tout['audio_synth'][0], jout['audio_synth'][0]),
                      (tout['add']['signal'][0], jout['add']['signal'][0])):
        got, want = got.numpy(), np.asarray(want)
        peak = np.abs(want).max()
        assert peak > 0.05 and np.isfinite(got).all()
        err = np.abs(got - want).max() / peak
        assert err <= 1.1e-4, err


def _save_ckpt(model, directory):
    from ddsp_piano_torch.training.trainer import Trainer

    return Trainer(model, first_phase=True).save(str(directory))


def test_restore_params_detects_each_form(tmp_path):
    """A TF prefix, a TF directory (with and without TF's checkpoint index
    file), a ckpt.pt file and a directory holding one each restore the
    same weights; None keeps the initial ones; a path that holds no
    checkpoint raises."""
    _tf()
    source = _port_model('dafx22', seed=9)
    want = _params(source)
    prefix = checkpoints.export_tf_weights(source,
                                           str(tmp_path / 'tf' / 'ckpt-3'))
    bare_dir = os.path.dirname(prefix)
    indexed = checkpoints.export_tf_weights(
        source, str(tmp_path / 'tf_indexed' / 'ckpt-4'))
    with open(os.path.join(os.path.dirname(indexed), 'checkpoint'),
              'w') as f:
        f.write('model_checkpoint_path: "ckpt-4"\n')
    pt_file = _save_ckpt(source, tmp_path / 'pt')
    for ckpt, is_tf in ((prefix, True), (bare_dir, True),
                        (os.path.dirname(indexed), True),
                        (pt_file, False), (os.path.dirname(pt_file), False)):
        assert checkpoints.is_tf_checkpoint(ckpt) == is_tf, ckpt
        model = checkpoints.restore_params(_port_model('dafx22'), ckpt)
        _assert_params_equal(_params(model), want)
    initial = _params(_port_model('dafx22'))
    _assert_params_equal(
        _params(checkpoints.restore_params(_port_model('dafx22'), None)),
        initial)
    empty = tmp_path / 'empty'
    empty.mkdir()
    for path in (str(empty), str(tmp_path / 'nothing')):
        with pytest.raises(FileNotFoundError, match='holds no checkpoint'):
            checkpoints.restore_params(_port_model('dafx22'), path)


def test_strict_import_raises_and_changes_nothing(tmp_path):
    """A maestro_v2 checkpoint lacks every dafx22 variable but the release
    duration: strict raises and leaves the weights; strict=False loads
    what matches and reports the rest."""
    _tf()
    prefix = checkpoints.export_tf_weights(_port_model('maestro_v2', seed=10),
                                           str(tmp_path / 'ckpt-0'))
    model = _port_model('dafx22')
    before = _params(model)
    with pytest.raises(ValueError, match='missing'):
        checkpoints.import_tf_weights(model, prefix)
    _assert_params_equal(_params(model), before)
    report = checkpoints.import_tf_weights(model, prefix, strict=False)
    assert report['matched'] == ['note_release/layer/cell/release_duration']
    # monophonic_network/dense_out is in both, at other widths.
    assert [m[0] for m in report['mismatched']] == [
        'monophonic_network/dense_out/kernel',
        'monophonic_network/dense_out/bias']
    assert len(report['missing']) == 29
    assert len(report['unused']) == 103
    narrow = checkpoints.export_tf_weights(_port_model('dafx22'),
                                           str(tmp_path / 'narrow' / 'c-0'))
    with pytest.raises(ValueError, match='mismatched'):
        checkpoints.import_tf_weights(_port_model('dafx22_24khz'), narrow)


def test_trainer_restore_tf_keeps_the_optimizer(tmp_path):
    """Trainer.restore_tf loads the weights in place: Adam keeps its
    moments and the step, and the next step trains the loaded weights."""
    _tf()
    from ddsp_piano_torch.training.trainer import Trainer

    source = _port_model('dafx22', seed=12, n_synths=4, duration=0.256)
    prefix = checkpoints.export_tf_weights(source, str(tmp_path / 'ckpt-0'))
    model = _port_model('dafx22', seed=13, n_synths=4, duration=0.256)
    trainer = Trainer(model, first_phase=True)
    rng = np.random.RandomState(0)
    batch = {'audio': rng.uniform(-0.1, 0.1, (1, 4096)).astype(np.float32),
             'conditioning': np.zeros((1, 64, 4, 2), np.float32),
             'pedal': np.zeros((1, 64, 4), np.float32),
             'piano_model': np.zeros((1, 1), np.int32)}
    batch['conditioning'][:, 5:, 0] = (60.0, 0.0)
    batch['conditioning'][:, 5:9, 0, 1] = 0.8
    trainer.train_step(batch)
    moments = {id(p): {k: v.clone() for k, v in s.items()}
               for p, s in trainer.optimizer.state.items()}
    report = trainer.restore_tf(prefix)
    assert len(report['matched']) == 32 and trainer.step == 1
    _assert_params_equal(_params(model), _params(source))
    for p, state in trainer.optimizer.state.items():
        for k, v in state.items():
            torch.testing.assert_close(v, moments[id(p)][k], rtol=0, atol=0)
    trainer.train_step(batch)
    assert trainer.step == 2


def test_synthesize_cli_renders_the_checkpoint(tmp_path):
    """synthesize_midi_file --ckpt <ckpt.pt directory> --device cpu loads
    the checkpoint's weights (not the initial ones) and renders as an
    in-process render of those weights with the same generator does."""
    from ddsp_piano_torch import synthesize_midi_file as cli
    from ddsp_piano_torch.data.io import load_midi_as_conditioning

    trained = _port_model('maestro_v2', seed=14, duration=3.0)
    ckpt_dir = os.path.dirname(_save_ckpt(trained, tmp_path / 'last_iter'))
    common = ['-d', '0.5', '-wu', '0.5', '--seed', '3', '--device', 'cpu',
              DEMO_MIDI]
    got = cli.main(cli.process_args(['--ckpt', ckpt_dir] + common
                                    + [str(tmp_path / 'ckpt.wav')]))
    _assert_params_equal(_params(got['model']), _params(trained))
    initial = cli.main(cli.process_args(common + [str(tmp_path / 'i.wav')]))
    assert np.abs(got['audio'] - initial['audio']).max() > 1e-3

    inputs = load_midi_as_conditioning(DEMO_MIDI, duration=0.5,
                                       warm_up_duration=0.5)
    model = _port_model('maestro_v2', duration=inputs['duration'],
                        inference=True)
    model.load_state_dict(trained.state_dict())
    with torch.inference_mode():
        outs = model({'conditioning': torch.from_numpy(inputs['conditioning']),
                      'pedal': torch.from_numpy(inputs['pedal']),
                      'piano_model': torch.tensor([[9]])},
                     generator=torch.Generator().manual_seed(3))
    want = outs['audio_synth'][0].numpy()[int(0.5 * 24000):]
    np.testing.assert_array_equal(got['audio'], want)
    assert np.isfinite(got['audio']).all()


def test_export_cli_writes_what_the_jax_package_reads(tmp_path):
    """export_tf_checkpoint --ckpt <ckpt.pt> writes the 32 dafx22
    variables, which the JAX package's reader returns bit for bit."""
    _tf()
    from ddsp_piano_torch import export_tf_checkpoint as cli
    from ddsp_piano_tpu.training import checkpoints as jax_checkpoints

    source = _port_model('dafx22', seed=15)
    pt = _save_ckpt(source, tmp_path / 'pt')
    written = cli.main(cli.process_args(['-c', 'dafx22', '--ckpt', pt,
                                         '--out', str(tmp_path / 'x' /
                                                      'ckpt-0')]))
    tf_vars = jax_checkpoints.read_tf_checkpoint(written)
    names = checkpoints.tf_name_map(source)
    assert sorted(tf_vars) == sorted(names)
    params = _params(source)
    for tf_name, name in names.items():
        np.testing.assert_array_equal(tf_vars[tf_name],
                                      params[name].numpy(), err_msg=tf_name)


def test_tensorflow_is_imported_only_for_tf_checkpoints(monkeypatch):
    """Without TensorFlow, reading a TF checkpoint raises an ImportError
    that says what TF is needed for; ckpt.pt needs none."""
    import builtins

    real_import = builtins.__import__

    def no_tf(name, *args, **kwargs):
        if name.split('.')[0] == 'tensorflow':
            raise ImportError("No module named 'tensorflow'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, '__import__', no_tf)
    with pytest.raises(ImportError, match='only to read or write TF'):
        checkpoints.read_tf_checkpoint('x/ckpt-0')
    with pytest.raises(ImportError, match='only to read or write TF'):
        checkpoints.export_tf_weights(_port_model('dafx22'), 'x/ckpt-0')
