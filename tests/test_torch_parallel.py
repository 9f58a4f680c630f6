"""Data parallelism of the port (ddsp_piano_torch/parallel) on the CPU.

Ranks are processes started by the port's launcher (parallel.mesh.launch),
meeting through a file in a temporary directory and reducing over gloo;
each sets one thread, for torch and numpy's BLAS, when it imports this
module. One spawn of two ranks serves the Trainer's cases (maestro_v2 at
4 voices and 0.2 s, global batch 4, the JAX package's PRNGKey draws
injected), another the CLIs' (train_single_phase and evaluate_model at 4
voices and 16 harmonics on a one-track mini-MAESTRO), beside two CLI
processes with the multi-host flags; the single-process references run
in the test process meanwhile.

A step over two ranks is held against the same step of one process on
the global batch: the losses within rtol 1e-5, the reduced gradient
within 1e-5 of each leaf's peak. The gradient is that of the loss's
magnitude term: the log-magnitude term scales rounding by 1 / |X| at
near-silent bins (ROADMAP, "compare gradients with the magnitude term
alone for tight checks"), and the ranks and the single process sum their
rows in another order. The first step's losses are also held against the
JAX package's Trainer on a 2-device mesh (its validation step at the
train step's key computes the losses its train step returns).
"""

import concurrent.futures
import multiprocessing
import os
import time

import numpy as np
import pytest
import threadpoolctl

torch = pytest.importorskip('torch')
torch.set_num_threads(1)
# numpy's BLAS too, for the whole worker (xdist collects every file) and
# in every spawned rank (which imports this module): threaded OpenBLAS
# stalls at each call's barrier on a loaded host.
threadpoolctl.threadpool_limits(1)

from ddsp_piano_torch.parallel import mesh  # noqa: E402

GLOBAL_BATCH = 4
N_SYNTHS = 4
SECONDS = 0.2
N_FRAMES = 50
N_SAMPLES = 4800
RANKS = 2
# The CLIs' model and data (tests/test_torch_train_cli.py's `small`).
SMALL = dict(n_synths=4, n_harmonics=16)
SEGMENT_SECONDS = 1.0
EVAL_SECONDS = 0.5


def _v2(first_phase=True):
    from ddsp_piano_torch.configs import get_model
    return get_model('maestro_v2', device='cpu', duration=SECONDS,
                     n_synths=N_SYNTHS, first_phase=first_phase)


def _global_batch():
    """Four 0.2 s segments: held notes, onsets, a release, a pedal; the
    target audio drawn like get_dummy_data's."""
    rng = np.random.RandomState(0)
    cond = np.zeros((GLOBAL_BATCH, N_FRAMES, N_SYNTHS, 2), np.float32)
    for b in range(GLOBAL_BATCH):
        for voice, (pitch, start, end) in enumerate(
                [(43 + b, 2, 45), (59, 8, 25), (67 - b, 16, N_FRAMES),
                 (72, 30, 40)]):
            cond[b, start:end, voice, 0] = pitch
            cond[b, start:start + 4, voice, 1] = 0.4 + 0.1 * voice
    pedal = np.zeros((GLOBAL_BATCH, N_FRAMES, 4), np.float32)
    pedal[1, 10:, 0] = 0.7
    return {'conditioning': cond, 'pedal': pedal,
            'audio': rng.uniform(0.0, 1.0, (GLOBAL_BATCH, N_SAMPLES)
                                 ).astype(np.float32),
            'piano_model': np.array([[3], [7], [1], [5]], np.int32)}


# -- rank counts and rows ----------------------------------------------------


@pytest.mark.parametrize('n_devices', [None] + list(range(1, 9)))
@pytest.mark.parametrize('batch_size', range(1, 9))
def test_rank_count_matches_jax_mesh(batch_size, n_devices):
    """One host of 8 cards (JAX: the 8 virtual CPU devices)."""
    from ddsp_piano_tpu.parallel import mesh as jax_mesh

    want = jax_mesh.get_mesh_for_batch(batch_size, n_devices).devices.size
    assert mesh.get_world_for_batch(batch_size, n_devices, n_local=8,
                                    num_processes=1) == want


def test_multi_host_rank_count_takes_every_card():
    assert mesh.get_world_for_batch(8, None, n_local=2, num_processes=2) == 4
    with pytest.warns(UserWarning, match='ignored in multi-process'):
        assert mesh.get_world_for_batch(8, 3, n_local=2,
                                        num_processes=2) == 4
    with pytest.raises(ValueError, match='must divide over the 4-device'):
        mesh.get_world_for_batch(6, None, n_local=2, num_processes=2)


def test_initialize_multihost_reads_the_coordinator(monkeypatch):
    monkeypatch.delenv('MASTER_ADDR', raising=False)
    monkeypatch.delenv('MASTER_PORT', raising=False)
    try:
        assert not mesh.initialize_multihost()
        assert (mesh.process_count(), mesh.process_index()) == (1, 0)
        monkeypatch.setenv('MASTER_ADDR', '10.0.0.1')
        monkeypatch.setenv('MASTER_PORT', '1234')
        assert mesh.initialize_multihost(num_processes=3, process_id=2)
        assert mesh._HOSTS == mesh.Hosts('tcp://10.0.0.1:1234', 3, 2)
        with pytest.raises(ValueError, match='num_processes'):
            mesh.initialize_multihost('h:1')
    finally:
        monkeypatch.delenv('MASTER_ADDR')
        mesh.initialize_multihost()


def _as_rank(monkeypatch, index, ranks, local=None):
    monkeypatch.setattr(mesh, 'world_size', lambda: ranks)
    monkeypatch.setattr(mesh, 'rank', lambda: index)
    local = local or (index, ranks)
    monkeypatch.setattr(mesh, '_LOCAL', local)


@pytest.mark.parametrize('batch_size,ranks', [(4, 2), (6, 3), (24, 4),
                                              (8, 8)])
def test_row_slices_match_jax(batch_size, ranks, monkeypatch):
    """A rank's rows of the global batch are what JAX's
    local_batch_slice gives a process with that index; a rank's rows of
    its host's batch (two hosts) are that host's share cut again."""
    import jax

    from ddsp_piano_tpu.parallel import mesh as jax_mesh

    batch = {'audio': np.arange(batch_size * 3).reshape(batch_size, 3)}
    for index in range(ranks):
        monkeypatch.setattr(jax, 'process_count', lambda: ranks)
        monkeypatch.setattr(jax, 'process_index', lambda: index)
        _as_rank(monkeypatch, index, ranks)
        want = jax_mesh.local_batch_slice(batch_size)
        assert mesh.local_batch_slice(batch_size) == want
        np.testing.assert_array_equal(
            mesh.slice_local_batch(batch)['audio'], batch['audio'][want])
        if ranks % 2 == 0:
            # Two hosts of ranks / 2 ranks: host h holds global rows
            # [h * B / 2, (h + 1) * B / 2).
            host, local = divmod(index, ranks // 2)
            _as_rank(monkeypatch, index, ranks, (local, ranks // 2))
            half = batch_size // 2
            host_rows = batch['audio'][host * half:(host + 1) * half]
            np.testing.assert_array_equal(
                mesh.slice_local_batch({'audio': host_rows},
                                       within_host=True)['audio'],
                batch['audio'][want])


def test_rank_noise_rows_fold_back_to_the_global_draw(monkeypatch):
    """The noise draw folds voices voice-major (n_synths * batch rows):
    the ranks' local folds, put back together, are the global fold."""
    from ddsp_piano_torch.processors.noise import uniform_noise

    rows, n = N_SYNTHS * GLOBAL_BATCH, 64
    want = uniform_noise((rows, n), torch.Generator().manual_seed(5), 'cpu')
    parts = []
    for index in range(RANKS):
        _as_rank(monkeypatch, index, RANKS)
        draw = mesh.RankDraw(torch.Generator().manual_seed(5), GLOBAL_BATCH)
        parts.append(uniform_noise((rows // RANKS, n), draw, 'cpu'))
        assert torch.equal(mesh.take_rows(want, GLOBAL_BATCH), parts[-1])
    back = torch.cat([p.view(N_SYNTHS, GLOBAL_BATCH // RANKS, n)
                      for p in parts], dim=1).reshape(rows, n)
    assert torch.equal(back, want)


# -- the Trainer over two ranks ------------------------------------------------


def _losses(losses):
    return {k: float(v) for k, v in losses.items()}


def _steps(trainer, rows, draws):
    """The validation step at the initial weights, the first step's
    gradient of the magnitude term alone, then one step a draw of the v2
    loss; the state around them."""
    draws = [np.array(d) for d in draws]
    out = {'initial': {n: p.detach().clone()
                       for n, p in trainer.model.named_parameters()}}
    val_losses, audio = trainer.validation_step(rows)
    out['val'] = (val_losses, audio)
    loss = trainer.model.loss_objs[0]
    loss.logmag_weight = 0.0
    mag = trainer.forward_backward(rows, noise=torch.from_numpy(draws[0]))
    out['mag'] = (_losses(mag), {n: p.grad.clone()
                                 for n, p in trainer.named_params})
    loss.logmag_weight = 1.0
    out['losses'] = [_losses(trainer.train_step(
        rows, noise=torch.from_numpy(d))) for d in draws]
    trainer.check_pending()
    out['trainable'] = [n for n, _ in trainer.named_params]
    out['params'] = {n: p.detach().clone()
                     for n, p in trainer.model.named_parameters()}
    return out


def _trainer_rank(params, batch, draws):
    from ddsp_piano_torch.params import load_jax_params
    from ddsp_piano_torch.training.trainer import NanLossError, Trainer

    model = _v2()
    load_jax_params(model, params)
    if mesh.rank() == 1:
        # The Trainer broadcasts rank 0's state: these must not survive.
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(2.0)
    rows = mesh.slice_local_batch(batch)
    out = _steps(Trainer(model, first_phase=True), rows, draws)
    out['rank'] = mesh.rank()

    # maestro_v2's second phase trains no parameter.
    frozen = Trainer(model, first_phase=False)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    out['phase_2'] = (frozen.optimizer is None, _losses(frozen.train_step(
        rows, noise=torch.from_numpy(draws[0]))), all(
        torch.equal(p, before[n]) for n, p in model.named_parameters()))

    out['psum'] = float(frozen.psum({'x': torch.full((3,), mesh.rank()
                                                     + 1.0)})['x'])
    try:
        frozen.psum([np.ones(3)])
        out['psum_numpy'] = None
    except TypeError as e:
        out['psum_numpy'] = str(e)

    # A NaN in the target of the last row: rank 1's rows only.
    trainer = Trainer(model, first_phase=True)
    bad = {k: v.copy() for k, v in batch.items()}
    bad['audio'][-1] = np.nan
    try:
        trainer.train_step(mesh.slice_local_batch(bad),
                           noise=torch.from_numpy(draws[0]))
        trainer.check_pending()
        out['nan'] = None
    except NanLossError as e:
        out['nan'] = (str(e), e.state['step'])
    return out


def _single_process(params, batch, draws, rendezvous):
    """The steps of one process on the global batch; then a step of one
    row outside a process group and in a group of one rank (the reduce
    path: a sum over one rank, divided by 1)."""
    from ddsp_piano_torch.params import load_jax_params
    from ddsp_piano_torch.training.trainer import Trainer

    model = load_jax_params(_v2(), params)
    trainer = Trainer(model, first_phase=True)
    # What the reduce of two ranks sums: the magnitude term's first-step
    # gradient on each half of the rows, with its rows of the draw.
    model.loss_objs[0].logmag_weight = 0.0
    halves = []
    for half in range(RANKS):
        rows = slice(half * GLOBAL_BATCH // RANKS,
                     (half + 1) * GLOBAL_BATCH // RANKS)
        trainer.forward_backward(
            {k: torch.from_numpy(v[rows]) for k, v in batch.items()},
            noise=torch.from_numpy(draws[0]).view(
                N_SYNTHS, GLOBAL_BATCH, N_SAMPLES)[:, rows].reshape(
                    -1, N_SAMPLES))
        halves.append({n: p.grad.clone() for n, p in trainer.named_params})
    model.loss_objs[0].logmag_weight = 1.0
    out = _steps(trainer, {k: torch.from_numpy(v) for k, v in batch.items()},
                 draws)
    out['halves'] = {n: (halves[0][n] + halves[1][n]) / RANKS
                     for n in halves[0]}
    row = {k: torch.from_numpy(v[:1]) for k, v in batch.items()}
    one_rank = []
    for group in (False, True):
        if group:
            mesh.init_rank(0, 1, mesh.Hosts(), 'cpu', rendezvous)
        trainer = Trainer(load_jax_params(_v2(), params), first_phase=True)
        one_rank.append((trainer.distributed, _losses(trainer.train_step(
            row)), {n: p.detach().clone()
                    for n, p in trainer.model.named_parameters()}))
    mesh.end_rank()
    out['one_rank'] = one_rank
    return out


def _jax_first_losses(params, batch, rng):
    """The losses of the JAX Trainer's step at ``rng`` on a 2-device mesh,
    from its validation step (the same forward)."""
    import jax
    import jax.numpy as jnp

    from ddsp_piano_tpu.configs import get_model
    from ddsp_piano_tpu.parallel import mesh as jax_mesh
    from ddsp_piano_tpu.training.trainer import Trainer, TrainState

    jmodel = get_model('maestro_v2', duration=SECONDS, n_synths=N_SYNTHS,
                       first_phase=True)
    trainer = Trainer(jmodel, first_phase=True, mesh=jax_mesh.get_mesh(2))
    state = TrainState(params=jax_mesh.replicate(
        jax.tree.map(jnp.asarray, params), trainer.mesh), opt_state=None,
        step=jnp.zeros((), jnp.int32))
    losses, _ = trainer.validation_step(state, batch, rng=rng)
    return losses


@pytest.fixture(scope='module')
def trainer_run(tmp_path_factory):
    """Two gloo ranks of the port's Trainer, each on its rows of the global
    batch (and of each global draw); the single process on the global
    batch; the JAX Trainer's first losses."""
    import jax
    import jax.numpy as jnp

    from ddsp_piano_torch.params import export_jax_params

    tmp = tmp_path_factory.mktemp('parallel_trainer')
    params = export_jax_params(_v2())
    batch = _global_batch()
    rngs = [jax.random.PRNGKey(100 + i) for i in range(2)]
    # The noise synth's draw inside the JAX step (models/dag.py:123).
    draws = [np.asarray(jax.random.uniform(
        jax.random.fold_in(rng, 1), (N_SYNTHS * GLOBAL_BATCH, N_SAMPLES),
        jnp.float32, -1.0, 1.0)) for rng in rngs]
    with concurrent.futures.ThreadPoolExecutor(1) as threads, \
            concurrent.futures.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context('spawn')) as procs:
        ranks = threads.submit(mesh.launch, _trainer_rank, RANKS,
                               (params, batch, draws), 'cpu')
        single = procs.submit(_single_process, params, batch, draws[:1],
                              'file://' + str(tmp / 'one_rank'))
        jax_losses = _jax_first_losses(params, batch, rngs[0])
        ranks, single = ranks.result(), single.result()
    return ranks, single, jax_losses


def test_first_step_losses_match_jax_mesh(trainer_run):
    ranks, _, jax_losses = trainer_run
    for r in ranks:
        for key, want in jax_losses.items():
            # rtol 1e-4, as test_whole_step_loss_matches_jax holds the loss.
            np.testing.assert_allclose(r['losses'][0][key], float(want),
                                       rtol=1e-4, err_msg=key)


def test_first_step_matches_single_process(trainer_run):
    """Losses within rtol 1e-5; the reduced gradient within 1e-5 of each
    leaf's peak, the same bits in both ranks."""
    ranks, single, _ = trainer_run
    for r in ranks:
        for got, want in ((r['mag'][0], single['mag'][0]),
                          (r['losses'][0], single['losses'][0])):
            assert sorted(got) == sorted(want)
            for key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=key)
        grads = r['mag'][1]
        assert sorted(grads) == sorted(single['mag'][1])
        for name, want in single['mag'][1].items():
            peak = float(want.abs().max())
            err = float((grads[name] - want).abs().max())
            assert err <= 1e-5 * peak, (name, err / peak)
            assert torch.equal(grads[name], ranks[0]['mag'][1][name])


def test_reduced_gradient_is_the_mean_of_the_ranks_rows(trainer_run):
    """The all-reduce's arithmetic: the reduced gradient is, bit for bit,
    the mean of the gradients one process takes on each rank's rows with
    its rows of the draw (the gap to the global batch's gradient is the
    float32 sums' other order)."""
    ranks, single, _ = trainer_run
    for r in ranks:
        for name, want in single['halves'].items():
            assert torch.equal(r['mag'][1][name], want), name


def test_parameters_bitwise_equal_across_ranks(trainer_run):
    """Rank 1's weights were doubled before its Trainer broadcast rank
    0's; after two steps the ranks hold the same bits."""
    ranks, single, _ = trainer_run
    for name, want in ranks[0]['params'].items():
        assert torch.equal(ranks[1]['params'][name], want), name
        assert torch.equal(ranks[1]['initial'][name],
                           single['initial'][name]), name
    assert ranks[0]['losses'] == ranks[1]['losses']
    assert len(ranks[0]['losses']) == 2


def test_frozen_parameters_stay_frozen(trainer_run):
    ranks, _, _ = trainer_run
    for r in ranks:
        trainable = set(r['trainable'])
        assert trainable and len(trainable) < len(r['params'])
        moved = {name for name, value in r['params'].items()
                 if not torch.equal(value, r['initial'][name])}
        # A trainable leaf whose gradient is 0 at every step stays too.
        assert moved <= trainable
        assert len(moved) > 0.9 * len(trainable)


def test_phase_without_trainable_parameters_runs_on_two_ranks(trainer_run):
    ranks, _, _ = trainer_run
    for r in ranks:
        no_optimizer, losses, unchanged = r['phase_2']
        assert no_optimizer and unchanged
        assert np.isfinite(losses['total_loss'])
        assert losses == ranks[0]['phase_2'][1]


def test_nan_in_one_ranks_rows_raises_on_every_rank(trainer_run):
    ranks, _, _ = trainer_run
    assert ranks[0]['nan'] is not None
    assert ranks[0]['nan'] == ranks[1]['nan']
    message, step = ranks[0]['nan']
    assert 'Nan loss at step 0' in message and step == 0


def test_validation_gathers_the_single_process_forward(trainer_run):
    """Each rank's validation step returns every rank's audio rows in the
    global order and the global batch's losses: the single process's
    forward on the global batch (the same fixed-generator draw)."""
    ranks, single, _ = trainer_run
    want_losses, want_audio = single['val']
    assert want_audio.shape == (GLOBAL_BATCH, N_SAMPLES)
    for r in ranks:
        losses, audio = r['val']
        assert audio.shape == want_audio.shape
        np.testing.assert_allclose(audio, want_audio, rtol=0,
                                   atol=1e-6 * np.abs(want_audio).max())
        for key, want in want_losses.items():
            np.testing.assert_allclose(losses[key], want, rtol=1e-5,
                                       err_msg=key)


def test_psum_sums_over_ranks_and_refuses_host_numpy(trainer_run):
    ranks, _, _ = trainer_run
    for r in ranks:
        assert r['psum'] == 3 * (1.0 + 2.0)
        assert 'requires tensors' in r['psum_numpy']


def _raise_in_rank_one():
    if mesh.rank() == 1:
        raise RuntimeError('rank 1 fails before its first reduce')
    torch.distributed.all_reduce(torch.ones(1))


def _failing_launch():
    start = time.perf_counter()
    try:
        mesh.launch(_raise_in_rank_one, RANKS, device_type='cpu')
        error = None
    except Exception as e:  # noqa: BLE001 - the launcher's error, whatever
        error = e
    return error, time.perf_counter() - start


def test_a_failing_rank_ends_the_launcher(cli_runs):
    """Rank 0 waits in an all-reduce that rank 1 never joins: the launcher
    ends it and raises within seconds, not the group's timeout."""
    error, seconds = cli_runs['failing']
    assert 'rank 1 fails' in str(error)
    assert seconds < 60


def test_world_of_one_rank_is_the_single_process_step(trainer_run):
    """A process group of one rank takes the reduce path (a sum over one
    rank, divided by 1): the single process's losses and parameters, bit
    for bit."""
    (alone, want, want_params), (grouped, got, params) = \
        trainer_run[1]['one_rank']
    assert not alone and grouped
    assert got == want
    for name, value in want_params.items():
        assert torch.equal(params[name], value), name


# -- the CLIs over two ranks ------------------------------------------------------


def _small(setattr=setattr):
    """The CLIs' model at 4 voices and 16 harmonics, on 1 s training
    segments with a 4-segment shuffle buffer."""
    from ddsp_piano_torch import configs
    from ddsp_piano_torch.data import pipeline

    real_get_model = configs.get_model
    setattr(configs, 'get_model', lambda *a, **kw: real_get_model(
        *a, **{**SMALL, 'duration': SEGMENT_SECONDS, **kw}))
    for name in ('get_training_dataset', 'get_validation_dataset'):
        real = getattr(pipeline, name)
        setattr(pipeline, name, lambda *a, _real=real, **kw: _real(
            *a, duration=SEGMENT_SECONDS, shuffle_buffer_segments=4, **kw))


def _run_clis(train_argv, eval_argv):
    from ddsp_piano_torch import evaluate_model
    from ddsp_piano_torch import train_single_phase as cli

    train = cli.main(cli.process_args(train_argv))
    return (cli.portable_result(train) if 'trainer' in train else train,
            evaluate_model.main(evaluate_model.process_args(eval_argv)))


def _cli_rank(train_argv, eval_argv):
    _small()
    return _run_clis(train_argv, eval_argv)


def _host_cli(process_id, argv, out_dir):
    """One host of a two-host run, one CPU rank, by the multi-host
    flags."""
    from ddsp_piano_torch import train_single_phase as cli

    _small()
    result = cli.main(cli.process_args(
        ['--coordinator_address', 'file://' + os.path.join(out_dir, 'rdv'),
         '--num_processes', '2', '--process_id', str(process_id)] + argv
        + [os.path.join(out_dir, 'exp')]))
    torch.save(cli.portable_result(result),
               os.path.join(out_dir, f'host{process_id}.pt'))


def _two_hosts(argv, out_dir):
    torch.multiprocessing.spawn(_host_cli, nprocs=2, args=(argv, out_dir))
    return [torch.load(os.path.join(out_dir, f'host{i}.pt'),
                       weights_only=False) for i in range(2)]


def _write_maestro(root, seconds=2.0, sample_rate=24000):
    """A maestro-v3.0.0.csv with a train, a validation and a test row over
    one MIDI file of at most three voices and one sine-mix wav."""
    from ddsp_piano_torch.data import audio_io, midi

    os.makedirs(root, exist_ok=True)
    notes = [midi.Note(48 + 5 * (i % 3), 70, 0.4 * i, 0.4 * i + 0.9)
             for i in range(int(seconds / 0.4) - 1)]
    midi.write_midi(os.path.join(root, 'track.midi'), notes)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    audio = 0.2 * np.sin(2 * np.pi * 220.0 * t) * np.exp(-(t % 0.4) * 4)
    audio_io.write_wav(os.path.join(root, 'track.wav'), audio, sample_rate)
    with open(os.path.join(root, 'maestro-v3.0.0.csv'), 'w') as f:
        f.write('canonical_composer,canonical_title,split,year,'
                'midi_filename,audio_filename,duration\n')
        for split, year in (('train', 2018), ('validation', 2017),
                            ('test', 2017)):
            f.write(f'Nobody,Etude,{split},{year},track.midi,track.wav,'
                    f'{seconds}\n')
    return root


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    """train_single_phase -b 2 -s 2 -e 1 on a preprocessed cache and
    evaluate_model -b 2 --duration 0.5 on the test row: in two ranks (the
    same process group for both CLIs), in two host processes (training
    only) and, meanwhile, in this process (one rank)."""
    from ddsp_piano_torch import preprocess_maestro

    root = tmp_path_factory.mktemp('parallel_cli')
    maestro = _write_maestro(str(root / 'maestro'))
    cache = str(root / 'cache')
    preprocess_maestro.main(preprocess_maestro.process_args(
        ['--num_workers', '1', '-p', '4', maestro, cache]))
    train = ['-b', '2', '-s', '2', '-e', '1', '--device', 'cpu', '--seed',
             '3', cache]
    evaluate = ['-b', '2', '--duration', str(EVAL_SECONDS), '--device',
                'cpu', maestro]
    runs = {}
    hosts_dir = str(root / 'hosts')
    os.makedirs(hosts_dir)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        failing = pool.submit(_failing_launch)
        ranks = pool.submit(
            mesh.launch, _cli_rank, RANKS,
            (train + ['--n_devices', '2', str(root / 'exp_2')],
             evaluate + ['--n_devices', '2', str(root / 'eval_2')]), 'cpu')
        hosts = pool.submit(_two_hosts, train, hosts_dir)
        with pytest.MonkeyPatch.context() as patch:
            _small(patch.setattr)
            runs['single'] = _run_clis(train + [str(root / 'exp_1')],
                                       evaluate + [str(root / 'eval_1')])
        runs['ranks'] = ranks.result()
        runs['hosts'] = hosts.result()
        runs['failing'] = failing.result()
    runs['root'] = root
    return runs


def test_train_cli_two_ranks_match_one_rank(cli_runs):
    """The first step's losses within rtol 1e-5, the second's within rtol
    1e-3 (after one update, as tests/test_torch_training.py holds the
    CLI's first step); the ranks' parameters bitwise equal."""
    want = cli_runs['single'][0]
    ranks = [train for train, _ in cli_runs['ranks']]
    assert [r['rank'] for r in ranks] == [0, 1]
    for r in ranks:
        assert r['step'] == want['step'] == 2
        assert r['step_losses'] == ranks[0]['step_losses']
        np.testing.assert_allclose(r['step_losses'][0],
                                   want['step_losses'][0], rtol=1e-5)
        np.testing.assert_allclose(r['step_losses'][1],
                                   want['step_losses'][1], rtol=1e-3)
        assert np.isfinite(r['val_losses']['total_loss'])
        for name, value in ranks[0]['params'].items():
            assert torch.equal(r['params'][name], value), name


def test_rank_zero_writes_the_only_checkpoint_and_event_file(cli_runs):
    ranks = [train for train, _ in cli_runs['ranks']]
    exp = os.path.join(str(cli_runs['root']), 'exp_2', 'phase_1')
    assert ranks[0]['events'] is not None and ranks[1]['events'] is None
    assert os.listdir(os.path.join(exp, 'logs')) == [
        os.path.basename(ranks[0]['events'])]
    assert os.listdir(os.path.join(exp, 'last_iter')) == ['ckpt.pt']
    saved = torch.load(os.path.join(exp, 'last_iter', 'ckpt.pt'),
                       weights_only=True)
    assert saved['step'] == 2
    for name, value in ranks[0]['params'].items():
        assert torch.equal(saved['model'][name], value), name


def test_multi_host_cli_processes_agree(cli_runs):
    """Two hosts of one CPU rank each, by --coordinator_address,
    --num_processes and --process_id: each reads its own stream and the
    two train as one, bit for bit."""
    hosts = cli_runs['hosts']
    assert hosts[0]['step'] == hosts[1]['step'] == 2
    assert hosts[0]['step_losses'] == hosts[1]['step_losses']
    assert np.isfinite(hosts[0]['step_losses']).all()
    for name, value in hosts[0]['params'].items():
        assert torch.equal(hosts[1]['params'][name], value), name
    assert hosts[0]['events'] is not None and hosts[1]['events'] is None


def test_evaluate_cli_two_ranks_match_one_rank(cli_runs):
    want = cli_runs['single'][1]['rows']
    assert len(want) == 4
    for _, result in cli_runs['ranks']:
        got = result['rows']
        assert [(r['filename'], r['piano_model']) for r in got] == [
            (r['filename'], r['piano_model']) for r in want]
        np.testing.assert_allclose([r['loss_val'] for r in got],
                                   [r['loss_val'] for r in want], rtol=1e-5)
    assert os.path.isfile(os.path.join(str(cli_runs['root']), 'eval_2',
                                       'spectral.csv'))


# -- the kernel build -----------------------------------------------------------


def test_kernel_build_runs_once_per_host(tmp_path, monkeypatch):
    """A second build on the host (another rank's) waits on the build
    directory's lock while the first compiles, then finds every library
    built and compiles nothing. The compiler is a stub that writes its
    output and logs its source."""
    from ddsp_piano_torch.kernels import build

    log = tmp_path / 'compiled.log'
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    f'echo "$3" >> {log}\necho built > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, 'BUILD_ROOT', tmp_path / 'kernels')
    monkeypatch.setattr(build, 'nvcc_path', lambda: str(nvcc))
    out_dir = build._build_dir()
    out_dir.mkdir(parents=True)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        with build.build_lock(out_dir):
            waiting = pool.submit(build.build_all)
            time.sleep(0.5)
            assert not waiting.done()
            first = build._build_missing(out_dir)
        assert waiting.result(timeout=30) == {}
    assert sorted(first) == sorted(build.SIGNATURES)
    compiled = log.read_text().split()
    assert sorted(os.path.basename(c) for c in compiled) == sorted(
        f'{name}.cu' for name in build.SIGNATURES)
    assert build.build_all() == {}
