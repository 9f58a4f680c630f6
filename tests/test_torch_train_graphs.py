"""The Trainer's step replayed from CUDA graphs against the same step run
eagerly, on the card.

From the same weights, each case holds the graph path's losses,
parameters, Adam moments and step counts bit-equal to the steps composed
eagerly from ``forward_backward`` and ``apply_gradients``: with injected
noise and with the generator's draw, on maestro_v2, dafx22 and the bf16
control networks; a K = 4 block against four single steps; a batch of a
new shape, captured anew; a non-finite loss (NanLossError at the same step
with the same state); the launch counters over replayed steps against
eager ones, and the profiler's kernel events of every replay against
those counters. Every test needs an NVIDIA GPU and skips without one.
This file imports no JAX; run it on the card as

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_train_graphs.py
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

from ddsp_piano_torch.device import set_f32_precision  # noqa: E402
from ddsp_piano_torch.kernels import build  # noqa: E402
from ddsp_piano_torch.nn import layers  # noqa: E402

SECONDS = 0.5
STEPS = 5
# Profiler names of the training kernels K4-K7 (as the benchmark reads
# them), by launch counter.
KERNEL_NAMES = {
    'oscillator_skip_bwd': r'\bosc_skip_bwd(_generic)?_kernel\b',
    'gru_scan_bwd': r'\bgru_scan_bwd_kernel\b',
    'note_release_res': r'\bnote_release_res_kernel\b',
    'note_release_bwd': r'\bnote_release_bwd_kernel\b',
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    set_f32_precision()
    return torch.device('cuda')


def _model(config, device):
    from ddsp_piano_torch.configs import get_model

    return get_model(config, device=device, duration=SECONDS, seed=0,
                     first_phase=True)


def _batch(model, b, seed):
    """A host batch of b rows: notes on a few voices, pedal, pianos and a
    target audio drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    n_frames = int(round(SECONDS * model.frame_rate))
    n_samples = int(round(SECONDS * model.sample_rate))
    cond = np.zeros((b, n_frames, model.n_synths, 2), np.float32)
    for row in range(b):
        for voice in range(min(6, model.n_synths)):
            start = int(rng.randint(0, n_frames - 20))
            end = int(rng.randint(start + 5, n_frames))
            cond[row, start:end, voice, 0] = rng.randint(30, 90)
            cond[row, start:start + 4, voice, 1] = rng.randint(20, 110) / 127
    pedal = (rng.rand(b, n_frames, 4) > 0.7).astype(np.float32)
    return {'conditioning': cond, 'pedal': pedal,
            'piano_model': rng.randint(0, 10, (b, 1)).astype(np.int32),
            'audio': (rng.randint(-16384, 16384, (b, n_samples))
                      / 32768.0).astype(np.float32)}


def _noise(model, b, seed, device):
    draw = torch.Generator(device=device).manual_seed(seed)
    n_samples = int(round(SECONDS * model.sample_rate))
    return 2.0 * torch.rand((model.n_synths * b, n_samples), generator=draw,
                            device=device) - 1.0


def _pair(config, device, **kwargs):
    """Two Trainers from the same weights: (graphs, eager)."""
    from ddsp_piano_torch.training.trainer import Trainer

    first, second = _model(config, device), _model(config, device)
    second.load_state_dict(first.state_dict())
    return (Trainer(first, first_phase=True, seed=3, **kwargs),
            Trainer(second, first_phase=True, seed=3, **kwargs))


def _eager_step(trainer, batch, noise=None):
    """One step composed from forward_backward and apply_gradients, with
    the noise draw of the Trainer's step."""
    losses = trainer.forward_backward(
        batch, noise=noise, generator=trainer.noise_generator(trainer.step))
    trainer.apply_gradients()
    trainer.step += 1
    return losses


def _state(trainer):
    """Parameters, then each one's Adam state (step, moments)."""
    out = [p.detach() for p in trainer.params]
    for p in trainer.params:
        state = trainer.optimizer.state[p]
        out += [state['step'], state['exp_avg'], state['exp_avg_sq']]
    return out


def _assert_same(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"{what}: tensor {i} differs"


def _assert_losses(got, want):
    assert list(got) == list(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


# dafx22's eager step does not repeat itself bit for bit on the card: the
# gradient of its z_encoder embedding (advanced indexing, whose gradient
# is accumulated in no fixed order) differs by a few 1e-8 between two
# eager steps on the same inputs. Its cases start each eager step from the
# graph path's state, hold the losses bit-equal and the state after the
# step within REPEAT_TOL.
REPEAT_TOL = 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize('config,bf16,noise,staging', [
    ('maestro_v2', False, 'injected', 'packed'),
    ('maestro_v2', False, 'drawn', 'packed'),
    ('maestro_v2', False, 'drawn', 'dict'),
    ('dafx22', False, 'injected', 'packed'),
    ('dafx22', False, 'drawn', 'dict'),
    ('maestro_v2', True, 'drawn', 'packed'),
])
def test_replayed_steps_equal_eager_steps(cuda_device, config, bf16, noise,
                                          staging):
    exact = config != 'dafx22'
    layers.enable_bf16_control(bf16)
    try:
        graphed, eager = _pair(config, cuda_device)
        batches = [_batch(graphed.model, 2, s) for s in range(STEPS)]
        if staging == 'packed':
            inputs = [graphed.pack_batch(b) for b in batches]
            eager_inputs = [eager.pack_batch(b) for b in batches]
        else:
            inputs = eager_inputs = batches
        noises = [_noise(graphed.model, 2, 10 + s, cuda_device)
                  if noise == 'injected' else None for s in range(STEPS)]
        got, want, gaps = [], [], []
        for x, y, n in zip(inputs, eager_inputs, noises):
            if not exact:
                torch._foreach_copy_(_state(eager), _state(graphed))
            got.append(graphed.train_step(x, noise=n))
            want.append(_eager_step(eager, y, n))
            gaps.append(max(float((g - w).abs().max()) for g, w in
                            zip(_state(graphed), _state(eager))))
        torch.cuda.synchronize()
    finally:
        layers.enable_bf16_control(False)
    assert (graphed.graph_captures, graphed.graph_replays,
            graphed.eager_steps) == (1, STEPS, 0)
    for g, w in zip(got, want):
        _assert_losses(g, w)
    # Each step's losses are its own: a later replay does not move them.
    assert len({g['total_loss'].data_ptr() for g in got}) == STEPS
    if exact:
        _assert_same(_state(graphed), _state(eager), 'state')
    else:
        assert max(gaps) <= REPEAT_TOL, gaps
    assert graphed.step == eager.step == STEPS
    graphed.check_pending()


@pytest.mark.cuda
def test_block_of_four_equals_four_single_steps(cuda_device):
    block_trainer, single = _pair('maestro_v2', cuda_device)
    batches = [_batch(single.model, 2, s) for s in range(4)]
    losses = block_trainer.train_steps(block_trainer.pack_block(batches))
    want = [single.train_step(single.pack_batch(b)) for b in batches]
    torch.cuda.synchronize()
    for k in losses:
        assert torch.equal(losses[k], torch.stack([w[k] for w in want])), k
    _assert_same(_state(block_trainer), _state(single), 'state')
    assert block_trainer.graph_replays == single.graph_replays == 4


@pytest.mark.cuda
def test_new_shape_is_captured_anew(cuda_device):
    graphed, eager = _pair('maestro_v2', cuda_device)
    shapes = (2, 3, 2, 3)
    batches = [_batch(graphed.model, b, s) for s, b in enumerate(shapes)]
    got = [graphed.train_step(b) for b in batches]
    want = [_eager_step(eager, b) for b in batches]
    torch.cuda.synchronize()
    assert (graphed.graph_captures, graphed.graph_replays) == (2, 4)
    for g, w in zip(got, want):
        _assert_losses(g, w)
    _assert_same(_state(graphed), _state(eager), 'state')


@pytest.mark.cuda
def test_non_finite_loss_raises_at_the_same_step(cuda_device):
    from ddsp_piano_torch.training.trainer import NanLossError

    graphed, eager = _pair('maestro_v2', cuda_device, nan_check_interval=2)
    good = _batch(graphed.model, 2, 0)
    bad = dict(good, audio=np.full_like(good['audio'], np.nan))
    errors = []
    for run in (graphed.train_step, _guarded_eager(eager)):
        with pytest.raises(NanLossError) as err:
            for b in (good, bad, good, good):
                run(b)
        errors.append(err.value)
    assert str(errors[0]) == str(errors[1])
    assert 'step 1 ' in str(errors[0])
    got, want = errors[0].state, errors[1].state
    assert got['step'] == want['step'] == 1
    _assert_same(list(got['model'].values()), list(want['model'].values()),
                 'model')
    for i, w in want['optimizer']['state'].items():
        g = got['optimizer']['state'][i]
        _assert_same([g['exp_avg'], g['exp_avg_sq']],
                     [w['exp_avg'], w['exp_avg_sq']], f'moments {i}')
    # The guard drains steps 0 and 1 at step 2 (two pending entries).
    assert graphed.step == eager.step == 3
    assert graphed.graph_replays == 3 and graphed.eager_steps == 0


def _guarded_eager(trainer):
    """train_step's snapshot and NaN guard around an eager step."""
    def run(batch):
        step = trainer.step
        slot = step % len(trainer._ring)
        trainer._snapshot(slot)
        losses = _eager_step(trainer, batch)
        trainer._guard(step, losses, slot)
        return losses
    return run


@pytest.mark.cuda
def test_launch_counters_and_profiler_events_of_replays(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    graphed, eager = _pair('maestro_v2', cuda_device)
    batches = [_batch(graphed.model, 2, s) for s in range(4)]
    graphed.train_step(batches[0])
    _eager_step(eager, batches[0])
    torch.cuda.synchronize()
    counts = []
    for step in (graphed.train_step, lambda b: _eager_step(eager, b)):
        build.reset_launches()
        for b in batches[1:]:
            step(b)
        torch.cuda.synchronize()
        counts.append(build.launch_counts())
    assert counts[0] == counts[1]
    assert all(counts[0][0][k] > 0 for k in KERNEL_NAMES)
    # The profiler records each graph-node kernel on every replay.
    build.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for b in batches[1:]:
            graphed.train_step(b)
        torch.cuda.synchronize()
    for counter, pattern in KERNEL_NAMES.items():
        events = sum(1 for e in prof.events()
                     if e.device_type.name == 'CUDA'
                     and re.search(pattern, e.name))
        assert events == build.LAUNCHES[counter] == counts[0][0][counter], \
            counter
