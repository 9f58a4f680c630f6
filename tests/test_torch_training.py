"""The port's training path against the JAX package's, on the CPU.

The spectral loss and its gradient, the optimizer (Adam, global-norm clip,
frozen parameters) and the whole maestro_v2 training step's gradients are
held against the JAX package on the same numpy inputs; the data pipeline,
batch staging, NaN guard, checkpoints and the train CLI run at a small
size. The JAX gradient of the whole step is computed once per module. The
10-step trajectories against the JAX trainer are held by the checks
check_ten_step_trajectory and check_loss_curve_distributions here, run
from test_torch_grad_kernels.py and test_torch_staging.py.
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

from ddsp_piano_torch.ops import core as tcore  # noqa: E402
from ddsp_piano_torch.ops import spectral as tspectral  # noqa: E402
from ddsp_piano_torch.params import flatten_tree, load_jax_params  # noqa
from ddsp_piano_tpu.ops import core as jcore  # noqa: E402
from ddsp_piano_tpu.ops import spectral as jspectral  # noqa: E402

V2_FFT_SIZES = (2048, 1024, 512, 256, 128, 64)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


# -- spectral ops and the v2 loss -----------------------------------------------


@pytest.mark.parametrize('n,length,step', [(1000, 256, 64), (999, 100, 30),
                                           (10, 64, 16)])
def test_frame_matches_tf_semantics(n, length, step):
    x = np.random.RandomState(n).randn(2, n).astype(np.float32)
    for pad_end in (True, False):
        if not pad_end and n < length:
            continue
        want = np.asarray(jspectral.frame(jnp.asarray(x), length, step,
                                          pad_end=pad_end))
        got = tspectral.frame(_t(x), length, step, pad_end=pad_end).numpy()
        np.testing.assert_array_equal(got, want)


def test_hann_window_and_safe_log_match():
    for length in (64, 65, 2048):
        # The port rounds the float64 window once; JAX evaluates
        # cos(2 pi n / L) in float32: up to 3.5 ulps of 1 (measured).
        np.testing.assert_allclose(
            tcore.hann_window(length).numpy(),
            np.asarray(jcore.hann_window(length)), atol=3e-7)
    x = np.array([-1.0, 0.0, 1e-6, 1e-5, 2e-5, 3.0], np.float32)
    got = _t(x).requires_grad_()
    tcore.safe_log(got).sum().backward()
    want = jax.grad(lambda v: jcore.safe_log(v).sum())(jnp.asarray(x))
    np.testing.assert_allclose(tcore.safe_log(_t(x)).numpy(),
                               np.asarray(jcore.safe_log(jnp.asarray(x))),
                               rtol=1e-7)
    # Zero below eps, as a where (a clamp would pass 1 at x == eps).
    np.testing.assert_array_equal(got.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize('weighted', [False, True])
def test_mean_difference_gradient_at_ties_matches_jax(weighted):
    """ROADMAP C.4: the L1 distance where a target bin equals a synth bin
    (nonzero, as when a student's weights equal its teacher's). jnp.abs's
    gradient at 0 is +1, so each tied bin passes -1/n to the synth side;
    torch.abs would pass 0. Held bit-exact against jax.grad."""
    rng = np.random.RandomState(4)
    target = rng.uniform(0.1, 2.0, (2, 9, 33)).astype(np.float32)
    value = target.copy()
    value[:, ::2] += rng.randn(2, 5, 33).astype(np.float32)
    weights = (rng.uniform(0.5, 1.5, (2, 9, 33)).astype(np.float32)
               if weighted else None)
    assert (target == value).sum() == 2 * 4 * 33

    def jax_loss(v):
        return jspectral.mean_difference(
            jnp.asarray(target), v, 'L1',
            None if weights is None else jnp.asarray(weights))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(value)))
    x = _t(value).requires_grad_()
    got = tspectral.mean_difference(
        _t(target), x, 'L1', None if weights is None else _t(weights))
    got.backward()
    # The mean's summation order differs: rtol 1e-6.
    np.testing.assert_allclose(float(got.detach()),
                               float(jax_loss(jnp.asarray(value))), rtol=1e-6)
    assert (want[target == value] != 0).all()
    np.testing.assert_array_equal(x.grad.numpy(), want)


@pytest.mark.parametrize('n_samples', [12000, 12345])
def test_spectral_loss_value_and_gradient_match(n_samples):
    """The v2 loss (L1 on magnitudes and log magnitudes over six FFT
    sizes) and its magnitude term alone, on random audio; 12345 samples is
    not a multiple of any hop."""
    rng = np.random.RandomState(n_samples)
    target = rng.uniform(-1, 1, (2, n_samples)).astype(np.float32)
    audio = (0.3 * rng.randn(2, n_samples)).astype(np.float32)
    weights = {'v2': (1.0, 1.0), 'magnitudes': (1.0, 0.0)}

    def jax_losses(a):
        return tuple(jspectral.multi_scale_spectral_loss(
            jnp.asarray(target), a, fft_sizes=V2_FFT_SIZES, loss_type='L1',
            mag_weight=m, logmag_weight=lg, sample_rate=24000)
            for m, lg in weights.values())

    want, pull = jax.vjp(jax.jit(jax_losses), jnp.asarray(audio))
    for i, (name, (m, lg)) in enumerate(weights.items()):
        x = _t(audio).requires_grad_()
        got = tspectral.multi_scale_spectral_loss(
            _t(target), x, fft_sizes=V2_FFT_SIZES, loss_type='L1',
            mag_weight=m, logmag_weight=lg, sample_rate=24000)
        got.backward()
        cotangent = tuple(jnp.float32(j == i) for j in range(len(weights)))
        want_grad = np.asarray(pull(cotangent)[0])
        # Value rtol 1e-5 (test_filters_spectral.py:316-327).
        np.testing.assert_allclose(float(got.detach()), float(want[i]),
                                   rtol=1e-5, err_msg=name)
        if name == 'magnitudes':
            # rtol 2e-3, atol 2e-5: test_filters_spectral.py:316-327 (two
            # FFT implementations).
            np.testing.assert_allclose(x.grad.numpy(), want_grad,
                                       rtol=2e-3, atol=2e-5)
        else:
            # The log-magnitude term's gradient is 1/|X| at every bin above
            # safe_log's 1e-5, so at near-silent bins it scales the two FFT
            # libraries' rounding by up to 1e5: 1e-2 of the gradient's
            # peak (measured 8.5e-3, at 59 of 24000 samples, all from the
            # 64-point FFT).
            err = np.abs(x.grad.numpy() - want_grad).max()
            assert err <= 1e-2 * np.abs(want_grad).max(), err


# -- the optimizer ---------------------------------------------------------------


def _v2_small(first_phase=True, duration=0.5):
    from ddsp_piano_torch.configs import get_model
    return get_model('maestro_v2', device='cpu', duration=duration,
                     n_synths=4, first_phase=first_phase)


@pytest.fixture(scope='module')
def jax_v2():
    """maestro_v2 with 4 voices (the GRU widths stay 64 / 192), its
    PRNGKey(0) params and its phase-1 trainable mask."""
    from ddsp_piano_tpu.configs import get_model as jax_get_model
    jmodel = jax_get_model('maestro_v2', duration=0.5, n_synths=4,
                           first_phase=True)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    mask = jmodel.trainable_mask(params, first_phase=True)
    return jmodel, params, mask


@pytest.fixture(scope='module')
def optax_v2(jax_v2):
    """optax's masked Adam with the global-norm clip, as the JAX trainer
    builds it (trainer.py:104-116), jitted once."""
    import optax

    _, params, mask = jax_v2
    labels = jax.tree.map(lambda m: 'train' if m else 'freeze', mask)
    tx = optax.multi_transform(
        {'train': optax.chain(optax.clip_by_global_norm(3.0),
                              optax.adam(1e-3)),
         'freeze': optax.set_to_zero()}, labels)

    @jax.jit
    def step(p, state, g):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    return tx, step


@pytest.mark.parametrize('steps,grad_scale', [(1, 1e-3), (3, 1e-3),
                                              (3, 1.0)],
                         ids=['1_step', '3_steps', '3_steps_clipped'])
def test_optimizer_matches_optax(jax_v2, optax_v2, steps, grad_scale):
    import optax

    from ddsp_piano_torch.training.trainer import Trainer

    _, params, mask = jax_v2
    tx, step = optax_v2
    rng = np.random.RandomState(steps)
    grads = jax.tree.map(
        lambda p: jnp.asarray(grad_scale * np.asarray(rng.randn(*p.shape)),
                              jnp.float32), params)
    norm = float(optax.global_norm(jax.tree.map(
        lambda g, m: g if m else jnp.zeros_like(g), grads, mask)))
    assert (norm > 3.0) == (grad_scale == 1.0)
    want, opt_state = params, tx.init(params)
    for _ in range(steps):
        want, opt_state = step(want, opt_state, grads)

    model = _v2_small()
    load_jax_params(model, jax.tree.map(np.asarray, params))
    trainer = Trainer(model, learning_rate=1e-3, first_phase=True)
    named_grads = dict(flatten_tree(jax.tree.map(np.asarray, grads)))
    for _ in range(steps):
        for name, p in trainer.named_params:
            p.grad = _t(named_grads[name])
        trainer.apply_gradients()
    want = dict(flatten_tree(jax.tree.map(np.asarray, want)))
    trainable = {n for n, _ in trainer.named_params}
    assert trainable == {n for n, m in flatten_tree(mask) if m}
    for name, p in model.named_parameters():
        # rtol 1e-6, and 1e-5 of the updates' size: optax forms the bias
        # correction 1 - 0.999^t in float32, where it loses 1.3e-5 to
        # cancellation; torch.optim.Adam forms it in float64.
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   rtol=1e-6, atol=1e-5 * 1e-3 * steps,
                                   err_msg=name)


def test_early_ir_regularization_matches_jax(jax_v2):
    """maestro_v2 with regularize_early (maestro-v2-regularized.gin): the
    L1 penalty on the early-IR embeddings; 0 without it."""
    from ddsp_piano_tpu.configs import get_model as jax_get_model

    _, params, _ = jax_v2
    jmodel = jax_get_model('maestro_v2', duration=0.5, n_synths=4,
                           regularize_early=True)
    for regularize in (True, False):
        model = _v2_small()
        model.reverb_model.regularize_early = regularize
        load_jax_params(model, jax.tree.map(np.asarray, params))
        want = (float(jmodel.regularization_loss(params)) if regularize
                else 0.0)
        np.testing.assert_allclose(model.regularization_loss().item(), want,
                                   rtol=1e-6)
    assert want == 0.0 and float(jmodel.regularization_loss(params)) > 0.0


# -- the whole step ---------------------------------------------------------------


def _v2_batch(n_synths=4, n_frames=125, sample_rate=24000, seed=0):
    """Two 0.5 s segments: held notes, onsets, a release, pedals; the
    target audio drawn like get_dummy_data's."""
    rng = np.random.RandomState(seed)
    cond = np.zeros((2, n_frames, n_synths, 2), np.float32)
    for b in range(2):
        for voice, (pitch, start, end) in enumerate(
                [(43 + b, 5, 110), (59, 20, 60), (67 - b, 40, n_frames),
                 (72, 80, 100)][:n_synths]):
            cond[b, start:end, voice, 0] = pitch
            cond[b, start:start + 4, voice, 1] = 0.4 + 0.1 * voice
    pedal = np.zeros((2, n_frames, 4), np.float32)
    pedal[1, 30:, 0] = 0.7
    n_samples = n_frames * sample_rate // 250
    return {'conditioning': cond, 'pedal': pedal,
            'audio': rng.uniform(0.0, 1.0, (2, n_samples)).astype(np.float32),
            'piano_model': np.array([[3], [7]], np.int32)}


@pytest.fixture(scope='module')
def whole_step(jax_v2):
    """jax.grad of the v2 total_loss, and of its magnitude term alone, and
    the port's Trainer gradients on the same params, batch and noise.

    As in test_torch_render, the JAX tuning and additive synth run op by op
    (under jit XLA contracts multiply-adds, which moves partial frequencies
    by an ulp and the audio by ~1e-3 of peak); the networks, the reverb,
    the noise synth and the losses, which carry no oscillator phase, run
    jitted."""
    from ddsp_piano_torch.training.trainer import Trainer
    from ddsp_piano_tpu.models import losses as jlosses

    jmodel, params, _ = jax_v2
    for net in (jmodel.context_network, jmodel.monophonic_network,
                jmodel.reverb_model):
        net.apply = jax.jit(net.apply, static_argnames='training')
    for proc in (jmodel.processor_group.noise, jmodel.processor_group.reverb):
        proc.get_signal = jax.jit(proc.get_signal)
    mag = jlosses.SpectralLoss(loss_type='L1', mag_weight=1.0,
                               sample_rate=24000, name='magnitudes')
    for loss in (jmodel.loss_objs[0], mag):
        loss._loss = jax.jit(loss._loss)
    batch = _v2_batch()
    feats = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(7)
    # The noise synth's draw inside VectorizedPolyphonicProcessorGroup.
    noise = jax.random.uniform(jax.random.fold_in(rng, 1), (8, 12000),
                               jnp.float32, -1.0, 1.0)

    def losses_fn(p):
        outputs = jmodel(p, feats, training=True, rng=rng)
        return outputs['losses']['total_loss'], mag.compute(outputs)

    want_loss, pull = jax.vjp(losses_fn, params)
    want = {}
    for i, name in enumerate(('v2', 'magnitudes')):
        grads = pull((jnp.float32(i == 0), jnp.float32(i == 1)))[0]
        want[name] = (float(want_loss[i]),
                      dict(flatten_tree(jax.tree.map(np.asarray, grads))))

    model = _v2_small()
    load_jax_params(model, jax.tree.map(np.asarray, params))
    trainer = Trainer(model, first_phase=True)
    got = {}
    for name, logmag_weight in (('v2', 1.0), ('magnitudes', 0.0)):
        model.loss_objs[0].logmag_weight = logmag_weight
        losses = trainer.forward_backward(
            {k: torch.from_numpy(v) for k, v in batch.items()},
            noise=torch.from_numpy(np.array(noise)))
        got[name] = (losses, {n: (None if p.grad is None
                                  else p.grad.numpy().copy())
                              for n, p in model.named_parameters()})
    model.loss_objs[0].logmag_weight = 1.0
    return want, got, jax_v2[2]


@pytest.mark.parametrize('loss', ['v2', 'magnitudes'])
def test_whole_step_loss_matches_jax(whole_step, loss):
    want_loss = whole_step[0][loss][0]
    losses = whole_step[1][loss][0]
    assert np.isfinite(want_loss)
    # rtol 1e-4: the slice's render tolerance, as a share of the loss
    # (measured 5e-7).
    np.testing.assert_allclose(float(losses['total_loss']), want_loss,
                               rtol=1e-4)
    assert float(losses['regularization_loss']) == 0.0


@pytest.mark.parametrize('loss', ['v2', 'magnitudes'])
def test_whole_step_gradients_match_jax(whole_step, loss):
    want = whole_step[0][loss][1]
    got = whole_step[1][loss][1]
    errs, flat_got, flat_want = {}, [], []
    for name, g in got.items():
        if g is None:                       # frozen: no gradient
            assert name.startswith('inharm_model.'), name
            continue
        peak = np.abs(want[name]).max()
        errs[name] = np.abs(g - want[name]).max() / max(peak, 1e-30)
        flat_got.append(g.ravel())
        flat_want.append(want[name].ravel())
    assert set(errs) == {n for n, m in flatten_tree(whole_step[2]) if m}
    if loss == 'magnitudes':
        # 1e-3 x each leaf's peak: degree-6 forward and degree-4 backward
        # oscillator trig against JAX's native transcendentals, float32
        # phase (measured 1.4e-4).
        assert max(errs.values()) <= 1e-3, sorted(errs.items(),
                                                  key=lambda kv: kv[1])[-3:]
        return
    # With the log-magnitude term, 1/|X| at near-silent bins of the
    # initial model's audio scales the ~1e-5-of-peak render difference
    # (JAX's float32 phase cumsum) by up to 1e5; JAX's own jitted and
    # op-by-op gradients of this step differ by 2.6 % of a leaf's peak at
    # the median leaf. Held: 0.1 of each leaf's peak (measured 7.7e-2) and
    # the direction of the whole gradient (cosine 0.99935 measured).
    assert max(errs.values()) <= 0.1, sorted(errs.items(),
                                             key=lambda kv: kv[1])[-3:]
    g, w = np.concatenate(flat_got), np.concatenate(flat_want)
    assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.999


def test_phase_with_no_trainable_parameter_matches_jax(jax_v2):
    """maestro_v2's even phase trains none of its parameters (the joint
    tuning is pretrained and frozen). The JAX trainer's masked optax step
    (all leaves set_to_zero) still takes the step: same losses, no update.
    The port's Trainer builds no optimizer, computes the losses, runs no
    backward, changes no parameter and advances its step."""
    from ddsp_piano_torch.training.trainer import Trainer
    from ddsp_piano_tpu.configs import get_model as jax_get_model
    from ddsp_piano_tpu.parallel import mesh as mesh_lib
    from ddsp_piano_tpu.training.trainer import Trainer as JaxTrainer

    _, params, _ = jax_v2
    jmodel = jax_get_model('maestro_v2', duration=0.5, n_synths=4,
                           first_phase=False)
    jtrainer = JaxTrainer(jmodel, first_phase=False,
                          mesh=mesh_lib.get_mesh(1))
    state = jtrainer.state_with_params(
        jtrainer.init_state(jax.random.PRNGKey(0)), params)
    assert not any(jax.tree.leaves(jtrainer._mask))
    batch = _v2_batch()
    rng = jax.random.PRNGKey(7)
    # The noise synth's draw inside the JAX step (models/dag.py:123).
    noise = jax.random.uniform(jax.random.fold_in(rng, 1), (8, 12000),
                               jnp.float32, -1.0, 1.0)
    new_state, want = jtrainer.train_step(state, batch, rng=rng)
    jax.tree.map(np.testing.assert_array_equal, new_state.params, params)

    model = _v2_small(first_phase=False)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    trainer = Trainer(model, first_phase=False)
    assert trainer.params == [] and trainer.optimizer is None
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = trainer.train_step(batch, noise=torch.from_numpy(
        np.array(noise)))
    trainer.check_pending()
    assert trainer.step == 1
    for name, p in model.named_parameters():
        assert p.grad is None, name
        torch.testing.assert_close(p.detach(), before[name], rtol=0, atol=0)
    assert sorted(losses) == sorted(want)
    for key in want:
        # rtol 1e-4, as test_whole_step_loss_matches_jax holds the loss.
        np.testing.assert_allclose(float(losses[key]), float(want[key]),
                                   rtol=1e-4, err_msg=key)


# The trajectory and loss-curve tests (ROADMAP C.1) run the checks below
# from test_torch_grad_kernels.py (v2 loss) and test_torch_staging.py
# (magnitudes), one loss a file, so that pytest-xdist's --dist loadfile
# spreads their ~300 s over two workers (it hands out the files with the
# most tests first, so each sits in a file of many); each file computes its
# own loss's trajectories once.
TRAJECTORY_STEPS = 10
# The start of the control trajectory: every weight times 1 + 2^-22, a
# rounding-level change.
TRAJECTORY_NUDGE = 2.0 ** -22
# The nudged starts of the loss-curve distributions (ROADMAP C.1): weights
# times 1 + k 2^-22, k = 0..3, for each package.
TRAJECTORY_STARTS = 4
# Each step's mean loss over the starts, port against JAX: within this
# many pooled standard errors (two-sided t with 6 degrees of freedom:
# 5.96 at 0.999).
TRAJECTORY_SE_MULTIPLE = 6.0
_TRAJECTORIES = {}
_JAX_TRAINERS = {}


def _trajectory_inputs():
    batches = [_v2_batch(seed=step) for step in range(TRAJECTORY_STEPS)]
    rngs = [jax.random.PRNGKey(100 + step)
            for step in range(TRAJECTORY_STEPS)]
    # The noise synth's draw inside the JAX step (models/dag.py:123).
    draws = [jax.random.uniform(jax.random.fold_in(rng, 1), (8, 12000),
                                jnp.float32, -1.0, 1.0) for rng in rngs]
    return batches, rngs, draws


def _port_trajectory(params, batches, draws, logmag_weight, nudge=0.0):
    from ddsp_piano_torch.training.trainer import Trainer

    model = _v2_small()
    load_jax_params(model, jax.tree.map(np.asarray, params))
    model.loss_objs[0].logmag_weight = logmag_weight
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.0 + nudge)
    trainer = Trainer(model, first_phase=True)
    losses = [float(trainer.train_step(b, noise=torch.from_numpy(
        np.array(n)))['total_loss']) for b, n in zip(batches, draws)]
    trainer.check_pending()
    return np.array(losses), trainer


def _jax_trainer(logmag_weight):
    """The JAX package's Trainer for a loss, built (and its step compiled)
    once per module."""
    from ddsp_piano_tpu.configs import get_model as jax_get_model
    from ddsp_piano_tpu.parallel import mesh as mesh_lib
    from ddsp_piano_tpu.training.trainer import Trainer as JaxTrainer

    if logmag_weight not in _JAX_TRAINERS:
        jmodel = jax_get_model('maestro_v2', duration=0.5, n_synths=4,
                               first_phase=True)
        jmodel.loss_objs[0].logmag_weight = logmag_weight
        _JAX_TRAINERS[logmag_weight] = JaxTrainer(
            jmodel, first_phase=True, mesh=mesh_lib.get_mesh(1))
    return _JAX_TRAINERS[logmag_weight]


def _jax_trajectory(params, batches, rngs, logmag_weight, nudge=0.0):
    jtrainer = _jax_trainer(logmag_weight)
    start = jax.tree.map(lambda p: p * jnp.float32(1.0 + nudge), params)
    state = jtrainer.state_with_params(
        jtrainer.init_state(jax.random.PRNGKey(0)), start)
    losses = []
    for batch, rng in zip(batches, rngs):
        state, step_losses = jtrainer.train_step(state, batch, rng=rng)
        losses.append(float(step_losses['total_loss']))
    return np.array(losses), state


def _trajectory(package, loss, k, params):
    """The 10-step loss curve of ``package`` ('port' or 'jax') from the
    weights times 1 + k 2^-22, computed once per module (with the port's
    Trainer or the JAX state after the last step)."""
    key = (package, loss, k)
    if key not in _TRAJECTORIES:
        batches, rngs, draws = _trajectory_inputs()
        logmag_weight = 1.0 if loss == 'v2' else 0.0
        nudge = k * TRAJECTORY_NUDGE
        _TRAJECTORIES[key] = (
            _port_trajectory(params, batches, draws, logmag_weight, nudge)
            if package == 'port' else
            _jax_trajectory(params, batches, rngs, logmag_weight, nudge))
    return _TRAJECTORIES[key]


def check_ten_step_trajectory(jax_v2, loss):
    """The port's Trainer against the JAX package's for 10 steps of the
    v2 loss (magnitudes and log magnitudes) and of its magnitude term
    alone, from the same parameters, on the same batches and the same
    injected noise draws.

    The trajectory is chaotic at init: Adam's first updates are ~lr times
    the sign of each gradient, and the v2 loss's gradients are
    ill-conditioned at near-silent bins (7.7e-2 of a leaf's peak from
    jax.grad, test_whole_step_gradients_match_jax). Measured: a weight
    change of 2^-22 moves the port's own v2 loss by up to 2.2 % within 10
    steps, and the port's v2 losses part from JAX's by 1.7e-3 at step 1
    and up to 5.1 % (magnitudes alone: 1.4 % and 1.2e-3). So each step's
    loss is held at rtol 1e-3 only at the first step, where the
    parameters are the same, and the whole trajectory against that
    control: the port's largest gap to JAX within four times the
    control's largest gap. The curves' distributions are held by
    check_loss_curve_distributions. The final
    parameters' largest gap, a share of each leaf's peak, is printed."""
    _, params, mask = jax_v2
    want, state = _trajectory('jax', loss, 0, params)
    got, trainer = _trajectory('port', loss, 0, params)
    control, _ = _trajectory('port', loss, 1, params)
    final = dict(flatten_tree(jax.tree.map(np.asarray, state.params)))
    gaps = {name: float(np.abs(p.detach().numpy() - final[name]).max()
                        / max(np.abs(final[name]).max(), 1e-30))
            for name, p in trainer.named_params}
    worst = max(gaps, key=gaps.get)
    gap = np.abs(got - want) / want
    control_gap = np.abs(control - got) / got
    fmt = lambda a: np.array2string(a, precision=2, max_line_width=200)
    print(f"\n{loss} loss, {TRAJECTORY_STEPS} steps, port / JAX: "
          + ', '.join(f"{g:.5f}/{w:.5f}" for g, w in zip(got, want))
          + f"; relative gap {fmt(gap)}, largest {gap.max():.3g}; control "
          f"(weights x (1 + 2^-22)) {fmt(control_gap)}, largest "
          f"{control_gap.max():.3g}; final parameters, gap / leaf peak: "
          f"worst {worst} {gaps[worst]:.3g}, median "
          f"{np.median(list(gaps.values())):.3g}")
    assert set(gaps) == {n for n, m in flatten_tree(mask) if m}
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    assert gap.max() <= 4.0 * control_gap.max(), (gap, control_gap)


def check_loss_curve_distributions(jax_v2, loss):
    """ROADMAP C.1: the distributions of the 10-step loss curves, from
    TRAJECTORY_STARTS nudged starts of each package (weights x (1 + k
    2^-22), k = 0..3), on the batches and draws of
    check_ten_step_trajectory, whose trajectories it shares. No per-step
    bound holds between two single trajectories of this chaotic start
    (JAX's own nudged curves part by up to 1.2 %); the means of the two
    packages' curves must agree at every step within
    TRAJECTORY_SE_MULTIPLE pooled standard errors. Measured: at most 3.15
    (v2 loss, step 4) and 1.26 (magnitudes, step 3). Each step's means,
    spreads and bound are printed."""
    _, params, _ = jax_v2
    curves = {package: np.stack([_trajectory(package, loss, k, params)[0]
                                 for k in range(TRAJECTORY_STARTS)])
              for package in ('port', 'jax')}
    n = TRAJECTORY_STARTS
    mean = {p: c.mean(axis=0) for p, c in curves.items()}
    sd = {p: c.std(axis=0, ddof=1) for p, c in curves.items()}
    se = np.sqrt((sd['port'] ** 2 + sd['jax'] ** 2) / n)
    bound = TRAJECTORY_SE_MULTIPLE * se
    diff = np.abs(mean['port'] - mean['jax'])
    print(f"\n{loss} loss, {n} starts a package, per step: " + '; '.join(
        f"{s}: port {mp:.5f} (sd {sp:.2e}) jax {mj:.5f} (sd {sj:.2e}) "
        f"|diff| {d:.2e} = {d / max(e, 1e-30):.2f} se, bound {b:.2e}"
        for s, (mp, sp, mj, sj, d, e, b) in enumerate(zip(
            mean['port'], sd['port'], mean['jax'], sd['jax'], diff, se,
            bound))))
    assert all(np.isfinite(c).all() for c in curves.values())
    assert (diff <= bound).all(), (diff, bound)


@pytest.mark.parametrize('config,trainable', [('maestro_v2', 0),
                                              ('dafx22', 7)])
def test_second_phase_optimizer(config, trainable):
    """The even phase's optimizer: none for maestro_v2, Adam over the 7
    frequency-module parameters for dafx22 (unchanged)."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.training.trainer import Trainer

    model = get_model(config, device='cpu', duration=0.25, n_synths=4,
                      first_phase=False)
    trainer = Trainer(model, first_phase=False)
    assert len(trainer.params) == trainable
    if trainable:
        assert trainer.optimizer.param_groups[0]['params'] == trainer.params
    else:
        assert trainer.optimizer is None
    assert trainer.state_dict()['optimizer'] == (
        None if not trainable else trainer.optimizer.state_dict())


def test_training_step_after_an_inference_mode_render():
    """A render under torch.inference_mode (the synthesize CLI's) followed
    by a training step in the same process: device constants cached by the
    render must not be inference tensors."""
    from ddsp_piano_torch.training.trainer import Trainer

    model = _v2_small(duration=0.25)
    batch = {k: torch.from_numpy(v) for k, v in _v2_batch(n_frames=62).items()}
    with torch.inference_mode():
        model(batch)
    losses = Trainer(model, first_phase=True).forward_backward(batch)
    assert np.isfinite(float(losses['total_loss']))


# -- pipeline, staging, guard, checkpoints, CLI -------------------------------------


def _write_mini_maestro(root, sample_rate=16000, seconds=6.0):
    """A two-row maestro-v3.0.0.csv (train and validation) over one MIDI
    file of at most three voices and one sine-mix wav."""
    from ddsp_piano_torch.data import audio_io, midi

    os.makedirs(root, exist_ok=True)
    notes = [midi.Note(48 + 5 * (i % 3), 70, 0.4 * i, 0.4 * i + 0.9)
             for i in range(int(seconds / 0.4) - 2)]
    midi.write_midi(os.path.join(root, 'track.midi'), notes)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    audio = 0.2 * np.sin(2 * np.pi * 220.0 * t) * np.exp(-(t % 0.4) * 4)
    audio_io.write_wav(os.path.join(root, 'track.wav'), audio, sample_rate)
    with open(os.path.join(root, 'maestro-v3.0.0.csv'), 'w') as f:
        f.write('canonical_composer,canonical_title,split,year,'
                'midi_filename,audio_filename,duration\n')
        for split, year in (('train', 2018), ('validation', 2017)):
            f.write(f'Nobody,Etude,{split},{year},track.midi,track.wav,'
                    f'{seconds}\n')
    return root


def test_pipeline_matches_jax_package(tmp_path):
    from ddsp_piano_torch.data import pipeline as tpipe
    from ddsp_piano_tpu.data import pipeline as jpipe

    root = _write_mini_maestro(str(tmp_path))
    csv_path = os.path.join(root, 'maestro-v3.0.0.csv')
    for split, year in ((None, None), ('train', None), ('validation', 2017)):
        rows, n, models = tpipe.dataset_from_csv(csv_path, split, year)
        want_rows, want_n, want_models = jpipe.dataset_from_csv(
            csv_path, split, year)
        assert n == want_n
        np.testing.assert_array_equal(models, want_models)
        assert [dict(r) for r in rows] == [
            {k: (v.item() if hasattr(v, 'item') else v)
             for k, v in r.items()} for r in want_rows]
    # A small shuffle buffer: the default 256 segments would load the
    # one track 128 times before the first batch.
    kwargs = dict(batch_size=2, sample_rate=24000, max_polyphony=4,
                  num_parallel_calls=1, shuffle_buffer_segments=4)
    got = next(tpipe.get_training_dataset(root, **kwargs))
    want = next(jpipe.get_training_dataset(root, **kwargs))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got['audio'].shape == (2, 72000)
    val = list(tpipe.get_validation_dataset(root, **kwargs))
    assert len(val) == len(list(jpipe.get_validation_dataset(root, **kwargs)))
    assert all(int(b['piano_model'][0, 0]) == 0 for b in val)


def test_batch_stager_on_cpu_keeps_arrays():
    from ddsp_piano_torch.training.trainer import BatchStager

    batch = _v2_batch()
    staged = BatchStager(torch.device('cpu'))(dict(batch, filename=['x']))
    assert sorted(staged) == sorted(batch)
    for k, v in batch.items():
        np.testing.assert_array_equal(staged[k].numpy(), v)
    with pytest.raises(TypeError, match='float32 and int32'):
        BatchStager(torch.device('cpu'))({'x': np.zeros(3, np.float64)})


@pytest.mark.parametrize('staging', ['dict', 'packed'])
def test_train_step_on_the_cpu_is_the_eager_step(staging):
    """Off a card the step runs eagerly: train_step's losses and
    parameters equal forward_backward and apply_gradients', no graph is
    captured, and each step's losses are tensors of their own."""
    from ddsp_piano_torch.training.trainer import Trainer

    model, twin = _v2_small(duration=0.25), _v2_small(duration=0.25)
    twin.load_state_dict(model.state_dict())
    trainer = Trainer(model, first_phase=True, seed=5)
    eager = Trainer(twin, first_phase=True, seed=5)
    batches = [_v2_batch(n_frames=62, seed=s) for s in range(2)]
    stage = ((lambda t, b: t.pack_batch(b)) if staging == 'packed'
             else (lambda t, b: b))
    got = [trainer.train_step(stage(trainer, b)) for b in batches]
    for k, b in enumerate(batches):
        want = eager.forward_backward(stage(eager, b),
                                      generator=eager.noise_generator(k))
        eager.apply_gradients()
        eager.step += 1
        for key, value in want.items():
            torch.testing.assert_close(got[k][key], value, rtol=0, atol=0)
    for p, q in zip(trainer.params, eager.params):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    assert (trainer.graph_captures, trainer.graph_replays,
            trainer.eager_steps) == (0, 0, 2)
    assert got[0]['total_loss'].data_ptr() != got[1]['total_loss'].data_ptr()
    assert float(got[0]['total_loss']) != float(got[1]['total_loss'])


@pytest.mark.parametrize('adam_state', ['lazy', 'made'])
def test_nan_guard_and_checkpoint_round_trip(tmp_path, adam_state):
    """The NaN guard's state and a checkpoint restore to the same next
    step, with Adam's state made at its first step (the CPU's) or made
    before it (a card's capturable Adam, _init_adam_state)."""
    from ddsp_piano_torch.training.trainer import (NanLossError, Trainer,
                                                   _init_adam_state)

    def new_trainer(model, **kwargs):
        trainer = Trainer(model, first_phase=True, **kwargs)
        if adam_state == 'made':
            _init_adam_state(trainer.optimizer)
        return trainer

    model = _v2_small(duration=0.25)
    trainer = new_trainer(model, nan_check_interval=2)
    batch = _v2_batch(n_frames=62)
    trainer.train_step(batch)
    path = trainer.save(str(tmp_path / 'last_iter'), meta={'x': 1.5})
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    bad = dict(batch, audio=np.full_like(batch['audio'], np.nan))
    trainer.train_step(bad)          # step 1: non-finite, not checked yet
    trainer.train_step(batch)        # step 2
    with pytest.raises(NanLossError, match='step 1') as err:
        trainer.train_step(batch)    # the guard drains steps 1 and 2
    assert (trainer.graph_replays, trainer.eager_steps) == (0, 4)
    state = err.value.state
    assert state['step'] == 1
    for name, value in saved.items():
        torch.testing.assert_close(state['model'][name], value, rtol=0,
                                   atol=0)
    fresh = new_trainer(_v2_small(duration=0.25))
    assert fresh.restore(os.path.dirname(path)) == {'x': 1.5}
    assert fresh.step == 1
    for name, p in fresh.model.named_parameters():
        torch.testing.assert_close(p.detach(), saved[name], rtol=0, atol=0)
    # NanLossError.state, saved and restored, gives the checkpoint's next
    # step: the same parameters, moments and Adam step count.
    again = new_trainer(_v2_small(duration=0.25))
    again.restore(trainer.save(str(tmp_path / 'nan_state'), state=state))
    want, got = fresh.train_step(batch), again.train_step(batch)
    assert fresh.step == again.step == 2
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    for p, q in zip(again.params, fresh.params):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    for p, q in zip(again.params, fresh.params):
        for key, value in fresh.optimizer.state[q].items():
            torch.testing.assert_close(again.optimizer.state[p][key], value,
                                       rtol=0, atol=0)


def test_train_cli_on_cpu(tmp_path, monkeypatch):
    """python -m ddsp_piano_torch.train_single_phase on a mini-MAESTRO:
    one step and a validation batch, with 4 voices, 16 partials and a
    4-segment shuffle buffer so it runs in seconds on the CPU; then
    --auto_resume finds the phase done."""
    from ddsp_piano_torch import configs
    from ddsp_piano_torch import train_single_phase as cli

    from ddsp_piano_torch.data import pipeline

    real_get_model = configs.get_model
    monkeypatch.setattr(configs, 'get_model', lambda *a, **kw: real_get_model(
        *a, n_synths=4, n_harmonics=16, **kw))
    real_dataset = pipeline.get_training_dataset
    monkeypatch.setattr(pipeline, 'get_training_dataset',
                        lambda *a, **kw: real_dataset(
                            *a, shuffle_buffer_segments=4, **kw))
    root = _write_mini_maestro(str(tmp_path / 'maestro'))
    exp = str(tmp_path / 'exp')
    argv = ['-b', '1', '-s', '1', '-e', '1', '--device', 'cpu', '--seed', '3',
            root, exp]
    result = cli.main(cli.process_args(argv))
    assert len(result['step_losses']) == 1
    assert np.isfinite(result['step_losses']).all()
    assert np.isfinite(result['val_losses']['total_loss'])
    assert os.path.isfile(os.path.join(exp, 'phase_1', 'last_iter',
                                       'ckpt.pt'))
    again = cli.main(cli.process_args(argv[:-2] + ['--auto_resume', root,
                                                   exp]))
    assert again['step_losses'] == [] and again['trainer'].step == 1


def test_train_cli_phase_2_on_cpu(tmp_path, monkeypatch):
    """train_single_phase -c maestro_v2 -p 2, restored from a phase-1
    checkpoint: one step that trains nothing, a validation batch, and a
    last_iter checkpoint holding the restored parameters unchanged; a
    phase-3 run restores that checkpoint and rebuilds Adam's moments."""
    from ddsp_piano_torch import configs
    from ddsp_piano_torch import train_single_phase as cli
    from ddsp_piano_torch.data import pipeline

    real_get_model = configs.get_model
    monkeypatch.setattr(configs, 'get_model', lambda *a, **kw: real_get_model(
        *a, n_synths=4, n_harmonics=16, **kw))
    real_dataset = pipeline.get_training_dataset
    monkeypatch.setattr(pipeline, 'get_training_dataset',
                        lambda *a, **kw: real_dataset(
                            *a, shuffle_buffer_segments=4, **kw))
    root = _write_mini_maestro(str(tmp_path / 'maestro'))
    exp = str(tmp_path / 'exp')
    common = ['-c', 'maestro_v2', '-b', '1', '-s', '1', '-e', '1',
              '--device', 'cpu', '--seed', '3']
    first = cli.main(cli.process_args(common + [root, exp]))
    phase1 = os.path.join(exp, 'phase_1', 'last_iter')
    second = cli.main(cli.process_args(common + ['-p', '2', '-r', phase1,
                                                 root, exp]))
    assert second['trainer'].optimizer is None
    assert second['trainer'].step == 2
    assert len(second['step_losses']) == 1
    assert np.isfinite(second['step_losses']).all()
    assert np.isfinite(second['val_losses']['total_loss'])
    saved = torch.load(os.path.join(exp, 'phase_2', 'last_iter', 'ckpt.pt'),
                       weights_only=True)
    assert saved['optimizer'] is None and saved['step'] == 2
    want = first['trainer'].model.state_dict()
    for name, value in saved['model'].items():
        torch.testing.assert_close(value, want[name], rtol=0, atol=0)
    third = cli.main(cli.process_args(
        common + ['-p', '3', '-r', os.path.join(exp, 'phase_2', 'last_iter'),
                  root, exp]))
    assert third['trainer'].optimizer is not None
    assert third['trainer'].step == 3
