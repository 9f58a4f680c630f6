"""The opt-in bf16 control networks (nn.layers.enable_bf16_control), on the
CPU, against the JAX package's switch of the same name.

- The switch is off by default, and switching it off again gives the
  float32 outputs and gradients back bit for bit.
- Dense and GRU under the switch against JAX's under its switch, each
  layer on its own, at u = 6, 64 and 192: the forward within 1e-3 of peak
  (measured: Dense bit-equal; the GRU up to 2.05e-4 at u = 192 over seeds
  0-3, where JAX's own bf16 output is 3.3e-3 to 5.3e-3 of peak from its
  float32 one, and the port's float32 output, which the test holds above
  the tolerance, 3.8e-3 to 4.6e-3).
- Their gradients against jax.grad under the switch, each leaf as a
  relative Frobenius distance (GRAD_TOL, about twice the most measured over
  seeds 0-2); each tolerance is below the distance of the port's float32
  gradient from JAX's bf16 one (JAX's own bf16-to-float32 distance, to
  1e-6), which the test prints. Both sides round to
  bf16 at the same points, but a float32 value an ulp apart on the two
  sides (their sums and transcendentals differ in the last place) rounds
  to bf16 values 2^-8 apart now and then, and the recurrence carries such
  a flip on: at u = 192 every leaf of the GRU differs somewhere. A maximum
  over a leaf measures one flip; the Frobenius distance measures them
  all. The rounding model matters more than the flips: leaving out the
  rounding of the carry's cotangent, adding one to its product, or
  rounding the recurrent weight gradient once instead of each step moves
  the u = 64 gradients 10 to 45 times further from JAX's.
- The plain bf16 scan, its backward and the weight contractions against a
  float64 emulation of the rounding points that their docstrings state;
  the step-by-step references that the card holds K2's and K5's bf16
  instances to give the plain versions back.
- A narrow maestro_v2 render (4 voices, 16 harmonics, 0.25 s) under both
  switches against JAX's (RENDER_TOL, measured; a Frobenius distance, as
  flips move its controls by bf16 steps).
"""

import functools

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

from ddsp_piano_torch.kernels import gru as kgru  # noqa: E402
from ddsp_piano_torch.nn import layers as tlayers  # noqa: E402
from ddsp_piano_tpu.nn import layers as jlayers  # noqa: E402

# (units, steps, batch, input features) of each case.
SIZES = {6: (6, 10, 1, 4), 64: (64, 200, 2, 16), 192: (192, 200, 4, 32)}
FWD_TOL = 1e-3
# Relative Frobenius distance of each gradient leaf from JAX's, by u.
# Measured here: u = 6 all 0 but the GRU bias 1.0e-7; u = 64 GRU kernel
# 2.2e-5, recurrent kernel 1.1e-6, bias 2.3e-7, input 7.0e-6; u = 192 GRU
# kernel 1.14e-3, recurrent 4.8e-4, bias 8.7e-5, input 1.07e-3; Dense at
# most 1.9e-5. Over three other seeds of weights and draws, at most: u = 64
# 7.1e-4, 2.1e-4, 2.9e-5, 3.1e-4; u = 192 1.38e-3, 6.0e-4, 1.05e-4,
# 1.23e-3; Dense 5.6e-5.
GRAD_TOL = {
    6: {'kernel': 1e-6, 'recurrent_kernel': 1e-6, 'bias': 1e-6, 'x': 1e-6},
    64: {'kernel': 1.5e-3, 'recurrent_kernel': 5e-4, 'bias': 1e-4,
         'x': 7e-4},
    192: {'kernel': 2.5e-3, 'recurrent_kernel': 1.2e-3, 'bias': 2.5e-4,
          'x': 2.5e-3},
}
DENSE_GRAD_TOL = 2e-4


@pytest.fixture()
def bf16():
    """Both packages' switches on for the test, off again after it."""
    tlayers.enable_bf16_control(True)
    jlayers.enable_bf16_control(True)
    try:
        yield
    finally:
        tlayers.enable_bf16_control(False)
        jlayers.enable_bf16_control(False)


def _weights(kind, u, d, seed):
    """Seeded weights of a Dense(u, d) or a GRU(u, d), as numpy arrays
    under the leaves' names, and the input and output cotangent draws."""
    rng = np.random.RandomState(seed)
    if kind == 'gru':
        limit = np.sqrt(6.0 / (d + 3 * u))
        q, _ = np.linalg.qr(rng.randn(3 * u, u))
        params = {'kernel': rng.uniform(-limit, limit, (d, 3 * u)),
                  'recurrent_kernel': q.T,
                  'bias': 0.1 * rng.randn(2, 3 * u)}
    else:
        limit = np.sqrt(6.0 / (d + u))
        params = {'kernel': rng.uniform(-limit, limit, (d, u)),
                  'bias': 0.1 * rng.randn(u)}
    return {k: v.astype(np.float32) for k, v in params.items()}


@functools.lru_cache(maxsize=None)
def _case(kind, u, seed=0):
    _, t, b, d = SIZES[u]
    params = _weights(kind, u, d, seed)
    rng = np.random.RandomState(seed + 100)
    x = rng.randn(b, t, d).astype(np.float32)
    g = rng.randn(b, t, u).astype(np.float32)
    jmod = (jlayers.GRU if kind == 'gru' else jlayers.Dense)(u, d)
    tmod = (tlayers.GRU if kind == 'gru' else tlayers.Dense)(u, d)
    with torch.no_grad():
        for name, value in params.items():
            getattr(tmod, name).copy_(torch.from_numpy(value))
    return params, x, g, jmod, tmod


@functools.lru_cache(maxsize=None)
def _jax_bf16(kind, u):
    """JAX's (output, {leaf: gradient, 'x': input gradient}) of sum(y * g)
    under its switch, traced afresh."""
    params, x, g, jmod, _ = _case(kind, u)
    jlayers.enable_bf16_control(True)
    try:
        return _jax_grads(jmod, params, x, g)
    finally:
        jlayers.enable_bf16_control(False)


def _jax_grads(jmod, params, x, g):
    def loss(p, x):
        y = jmod.apply(p, x)
        return jnp.sum(y * g), y

    (_, y), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    grads = {k: np.asarray(v) for k, v in gp.items()}
    grads['x'] = np.asarray(gx)
    return np.asarray(y), grads


def _port_grads(tmod, x, g):
    tmod.zero_grad()
    xt = torch.from_numpy(x).requires_grad_()
    y = tmod(xt)
    (y * torch.from_numpy(g)).sum().backward()
    grads = {k: p.grad.numpy().copy() for k, p in tmod.named_parameters()}
    grads['x'] = xt.grad.numpy()
    return y.detach().numpy(), grads


def _frobenius(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_switch_is_off_by_default_and_off_restores_float32():
    assert tlayers._BF16_MATMUL is False
    _, x, g, _, dense = _case('dense', 64)
    _, _, _, _, gru = _case('gru', 6)
    xg = np.random.RandomState(5).randn(1, 10, 4).astype(np.float32)
    gg = np.random.RandomState(6).randn(1, 10, 6).astype(np.float32)

    def outputs():
        return (_port_grads(dense, x, g), _port_grads(gru, xg, gg))

    before = outputs()
    tlayers.enable_bf16_control()
    try:
        during = outputs()
    finally:
        tlayers.enable_bf16_control(False)
    after = outputs()
    for (y0, g0), (y1, g1), (y2, g2) in zip(before, during, after):
        assert not np.array_equal(y0, y1)
        assert y0.tobytes() == y2.tobytes()
        for leaf in g0:
            assert not np.array_equal(g0[leaf], g1[leaf]) or leaf == 'bias'
            assert g0[leaf].tobytes() == g2[leaf].tobytes(), leaf


@pytest.mark.parametrize('kind', ['dense', 'gru'])
@pytest.mark.parametrize('u', sorted(SIZES))
def test_forward_matches_jax(u, kind):
    _, x, _, _, tmod = _case(kind, u)
    want, _ = _jax_bf16(kind, u)
    with torch.no_grad():
        f32 = tmod(torch.from_numpy(x)).numpy()
        tlayers.enable_bf16_control(True)
        try:
            got = tmod(torch.from_numpy(x)).numpy()
        finally:
            tlayers.enable_bf16_control(False)
    peak = np.abs(want).max()
    err = np.abs(got - want).max() / peak
    # The port's float32 output stands for JAX's (they are ~3e-7 of peak
    # apart): the distance that bf16 makes.
    own = np.abs(f32 - want).max() / peak
    print(f"{kind} u={u}: {err:.3g} of peak from JAX; float32 {own:.3g}")
    assert err <= FWD_TOL, err
    assert own > FWD_TOL, own
    if kind == 'dense':
        # The same float32 products rounded once: bit-equal here.
        assert err == 0.0, err


@pytest.mark.parametrize('kind', ['dense', 'gru'])
@pytest.mark.parametrize('u', sorted(SIZES))
def test_gradients_match_jax(u, kind):
    _, x, g, _, tmod = _case(kind, u)
    _, want = _jax_bf16(kind, u)
    _, f32 = _port_grads(tmod, x, g)
    tlayers.enable_bf16_control(True)
    try:
        _, got = _port_grads(tmod, x, g)
    finally:
        tlayers.enable_bf16_control(False)
    for leaf in want:
        tol = GRAD_TOL[u][leaf] if kind == 'gru' else DENSE_GRAD_TOL
        err = _frobenius(got[leaf], want[leaf])
        own = _frobenius(f32[leaf], want[leaf])
        print(f"{kind} u={u} {leaf}: {err:.3g} from JAX (tolerance "
              f"{tol:g}); float32 {own:.3g}")
        assert err <= tol, (leaf, err)
        # The Dense bias gradient is the cotangent's sum either way.
        if not (kind == 'dense' and leaf == 'bias'):
            assert own > tol, (leaf, own)


def _round64(v):
    return v.float().bfloat16().double()


def _model_forward(x_proj, w, bias, h0):
    """gru_scan_plain's bf16 recurrence in float64, rounded to bf16 where
    its docstring says: h and U entering the product."""
    u = h0.shape[-1]
    w, h, hs = _round64(w), h0, []
    for xt in x_proj:
        rec = _round64(h) @ w + bias
        z = torch.sigmoid(xt[:, :u] + rec[:, :u])
        r = torch.sigmoid(xt[:, u:2 * u] + rec[:, u:2 * u])
        hh = torch.tanh(xt[:, 2 * u:] + r * rec[:, 2 * u:])
        h = z * h + (1.0 - z) * hh
        hs.append(h)
    return torch.stack(hs)


def _model_backward(x_proj, w, bias, h0, hs, g):
    """gru_scan_plain_bwd's and gru_grads_from_streams' bf16 gradient in
    float64: h_prev and U rounded in the recompute, D = [dz_pre | dr_pre |
    drh] rounded before the carry's product, each step's h_prev^T D
    rounded."""
    u = h0.shape[-1]
    w_r = _round64(w)
    h_prev = torch.cat([h0[None], hs[:-1]])
    dh = torch.zeros_like(h0)
    streams, d_kernel = [], torch.zeros_like(w)
    for t in range(x_proj.shape[0] - 1, -1, -1):
        hp, xt = h_prev[t], x_proj[t]
        rec = _round64(hp) @ w_r + bias
        rh = rec[:, 2 * u:]
        z = torch.sigmoid(xt[:, :u] + rec[:, :u])
        r = torch.sigmoid(xt[:, u:2 * u] + rec[:, u:2 * u])
        hh = torch.tanh(xt[:, 2 * u:] + r * rh)
        dh = dh + g[t]
        dpre = dh * (1.0 - z) * (1.0 - hh * hh)
        dz_pre = dh * (hp - hh) * z * (1.0 - z)
        dr_pre = dpre * rh * r * (1.0 - r)
        d = _round64(torch.cat([dz_pre, dr_pre, dpre * r], dim=-1))
        d_kernel = d_kernel + _round64(_round64(hp).t() @ d)
        dh = dh * z + d @ w_r.t()
        streams.append(torch.stack([dz_pre, dr_pre, dpre, dpre * r]))
    return torch.stack(streams[::-1], dim=1), dh, d_kernel


def test_plain_bf16_scan_and_backward_match_float64_rounding_model():
    t, b, u = 24, 3, 8
    rng = np.random.RandomState(11)
    x_proj = torch.from_numpy(rng.randn(t, b, 3 * u).astype(np.float32))
    w = torch.from_numpy((0.4 * rng.randn(u, 3 * u)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.randn(3 * u)).astype(np.float32))
    h0 = torch.from_numpy((0.5 * rng.randn(b, u)).astype(np.float32))
    g = torch.from_numpy(rng.randn(t, b, u).astype(np.float32))
    f64 = [a.double() for a in (x_proj, w, bias, h0)]

    hs = kgru.gru_scan_plain(x_proj, w, bias, h0, bf16=True)
    want = _model_forward(*f64)
    assert (hs - want).abs().max() <= 1e-6 * want.abs().max()
    f32 = kgru.gru_scan_plain(x_proj, w, bias, h0)
    assert (f32 - want).abs().max() > 1e-3 * want.abs().max()

    streams = kgru.gru_scan_plain_bwd(x_proj, w, bias, h0, hs, g, bf16=True)
    want_streams, want_dh0, want_dk = _model_backward(*f64, hs.double(),
                                                      g.double())
    for got, ref in zip(streams[:4], want_streams):
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert (streams[4] - want_dh0).abs().max() <= 1e-5 * want_dh0.abs().max()
    _, d_kernel, _, _ = kgru.gru_grads_from_streams(h0, hs, streams,
                                                    bf16=True,
                                                    steps_a_chunk=5)
    assert (d_kernel - want_dk).abs().max() <= 1e-5 * want_dk.abs().max()
    f32_streams = kgru.gru_scan_plain_bwd(x_proj, w, bias, h0, hs, g)
    _, f32_dk, _, _ = kgru.gru_grads_from_streams(h0, hs, f32_streams)
    assert (f32_dk - want_dk).abs().max() > 1e-3 * want_dk.abs().max()


@pytest.mark.parametrize('bf16', [False, True], ids=['float32', 'bf16'])
def test_step_references_reproduce_the_plain_versions(bf16):
    """gru_scan_plain_steps and gru_scan_plain_bwd_steps, the step-by-step
    references the card holds K2 and K5 to, give back the plain versions'
    own outputs from them; and the float32 run is no bf16 run step by
    step."""
    t, b, u = 30, 3, 8
    rng = np.random.RandomState(12)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(t, b, 3 * u), 0.4 * rng.randn(u, 3 * u),
        0.1 * rng.randn(3 * u), 0.5 * rng.randn(b, u))]
    g = torch.from_numpy(rng.randn(t, b, u).astype(np.float32))
    hs = kgru.gru_scan_plain(*args, bf16)
    steps = kgru.gru_scan_plain_steps(*args, hs, bf16)
    assert (steps - hs).abs().max() <= 1e-6
    streams = kgru.gru_scan_plain_bwd(*args, hs, g, bf16)
    again = kgru.gru_scan_plain_bwd_steps(*args, hs, g, streams, bf16)
    for got, want in zip(again, streams):
        assert torch.equal(got, want)
    other = kgru.gru_scan_plain(*args, not bf16)
    assert (kgru.gru_scan_plain_steps(*args, other, bf16)
            - other).abs().max() > 1e-4


# A narrow maestro_v2 render under both switches: 4 voices, 16 harmonics,
# the port's seed-0 weights exported to the JAX model, JAX jitted. The
# relative Frobenius distance of the audio; measured on one thread over
# weight seeds 0-4: 1.8e-4 to 4.05e-3 (seed 0; 2.14e-3 on four threads,
# whose float32 sums round otherwise), where each side's bf16 render is
# 5.7e-3 to 9.0e-3 (seed 0) from its float32 one and the two float32
# renders are 1.0e-4 to 1.9e-4 apart. A flip upstream moves many values
# below it by a bf16 step: the seed-0 render's magnitudes differ from
# JAX's in 10 % of their elements.
RENDER_SECONDS = 0.25
RENDER_TOL = 6e-3


def test_narrow_v2_render_matches_jax(bf16):
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.params import export_jax_params
    from ddsp_piano_tpu.configs import get_model as jax_get_model

    narrow = dict(n_synths=4, n_harmonics=16)
    model = get_model('maestro_v2', inference=True, duration=RENDER_SECONDS,
                      device='cpu', **narrow)
    jmodel = jax_get_model('maestro_v2', duration=RENDER_SECONDS,
                           inference=True, **narrow)
    n_frames = int(RENDER_SECONDS * 250)
    cond = np.zeros((1, n_frames, 4, 2), np.float32)
    for voice, (pitch, start) in enumerate([(43, 2), (55, 5), (62, 20),
                                            (67, 40)]):
        cond[:, start:, voice, 0] = pitch
        cond[:, start:start + 8, voice, 1] = 0.7
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda p, f: jmodel(p, f, rng=rng))(
        export_jax_params(model),
        {'conditioning': jnp.asarray(cond),
         'pedal': jnp.zeros((1, n_frames, 4)),
         'piano_model': jnp.asarray([[3]], np.int32)})['audio_synth'])
    # The noise synth's draw inside the JAX model, injected into the port.
    noise = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(rng, 1), (4, n_frames * 96), jnp.float32, -1.0,
        1.0)))
    features = {'conditioning': torch.from_numpy(cond),
                'pedal': torch.zeros(1, n_frames, 4),
                'piano_model': torch.tensor([[3]])}
    with torch.inference_mode():
        got = model(features, noise=noise)['audio_synth'].numpy()
        tlayers.enable_bf16_control(False)
        f32 = model(features, noise=noise)['audio_synth'].numpy()
    err, own = _frobenius(got, want), _frobenius(f32, got)
    print(f"render: {err:.3g} from JAX's (tolerance {RENDER_TOL:g}); the "
          f"port's float32 render {own:.3g} from its bf16 one")
    assert np.isfinite(got).all() and np.abs(want).max() > 0.01
    assert err <= RENDER_TOL, err
    assert own > RENDER_TOL, own
