"""Packed batch staging and K-step blocks, on the CPU.

BatchPacker (ddsp_piano_torch/training/staging.py) against the JAX
package's on the same templates: the same encodings and packed arrays bit
for bit; the port's on-device decode bit-identical to the dict batch; a
batch that stops round-tripping raises. Trainer.train_steps (K = 4) against
four train_steps, bit for bit, whether the block is a list of host batches,
a packed lane tensor or a stacked dict; and the block NaN guard. At the
end, the magnitude loss's 10-step trajectories against the JAX trainer's
(ROADMAP C.1; tests/test_torch_grad_kernels.py holds the v2 loss's).
"""

import re

import numpy as np
import pytest
import threadpoolctl

torch = pytest.importorskip('torch')
torch.set_num_threads(1)
# numpy's BLAS too, for the whole worker (xdist collects every file):
# threaded OpenBLAS stalls at each call's barrier on a loaded host.
threadpoolctl.threadpool_limits(1)

from ddsp_piano_torch.data.pipeline import get_dummy_data  # noqa: E402
from ddsp_piano_torch.training.staging import BatchPacker  # noqa: E402
from ddsp_piano_tpu.training.staging import (  # noqa: E402
    BatchPacker as JaxBatchPacker)
from test_torch_training import (_v2_batch, _v2_small,  # noqa: E402
                                 check_loss_curve_distributions,
                                 check_ten_step_trajectory, jax_v2)


def _every_encoding(seed=0, b=2):
    """A batch with a key for each wire encoding."""
    rng = np.random.RandomState(seed)
    return {
        'audio': (rng.randint(-32768, 32768, (b, 300)) / 32768.0
                  ).astype(np.float32),                       # i16x32768
        'velocity': (rng.randint(0, 128, (b, 20, 3)) / 127.0
                     ).astype(np.float32),                    # i16x127
        'halves': (rng.randint(0, 1000, (b, 7)) + 0.5
                   ).astype(np.float32),                      # f16
        'rolls': rng.randint(0, 2, (b, 9, 4)).astype(np.float32),  # u16
        'noise': rng.randn(b, 11).astype(np.float32),         # f32x2
        'piano_model': rng.randint(0, 10, (b, 1)).astype(np.int32),  # u16
        'offsets': rng.randint(-2 ** 31, 2 ** 31 - 1,
                               (b, 5)).astype(np.int32),      # i32x2
        'filename': np.array([['a'], ['b']]),
    }


WANT_ENCODINGS = {'audio': 'i16x32768', 'velocity': 'i16x127',
                  'halves': 'f16', 'rolls': 'u16', 'noise': 'f32x2',
                  'piano_model': 'u16', 'offsets': 'i32x2'}


def _unpacked(packer, packed):
    return packer.unpack(torch.from_numpy(packed.view(np.int16)))


@pytest.mark.parametrize('wire', [True, False], ids=['packed', 'packed32'])
@pytest.mark.parametrize('template', ['every_encoding', 'v2', 'dummy'])
def test_packer_matches_jax_and_round_trips(template, wire):
    batches = {'every_encoding': [_every_encoding(s) for s in range(3)],
               'v2': [_v2_batch(seed=s) for s in range(3)],
               'dummy': [get_dummy_data(2, 0.5, 24000, seed=s)
                         for s in range(3)]}[template]
    packer = BatchPacker(batches[0], wire=wire)
    jpacker = JaxBatchPacker(batches[0], wire=wire)
    assert packer.encodings() == jpacker.encodings()
    assert packer.width == jpacker.width
    if template == 'every_encoding':
        assert packer.encodings() == (WANT_ENCODINGS if wire else {
            k: 'i32x2' if k in ('piano_model', 'offsets') else 'f32x2'
            for k in WANT_ENCODINGS})
    for batch in batches:
        packed = packer.pack(batch)
        np.testing.assert_array_equal(packed, jpacker.pack(batch))
        got = _unpacked(packer, packed)
        assert sorted(got) == sorted(k for k in batch if k != 'filename')
        for k, v in got.items():
            assert v.numpy().dtype == batch[k].dtype, k
            np.testing.assert_array_equal(v.numpy(), batch[k], err_msg=k)
    block = packer.pack_block(batches)
    np.testing.assert_array_equal(block, jpacker.pack_block(batches))
    for k, v in _unpacked(packer, block).items():
        np.testing.assert_array_equal(
            v.numpy(), np.stack([b[k] for b in batches]), err_msg=k)
    assert packer.wire_bytes(2) == 2 * 2 * packer.width


@pytest.mark.parametrize('key,value,encoding', [
    ('audio', 0.1, 'i16*32768'), ('velocity', 0.3, 'i16*127'),
    ('halves', 0.1, 'f16'), ('rolls', 0.5, 'u16'),
    ('piano_model', 70000, 'u16')])
def test_packer_raises_when_a_batch_stops_round_tripping(key, value,
                                                         encoding):
    """A later batch whose key leaves its template's encoding raises, in
    the JAX package's words, and fits packed32."""
    template = _every_encoding()
    batch = _every_encoding(1)
    batch[key] = batch[key].copy()
    batch[key].flat[1] = value
    want = re.escape('no longer fits the u16' if encoding == 'u16'
                     else f'no longer round-trips the {encoding}')
    for packer_class in (BatchPacker, JaxBatchPacker):
        with pytest.raises(ValueError, match=want) as err:
            packer_class(template).pack(batch)
        assert '--staging packed32' in str(err.value)
    packer = BatchPacker(template, wire=False)
    got = _unpacked(packer, packer.pack(batch))
    np.testing.assert_array_equal(got[key].numpy(), batch[key])


def test_train_steps_equal_four_single_steps():
    """K = 4 steps on one block, as a list of host batches, a packed lane
    tensor and a stacked dict: the same losses and parameters, bit for
    bit, as four train_step calls (each step's noise draw comes from its
    own step number)."""
    from ddsp_piano_torch.training.trainer import Trainer

    batches = [_v2_batch(n_frames=62, seed=s) for s in range(4)]

    def trainer():
        return Trainer(_v2_small(duration=0.25), first_phase=True)

    single = trainer()
    want = [single.train_step(b) for b in batches]
    single.check_pending()
    want = {k: torch.stack([w[k] for w in want]) for k in want[0]}
    for form in ('list', 'packed', 'packed32', 'dict'):
        block = trainer()
        if form == 'list':
            staged = batches
        elif form == 'dict':
            staged = block.stack_batches(batches)
        else:
            block.pack_wire = form == 'packed'
            staged = block.pack_block(batches)
            assert staged.dtype == torch.int16 and staged.shape[:2] == (4, 2)
        got = block.train_steps(staged)
        block.check_pending()
        assert block.step == 4
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == (4,)
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                       msg=f"{form} {k}")
        for (name, p), q in zip(block.model.named_parameters(),
                                single.model.parameters()):
            torch.testing.assert_close(p.detach(), q.detach(), rtol=0,
                                       atol=0, msg=f"{form} {name}")


def test_block_nan_guard_yields_the_state_before_the_block():
    """A non-finite loss at step 3 of a block: NanLossError names the
    block's first step and carries the state from before the block."""
    from ddsp_piano_torch.training.trainer import NanLossError, Trainer

    trainer = Trainer(_v2_small(duration=0.25), first_phase=True,
                      nan_check_interval=1)
    batches = [_v2_batch(n_frames=62, seed=s) for s in range(8)]
    bad = dict(batches[6], audio=np.full_like(batches[6]['audio'], np.nan))
    # Dict blocks: a NaN does not round-trip the packed audio lanes.
    trainer.train_steps(trainer.stack_batches(batches[:4]))
    trainer.check_pending()
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    moments = [t.clone() for t in trainer._state_tensors()]
    trainer.train_steps(trainer.stack_batches(batches[4:6]
                                              + [bad, batches[7]]))
    assert trainer.step == 8
    with pytest.raises(NanLossError, match='step 4 ') as err:
        trainer.check_pending()
    state = err.value.state
    assert state['step'] == 4
    for name, value in before.items():
        torch.testing.assert_close(state['model'][name], value, rtol=0,
                                   atol=0)
    adam = state['optimizer']['state']
    n = len(trainer.params)
    for i in range(n):
        torch.testing.assert_close(adam[i]['exp_avg'], moments[n + 2 * i],
                                   rtol=0, atol=0)
    assert any(not torch.equal(p.detach(), before[n])
               for n, p in trainer.model.named_parameters())


# -- ROADMAP C.1 for the magnitudes loss ------------------------------------
# The checks are test_torch_training.py's; one loss a file, so that
# pytest-xdist's --dist loadfile runs the two losses' trajectories on two
# workers.


@pytest.mark.parametrize('loss', ['magnitudes'])
def test_ten_step_trajectory_matches_jax_trainer(jax_v2, loss):
    check_ten_step_trajectory(jax_v2, loss)


@pytest.mark.parametrize('loss', ['magnitudes'])
def test_loss_curve_distributions_match_jax_trainer(jax_v2, loss):
    check_loss_curve_distributions(jax_v2, loss)
