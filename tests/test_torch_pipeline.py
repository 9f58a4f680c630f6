"""The port's data preprocessing path against the JAX package's, on the CPU.

The preprocessing cache (python -m ddsp_piano_torch.preprocess_maestro)
against ddsp_piano_tpu's writer, key by key and bit for bit, with equal
index files; get_dummy_data, batch_segments and single_track_dataset
against the JAX functions; and the port's training iterator reading that
cache. The mini-MAESTRO is one 2 s track (test_torch_training.py's
_write_mini_maestro) in a train and a validation row.
"""

import json
import os

import numpy as np
import pytest
import threadpoolctl

torch = pytest.importorskip('torch')
torch.set_num_threads(1)
# numpy's BLAS too, for the whole worker (xdist collects every file):
# threaded OpenBLAS stalls at each call's barrier on a loaded host.
threadpoolctl.threadpool_limits(1)

from ddsp_piano_torch.data import pipeline as tpipe  # noqa: E402
from ddsp_piano_tpu.data import pipeline as jpipe  # noqa: E402
from test_torch_training import _write_mini_maestro  # noqa: E402

SECONDS = 2.0
SAMPLE_RATE = 24000


@pytest.fixture(scope='module')
def maestro(tmp_path_factory):
    return _write_mini_maestro(str(tmp_path_factory.mktemp('maestro')),
                               sample_rate=SAMPLE_RATE, seconds=SECONDS)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_preprocess_cli_writes_the_jax_writers_cache(maestro, tmp_path):
    """python -m ddsp_piano_torch.preprocess_maestro (the JAX CLI's
    defaults but the rates, which the test sets) against
    ddsp_piano_tpu.data.pipeline.preprocess_into_cache: the same files,
    each .npz's arrays bit for bit, the same index_<split>.json."""
    from ddsp_piano_torch import preprocess_maestro as cli

    got_dir, want_dir = str(tmp_path / 'port'), str(tmp_path / 'jax')
    args = cli.process_args(['--num_workers', '2', maestro, got_dir])
    assert (args.sample_rate, args.frame_rate, args.polyphony,
            args.splits) == (24000, 250, 16, ['validation', 'train'])
    indexes = cli.main(args)
    for split in ('validation', 'train'):
        jpipe.preprocess_into_cache(want_dir, maestro, split=split,
                                    sample_rate=24000, frame_rate=250,
                                    max_polyphony=16, num_workers=2,
                                    verbose=False)
        with open(os.path.join(got_dir, f'index_{split}.json')) as f:
            got_index = json.load(f)
        with open(os.path.join(want_dir, f'index_{split}.json')) as f:
            want_index = json.load(f)
        assert got_index == want_index == indexes[split]
        assert got_index['tracks'] == [f'track_{split}_00000.npz']
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    for name in os.listdir(want_dir):
        if name.endswith('.npz'):
            _assert_same(dict(np.load(os.path.join(got_dir, name))),
                         dict(np.load(os.path.join(want_dir, name))))
    # The cached track is the port's own load_track of the row.
    rows, _, models = tpipe.dataset_from_csv(
        os.path.join(maestro, 'maestro-v3.0.0.csv'), split='train')
    _assert_same(dict(np.load(os.path.join(got_dir,
                                           'track_train_00000.npz'))),
                 tpipe.load_track(rows[0], maestro, models, 24000, 250, 16))


def test_training_iterator_reads_the_cache(maestro, tmp_path):
    """The port's training and validation iterators give the same batches
    from the cache as from the raw folder."""
    cache = str(tmp_path / 'cache')
    for split in ('train', 'validation'):
        tpipe.preprocess_into_cache(cache, maestro, split=split,
                                    sample_rate=SAMPLE_RATE,
                                    max_polyphony=4, num_workers=1,
                                    verbose=False)
    kwargs = dict(batch_size=2, duration=1.0, sample_rate=SAMPLE_RATE,
                  max_polyphony=4, num_parallel_calls=1,
                  shuffle_buffer_segments=4)
    train = tpipe.get_training_dataset(cache, **kwargs)
    raw = tpipe.get_training_dataset(maestro, **kwargs)
    for _ in range(3):
        got, want = next(train), next(raw)
        _assert_same(got, want)
    train.close()
    raw.close()
    _assert_same(next(tpipe.get_validation_dataset(cache, **kwargs)),
                 next(tpipe.get_validation_dataset(maestro, **kwargs)))
    with pytest.raises(ValueError, match='ddsp_piano_torch.preprocess'):
        next(tpipe.get_training_dataset(cache, **dict(kwargs,
                                                      sample_rate=16000)))


@pytest.mark.parametrize('kwargs', [
    {}, dict(batch_size=3, duration=0.5, sample_rate=24000, n_synths=4,
             seed=5)])
def test_dummy_data_matches_jax(kwargs):
    _assert_same(tpipe.get_dummy_data(**kwargs),
                 jpipe.get_dummy_data(**kwargs))


@pytest.mark.parametrize('drop_remainder', [True, False])
def test_batch_segments_matches_jax(maestro, drop_remainder):
    rows, _, models = tpipe.dataset_from_csv(
        os.path.join(maestro, 'maestro-v3.0.0.csv'), split='train')
    track = tpipe.load_track(rows[0], maestro, models, SAMPLE_RATE, 250, 4)
    segments = tpipe.segment_track(track, 0.5, SAMPLE_RATE, 250,
                                   max_polyphony=4)
    assert len(segments) % 3
    got = list(tpipe.batch_segments(segments, 3, drop_remainder))
    want = list(jpipe.batch_segments(segments, 3, drop_remainder))
    assert len(got) == len(want) == (len(segments) + 2 * (
        not drop_remainder)) // 3
    for g, w in zip(got, want):
        _assert_same(g, w)


@pytest.mark.parametrize('duration', [3.0, 0.5],
                         ids=['padded_no_overlap', 'overlap_half'])
def test_single_track_dataset_matches_jax(maestro, duration):
    """A track no longer than the segment is zero-padded to one segment
    (overlap 0); a longer one splits with overlap 0.5."""
    kwargs = dict(batch_size=2, duration=duration, sample_rate=SAMPLE_RATE,
                  max_polyphony=4)
    midi, wav = (os.path.join(maestro, n) for n in ('track.midi',
                                                     'track.wav'))
    one = list(tpipe.single_track_dataset(midi, wav, **dict(kwargs,
                                                            batch_size=1)))
    want = list(jpipe.single_track_dataset(midi, wav, **dict(kwargs,
                                                             batch_size=1)))
    assert len(one) == len(want)
    assert (len(one) == 1) == (duration > SECONDS) and len(one) % 2
    for g, w in zip(one, want):
        _assert_same(g, w)
    got = list(tpipe.single_track_dataset(midi, wav, **kwargs))
    want = list(jpipe.single_track_dataset(midi, wav, **kwargs))
    assert len(got) == len(want) == len(one) // 2
    for g, w in zip(got, want):
        _assert_same(g, w)
    if duration > SECONDS:
        audio = one[0]['audio'][0]
        assert audio.shape == (int(duration * SAMPLE_RATE),)
        assert not audio[int(SECONDS * SAMPLE_RATE):].any()
    infinite = tpipe.single_track_dataset(midi, wav, infinite_generator=True,
                                          **dict(kwargs, batch_size=1))
    assert len([next(infinite) for _ in range(2 * len(one))]) == 2 * len(one)
