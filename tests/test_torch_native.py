"""The port's C++ host voice allocator (ddsp_piano_torch/native) on the CPU.

Bit for bit against the port's numpy loop and against the JAX package's
C++ allocator (ddsp_piano_tpu.native) on the rolls of
tests/test_midi_data.py's native cases (five random rolls, and an
over-capacity roll at n_synths = 4); 'always' and 'auto' with no compiler
on PATH; four threads that call it first build the library once. The
cases that need a C++ compiler skip when none is on PATH.
"""

import shutil
import threading

import numpy as np
import pytest
import threadpoolctl

torch = pytest.importorskip('torch')
torch.set_num_threads(1)
# numpy's BLAS too, for the whole worker (xdist collects every file):
# threaded OpenBLAS stalls at each call's barrier on a loaded host.
threadpoolctl.threadpool_limits(1)

from ddsp_piano_torch import native  # noqa: E402
from ddsp_piano_torch.data import midi_encoders  # noqa: E402

needs_compiler = pytest.mark.skipif(
    native.compiler() is None, reason="no C++ compiler on PATH")


def _random_roll(seed, n_frames=400, density=30):
    """tests/test_midi_data.py TestNativeAllocator._random_roll."""
    rng = np.random.RandomState(seed)
    roll = np.zeros((n_frames, 88, 2), np.float32)
    for _ in range(density):
        p = rng.randint(0, 88)
        s = rng.randint(0, n_frames - 5)
        e = s + rng.randint(1, 40)
        roll[s:e, p, 0] = 1.0
        roll[s, p, 1] = rng.rand()
    return roll


ROLLS = [(f'random {seed}', seed, 400, 30, 16) for seed in range(5)] + [
    ('over capacity', 99, 200, 80, 4)]


@pytest.fixture()
def fresh(tmp_path, monkeypatch):
    """The module as a new process finds it, building into ``tmp_path``."""
    monkeypatch.setattr(native, 'BUILD_ROOT', tmp_path / 'host')
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_noticed', False)
    return tmp_path


@needs_compiler
@pytest.mark.parametrize('name, seed, n_frames, density, n_synths', ROLLS,
                         ids=[r[0] for r in ROLLS])
def test_native_matches_numpy_loop_and_jax_native(name, seed, n_frames,
                                                  density, n_synths):
    from ddsp_piano_tpu import native as jax_native

    roll = _random_roll(seed, n_frames, density)
    want_c, want_p = midi_encoders.roll_to_conditioning(
        roll.copy(), n_synths, use_native='never')
    calls = native.CALLS['allocate_voices']
    got_c, got_p = midi_encoders.roll_to_conditioning(roll, n_synths)
    assert native.CALLS['allocate_voices'] == calls + 1
    assert got_c.dtype == np.float32 and got_p.dtype == np.float32
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_p, want_p)
    assert np.any(got_c[..., 0] > 0)
    if not jax_native.available():
        pytest.skip("the JAX package's native library cannot be built")
    jax_c, jax_p = jax_native.allocate_voices(roll, n_synths)
    np.testing.assert_array_equal(got_c, jax_c)
    np.testing.assert_array_equal(got_p, jax_p)


def test_no_compiler_always_raises_and_auto_notices_once(fresh, monkeypatch,
                                                         capsys):
    monkeypatch.setenv('PATH', str(fresh / 'nothing-here'))
    roll = _random_roll(0)
    with pytest.raises(native.CompilerMissing, match='g\\+\\+'):
        midi_encoders.roll_to_conditioning(roll, 16, use_native='always')
    calls = native.CALLS['allocate_voices']
    want = midi_encoders.roll_to_conditioning(roll, 16, use_native='never')
    capsys.readouterr()
    for _ in range(2):
        got = midi_encoders.roll_to_conditioning(roll, 16)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    err = capsys.readouterr().err
    assert err.count('ddsp_piano_torch.native:') == 1, err
    assert 'no C++ compiler (g++ or c++) on PATH' in err
    assert native.CALLS['allocate_voices'] == calls
    with pytest.raises(ValueError, match='use_native'):
        midi_encoders.roll_to_conditioning(roll, 16, use_native='yes')


def test_failing_compiler_raises_with_its_output(fresh, monkeypatch):
    bin_dir = fresh / 'bin'
    bin_dir.mkdir()
    cxx = bin_dir / 'g++'
    cxx.write_text("#!/bin/sh\necho 'error: no room for this source' >&2\n"
                   "exit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setenv('PATH', str(bin_dir))
    for use_native in ('auto', 'always'):
        with pytest.raises(RuntimeError, match='no room for this source'):
            midi_encoders.roll_to_conditioning(_random_roll(0), 16,
                                               use_native=use_native)


@needs_compiler
def test_four_threads_build_once(fresh, monkeypatch):
    builds = []
    compile_ = native._compile

    def counting(target):
        builds.append(target)
        compile_(target)

    monkeypatch.setattr(native, '_compile', counting)
    roll = _random_roll(3)
    want = midi_encoders.roll_to_conditioning(roll, 16, use_native='never')
    results = [None] * 4
    start = threading.Barrier(4)

    def work(i):
        start.wait()
        results[i] = native.allocate_voices(roll, 16)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1, builds
    assert builds[0].parent.parent == fresh / 'host'
    assert builds[0].exists()
    for got in results:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.skipif(shutil.which('g++') is None, reason="no g++ on PATH")
def test_library_builds_outside_the_package(fresh):
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.parent == fresh / 'host'
    assert not list(native.SOURCE.parent.glob('*.so'))
