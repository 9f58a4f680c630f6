"""Data pipeline: dummy batches, segmentation, batching, the MAESTRO
dataset iterators and the per-track preprocessing cache.

Copy of ddsp_piano_tpu/data/pipeline.py: get_dummy_data, split_sequence,
segment_track, _stack_group, batch_segments, dataset_from_csv, load_track,
preprocess_into_cache, _iter_tracks with its cache and raw branches,
get_dataset, batch_segments_stream, get_training_dataset,
get_validation_dataset, get_test_dataset, single_track_dataset and
Prefetcher. One change: dataset_from_csv reads maestro-v3.0.0.csv with the
stdlib csv module instead of pandas, with the same rows, filters and sorted
piano models, so preprocess_into_cache writes the same cache as the JAX
package's writer.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)


def get_dummy_data(batch_size: int = 6,
                   duration: float = 3.0,
                   sample_rate: int = 16000,
                   frame_rate: int = 250,
                   n_synths: int = 16,
                   n_instruments: int = 10,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """Random features with the canonical shapes, drawn from
    ``np.random.RandomState(seed)``: conditioning (b, t, n_synths, 2),
    pedal (b, t, 4), audio (b, n_samples), piano_model (b, 1) int32."""
    rng = np.random.RandomState(seed)
    n_frames = int(duration * frame_rate)
    n_samples = int(duration * sample_rate)
    return {
        'conditioning': rng.uniform(
            0.0, 1.0, (batch_size, n_frames, n_synths, 2)).astype(np.float32),
        'pedal': rng.uniform(
            0.0, 1.0, (batch_size, n_frames, 4)).astype(np.float32),
        'audio': rng.uniform(
            0.0, 1.0, (batch_size, n_samples)).astype(np.float32),
        'piano_model': rng.randint(
            0, n_instruments, (batch_size, 1)).astype(np.int32),
    }


def split_sequence(x: np.ndarray, segment_duration: float, rate: float,
                   overlap: float = 0.5) -> np.ndarray:
    """Overlapping segmentation along axis 0."""
    n_samples = int(segment_duration * rate)
    hop_size = int(n_samples * (1 - overlap))
    segments = []
    timestep = 0
    while timestep + n_samples <= x.shape[0]:
        segments.append(x[timestep:timestep + n_samples])
        timestep += hop_size
    if not segments:
        return np.zeros((0, n_samples) + x.shape[1:], dtype=x.dtype)
    return np.stack(segments)


def segment_track(track: Dict[str, np.ndarray],
                  duration: float,
                  sample_rate: int,
                  frame_rate: int,
                  overlap: float = 0.5,
                  max_polyphony: Optional[int] = 16,
                  filter_over_polyphony: bool = True
                  ) -> List[Dict[str, np.ndarray]]:
    """Split one loaded track dict (audio, conditioning, pedal, polyphony,
    piano_model, optionally filename) into per-segment feature dicts."""
    audio = split_sequence(track['audio'], duration, sample_rate, overlap)
    conditioning = split_sequence(track['conditioning'], duration,
                                  frame_rate, overlap)
    pedal = split_sequence(track['pedal'], duration, frame_rate, overlap)
    polyphony = split_sequence(track['polyphony'], duration, frame_rate,
                               overlap)
    n_segments = min(len(audio), len(conditioning))
    if n_segments == 0:
        log.warning(
            "Track %r yields no %gs segments (audio %.1fs, MIDI %.1fs) - "
            "it will be silently absent from the dataset.",
            track.get('filename', '?'), duration,
            len(track['audio']) / sample_rate,
            len(track['conditioning']) / frame_rate)
    segments = []
    for i in range(n_segments):
        if (filter_over_polyphony and max_polyphony is not None
                and polyphony[i].max() > max_polyphony):
            continue
        seg = {
            'audio': audio[i],
            'conditioning': conditioning[i],
            'pedal': pedal[i],
            'piano_model': np.asarray(track['piano_model'],
                                      np.int32).reshape(1),
        }
        if 'filename' in track:
            seg['filename'] = f"{track['filename']}_{i}"
        segments.append(seg)
    return segments


def _stack_group(group: Sequence[Dict[str, np.ndarray]]
                 ) -> Dict[str, np.ndarray]:
    """Stack segment dicts into one batch dict ('filename' keeps the
    reference's (batch, 1) string layout)."""
    batch = {}
    for k in group[0]:
        if k == 'filename':
            batch[k] = np.asarray([[g[k]] for g in group])
        else:
            batch[k] = np.stack([g[k] for g in group])
    return batch


def batch_segments(segments: Sequence[Dict[str, np.ndarray]],
                   batch_size: int,
                   drop_remainder: bool = True
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Stack a list of segment dicts into batches."""
    n_full = len(segments) // batch_size
    end = n_full * batch_size if drop_remainder else len(segments)
    for start in range(0, end, batch_size):
        group = segments[start:start + batch_size]
        if len(group) < batch_size and drop_remainder:
            return
        yield _stack_group(group)


def batch_segments_stream(segments: Iterator[Dict[str, np.ndarray]],
                          batch_size: int
                          ) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-size batches of a segment stream (the remainder is dropped)."""
    group = []
    for seg in segments:
        group.append(seg)
        if len(group) == batch_size:
            yield _stack_group(group)
            group = []


def dataset_from_csv(csv_path: str, split: Optional[str] = None,
                     year: Optional[int] = None):
    """Read maestro-v3.0.0.csv -> (row dicts, n_rows, sorted piano models),
    the rows in file order, 'year' as an int and 'duration' as a float."""
    with open(csv_path, newline='') as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        row['year'] = int(row['year'])
        if 'duration' in row:
            row['duration'] = float(row['duration'])
    if split:
        rows = [r for r in rows if r['split'] == split]
    if year:
        rows = [r for r in rows if r['year'] == year]
    piano_models = np.sort(np.unique([r['year'] for r in rows]))
    return rows, len(rows), piano_models


def load_track(row: Dict, dataset_dir: str, piano_models: np.ndarray,
               sample_rate: int, frame_rate: int,
               max_polyphony: int) -> Dict[str, np.ndarray]:
    """Load one MAESTRO row into a track feature dict."""
    from ddsp_piano_torch.data import io as data_io
    audio, conditioning, pedal, polyphony = data_io.load_data(
        os.path.join(dataset_dir, row['audio_filename']),
        os.path.join(dataset_dir, row['midi_filename']),
        max_polyphony=max_polyphony,
        sample_rate=sample_rate,
        frame_rate=frame_rate)
    piano_model = int(np.where(piano_models == row['year'])[0][0])
    return {'audio': audio,
            'conditioning': conditioning,
            'pedal': pedal,
            'polyphony': polyphony.astype(np.int32),
            'piano_model': np.asarray([piano_model], np.int32),
            'filename': row['audio_filename']}


def preprocess_into_cache(cache_dir: str, dataset_dir: str,
                          split: str = 'train', year: Optional[int] = None,
                          sample_rate: int = 16000, frame_rate: int = 250,
                          max_polyphony: int = 16, num_workers: int = 8,
                          verbose: bool = True) -> Dict:
    """Preprocess a MAESTRO split into a cache directory: one compressed
    ``track_<split>_<i:05d>.npz`` of load_track's dict per row, written by
    a thread pool in row order, and ``index_<split>.json`` with the split,
    the three rates, the sorted piano models, the track files and each
    track's year. Returns the index."""
    os.makedirs(cache_dir, exist_ok=True)
    rows, n, piano_models = dataset_from_csv(
        os.path.join(dataset_dir, 'maestro-v3.0.0.csv'), split=split,
        year=year)
    index = []

    def process(i_row):
        i, row = i_row
        track = load_track(row, dataset_dir, piano_models, sample_rate,
                           frame_rate, max_polyphony)
        name = f'track_{split}_{i:05d}.npz'
        np.savez_compressed(os.path.join(cache_dir, name), **track)
        return name

    with ThreadPoolExecutor(num_workers) as pool:
        for j, name in enumerate(pool.map(process, enumerate(rows))):
            index.append(name)
            if verbose and (j + 1) % 10 == 0:
                print(f'  preprocessed {j + 1}/{n} tracks')
    meta = {'split': split, 'sample_rate': sample_rate,
            'frame_rate': frame_rate, 'max_polyphony': max_polyphony,
            'piano_models': [int(y) for y in piano_models],
            'tracks': index,
            # Each track's year, so that a year-filtered reader of an
            # unfiltered cache can take its subset.
            'track_years': [int(row['year']) for row in rows]}
    with open(os.path.join(cache_dir, f'index_{split}.json'), 'w') as f:
        json.dump(meta, f)
    return meta


def _iter_tracks(filename: str, split: str, year, sample_rate, frame_rate,
                 max_polyphony, shuffle: bool, infinite: bool,
                 num_workers: int, seed: int = 0):
    """Yield track dicts from a preprocessed cache dir (index_<split>.json
    and one .npz per track) or a raw MAESTRO dir, loaded by a thread pool
    with a bounded window of tracks in flight."""
    cache_index = os.path.join(filename, f'index_{split}.json')
    if os.path.isfile(cache_index):
        with open(cache_index) as f:
            meta = json.load(f)
        # A cache preprocessed at other rates would misalign audio and
        # conditioning.
        wanted = {'sample_rate': sample_rate, 'frame_rate': frame_rate,
                  'max_polyphony': max_polyphony}
        mismatched = {k: (meta.get(k), v) for k, v in wanted.items()
                      if meta.get(k) is not None and meta.get(k) != v}
        if mismatched:
            raise ValueError(
                f"Preprocessed cache {cache_index!r} was built with "
                f"{ {k: v[0] for k, v in mismatched.items()} } but the "
                f"trainer requested { {k: v[1] for k, v in mismatched.items()} }"
                f". Re-run python -m ddsp_piano_torch.preprocess_maestro "
                f"with matching settings.")
        items = list(meta['tracks'])
        if year is not None:
            years = meta.get('track_years')
            if years is None:
                raise ValueError(
                    f"year={year} requested but {cache_index!r} predates "
                    f"per-track year metadata; re-run "
                    f"python -m ddsp_piano_torch.preprocess_maestro "
                    f"(or drop the year filter).")
            items = [t for t, y in zip(items, years) if y == year]
        load = lambda name: dict(
            np.load(os.path.join(filename, name), allow_pickle=False))
    else:
        rows, _, piano_models = dataset_from_csv(
            os.path.join(filename, 'maestro-v3.0.0.csv'), split=split,
            year=year)
        items = rows
        load = lambda row: load_track(row, filename, piano_models,
                                      sample_rate, frame_rate,
                                      max_polyphony)

    rng = np.random.RandomState(seed)
    epoch = 0
    if not items:
        raise ValueError(
            f"No tracks to load from {filename!r} (split={split!r}, "
            f"year={year!r}): an infinite iterator over zero tracks "
            f"would spin forever.")

    pool = ThreadPoolExecutor(max(num_workers, 1))
    window = 2 * max(num_workers, 1)
    try:
        while True:
            order = list(range(len(items)))
            if shuffle:
                rng.shuffle(order)
            pending = deque()
            it = iter(order)
            for i in it:
                pending.append(pool.submit(load, items[i]))
                if len(pending) >= window:
                    break
            while pending:
                track = pending.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(load, items[nxt]))
                if 'filename' not in track:
                    track = dict(track, filename=f'track_{epoch}')
                yield track
            epoch += 1
            if not infinite:
                return
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def get_dataset(filename: str,
                split: str = 'train',
                year: Optional[int] = None,
                duration: float = 3.0,
                overlap: float = 0.5,
                batch_size: int = 6,
                shuffle: bool = True,
                infinite_generator: bool = True,
                sample_rate: int = 16000,
                frame_rate: int = 250,
                max_polyphony: int = 16,
                filter_over_polyphony: bool = True,
                num_parallel_calls: int = 8,
                shuffle_buffer_segments: int = 256,
                seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Batched segment iterator over a MAESTRO directory or cache dir:
    track-level shuffle -> overlapping segmentation -> polyphony filter ->
    segment-level shuffle buffer -> fixed-shape batches (drop remainder)."""
    rng = np.random.RandomState(seed + 1)
    tracks = _iter_tracks(filename, split, year, sample_rate, frame_rate,
                          max_polyphony, shuffle, infinite_generator,
                          num_parallel_calls, seed)

    def segments():
        for track in tracks:
            yield from segment_track(
                track, duration, sample_rate, frame_rate, overlap=overlap,
                max_polyphony=max_polyphony,
                filter_over_polyphony=filter_over_polyphony)

    def shuffled_segments():
        if not shuffle:
            yield from segments()
            return
        buf = []
        for seg in segments():
            buf.append(seg)
            if len(buf) >= shuffle_buffer_segments:
                idx = rng.randint(len(buf))
                buf[idx], buf[-1] = buf[-1], buf[idx]
                yield buf.pop()
        rng.shuffle(buf)
        yield from buf

    yield from batch_segments_stream(shuffled_segments(), batch_size)


def get_training_dataset(filename, **kwargs):
    return get_dataset(filename, split='train', **kwargs)


def get_validation_dataset(filename, **kwargs):
    return get_dataset(filename, split='validation',
                       infinite_generator=False, shuffle=False, **kwargs)


def get_test_dataset(filename, duration=10.0, overlap=0.0, **kwargs):
    """The test split in consecutive segments (no overlap), in track order,
    none dropped for its polyphony, once."""
    return get_dataset(filename, split='test', duration=duration,
                       overlap=overlap, filter_over_polyphony=False,
                       infinite_generator=False, shuffle=False,
                       num_parallel_calls=1, **kwargs)


def single_track_dataset(midi_filename: str,
                         audio_filename: str,
                         batch_size: int = 1,
                         duration: float = 3.0,
                         sample_rate: int = 16000,
                         frame_rate: int = 250,
                         max_polyphony: int = 16,
                         infinite_generator: bool = False):
    """Batches of one recording's segments (piano model 0): a track no
    longer than ``duration`` is zero-padded to one segment, split without
    overlap; a longer one is split with overlap 0.5."""
    from ddsp_piano_torch.data import io as data_io
    audio, conditioning, pedal, polyphony = data_io.load_data(
        audio_filename, midi_filename, max_polyphony=max_polyphony,
        sample_rate=sample_rate, frame_rate=frame_rate)
    track = {'audio': audio, 'conditioning': conditioning, 'pedal': pedal,
             'polyphony': polyphony.astype(np.int32),
             'piano_model': np.zeros(1, np.int32),
             'filename': os.path.basename(audio_filename)}
    if len(conditioning) / float(frame_rate) <= duration:
        n_frames = int(duration * frame_rate)
        track = dict(track,
                     audio=data_io.ensure_sequence_length(
                         audio, int(duration * sample_rate)),
                     conditioning=data_io.ensure_sequence_length(
                         conditioning, n_frames),
                     pedal=data_io.ensure_sequence_length(pedal, n_frames),
                     polyphony=data_io.ensure_sequence_length(
                         polyphony.astype(np.int32), n_frames))
        segments = segment_track(track, duration, sample_rate, frame_rate,
                                 overlap=0.0, max_polyphony=max_polyphony)
    else:
        segments = segment_track(track, duration, sample_rate, frame_rate,
                                 overlap=0.5, max_polyphony=max_polyphony)

    def generate():
        while True:
            yield from batch_segments(segments, batch_size)
            if not infinite_generator:
                return
    return generate()


class Prefetcher:
    """Background-thread batch prefetcher: keeps host loading off the
    training step's critical path. A pipeline error is raised to the
    consumer instead of ending the iterator quietly. :meth:`close` stops
    the thread and closes the wrapped iterator."""

    def __init__(self, iterator: Iterator, depth: int = 4):
        self._queue: 'queue.Queue' = queue.Queue(maxsize=depth)
        self._iterator = iterator
        self._done = object()
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self):
        try:
            for item in self._iterator:
                if not self._put(item):
                    break
        except BaseException as e:   # noqa: B036 - surfaced to the consumer
            self._error = e
        finally:
            close = getattr(self._iterator, 'close', None)
            if close is not None:
                close()
            self._put(self._done)

    def close(self, timeout: float = 30.0):
        self._stop.set()
        self._thread.join(timeout)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._done:
            # Re-queue the sentinel: next() after exhaustion keeps raising.
            self._queue.put(self._done)
            if self._error is not None:
                raise RuntimeError(
                    "data pipeline worker failed") from self._error
            raise StopIteration
        return item
