"""Data pipeline: segmentation, batching and the MAESTRO dataset iterators.

Copy of ddsp_piano_tpu/data/pipeline.py (split_sequence, segment_track, _stack_group, dataset_from_csv, load_track, _iter_tracks
with its cache and raw branches, get_dataset, batch_segments_stream,
get_training_dataset, get_validation_dataset, get_test_dataset,
Prefetcher). One change:
dataset_from_csv reads maestro-v3.0.0.csv with the stdlib csv module
instead of pandas, with the same rows, filters and sorted piano models.
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
                f". Re-run preprocess_maestro.py with matching settings.")
        items = list(meta['tracks'])
        if year is not None:
            years = meta.get('track_years')
            if years is None:
                raise ValueError(
                    f"year={year} requested but {cache_index!r} predates "
                    f"per-track year metadata; re-run preprocess_maestro.py "
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
