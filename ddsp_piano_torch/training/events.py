"""TensorBoard event files, written and read with the standard library and
numpy only (no tensorflow, tensorboard or protobuf package).

The file is a TFRecord stream: each record is a little-endian u64 length,
the masked CRC-32C of those 8 bytes, the data, and the masked CRC-32C of
the data (mask: ((crc >> 15) | (crc << 17)) + 0xa282ead8). Each record's
data is an ``Event`` protocol buffer, encoded here by hand; the first one
carries ``file_version: "brain.Event:2"``. Summary values take the form
TF2's ``tf.summary.scalar`` / ``audio`` / ``image`` write: a
``Value.tensor`` plus ``Value.metadata.plugin_data`` naming the plugin
('scalars'; 'audio' with WAV encoding; 'images'), so TensorBoard's
plugins read them and a record compares field by field with TF's.

WAV is 16-bit PCM quantized as ``tf.audio.encode_wav`` does (round half
away from zero of x * 32768, clipped to int16); PNG is written with zlib
and struct. The reader (:func:`read_events`) checks every CRC and decodes
the same messages.
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

FILE_VERSION = b'brain.Event:2'
WRITER = b'ddsp_piano_torch.training.events'

# TensorProto dtypes.
DT_FLOAT = 1
DT_STRING = 7
# The audio plugin's AudioPluginData.Encoding.WAV.
AUDIO_ENCODING_WAV = 11

# -- CRC-32C ------------------------------------------------------------------


def _crc32c_table() -> List[int]:
    table = []
    for n in range(256):
        crc = n
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
        table.append(crc)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), reflected, by a byte table."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame_record(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, data, its masked CRC."""
    length = struct.pack('<Q', len(data))
    return (length + struct.pack('<I', masked_crc32c(length)) + data
            + struct.pack('<I', masked_crc32c(data)))


def iter_records(raw: bytes) -> Iterator[bytes]:
    """The records of a TFRecord stream; raises on a bad CRC or a cut
    record."""
    pos = 0
    while pos < len(raw):
        if pos + 12 > len(raw):
            raise ValueError(f"truncated record header at byte {pos}")
        header = raw[pos:pos + 8]
        (length,) = struct.unpack('<Q', header)
        (crc,) = struct.unpack('<I', raw[pos + 8:pos + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f"bad length CRC at byte {pos}")
        start, end = pos + 12, pos + 12 + length
        if end + 4 > len(raw):
            raise ValueError(f"truncated record at byte {pos}")
        data = raw[start:end]
        (crc,) = struct.unpack('<I', raw[end:end + 4])
        if crc != masked_crc32c(data):
            raise ValueError(f"bad data CRC at byte {pos}")
        yield data
        pos = end + 4


# -- protocol buffer wire format ----------------------------------------------


def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1          # negative int64 as its two's complement
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _field_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _field_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _field_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack('<d', value)


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[tuple]:
    """(field number, wire type, value) of a message; length-delimited
    values as bytes, fixed ones as their raw bytes."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + length], pos + length
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


# -- messages -----------------------------------------------------------------


def _tensor_shape(dims: Sequence[int]) -> bytes:
    return b''.join(_field_bytes(2, _field_varint(1, d)) for d in dims)


def tensor_proto(dtype: int, dims: Sequence[int],
                 content: Optional[bytes] = None,
                 strings: Sequence[bytes] = ()) -> bytes:
    """TensorProto: dtype (1), tensor_shape (2), tensor_content (4),
    string_val (8)."""
    out = _field_varint(1, dtype) + _field_bytes(2, _tensor_shape(dims))
    if content is not None:
        out += _field_bytes(4, content)
    return out + b''.join(_field_bytes(8, s) for s in strings)


def summary_metadata(plugin_name: str, content: bytes = b'') -> bytes:
    """SummaryMetadata{plugin_data (1): PluginData{plugin_name (1),
    content (2)}}."""
    plugin = _field_bytes(1, plugin_name.encode())
    if content:
        plugin += _field_bytes(2, content)
    return _field_bytes(1, plugin)


def summary_value(tag: str, tensor: bytes, metadata: bytes) -> bytes:
    """Summary.Value: tag (1), tensor (8), metadata (9)."""
    return (_field_bytes(1, tag.encode()) + _field_bytes(8, tensor)
            + _field_bytes(9, metadata))


def event(wall_time: float, step: int = 0, summary_values=(),
          file_version: Optional[bytes] = None) -> bytes:
    """Event: wall_time (1), step (2), file_version (3), summary (5),
    source_metadata (10)."""
    out = _field_double(1, wall_time)
    if step:
        out += _field_varint(2, int(step))
    if file_version is not None:
        out += _field_bytes(3, file_version)
        out += _field_bytes(10, _field_bytes(1, WRITER))
    if summary_values:
        out += _field_bytes(5, b''.join(_field_bytes(1, v)
                                        for v in summary_values))
    return out


def _decode_tensor(buf: bytes) -> Dict[str, Any]:
    out: Dict[str, Any] = {'dtype': 0, 'shape': [], 'content': b'',
                           'strings': []}
    for field, _, value in _fields(buf):
        if field == 1:
            out['dtype'] = value
        elif field == 2:
            for f, _, dim in _fields(value):
                if f == 2:
                    size = dict((g, v) for g, _, v in _fields(dim)).get(1, 0)
                    out['shape'].append(size)
        elif field == 4:
            out['content'] = bytes(value)
        elif field == 8:
            out['strings'].append(bytes(value))
    return out


def _decode_value(buf: bytes) -> Dict[str, Any]:
    out: Dict[str, Any] = {'tag': '', 'plugin_name': '', 'plugin_content': b''}
    for field, _, value in _fields(buf):
        if field == 1:
            out['tag'] = value.decode()
        elif field == 2:
            (out['simple_value'],) = struct.unpack('<f', value)
        elif field == 8:
            out['tensor'] = _decode_tensor(value)
        elif field == 9:
            for f, _, plugin in _fields(value):
                if f == 1:
                    for g, _, v in _fields(plugin):
                        if g == 1:
                            out['plugin_name'] = v.decode()
                        elif g == 2:
                            out['plugin_content'] = bytes(v)
    return out


def decode_event(buf: bytes) -> Dict[str, Any]:
    """{'wall_time', 'step', 'file_version' (or None), 'values': [...]},
    each value {'tag', 'plugin_name', 'plugin_content', 'tensor':
    {'dtype', 'shape', 'content', 'strings'}}."""
    out: Dict[str, Any] = {'wall_time': 0.0, 'step': 0,
                           'file_version': None, 'values': []}
    for field, _, value in _fields(buf):
        if field == 1:
            (out['wall_time'],) = struct.unpack('<d', value)
        elif field == 2:
            out['step'] = value - (1 << 64) if value >> 63 else value
        elif field == 3:
            out['file_version'] = value.decode()
        elif field == 5:
            out['values'] = [_decode_value(v) for f, _, v in _fields(value)
                             if f == 1]
    return out


def read_events(path: str) -> List[Dict[str, Any]]:
    """Every event of an event file, CRCs checked."""
    with open(path, 'rb') as f:
        raw = f.read()
    return [decode_event(record) for record in iter_records(raw)]


def value_array(value: Dict[str, Any]) -> Any:
    """A value's data: a float for a scalar, the list of (wav bytes,
    label) pairs for audio, the list of PNG bytes for an image."""
    tensor = value['tensor']
    if value['plugin_name'] == 'scalars':
        return float(np.frombuffer(tensor['content'], '<f4')[0])
    if value['plugin_name'] == 'audio':
        s = tensor['strings']
        return list(zip(s[0::2], s[1::2]))
    if value['plugin_name'] == 'images':
        return tensor['strings'][2:]
    raise ValueError(f"unknown plugin {value['plugin_name']!r}")


# -- encoders -----------------------------------------------------------------


def quantize_pcm16(audio: np.ndarray) -> np.ndarray:
    """tf.audio.encode_wav's samples: roundf(x * 32768) (half away from
    zero, of the float32 product) clipped to [-32768, 32767]."""
    scaled = (np.asarray(audio, np.float32) * np.float32(32768.0)).astype(
        np.float64)
    rounded = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
    return np.clip(rounded, -32768, 32767).astype('<i2')


def encode_wav(audio: np.ndarray, sample_rate: int) -> bytes:
    """(n_samples,) or (n_samples, channels) float audio as a 16-bit PCM
    WAV file's bytes (the header of tf.audio.encode_wav)."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[:, None]
    channels = audio.shape[1]
    data = quantize_pcm16(audio).tobytes()
    header = b'RIFF' + struct.pack('<I', 36 + len(data)) + b'WAVE'
    fmt = struct.pack('<HHIIHH', 1, channels, sample_rate,
                      sample_rate * channels * 2, channels * 2, 16)
    return (header + b'fmt ' + struct.pack('<I', len(fmt)) + fmt
            + b'data' + struct.pack('<I', len(data)) + data)


def decode_wav(wav: bytes) -> tuple:
    """(float32 samples (n, channels) scaled by 1 / 32768, sample rate)
    of a 16-bit PCM WAV written by :func:`encode_wav`."""
    channels, sample_rate = struct.unpack('<HI', wav[22:28])
    pos = 12
    while pos < len(wav):
        chunk, size = wav[pos:pos + 4], struct.unpack('<I',
                                                      wav[pos + 4:pos + 8])[0]
        if chunk == b'data':
            pcm = np.frombuffer(wav[pos + 8:pos + 8 + size], '<i2')
            return (pcm.reshape(-1, channels).astype(np.float32) / 32768.0,
                    sample_rate)
        pos += 8 + size
    raise ValueError("no data chunk")


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(h, w) gray, (h, w, 3) RGB or (h, w, 4) RGBA uint8 as PNG bytes
    (no row filter, zlib level 6)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {image.dtype}")
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, c = image.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, w * c)], axis=1)
    ihdr = struct.pack('>IIBBBBB', w, h, 8, color, 0, 0, 0)
    return (b'\x89PNG\r\n\x1a\n' + _png_chunk(b'IHDR', ihdr)
            + _png_chunk(b'IDAT', zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b'IEND', b''))


def decode_png(png: bytes) -> np.ndarray:
    """The pixels of a PNG written by :func:`encode_png`."""
    pos, idat, header = 8, b'', None
    while pos < len(png):
        (length,) = struct.unpack('>I', png[pos:pos + 4])
        kind, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + length]
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', data)
        elif kind == b'IDAT':
            idat += data
        pos += 12 + length
    w, h, _, color = header[:4]
    c = {0: 1, 2: 3, 6: 4}[color]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * c)
    if rows[:, 0].any():
        raise ValueError("only unfiltered rows are read")
    return rows[:, 1:].reshape(h, w, c)


# -- the writer ---------------------------------------------------------------


class EventFileWriter:
    """Appends events to ``<logdir>/events.out.tfevents.<time>.<host>``;
    the first record is the file version. Records go to the file as they
    are made; :meth:`flush` flushes it."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            logdir, f'events.out.tfevents.{int(now)}.{socket.gethostname()}')
        self._file = open(self.path, 'ab')
        self._write(event(now, file_version=FILE_VERSION))

    def _write(self, data: bytes):
        self._file.write(frame_record(data))

    def add_values(self, step: int, values: Sequence[bytes]):
        self._write(event(time.time(), step, values))

    def scalar(self, tag: str, value: float, step: int):
        tensor = tensor_proto(DT_FLOAT, (),
                              content=np.float32(value).tobytes())
        self.add_values(step, [summary_value(tag, tensor,
                                             summary_metadata('scalars'))])

    def audio(self, tag: str, clips: np.ndarray, sample_rate: int,
              step: int):
        """clips (k, n_samples[, channels]) floats in [-1, 1]."""
        wavs = [encode_wav(c, sample_rate) for c in clips]
        tensor = tensor_proto(DT_STRING, (len(wavs), 2), strings=[
            s for wav in wavs for s in (wav, b'')])
        meta = summary_metadata('audio',
                                _field_varint(2, AUDIO_ENCODING_WAV))
        self.add_values(step, [summary_value(tag, tensor, meta)])

    def image(self, tag: str, images: Sequence[np.ndarray], step: int):
        """images: (h, w[, c]) uint8 arrays of one size."""
        h, w = images[0].shape[:2]
        strings = [str(w).encode(), str(h).encode()] + [
            encode_png(im) for im in images]
        tensor = tensor_proto(DT_STRING, (len(strings),), strings=strings)
        self.add_values(step, [summary_value(tag, tensor,
                                             summary_metadata('images'))])

    def flush(self):
        self._file.flush()

    def close(self):
        self._file.close()
