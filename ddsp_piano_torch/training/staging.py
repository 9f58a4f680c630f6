"""Packed host-to-device batch staging with a 16-bit wire format.

Counterpart of ddsp_piano_tpu/training/staging.py (BatchPacker). A
training batch packs into one contiguous ``(batch, width)`` array of
16-bit lanes, so that it goes to the card as one pinned copy, and each key
takes the narrowest 16-bit encoding that round-trips it bit for bit:

  u16       integer-valued data in [0, 65535] (pedal 0/1 rolls, instrument
            ids)
  i16xS     round(a * S) in int16, S in {32768, 127}; decoded as
            ``int16 -> float32, divided by S``. 32768: the pipeline decodes
            16-bit PCM as int16 / 32768; 127: MIDI velocities are
            velocity / 127 and pitches small integers.
  f16       values that survive float32 -> float16 -> float32
  f32x2     the float32 bit pattern in two lanes (hi, lo); always exact
  i32x2     the same for integer keys that do not fit u16

The encodings are chosen from a template batch, in the JAX package's order,
and checked bitwise on every later batch: a batch that stops round-tripping
raises. ``wire=False`` (``--staging packed32``) takes f32x2 / i32x2 for
every key.

The host side is a copy of the JAX package's (the packed arrays are equal
bit for bit). The lanes travel as int16 (torch's uint16 supports few
operators) and :meth:`BatchPacker.unpack` decodes them on the device with
torch operators: a slice, a ``view`` of the same element size, a cast and,
for i16xS, a true division by a device tensor holding S (a division by a
Python scalar is a multiply by its reciprocal on the GPU, which is not
bit-exact). So the decoded batch equals the dict batch bit for bit.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ['BatchPacker']

_SKIP_KEYS = ('filename',)

# Scales by data provenance; the first bitwise match wins.
_I16_SCALES = (32768.0, 127.0)


def _encode_u16(a):
    return a.astype(np.uint16)[..., None]


def _encode_i16(a, scale):
    return (np.round(a * scale).astype(np.int16)
            .view(np.uint16)[..., None])


def _encode_f16(a):
    return a.astype(np.float16).view(np.uint16)[..., None]


def _encode_x2(a, dtype):
    bits = np.ascontiguousarray(a, dtype).view(np.uint32)
    return np.stack([(bits >> 16).astype(np.uint16),
                     (bits & 0xffff).astype(np.uint16)], axis=-1)


def _u16_ok(a, dtype):
    if np.issubdtype(dtype, np.integer):
        return bool(a.size == 0 or (a.min() >= 0 and a.max() <= 0xffff))
    d = a.astype(np.uint16).astype(np.float32)
    return bool(np.array_equal(d, a) and (a.size == 0 or a.min() >= 0))


def _i16_ok(a, scale):
    q = np.round(a * scale)
    if a.size and (q.min() < -32768 or q.max() > 32767):
        return False
    # Decode as the device does: float32 cast, then float32 division.
    d = q.astype(np.int16).astype(np.float32) / np.float32(scale)
    return bool(np.array_equal(d, a))


def _f16_ok(a):
    return bool(np.array_equal(a.astype(np.float16).astype(np.float32), a))


class BatchPacker:
    """Packs a host batch dict into one ``(batch, width)`` 16-bit array.

    Built from a template batch; every later batch must carry the same
    keys, per-sample shapes and dtypes, and satisfy the encodings chosen
    from the template. ``wire=False`` forces the two-lane encodings for
    every key.
    """

    def __init__(self, template: Dict[str, np.ndarray], wire: bool = True):
        self.specs = []  # (key, tail_shape, dtype, enc, offset, lanes*size)
        offset = 0
        batch_dim = None
        for key in sorted(template):
            if key in _SKIP_KEYS:
                continue
            a = np.asarray(template[key])
            if a.ndim < 1:
                raise ValueError(
                    f"BatchPacker needs a leading batch axis on every key; "
                    f"{key!r} is a scalar - stage this batch as a dict.")
            if batch_dim is None:
                batch_dim = a.shape[0]
            elif a.shape[0] != batch_dim:
                raise ValueError(
                    f"Inconsistent batch dim: {key!r} has {a.shape[0]}, "
                    f"expected {batch_dim}.")
            if np.issubdtype(a.dtype, np.integer):
                enc = 'u16' if (wire and _u16_ok(a, a.dtype)) else 'i32x2'
            elif a.dtype == np.float32:
                enc = 'f32x2'
                if wire:
                    if _u16_ok(a, a.dtype):
                        enc = 'u16'
                    else:
                        for s in _I16_SCALES:
                            if _i16_ok(a, s):
                                enc = f'i16x{int(s)}'
                                break
                        else:
                            if _f16_ok(a):
                                enc = 'f16'
            else:
                raise ValueError(
                    f"BatchPacker supports float32 and integer keys; "
                    f"{key!r} is {a.dtype} - stage this batch as a dict.")
            size = int(np.prod(a.shape[1:], dtype=np.int64))
            lanes = 2 if enc.endswith('x2') else 1
            self.specs.append((key, a.shape[1:], a.dtype, enc, offset,
                               lanes * size))
            offset += lanes * size
        if not self.specs:
            raise ValueError("Empty batch - nothing to pack.")
        self.width = offset
        self._scales = {}

    def _encode(self, key, a, dtype, enc):
        """-> (..., size, lanes) uint16, checking that it round-trips."""
        if enc == 'u16':
            if not _u16_ok(a, dtype):
                raise ValueError(
                    f"{key!r} no longer fits the u16 wire encoding chosen "
                    f"from the template batch - use --staging packed32 "
                    f"(or stage as a dict).")
            return _encode_u16(a)
        if enc.startswith('i16x'):
            scale = float(enc[4:])
            if not _i16_ok(a, scale):
                raise ValueError(
                    f"{key!r} no longer round-trips the i16*{scale:g} wire "
                    f"encoding chosen from the template batch - use "
                    f"--staging packed32 (or stage as a dict).")
            return _encode_i16(a, scale)
        if enc == 'f16':
            if not _f16_ok(a):
                raise ValueError(
                    f"{key!r} no longer round-trips the f16 wire encoding "
                    f"chosen from the template batch - use --staging "
                    f"packed32 (or stage as a dict).")
            return _encode_f16(a)
        return _encode_x2(a, np.int32 if enc == 'i32x2' else np.float32)

    def pack(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """One host batch dict -> ``(batch, width)`` uint16 array."""
        b = np.asarray(batch[self.specs[0][0]]).shape[0]
        out = np.empty((b, self.width), np.uint16)
        for key, tail, dtype, enc, off, span in self.specs:
            a = np.asarray(batch[key])
            out[:, off:off + span] = self._encode(
                key, a, dtype, enc).reshape(b, -1)
        return out

    def pack_block(self, batches: Sequence[Dict[str, np.ndarray]]
                   ) -> np.ndarray:
        """K host batches -> ``(K, batch, width)`` uint16 array."""
        return np.stack([self.pack(b) for b in batches])

    def _scale(self, enc: str, device: torch.device) -> torch.Tensor:
        """The i16 scale as a 0-d float32 tensor on ``device`` (made once
        per device)."""
        key = (enc, device)
        if key not in self._scales:
            self._scales[key] = torch.full((), float(enc[4:]),
                                           dtype=torch.float32,
                                           device=device)
        return self._scales[key]

    def unpack(self, packed: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Inverse of pack on the device: ``(..., width)`` int16 lanes (the
        uint16 array's bits) -> the batch dict. Any leading shape, so one
        packer serves a step's ``(b, width)`` and a block's
        ``(K, b, width)``."""
        if packed.dtype != torch.int16:
            raise TypeError(f"packed lanes must be int16, got {packed.dtype}")
        lead = tuple(packed.shape[:-1])
        out = {}
        for key, tail, dtype, enc, off, span in self.specs:
            w = packed[..., off:off + span]
            if enc == 'u16':
                v = (w.to(torch.int32) & 0xffff).to(
                    torch.from_numpy(np.zeros(0, dtype)).dtype)
            elif enc.startswith('i16x'):
                v = w.to(torch.float32) / self._scale(enc, w.device)
            elif enc == 'f16':
                v = w.view(torch.float16).to(torch.float32)
            else:
                # (hi, lo) lane pairs: swapped, they are the little-endian
                # 32-bit word.
                pair = w.reshape(lead + (span // 2, 2)).flip(-1)
                v = pair.contiguous().view(
                    torch.float32 if enc == 'f32x2' else torch.int32)[..., 0]
            out[key] = v.reshape(lead + tuple(tail))
        return out

    def encodings(self) -> Dict[str, str]:
        """Per-key wire encodings."""
        return {s[0]: s[3] for s in self.specs}

    def wire_bytes(self, batch_dim: int) -> int:
        return 2 * batch_dim * self.width
