"""Record codecs — wire-compatible with the reference's data protos.

Reference schema: SINGA's src/proto/model.proto:279-305 —
  Record{ type=1 (enum, kSingleLabelImage=0), image=2 (message) }
  SingleLabelImageRecord{ shape=1 (repeated int32), label=2 (int32),
                          pixel=3 (bytes), data=4 (repeated float) }
  Datum{ channels=1, height=2, width=3, data=4 (bytes), label=5,
         float_data=6 (repeated float), encoded=7 (bool) }   (caffe LMDB)

Hand-rolled protobuf wire codec (varints + length-delimited fields) so
shards written by the reference `loader` binary decode here byte-for-byte
and shards written here feed the reference — without generated code.

The port's own copy of `singa_tpu/data/records.py`, which imports no JAX.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

# -- protobuf wire primitives ------------------------------------------------

_WT_VARINT, _WT_64, _WT_LEN, _WT_32 = 0, 1, 2, 5


def _enc_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _dec_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _tag(fieldnum: int, wt: int) -> bytes:
    return _enc_varint((fieldnum << 3) | wt)


def _iter_fields(buf: bytes):
    i = 0
    n = len(buf)
    while i < n:
        key, i = _dec_varint(buf, i)
        fieldnum, wt = key >> 3, key & 7
        if wt == _WT_VARINT:
            v, i = _dec_varint(buf, i)
        elif wt == _WT_LEN:
            ln, i = _dec_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == _WT_32:
            v = buf[i:i + 4]
            i += 4
        elif wt == _WT_64:
            v = buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"bad wire type {wt}")
        yield fieldnum, wt, v


# -- messages ----------------------------------------------------------------


@dataclass
class SingleLabelImageRecord:
    shape: List[int] = field(default_factory=list)
    label: int = 0
    pixel: bytes = b""
    data: List[float] = field(default_factory=list)

    def encode(self) -> bytes:
        out = bytearray()
        for s in self.shape:
            out += _tag(1, _WT_VARINT) + _enc_varint(s)
        if self.label:
            out += _tag(2, _WT_VARINT) + _enc_varint(self.label)
        if self.pixel:
            out += _tag(3, _WT_LEN) + _enc_varint(len(self.pixel)) + self.pixel
        for f in self.data:
            out += _tag(4, _WT_32) + struct.pack("<f", f)
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "SingleLabelImageRecord":
        rec = cls()
        for fn, wt, v in _iter_fields(buf):
            if fn == 1:
                if wt == _WT_LEN:   # packed repeated
                    i = 0
                    while i < len(v):
                        x, i = _dec_varint(v, i)
                        rec.shape.append(x)
                else:
                    rec.shape.append(v)
            elif fn == 2:
                rec.label = v
            elif fn == 3:
                rec.pixel = bytes(v)
            elif fn == 4:
                if wt == _WT_LEN:   # packed repeated float
                    rec.data.extend(
                        struct.unpack(f"<{len(v) // 4}f", v))
                else:
                    rec.data.append(struct.unpack("<f", v)[0])
        return rec

    def pixels_array(self) -> np.ndarray:
        if self.pixel:
            arr = np.frombuffer(self.pixel, np.uint8)
        else:
            arr = np.asarray(self.data, np.float32)
        return arr.reshape(self.shape) if self.shape else arr


@dataclass
class Record:
    KSINGLE_LABEL_IMAGE = 0
    type: int = KSINGLE_LABEL_IMAGE
    image: Optional[SingleLabelImageRecord] = None

    def encode(self) -> bytes:
        out = bytearray()
        # type has default 0 — the reference always writes image
        if self.type:
            out += _tag(1, _WT_VARINT) + _enc_varint(self.type)
        if self.image is not None:
            body = self.image.encode()
            out += _tag(2, _WT_LEN) + _enc_varint(len(body)) + body
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "Record":
        rec = cls()
        for fn, wt, v in _iter_fields(buf):
            if fn == 1:
                rec.type = v
            elif fn == 2:
                rec.image = SingleLabelImageRecord.decode(v)
        return rec


def record_has_image(buf: bytes) -> bool:
    """Whether a serialized Record carries an image submessage — a
    tag-walk only (no submessage parse), cheap enough for the input
    pipeline to filter image-less records before batching.

    Raises ValueError on an unparseable buffer: a torn/corrupt record
    must fail loudly (the shard store already truncates torn tails at
    open, shard.cc:175-206 semantics), not be silently dropped as if it
    were merely image-less."""
    try:
        for fn, wt, _ in _iter_fields(buf):
            if fn == 2 and wt == _WT_LEN:
                return True
    except (ValueError, IndexError) as e:
        raise ValueError(
            f"corrupt Record buffer ({len(buf)} bytes): {e}") from e
    return False


def record_from_datum(d: "Datum") -> "Record":
    """caffe Datum → Record, the conversion the reference's LMDB parse
    loop performs implicitly (layer.cc:285-316: Datum fields copied
    into the blob the same way Record fields are)."""
    if d.encoded:
        raise ValueError(
            "encoded (JPEG/PNG) Datum values are not supported — "
            "re-export the LMDB with convert_imageset's raw mode, or "
            "decode to raw pixels before conversion (no image codec "
            "exists in this environment)")
    img = SingleLabelImageRecord(
        shape=[d.channels, d.height, d.width], label=d.label,
        pixel=d.data, data=list(d.float_data) if not d.data else [])
    return Record(image=img)


@dataclass
class Datum:
    """caffe's LMDB record (model.proto:288-299)."""
    channels: int = 0
    height: int = 0
    width: int = 0
    data: bytes = b""
    label: int = 0
    float_data: List[float] = field(default_factory=list)
    encoded: bool = False

    def encode(self) -> bytes:
        out = bytearray()
        for fn, v in ((1, self.channels), (2, self.height), (3, self.width)):
            if v:
                out += _tag(fn, _WT_VARINT) + _enc_varint(v)
        if self.data:
            out += _tag(4, _WT_LEN) + _enc_varint(len(self.data)) + self.data
        if self.label:
            out += _tag(5, _WT_VARINT) + _enc_varint(self.label)
        for f in self.float_data:
            out += _tag(6, _WT_32) + struct.pack("<f", f)
        if self.encoded:
            out += _tag(7, _WT_VARINT) + _enc_varint(1)
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "Datum":
        d = cls()
        for fn, wt, v in _iter_fields(buf):
            if fn == 1:
                d.channels = v
            elif fn == 2:
                d.height = v
            elif fn == 3:
                d.width = v
            elif fn == 4:
                d.data = bytes(v)
            elif fn == 5:
                d.label = v
            elif fn == 6:
                if wt == _WT_LEN:
                    d.float_data.extend(struct.unpack(f"<{len(v) // 4}f", v))
                else:
                    d.float_data.append(struct.unpack("<f", v)[0])
            elif fn == 7:
                d.encoded = bool(v)
        return d
