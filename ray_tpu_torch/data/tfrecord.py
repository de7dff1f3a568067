"""TFRecord + tf.train.Example codec, with no TensorFlow dependency (the
port's copy of ``ray_tpu/data/tfrecord.py``: standard library only, so
both packages write the same bytes).

Equivalent of the reference's TFRecordDatasource (reference:
python/ray/data/datasource/tfrecords_datasource.py — which parses
tf.train.Example records, via tf or a pure-python fallback). TFRecord is
the format training corpora often arrive in, and the reader must not
need TensorFlow: both the record framing
(length / masked-crc32c / payload / masked-crc32c) and the Example
protobuf (Features -> map<string, Feature> -> bytes/float/int64 lists)
are implemented here directly from the public wire formats.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List

# ---------------------------------------------------------------- crc32c

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf

def _write_varint(out: bytearray, v: int) -> None:
    while True:
        bits = v & 0x7F
        v >>= 7
        if v:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _encode_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(payload))
    out += payload


def _encode_feature(values: list) -> bytes:
    """One tf.train.Feature: bytes_list=1 / float_list=2 / int64_list=3.
    `values` is pre-normalized to bytes/str, float, or int elements."""
    inner = bytearray()
    if values and isinstance(values[0], (bytes, str)):
        for v in values:
            _encode_len_delimited(
                inner, 1, v.encode() if isinstance(v, str) else v)
        kind = 1
    elif values and isinstance(values[0], float):
        packed = struct.pack(f"<{len(values)}f", *values)
        _encode_len_delimited(inner, 1, packed)
        kind = 2
    else:
        packed = bytearray()
        for v in values:
            _write_varint(packed, int(v) & 0xFFFFFFFFFFFFFFFF)
        _encode_len_delimited(inner, 1, bytes(packed))
        kind = 3
    feature = bytearray()
    _encode_len_delimited(feature, kind, bytes(inner))
    return bytes(feature)


def encode_example(row: Dict[str, Any]) -> bytes:
    """dict -> serialized tf.train.Example. Scalars become 1-element
    lists (the Example convention); numpy arrays flatten."""
    import numpy as np

    features = bytearray()
    for key in sorted(row):
        value = row[key]
        if isinstance(value, np.ndarray):
            values = list(value.reshape(-1))
        elif isinstance(value, (list, tuple)):
            values = list(value)
        else:
            values = [value]
        if values and isinstance(values[0], (np.floating, float)):
            values = [float(v) for v in values]
        elif values and isinstance(values[0], (np.integer, int)) and not isinstance(values[0], bool):
            values = [int(v) for v in values]
        entry = bytearray()
        _encode_len_delimited(entry, 1, key.encode())
        _encode_len_delimited(entry, 2, _encode_feature(values))
        _encode_len_delimited(features, 1, bytes(entry))
    example = bytearray()
    _encode_len_delimited(example, 1, bytes(features))
    return bytes(example)


def _decode_feature(buf: bytes) -> list:
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        assert wire == 2, f"unexpected wire type {wire} in Feature"
        ln, pos = _read_varint(buf, pos)
        payload = buf[pos:pos + ln]
        pos += ln
        if field == 1:    # BytesList
            out, p = [], 0
            while p < len(payload):
                t, p = _read_varint(payload, p)
                assert t >> 3 == 1
                n, p = _read_varint(payload, p)
                out.append(payload[p:p + n])
                p += n
            return out
        if field == 2:    # FloatList (packed, or repeated unpacked)
            out, p = [], 0
            while p < len(payload):
                t, p = _read_varint(payload, p)
                if t & 7 == 2:
                    n, p = _read_varint(payload, p)
                    out += list(struct.unpack(f"<{n // 4}f",
                                              payload[p:p + n]))
                    p += n
                else:  # wire 5: single fixed32
                    out.append(struct.unpack("<f", payload[p:p + 4])[0])
                    p += 4
            return out
        if field == 3:    # Int64List
            out, p = [], 0
            while p < len(payload):
                t, p = _read_varint(payload, p)
                if t & 7 == 2:
                    n, p = _read_varint(payload, p)
                    end = p + n
                    while p < end:
                        v, p = _read_varint(payload, p)
                        out.append(v - (1 << 64) if v >= (1 << 63) else v)
                else:  # wire 0: unpacked varint
                    v, p = _read_varint(payload, p)
                    out.append(v - (1 << 64) if v >= (1 << 63) else v)
            return out
    return []


def decode_example(buf: bytes) -> Dict[str, list]:
    """serialized tf.train.Example -> {name: list of bytes/float/int}."""
    out: Dict[str, list] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        if tag >> 3 != 1 or tag & 7 != 2:
            raise ValueError("not a tf.train.Example (bad Features field)")
        ln, pos = _read_varint(buf, pos)
        features = buf[pos:pos + ln]
        pos += ln
        fpos = 0
        while fpos < len(features):
            ftag, fpos = _read_varint(features, fpos)
            assert ftag >> 3 == 1 and ftag & 7 == 2
            fln, fpos = _read_varint(features, fpos)
            entry = features[fpos:fpos + fln]
            fpos += fln
            # map entry: key=1 (string), value=2 (Feature)
            key = value = None
            epos = 0
            while epos < len(entry):
                etag, epos = _read_varint(entry, epos)
                eln, epos = _read_varint(entry, epos)
                payload = entry[epos:epos + eln]
                epos += eln
                if etag >> 3 == 1:
                    key = payload.decode()
                else:
                    value = payload
            if key is not None:
                out[key] = _decode_feature(value or b"")
    return out


# --------------------------------------------------------- record framing

def write_records(path: str, payloads: Iterator[bytes]) -> int:
    """Write framed TFRecords; returns the record count."""
    n = 0
    with open(path, "wb") as f:
        for payload in payloads:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))
            n += 1
    return n


def read_records(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    def must_read(f, n: int, what: str) -> bytes:
        buf = f.read(n)
        if len(buf) < n:
            raise ValueError(f"truncated TFRecord ({what}) in {path}")
        return buf

    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) < 8:
                raise ValueError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", must_read(f, 4, "length crc"))
            payload = must_read(f, length, "payload")
            (pcrc,) = struct.unpack("<I", must_read(f, 4, "data crc"))
            if verify_crc:
                if _masked_crc(header) != hcrc:
                    raise ValueError(f"TFRecord length-crc mismatch in {path}")
                if _masked_crc(payload) != pcrc:
                    raise ValueError(f"TFRecord data-crc mismatch in {path}")
            yield payload
