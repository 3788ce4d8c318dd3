"""The protobuf wire format, by hand: enough to read and write the few
messages the port exchanges with TensorFlow's files without TensorFlow or
protobuf (the tensor bundle's index entries, ckpt/tf_bundle.py, and the
tf.train.Example records of data/tfrecords.py).

A message is a sequence of (tag, value) pairs, the tag a varint of
`field << 3 | wire type`: 0 a varint, 1 eight little-endian bytes, 2 a
varint length and that many bytes (strings, sub-messages, packed repeated
numbers), 5 four little-endian bytes.

    for field, wire, value in fields(buf): ...   # int, or bytes for wire type 2
    out = bytearray(); put_field(out, 1, b"abc", 2)
"""
from __future__ import annotations

import struct
from typing import Iterator, Tuple


class WireError(ValueError):
    """Bytes that are not a well-formed protobuf message."""


def varint(buf, pos: int) -> Tuple[int, int]:
    """(value, position after it) of the varint at buf[pos]."""
    result, shift = 0, 0
    while True:
        if pos >= len(buf):
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise WireError("varint longer than 10 bytes")


def put_varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def fields(buf) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a protobuf message: an int for
    varint and fixed fields, bytes for length-delimited ones."""
    pos = 0
    while pos < len(buf):
        tag, pos = varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = varint(buf, pos)
        elif wire == 1:
            if pos + 8 > len(buf):
                raise WireError("truncated protobuf message")
            value = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:
            n, pos = varint(buf, pos)
            value = bytes(buf[pos:pos + n])
            pos += n
        elif wire == 5:
            if pos + 4 > len(buf):
                raise WireError("truncated protobuf message")
            value = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise WireError(f"protobuf wire type {wire} is not supported")
        if pos > len(buf):
            raise WireError("truncated protobuf message")
        yield field, wire, value


def put_field(out: bytearray, field: int, value, wire: int = 0) -> None:
    """Append one field: wire 0 an int as a varint, 2 bytes with their
    length, 5 an int as four bytes."""
    put_varint(out, field << 3 | wire)
    if wire == 0:
        put_varint(out, value)
    elif wire == 2:
        put_varint(out, len(value))
        out += value
    elif wire == 5:
        out += struct.pack("<I", value)
    else:
        raise ValueError(wire)
