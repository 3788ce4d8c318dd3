"""TFRecord conversion without TensorFlow or protobuf (counterpart of
dan_tpu/data/tfrecords.py): the reference trains from sharded TFRecords of
tf.train.Example records; this module writes and reads the same layout, so
datasets go both ways between the port and TF tooling:

    image/encoded, image/format, image/height, image/width, image/filename
    image/object/bbox/{xmin, ymin, xmax, ymax}   (normalized floats)
    image/object/bbox/label                       (1 = face)
    image/object/bbox/difficult                   (invalid flag)

    paths = convert_to_tfrecords(records, "/data/tfr", "train", num_shards=16)
    for record, jpeg_bytes in read_tfrecords(paths): ...

A TFRecord file is a sequence of records, each

    uint64 length | uint32 masked CRC-32C of those 8 bytes | data | uint32 masked CRC-32C of data

(little-endian; the mask is TF's, utils/crc32c.py).  The reader checks both
CRCs and raises TFRecordError on a mismatch or a truncated record.  The
messages go through utils/protowire.py:

    Example  { Features features = 1; }
    Features { map<string, Feature> feature = 1; }     entries {key = 1; value = 2}
    Feature  { oneof { BytesList bytes_list = 1; FloatList float_list = 2;
                       Int64List int64_list = 3; } }
    BytesList { repeated bytes value = 1; }  FloatList { repeated float value = 1 [packed]; }
    Int64List { repeated int64 value = 1 [packed]; }

The writer puts the map's entries in key order, as protobuf's
deterministic serialization does.  TF's own writer (upb) orders them by a
hash seeded per process, so its shards differ from run to run and from
these in that order alone; the reader takes any order, and packed or
unpacked numbers.

Boxes follow the reference exactly: written as float64 `box / w` stored as
float32, read back as `xmin * w` in float32 with w a Python int.  The
writer decodes each image once with cv2 for its (h, w).
"""
from __future__ import annotations

import os
import struct
from typing import BinaryIO, Dict, Iterator, List, Tuple

import numpy as np

from dan_tpu_torch.utils.crc32c import crc32c, mask, unmask
from dan_tpu_torch.utils.protowire import WireError, fields, put_field, put_varint, varint
from dan_tpu_torch.data.widerface import ImageRecord

_BYTES, _FLOATS, _INT64S = 1, 2, 3  # Feature's oneof fields


class TFRecordError(WireError):
    """A TFRecord file or Example that is damaged, truncated or lacks a
    feature the reader needs."""


# -- framing ---------------------------------------------------------------------

def write_record(f: BinaryIO, data: bytes) -> None:
    """Append one framed record to an open binary file."""
    length = struct.pack("<Q", len(data))
    f.write(length)
    f.write(struct.pack("<I", mask(crc32c(length))))
    f.write(data)
    f.write(struct.pack("<I", mask(crc32c(data))))


def iter_records(path: str) -> Iterator[bytes]:
    """The data of every record of a TFRecord file, each checked against
    its length's and its data's CRC."""
    with open(path, "rb") as f:
        n = 0
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise TFRecordError(f"{path}: record {n} is truncated in its header")
            length = head[:8]
            if crc32c(length) != unmask(struct.unpack("<I", head[8:])[0]):
                raise TFRecordError(f"{path}: CRC-32C mismatch in the length of record {n}")
            size = struct.unpack("<Q", length)[0]
            data = f.read(size)
            tail = f.read(4)
            if len(data) < size or len(tail) < 4:
                raise TFRecordError(f"{path}: record {n} is truncated")
            if crc32c(data) != unmask(struct.unpack("<I", tail)[0]):
                raise TFRecordError(f"{path}: CRC-32C mismatch in the data of record {n}")
            yield data
            n += 1


# -- tf.train.Example --------------------------------------------------------------

def _feature(kind: int, values) -> bytes:
    """A Feature holding a BytesList, a FloatList or an Int64List."""
    inner = bytearray()
    if kind == _BYTES:
        for v in values:
            put_field(inner, 1, v, 2)
    elif kind == _FLOATS and len(values):
        put_field(inner, 1, np.asarray(values, "<f4").tobytes(), 2)
    elif len(values):
        packed = bytearray()
        for v in values:
            put_varint(packed, int(v) & (2**64 - 1))  # int64: two's complement in 64 bits
        put_field(inner, 1, bytes(packed), 2)
    out = bytearray()
    put_field(out, kind, bytes(inner), 2)
    return bytes(out)


def serialize_example(feature: Dict[str, Tuple[int, object]]) -> bytes:
    """An Example of {name: (kind, values)}, its map entries in key order."""
    features = bytearray()
    for key in sorted(feature, key=lambda k: k.encode()):
        entry = bytearray()
        put_field(entry, 1, key.encode(), 2)
        put_field(entry, 2, _feature(*feature[key]), 2)
        put_field(features, 1, bytes(entry), 2)
    out = bytearray()
    put_field(out, 1, bytes(features), 2)
    return bytes(out)


def _values(kind: int, buf: bytes) -> list:
    """The values of a BytesList, FloatList or Int64List message."""
    out: list = []
    for field, wire, value in fields(buf):
        if field != 1:
            continue
        if kind == _BYTES and wire == 2:
            out.append(value)
        elif kind == _FLOATS and wire == 2:
            if len(value) % 4:
                raise TFRecordError("a packed float list of a length not a multiple of 4")
            out.extend(np.frombuffer(value, "<f4").tolist())
        elif kind == _FLOATS and wire == 5:
            out.append(struct.unpack("<f", struct.pack("<I", value))[0])
        elif kind == _INT64S and wire == 2:
            pos = 0
            while pos < len(value):
                v, pos = varint(value, pos)
                out.append(v - 2**64 if v >= 2**63 else v)
        elif kind == _INT64S and wire == 0:
            out.append(value - 2**64 if value >= 2**63 else value)
        else:
            raise TFRecordError(f"list kind {kind} with wire type {wire}")
    return out


def parse_example(data: bytes) -> Dict[str, Tuple[int, list]]:
    """{name: (kind, values)} of a serialized Example; floats as Python
    floats of float32 values."""
    out: Dict[str, Tuple[int, list]] = {}
    for field, wire, features in fields(data):
        if field != 1 or wire != 2:
            continue
        for f2, w2, entry in fields(features):
            if f2 != 1 or w2 != 2:
                continue
            key, feature = "", b""
            for f3, w3, value in fields(entry):
                if f3 == 1 and w3 == 2:
                    key = value.decode("utf-8")
                elif f3 == 2 and w3 == 2:
                    feature = value
            kind, values = 0, []
            for f4, w4, value in fields(feature):
                if f4 in (_BYTES, _FLOATS, _INT64S) and w4 == 2:
                    kind, values = f4, _values(f4, value)
            out[key] = (kind, values)
    return out


# -- the dataset layout ----------------------------------------------------------------

def _features(record: ImageRecord, encoded: bytes, h: int, w: int):
    boxes = record.boxes.astype(np.float64)
    norm = [(boxes[:, i] / d).astype(np.float32) if len(boxes) else np.zeros(0, np.float32)
            for i, d in zip(range(4), (w, h, w, h))]
    n = len(boxes)
    return {
        "image/encoded": (_BYTES, [encoded]),
        "image/format": (_BYTES, [b"JPEG"]),
        "image/height": (_INT64S, [h]),
        "image/width": (_INT64S, [w]),
        "image/filename": (_BYTES, [record.rel_path.encode()]),
        "image/object/bbox/xmin": (_FLOATS, norm[0]),
        "image/object/bbox/ymin": (_FLOATS, norm[1]),
        "image/object/bbox/xmax": (_FLOATS, norm[2]),
        "image/object/bbox/ymax": (_FLOATS, norm[3]),
        "image/object/bbox/label": (_INT64S, [1] * n),
        "image/object/bbox/difficult": (_INT64S, [0] * n),
    }


def shard_paths(output_dir: str, split: str, num_shards: int) -> List[str]:
    return [os.path.join(output_dir, f"{split}-{i:05d}-of-{num_shards:05d}.tfrecord")
            for i in range(num_shards)]


def convert_to_tfrecords(
    records: List[ImageRecord],
    output_dir: str,
    split: str = "train",
    num_shards: int = 16,
) -> List[str]:
    """Write sharded TFRecords (record i to shard i % num_shards); returns
    the shard paths."""
    import cv2

    os.makedirs(output_dir, exist_ok=True)
    paths = shard_paths(output_dir, split, num_shards)
    files = [open(p, "wb") for p in paths]
    try:
        for i, rec in enumerate(records):
            with open(rec.path, "rb") as f:
                encoded = f.read()
            img = cv2.imdecode(np.frombuffer(encoded, np.uint8), cv2.IMREAD_COLOR)
            if img is None:
                raise ValueError(f"undecodable image: {rec.path}")
            h, w = img.shape[:2]
            write_record(files[i % num_shards],
                         serialize_example(_features(rec, encoded, h, w)))
    finally:
        for f in files:
            f.close()
    return paths


def _one(example, key: str, kind: int):
    got_kind, values = example.get(key, (0, []))
    if got_kind != kind or len(values) != 1:
        raise TFRecordError(f"feature {key!r}: expected one value of list kind {kind}, got "
                            f"{len(values)} of kind {got_kind}")
    return values[0]


def _floats(example, key: str) -> np.ndarray:
    kind, values = example.get(key, (_FLOATS, []))
    if kind not in (_FLOATS, 0):
        raise TFRecordError(f"feature {key!r} is not a float list")
    return np.asarray(values, np.float32)


def read_tfrecords(paths: List[str]) -> Iterator[Tuple[ImageRecord, bytes]]:
    """Parse TFRecords back into (ImageRecord, jpeg_bytes) pairs (callers
    decode with cv2.imdecode when needed); path is "" (the JPEG is the
    bytes), attrs zeros."""
    for path in paths:
        for data in iter_records(path):
            ex = parse_example(data)
            h = int(_one(ex, "image/height", _INT64S))
            w = int(_one(ex, "image/width", _INT64S))
            rel = _one(ex, "image/filename", _BYTES).decode()
            encoded = _one(ex, "image/encoded", _BYTES)
            xmin, ymin, xmax, ymax = (_floats(ex, f"image/object/bbox/{k}")
                                      for k in ("xmin", "ymin", "xmax", "ymax"))
            boxes = np.stack(
                [xmin * w, ymin * h, xmax * w, ymax * h], axis=-1
            ).astype(np.float32) if len(xmin) else np.zeros((0, 4), np.float32)
            yield ImageRecord(
                path="",
                rel_path=rel,
                event=rel.split("/")[0],
                boxes=boxes,
                attrs=np.zeros((len(boxes), 6), np.float32),
            ), encoded
