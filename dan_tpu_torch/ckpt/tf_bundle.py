"""TF's V2 tensor bundle (what `tf.train.Saver` and `tf.train.Checkpoint`
write), read and written without TensorFlow or protobuf.

A bundle with prefix P is `P.index` and the data shards
`P.data-00000-of-0000N`.  The index is a LevelDB-format table:

    data blocks | metaindex block | index block | footer (48 bytes)

  * footer: the BlockHandles (varint64 offset, varint64 size) of the
    metaindex and the index block, zeros up to 40 bytes, then the fixed64
    magic 0xdb4775248b80fb57;
  * a block: entries `varint shared, varint non_shared, varint value_len,
    key[shared:], value` (each key shares a prefix with the one before it,
    none at a restart point), then the uint32 restart offsets and their
    count; after it a 5-byte trailer, the compression type (0: none, the
    only one read here) and the masked CRC-32C of the block and that byte;
  * the index block maps a separator key (>= every key of its block) to
    the BlockHandle of each data block.

Values are protobuf messages, decoded by utils/protowire.py.
The key "" holds the BundleHeaderProto (num_shards 1, endianness 2,
version 3); every other key a BundleEntryProto (dtype 1, shape 2, shard_id
3, offset 4, size 5, crc32c 6 as fixed32, slices 7).  Proto3 leaves out
fields equal to 0, so a missing offset is 0 and a scalar's shape is empty.
A tensor is `size` bytes at `offset` of its shard, little-endian, with its
masked CRC-32C in the entry.

    reader = BundleReader(prefix)
    reader.get_variable_to_shape_map()       # {name: [dims]}
    reader.get_tensor(name)                  # numpy array
    write_bundle(prefix, {name: array})      # readable by tf.train.load_checkpoint

bfloat16 tensors are returned as float32 (exact: bf16 is the upper half of
a float32); `get_variable_to_dtype_map` still names them bfloat16.  String
tensors are listed but not read, nor are partitioned (sliced) variables.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np

from dan_tpu_torch.utils.crc32c import crc32c, mask, unmask
from dan_tpu_torch.utils.protowire import WireError
from dan_tpu_torch.utils.protowire import fields as _fields
from dan_tpu_torch.utils.protowire import put_field as _put_field
from dan_tpu_torch.utils.protowire import put_varint as _put_varint
from dan_tpu_torch.utils.protowire import varint as _varint

MAGIC = 0xDB4775248B80FB57
FOOTER_LEN = 48
BLOCK_TRAILER_LEN = 5
# tensorflow/core/lib/io/table_options.h: block size and restart interval.
BLOCK_SIZE = 262144
RESTART_INTERVAL = 16

# DataType enum (tensorflow/core/framework/types.proto) -> (name, numpy dtype
# of the stored bytes).
DTYPES = {
    1: ("float32", np.dtype("<f4")),
    2: ("float64", np.dtype("<f8")),
    3: ("int32", np.dtype("<i4")),
    4: ("uint8", np.dtype("u1")),
    5: ("int16", np.dtype("<i2")),
    6: ("int8", np.dtype("i1")),
    9: ("int64", np.dtype("<i8")),
    10: ("bool", np.dtype("?")),
    14: ("bfloat16", np.dtype("<u2")),
    19: ("float16", np.dtype("<f2")),
}
_OTHER_DTYPES = {7: "string", 8: "complex64", 11: "qint8", 12: "quint8", 13: "qint32",
                 15: "qint16", 16: "quint16", 17: "uint16", 18: "complex128",
                 20: "resource", 21: "variant", 22: "uint32", 23: "uint64"}


class BundleError(ValueError):
    """A bundle this reader cannot read, or one whose bytes are damaged."""


@dataclass
class Entry:
    """A BundleEntryProto."""

    dtype: int = 0
    shape: Tuple[int, ...] = ()
    shard_id: int = 0
    offset: int = 0
    size: int = 0
    crc32c: int = 0
    sliced: bool = False

    @classmethod
    def parse(cls, buf) -> "Entry":
        e = cls()
        for field, _, value in _fields(buf):
            if field == 1:
                e.dtype = value
            elif field == 2:
                e.shape = _parse_shape(value)
            elif field == 3:
                e.shard_id = value
            elif field == 4:
                e.offset = value
            elif field == 5:
                e.size = value
            elif field == 6:
                e.crc32c = value
            elif field == 7:
                e.sliced = True
        return e

    def serialize(self) -> bytes:
        out = bytearray()
        if self.dtype:
            _put_field(out, 1, self.dtype)
        shape = bytearray()
        for d in self.shape:
            dim = bytearray()
            if d:
                _put_field(dim, 1, d)
            _put_field(shape, 2, bytes(dim), 2)
        _put_field(out, 2, bytes(shape), 2)
        for field, value in ((3, self.shard_id), (4, self.offset), (5, self.size)):
            if value:
                _put_field(out, field, value)
        _put_field(out, 6, self.crc32c, 5)
        return bytes(out)


def _parse_shape(buf) -> Tuple[int, ...]:
    dims: List[int] = []
    for field, _, value in _fields(buf):
        if field == 2:  # TensorShapeProto.dim
            size = 0
            for f, _, v in _fields(value):
                if f == 1:
                    size = v
            dims.append(size)
        elif field == 3 and value:
            raise BundleError("a tensor of unknown rank")
    return tuple(dims)


def _parse_header(buf) -> Tuple[int, int]:
    """BundleHeaderProto -> (num_shards, endianness)."""
    num_shards, endianness = 0, 0
    for field, _, value in _fields(buf):
        if field == 1:
            num_shards = value
        elif field == 2:
            endianness = value
    return num_shards, endianness


def _version() -> bytes:
    """VersionDef { producer: 1 }: the bundle format's version."""
    version = bytearray()
    _put_field(version, 1, 1)
    return bytes(version)


# -- table ---------------------------------------------------------------------

def _handle(buf, pos: int = 0) -> Tuple[int, int, int]:
    offset, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return offset, size, pos


def _read_block(data: bytes, offset: int, size: int, what: str) -> memoryview:
    end = offset + size + BLOCK_TRAILER_LEN
    if end > len(data):
        raise BundleError(f"{what} runs past the end of the index file")
    block = memoryview(data)[offset:offset + size]
    kind = data[offset + size]
    if kind != 0:
        raise BundleError(f"{what} has compression type {kind}; only uncompressed (0) "
                          "blocks are read")
    want = unmask(struct.unpack_from("<I", data, offset + size + 1)[0])
    if crc32c(memoryview(data)[offset:offset + size + 1]) != want:
        raise BundleError(f"CRC-32C mismatch in {what} of the index file")
    return block


def _block_entries(block: memoryview, what: str) -> Iterator[Tuple[bytes, bytes]]:
    if len(block) < 4:
        raise BundleError(f"{what} is too short")
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 - 4 * n_restarts
    if end < 0:
        raise BundleError(f"{what}: bad restart count")
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        value_len, pos = _varint(block, pos)
        if shared > len(key) or pos + non_shared + value_len > end:
            raise BundleError(f"{what}: a corrupt entry")
        key = key[:shared] + bytes(block[pos:pos + non_shared])
        pos += non_shared
        yield key, bytes(block[pos:pos + value_len])
        pos += value_len


class _BlockWriter:
    def __init__(self, restart_interval: int):
        self.interval = restart_interval
        self.buf = bytearray()
        self.restarts = [0]
        self.count = 0
        self.last = b""

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self.count < self.interval:
            while shared < min(len(key), len(self.last)) and key[shared] == self.last[shared]:
                shared += 1
        else:
            self.restarts.append(len(self.buf))
            self.count = 0
        for v in (shared, len(key) - shared, len(value)):
            _put_varint(self.buf, v)
        self.buf += key[shared:]
        self.buf += value
        self.last = key
        self.count += 1

    def size(self) -> int:
        return len(self.buf) + 4 * len(self.restarts) + 4

    def finish(self) -> bytes:
        tail = struct.pack(f"<{len(self.restarts)}I", *self.restarts)
        return bytes(self.buf) + tail + struct.pack("<I", len(self.restarts))


def _separator(start: bytes, limit: bytes) -> bytes:
    """LevelDB's BytewiseComparator::FindShortestSeparator: a short key in
    [start, limit)."""
    n = min(len(start), len(limit))
    i = 0
    while i < n and start[i] == limit[i]:
        i += 1
    if i < n and start[i] < 0xFF and start[i] + 1 < limit[i]:
        return start[:i] + bytes([start[i] + 1])
    return start


def _successor(key: bytes) -> bytes:
    """FindShortSuccessor: a short key >= key."""
    for i, b in enumerate(key):
        if b != 0xFF:
            return key[:i] + bytes([b + 1])
    return key


def _write_table(f, items: List[Tuple[bytes, bytes]], block_size: int) -> None:
    """LevelDB table of sorted (key, value) items, uncompressed, with TF's
    restart interval in the data blocks."""
    pos = 0

    def write_block(contents: bytes) -> Tuple[int, int]:
        nonlocal pos
        trailer = b"\x00" + struct.pack("<I", mask(crc32c(contents + b"\x00")))
        f.write(contents)
        f.write(trailer)
        handle = (pos, len(contents))
        pos += len(contents) + BLOCK_TRAILER_LEN
        return handle

    def handle_bytes(h) -> bytes:
        out = bytearray()
        _put_varint(out, h[0])
        _put_varint(out, h[1])
        return bytes(out)

    index = _BlockWriter(1)
    block = _BlockWriter(RESTART_INTERVAL)
    pending: Optional[Tuple[int, int]] = None  # a flushed block not yet indexed
    for key, value in items:
        if pending is not None:
            index.add(_separator(block.last, key), handle_bytes(pending))
            pending = None
            block = _BlockWriter(RESTART_INTERVAL)
        block.add(key, value)
        if block.size() >= block_size:
            pending = write_block(block.finish())
    if pending is None and block.count:
        pending = write_block(block.finish())
    if pending is not None:
        index.add(_successor(block.last), handle_bytes(pending))
    meta = write_block(_BlockWriter(RESTART_INTERVAL).finish())
    idx = write_block(index.finish())
    footer = handle_bytes(meta) + handle_bytes(idx)
    f.write(footer + b"\x00" * (40 - len(footer)) + struct.pack("<Q", MAGIC))


# -- reader ---------------------------------------------------------------------

def shard_path(prefix: str, shard: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


class BundleReader:
    """The tensors of the bundle at `prefix`, read on request: the two
    calls of `tf.train.load_checkpoint` that the importer makes."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        try:
            self._read_index()
        except WireError as e:  # a damaged varint or protobuf value
            raise BundleError(f"{prefix}.index: {e}") from e

    def _read_index(self) -> None:
        prefix = self.prefix
        with open(prefix + ".index", "rb") as f:
            data = f.read()
        if len(data) < FOOTER_LEN:
            raise BundleError(f"{prefix}.index is too short for a table")
        footer = data[-FOOTER_LEN:]
        if struct.unpack_from("<Q", footer, 40)[0] != MAGIC:
            raise BundleError(f"{prefix}.index is not a TF tensor bundle (bad magic)")
        _, _, pos = _handle(footer)
        idx_off, idx_size, _ = _handle(footer, pos)
        index = _read_block(data, idx_off, idx_size, "the index block")
        entries: Dict[bytes, bytes] = {}
        for i, (_, value) in enumerate(_block_entries(index, "the index block")):
            off, size, _ = _handle(value)
            block = _read_block(data, off, size, f"data block {i}")
            entries.update(_block_entries(block, f"data block {i}"))
        if b"" not in entries:
            raise BundleError(f"{prefix}.index has no bundle header")
        self.num_shards, endianness = _parse_header(entries.pop(b""))
        if endianness != 0:
            raise BundleError(f"{prefix} is a big-endian bundle; only little-endian is read")
        # A partitioned variable's slices sit under binary keys that start
        # with a 0 byte (TF's EncodeTensorNameSlice); its own entry lists them.
        self._entries = {k.decode("utf-8"): Entry.parse(v) for k, v in entries.items()
                         if not k.startswith(b"\x00")}

    def get_variable_to_shape_map(self) -> Dict[str, List[int]]:
        return {k: list(e.shape) for k, e in self._entries.items()}

    def get_variable_to_dtype_map(self) -> Dict[str, str]:
        return {k: DTYPES[e.dtype][0] if e.dtype in DTYPES
                else _OTHER_DTYPES.get(e.dtype, f"dtype {e.dtype}")
                for k, e in self._entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        if name not in self._entries:
            raise KeyError(f"{name} is not in the bundle {self.prefix}")
        e = self._entries[name]
        if e.sliced:
            raise BundleError(f"{name} is a partitioned (sliced) variable; not supported")
        if e.dtype not in DTYPES:
            kind = _OTHER_DTYPES.get(e.dtype, f"dtype {e.dtype}")
            raise BundleError(f"{name} holds {kind} values, which this reader does not read")
        if not 0 <= e.shard_id < self.num_shards:
            raise BundleError(f"{name}: shard {e.shard_id} of {self.num_shards}")
        stored = DTYPES[e.dtype][1]
        count = int(np.prod(e.shape, dtype=np.int64))
        if e.size != count * stored.itemsize:
            raise BundleError(f"{name}: {e.size} bytes for shape {e.shape} of "
                              f"{DTYPES[e.dtype][0]}")
        raw = np.fromfile(shard_path(self.prefix, e.shard_id, self.num_shards),
                          dtype=np.uint8, count=e.size, offset=e.offset)
        if raw.size != e.size:
            raise BundleError(f"{name}: the data shard ends inside the tensor")
        if crc32c(raw) != unmask(e.crc32c):
            raise BundleError(f"CRC-32C mismatch in the data of {name}")
        value = raw.view(stored).reshape(e.shape)
        if e.dtype == 14:  # bfloat16: the upper half of a float32
            value = (value.astype(np.uint32) << 16).view(np.float32)
        return value


# -- writer ----------------------------------------------------------------------

def _tensor_bytes(value) -> Tuple[int, Tuple[int, ...], np.ndarray]:
    """(dtype enum, shape, little-endian bytes as uint8) of a numpy array
    or a torch tensor."""
    if type(value).__module__.startswith("torch"):
        import torch

        t = value.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return 14, tuple(t.shape), t.view(torch.int16).numpy().view(np.uint8).reshape(-1)
        value = t.numpy()
    a = np.asarray(value)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16
        return 14, a.shape, np.ascontiguousarray(a).view(np.uint8).reshape(-1)
    key = a.dtype.newbyteorder("<") if a.dtype.byteorder == ">" else a.dtype
    for enum, (name, stored) in DTYPES.items():
        if enum != 14 and np.dtype(key) == stored:
            return enum, a.shape, np.ascontiguousarray(a, stored).view(np.uint8).reshape(-1)
    raise TypeError(f"dtype {a.dtype} cannot be written to a tensor bundle")


def write_bundle(prefix: str, tensors: Mapping[str, object], num_shards: int = 1,
                 block_size: int = BLOCK_SIZE) -> None:
    """Write `tensors` ({name: numpy array or torch tensor}) as the bundle
    `prefix`: keys in bytewise order with the header first, tensors spread
    over `num_shards` data files in that order (name i in shard i %
    num_shards), an empty metaindex block and the footer."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    d = os.path.dirname(prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    names = sorted(tensors, key=lambda n: n.encode("utf-8"))
    if "" in tensors:
        raise ValueError("the empty name is the bundle header's key")
    files = [open(shard_path(prefix, s, num_shards), "wb") for s in range(num_shards)]
    pos = [0] * num_shards
    items = []
    try:
        for i, name in enumerate(names):
            dtype, shape, raw = _tensor_bytes(tensors[name])
            shard = i % num_shards
            files[shard].write(memoryview(raw))
            items.append((name.encode("utf-8"), Entry(
                dtype=dtype, shape=tuple(int(s) for s in shape), shard_id=shard,
                offset=pos[shard], size=raw.size, crc32c=mask(crc32c(raw))).serialize()))
            pos[shard] += raw.size
    finally:
        for f in files:
            f.close()
    header = bytearray()
    _put_field(header, 1, num_shards)
    _put_field(header, 3, _version(), 2)
    with open(prefix + ".index", "wb") as f:
        _write_table(f, [(b"", bytes(header))] + items, block_size)
