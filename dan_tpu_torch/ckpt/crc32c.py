"""CRC-32C (Castagnoli) in numpy, and TF's masked form of it.

TF's tensor bundles checksum every table block and every tensor with
CRC-32C (reflected polynomial 0x82F63B78, initial value and final xor
0xFFFFFFFF) and store it masked: rotated right by 15 bits plus 0xa282ead8.
zlib's crc32 is the IEEE polynomial, so it cannot stand in.

    crc32c(b"123456789") == 0xE3069283
    mask(c), unmask(mask(c)) == c
    crc32c_combine(crc32c(a), crc32c(b), len(b)) == crc32c(a + b)

A byte loop in Python would take minutes over a 96 MB checkpoint.  Here the
data is cut into equal chunks and every chunk's CRC advances one table
lookup a byte, four bytes a step, across all chunks at once; the chunk CRCs are then joined
pairwise, each join shifting the left CRC by the right chunk's length of
zero bytes (a fixed GF(2) 32x32 matrix, applied through four byte tables).
"""
from __future__ import annotations

import numpy as np

POLY = 0x82F63B78
MASK_DELTA = 0xA282EAD8
_U32 = 0xFFFFFFFF
# Chunks the data is cut into at most; a step costs a few numpy calls on a
# vector this long.
_LANES = 1 << 14


def _byte_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(POLY), t >> 1).astype(np.uint32)
    return t


_TABLE = _byte_table()
# Slice-by-4: _TABLES[k][b] is the register after byte b and k zero bytes.
_TABLES = [_TABLE]
for _ in range(3):
    _TABLES.append(_TABLE[_TABLES[-1] & 0xFF] ^ (_TABLES[-1] >> 8))


def mask(crc: int) -> int:
    """TF's masked CRC (tensorflow/core/lib/hash/crc32c.h::Mask)."""
    crc &= _U32
    return ((((crc >> 15) | (crc << 17)) & _U32) + MASK_DELTA) & _U32


def unmask(masked: int) -> int:
    rot = (masked - MASK_DELTA) & _U32
    return ((rot >> 17) | (rot << 15)) & _U32


# -- the zero-shift operator: a GF(2) matrix as the images of the 32 bits ----

def _apply(cols, v: int) -> int:
    out, i = 0, 0
    while v:
        if v & 1:
            out ^= cols[i]
        v >>= 1
        i += 1
    return out


def _square(cols):
    return [_apply(cols, c) for c in cols]


def _byte_op():
    """The matrix that advances a raw register (no init, no final xor)
    over one zero byte."""
    op = [(POLY if i == 0 else 0) ^ ((1 << i) >> 1) for i in range(32)]  # one bit
    for _ in range(3):
        op = _square(op)
    return op


_POW2 = [_byte_op()]  # _POW2[k]: the matrix for 2**k zero bytes


def _pow2(k: int):
    while len(_POW2) <= k:
        _POW2.append(_square(_POW2[-1]))
    return _POW2[k]


def _shift_cols(n_bytes: int):
    """The matrix that advances a raw register over n_bytes zero bytes."""
    result = [1 << i for i in range(32)]
    k = 0
    while n_bytes:
        if n_bytes & 1:
            result = [_apply(_pow2(k), c) for c in result]
        n_bytes >>= 1
        k += 1
    return result


def _shift_tables(cols) -> np.ndarray:
    """(4, 256) tables: the matrix applied to each byte of a register."""
    b = np.arange(256, dtype=np.uint64)
    out = np.zeros((4, 256), np.uint32)
    for k in range(4):
        acc = np.zeros(256, np.uint64)
        for bit in range(8):
            acc ^= np.where((b >> bit) & 1, np.uint64(cols[8 * k + bit]), np.uint64(0))
        out[k] = acc.astype(np.uint32)
    return out


def _shift_vec(regs: np.ndarray, tables: np.ndarray) -> np.ndarray:
    return (tables[0][regs & 0xFF] ^ tables[1][(regs >> 8) & 0xFF]
            ^ tables[2][(regs >> 16) & 0xFF] ^ tables[3][regs >> 24])


def _shift(reg: int, n_bytes: int) -> int:
    k = 0
    while n_bytes:
        if n_bytes & 1:
            reg = _apply(_pow2(k), reg)
        n_bytes >>= 1
        k += 1
    return reg


def crc32c_combine(crc_a: int, crc_b: int, len_b: int) -> int:
    """CRC-32C of a + b from crc32c(a), crc32c(b) and len(b)."""
    return (_shift(crc_a, len_b) ^ crc_b) & _U32


# -- the chunked CRC ---------------------------------------------------------

def _raw_lanes(words: np.ndarray) -> np.ndarray:
    """(lanes, steps) uint32 little-endian words -> each lane's raw CRC
    (initial register 0, no final xor), four bytes a step."""
    t0, t1, t2, t3 = _TABLES
    reg = np.zeros(words.shape[0], np.uint32)
    for j in range(words.shape[1]):
        reg ^= words[:, j]
        b = reg.view(np.uint8).reshape(-1, 4)  # the register's bytes, low first
        reg = np.take(t3, b[:, 0])
        reg ^= np.take(t2, b[:, 1])
        reg ^= np.take(t1, b[:, 2])
        reg ^= np.take(t0, b[:, 3])
    return reg


def _raw(data: np.ndarray) -> int:
    """Raw CRC of a uint8 array: zero bytes in front leave a register that
    starts at 0 at 0, so the data is padded in front to whole chunks."""
    n = data.size
    if n == 0:
        return 0
    lanes = min(_LANES, max(1, n // 256))
    chunk = -(-n // lanes)
    chunk = -(-chunk // 4) * 4
    lanes = -(-n // chunk)
    if lanes * chunk == n:
        padded = data
    else:
        padded = np.zeros(lanes * chunk, np.uint8)
        padded[lanes * chunk - n:] = data
    words = padded.view("<u4").reshape(lanes, chunk // 4)
    regs = _raw_lanes(words)
    # Join neighbours: left shifted over the right's bytes, xor the right.
    op = _shift_cols(chunk)
    while regs.size > 1:
        if regs.size % 2:  # a zero chunk in front changes nothing
            regs = np.concatenate([np.zeros(1, np.uint32), regs])
        regs = _shift_vec(regs[0::2], _shift_tables(op)) ^ regs[1::2]
        op = _square(op)
    return int(regs[0])


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C of `data` (bytes-like or a numpy array, read as its bytes),
    continuing from `crc`, the CRC-32C of what came before (0 for none)."""
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    else:
        buf = np.frombuffer(memoryview(data).cast("B"), np.uint8)
    n = buf.size
    # Standard CRC = raw CRC with the register preset to crc ^ 0xFFFFFFFF,
    # xored with 0xFFFFFFFF; the preset travels over n bytes as a shift.
    return (_shift((crc ^ _U32) & _U32, n) ^ _raw(buf) ^ _U32) & _U32
