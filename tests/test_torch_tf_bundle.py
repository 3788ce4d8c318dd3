"""The port's TF V2 bundle reader and writer (dan_tpu_torch/ckpt/tf_bundle.py)
and its CRC-32C (utils/crc32c.py) against TensorFlow: bundles TF writes
(tf.raw_ops.SaveV2, the op under tf.train.Saver, and a Saver itself) read
bit-identically to tf.train.load_checkpoint, bundles the port writes read
bit-identically through TF, and damaged or unsupported bundles raise.
google_crc32c (a TF dependency) is the CRC oracle here only."""
import os
import struct

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
google_crc32c = pytest.importorskip("google_crc32c")

from dan_tpu_torch.utils import crc32c as port_crc  # noqa: E402
from dan_tpu_torch.ckpt import tf_bundle  # noqa: E402
from dan_tpu_torch.ckpt.tf_bundle import BundleError, BundleReader, write_bundle  # noqa: E402

torch.set_num_threads(1)

# dtype name -> a seeded value of that dtype (bf16 is made by TF's cast).
_RNG = np.random.default_rng(0)
VALUES = {
    "a/f32": _RNG.standard_normal((3, 5)).astype(np.float32),
    "a/f16": _RNG.standard_normal((4, 2, 3)).astype(np.float16),
    "a/f64": _RNG.standard_normal((7,)),
    "b/i32": _RNG.integers(-2**31, 2**31, (2, 9), dtype=np.int32),
    "b/i64": _RNG.integers(-2**62, 2**62, (5,), dtype=np.int64),
    "b/i16": _RNG.integers(-2**15, 2**15, (6,), dtype=np.int16),
    "b/i8": _RNG.integers(-128, 128, (11,), dtype=np.int8),
    "b/u8": _RNG.integers(0, 256, (3, 3), dtype=np.uint8),
    "c/bool": _RNG.integers(0, 2, (10,)).astype(bool),
    "d/scalar": np.float32(2.5),
    "d/empty": np.zeros((0, 4), np.float32),
    "global_step": np.int64(120000),
}
BF16_SOURCE = _RNG.standard_normal((4, 6)).astype(np.float32)


def _save_v2(prefix, tensors):
    names = sorted(tensors)
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names, shape_and_slices=[""] * len(names),
                      tensors=[tensors[n] for n in names])


def _tf_values():
    out = {k: tf.constant(v) for k, v in VALUES.items()}
    out["a/bf16"] = tf.cast(tf.constant(BF16_SOURCE), tf.bfloat16)
    return out


def _bits(a):
    """A value's bytes, comparable across numpy and ml_dtypes' bfloat16."""
    a = np.asarray(a)
    return a.dtype.name, a.shape, np.ascontiguousarray(a).tobytes()


def _assert_reads_like_tf(prefix):
    ours, theirs = BundleReader(prefix), tf.train.load_checkpoint(prefix)
    assert ours.get_variable_to_shape_map() == theirs.get_variable_to_shape_map()
    assert ours.get_variable_to_dtype_map() == {
        k: v.name for k, v in theirs.get_variable_to_dtype_map().items()}
    for name, dtype in theirs.get_variable_to_dtype_map().items():
        want, got = theirs.get_tensor(name), ours.get_tensor(name)
        if dtype.name == "bfloat16":  # read as its exact float32
            assert got.dtype == np.float32
            assert np.array_equal(got.view(np.uint32) >> 16, want.view(np.uint16))
            assert not (got.view(np.uint32) & 0xFFFF).any()
        else:
            assert _bits(got) == _bits(want), name
    return ours


@pytest.mark.parametrize("n", [0, 1, 7, 4095, 4096, 4097, 3 << 20])
def test_crc32c_equals_google_crc32c(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    want = google_crc32c.value(data.tobytes())
    assert port_crc.crc32c(data) == want
    assert port_crc.crc32c(data.tobytes()) == want
    cut = n // 3
    a, b = data[:cut].tobytes(), data[cut:].tobytes()
    assert port_crc.crc32c(b, port_crc.crc32c(a)) == want
    assert port_crc.crc32c_combine(port_crc.crc32c(a), port_crc.crc32c(b), len(b)) == want


def test_crc32c_check_value_and_mask_round_trip():
    assert port_crc.crc32c(b"123456789") == 0xE3069283
    for c in (0, 1, 0xE3069283, 0xFFFFFFFF, 0x80000000):
        assert port_crc.unmask(port_crc.mask(c)) == c


def test_mask_equals_the_one_tf_stores(tmp_path):
    """Each tensor's entry holds TF's masked CRC of its bytes, and each block
    trailer the masked CRC of the block and its type byte: both equal the
    port's mask of google_crc32c's CRC."""
    prefix = str(tmp_path / "m")
    _save_v2(prefix, _tf_values())
    data = open(prefix + ".data-00000-of-00001", "rb").read()
    index = open(prefix + ".index", "rb").read()
    reader = BundleReader(prefix)
    for name, e in reader._entries.items():
        raw = data[e.offset:e.offset + e.size]
        assert e.crc32c == port_crc.mask(google_crc32c.value(raw)), name
    off, size, pos = tf_bundle._handle(index[-48:])
    off, size, _ = tf_bundle._handle(index[-48:], pos)
    stored = struct.unpack_from("<I", index, off + size + 1)[0]
    assert stored == port_crc.mask(google_crc32c.value(index[off:off + size + 1]))


def test_reader_equals_tf_on_every_dtype(tmp_path):
    """f32, f16, bf16, f64, int8/16/32/64, uint8, bool, a scalar, a zero-size
    tensor and an int64 global_step, written by TF's SaveV2."""
    prefix = str(tmp_path / "m")
    _save_v2(prefix, _tf_values())
    ours = _assert_reads_like_tf(prefix)
    assert ours.get_variable_to_dtype_map()["a/bf16"] == "bfloat16"
    assert ours.get_variable_to_shape_map()["d/scalar"] == []
    assert ours.get_variable_to_shape_map()["d/empty"] == [0, 4]
    assert ours.get_tensor("global_step").dtype == np.int64


def test_reader_equals_tf_on_a_saver_checkpoint(tmp_path):
    """A tf.compat.v1.train.Saver checkpoint: slim-style variables and the
    int64 global_step the Saver writes beside them."""
    prefix = str(tmp_path / "model.ckpt")
    with tf.compat.v1.Graph().as_default():
        for name in ("vgg_16/conv1/conv1_1/weights", "vgg_16/conv1/conv1_1/biases"):
            tf.compat.v1.get_variable(name, initializer=tf.constant(
                _RNG.standard_normal((3, 3, 3, 4) if name.endswith("weights") else (4,))
                .astype(np.float32)))
        tf.compat.v1.get_variable("half", initializer=tf.constant(np.float16(1.5)))
        step = tf.compat.v1.train.get_or_create_global_step()
        saver = tf.compat.v1.train.Saver()
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            sess.run(step.assign(123456))
            saver.save(sess, prefix, write_meta_graph=False)
    ours = _assert_reads_like_tf(prefix)
    assert ours.get_variable_to_dtype_map()["global_step"] == "int64"
    assert int(ours.get_tensor("global_step")) == 123456


def _index_blocks(prefix):
    index = open(prefix + ".index", "rb").read()
    off, size, pos = tf_bundle._handle(index[-48:])
    off, size, _ = tf_bundle._handle(index[-48:], pos)
    block = tf_bundle._read_block(index, off, size, "the index block")
    return list(tf_bundle._block_entries(block, "the index block"))


def test_reader_equals_tf_on_a_multi_block_index(tmp_path):
    """2,500 variables with long names fill more than one 256 KiB data block,
    so the reader must walk the index block."""
    prefix = str(tmp_path / "m")
    names = [f"{i:05d}/" + "scope_name/" * 9 + "weights" for i in range(2500)]
    _save_v2(prefix, {n: tf.constant(np.full((2,), i, np.float32)) for i, n in enumerate(names)})
    assert len(_index_blocks(prefix)) > 1
    ours = _assert_reads_like_tf(prefix)
    assert len(ours.get_variable_to_shape_map()) == 2500


@pytest.mark.parametrize("shards,block_size", [(1, tf_bundle.BLOCK_SIZE), (1, 64), (2, 64)])
def test_port_writer_is_read_by_tf(tmp_path, shards, block_size):
    prefix = str(tmp_path / "m")
    tensors = dict(VALUES)
    tensors["a/bf16"] = torch.from_numpy(BF16_SOURCE).to(torch.bfloat16)
    tensors.update({f"many/{i:03d}": np.full((i % 5,), i, np.int32) for i in range(100)})
    write_bundle(prefix, tensors, num_shards=shards, block_size=block_size)
    if block_size == 64:
        assert len(_index_blocks(prefix)) > 10
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["m.index"] + [f"m.data-{s:05d}-of-{shards:05d}" for s in range(shards)])
    theirs = tf.train.load_checkpoint(prefix)
    assert sorted(theirs.get_variable_to_shape_map()) == sorted(tensors)
    for name, value in tensors.items():
        got = theirs.get_tensor(name)
        if name == "a/bf16":
            assert np.array_equal(got.view(np.uint16),
                                  value.view(torch.int16).numpy().view(np.uint16))
        else:
            assert _bits(got) == _bits(value), name
    _assert_reads_like_tf(prefix)


def test_port_writer_matches_tf_byte_for_byte(tmp_path):
    """The same tensors in the same order: the port's index and data files
    equal those of TF's SaveV2."""
    _save_v2(str(tmp_path / "tf"), {k: tf.constant(v) for k, v in VALUES.items()})
    write_bundle(str(tmp_path / "port"), VALUES)
    for suffix in (".index", ".data-00000-of-00001"):
        assert open(tmp_path / ("tf" + suffix), "rb").read() == \
            open(tmp_path / ("port" + suffix), "rb").read(), suffix


def _flip(path, pos):
    data = bytearray(open(path, "rb").read())
    data[pos] ^= 0x01
    open(path, "wb").write(bytes(data))


def test_a_flipped_byte_raises_a_crc_error(tmp_path):
    prefix = str(tmp_path / "m")
    _save_v2(prefix, _tf_values())
    _flip(prefix + ".index", 10)  # inside the data block
    with pytest.raises(BundleError, match="CRC-32C mismatch in data block 0"):
        BundleReader(prefix)
    _save_v2(prefix, _tf_values())
    reader = BundleReader(prefix)
    e = reader._entries["a/f32"]
    _flip(prefix + ".data-00000-of-00001", e.offset + 5)
    with pytest.raises(BundleError, match="CRC-32C mismatch in the data of a/f32"):
        reader.get_tensor("a/f32")
    reader.get_tensor("a/f16")  # the others still read


def test_string_variable_is_listed_and_refused(tmp_path):
    prefix = str(tmp_path / "m")
    _save_v2(prefix, {"s": tf.constant([b"ab", b"c"]), "x": tf.constant(np.ones(2, np.float32))})
    reader = BundleReader(prefix)
    assert reader.get_variable_to_shape_map() == {"s": [2], "x": [2]}
    assert reader.get_variable_to_dtype_map()["s"] == "string"
    with pytest.raises(BundleError, match="string"):
        reader.get_tensor("s")
    assert np.array_equal(reader.get_tensor("x"), np.ones(2, np.float32))


def test_partitioned_variable_is_refused(tmp_path):
    prefix = str(tmp_path / "m")
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=["p"], shape_and_slices=["4 0,2"],
                      tensors=[tf.constant(np.ones(2, np.float32))])
    reader = BundleReader(prefix)
    with pytest.raises(BundleError, match="partitioned"):
        reader.get_tensor("p")


def _rewrite_index(prefix, edit):
    """Rewrite prefix.index with edit(key, value) applied to every entry."""
    index = open(prefix + ".index", "rb").read()
    items = []
    for _, handle in _index_blocks(prefix):
        off, size, _ = tf_bundle._handle(handle)
        block = tf_bundle._read_block(index, off, size, "block")
        items += [(k, edit(k, v)) for k, v in tf_bundle._block_entries(block, "block")]
    with open(prefix + ".index", "wb") as f:
        tf_bundle._write_table(f, items, tf_bundle.BLOCK_SIZE)


def test_big_endian_header_and_compressed_block_are_refused(tmp_path):
    prefix = str(tmp_path / "m")
    write_bundle(prefix, {"x": np.ones(3, np.float32)})

    def big_endian(key, value):
        if key:
            return value
        out = bytearray(value)
        tf_bundle._put_field(out, 2, 1)  # endianness: BIG
        return bytes(out)

    _rewrite_index(prefix, lambda k, v: v)
    assert np.array_equal(BundleReader(prefix).get_tensor("x"), np.ones(3, np.float32))
    _rewrite_index(prefix, big_endian)
    with pytest.raises(BundleError, match="big-endian"):
        BundleReader(prefix)
    # A data block whose trailer says snappy (type 1), with a valid CRC.
    write_bundle(prefix, {"x": np.ones(3, np.float32)})
    data = bytearray(open(prefix + ".index", "rb").read())
    (_, handle), = _index_blocks(prefix)
    off, size, _ = tf_bundle._handle(handle)
    data[off + size] = 1
    data[off + size + 1:off + size + 5] = struct.pack(
        "<I", port_crc.mask(port_crc.crc32c(bytes(data[off:off + size + 1]))))
    open(prefix + ".index", "wb").write(bytes(data))
    with pytest.raises(BundleError, match="compression type 1"):
        BundleReader(prefix)


def test_a_truncated_entry_value_raises_a_bundle_error(tmp_path):
    prefix = str(tmp_path / "m")
    write_bundle(prefix, {"x": np.ones(3, np.float32)})
    # The entry's last field is its fixed32 CRC: one byte short is a
    # truncated protobuf message, in a block whose own CRC is valid.
    _rewrite_index(prefix, lambda k, v: v[:-1] if k == b"x" else v)
    with pytest.raises(BundleError, match="truncated protobuf message"):
        BundleReader(prefix)


def test_not_a_bundle_raises(tmp_path):
    prefix = str(tmp_path / "m")
    open(prefix + ".index", "wb").write(b"\0" * 64)
    with pytest.raises(BundleError, match="magic"):
        BundleReader(prefix)
