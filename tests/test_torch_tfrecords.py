"""The port's TF-free TFRecords (dan_tpu_torch/data/tfrecords.py) against the
JAX package's (dan_tpu/data/tfrecords.py), which writes and reads through
TensorFlow, on the committed mini-WIDER fixture.

The shards cannot be byte-identical: TF's writer (upb) serializes an
Example's feature map in an order hashed with a seed drawn per process, so
TF's own shards differ from run to run.  So each Example the port writes is
held byte for byte against TF's deterministic serialization of the same
Example (map keys in order), the framing against TF's reader, and each
package reads the other's shards to equal ImageRecords (boxes bit for bit)
and JPEG bytes.  A flipped byte or a truncated record raises."""
import os

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from dan_tpu.data import tfrecords as jax_tfr  # noqa: E402
from dan_tpu.data.widerface import load_split as jax_load_split  # noqa: E402
from dan_tpu_torch.data import tfrecords as tfr  # noqa: E402
from dan_tpu_torch.data.widerface import load_split  # noqa: E402

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "mini_wider")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("tfr")
    records = load_split(FIX, "val")
    port = tfr.convert_to_tfrecords(records, str(d / "port"), "train", num_shards=4)
    ref = jax_tfr.convert_to_tfrecords(jax_load_split(FIX, "val"), str(d / "ref"), "train",
                                       num_shards=4)
    return records, port, ref


def _same(got, want):
    assert len(got) == len(want)
    for (g, genc), (w, wenc) in zip(got, want):
        assert (g.path, g.rel_path, g.event) == (w.path, w.rel_path, w.event)
        assert g.boxes.dtype == w.boxes.dtype == np.float32
        assert g.boxes.shape == w.boxes.shape and np.array_equal(g.boxes, w.boxes)
        assert np.array_equal(g.attrs, w.attrs)
        assert genc == wenc


def test_shard_names_and_counts(shards):
    records, port, ref = shards
    assert [p.rsplit("/", 1)[1] for p in port] == [p.rsplit("/", 1)[1] for p in ref] == [
        f"train-{i:05d}-of-00004.tfrecord" for i in range(4)]
    assert len(records) == 20
    assert sum(1 for p in port for _ in tfr.iter_records(p)) == 20


def test_examples_are_tf_deterministic_serialization(shards):
    """Every record the port wrote == TF's Example parsed from it and
    serialized deterministically; the framing is what TF's reader reads."""
    _, port, _ = shards
    n = 0
    for path in port:
        ours = list(tfr.iter_records(path))
        theirs = [r.numpy() for r in tf.data.TFRecordDataset([path])]
        assert ours == theirs
        for data in ours:
            ex = tf.train.Example.FromString(data)
            assert ex.SerializeToString(deterministic=True) == data
            n += 1
    assert n == 20


def test_each_reader_reads_the_others_shards(shards):
    _, port, ref = shards
    for paths in (port, ref):
        _same(list(tfr.read_tfrecords(paths)), list(jax_tfr.read_tfrecords(paths)))
    _same(list(tfr.read_tfrecords(port)), list(tfr.read_tfrecords(ref)))


def test_boxes_round_trip_as_the_reference(shards):
    """Read-back boxes: float64 box / w stored as float32, times the int w
    in float32 -- the reference's arithmetic, not the source boxes."""
    records, port, _ = shards
    by_name = {r.rel_path: r for r in records}
    for rec, encoded in tfr.read_tfrecords(port):
        src = by_name[rec.rel_path]
        with open(src.path, "rb") as f:
            assert f.read() == encoded
        np.testing.assert_allclose(rec.boxes, src.boxes, rtol=1e-6, atol=1e-3)


def test_empty_boxes_and_unpacked_lists(tmp_path):
    """An image without boxes, and an Example with unpacked lists in
    another key order (what another writer may produce)."""
    ex = tf.train.Example(features=tf.train.Features(feature={
        "image/width": tf.train.Feature(int64_list=tf.train.Int64List(value=[7])),
        "image/height": tf.train.Feature(int64_list=tf.train.Int64List(value=[5])),
        "image/filename": tf.train.Feature(bytes_list=tf.train.BytesList(value=[b"e/x.jpg"])),
        "image/encoded": tf.train.Feature(bytes_list=tf.train.BytesList(value=[b"\xff\xd8"])),
    }))
    path = str(tmp_path / "a.tfrecord")
    with tf.io.TFRecordWriter(path) as w:
        w.write(ex.SerializeToString())
    (rec, enc), = tfr.read_tfrecords([path])
    assert rec.boxes.shape == (0, 4) and rec.rel_path == "e/x.jpg" and enc == b"\xff\xd8"
    unpacked = bytes.fromhex("0a05") + b"\x0d" + np.float32(0.25).tobytes()  # FloatList{1: 0.25}
    assert tfr._values(tfr._FLOATS, unpacked[2:]) == [0.25]
    assert tfr._values(tfr._INT64S, b"\x08\x03\x08\x04") == [3, 4]


def _damaged(path, at, out):
    data = bytearray(open(path, "rb").read())
    if at is None:
        data = data[:-7]
    else:
        data[at] ^= 0x01
    with open(out, "wb") as f:
        f.write(bytes(data))
    return out


@pytest.mark.parametrize("where,match", [(3, "length of record 0"), (40, "data of record 0"),
                                         (-2, "data of record"), (None, "truncated")])
def test_a_flipped_byte_or_truncation_raises(shards, tmp_path, where, match):
    _, port, _ = shards
    bad = _damaged(port[0], where, str(tmp_path / "bad.tfrecord"))
    with pytest.raises(tfr.TFRecordError, match=match):
        list(tfr.read_tfrecords([bad]))


def test_a_missing_feature_raises(tmp_path):
    path = str(tmp_path / "m.tfrecord")
    with open(path, "wb") as f:
        tfr.write_record(f, tfr.serialize_example({"image/height": (tfr._INT64S, [3])}))
    with pytest.raises(tfr.TFRecordError, match="image/width"):
        list(tfr.read_tfrecords([path]))


def test_roundtrip_with_tensorflow_and_protobuf_blocked(tmp_path):
    """The module writes and reads the fixture in an interpreter that
    refuses tensorflow, google.protobuf, JAX and the JAX package."""
    code = (
        "import importlib.abc, sys\n"
        "BLOCKED = ('tensorflow', 'google.protobuf', 'jax', 'jaxlib', 'dan_tpu')\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if any(name == b or name.startswith(b + '.') for b in BLOCKED):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from dan_tpu_torch.data import tfrecords as t\n"
        "from dan_tpu_torch.data.widerface import load_split\n"
        f"recs = load_split({FIX!r}, 'val')\n"
        f"paths = t.convert_to_tfrecords(recs, {str(tmp_path)!r}, 'val', 2)\n"
        "back = {r.rel_path: r for r, _ in t.read_tfrecords(paths)}\n"
        "assert len(back) == 20 and sum(len(r.boxes) for r in back.values()) == "
        "sum(len(r.boxes) for r in recs)\n"
        "print('tfrecords-ok')\n"
    )
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "tfrecords-ok" in proc.stdout
