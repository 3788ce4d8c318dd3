"""The port's TF1 importer (dan_tpu_torch/ckpt/tf_import.py) against the JAX
package's (dan_tpu/ckpt/tf_import.py), which reads through TensorFlow: the
same name map, the same leaves bit for bit on bundles of either exporter,
the same strict / non-strict reports and the same classifier-fc
subsampling.  At the tiny ModelConfig(image_size=64), whose widths are the
default config's (77 tensors, 95.9 MB)."""
import contextlib
import gc
import io

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402

from dan_tpu.ckpt import tf_import as jax_import  # noqa: E402
from dan_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from dan_tpu.models.detector import init_detector_params  # noqa: E402
from dan_tpu_torch.ckpt import tf_import as port_import  # noqa: E402
from dan_tpu_torch.ckpt.tf_bundle import BundleReader, write_bundle  # noqa: E402
from dan_tpu_torch.config import ModelConfig  # noqa: E402

torch.set_num_threads(1)

# The names tests/parity/test_tf_import.py maps.
PARITY_NAMES = (
    "vgg_16/conv1/conv1_1/weights", "vgg_16/conv3/conv3_3/biases", "vgg_16/fc6/weights",
    "conv6_2/weights", "conv4_3_norm/gamma", "conv4_3_norm_mbox_conf/weights",
    "fc7_mbox_loc/biases", "vgg_16/conv1/conv1_1/weights/Momentum", "global_step",
)
# Slots, bookkeeping and other names a TF1 checkpoint carries.
OTHER_NAMES = (
    "beta1_power", "beta2_power", "save_counter", "global_step:0",
    "vgg_16/conv2/conv2_1/weights/Adam", "vgg_16/conv2/conv2_1/weights/Adam_1",
    "vgg_16/conv5/conv5_3/biases/ExponentialMovingAverage", "vgg_16/fc8/weights",
    "vgg_16/conv3_3/weights", "vgg_16/fc7/biases", "conv7_1/biases",
    "conv3_3_l2_norm/scale", "conv5_3_norm_mbox_loc/weights", "conv7_2_mbox_conf/biases",
    "lfpn/td/conv5_3/weights", "lfpn/lat/conv3_3/biases", "ssd/lfpn_td/conv4_3/weights",
    "unrelated/variable", "conv3_3/weights/Momentum", "",
)


@pytest.fixture(scope="module")
def tree():
    params = init_detector_params(jax.random.PRNGKey(42), JaxModelConfig(image_size=64))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def bundles(tree, tmp_path_factory):
    """The same tree through the JAX exporter (a TF Saver) and the port's."""
    d = tmp_path_factory.mktemp("bundles")
    jax_import.export_tf_checkpoint(tree, str(d / "jax.ckpt"))
    port_import.export_tf_checkpoint(tree, str(d / "port.ckpt"))
    return {"jax": str(d / "jax.ckpt"), "port": str(d / "port.ckpt")}


def test_map_tf_name_equals_jax(bundles):
    exported = set()
    for prefix in bundles.values():
        exported |= set(tf.train.load_checkpoint(prefix).get_variable_to_shape_map())
    assert len(exported) == 77
    for name in sorted(exported) + list(PARITY_NAMES) + list(OTHER_NAMES):
        assert port_import.map_tf_name(name) == jax_import.map_tf_name(name), name
    assert port_import.NAME_RULES == jax_import.NAME_RULES
    assert port_import._SKIP_EXACT == jax_import._SKIP_EXACT


def test_both_exporters_write_the_same_bundle(bundles):
    """The port's writer is byte-identical to the JAX exporter's TF Saver."""
    for suffix in (".index", ".data-00000-of-00001"):
        with open(bundles["jax"] + suffix, "rb") as a, open(bundles["port"] + suffix, "rb") as b:
            assert a.read() == b.read(), suffix


@pytest.mark.parametrize("exporter", ["jax", "port"])
def test_load_equals_jax_leaf_for_leaf(bundles, tree, exporter):
    got = port_import.load_tf_checkpoint(bundles[exporter], ModelConfig(image_size=64),
                                         verbose=False)
    want = jax_import.load_tf_checkpoint(bundles[exporter], JaxModelConfig(image_size=64),
                                         verbose=False)
    assert sorted(got) == sorted(want)
    for g in want:
        assert sorted(got[g]) == sorted(want[g]), g
        for layer in want[g]:
            for leaf, w in want[g][layer].items():
                w = np.asarray(w)
                v = got[g][layer][leaf]
                assert v.dtype == w.dtype and v.shape == w.shape, (g, layer, leaf)
                assert np.array_equal(v, w), (g, layer, leaf)
                assert np.array_equal(v, tree[g][layer][leaf]), (g, layer, leaf)


def _printed(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            fn(*args, **kw)
            err = None
        except ValueError as e:
            err = str(e)
    return out.getvalue().splitlines(), err


def test_strict_and_non_strict_report_as_jax(tree, tmp_path):
    """A partial bundle: one head pair and one LFPN block left out, a
    mis-shaped conv1_1 kernel, an unmapped name, a slot and global_step.
    Both importers print the same report (every list under 20 names), and
    strict fails in both with the same message."""
    tensors = port_import.tf_names(tree)
    for name in ("conv3_3_mbox_conf/weights", "conv3_3_mbox_conf/biases",
                 "lfpn/td/conv4_3/weights", "lfpn/td/conv4_3/biases"):
        del tensors[name]
    tensors["vgg_16/conv1/conv1_1/weights"] = np.zeros((3, 3, 3, 8), np.float32)
    tensors["vgg_16/fc8/weights"] = np.zeros((4, 4), np.float32)
    tensors["vgg_16/conv2/conv2_1/weights/Momentum"] = np.zeros((2,), np.float32)
    tensors["global_step"] = np.int64(7)
    prefix = str(tmp_path / "partial.ckpt")
    write_bundle(prefix, tensors)
    for strict in (False, True):
        port_lines, port_err = _printed(port_import.load_tf_checkpoint, prefix,
                                        ModelConfig(image_size=64), strict=strict)
        jax_lines, jax_err = _printed(jax_import.load_tf_checkpoint, prefix,
                                      JaxModelConfig(image_size=64), strict=strict)
        assert port_lines[0] == jax_lines[0] == (
            "[tf_import] placed 72 params; 5 model params left at init; 1 ckpt vars unmapped; "
            "1 shape-mismatched")
        assert sorted(port_lines) == sorted(jax_lines)
        assert port_err == jax_err
        assert (port_err is None) == (not strict)
    rep = port_import.import_tf_checkpoint(prefix, ModelConfig(image_size=64))
    assert sorted(rep.missing) == sorted([
        "heads/cls_conv3_3/kernel", "heads/cls_conv3_3/bias", "lfpn/lfpn_td_conv4_3/kernel",
        "lfpn/lfpn_td_conv4_3/bias", "backbone/conv1_1/kernel"])
    assert rep.unmapped == ["vgg_16/fc8/weights"]
    assert rep.mismatched == [("vgg_16/conv1/conv1_1/weights", (3, 3, 3, 8), (3, 3, 3, 64))]


def test_a_full_bundle_passes_strict(bundles):
    lines, err = _printed(port_import.load_tf_checkpoint, bundles["port"],
                          ModelConfig(image_size=64), strict=True)
    assert err is None and lines == [
        "[tf_import] placed 77 params; 0 model params left at init; 0 ckpt vars unmapped; "
        "0 shape-mismatched"]


def test_adapt_vgg_fc_equals_jax():
    """The classifier's dense fc6 (25088, 4096) and fc7 (4096, 4096) and their
    biases, subsampled bit-identically; other shapes are not adapted."""
    rng = np.random.default_rng(0)
    fc6 = rng.standard_normal((25088, 4096), dtype=np.float32)
    cases = [(fc6, (3, 3, 512, 1024), "fc6"), (fc6.reshape(7, 7, 512, 4096), (3, 3, 512, 1024), "fc6")]
    for value, shape, layer in cases:
        got = port_import._adapt_vgg_fc(value, shape, layer)
        want = jax_import._adapt_vgg_fc(value, shape, layer)
        assert got.shape == want.shape == shape and np.array_equal(got, want)
    del fc6, cases, got, want, value
    gc.collect()
    fc7 = rng.standard_normal((4096, 4096), dtype=np.float32)
    bias = rng.standard_normal(4096, dtype=np.float32)
    for value, shape, layer in ((fc7, (1, 1, 1024, 1024), "fc7"), (bias, (1024,), "fc6"),
                                (bias, (1024,), "fc7")):
        got = port_import._adapt_vgg_fc(value, shape, layer)
        want = jax_import._adapt_vgg_fc(value, shape, layer)
        assert got.shape == want.shape == shape and np.array_equal(got, want)
    for value, shape, layer in ((np.zeros((3, 3, 8, 8)), (3, 3, 4, 4), "conv1_1"),
                                (bias, (512,), "fc6"), (fc7, (3, 3, 1024, 1024), "fc7")):
        assert port_import._adapt_vgg_fc(value, shape, layer) is None
        assert jax_import._adapt_vgg_fc(value, shape, layer) is None


def test_classifier_bundle_is_placed_and_subsampled_as_jax(tree, tmp_path):
    """A small VGG-16 classifier-shaped bundle: the 13 convs, fc6 and fc7
    dense, both importers place the same 30 leaves with the same values."""
    rng = np.random.default_rng(1)
    tensors = {}
    for layer, leaves in tree["backbone"].items():
        if layer.startswith(("conv6", "conv7", "fc")):
            continue
        for leaf, arr in leaves.items():
            kind = "weights" if leaf == "kernel" else "biases"
            tensors[f"vgg_16/conv{layer[4]}/{layer}/{kind}"] = rng.standard_normal(
                arr.shape, dtype=np.float32)
    tensors["vgg_16/fc6/weights"] = rng.standard_normal((25088, 4096), dtype=np.float32)
    tensors["vgg_16/fc6/biases"] = rng.standard_normal(4096, dtype=np.float32)
    tensors["vgg_16/fc7/weights"] = rng.standard_normal((4096, 4096), dtype=np.float32)
    tensors["vgg_16/fc7/biases"] = rng.standard_normal(4096, dtype=np.float32)
    prefix = str(tmp_path / "vgg_16.ckpt")
    write_bundle(prefix, tensors)
    del tensors
    gc.collect()
    rep = port_import.import_tf_checkpoint(prefix, ModelConfig(image_size=64))
    assert len(rep.placed) == 30 and all(s == "backbone" for s, _, _ in rep.placed)
    assert len(rep.missing) == 47 and not rep.unmapped and not rep.mismatched
    want = jax_import.load_tf_checkpoint(prefix, JaxModelConfig(image_size=64), verbose=False)
    for _, layer, leaf in rep.placed:
        assert np.array_equal(rep.params["backbone"][layer][leaf],
                              np.asarray(want["backbone"][layer][leaf])), (layer, leaf)
    reader = BundleReader(prefix)
    fc6 = reader.get_tensor("vgg_16/fc6/weights").reshape(7, 7, 512, 4096)
    np.testing.assert_array_equal(rep.params["backbone"]["fc6"]["kernel"][1, 2],
                                  fc6[3, 6, :, ::4])
