"""The JAX package's parameter init in numpy (dan_tpu_torch/models/
reference_init.py, ops/threefry.py's array draws) against JAX itself:
`random_bits` bit for bit, `uniform` bit for bit and `normal` within 3 ulp
on array shapes; every leaf of `init_reference_params(0, config)` against
`init_detector_params(PRNGKey(0), config)` at the default widths (the
uniform bits under every kernel exactly, kernels within 4 ulp, biases and
scales exactly); and a partial TF bundle's uncovered leaves against the
JAX importer's.

The bounds: XLA's float32 log1p on the CPU rounds differently from numpy's
in the last bit, which erf_inv's polynomial carries into 1-3 ulp of about
1.3 % of the normals (3 at most over 27M draws); the kernel's multiply by
its std rounds once more (4 at most)."""
import numpy as np
import pytest
import torch

import jax

from dan_tpu.ckpt import tf_import as jax_import
from dan_tpu.config import ModelConfig as JaxModelConfig
from dan_tpu.models.detector import init_detector_params
from dan_tpu_torch.ckpt import tf_import as port_import
from dan_tpu_torch.ckpt.tf_bundle import write_bundle
from dan_tpu_torch.config import ModelConfig
from dan_tpu_torch.models.reference_init import init_reference_params, reference_specs
from dan_tpu_torch.ops import threefry

torch.set_num_threads(1)

NORMAL_ULPS = 3
KERNEL_ULPS = 4


def ulps(a, b) -> np.ndarray:
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed,shape", [(0, (7,)), (3, (2, 3)), (42, (3, 3, 64, 128)),
                                        (2**32 - 1, (1, 1, 1024, 256))])
def test_array_bits_and_uniform_equal_jax(seed, shape):
    key, jkey = threefry.prng_key(seed), jax.random.PRNGKey(seed)
    assert np.array_equal(threefry.random_bits(key, shape),
                          np.asarray(jax.random.bits(jkey, shape)))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    got = threefry.uniform(key, lo, 1.0, shape)
    want = np.asarray(jax.random.uniform(jkey, shape, minval=lo, maxval=1.0))
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_normal_within_its_ulp_bound():
    worst, exact, n = 0, 0, 0
    for seed in range(4):
        got = threefry.normal(threefry.prng_key(seed), (256, 1024))
        d = ulps(got, np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (256, 1024))))
        worst, exact, n = max(worst, int(d.max())), exact + int((d == 0).sum()), n + d.size
    assert worst <= NORMAL_ULPS and exact / n > 0.98, (worst, exact / n)
    assert threefry.normal(threefry.prng_key(5)).shape == ()


def test_erf_inv_edges():
    x = np.array([-1, 1, 0, -0.0], np.float32)
    got = threefry.erf_inv(x)
    want = np.asarray(jax.lax.erf_inv(x))
    assert np.array_equal(got, want) and np.isinf(got[:2]).all()


def test_array_draws_take_a_scalar_key():
    keys = threefry.prng_key(np.array([1, 2]))
    with pytest.raises(ValueError, match="scalar key"):
        threefry.random_bits(keys, (3,))


@pytest.fixture(scope="module")
def jax_init():
    return jax.tree_util.tree_map(
        np.asarray, init_detector_params(jax.random.PRNGKey(0), JaxModelConfig(image_size=64)))


def test_every_leaf_equals_the_jax_init(jax_init):
    """init_reference_params(0, config) leaf by leaf against JAX; its specs'
    keys and the uniform bits under every kernel exactly."""
    config = ModelConfig(image_size=64)
    specs = reference_specs(0, config)
    params = init_reference_params(0, config)
    assert {s: {l: sorted(v) for l, v in layers.items()} for s, layers in params.items()} == \
        {s: {l: sorted(v) for l, v in layers.items()} for s, layers in jax_init.items()}
    # The keys: each section's split by JAX, one key a conv in construction order.
    sections = dict(zip(("backbone", "lfpn", "heads"),
                        jax.random.split(jax.random.PRNGKey(0), 3)))
    n_kernels = 0
    for section, layers in specs.items():
        convs = [layer for layer, leaves in layers.items() if "kernel" in leaves]
        jkeys = (np.asarray(jax.random.split(sections[section], len(convs)))
                 if section in sections else [])
        for j, layer in enumerate(convs):
            spec = layers[layer]["kernel"]
            assert (int(spec.key[0]), int(spec.key[1])) == tuple(int(w) for w in jkeys[j])
            # The uniform bits under the kernel, exactly.
            assert np.array_equal(threefry.random_bits(spec.key, spec.shape),
                                  np.asarray(jax.random.bits(jkeys[j], spec.shape)))
            n_kernels += 1
        for layer, leaves in layers.items():
            for leaf in leaves:
                d = ulps(params[section][layer][leaf], jax_init[section][layer][leaf])
                assert d.max() <= (KERNEL_ULPS if leaf == "kernel" else 0), \
                    (section, layer, leaf, int(d.max()))
    assert n_kernels == 19 + 6 + 12  # backbone, LFPN, heads
    assert np.all(params["l2norm"]["conv4_3"]["scale"] == 8.0)
    spec = specs["heads"]["loc_fc7"]["kernel"]
    assert np.array_equal(spec.value(), params["heads"]["loc_fc7"]["kernel"])


def test_partial_bundle_fills_uncovered_leaves_as_jax(jax_init, tmp_path):
    """A bundle without one head pair, one LFPN block and the conv3_3 scale:
    the port's importer fills them as the JAX importer does (PRNGKey(0))."""
    tensors = port_import.tf_names(jax.tree_util.tree_map(
        lambda a: a + np.float32(1), jax_init))
    left_out = ("conv3_3_mbox_conf/weights", "conv3_3_mbox_conf/biases",
                "lfpn/td/conv4_3/weights", "lfpn/td/conv4_3/biases", "conv3_3_norm/gamma")
    for name in left_out:
        del tensors[name]
    prefix = str(tmp_path / "partial.ckpt")
    write_bundle(prefix, tensors)
    got = port_import.import_tf_checkpoint(prefix, ModelConfig(image_size=64))
    want = jax_import.load_tf_checkpoint(prefix, JaxModelConfig(image_size=64), verbose=False)
    assert sorted(got.missing) == sorted([
        "heads/cls_conv3_3/kernel", "heads/cls_conv3_3/bias", "lfpn/lfpn_td_conv4_3/kernel",
        "lfpn/lfpn_td_conv4_3/bias", "l2norm/conv3_3/scale"])
    for name in got.missing:
        section, layer, leaf = name.split("/")
        g, w = got.params[section][layer][leaf], np.asarray(want[section][layer][leaf])
        assert ulps(g, w).max() <= (KERNEL_ULPS if leaf == "kernel" else 0), name
        assert ulps(g, jax_init[section][layer][leaf]).max() <= \
            (KERNEL_ULPS if leaf == "kernel" else 0), name
    # Placed leaves are the bundle's, bit for bit.
    assert np.array_equal(got.params["heads"]["loc_conv3_3"]["kernel"],
                          jax_init["heads"]["loc_conv3_3"]["kernel"] + np.float32(1))
