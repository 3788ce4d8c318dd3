"""The parameter bridge between the JAX package and the PyTorch port:
a bit-exact round trip, and the packed conv1 kernels built by the port
equal to the JAX package's."""
import numpy as np
import pytest
import torch

import jax

from dan_tpu.config import ModelConfig
from dan_tpu.models import vgg as jvgg
from dan_tpu.models.detector import init_detector_params
from dan_tpu_torch.ckpt.bridge import params_from_jax, params_to_jax
from dan_tpu_torch.models import vgg as tvgg
from dan_tpu_torch.models.detector import DANDetector

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_tree():
    params = init_detector_params(jax.random.PRNGKey(0), ModelConfig())
    return jax.tree_util.tree_map(np.asarray, params)


def _leaves(tree):
    return {
        "/".join(str(k.key) for k in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def test_round_trip_bit_exact(jax_tree):
    state = params_from_jax(jax_tree)
    model = DANDetector(ModelConfig())
    model.load_state_dict(state)  # strict: every name maps both ways
    back = _leaves(params_to_jax(model.state_dict()))
    want = _leaves(jax_tree)
    assert back.keys() == want.keys()
    for k, v in want.items():
        assert back[k].dtype == np.float32 and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_kernel_layout_is_oihw(jax_tree):
    state = params_from_jax(jax_tree)
    k = jax_tree["backbone"]["conv2_1"]["kernel"]  # (3, 3, 64, 128) HWIO
    w = state["backbone.conv2_1.weight"].numpy()
    assert w.shape == (128, 64, 3, 3)
    np.testing.assert_array_equal(w[5, 7, 2, 1], k[2, 1, 7, 5])


@pytest.mark.parametrize(
    "name,pack_t,pack_j",
    [
        ("conv1_1", tvgg.pack_conv_kernel_stride2, jvgg._pack_conv_kernel_stride2),
        ("conv1_2", tvgg.pack_conv_kernel_2x2_phase, jvgg._pack_conv_kernel_2x2_phase),
    ],
    ids=["stride2_4x4", "phase_2x2"],
)
def test_packed_conv1_kernels_equal_jax(jax_tree, name, pack_t, pack_j):
    k = jax_tree["backbone"][name]["kernel"]
    want = np.asarray(pack_j(jax.numpy.asarray(k)))
    got = pack_t(torch.from_numpy(k.transpose(3, 2, 0, 1).copy())).numpy()
    np.testing.assert_array_equal(got.transpose(2, 3, 1, 0), want)


def test_load_repacks_conv1(jax_tree):
    """After loading weights, the packed conv1 kernels the forward uses
    (gathered from the live parameters) are the JAX package's."""
    model = DANDetector(ModelConfig())
    model.load_state_dict(params_from_jax(jax_tree))
    k1p, b1p, k2p = (t.detach() for t in model.backbone.packed_kernels())
    k1 = jax_tree["backbone"]["conv1_1"]["kernel"]
    want = np.asarray(jvgg._pack_conv_kernel_stride2(jax.numpy.asarray(k1)))
    np.testing.assert_array_equal(k1p.numpy().transpose(2, 3, 1, 0), want)
    np.testing.assert_array_equal(
        b1p.numpy(), np.tile(jax_tree["backbone"]["conv1_1"]["bias"], 4)
    )
    k2 = jax_tree["backbone"]["conv1_2"]["kernel"]
    want2 = np.asarray(jvgg._pack_conv_kernel_2x2_phase(jax.numpy.asarray(k2)))
    np.testing.assert_array_equal(k2p.numpy().transpose(2, 3, 1, 0), want2)
