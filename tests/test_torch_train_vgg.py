"""The train half of the port's packed conv1 block against the JAX
package: the packed kernels follow the live conv1 parameters, gradients
reach conv1_1/conv1_2 as jax.grad's do, the phase-pool backward routes
bit for bit as the XLA assembly and the Pallas kernel (interpret mode),
and the conv1_2' weight gradient matches the Pallas kernel and the vjp
oracle.

Float32 on the CPU with oneDNN off (see test_torch_model.py).  Gradient
tolerances are rtol 1e-4, atol 1e-5 (f32 accumulation order of the convs);
the wgrad tolerance rtol 1e-5, atol 1e-4 is the JAX kernel test's own.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dan_tpu.config import ModelConfig
from dan_tpu.models import vgg as jvgg
from dan_tpu.ops.conv12_wgrad_pallas import conv12_wgrad_pallas
from dan_tpu.ops.phase_pool_pallas import phase_pool_bwd_pallas
from dan_tpu_torch.models.vgg import VGG, PhasePool, phase_pool_with_winner
from dan_tpu_torch.ops import conv12_wgrad_cuda, phase_pool_cuda
from dan_tpu_torch.ops.conv12_wgrad_cuda import conv12_wgrad, conv12_wgrad_plain
from dan_tpu_torch.ops.phase_pool_cuda import phase_pool_bwd, phase_pool_bwd_plain

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _plain_cpu_conv():
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


def conv1_params(rng):
    """JAX-layout conv1 parameters at the model's widths (3 -> 64 -> 64)."""
    return {
        "conv1_1": {"kernel": (rng.normal(size=(3, 3, 3, 64)) * 0.1).astype(np.float32),
                    "bias": (rng.normal(size=(64,)) * 0.1).astype(np.float32)},
        "conv1_2": {"kernel": (rng.normal(size=(3, 3, 64, 64)) * 0.1).astype(np.float32),
                    "bias": (rng.normal(size=(64,)) * 0.1).astype(np.float32)},
    }


def port_vgg(params) -> VGG:
    model = VGG(ModelConfig(image_size=64, compute_dtype="float32"),
                torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name in ("conv1_1", "conv1_2"):
            conv = getattr(model, name)
            conv.weight.copy_(torch.from_numpy(params[name]["kernel"].transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.from_numpy(params[name]["bias"]))
    return model


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


# -- the two repairs ---------------------------------------------------------


def test_packed_kernels_follow_in_place_weight_updates():
    """An in-place change of conv1_1/conv1_2 (what an optimizer step does)
    reaches the packed forward: it equals a model built with the new
    weights."""
    rng = np.random.default_rng(0)
    model = port_vgg(conv1_params(rng))
    x = nchw(rng.normal(size=(2, 8, 8, 3)).astype(np.float32))
    with torch.inference_mode():
        before = model.conv1_block_packed(x)
    new = conv1_params(np.random.default_rng(1))
    with torch.no_grad():
        model.conv1_1.weight.copy_(torch.from_numpy(new["conv1_1"]["kernel"].transpose(3, 2, 0, 1)))
        model.conv1_2.weight.sub_(0.05)
        model.conv1_2.bias.add_(0.01)
    fresh = port_vgg(new)
    with torch.no_grad():
        fresh.conv1_2.weight.copy_(model.conv1_2.weight)
        fresh.conv1_2.bias.copy_(model.conv1_2.bias)
        fresh.conv1_1.bias.copy_(model.conv1_1.bias)
    with torch.inference_mode():
        after = model.conv1_block_packed(x)
        np.testing.assert_array_equal(after.numpy(), fresh.conv1_block_packed(x).numpy())
    assert not torch.equal(before, after)


def test_conv1_grads_match_jax_grad():
    """Gradients of conv1_1/conv1_2 through the port's packed block (its
    autograd Functions and the packing's backward) against jax.grad through
    dan_tpu.models.vgg.conv1_block_packed with the XLA backwards."""
    rng = np.random.default_rng(0)
    params = conv1_params(rng)
    x = rng.normal(size=(8, 8, 8, 3)).astype(np.float32)

    def loss(p):
        out = jvgg.conv1_block_packed(p, jnp.asarray(x), False, False)
        return jnp.sum(out * out)

    want = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, params))
    model = port_vgg(params)
    out = model.conv1_block_packed(nchw(x))
    (out * out).sum().backward()
    for name in ("conv1_1", "conv1_2"):
        conv = getattr(model, name)
        assert conv.weight.grad is not None and conv.weight.grad.abs().max() > 0
        np.testing.assert_allclose(conv.weight.grad.numpy().transpose(2, 3, 1, 0),
                                   np.asarray(want[name]["kernel"]), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(conv.bias.grad.numpy(), np.asarray(want[name]["bias"]),
                                   rtol=1e-4, atol=1e-5)


def test_grads_equal_the_standard_conv1_path():
    """The packed block's gradients equal those of the plain conv1_1 ->
    conv1_2 -> pool1 path of the same weights (the packing is exact)."""
    rng = np.random.default_rng(2)
    model = port_vgg(conv1_params(rng))
    x = nchw(rng.normal(size=(4, 8, 6, 3)).astype(np.float32))
    (model.conv1_block_packed(x) ** 2).sum().backward()
    packed = [p.grad.clone() for p in model.parameters() if p.grad is not None]
    model.zero_grad()
    from dan_tpu_torch.models.layers import max_pool

    (max_pool(model.conv1_2(model.conv1_1(x))) ** 2).sum().backward()
    plain = [p.grad for p in model.parameters() if p.grad is not None]
    assert len(packed) == len(plain) == 4
    for a, b in zip(packed, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_inference_keeps_the_plain_block():
    """Without grad the block never builds the autograd Functions' graph,
    and its output equals the training forward's."""
    rng = np.random.default_rng(3)
    model = port_vgg(conv1_params(rng))
    x = nchw(rng.normal(size=(2, 8, 8, 3)).astype(np.float32))
    train = model.conv1_block_packed(x)
    assert train.grad_fn is not None and "PhasePool" in type(train.grad_fn).__name__
    with torch.inference_mode():
        infer = model.conv1_block_packed(x)
    np.testing.assert_array_equal(train.detach().numpy(), infer.numpy())


# -- phase-pool backward ------------------------------------------------------


def _tie_heavy_r(rng, b, h, w, c):
    """A packed conv output with values in {-2..2}: exact phase ties and
    relu clamps everywhere."""
    return rng.integers(-2, 3, (b, h + 1, w + 1, 4 * c)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c", [(2, 6, 6, 8), (1, 5, 7, 16), (3, 8, 4, 8)])
def test_phase_pool_backward_bit_identical(dtype, b, h, w, c):
    """The winner from the forward and the routed cotangent, bit for bit
    against the JAX package's forward residual, its XLA assembly and the
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(b * 100 + h)
    r = _tie_heavy_r(rng, b, h, w, c)
    b2 = rng.integers(-1, 2, (c,)).astype(np.float32)
    g = rng.normal(size=(b, h, w, c)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    j_out, (j_win, _) = jvgg._phase_pool_fwd(jnp.asarray(r, jdt), jnp.asarray(b2, jdt))
    t_out, t_win = phase_pool_with_winner(nchw(r).to(tdt), torch.from_numpy(b2).to(tdt))
    np.testing.assert_array_equal(t_win.numpy(), np.asarray(j_win))
    np.testing.assert_array_equal(t_out.float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(j_out.astype(jnp.float32)))
    assert (t_win.numpy() == 255).any() and (t_win.numpy() < 4).any()
    gj = jnp.asarray(g, jdt)
    gt = torch.from_numpy(g).to(tdt)
    got = phase_pool_bwd(gt, t_win)
    assert got.shape == (b, h + 1, w + 1, 4 * c) and got.dtype == tdt
    got32 = got.float().numpy()
    np.testing.assert_array_equal(got32, np.asarray(jvgg._phase_pool_bwd_xla(j_win, gj).astype(jnp.float32)))
    np.testing.assert_array_equal(
        got32, np.asarray(phase_pool_bwd_pallas(gj, j_win, interpret=True).astype(jnp.float32))
    )


def test_phase_pool_function_grads_match_jax_vjp():
    """PhasePool's (gr, gb2) against jax.vjp of the JAX package's
    _phase_pool, on tie-heavy input."""
    rng = np.random.default_rng(4)
    r = _tie_heavy_r(rng, 2, 6, 6, 8)
    b2 = rng.integers(-1, 2, (8,)).astype(np.float32)
    g = rng.normal(size=(2, 6, 6, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, bb: jvgg._phase_pool(a, bb, False), jnp.asarray(r), jnp.asarray(b2))
    jr, jb = vjp(jnp.asarray(g))
    rt = nchw(r).requires_grad_()
    bt = torch.from_numpy(b2).requires_grad_()
    PhasePool.apply(rt, bt).backward(nchw(g))
    np.testing.assert_array_equal(rt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jr))
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)


def test_phase_pool_cpu_never_launches_and_checks_inputs():
    before = phase_pool_cuda.LAUNCHES
    g = torch.zeros((1, 2, 2, 8))
    phase_pool_bwd(g, torch.zeros((1, 2, 2, 8), dtype=torch.uint8))
    assert phase_pool_cuda.LAUNCHES == before
    with pytest.raises(TypeError):
        phase_pool_bwd(g, torch.zeros((1, 2, 2, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        phase_pool_bwd(g, torch.zeros((1, 2, 3, 8), dtype=torch.uint8))


# -- conv1_2' weight gradient -------------------------------------------------


def _jax_vjp_wgrad(o1_pre, dr):
    c_in, c_out = o1_pre.shape[-1], dr.shape[-1]
    k2 = jnp.zeros((2, 2, c_in, c_out), jnp.float32)
    _, vjp = jax.vjp(lambda k: jvgg._raw_conv12(jax.nn.relu(jnp.asarray(o1_pre)), k), k2)
    return np.asarray(vjp(jnp.asarray(dr))[0])


# The last case is the shape of the dry run's float32 step (tools/
# dryrun_multichip.py, __graft_entry__.py): 8 images of 64 px, a 32 x 32
# phase grid, 256 packed channels.
@pytest.mark.parametrize("b,h,w,c", [(8, 6, 10, 128), (8, 1, 1, 128), (8, 5, 7, 256),
                                     (8, 32, 32, 256)])
def test_wgrad_plain_matches_pallas(b, h, w, c):
    rng = np.random.default_rng(b + h + w)
    o1 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    dr = rng.normal(size=(b, h + 1, w + 1, c)).astype(np.float32)
    want = np.asarray(conv12_wgrad_pallas(jnp.asarray(o1), jnp.asarray(dr), interpret=True,
                                          relu_input=True))
    got = conv12_wgrad(torch.from_numpy(o1), torch.from_numpy(dr))
    assert got.shape == (c, c, 2, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().transpose(2, 3, 1, 0), want, rtol=1e-5, atol=1e-4)


def test_wgrad_any_batch_size():
    """B = 3: the port has no batch % 8 rule; held against the vjp oracle
    (the Pallas kernel refuses this batch)."""
    rng = np.random.default_rng(9)
    o1 = rng.normal(size=(3, 5, 4, 16)).astype(np.float32)
    dr = rng.normal(size=(3, 6, 5, 24)).astype(np.float32)
    got = conv12_wgrad_plain(torch.from_numpy(o1), torch.from_numpy(dr))
    np.testing.assert_allclose(got.numpy().transpose(2, 3, 1, 0), _jax_vjp_wgrad(o1, dr),
                               rtol=1e-5, atol=1e-4)


def test_wgrad_cpu_never_launches_and_checks_inputs():
    kernels = conv12_wgrad_cuda.KERNELS.values()
    before = [k.LAUNCHES for k in kernels]
    conv12_wgrad(torch.zeros((1, 2, 2, 8)), torch.zeros((1, 3, 3, 8)))
    assert [k.LAUNCHES for k in kernels] == before
    with pytest.raises(ValueError):
        conv12_wgrad(torch.zeros((1, 2, 2, 8)), torch.zeros((1, 2, 2, 8)))
