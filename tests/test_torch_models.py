"""The PyTorch port's InstanceNorm twin, layers and generators against the
JAX package (CPU, f32, toy sizes), with flax-initialised params carried
over by pix2pixhdaudiosr_torch/convert.py. Inputs come from numpy seeds;
the JAX Pallas InstanceNorm runs in interpret mode. Layouts: the JAX side
is NHWC, the port's modules take NCHW (a permute of the same array)."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from pix2pixhdaudiosr_tpu.models import generator as jgen  # noqa: E402
from pix2pixhdaudiosr_tpu.models import layers as jlayers  # noqa: E402

from pix2pixhdaudiosr_torch.convert import jax_to_torch_generator  # noqa: E402
from pix2pixhdaudiosr_torch.models import layers as tlayers  # noqa: E402
from pix2pixhdaudiosr_torch.models.discriminator import build_discriminator  # noqa: E402
from pix2pixhdaudiosr_torch.models.generator import build_generator  # noqa: E402
from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act,  # noqa: E402
                                             instance_norm_act_ref)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_networks import LADDER  # noqa: E402


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture
def interpret_pallas(monkeypatch):
    import pix2pixhdaudiosr_tpu.ops.norm_pallas as N
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(N.pl, "pallas_call", interp)


@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
def test_in_twin_matches_jax(rng_np, act, interpret_pallas):
    """The IN twin against layers.instance_norm and the Pallas
    fused_instance_norm (interpret), f32, atol 1e-5."""
    from pix2pixhdaudiosr_tpu.ops.norm_pallas import fused_instance_norm
    x = (rng_np.standard_normal((2, 16, 32, 8)) * 3 + 5).astype(np.float32)
    got = nhwc(instance_norm_act(nchw(x), act))
    ref = np.asarray(jlayers.instance_norm(jnp.asarray(x)))
    ref = {"none": ref, "relu": np.maximum(ref, 0),
           "leaky": np.where(ref >= 0, ref, 0.2 * ref)}[act]
    np.testing.assert_allclose(got, ref, atol=1e-5)
    fused = np.asarray(fused_instance_norm(jnp.asarray(x), act=act))
    np.testing.assert_allclose(got, fused, atol=1e-5)


def test_in_wrapper_cpu_twin_and_refusals(rng_np):
    x = nchw(rng_np.standard_normal((1, 4, 4, 3)).astype(np.float32))
    before = instance_norm_act.launches
    torch.testing.assert_close(instance_norm_act(x, "relu"),
                               instance_norm_act_ref(x, "relu"))
    assert instance_norm_act.launches == before  # the twin launches nothing
    with pytest.raises(ValueError, match="CUDA"):
        instance_norm_act(torch.empty(1, 3, 4, 4, device="meta"))
    with pytest.raises(ValueError, match="activation"):
        instance_norm_act_ref(x, "tanh")
    xb = x.to(torch.bfloat16)
    assert instance_norm_act(xb).dtype == torch.bfloat16


def test_avg_pool_matches_jax(rng_np):
    for shape in ((2, 9, 7, 3), (1, 16, 8, 2)):
        x = rng_np.standard_normal(shape).astype(np.float32)
        np.testing.assert_allclose(
            nhwc(tlayers.avg_pool_3s2(nchw(x))),
            np.asarray(jlayers.avg_pool_3s2(jnp.asarray(x))), atol=1e-6)


def _flax_apply(module, x, key=0):
    x = jnp.asarray(x)
    params = jax.jit(module.init)(jax.random.PRNGKey(key), x)
    return params, np.asarray(jax.jit(module.apply)(params, x))


def _load(module, params):
    module.load_state_dict(jax_to_torch_generator(jax.device_get(params)))
    return module


@pytest.mark.parametrize("kw", [
    dict(kernel=7, reflect=3, act="relu"),
    dict(kernel=3, stride=2, pad=1, act="relu"),
    dict(kernel=3, reflect=1, act="none"),
    dict(kernel=7, reflect=3, norm=False, act="tanh"),
], ids=["c7s1", "down", "res-half", "final"])
def test_conv_in_matches_flax(rng_np, kw):
    x = rng_np.standard_normal((2, 16, 12, 5)).astype(np.float32)
    jm = jlayers.ConvIN(6, **kw)
    params, want = _flax_apply(jm, x)
    tm = _load(tlayers.ConvIN(5, 6, **kw), params)
    np.testing.assert_allclose(nhwc(tm(nchw(x))), want, atol=1e-5)


@pytest.mark.parametrize("mode,impl", [("same", None), ("torch", "torch")])
def test_deconv_modes_match_flax(rng_np, mode, impl):
    """Both deconv modes against flax: SAME (the JAX default) and
    --torch_deconv, each with the flip_hw + permute weight of convert.py."""
    x = rng_np.standard_normal((2, 6, 5, 8)).astype(np.float32)
    params, want = _flax_apply(jlayers.ConvTransposeIN(4, impl=impl), x)
    tm = _load(tlayers.ConvTransposeIN(8, 4, mode), params)
    got = nhwc(tm(nchw(x)))
    assert got.shape == want.shape == (2, 12, 10, 4)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_deconv_modes_differ():
    """Swapping the two paddings is not a rounding difference."""
    tm = tlayers.ConvTransposeIN(3, 2, "same")
    x = torch.randn(1, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    y_same = tm(x)
    tm.mode = "torch"
    assert (y_same - tm(x)).abs().max() > 0.1
    with pytest.raises(ValueError, match="deconv mode"):
        tlayers.ConvTransposeIN(3, 2, "valid")


def test_resnet_block_matches_flax(rng_np):
    x = rng_np.standard_normal((2, 8, 8, 6)).astype(np.float32)
    params, want = _flax_apply(jlayers.ResnetBlock(6), x)
    tm = _load(tlayers.ResnetBlock(6), params)
    np.testing.assert_allclose(nhwc(tm(nchw(x))), want, atol=1e-5)


TOY = dict(ngf=4, n_downsample_global=2, n_blocks_global=1,
           n_local_enhancers=1, n_blocks_local=1)


@pytest.mark.parametrize("net_g", ["local", "global"])
@pytest.mark.parametrize("deconv", ["same", "torch"])
def test_toy_generators_match_jax(rng_np, net_g, deconv):
    """Toy LocalEnhancer / GlobalGenerator (ngf 4, 2 downsamples, 1 + 1
    blocks, f32) on a [2, 64, 16, 2] spectrogram (16 frames), JAX-init
    params through convert.py: atol 1e-4."""
    x = (rng_np.standard_normal((2, 64, 16, 2)) * 0.5).astype(np.float32)
    jm = jgen.build_generator(net_g, 2, 2, **TOY, dtype=jnp.float32,
                              deconv_impl="torch" if deconv == "torch" else None)
    params, want = _flax_apply(jm, x, key=3)
    tm = _load(build_generator(net_g, 2, 2, **TOY, deconv_mode=deconv), params)
    got = nhwc(tm(nchw(x)))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_convert_covers_every_tensor():
    jm = jgen.build_generator("local", 2, 2, **TOY, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 16, 2)))
    sd = jax_to_torch_generator(jax.device_get(params))
    tm = build_generator("local", 2, 2, **TOY)
    assert set(sd) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert sd[k].shape == v.shape, k
    # with or without the top-level "params" key
    assert set(jax_to_torch_generator(params["params"])) == set(sd)
    assert "global.ResnetBlock_0.ConvIN_1.Conv_0.weight" in sd
    assert "enh1_up.ConvTranspose_0.weight" in sd


@pytest.mark.parametrize("gb,lb,ngf,expected", LADDER)
def test_flagship_parameter_count(gb, lb, ngf, expected):
    """Every row of the JAX package's param ladder (tests/test_networks.py
    LADDER: LocalEnhancer, 2-channel io, 4 downsamples), built on the meta
    device: the flagship G3L2 at ngf 48 156,050,690 parameters, the
    reference's default G9L3 at ngf 64 730,713,346."""
    m = build_generator("local", 2, 2, ngf, 4, gb, 1, lb, device="meta")
    assert sum(p.numel() for p in m.parameters()) == expected


def test_encoder_and_discriminator_parameter_counts():
    """The default D (input 4, ndf 64, 3 layers, 2 scales, intermediate
    features) has 5,531,522 parameters, as the JAX package's
    (tests/test_networks.py), on the meta device; "encoder" builds the
    feature Encoder with as many parameters as the JAX package's."""
    d = build_discriminator(4, 64, 3, False, 2, True, device="meta")
    assert sum(p.numel() for p in d.parameters()) == 5_531_522
    from pix2pixhdaudiosr_tpu.models.generator import Encoder as JEncoder
    e = build_generator("encoder", 2, 2, 48, 4, 3, 1, 2, device="meta")
    want = JEncoder(2, 2, 48, 4).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 32, 16, 2)))
    assert sum(p.numel() for p in e.parameters()) == sum(
        x.size for x in jax.tree.leaves(want))


def test_flax_conv_is_the_reference_layout():
    """Guard on the converter's input: flax keeps conv kernels HWIO."""
    p = nn.Conv(3, (3, 3)).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 2)))
    assert p["params"]["kernel"].shape == (3, 3, 2, 3)
