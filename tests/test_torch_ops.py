"""The kernels as torch operators (the `p2p` namespace, ops/_cuda.define_op)
on the CPU: torch.library.opcheck of every operator's CPU and fake impl,
the FLOP formulas under FlopCounterMode, every wrapper's traced route, and
a toy serve forward exported with torch.export, saved, loaded and run,
equal to eager and to the JAX package's inference (one JAX compile)."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from pix2pixhdaudiosr_tpu.config import parse_config as jparse  # noqa: E402
from pix2pixhdaudiosr_tpu.system import Pix2PixHDSystem as JSystem  # noqa: E402

from pix2pixhdaudiosr_torch.config import parse_config  # noqa: E402
from pix2pixhdaudiosr_torch.convert import jax_to_torch_generator  # noqa: E402
from pix2pixhdaudiosr_torch.ops import (_cuda, conv, enhancer,  # noqa: E402
                                        mdct_kernels, norm, quant)
from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools.aot_engine_torch import ServeEngine  # noqa: E402

TOY = ["--netG", "local", "--ngf", "4", "--n_downsample_global", "2",
       "--n_blocks_global", "1", "--n_local_enhancers", "1",
       "--n_blocks_local", "1", "--input_nc", "2", "--output_nc", "2",
       "--label_nc", "0", "--no_instance", "--explicit_encoding",
       "--mask_mode", "mode2", "--compute_dtype", "float32",
       "--n_fft", "64", "--hop_length", "32", "--win_length", "64",
       "--segment_length", "480", "--seed", "11"]
# the toy LocalEnhancer's InstanceNorms: the trunk's head, 2 downs, 2 in
# its resblock, 2 deconvs; the enhancer's down0, down1, 2 in its resblock
# and its deconv
TOY_NORMS = 12


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


def _cases(rng):
    x = _t(rng, 2, 16, 6, 5).contiguous(memory_format=torch.channels_last)
    xb = x.bfloat16()
    w = enhancer.pack_weights(_t(rng, 8, 16, 3, 3, scale=0.1))
    stats = (_t(rng, 2, 16), _t(rng, 2, 16).abs() + 0.5)
    basis = _t(rng, 64, 64, scale=0.1)
    return {
        "mdct2": (torch.ops.p2p.mdct2, (_t(rng, 2, 256), basis, 32)),
        "mdct2_planes": (torch.ops.p2p.mdct2, (
            _t(rng, 2, 256), basis, 32,
            *mdct_kernels.mdct2_planes(basis))),
        "imdct2": (torch.ops.p2p.imdct2, (_t(rng, 2, 7, 64), basis, 32)),
        "instance_norm_act": (torch.ops.p2p.instance_norm_act,
                              (x, "relu", 1e-5, False)),
        "instance_norm_act_stats": (torch.ops.p2p.instance_norm_act,
                                    (xb, "leaky", 1e-5, True)),
        "instance_stats": (torch.ops.p2p.instance_stats, (x, 1e-5)),
        "instance_moments_crop": (torch.ops.p2p.instance_moments,
                                  (x[:, :, 1:5, 1:4],)),
        "instance_apply": (torch.ops.p2p.instance_apply, (
            xb, 3 * norm.instance_moments_ref(x), "none", 1e-5, 3)),
        "conv3x3_in": (torch.ops.p2p.conv3x3_in, (
            xb, w, _t(rng, 8), None, None, None, None, 1e-5)),
        "conv3x3_in_prologue": (torch.ops.p2p.conv3x3_in, (
            xb, w, _t(rng, 8), *stats, xb, "in_relu_add", 1e-5)),
        "conv3x3_valid": (torch.ops.p2p.conv3x3_valid,
                          (xb, _t(rng, 8, 16, 3, 3, scale=0.1), True)),
        "stochastic_quantize_2d": (torch.ops.p2p.stochastic_quantize_2d,
                                   (_t(rng, 12, 8), 7)),
    }


CASES = sorted(_cases(np.random.default_rng(0)))


@pytest.mark.parametrize("case", CASES)
def test_opcheck_cpu_and_fake(case):
    """torch.library.opcheck: schema, autograd registration, the fake impl
    against the CPU impl (shape, dtype, strides) and AOT dispatch."""
    op, args = _cases(np.random.default_rng(0))[case]
    res = torch.library.opcheck(op, args)
    assert all(v == "SUCCESS" for v in res.values()), res


def test_every_op_has_a_case():
    """Every operator of the namespace is among the opcheck cases."""
    defined = {name for name in dir(torch.ops.p2p)
               if isinstance(getattr(torch.ops.p2p, name),
                             torch._ops.OpOverloadPacket)}
    covered = {str(op).split(".")[1] for op, _ in
               _cases(np.random.default_rng(0)).values()}
    assert defined == covered == {
        "mdct2", "imdct2", "instance_norm_act", "instance_stats",
        "instance_moments", "instance_apply", "conv3x3_in", "conv3x3_valid",
        "stochastic_quantize_2d"}


def _flops(op, args) -> int:
    with FlopCounterMode(display=False) as counter:
        op(*args)
    return counter.get_total_flops()


@pytest.mark.parametrize("case,want", [
    ("mdct2", 2 * 2 * 7 * 64 * 64),           # 2 B T win n_fft, T = 7
    ("imdct2", 2 * 2 * 7 * 64 * 64),
    ("conv3x3_in", 2 * 9 * 16 * 8 * 6 * 5 * 2),  # 2 * 9 Ci Co H W a sample
    ("conv3x3_valid", 2 * 9 * 16 * 8 * 4 * 3 * 2),
])
def test_flop_formulas(case, want):
    op, args = _cases(np.random.default_rng(0))[case]
    assert _flops(op, args) == want


def test_eager_cpu_runs_the_twin_without_dispatch(monkeypatch):
    """Run eagerly, a wrapper takes no operator: the CPU runs the twin
    directly (the card launches directly), which costs no dispatcher."""
    def refuse(*args):
        raise AssertionError("the eager route reached the operator")
    monkeypatch.setattr(norm, "instance_norm_act_op", refuse)
    monkeypatch.setattr(mdct_kernels, "mdct2_op", refuse)
    rng = np.random.default_rng(1)
    x = _t(rng, 1, 8, 4, 4)
    torch.testing.assert_close(norm.instance_norm_act(x, "relu"),
                               norm.instance_norm_act_ref(x, "relu"))
    mdct_kernels.mdct2(_t(rng, 1, 256), _t(rng, 64, 64), 32)
    assert not _cuda.tracing()


class _Wrapped(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


_RNG = np.random.default_rng(2)
_XB = _t(_RNG, 2, 16, 6, 5).bfloat16().contiguous(
    memory_format=torch.channels_last)
_W = _t(_RNG, 8, 16, 3, 3, scale=0.1)
WRAPPED = {
    "imdct2": (lambda s, b: mdct_kernels.imdct2(s, b, 32),
               (_t(_RNG, 2, 7, 64), _t(_RNG, 64, 64)), "imdct2"),
    "instance_norm_act": (lambda x: norm.instance_norm_act(x, "leaky", 1e-5,
                                                           True),
                          (_XB,), "instance_norm_act"),
    "instance_stats": (lambda x: norm.instance_stats(x), (_XB,),
                       "instance_stats"),
    "instance_moments": (lambda x: norm.instance_moments(x[:, :, 1:, 1:]),
                         (_XB,), "instance_moments"),
    "instance_apply": (lambda x, m: norm.instance_apply(x, m, "relu",
                                                       count=2),
                       (_XB, 2 * norm.instance_moments_ref(_XB)),
                       "instance_apply"),
    "conv3x3_in": (lambda x, w: enhancer.conv3x3_in(
        x, enhancer.pack_weights(w), torch.zeros(8)), (_XB, _W),
        "conv3x3_in"),
    "conv3x3_valid": (lambda x, w: conv.conv3x3_valid(x, w), (_XB, _W),
                      "conv3x3_valid"),
    "stochastic_quantize_2d": (lambda x: quant.stochastic_quantize_2d(x, 5),
                               (_t(_RNG, 12, 8),), "stochastic_quantize_2d"),
}


@pytest.mark.parametrize("name", sorted(WRAPPED))
def test_traced_wrapper_records_its_op(name):
    """Under torch.export each wrapper calls its operator once, and the
    exported program gives the eager twin's bits."""
    fn, args, op = WRAPPED[name]
    ep = torch.export.export(_Wrapped(fn), args, strict=False)
    calls = [n for n in ep.graph.nodes if n.op == "call_function"
             and str(n.target) == f"p2p.{op}.default"]
    assert len(calls) == 1
    got, want = ep.module()(*args), fn(*args)
    for g, w in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(g, w)


def _toy_system():
    cfg = parse_config(TOY, is_train=False, save=False)
    jcfg = jparse(TOY, is_train=False, save=False)
    jsys = JSystem(jcfg)
    params = jax.jit(jsys.netG.init)(
        jax.random.PRNGKey(4), jnp.zeros(jsys.spectro_shape(1), jnp.float32))
    system = Pix2PixHDSystem(cfg, device="cpu")
    system.netG.load_state_dict(jax_to_torch_generator(
        jax.device_get(params)))
    system.netG.eval().requires_grad_(False)
    return system, jsys, params


def test_toy_serve_exports_and_matches_eager_and_jax(tmp_path, rng_np):
    """The toy serve forward (encode + G, system.inference(...)[0], mask
    noise an input) exported: B1 once and B3 12 times in the graph,
    saved, loaded, and run to eager's bits; and within atol 1e-4 of the
    JAX package's inference on the same weights and noise."""
    system, jsys, params = _toy_system()
    audio = torch.from_numpy((rng_np.standard_normal((2, 480)) * 0.2)
                             .astype(np.float32))
    b, f, t, c = system.spectro_shape(2)
    key = jax.random.PRNGKey(3)
    shape = (b, system.codec.mask_size(f), t, c)
    # the draw of the JAX inference's mask: split(split(key)[0], 3)[1]
    sub = jax.random.split(jax.random.split(key)[0], 3)[1]
    noise = torch.from_numpy(np.array(jax.random.normal(sub, shape)))

    with torch.no_grad():
        ep = torch.export.export(ServeEngine(system), (audio, noise),
                                 strict=False)
        want = system.inference(audio, noise)[0]
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert ops.count("p2p.mdct2.default") == 1
    assert ops.count("p2p.instance_norm_act.default") == TOY_NORMS
    path = str(tmp_path / "toy.pt2")
    torch.export.save(ep, path)
    got = torch.export.load(path).module()(audio, noise)
    assert torch.equal(got, want)

    jwant = np.asarray(jax.jit(lambda p, a, k: jsys.inference(p, a, k)[0])(
        params, jnp.asarray(audio.numpy()), key))
    np.testing.assert_allclose(got.numpy(), jwant, atol=1e-4, rtol=0)
