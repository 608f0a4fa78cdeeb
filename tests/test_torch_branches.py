"""chip_smoke phase 10's CPU steps on a card step's branches
(chip_smoke.card_branch_in for InstanceNorm's activation, card_floor for
the time-domain D's dB floor), on the CPU at a toy size: on branches that
are their own they compute what the step computes, and where a recorded
branch differs at an element, their output and gradient take it.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import card_branch_in, card_floor  # noqa: E402
from pix2pixhdaudiosr_torch.ops.norm import (instance_norm_act_grad_ref,  # noqa: E402
                                             instance_norm_act_ref)
from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem  # noqa: E402

SLOPE = {"relu": 0.0, "leaky": 0.2}


def _x_dy(seed=0, shape=(2, 3, 5, 4)):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))


@pytest.mark.parametrize("source", ["card", "card_x", "own"])
@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
def test_card_branch_in_on_its_own_branches_is_the_twin(act, source):
    x, dy = _x_dy()
    y, saved = instance_norm_act_ref(x, act, with_stats=True)
    flips = []
    forward, backward = card_branch_in([(x, y, act)], source, flips)
    got, got_saved = forward(x, act, with_stats=True)
    torch.testing.assert_close(got, y, rtol=0, atol=0)
    torch.testing.assert_close(got_saved, saved, rtol=0, atol=0)
    torch.testing.assert_close(backward(x, dy, got_saved, act),
                               instance_norm_act_grad_ref(x, dy, saved, act))
    assert flips == ([] if act == "none" else [0])


@pytest.mark.parametrize("act", ["relu", "leaky"])
def test_card_branch_in_takes_a_differing_branch(act):
    """The card put the element nearest the kink on the other side: the
    output there is the other branch of the step's own pre-activation, and
    dx is autograd's through InstanceNorm times the card's slopes."""
    x, dy = _x_dy(1)
    y_lin = instance_norm_act_ref(x, "none")
    i = int(y_lin.abs().argmin())
    own_keep = y_lin >= 0 if act == "leaky" else y_lin > 0
    keep = own_keep.clone()
    keep.view(-1)[i] = ~own_keep.view(-1)[i]
    slope = torch.where(keep, 1.0, SLOPE[act])
    card_y = y_lin * slope
    card_y.view(-1)[i] = 1e-3 if keep.view(-1)[i] else -1e-3 * SLOPE[act]
    flips = []
    forward, backward = card_branch_in([(x, card_y, act)], "own", flips)
    got, saved = forward(x, act, with_stats=True)
    assert flips == [1]
    torch.testing.assert_close(got, y_lin * slope, rtol=0, atol=0)

    xg = x.clone().requires_grad_()
    mean = xg.mean(dim=(2, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    (want,) = torch.autograd.grad((xg - mean) / torch.sqrt(var + 1e-5) * slope,
                                  xg, dy)
    torch.testing.assert_close(backward(x, dy, saved, act), want,
                               rtol=1e-5, atol=1e-5)


def test_card_floor_follows_the_recorded_floor():
    """On the step's own branches card_floor is system.time_d_input, value
    and gradient; an element recorded on the other side of the floor takes
    the floor's value and no gradient, or 20 log10|f| and its gradient."""
    mv = 1e-3
    rng = np.random.default_rng(2)
    label, test = (torch.from_numpy((rng.standard_normal((2, 6, 8)) * 2e-3)
                                    .astype(np.float32)) for _ in range(2))
    test.requires_grad_()
    holder = SimpleNamespace(cfg=SimpleNamespace(min_value=mv))
    want = Pix2PixHDSystem.time_d_input(holder, label, test)
    keep = [f.detach().abs() >= mv for f in (label, test)]
    got = card_floor([tuple(keep)], mv)(label, test)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    (g_want,) = torch.autograd.grad(want[..., 1].sum(), test)
    (g_got,) = torch.autograd.grad(got[..., 1].sum(), test)
    torch.testing.assert_close(g_got, g_want, rtol=0, atol=0)

    above, below = (int(torch.nonzero(m.view(-1))[0])
                    for m in (keep[1], ~keep[1]))
    flipped = keep[1].clone()
    flipped.view(-1)[above], flipped.view(-1)[below] = False, True
    got = card_floor([(keep[0], flipped)], mv)(label, test)[..., 1]
    (g,) = torch.autograd.grad(got.sum(), test)
    got, t = got.detach().view(-1), test.detach().view(-1)
    assert float(got[above]) == pytest.approx(20 * np.log10(mv) - 20)
    assert g.view(-1)[above] == 0
    assert float(got[below]) == pytest.approx(
        20 * np.log10(abs(float(t[below]))) - 20, rel=1e-6)
    assert g.view(-1)[below] == pytest.approx(
        20 / np.log(10) / float(t[below]), rel=1e-5)
