"""chip_smoke's readings of the card's rounding, on the CPU at a toy size:
the --remat_g forward capture (chip_smoke.remat_norm_inputs, phase 11's
held leg: the recompute in the backward reproduces each InstanceNorm input
of the forward bit for bit), the phase 16 floor's held moments
(chip_smoke.parity_gaps), and the traced step's self-consistency
(chip_smoke.trace_split, trace_problems) on made-up profiler events.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from chip_smoke import (DP_ORDERS, card_floor, count_norms,  # noqa: E402
                        floor_rows, parity_cudnn, rank_blocks, record_floors,
                        remat_forward_check, remat_norm_inputs,
                        trace_problems, trace_split)
from pix2pixhdaudiosr_torch.config import parse_config  # noqa: E402
from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem  # noqa: E402
from pix2pixhdaudiosr_torch.trainer import init_state  # noqa: E402

BF16 = ["--compute_dtype", "bfloat16"]


def _toy(extra):
    cfg = parse_config(chip_smoke.TOY_TRAIN + extra, is_train=True,
                       save=False)
    system = Pix2PixHDSystem(cfg, device="cpu")
    init_state(system, 3)
    g = torch.Generator().manual_seed(0)
    data = {k: torch.randn(2, chip_smoke.TOY_SEG, generator=g) * 0.2
            for k in ("label", "image")}
    b, f, t, c = system.spectro_shape(2)
    noise = torch.randn(b, system.codec.mask_size(f), t, c,
                        generator=torch.Generator().manual_seed(1))
    return system, data, noise


@pytest.mark.parametrize("feat", [False, True])
@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_forward_inputs_bit_equal(mode, feat):
    """A test of the capture: in bf16 under autocast it finds G's (and
    netE's) InstanceNorm calls twice, the forward's and the recompute's, in
    one order and torch.equal; D's calls are not taken; the system's config
    is restored. The CPU has no cuDNN and no per-thread algorithm choice,
    so the recompute's fault on the card (another conv algorithm on
    autograd's thread) cannot show here: tests/test_torch_cuda.py's
    test_remat_forward_on_card_bit_equal holds it there."""
    system, data, noise = _toy(BF16 + (chip_smoke.TOY_FEAT if feat else []))
    first, again = remat_norm_inputs(system, data, noise, mode)
    n = sum(count_norms(net) for net in system.g_nets().values())
    assert n == (12 + 5 if feat else 12)
    assert first[0].dtype == torch.bfloat16
    check = remat_forward_check(first, again, n)
    assert check == dict(calls=[n, n], equal=n, first_differing=None, ok=True)
    assert system.cfg.remat_g == ""


def test_remat_forward_check_names_the_first_difference():
    """A recompute that differs in one element of one call, or that runs
    fewer calls than the net has, is refused and the call named."""
    system, data, noise = _toy(BF16)
    first, again = remat_norm_inputs(system, data, noise, "full")
    n = len(first)
    bad = [t.clone() for t in again]
    bad[5][0, 0, 0, 0] += 1.0
    check = remat_forward_check(first, bad, n)
    assert not check["ok"] and check["equal"] == n - 1
    assert check["first_differing"]["index"] == 5
    assert check["first_differing"]["elements"] == 1
    assert not remat_forward_check(first, again[:-1], n)["ok"]
    assert not remat_forward_check(first, again, n + 1)["ok"]


def test_recorded_floor_gives_every_order_one_branch_set():
    """The first order's branches of the dB floor (record_floors), taken
    by the other orders on their own rows (floor_rows, card_floor), are
    one branch set: where an order's frames sit on the other side of the
    floor by rounding (a planted flip each way), its input and gradient
    are those of the first order's branch, row for row."""
    mv = 1e-3
    rng = np.random.default_rng(4)
    label, test = (torch.from_numpy((rng.standard_normal((8, 5, 6)) * 2e-3)
                                    .astype(np.float32)) for _ in range(2))
    system = SimpleNamespace(cfg=SimpleNamespace(min_value=mv))
    system.time_d_input = lambda a, b: Pix2PixHDSystem.time_d_input(
        system, a, b)
    floors = []
    record_floors(system, floors)
    system.time_d_input(label, test)
    assert [tuple(k.shape) for k in floors[0]] == [(8, 5, 6)] * 2
    flat = test.view(-1)
    above = int(torch.nonzero(flat.abs() >= mv)[0])
    below = int(torch.nonzero(flat.abs() < mv)[0])
    for order in DP_ORDERS.values():
        moved = test.clone().view(-1)
        moved[above] = np.sign(float(flat[above])) * mv * (1 - 1e-6)
        moved[below] = np.sign(float(flat[below])) * mv * (1 + 1e-6)
        moved = moved.view_as(test)[order].requires_grad_()
        replay = card_floor(floor_rows(floors, order), mv)
        got = replay(label[order], moved)
        own = Pix2PixHDSystem.time_d_input(system, label[order], moved)
        inv = np.argsort(order)
        (g_own,) = torch.autograd.grad(own[..., 1].sum(), moved)
        assert not torch.equal(g_own[inv] != 0, floors[0][1])
        (g,) = torch.autograd.grad(got[..., 1].sum(), moved)
        assert torch.equal(g[inv] != 0, floors[0][1])


def test_rank_blocks_runs_each_net_on_the_ranks_rows():
    """rank_blocks makes G and every discriminator run each forward on the
    batch's row blocks, one after another, and join the outputs (tensors,
    and the discriminators' lists of lists): the step's losses stay those
    of the whole-batch forward; parity_cudnn sets cuDNN's flags."""
    from pix2pixhdaudiosr_torch.trainer import make_train_step
    system, data, noise = _toy(["--use_time_D", "--use_match_loss",
                                "--batchSize", "4"])
    data = {k: torch.cat([v, v.flip(0)]) for k, v in data.items()}
    noise = torch.cat([noise, noise.flip(0)])
    want = make_train_step(system)(init_state(system, 3), data, noise)[0]
    system2, _, _ = _toy(["--use_time_D", "--use_match_loss",
                          "--batchSize", "4"])
    calls = []
    for net in (system2.netG_train, *system2.d_nets().values()):
        net.forward = (lambda inner: lambda x, *a, **k: calls.append(
            x.shape[0]) or inner(x, *a, **k))(net.forward)
    rank_blocks(system2)
    got = make_train_step(system2)(init_state(system2, 3), data, noise)[0]
    assert set(calls) == {2} and len(calls) == 2 * (1 + 3 + 3)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=0)
    benchmark = torch.backends.cudnn.benchmark, \
        torch.backends.cudnn.deterministic
    try:
        parity_cudnn(True)
        assert (torch.backends.cudnn.benchmark,
                torch.backends.cudnn.deterministic) == (False, True)
        parity_cudnn(False)
        assert (torch.backends.cudnn.benchmark,
                torch.backends.cudnn.deterministic) == (True, False)
    finally:
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = benchmark


def _events(parts_ms, device_ms, ranges=(), markers=(), streams=None):
    """Made-up profiler events: under each part's outermost event a CPU op
    (id: its part's index) with one kernel of parts_ms[part] ms; the
    device events of device_ms (kernel ms, one after another on stream 7
    unless `streams` gives each its stream and start); user ranges (name,
    ms) mirrored on the device and handed back as a kernel of the
    optimizer's outer event; and CUPTI markers, each a "Command Buffer
    Full" event whose id meets the op of the part named, with that op's
    kernel."""
    from torch.autograd import DeviceType
    outer = {"forward": "aten::conv2d", "backward":
             "autograd::engine::evaluate_function: ConvBackward0",
             "optimizer": "Optimizer.step#Adam.step"}
    events = []

    def cpu(name, parent, id_, kernels):
        return SimpleNamespace(name=name, key=name, cpu_parent=parent, id=id_,
                               device_type=DeviceType.CPU, kernels=kernels,
                               is_user_annotation=False)
    for i, (part, ms) in enumerate(parts_ms.items()):
        top = cpu(outer[part], None, 100 + i, [
            SimpleNamespace(name=n, duration=1e3 * r) for n, r in ranges
        ] if part == "optimizer" else [])
        kernel = SimpleNamespace(name=f"k_{part}", duration=1e3 * ms)
        events += [top, cpu("aten::op", top, i, [kernel])]
        if part in markers:
            events.append(cpu("Command Buffer Full", top, i, [kernel]))
    t = 0.0
    for i, ms in enumerate(device_ms):
        stream, start = streams[i] if streams else (7, t)
        t = start + 1e3 * ms
        events.append(SimpleNamespace(
            name=f"k{i}", key=f"k{i}", cpu_parent=None, id=1000 + i,
            device_type=DeviceType.CUDA, kernels=[],
            self_device_time_total=1e3 * ms, is_user_annotation=False,
            device_resource_id=stream,
            time_range=SimpleNamespace(start=start, end=start + 1e3 * ms)))
    events += [SimpleNamespace(name=n, key=n, cpu_parent=None, id=2000,
                               device_type=DeviceType.CUDA, kernels=[],
                               self_device_time_total=1e3 * r,
                               is_user_annotation=True,
                               time_range=SimpleNamespace(start=0.0,
                                                          end=1e3 * r))
               for n, r in ranges]
    return events


PARTS = {"forward": 40.0, "backward": 60.0, "optimizer": 4.0}


def test_trace_split_counts_each_kernel_once():
    """The parts sum each kernel once, under its operator's outermost
    event: a CUPTI marker whose id meets an operator's, handed that
    operator's kernels too, adds nothing, and the optimizer's user range,
    mirrored on the device and handed back as a kernel of Optimizer.step,
    is no kernel (range_ms)."""
    ranges = [("Optimizer.step#Adam.step", 15.0)]
    split = trace_split(_events(PARTS, [40.0, 60.0, 4.0], ranges,
                                markers=("optimizer", "forward")))
    assert split["parts_ms"] == PARTS
    assert split["kernel_ms"] == split["busy_ms"] == 104.0
    assert split["range_ms"] == 15.0 and split["streams"] == 1
    assert split["part_kernels"]["optimizer"] == {"k_optimizer": [4.0, 1]}
    assert trace_problems(split, 110.0) == []


def test_trace_problems_refuses_parts_beyond_the_total():
    """A made-up trace whose parts exceed its kernels' sum (an op's kernel
    counted under two ids), or fall short of it (a kernel under no op), is
    refused, as is one whose device is busy beyond 1.05x the step's
    CUDA-event time; kernels that overlap on two streams count their
    union as busy time."""
    over = trace_split(_events(PARTS, [40.0, 60.0]))
    assert over["kernel_ms"] == 100.0
    assert len(trace_problems(over, 200.0)) == 1
    under = trace_split(_events(PARTS, [40.0, 60.0, 4.0, 2.0]))
    assert len(trace_problems(under, 200.0)) == 1
    split = trace_split(_events(PARTS, [40.0, 60.0, 4.0]))
    assert trace_problems(split, 104.0 / 1.049) == []
    assert len(trace_problems(split, 104.0 / 1.06)) == 1
    both = trace_split(_events(PARTS, [40.0, 60.0, 4.0], streams=[
        (7, 0.0), (13, 10e3), (7, 40e3)]))
    assert both["kernel_ms"] == 104.0 and both["streams"] == 2
    assert both["busy_ms"] == 70.0
    assert trace_problems(both, 70.0) == []
    assert len(trace_problems(both, 60.0)) == 1
