"""The host side of the wgmma route of the 3x3 conv kernels B4 and B5
(csrc/conv3x3_wgmma.cu), on the CPU: the planner, the shared-memory layout
that the wgmma descriptors read, and the row ring's staging index map
emulated in numpy until it rebuilds the conv.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py); these tests hold what surrounds it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from pix2pixhdaudiosr_torch.ops import enhancer as te  # noqa: E402

SMEM_LIMIT = 232_448
BN = 96          # conv3x3_wgmma.cu kBN
SBO = 128        # one core matrix: 8 rows x 16 bytes
FLAGSHIP_B4 = (128, 256, 64, 96, 96)   # B, H, W, Ci, Co (reflect)
FLAGSHIP_B5 = (64, 256, 64, 96, 96)    # output of a [64, 96, 258, 66] input
# shapes the card tests give the kernels (B, H, W, Ci, Co of the output)
CARD_SHAPES = [(2, 16, 64, 96, 96), (3, 5, 7, 8, 8), (1, 5, 150, 40, 40),
               (2, 16, 64, 96, 96), (3, 5, 7, 16, 24), (1, 5, 7, 16, 136)]


def _plans():
    for shape in (FLAGSHIP_B4, FLAGSHIP_B5, *CARD_SHAPES,
                  (1, 3, 64, 96, 96), (4, 40, 128, 48, 192),
                  (2, 7, 64, 96, 288), (5, 33, 64, 80, 96), (3, 33, 64, 96, 192)):
        for sms in (132, 7, 3):
            yield shape, te.plan_conv(*shape, sms)


def test_every_plan_fits_shared_memory():
    """Both routes' plans stay within a block's 232,448 bytes, and the
    wgmma plan's bytes are conv3x3_wgmma.cu's `layout` total."""
    n_wgmma = 0
    for (B, H, W, Ci, Co), plan in _plans():
        assert plan.smem <= SMEM_LIMIT, (B, H, W, Ci, Co, plan)
        if plan.route == "wgmma":
            n_wgmma += 1
            S, Wp = Ci // 8, W + 2
            ring = 9 * BN * S * 16
            bias = ring + plan.slots * S * Wp * 16
            total = bias + BN * 4 + 2 * S * 8 * 4 + 2 * plan.slots * 8
            assert plan.smem == total == te.wgmma_smem_bytes(W, Ci, plan.slots)
    assert n_wgmma >= 10


def test_flagship_shapes_take_the_wgmma_route():
    """B4 at [128, 96, 256, 64] and B5 at [64, 96, 258, 66] take the new
    route with 5 ring slots (rows r..r+3 in use, r+4 staged), the most
    that fit beside the weights; B4 one strip a sample (128 units on 132
    SMs), B5 two (128 units)."""
    b4, b5 = te.plan_conv(*FLAGSHIP_B4), te.plan_conv(*FLAGSHIP_B5)
    assert b4 == te.ConvPlan("wgmma", 230_480, 8, 256, 1, 5)
    assert b5 == te.ConvPlan("wgmma", 230_480, 16, 128, 2, 5)
    assert te.wgmma_smem_bytes(64, 96, te.WG_SLOTS + 1) > SMEM_LIMIT


@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_card_test_shapes_take_a_route_that_exists(shape):
    """Ci = 8, 16 or 40, W = 5, 7 or 150, Co = 24 or 136: the mma.sync
    route, with conv_tiling's tiles; (2, 16, 64, 96, 96) the wgmma route."""
    B, H, W, Ci, Co = shape
    plan = te.plan_conv(*shape)
    if (Ci, W) == (96, 64) and Co % 96 == 0:
        assert plan.route == "wgmma"
    else:
        assert plan.route == "mma_sync"
        assert (plan.th, plan.tw, plan.bn, plan.P) == te.conv_tiling(H, W, Ci,
                                                                    Co)
    with pytest.raises(ValueError, match="conv route"):
        te.plan_conv(*shape, route="tma")


@pytest.mark.parametrize("kw,match", [
    (dict(W=7), "96 input channels at width 64"),
    (dict(Ci=40), "96 input channels at width 64"),
    (dict(W=128), "96 input channels at width 64"),
    (dict(Ci=48), "96 input channels at width 64"),
    (dict(Ci=192), "96 input channels at width 64"),
    (dict(W=32), "96 input channels at width 64"),
    (dict(Co=64), "multiple of 96"), (dict(Co=144), "multiple of 96")])
def test_forced_wgmma_plans_that_do_not_fit_raise(kw, match):
    """The wgmma route takes Ci = 96, W = 64 and Co % 96 == 0 only: a
    forced plan of any other shape raises, and the planner's own plan of
    it takes the mma.sync route."""
    shape = dict(B=2, H=16, W=64, Ci=96, Co=96)
    shape.update(kw)
    with pytest.raises(ValueError, match=match):
        te.plan_conv(**shape, route="wgmma")
    assert te.plan_conv(**shape).route == "mma_sync"


@pytest.mark.parametrize("B,H,sms", [
    (3, 256, 132), (1, 255, 132), (140, 2, 132), (133, 16, 132),
    (3, 16, 132), (2, 16, 3), (1, 33, 4), (2, 9, 5), (5, 6, 3), (4, 40, 7),
    (2, 6, 3), (1, 1, 2)])
def test_strips_cover_every_output_row_once(B, H, sms):
    """The planner's units of a sample (strip rows each, the last one
    shorter where strip does not divide H), walked by blocks blockIdx.x,
    + gridDim.x, ... (more units than blocks in some cases), and the rows
    each consumer warpgroup takes (alternating over all of a block's units)
    put every output row in exactly one (unit, warpgroup)."""
    plan = te.plan_conv(B, H, 64, 96, 96, sms, route="wgmma")
    assert plan.strips == -(-H // plan.strip)
    assert plan.P == plan.strips * 8
    units = B * plan.strips
    grid = min(units, sms)
    seen = np.zeros((B, H), int)
    for blk in range(grid):
        rows_before = 0
        for u in range(blk, units, grid):
            b, s = divmod(u, plan.strips)
            h0 = s * plan.strip
            n = min(plan.strip, H - h0)
            assert n >= 1
            for cw in range(2):
                for j in range((cw + rows_before) % 2, n, 2):
                    seen[b, h0 + j] += 1
            rows_before += n
    assert (seen == 1).all()


def test_strip_choice_balances_the_card():
    """The planner's strip keeps the busiest block's rows near the
    average: at the two flagship shapes on 132 SMs within 4% of it."""
    for B, H, W, Ci, Co in (FLAGSHIP_B4, FLAGSHIP_B5):
        plan = te.plan_conv(B, H, W, Ci, Co)
        units = B * plan.strips
        waves = -(-units // min(units, 132))
        assert waves * plan.strip <= 1.04 * B * H / 132 + plan.strip


# -- the shared-memory layout the wgmma descriptors read ---------------------

def _desc_read(mem: np.ndarray, start: int, lbo: int,
               rows: int) -> np.ndarray:
    """Read a [rows, 16] operand of 2-byte elements (mem: one array element
    a bf16) through a K-major, no-swizzle wgmma descriptor: element (r, j)
    at byte start + (r // 8) * SBO + (r % 8) * 16 + (j // 8) * lbo +
    (j % 8) * 2, the canonical layout ((8, n), (8, 2)) : ((16 B, SBO),
    (2 B, LBO))."""
    r = np.arange(rows)[:, None]
    j = np.arange(16)[None, :]
    byte = start + (r // 8) * SBO + (r % 8) * 16 + (j // 8) * lbo + (j % 8) * 2
    assert (byte % 2 == 0).all()
    return mem[byte // 2]


def _weights_smem(w: torch.Tensor, n_block: int) -> np.ndarray:
    """The kernel's store of the resident weights (the consumer loop at
    the top of the consumer branch): chunk c of weight row (tap, n) of this
    N tile at byte ((tap * S + c) * kBN + n) * 16."""
    _, Co, Ci = w.shape
    S = Ci // 8
    src = w.view(torch.int16).numpy()
    mem = np.zeros(9 * S * BN * 8, np.int16)
    for idx in range(9 * S * BN):
        n, r = idx % BN, idx // BN
        c, tap = r % S, r // S
        mem[idx * 8:idx * 8 + 8] = src[tap, n_block + n, c * 8:c * 8 + 8]
    return mem


@pytest.mark.parametrize("Co", [96, 192, 288, 384])
def test_weight_descriptors_read_pack_weights_back(Co):
    """For every N tile, tap and k16 step, the B descriptor of
    `mainloop` (start wsm + (tap * S + 2 kk) * kBN * 16, lbo kBN * 16,
    sbo 128) reads pack_weights' [9, Co, Ci] matrix back bit for bit."""
    Ci = 96
    g = torch.Generator().manual_seed(0)
    w = te.pack_weights(torch.randn(Co, Ci, 3, 3, generator=g))
    S = Ci // 8
    want = w.view(torch.int16).numpy()
    for n_block in range(0, Co, BN):
        mem = _weights_smem(w, n_block)
        for tap in range(9):
            for kk in range(S // 2):
                start = (tap * S + 2 * kk) * BN * 16
                got = _desc_read(mem, start, BN * 16, BN)
                exp = want[tap, n_block:n_block + BN, 16 * kk:16 * kk + 16]
                assert np.array_equal(got, exp), (n_block, tap, kk)


# -- the row ring, emulated ---------------------------------------------------

def reflect_index(i: int, n: int) -> int:
    """conv_common.cuh reflect_index."""
    if i < 0:
        i = -i
    if i >= n:
        i = 2 * n - 2 - i
    return min(max(i, 0), n - 1)


def _stage_row(x_row: np.ndarray, W: int, reflect: bool) -> np.ndarray:
    """stage_row: position p of a staged row reads input column
    reflect(p - 1) or p; chunk c of it lands at 16-byte unit c * Wp + p.
    Returns the slot as [S * Wp * 8] channel values."""
    Wp, S = W + 2, x_row.shape[1] // 8
    slot = np.zeros(S * Wp * 8, x_row.dtype)
    for p in range(Wp):
        col = reflect_index(p - 1, W) if reflect else p
        for c in range(S):
            slot[(c * Wp + p) * 8:(c * Wp + p) * 8 + 8] = x_row[col, c * 8:c * 8 + 8]
    return slot


def emulate_ring_conv(x: np.ndarray, w: np.ndarray, strip: int, slots: int,
                      reflect: bool, n_blocks: int = 3) -> np.ndarray:
    """The kernel's index maps in numpy, f32: blocks walk units (strips of
    one sample) in the order blockIdx.x + k * gridDim.x; the producer
    stages a unit's rows h0 - 1 .. h0 + n (reflected) or h0 .. h0 + n + 1
    (VALID) in order, each into ring slot (rows staged so far) % slots, no
    sooner than an output row needs it; output row j of
    the unit reads the slots of its rows j, j + 1, j + 2, tap (dh, dw)
    through an A descriptor at slot + (m0 + dw) * 16 + 2 kk * lbo_a (lbo_a
    = Wp * 16, sbo 128) and B through the weights' descriptor.
    x: [B, Hin, Win, Ci] (NHWC), w: [9, Co, Ci]; returns [B, H, W, Co].
    strip and slots are the kernel's arguments of those names."""
    B, Hin, Win, Ci = x.shape
    Co = w.shape[1]
    H, W = (Hin, Win) if reflect else (Hin - 2, Win - 2)
    S, Wp = Ci // 8, W + 2
    y = np.zeros((B, H, W, Co), np.float32)
    strips = -(-H // strip)
    units = B * strips
    for blk in range(min(units, n_blocks)):
        ring = np.zeros((slots, S * Wp * 8), np.float32)
        it = 0
        for u in range(blk, units, min(units, n_blocks)):
            b, s = divmod(u, strips)
            h0 = s * strip
            n = min(strip, H - h0)
            staged = 0
            for j in range(n):
                for i in range(staged, j + 3):  # rows in order, as needed
                    hin = reflect_index(h0 - 1 + i, H) if reflect else h0 + i
                    ring[(it + i) % slots] = _stage_row(x[b, hin], W,
                                                        reflect)
                staged = j + 3
                acc = np.zeros((W, Co), np.float32)
                for m0 in range(0, W, 64):
                    m = min(64, W - m0)
                    for dh in range(3):
                        mem = ring[(it + j + dh) % slots]
                        for dw in range(3):
                            for kk in range(S // 2):
                                start = (m0 + dw) * 16 + 2 * kk * Wp * 16
                                a = _desc_read(mem, start, Wp * 16, m)
                                wk = w[3 * dh + dw, :, 16 * kk:16 * kk + 16]
                                acc[m0:m0 + m] += a @ wk.T
                y[b, h0 + j] = acc
            it += n + 2
    return y


@pytest.mark.parametrize("reflect", [True, False])
@pytest.mark.parametrize("H,strip,slots", [(6, 4, 5), (5, 2, 4), (3, 1, 5)])
def test_ring_emulation_rebuilds_the_conv(reflect, H, strip, slots):
    """The emulated index maps give F.conv2d of the reflect-padded input
    (B4) or of the given padded input (B5) within 1e-5 in f32, over units
    of unequal length and more units than blocks (the ring carried from one
    unit to the next), at the planner's 5 ring slots and the least the
    kernel takes (4)."""
    rng = np.random.default_rng(3)
    B, W, Ci, Co = 2, 64, 96, 96
    Hin, Win = (H, W) if reflect else (H + 2, W + 2)
    x = rng.standard_normal((B, Hin, Win, Ci)).astype(np.float32)
    # outputs of ~1: f32 sums in another order stay within 1e-5, while a
    # wrong index moves an output by ~1
    w = (rng.standard_normal((9, Co, Ci)) * .05).astype(np.float32)
    got = emulate_ring_conv(x, w, strip, slots, reflect)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if reflect:
        xt = F.pad(xt, (1, 1, 1, 1), mode="reflect")
    want = F.conv2d(xt, te.unpack_weights(torch.from_numpy(w)))
    np.testing.assert_allclose(got, want.permute(0, 2, 3, 1).numpy(),
                               atol=1e-5, rtol=0)


# -- the ring's hand-off, emulated --------------------------------------------

def _ring_protocol(B, H, strip, slots, units, seed):
    """conv3x3_wgmma.cu's producer and two consumer warpgroups as
    generators, interleaved at random. mbarriers: a phase count and an
    arrival count; try_wait.parity(p) passes once the phase of parity p has
    completed (the current phase's parity differs). The producer fills the
    rows of `units` in order, waiting each slot's previous release
    (empty, 8 warp arrivals); a consumer waits every fill in order, computes
    its rows (every other row of the block) and releases rows below its
    next. Returns the rows each warpgroup computed, checking every slot
    holds the row a consumer expects while it reads it."""
    rng = np.random.default_rng(seed)
    strips = -(-H // strip)
    full = [[0, 0] for _ in range(slots)]
    empty = [[0, 0] for _ in range(slots)]
    filled = [None] * slots
    out = []

    def arrive(bar, count, n):
        bar[1] += n
        if bar[1] == count:
            bar[0], bar[1] = bar[0] + 1, 0

    def done(bar, parity):
        return (bar[0] & 1) != parity

    def producer():
        it = 0
        for u in units:
            n = min(strip, H - (u % strips) * strip)
            for _ in range(n + 2):
                slot, use = it % slots, it // slots
                while use > 0 and not done(empty[slot], (use - 1) & 1):
                    yield
                filled[slot] = it
                arrive(full[slot], 1, 1)
                it += 1
                yield

    def consumer(cw):
        it0 = rows_before = 0
        for u in units:
            n = min(strip, H - (u % strips) * strip)
            st = {"waited": 0, "released": 0}

            def wait_through(r):
                while st["waited"] <= r:
                    q = it0 + st["waited"]
                    while not done(full[q % slots], (q // slots) & 1):
                        yield
                    assert filled[q % slots] == q
                    st["waited"] += 1

            def release_below(r):
                yield from wait_through(r - 1)
                while st["released"] < r:
                    arrive(empty[(it0 + st["released"]) % slots], 8, 4)
                    st["released"] += 1

            for j in range((cw + rows_before) % 2, n, 2):
                yield from wait_through(j + 2)
                for dh in range(3):   # the wgmmas read the three rows
                    assert filled[(it0 + j + dh) % slots] == it0 + j + dh
                    yield
                yield from release_below(min(j + 2, n + 2))
                out.append((u, j, cw))
            yield from release_below(n + 2)
            it0 += n + 2
            rows_before += n

    agents = [producer(), consumer(0), consumer(1)]
    alive = [0, 1, 2]
    for _ in range(200_000):
        if not alive:
            return out
        k = alive[rng.integers(len(alive))]
        try:
            next(agents[k])
        except StopIteration:
            alive.remove(k)
    raise AssertionError("the ring's hand-off deadlocked")


@pytest.mark.parametrize("H,strip,slots", [
    (7, 2, 4), (9, 4, 5), (5, 1, 5), (6, 6, 4), (7, 3, 5), (9, 2, 4),
    (4, 4, 4), (8, 3, 5)])
def test_ring_hand_off_has_no_deadlock_or_stale_slot(H, strip, slots):
    """Over random interleavings of the producer and the two consumer
    warpgroups, with units of unequal length and rows a warpgroup skips,
    no wait deadlocks, no slot is refilled while a consumer reads it, no
    parity wait passes on a slot two phases behind, and every output row
    of the block's units is computed once by each warpgroup that owns it."""
    B = 2
    units = list(range(0, B * -(-H // strip), 2))   # one block's units
    for seed in range(8):
        out = _ring_protocol(B, H, strip, slots, units, seed)
        want = sum(min(strip, H - (u % -(-H // strip)) * strip)
                   for u in units)
        assert len(out) == len(set(out)) == want
