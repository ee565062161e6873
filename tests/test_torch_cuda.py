"""Card-only tests of the port: the CUDA kernels against their plain
PyTorch versions, and the CUDA routes of the comparison against the CPU
routes.

Marked `cuda`; each skips without a card. This file imports neither jax
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dashing2_tpu_torch.cmp import core as C
from dashing2_tpu_torch.cmp import estimators as E
from dashing2_tpu_torch.config import Dashing2DistOptions
from dashing2_tpu_torch.enums import Measure
from dashing2_tpu_torch.ops import gtlt as G
from dashing2_tpu_torch.ops import int_counts as IC
from dashing2_tpu_torch.ops import nibble_comb as NC
from dashing2_tpu_torch.ops import nibble_tri as NT
from dashing2_tpu_torch.result import SketchingResult

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _packed(n: int, m: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=(n, m // 2), dtype=np.uint8)
    if n >= 4:
        a[n - 1] = a[0]
        a[1] = 0x00
        a[2] = 0xFF
    return a


# tile edges and ragged tails of the kernels' 64- and 128-row tiles
KERNEL_SIZES = [1, 2, 63, 129, 1000, 1025, 4097]


@pytest.mark.parametrize("m", [30, 62, 64, 100, 256, 1024])
@pytest.mark.parametrize("n", KERNEL_SIZES)
def test_kernel_matches_plain(card, n, m):
    """tri_eq.cu's one-hot product, exact, with the diagonal m; m not a
    multiple of its 32-register k step (30, 62, 100) is where its pad
    rule bites."""
    a = torch.from_numpy(_packed(n, m, seed=n + m)).to(card)
    before = NT.launches
    got = NT.tri_eq_counts(a, m)
    assert NT.launches == before + 1
    want = NT.tri_eq_counts_plain(a, m)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint16 and got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert (got.diagonal().cpu().numpy() == m).all()
    if n <= 129:
        u = np.concatenate([_packed(n, m, n + m) & 0xF,
                            _packed(n, m, n + m) >> 4], axis=1)
        ref = (u[:, None, :] == u[None, :, :]).sum(2)
        np.testing.assert_array_equal(got.cpu().numpy(), ref)


def test_kernel_on_unaligned_view(card):
    """A row slice starting at an odd byte offset is copied to aligned,
    word-padded rows before the launch."""
    base = torch.from_numpy(_packed(65, 64, seed=9)).to(card)
    flat = torch.cat([torch.zeros(1, dtype=torch.uint8, device=card),
                      base.reshape(-1)])
    view = flat[1:].view(65, 32)
    assert view.data_ptr() % 4
    got = NT.tri_eq_counts(view, 64)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  NT.tri_eq_counts_plain(base, 64).cpu()
                                  .numpy())


@pytest.mark.parametrize("m", [64, 256, 1024, 4096])
def test_sim_table_on_card_bits_equal_cpu(card, m):
    on_card = C.sim_table("nibble-bbit", m, 0.5, card).cpu().numpy()
    on_cpu = C.sim_table("nibble-bbit", m, 0.5, "cpu").numpy()
    np.testing.assert_array_equal(on_card.view(np.uint32),
                                  on_cpu.view(np.uint32))


@pytest.mark.parametrize("m", [30, 62, 64, 94, 96, 98, 100, 126, 128, 130,
                               256, 1024, 4096])
@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 257, 1025, 4097])
def test_comb_kernel_matches_plain(card, n, m):
    """tri_comb.cu's one-hot x combined product, exact in eq and gt: n at
    its 128-row tiles' edges; m at the pad rule (30, 62, 94, 98, 100, 126,
    130), the edge of its 96-register decode chunks (94, 96, 98), the
    127-register decode limit and the TPU's 64-register chunks (126, 128,
    130), and several stages (256 and up)."""
    a = torch.from_numpy(_packed(n, m, seed=2 * n + m)).to(card)
    before = NC.launches
    got = NC.tri_comb_counts(a, m)
    assert NC.launches == before + 1
    want = NC.tri_comb_counts_plain(a, m)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.uint16 and g.device.type == "cuda"
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    assert (got[0].diagonal().cpu().numpy() == m).all()
    assert (got[1].diagonal().cpu().numpy() == 0).all()
    if n <= 129:
        p = _packed(n, m, 2 * n + m)
        u = np.concatenate([p & 0xF, p >> 4], axis=1)
        np.testing.assert_array_equal(
            got[1].cpu().numpy(), (u[:, None, :] > u[None, :, :]).sum(2))


@pytest.mark.parametrize("m", [30, 128, 130, 1024])
@pytest.mark.parametrize("planted", ["equal", "zero-fifteen"])
def test_comb_kernel_planted_rows(card, planted, m):
    """`equal`: 300 copies of one row, so every register of every pair is
    equal and every full decode chunk holds 96 equal registers (the
    decode's limit is 127). `zero-fifteen`: rows of nibble 0 against rows
    of nibble 15, so gt is m or 0."""
    if planted == "equal":
        a = np.broadcast_to(_packed(1, m, seed=m), (300, m // 2)).copy()
        want_eq = np.full((300, 300), m)
        want_gt = np.zeros((300, 300), np.int64)
    else:
        a = np.zeros((300, m // 2), np.uint8)
        a[1::2] = 0xFF
        hi = np.arange(300) % 2 == 1
        want_eq = np.where(hi[:, None] == hi[None, :], m, 0)
        want_gt = np.where(hi[:, None] & ~hi[None, :], m, 0)
    x = torch.from_numpy(a).to(card)
    eq, gt = NC.tri_comb_counts(x, m)
    np.testing.assert_array_equal(eq.cpu().numpy(), want_eq)
    np.testing.assert_array_equal(gt.cpu().numpy(), want_gt)
    for g, w in zip((eq, gt), NC.tri_comb_counts_plain(x, m)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


def test_comb_kernel_on_unaligned_view(card):
    base = torch.from_numpy(_packed(65, 64, seed=10)).to(card)
    flat = torch.cat([torch.zeros(1, dtype=torch.uint8, device=card),
                      base.reshape(-1)])
    view = flat[1:].view(65, 32)
    assert view.data_ptr() % 4
    got = NC.tri_comb_counts(view, 64)
    for g, w in zip(got, NC.tri_comb_counts_plain(base, 64)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("m,b", [(64, 2.68), (256, 1.0733), (1024, 3.43)])
def test_ab_epilogue_on_card_bits_equal_cpu(card, m, b, fused):
    c = torch.arange(m + 1, dtype=torch.int32)
    gt, lt = torch.meshgrid(c, c, indexing="ij")
    on_cpu = E.compressed_ab_measures32(gt, lt, m, b, 0.5,
                                        Measure.SIMILARITY, fused=fused)
    on_card = E.compressed_ab_measures32(gt.to(card), lt.to(card), m, b,
                                         0.5, Measure.SIMILARITY,
                                         fused=fused).cpu()
    np.testing.assert_array_equal(on_card.numpy().view(np.uint32),
                                  on_cpu.numpy().view(np.uint32))


@pytest.mark.parametrize("n", [40, 300])
@pytest.mark.parametrize("upper_only", [False, True])
@pytest.mark.parametrize("truncation", [1, 0])
def test_pairwise_matrix_cuda_equals_cpu(card, upper_only, truncation, n):
    m = 256
    rng = np.random.default_rng(5)
    sigs = rng.random((n, m))
    sigs[7] = sigs[3]
    sigs[11, ::5] = 0.0           # empty registers: densified
    opts = Dashing2DistOptions(k=31, sketchsize=m, fd_level=0.5,
                               truncation_method=truncation)

    def run(device):
        res = SketchingResult(names=[f"s{i}" for i in range(n)],
                              cardinalities=np.full(n, 1e4),
                              signatures=sigs.copy())
        return list(C.pairwise_matrix(opts, res, block=64,
                                      upper_only=upper_only, device=device))
    got, want = run(card), run("cpu")
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


def _regs(n: int, m: int, seed: int) -> np.ndarray:
    """(n, m) u64 registers, half with the top bit set, with identical
    rows, equal registers, all-zero and all-ones rows."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 64, size=(n, m), dtype=np.uint64)
    if n >= 2:
        a[n - 1] = a[0]
        a[1, ::3] = a[0, ::3]
    if n >= 4:
        a[2] = 0
        a[3] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return a


def _dev(a: np.ndarray, card) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int64)).to(card)


@pytest.mark.parametrize("m", [30, 64, 1024])
@pytest.mark.parametrize("n", [1, 2, 63, 129, 1025])
def test_gtlt_self_kernel_matches_plain(card, n, m):
    a = _regs(n, m, seed=3 * n + m)
    t = _dev(a, card)
    before = G.self_launches.launches
    got = G.gtlt_self_counts(t)
    assert G.self_launches.launches == before + 1
    want = G.gtlt_self_counts_plain(t)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint16 and got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    if n <= 129:
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      (a[:, None] > a[None]).sum(2))


@pytest.mark.parametrize("m", [30, 64, 1024])
@pytest.mark.parametrize("na,nb", [(1, 1), (2, 65), (63, 129), (129, 1000),
                                   (1025, 64)])
def test_gtlt_kernel_matches_plain(card, na, nb, m):
    a, b = _regs(na, m, seed=na + m), _regs(nb, m, seed=nb + m + 1)
    ta, tb = _dev(a, card), _dev(b, card)
    before = G.rect_launches.launches
    got = G.gtlt_counts(ta, tb)
    assert G.rect_launches.launches == before + 1
    want = G.gtlt_counts_plain(ta, tb)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.uint16 and g.shape == (na, nb)
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    if na * nb <= 129 * 1000:
        np.testing.assert_array_equal(got[1].cpu().numpy(),
                                      (a[:, None] < b[None]).sum(2))


def test_gtlt_kernel_on_row_slices(card):
    """The row-block route's operands: rows [s, s+b) against rows [s, n)
    of one register matrix on the card."""
    a = _regs(300, 64, seed=12)
    t = _dev(a, card)
    full = G.gtlt_self_counts(t).cpu().numpy()
    for s in (0, 64, 237):
        gt, lt = G.gtlt_counts(t[s:s + 64], t[s:])
        np.testing.assert_array_equal(gt.cpu().numpy(), full[s:s + 64, s:])
        np.testing.assert_array_equal(lt.cpu().numpy(),
                                      full[s:, s:s + 64].T)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("m", [64, 200, 1024, 4096])
def test_full_sim_table_on_card_bits_equal_cpu(card, m, fused):
    on_card = C.sim_table("full", m, 8.0, card, fused).cpu().numpy()
    on_cpu = C.sim_table("full", m, 8.0, "cpu", fused).numpy()
    np.testing.assert_array_equal(on_card.view(np.uint32),
                                  on_cpu.view(np.uint32))


@pytest.mark.parametrize("self_max", [C.SELF_MAX, 0])
@pytest.mark.parametrize("upper_only", [False, True])
@pytest.mark.parametrize("n", [40, 300])
def test_full_pairwise_matrix_cuda_equals_cpu(card, n, upper_only, self_max,
                                              monkeypatch):
    """Both full-register routes (self-pairs, and row blocks with
    SELF_MAX forced to 0) on the card against the CPU."""
    m = 200
    monkeypatch.setattr(C, "SELF_MAX", self_max)
    rng = np.random.default_rng(6)
    sigs = rng.exponential(size=(n, m))
    sigs[7] = sigs[3]
    sigs[9, ::2] = sigs[4, ::2]
    sigs[11, ::5] = 0.0
    opts = Dashing2DistOptions(k=31, sketchsize=m)

    def run(device):
        res = SketchingResult(names=[f"s{i}" for i in range(n)],
                              cardinalities=np.full(n, 1e4),
                              signatures=sigs.copy())
        return list(C.pairwise_matrix(opts, res, block=64,
                                      upper_only=upper_only, device=device))
    before = (G.self_launches.launches, G.rect_launches.launches)
    got = run(card)
    launched = (G.self_launches.launches - before[0],
                G.rect_launches.launches - before[1])
    assert launched == ((0, -(-n // 64)) if self_max == 0 else (1, 0))
    want = run("cpu")
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


def _ints(n: int, m: int, dt, seed: int) -> np.ndarray:
    """(n, m) u8 or u16 registers with identical rows, equal registers,
    all-zero and all-max rows, and values on both sides of the top
    bit."""
    top = int(np.iinfo(dt).max)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, top + 1, size=(n, m), dtype=np.uint64).astype(dt)
    if n >= 2:
        a[n - 1] = a[0]
        a[1, ::3] = a[0, ::3]
    if n >= 5:
        a[2] = 0
        a[3] = top
        a[4, 0::2] = (top + 1) // 2
        a[4, 1::2] = (top + 1) // 2 - 1
    return a


def _int_dev(a: np.ndarray, card) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16
                            else a).to(card)


def _naive_int(a: np.ndarray, b: np.ndarray):
    x, y = a.astype(np.int64)[:, None], b.astype(np.int64)[None]
    return (x == y).sum(2), (x > y).sum(2), (x < y).sum(2)


@pytest.mark.parametrize("mode", ["eq", "gtlt"])
@pytest.mark.parametrize("m", [30, 64, 1024])
@pytest.mark.parametrize("n", [1, 2, 63, 129, 1025])
@pytest.mark.parametrize("dt", [np.uint8, np.uint16])
def test_int_counts_self_kernel_matches_plain(card, dt, n, m, mode):
    a = _ints(n, m, dt, seed=5 * n + m)
    t = _int_dev(a, card)
    before = IC.self_launches.launches
    got = IC.int_counts_self(t, mode)
    assert IC.self_launches.launches == before + 1
    want = IC.int_counts_self_plain(t, mode)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint16 and got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    if n <= 129:
        eq, gt, _ = _naive_int(a, a)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      eq if mode == "eq" else gt)


@pytest.mark.parametrize("m", [30, 64, 1024])
@pytest.mark.parametrize("na,nb", [(1, 1), (2, 65), (63, 129), (129, 1000),
                                   (1025, 64)])
@pytest.mark.parametrize("dt", [np.uint8, np.uint16])
def test_int_counts_kernel_matches_plain(card, dt, na, nb, m):
    a, b = _ints(na, m, dt, seed=na + m), _ints(nb, m, dt, seed=nb + m + 1)
    ta, tb = _int_dev(a, card), _int_dev(b, card)
    before = IC.rect_launches.launches
    got = IC.int_counts(ta, tb)
    assert IC.rect_launches.launches == before + 1
    want = IC.int_counts_plain(ta, tb)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.uint16 and g.shape == (na, nb)
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    if na * nb <= 129 * 1000:
        for g, w in zip(got, _naive_int(a, b)):
            np.testing.assert_array_equal(g.cpu().numpy(), w)


@pytest.mark.parametrize("dt", [np.uint8, np.uint16])
def test_int_counts_kernel_on_row_slices(card, dt):
    """The row-block route's operands: rows [s, s+b) against rows [s, n)
    of one register matrix on the card, and a u8 row slice that starts
    off a word boundary."""
    a = _ints(300, 30, dt, seed=13)
    t = _int_dev(a, card)
    eq = IC.int_counts_self(t, "eq").cpu().numpy()
    gt = IC.int_counts_self(t, "gtlt").cpu().numpy()
    for s in (0, 1, 64, 237):
        e, g, lt = (x.cpu().numpy() for x in IC.int_counts(t[s:s + 64], t[s:]))
        np.testing.assert_array_equal(e, eq[s:s + 64, s:])
        np.testing.assert_array_equal(g, gt[s:s + 64, s:])
        np.testing.assert_array_equal(lt, gt[s:, s:s + 64].T)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("m", [30, 256, 1024])
@pytest.mark.parametrize("fd", [0.5, 1.0, 2.0, 4.0])
def test_bbit_sim_tables_on_card_bits_equal_cpu(card, fd, m, fused):
    kind = "nibble-bbit" if fd == 0.5 else "bbit"
    on_card = C.sim_table(kind, m, fd, card, fused).cpu().numpy()
    on_cpu = C.sim_table(kind, m, fd, "cpu", fused).numpy()
    np.testing.assert_array_equal(on_card.view(np.uint32),
                                  on_cpu.view(np.uint32))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("fd,b", [(1.0, 1.0545), (2.0, 1.000206),
                                  (4.0, 1.0000000031)])
def test_complement_epilogue_on_card_bits_equal_cpu(card, fd, b, fused):
    m = 1024
    c = torch.arange(m + 1, dtype=torch.int32)
    gt, lt = torch.meshgrid(c, c, indexing="ij")
    on_cpu = E.compressed_ab_measures32(gt, lt, m, b, fd, Measure.SIMILARITY,
                                        fused=fused, gb_form="complement")
    on_card = E.compressed_ab_measures32(
        gt.to(card), lt.to(card), m, b, fd, Measure.SIMILARITY, fused=fused,
        gb_form="complement").cpu()
    np.testing.assert_array_equal(on_card.numpy().view(np.uint32),
                                  on_cpu.numpy().view(np.uint32))


def test_fma32_on_card_bits_equal_cpu(card):
    rng = np.random.default_rng(11)
    x = [torch.from_numpy((rng.random(1 << 16) * s).astype(np.float32))
         for s in (1.0, 3e3, 1e-3)]
    on_cpu = E.fma32(*x)
    on_card = E.fma32(*(t.to(card) for t in x)).cpu()
    assert torch.equal(on_cpu.view(torch.int32), on_card.view(torch.int32))


@pytest.mark.parametrize("self_max", [C.SELF_MAX, 0])
@pytest.mark.parametrize("n", [40, 300])
@pytest.mark.parametrize("truncation", [1, 0])
@pytest.mark.parametrize("fd", [1.0, 2.0, 4.0])
def test_int_pairwise_matrix_cuda_equals_cpu(card, fd, truncation, n,
                                             self_max, monkeypatch):
    """The u8/u16/u32 routes (self-pairs, and row blocks with SELF_MAX
    forced to 0) on the card against the CPU, upper trapezoids."""
    m = 200
    monkeypatch.setattr(C, "SELF_MAX", self_max)
    rng = np.random.default_rng(7)
    sigs = rng.exponential(size=(n, m))
    sigs[7] = sigs[3]
    sigs[9, ::2] = sigs[4, ::2]
    sigs[11, ::5] = 0.0
    opts = Dashing2DistOptions(k=31, sketchsize=m, fd_level=fd,
                               truncation_method=truncation)

    def run(device):
        res = SketchingResult(names=[f"s{i}" for i in range(n)],
                              cardinalities=np.full(n, 1e4),
                              signatures=sigs.copy())
        return list(C.pairwise_matrix(opts, res, block=64, upper_only=True,
                                      device=device))
    counters = (IC.self_launches, IC.rect_launches, G.self_launches,
                G.rect_launches)
    before = [c.launches for c in counters]
    got = run(card)
    launched = [c.launches - b for c, b in zip(counters, before)]
    blocks = -(-n // 64)
    if fd == 4.0:
        assert launched == ([0, 0, 0, blocks] if self_max == 0
                            else [0, 0, 1, 0])
    else:
        assert launched == ([0, blocks, 0, 0] if self_max == 0
                            else [1, 0, 0, 0])
    want = run("cpu")
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


# kind -> (fd, SetSketch b of a realistic job for the a/b kinds)
MEASURE_KINDS = {"nibble-bbit": (0.5, 1.0), "nibble-ab": (0.5, 1.0733),
                 "bbit-u8": (1.0, 1.0), "bbit-u16": (2.0, 1.0),
                 "bbit-u32": (4.0, 1.0), "ab-u8": (1.0, 1.0571),
                 "ab-u16": (2.0, 1.0002), "ab-u32": (4.0, 1.0 + 2.7e-9),
                 "full": (8.0, 1.0), "eqfull": (8.0, 1.0)}


@pytest.mark.parametrize("n", [20, 100])
@pytest.mark.parametrize("msr", [Measure.SIMILARITY, Measure.INTERSECTION,
                                 Measure.UNION_SIZE, Measure.CONTAINMENT,
                                 Measure.SYMMETRIC_CONTAINMENT,
                                 Measure.POISSON_LLR])
@pytest.mark.parametrize("name", sorted(MEASURE_KINDS))
def test_measure_epilogue_on_card_bits_equal_cpu(card, name, msr, n):
    """Every measure's epilogue, as pairwise_matrix builds it (numpy route
    at n = 20, jitted route at n = 100), on the card against the CPU over
    seeded counts (every count up to m) and cardinalities with zeros,
    equal and very unequal pairs."""
    m = 1000
    kind = name.split("-")[0] if name.startswith(("bbit", "ab")) else name
    fd, b = MEASURE_KINDS[name]
    opts = Dashing2DistOptions(k=31, sketchsize=m, fd_level=fd, measure=msr)
    creps = C.CompressedReps(data=None, b=b)
    rng = np.random.default_rng(n + int(msr))
    eq = torch.from_numpy(rng.integers(0, m + 1, (64, 200)))
    eq[0, :] = torch.arange(200) * 5
    gt = torch.from_numpy(rng.integers(0, m // 2 + 1, (64, 200)))
    lt = torch.from_numpy(rng.integers(0, m // 2 + 1, (64, 200)))
    cards = rng.choice([0.0, 1.0, 2500.0, 1e9, 12345.678], 200) \
        * rng.uniform(0.5, 2.0, 200)
    lh = torch.from_numpy(cards[:64].astype(np.float32))[:, None]
    rh = torch.from_numpy(cards.astype(np.float32))[None, :]
    counts = [eq, gt, lt, lh, rh]
    on_cpu = C._epilogue(kind, opts, creps, n, torch.device("cpu"))(*counts)
    on_card = C._epilogue(kind, opts, creps, n, card)(
        *(x.to(card) for x in counts)).cpu()
    assert on_card.dtype == torch.float32 and on_card.shape == (64, 200)
    assert torch.equal(on_cpu.view(torch.int32), on_card.view(torch.int32))


@pytest.mark.parametrize("n", [1, 63, 1025])
def test_nibble_unpack_and_int_counts_on_card(card, n):
    """The row-block route's on-card nibble unpack, and int_counts over
    the unpacked u8 registers, against the CPU and the plain version."""
    m = 256
    packed = torch.from_numpy(_packed(n, m, seed=n))
    got = C._unpack_nibbles(packed.to(card))
    want = C._unpack_nibbles(packed)
    assert got.dtype == torch.uint8 and got.shape == (n, m)
    assert torch.equal(got.cpu(), want)
    s = n // 3
    for x, y in ((got, got), (got[s:s + 64], got[s:])):
        for g, w in zip(IC.int_counts(x, y), IC.int_counts_plain(x, y)):
            assert torch.equal(g.to(torch.int32), w.to(torch.int32))


@pytest.mark.parametrize("upper_only", [True, False])
@pytest.mark.parametrize("self_max", [C.SELF_MAX, 0])
@pytest.mark.parametrize("fd,truncation", [(0.5, 1), (0.5, 0), (8.0, 1)])
def test_measure_pairwise_matrix_cuda_equals_cpu(card, fd, truncation,
                                                 self_max, upper_only,
                                                 monkeypatch):
    """Nibble and equality-compared full registers, CONTAINMENT and
    POISSON_LLR, on the self-pairs and row-block routes, symmetric and
    asymmetric: the card's blocks equal the CPU's."""
    n, m = 300, 200
    monkeypatch.setattr(C, "SELF_MAX", self_max)
    rng = np.random.default_rng(8)
    sigs = rng.exponential(size=(n, m))
    sigs[7] = sigs[3]
    sigs[9, ::2] = sigs[4, ::2]
    cards = rng.uniform(1e3, 1e6, n)
    for msr in (Measure.CONTAINMENT, Measure.POISSON_LLR):
        opts = Dashing2DistOptions(k=31, sketchsize=m, fd_level=fd,
                                   truncation_method=truncation, measure=msr)

        def run(device):
            res = SketchingResult(names=[f"s{i}" for i in range(n)],
                                  cardinalities=cards.copy(),
                                  signatures=sigs.copy())
            return list(C.pairwise_matrix(opts, res, block=64,
                                          upper_only=upper_only,
                                          device=device))
        got, want = run(card), run("cpu")
        assert [s for s, _ in got] == [s for s, _ in want]
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g.view(np.uint32),
                                          w.view(np.uint32))
