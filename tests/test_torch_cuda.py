"""Card-only tests of the port: the CUDA kernels against their plain
PyTorch versions, and the CUDA routes of the comparison against the CPU
routes.

Marked `cuda`; each skips without a card. This file imports neither jax
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os

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


# --------------------------------------------------------------------------
# panels and pair lists
# --------------------------------------------------------------------------

PANEL_KINDS = {"nibble-bbit": dict(fd_level=0.5, truncation_method=1),
               "nibble-ab": dict(fd_level=0.5),
               "u8-ab": dict(fd_level=1.0),
               "u16-bbit": dict(fd_level=2.0, truncation_method=1),
               "u32-ab": dict(fd_level=4.0),
               "full": dict(),
               "eqfull": dict(truncation_method=1)}


def _family_sigs(n: int, m: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.exponential(size=(n // 4 + 1, m))
    sigs = base[rng.integers(0, len(base), n)]
    return np.where(rng.random((n, m)) < 0.15,
                    rng.exponential(size=(n, m)), sigs)


@pytest.mark.parametrize("msr", ["SIMILARITY", "CONTAINMENT", "POISSON_LLR"])
@pytest.mark.parametrize("kind", sorted(PANEL_KINDS))
@pytest.mark.parametrize("nf,nq", [(30, 10), (250, 50)])
def test_panel_cuda_equals_cpu(card, nf, nq, kind, msr):
    """A panel on the card: one rectangular launch per reference row
    block (int_counts for nibbles, u8 and u16; gtlt_counts for u32, u64
    and eqfull), no self-pairs launch, and the CPU's values bit for
    bit."""
    n, m = nf + nq, 200
    sigs = _family_sigs(n, m, seed=nf + len(kind))
    cards = np.random.default_rng(nq).uniform(1e3, 1e6, n)
    opts = Dashing2DistOptions(k=31, sketchsize=m, measure=Measure[msr],
                               **PANEL_KINDS[kind])

    def run(device):
        res = SketchingResult(names=[f"s{i}" for i in range(n)],
                              cardinalities=cards.copy(),
                              signatures=sigs.copy(), nq=nq)
        return list(C.pairwise_matrix(opts, res, block=64, device=device))
    counters = (NT, NC, G.self_launches, G.rect_launches,
                IC.self_launches, IC.rect_launches)
    before = [c.launches for c in counters]
    got = run(card)
    launched = [c.launches - b for c, b in zip(counters, before)]
    rect = -(-nf // 64)
    wide = kind in ("u32-ab", "full", "eqfull")
    assert launched == [0, 0, 0, rect if wide else 0, 0,
                        0 if wide else rect], launched
    want = run("cpu")
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.shape[1] == nq
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.uint64])
def test_pair_counts_on_card_equal_plain(card, dt):
    """ops/pair_counts.py on the card against the same function on CPU
    tensors, over pairs of an item with itself, repeated pairs and more
    than one block."""
    from dashing2_tpu_torch.ops.pair_counts import pair_counts
    rng = np.random.default_rng(3)
    n, m = 300, 1024
    if dt == np.uint64:
        a = _regs(n, m, seed=4).view(np.int64)
    else:
        a = _ints(n, m, dt, seed=4)
        a = a.view(np.int16) if dt == np.uint16 else a
    ia = rng.integers(0, n, 20000)
    ib = rng.integers(0, n, 20000)
    ib[:50] = ia[:50]
    ia[50:100], ib[50:100] = ia[100:150], ib[100:150]
    regs = torch.from_numpy(a)
    got = pair_counts(regs.to(card), torch.from_numpy(ia).to(card),
                      torch.from_numpy(ib).to(card))
    want = pair_counts(regs, torch.from_numpy(ia), torch.from_numpy(ib))
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)
    assert (want[0][:50] == m).all()


@pytest.mark.parametrize("msr", ["SIMILARITY", "UNION_SIZE", "POISSON_LLR"])
@pytest.mark.parametrize("kind", sorted(PANEL_KINDS))
def test_measure_pairs_cuda_equals_cpu(card, kind, msr):
    n, m = 200, 256
    sigs = _family_sigs(n, m, seed=len(kind))
    cards = np.random.default_rng(2).uniform(1e3, 1e6, n)
    rng = np.random.default_rng(9)
    ia, ib = rng.integers(0, n, 10000), rng.integers(0, n, 10000)
    opts = Dashing2DistOptions(k=31, sketchsize=m, measure=Measure[msr],
                               **PANEL_KINDS[kind])

    def run(device):
        res = SketchingResult(names=[f"s{i}" for i in range(n)],
                              cardinalities=cards.copy(),
                              signatures=sigs.copy())
        creps, res = C._prep(opts, res)
        return C.measure_pairs(opts, res, creps, ia, ib, device=device)
    got, want = run(card), run("cpu")
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_hash_chain_on_card_equals_cpu(card):
    """ops/hashes.py on CUDA int64 tensors gives the CPU's bits, u64
    values >= 2^63 and rounding ties of the unit float included."""
    from dashing2_tpu_torch.ops import hashes as DH
    rng = np.random.default_rng(21)
    x = rng.integers(0, 1 << 64, 1 << 16, dtype=np.uint64)
    x[:6] = [0, 1 << 63, (1 << 64) - 1, (1 << 63) + (1 << 10),
             (1 << 53) + 1, (1 << 63) + (3 << 10)]
    t = torch.from_numpy(x.view(np.int64))
    for fn in (DH.wanghash, DH.css_item_hash, DH.u64_to_unit_float,
               lambda v: DH.wyhash64_step(v)[1],
               lambda v: DH.u64_mod(v, 1000), lambda v: DH.u64_mod(v, 1024),
               lambda v: DH.wanghash_(v.clone())):
        got = fn(t.to(card)).cpu()
        want = fn(t)
        assert torch.equal(got.view(torch.int64) if got.is_floating_point()
                           else got, want.view(torch.int64)
                           if want.is_floating_point() else want)


@pytest.mark.parametrize("m,n", [(1024, 20000), (256, 3000), (100, 500),
                                 (64, 7)])
def test_css_on_card_matches_cpu(card, m, n):
    """The CSetSketch draws on the card against the same torch code on
    the CPU: the passes equal, the registers bit for bit (the port's own
    f64 log on both), and so the order of the registers across items
    (the gt/lt counts)."""
    from dashing2_tpu_torch.ops import gtlt as G
    from dashing2_tpu_torch.ops import sketch_kernels as SK
    from dashing2_tpu_torch.ops.cmp_kernels import f64_to_ordered_u64
    rng = np.random.default_rng(m + n)
    shared = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    items = [np.unique(np.concatenate([
        shared[:n - 50 * i], rng.integers(0, 1 << 64, 50 * i,
                                          dtype=np.uint64)]))
        for i in range(6)] + [np.zeros(0, np.uint64)]
    got, gp = SK.css_sketch_many(items, m, card, budget=1 << 24)
    want, wp = SK.css_sketch_many(items, m, "cpu")
    np.testing.assert_array_equal(gp, wp)
    assert np.isinf(got[-1]).all() and gp[-1] == 0
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    counts = [G.gtlt_self_counts_plain(torch.from_numpy(
        f64_to_ordered_u64(r[:-1]).view(np.int64))) for r in (got, want)]
    assert torch.equal(counts[0], counts[1])


def test_fss_cli_on_card_equals_cpu(card, tmp_path):
    """`sketch --full-setsketch` and `--fastcmp-bytes` through the CLI
    on the card write the CPU run's bytes; `cmp --presketched --full`
    over the card's -o output gives the sketch job's bytes."""
    from dashing2_tpu_torch import cli
    from dashing2_tpu_torch.io.corpus import write_corpus
    paths = write_corpus(str(tmp_path / "fa"), seed=5, n_ancestors=7,
                         n_mutants=10, length=3000)
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    for tag, flags in (("fss", ["--full-setsketch"]),
                       ("u8", ["--full-setsketch", "--fastcmp-bytes"])):
        outs = []
        for dev in ("cuda", "cpu"):
            out = tmp_path / f"{tag}-{dev}.bin"
            argv = ["sketch", "-k", "31", "-S", "256"] + flags + [
                "--binary-output", "--cmpout", str(out), "-o",
                str(tmp_path / f"{tag}-{dev}.sig"), "-F", str(lst),
                "--device", dev]
            assert cli.main(argv) == 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1]
    out = tmp_path / "c.bin"
    assert cli.main(["cmp", "--presketched", "--full", "--binary-output",
                     "--cmpout", str(out),
                     str(tmp_path / "fss-cuda.sig")]) == 0
    assert out.read_bytes() == (tmp_path / "fss-cuda.bin").read_bytes()


@pytest.mark.parametrize("msr", ["SIMILARITY", "CONTAINMENT", "UNION_SIZE",
                                 "POISSON_LLR"])
@pytest.mark.parametrize("fused", [True, False])
def test_u64_ab_epilogue_on_card_equals_cpu(card, msr, fused):
    """The u64 a/b estimator (fd 8) on the card gives the CPU's bits over
    every (gt, lt) with gt + lt <= m."""
    m = 100
    c = torch.arange(m + 1, dtype=torch.int32)
    gt, lt = torch.meshgrid(c, c, indexing="ij")
    lt = torch.minimum(lt, m - gt)
    lh = torch.linspace(1.0, 1e6, m + 1, dtype=torch.float32)[:, None]
    rh = torch.linspace(5.0, 2e5, m + 1, dtype=torch.float32)[None, :]
    args = (m, 1.06, 8.0, Measure[msr])
    kw = dict(fused=fused, gb_form="complement")
    on_cpu = E.compressed_ab_measures32(gt, lt, *args, lh=lh, rh=rh, **kw)
    on_card = E.compressed_ab_measures32(gt.to(card), lt.to(card), *args,
                                         lh=lh.to(card), rh=rh.to(card),
                                         **kw).cpu()
    assert torch.equal(on_cpu.view(torch.int32), on_card.view(torch.int32))


def _exact_result(n: int, seed: int, weighted: bool, big: int = 0):
    """Seeded exact sets sharing keys by family: u64::max in items 0, 3
    and 6, items 4 and 7 empty, item 1 `big` keys larger."""
    rng = np.random.default_rng(seed)
    top = np.uint64(0xFFFFFFFFFFFFFFFF)
    pool = rng.integers(0, 1 << 63, size=8000, dtype=np.uint64) * 2 + 1
    sets, counts = [], []
    for i in range(n):
        fam = (i // 5) % 12
        s = np.unique(rng.choice(pool[fam * 250:fam * 250 + 500],
                                 size=int(rng.integers(50, 400))))
        if i in (0, 3, 6):
            s = np.append(s, top)
        if i in (4, 7):
            s = s[:0]
        if big and i == 1:
            s = np.unique(np.concatenate([s, pool[:big]]))
        sets.append(s)
        counts.append(rng.integers(1, 60, size=len(s)).astype(np.float64))
    return SketchingResult(names=[str(i) for i in range(n)], kmer_sets=sets,
                           kmer_set_counts=counts if weighted else None)


@pytest.mark.parametrize("budget", [1 << 26, 4099])
@pytest.mark.parametrize("weighted", [False, True])
def test_exact_join_on_card_equals_cpu(card, weighted, budget):
    """cmp/wcompare.py's posting join on CUDA tensors: the CPU's integers
    for every row block, whole and upper triangle, in one or many
    sub-blocks."""
    from dashing2_tpu_torch.cmp import wcompare as W
    res = _exact_result(300, seed=7, weighted=weighted)
    cols = np.arange(300)
    joins = [W.ExactJoin(W.device_sets(res, torch.device(d)), cols,
                         budget=budget) for d in ("cuda", "cpu")]
    for start in (0, 128, 256):
        rows = np.arange(start, min(start + 128, 300))
        for upper in (False, True):
            got, want = (j.block(rows, upper=upper).cpu() for j in joins)
            assert torch.equal(got, want)
    assert joins[0].subblocks == joins[1].subblocks


@pytest.mark.parametrize("route", ["lookup", "posting"])
@pytest.mark.parametrize("weighted", [False, True])
def test_exact_pairs_on_card_equal_cpu(card, weighted, route):
    from dashing2_tpu_torch.cmp import wcompare as W
    res = _exact_result(200, seed=8, weighted=weighted,
                        big=6000 if route == "posting" else 0)
    assert (W.padded_sets(res, card) is None) == (route == "posting")
    rng = np.random.default_rng(9)
    ia = np.concatenate([[0, 0, 4], rng.integers(0, 200, 5000)])
    ib = np.concatenate([[3, 1, 7], rng.integers(0, 200, 5000)])
    got = W.exact_intersections_pairs(res, ia, ib, device="cuda",
                                      budget=1 << 20)
    want = W.exact_intersections_pairs(res, ia, ib, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert want[0] > 0 and want[2] == 0


def test_exact_cli_on_card_equals_cpu(card, tmp_path):
    """`--set` and `--countdict` all-pairs, panel and neighbour jobs
    through the CLI on the card write the CPU run's bytes."""
    from dashing2_tpu_torch import cli
    from dashing2_tpu_torch.io.corpus import write_corpus
    paths = write_corpus(str(tmp_path / "fa"), seed=6, n_ancestors=7,
                         n_mutants=10, length=3000)
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    qs = tmp_path / "q.txt"
    qs.write_text("\n".join(paths[::10]) + "\n")
    for tag, flags in (("set", ["--set"]),
                       ("cd-asym", ["--countdict", "--containment",
                                    "--asymmetric-all-pairs"]),
                       ("panel", ["--set", "-Q", str(qs)]),
                       ("knn", ["--set", "--topk", "5"]),
                       ("greedy", ["--countdict", "--greedy", "0.3"])):
        outs = []
        for dev in ("cuda", "cpu"):
            out = tmp_path / f"{tag}-{dev}.bin"
            assert cli.main(["sketch", "-k", "31", "--binary-output",
                             "--cmpout", str(out), "-F", str(lst),
                             "--device", dev] + flags) == 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1], tag


def test_fixed_math_on_card_equals_cpu(card):
    """ops/fixedmath.py's log32, exp32 and log64 on CUDA tensors give the
    CPU's bits."""
    from dashing2_tpu_torch.ops import fixedmath as FM
    rng = np.random.default_rng(23)
    x32 = np.concatenate([rng.random(1 << 18), np.exp(rng.uniform(
        -69, 88, 1 << 18))]).astype(np.float32)
    x32[:5] = [0.0, 1.0, np.inf, 1e-30, -1.0]
    x64 = np.concatenate([rng.random(1 << 18) + 1e-300, np.exp(
        rng.uniform(-700, 700, 1 << 18))])
    for fn, x in ((FM.log32, x32), (FM.exp32, -np.abs(x32) * 0.25),
                  (FM.exp32, np.log1p(np.abs(x32))), (FM.log64, x64)):
        t = torch.from_numpy(np.ascontiguousarray(x))
        got, want = fn(t.to(card)).cpu(), fn(t)
        bits = torch.int32 if got.dtype == torch.float32 else torch.int64
        assert torch.equal(got.view(bits), want.view(bits)), fn.__name__


def _weighted_operands(lens, seed, kind):
    from dashing2_tpu_torch.sketch import weighted as PW
    rng = np.random.default_rng(seed)
    hs = [rng.integers(0, 1 << 64, n, dtype=np.uint64) for n in lens]
    cs = [rng.integers(1, 10 ** 6 + 1, n).astype(np.float64) for n in lens]
    for h, c in zip(hs, cs):
        for a, b in ((3, 9), (50, 2100)):
            if b < len(h):
                h[b], c[b] = h[a], c[a]
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    lnw = np.concatenate(PW._lnw_many(kind, hs, cs)).astype(np.float32)
    return (torch.from_numpy(np.concatenate(hs).view(np.int64)),
            torch.from_numpy(lnw), torch.from_numpy(off))


@pytest.mark.parametrize("m", [1, 64, 100, 129, 1000, 1024])
@pytest.mark.parametrize("kind", ["icws", "pmh"])
def test_weighted_draws_match_plain(card, kind, m):
    """weighted_draws.cu against its plain version: keys, winners and
    values bit for bit, over empty, one-position and row-edge streams
    with repeats inside and across 2048-position rows."""
    from dashing2_tpu_torch.ops import weighted_draws as WD
    args = [t.to(card) for t in _weighted_operands(
        [0, 1, 7, 2047, 2048, 2049, 4200], m, kind)]
    before = WD.launches.launches
    got = WD.weighted_draws(kind, *args, m)
    assert WD.launches.launches == before + 1
    want = WD.weighted_draws_plain(kind, *args, m)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
    cpu = WD.weighted_draws(kind, *[t.cpu() for t in args], m)
    assert torch.equal(cpu[2].view(torch.int32), got[2].cpu().view(
        torch.int32))


def test_weighted_cli_on_card_equals_cpu(card, tmp_path):
    """`sketch -B`, `-P -c 4096` and `-P --topk 3` through the CLI on the
    card write the CPU run's bytes."""
    from dashing2_tpu_torch import cli
    from dashing2_tpu_torch.io.corpus import write_corpus
    paths = write_corpus(str(tmp_path / "fa"), seed=9, n_ancestors=3,
                         n_mutants=4, length=3000)
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    for tag, flags in (("B", ["-B"]), ("P-c", ["-P", "-c", "4096"]),
                       ("P-knn", ["-P", "--topk", "3"])):
        outs = []
        for dev in ("cuda", "cpu"):
            out = tmp_path / f"{tag}-{dev}.bin"
            assert cli.main(["sketch", "-k", "21", "-S", "128"] + flags + [
                "--binary-output", "--cmpout", str(out), "-F", str(lst),
                "--device", dev]) == 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1], tag


def _masked_operands(lens, seed, kind):
    """Streams whose weights hold zeros and negative values (masked: a
    log-weight of -inf), the third every weight 0 or less, the last its
    first two 2048-position rows masked."""
    from dashing2_tpu_torch.sketch import weighted as PW
    rng = np.random.default_rng(seed)
    hs = [rng.integers(0, 1 << 64, n, dtype=np.uint64) for n in lens]
    cs = []
    for n in lens:
        c = rng.integers(1, 10 ** 6 + 1, n).astype(np.float64)
        u = rng.random(n)
        c[u < 0.2] = 0.0
        c[u > 0.9] *= -1.0
        cs.append(c)
    cs[2] = -np.abs(cs[2])
    cs[-1][:4096] = 0.0
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    lnw = np.concatenate(PW._lnw_many(kind, hs, cs)).astype(np.float32)
    return (torch.from_numpy(np.concatenate(hs).view(np.int64)),
            torch.from_numpy(lnw), torch.from_numpy(off))


@pytest.mark.parametrize("m", [1, 64, 1000, 1024])
@pytest.mark.parametrize("kind", ["icws", "pmh"])
def test_weighted_draws_masked_match_plain(card, kind, m):
    """weighted_draws.cu against its plain version on streams with zero,
    negative and all-masked weights: keys, winners and values bit for
    bit; the all-masked item has key +inf, winner 0 and value 0."""
    from dashing2_tpu_torch.ops import weighted_draws as WD
    args = [t.to(card) for t in _masked_operands(
        [1, 7, 2049, 2048, 5000], m, kind)]
    got = WD.weighted_draws(kind, *args, m)
    want = WD.weighted_draws_plain(kind, *args, m)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
    key, win, val = (t[2].cpu() for t in got)
    assert torch.isinf(key).all() and not win.any() and not val.any()


@pytest.mark.parametrize("m", [64, 1024])
def test_css_winners_on_card_equal_cpu(card, m):
    """css_sketch_many(return_ids=True) on the card: the CPU's registers
    and winners (indices in each item's input order)."""
    from dashing2_tpu_torch.ops import sketch_kernels as SK
    rng = np.random.default_rng(m)
    items = [rng.permutation(np.unique(rng.integers(
        0, 1 << 64, n, dtype=np.uint64))) for n in (3, 500, 9000, 30000)]
    items.append(np.zeros(0, np.uint64))
    got = SK.css_sketch_many(items, m, card, return_ids=True)
    want = SK.css_sketch_many(items, m, "cpu", return_ids=True)
    np.testing.assert_array_equal(got[0].view(np.int64),
                                  want[0].view(np.int64))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_contain_lookup_on_card_equals_cpu(card):
    """The contain lookup on the card: the CPU's match counts and depth
    sums, keys at and above 2^63, a key many references hold, in
    sub-blocks of a few entries too."""
    from dashing2_tpu_torch.cmp import contain as PCT
    rng = np.random.default_rng(17)
    pool = rng.integers(0, 1 << 64, 5000, dtype=np.uint64)
    pool[:3] = [0, 1 << 63, (1 << 64) - 1]
    kmers = rng.choice(pool, (300, 128))
    kmers[:, 0] = pool[1]
    hv = np.concatenate([rng.choice(pool, 20000),
                         rng.integers(0, 1 << 64, 3000, dtype=np.uint64)])
    want = PCT.KmerLookup(kmers, "cpu").match(hv)
    got = PCT.KmerLookup(kmers, card).match(hv)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    old = PCT.EXPAND_BLOCK
    PCT.EXPAND_BLOCK = 97
    try:
        small = PCT.KmerLookup(kmers, card).match(hv)
    finally:
        PCT.EXPAND_BLOCK = old
    for g, w in zip(small, want):
        np.testing.assert_array_equal(g, w)


def _interval_inputs(tmp_path):
    """Four BED files, three BigWig tracks (values with zeros and
    negatives) and a LeafCutter table."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        from chip_smoke import _write_bigwig
    finally:
        sys.path.pop(0)
    rng = np.random.default_rng(19)
    beds = []
    for i in range(4):
        p = tmp_path / f"p{i}.bed"
        p.write_text("".join(
            f"chr{c}\t{s}\t{s + w}\n" for c, s, w in zip(
                rng.integers(1, 4, 60), rng.integers(0, 50000, 60),
                rng.integers(20, 300, 60))))
        beds.append(str(p))
    tracks = []
    for i in range(3):
        chroms = {}
        for c in ("chr1", "chr2"):
            s = np.sort(rng.choice(20000, 300, replace=False)).astype(
                np.uint32) * 5
            v = rng.choice([0.0, -2.0, 1.5, 4.0], 300).astype(np.float32)
            chroms[c] = (s, s + rng.integers(1, 5, 300).astype(np.uint32), v)
        p = str(tmp_path / f"t{i}.bw")
        _write_bigwig(p, chroms, per_block=64)
        tracks.append(p)
    lf = tmp_path / "x_perind.counts"
    lf.write_text("chrom a b c\n" + "".join(
        f"chr1:{10 * j}:{10 * j + 5}:clu_{j} "
        + " ".join(f"{rng.integers(0, 4)}/{rng.integers(1, 9)}"
                   for _ in range(3)) + "\n" for j in range(200)))
    return beds, tracks, [str(lf)]


def test_interval_cli_on_card_equals_cpu(card, tmp_path):
    """`sketch --bed` (one-permutation, --full-setsketch, -B
    --normalize-intervals, -P), `--bigwig -P`, `--bigwig -B --by-chrom`
    and `--leafcutter -B` through the CLI on the card write the CPU
    run's bytes (comparison and -o)."""
    from dashing2_tpu_torch import cli
    beds, tracks, lf = _interval_inputs(tmp_path)
    jobs = {"bed": (["--bed"], beds), "bed-fss": (["--bed", "--full"], beds),
            "bed-bmh": (["--bed", "-B", "--normalize-intervals"], beds),
            "bed-pmh": (["--bed", "-P"], beds),
            "bw-pmh": (["--bigwig", "-P"], tracks),
            "bw-bmh": (["--bigwig", "-B", "--by-chrom"], tracks),
            "lf-bmh": (["--leafcutter", "-B"], lf)}
    for tag, (flags, paths) in jobs.items():
        outs = []
        for dev in ("cuda", "cpu"):
            out, sig = tmp_path / f"{tag}-{dev}.bin", tmp_path / f"{tag}.sig"
            assert cli.main(["sketch", "-S", "256"] + flags + [
                "--binary-output", "--cmpout", str(out), "-o", str(sig)]
                + paths + ["--device", dev]) == 0
            outs.append((out.read_bytes(), sig.read_bytes()))
        assert outs[0] == outs[1], tag


def test_wsketch_cli_on_card_equals_cpu(card, tmp_path):
    """`wsketch -B`, `-P` and `-q` over a CSR matrix (weights with zeros
    and negatives, an empty row) on the card write the CPU run's files."""
    from dashing2_tpu_torch import cli
    rng = np.random.default_rng(23)
    ids = rng.integers(0, 3000, 2500).astype(np.uint64)
    w = rng.uniform(0.2, 4.0, 2500)
    w[::11] = 0.0
    w[3::13] *= -1
    ip = np.array([0, 700, 700, 1500, 2500], np.uint64)
    for name, arr in (("ids", ids), ("w", w), ("ip", ip)):
        arr.tofile(str(tmp_path / name))
    for flags in (["-B"], ["-P"], ["-q"]):
        files = []
        for dev in ("cuda", "cpu"):
            pref = str(tmp_path / f"o{dev}")
            assert cli.main(["wsketch", "-S", "256", "-o", pref] + flags + [
                str(tmp_path / n) for n in ("ids", "w", "ip")]
                + ["--device", dev]) == 0
            files.append({s: open(f"{pref}{s}", "rb").read() for s in (
                ".sampled.indices.stacked.4.256.i64",
                ".sampled.regs.stacked.4.256.f64",
                ".sampled.hashes.stacked.4.256.i64", ".sampled.info.txt")})
        assert files[0] == files[1], flags


def test_contain_cli_on_card_equals_cpu(card, tmp_path):
    """`sketch -s -N -o db`, then `contain` binary and text with the
    lookup on the card: the CPU run's bytes."""
    from dashing2_tpu_torch import cli
    from dashing2_tpu_torch.io.corpus import write_corpus
    paths = write_corpus(str(tmp_path / "fa"), seed=29, n_ancestors=3,
                         n_mutants=4, length=3000)
    db = str(tmp_path / "db")
    assert cli.main(["sketch", "-k", "21", "-S", "256", "-s", "-N", "-o",
                     db] + paths) == 0
    for flags in (["--binary-output"], []):
        outs = []
        for dev in ("cuda", "cpu"):
            out = tmp_path / f"c-{dev}"
            assert cli.main(["contain"] + flags + [
                "--cmpout", str(out), db + ".kmer64"] + paths[:5]
                + ["--device", dev]) == 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1], flags


def _omh_streams(card):
    """The planted OMH streams (tests/omh_planted.py) and random streams
    across the kernel's pieces (8192 positions) and staged steps (1024),
    with invalid windows, back to back on the card."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from omh_planted import planted_items, ragged
    rng = np.random.default_rng(41)
    items = planted_items()
    for n in (1, 1023, 1024, 1025, 8192, 8193, 20000):
        km = rng.integers(0, 1 << 40, n, dtype=np.uint64)
        items.append((km, rng.integers(0, 4, n).astype(np.int64),
                      rng.random(n) > 0.1))
    km, occ, va, off = ragged(items)
    return [torch.from_numpy(x).to(card) for x in (
        km.view(np.int64), occ, va, off)]


@pytest.mark.parametrize("m", [1, 7, 130, 1024])
def test_omh_kernel_matches_plain(card, m):
    """csrc/omh.cu against omh_registers_plain, bit for bit: planted f64
    ties, keys rounding to 2^64, phantoms before and after a real winner
    at position 0, one and no valid window, and streams of 1 to 20000
    positions; m not a multiple of the 128-register tile; with the piece
    table built by the wrapper and prebuilt from host offsets."""
    from dashing2_tpu_torch.ops import omh as OP
    args = _omh_streams(card)
    before = OP.launches.launches
    got = OP.omh_registers(*args, m, 2)
    pre = OP.omh_registers(*args, m, 2, pieces=OP.piece_table(
        args[3].cpu().numpy(), args[0].device))
    torch.cuda.synchronize()
    assert OP.launches.launches == before + 2
    want = OP.omh_registers_plain(*args, m, 2)
    assert torch.equal(got, want) and torch.equal(pre, want)


@pytest.mark.parametrize("ell", [1, 3])
def test_omh_kernel_refuses_other_depths(card, ell):
    """The kernel is built for ell = 2 only: another depth raises before
    any launch."""
    from dashing2_tpu_torch.ops import omh as OP
    args = _omh_streams(card)
    before = OP.launches.launches
    with pytest.raises(ValueError, match="ell"):
        OP.omh_registers(*args, 7, ell)
    assert OP.launches.launches == before


def test_omh_sketch_on_card_equals_cpu(card):
    """sketch/omh.py's streams (k-mers and occurrence ranks in torch on
    the card) and registers: the CPU's."""
    from dashing2_tpu_torch.io.corpus import edited_sequences
    from dashing2_tpu_torch.enums import Alphabet
    from dashing2_tpu_torch.ops.kmers import encode_ascii
    from dashing2_tpu_torch.sketch import omh as PO
    recs = edited_sequences(43, 6, 4, length=(10, 3000), n_every=3,
                            polya_every=4)
    codes = [encode_ascii(s, Alphabet.DNA) for _, s in recs]
    np.testing.assert_array_equal(
        PO.omh_sketch_many(codes, 15, 200, device=card),
        PO.omh_sketch_many(codes, 15, 200, device="cpu"))


@pytest.mark.parametrize("flags", [
    [], ["--fastcmp", "0.5"], ["--fastcmp", "1"],
    ["--compute-edit-distance", "--topk", "3"], ["--greedy", "0.3f"]])
def test_edit_distance_cli_on_card_equals_cpu(card, tmp_path, flags):
    """`sketch -E --parse-by-seq` jobs with the registers drawn and
    compared on the card: the CPU run's bytes."""
    from dashing2_tpu_torch import cli
    from dashing2_tpu_torch.io.corpus import edited_sequences, write_fasta
    fa = write_fasta(str(tmp_path / "s.fa"), edited_sequences(
        47, 10, 8, length=(200, 900)))
    outs = []
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"o-{dev}"
        assert cli.main(["sketch", "-E", "--parse-by-seq", "-k", "15", "-S",
                         "256", "--binary-output", "--cmpout", str(out)]
                        + flags + [fa, "--device", dev]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0]


# ----------------------------------------------------------------------
# oph_rows: csrc/oph_rows.cu against oph_rows_plain
# ----------------------------------------------------------------------

# (options, alphabet letters): every encoding `oph_rows.encoding` selects
OPH_CONFIGS = {
    "dna-k31": (dict(k=31), "ACGT"),
    "dna-k15-noncanonical": (dict(k=15, canonicalize=False), "ACGT"),
    "mini-21-31": (dict(k=21, w=31), "ACGT"),
    "mini-4-12": (dict(k=4, w=12), "ACGT"),
    "mini-wide": (dict(k=21, w=3000), "ACGT"),   # shared memory > 48 KB
    "protein-k7": (dict(k=7, alphabet="PROTEIN"), "ACDEFGHIKLMNPQRSTVWY"),
    "protein3bit-k12-w20": (dict(k=12, w=20, alphabet="PROTEIN_3BIT"),
                            "ACDEFGHIKLMNPQRSTVWY"),
    "dna2-k40": (dict(k=40, alphabet="DNA2"), "ACGT"),
    "spaced": (dict(k=11, spacing="0,2,0,1,0x5,3"), "ACGT"),
    "spaced-w30": (dict(k=11, w=30, spacing="1x10"), "ACGT"),
    "spaced-protein14": (dict(k=5, spacing="1,0,2,1",
                              alphabet="PROTEIN_14"),
                         "ACDEFGHIKLMNPQRSTVWY"),
    "roll-48": (dict(k=48), "ACGT"),
    "roll-80-noncanonical": (dict(k=80, canonicalize=False), "ACGT"),
    "roll-40-w60": (dict(k=40, w=60), "ACGT"),
    "roll-protein20-k30": (dict(k=30, alphabet="PROTEIN20"),
                           "ACDEFGHIKLMNPQRSTVWY"),
    "u128-k40": (dict(k=40, use128=True), "ACGT"),
    "u128-k63-w80": (dict(k=63, w=80, use128=True), "ACGT"),
    "ds": (dict(k=31, kmer_downsample_frac=0.3), "ACGT"),
    "filterset": (dict(k=21, w=25), "ACGT"),
}


def _oph_rows_case(cfg, seed=0, R=23, L=5000, m=100):
    """(codes, row items, n items, m, hkw, filterset) on the CPU: rows of
    random letters of the alphabet with N runs, a short row, a row of
    INVALID and a skipped row (-1), the items 0..6 in several rows each."""
    from dashing2_tpu_torch.config import Dashing2Options
    from dashing2_tpu_torch.enums import Alphabet
    from dashing2_tpu_torch.ops import kmers as K
    from dashing2_tpu_torch.sketch import core as PC
    kw, letters = OPH_CONFIGS[cfg]
    kw = dict(kw)
    if "alphabet" in kw:
        kw["alphabet"] = Alphabet[kw["alphabet"]]
    opts = Dashing2Options(sketchsize=m, **kw)
    rng = np.random.default_rng(seed)
    seqs = rng.choice(np.frombuffer(letters.encode(), np.uint8), (R, L))
    for r in range(0, R, 3):
        at = int(rng.integers(0, L - 100))
        seqs[r, at:at + int(rng.integers(1, 100))] = ord("N")
    codes = K.encode_ascii(seqs.reshape(-1).tobytes(),
                           opts.alphabet).reshape(R, L)
    codes[1, 60:] = K.INVALID
    codes[2] = K.INVALID
    item = (np.arange(R) % 7).astype(np.int32)
    item[5] = -1
    hkw = PC._hash_kwargs(opts, L - 400)
    fs = None
    if cfg == "filterset":
        hashed, valid = PC.OR.hash_chunk_batch(torch.from_numpy(codes), hkw)
        hv = np.unique(hashed[valid].numpy().view(np.uint64))
        fs = torch.from_numpy(np.sort(rng.choice(hv, len(hv) // 3,
                                                 replace=False))
                              .view(np.int64))
    return (torch.from_numpy(codes), torch.from_numpy(item), 7, m, hkw, fs)


# rows the kernel's schedule treats apart: (config, m, how the rows are
# changed); every case also runs with counts
OPH_EDGES = {
    # every row padding: each block leaves after its one ballot
    "all-padding": ("dna-k31", 100, "pad"),
    # valid stretches shorter than k, one of k exactly, N runs a base apart
    "short-stretch": ("dna-k31", 100, "short"),
    # m not a power of two: the bucket's % path
    "m-1000": ("dna-k31", 1000, None),
    "m-1000-roll": ("roll-48", 1000, None),
    # m above the shared bucket-min: the tested global atomicMin
    "m-32768": ("dna-k31", 32768, None),
    "m-32768-mini": ("mini-21-31", 32768, None),
    # a filterset with counts (and minimizers)
    "filterset-counts": ("filterset", 1000, None),
    # tests/seq_planted.py's rows: equal scores (a homopolymer, tandem
    # repeats of period 5 and nwin) and N runs of 1 to nwin bases, with
    # minimizers in three encodings
    "planted-mini": ("mini-21-31", 100, "planted"),
    "planted-roll": ("roll-40-w60", 100, "planted"),
    "planted-u128": ("u128-k63-w80", 100, "planted"),
    # rows of many segments of the window stage
    "long-rows": ("mini-21-31", 100, "long"),
}


def _oph_edge_case(case):
    from seq_planted import planted_rows
    cfg, m, how = OPH_EDGES[case]
    if how == "planted":
        L = 5000
        nwin = OPH_CONFIGS[cfg][0]["w"] - OPH_CONFIGS[cfg][0]["k"] + 1
        rows = planted_rows(L, 4, nwin, seed=len(case))
        codes, item, n, _, hkw, fs = _oph_rows_case(
            cfg, m=m, R=6 + rows.shape[0], L=L)
        codes[6:] = torch.from_numpy(rows)
        return codes, item, n, m, hkw, fs
    codes, item, n, _, hkw, fs = (_oph_rows_case(cfg, m=m, R=6, L=60000)
                                  if how == "long"
                                  else _oph_rows_case(cfg, m=m))
    if how == "pad":
        codes[:] = 0xFF
    elif how == "short":
        codes[:] = 0xFF
        for r in range(codes.shape[0]):
            at = 100 + 37 * r
            codes[r, at:at + 30] = r % 4            # 30 bases: no 31-mer
            codes[r, at + 300:at + 331] = (r + 1) % 4   # one 31-mer
            codes[r, 900:2000:2] = 2                # N a base apart
    return codes, item, n, m, hkw, fs


@pytest.mark.parametrize("want_counts", [True, False])
@pytest.mark.parametrize("cfg", sorted(OPH_CONFIGS) + sorted(OPH_EDGES))
def test_oph_rows_kernel_matches_plain(card, cfg, want_counts):
    """csrc/oph_rows.cu == oph_rows_plain (registers and counts) in each
    encoding, with minimizers, downsampling and a filterset: N runs,
    rows shorter than k and all INVALID, a skipped row, items over
    several rows, m not a power of two; and the edge rows of OPH_EDGES,
    which take the tested global atomicMin above SMEM_BUCKETS_MAX_M."""
    from dashing2_tpu_torch.ops import oph_rows as OR
    codes, item, n, m, hkw, fs = (_oph_edge_case(cfg) if cfg in OPH_EDGES
                                  else _oph_rows_case(cfg))
    assert OR.use_smem_buckets(m) is not cfg.startswith("m-32768")
    dev = [x.to(card) if x is not None else None for x in (codes, item, fs)]
    want_r, want_c = OR.oph_rows_plain(dev[0], dev[1], n, m, hkw, dev[2],
                                       want_counts)
    before = OR.launches.launches
    got_r, got_c = OR.oph_rows(dev[0], dev[1], n, m, hkw, dev[2],
                               want_counts)
    torch.cuda.synchronize()
    assert OR.launches.launches == before + 1
    assert torch.equal(got_r, want_r)
    assert (got_c is None) == (not want_counts)
    if want_counts:
        assert torch.equal(got_c, want_c)
    if cfg == "all-padding":
        assert (got_r == -1).all()
    else:
        assert (got_r != -1).sum() > 16


def test_oph_rows_on_card_equals_cpu(card):
    """The plain version on the card == the plain version on the CPU."""
    from dashing2_tpu_torch.ops import oph_rows as OR
    codes, item, n, m, hkw, fs = _oph_rows_case("mini-21-31", seed=3)
    cpu = OR.oph_rows_plain(codes, item, n, m, hkw, fs, True)
    got = OR.oph_rows_plain(codes.to(card), item.to(card), n, m, hkw, None,
                            True)
    assert torch.equal(got[0].cpu(), cpu[0])
    assert torch.equal(got[1].cpu(), cpu[1])


# ----------------------------------------------------------------------
# hash_rows: csrc/oph_rows.cu's hash-stream entry against its plain
# versions (hash_chunk_batch, hash_chunk_batch128)
# ----------------------------------------------------------------------

# (config, full 128-bit keys, zero seed, downsample and filterset): every
# encoding of OPH_CONFIGS with the low word, its edge rows, and the
# 128-bit code's full keys with and without a seed, minimizers,
# downsampling and a filterset of low words
HASH_CASES = ([(cfg, False, False, False) for cfg in sorted(OPH_CONFIGS)]
              + [("all-padding", False, False, False),
                 ("short-stretch", False, False, False),
                 ("dna-k31", False, True, False),
                 ("u128-k40", True, False, False),
                 ("u128-k40", True, True, False),
                 ("u128-k63-w80", True, False, False),
                 ("u128-k63-w80", True, True, True),
                 ("u128-k40", True, False, True),
                 ("planted-mini", False, False, False),
                 ("planted-mini", False, False, True),
                 ("planted-roll", False, False, False),
                 ("planted-u128", True, False, False),
                 ("planted-u128", False, True, False),
                 ("long-rows", False, False, False)])
# the staged blocks' geometry: ops/oph_rows.py `geometry` (four blocks
# an SM), the longest runs a block alone fits, and runs of 12 (segments
# of 1,536 less the halos: many a row)
HASH_GEOMETRIES = ("default", "alone", "short")


def _force_geometry(monkeypatch, how):
    from dashing2_tpu_torch.ops import oph_rows as OR
    if how == "alone":
        monkeypatch.setattr(OR, "SHARES", (1,))
    elif how == "short":
        real = OR.geometry

        def short(span, nwin, m, words=1, stream=False):
            h = nwin - 1 if nwin > 1 else 0
            if not (nwin > 1 or stream) or OR.THREADS * 12 <= 2 * h:
                return real(span, nwin, m, words, stream)
            seg = OR.THREADS * 12 - 2 * h
            return 12, seg, OR.smem_bytes(seg, span, nwin, m, words, stream)
        monkeypatch.setattr(OR, "geometry", short)


def _hash_case(cfg, zero_seed, masks):
    """(codes, hkw, filterset) of a HASH_CASES row, on the CPU."""
    from dashing2_tpu_torch.ops import oph_rows as OR
    codes, _, _, _, hkw, fs = (_oph_edge_case(cfg) if cfg in OPH_EDGES
                               else _oph_rows_case(cfg))
    hkw = dict(hkw, seed_is_zero=zero_seed)
    if masks:
        hkw["downsample_threshold"] = int(0.4 * (1 << 64))
        lo, _ = OR.hash_chunk_batch(codes, hkw)
        hv = np.unique(lo.numpy().reshape(-1).view(np.uint64))
        fs = torch.from_numpy(hv[::5].copy().view(np.int64))
    return codes, hkw, fs


@pytest.mark.parametrize("geometry", HASH_GEOMETRIES)
@pytest.mark.parametrize("cfg,full,zero_seed,masks", HASH_CASES)
def test_hash_rows_kernel_matches_plain(card, monkeypatch, cfg, full,
                                        zero_seed, masks, geometry):
    """csrc/oph_rows.cu `hash_rows` == hash_rows_plain bit for bit: the
    kept tokens in row order, the high words of full keys and the rows'
    counts, at each segment length of HASH_GEOMETRIES; two launches (the
    tokens, their placement)."""
    from dashing2_tpu_torch.config import Dashing2Options
    from dashing2_tpu_torch.ops import oph_rows as OR
    _force_geometry(monkeypatch, geometry)
    codes, hkw, fs = _hash_case(cfg, zero_seed, masks)
    x2 = Dashing2Options(seedseed=7).xormask2_hi if full else None
    dev = [x.to(card) if x is not None else None for x in (codes, fs)]
    want = OR.hash_rows_plain(dev[0], hkw, dev[1], x2)
    before = OR.hash_launches.launches
    got = OR.hash_rows(dev[0], hkw, dev[1], x2)
    torch.cuda.synchronize()
    assert OR.hash_launches.launches == before + 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert (got[1] is None) == (not full)
    if full:
        assert torch.equal(got[1], want[1])
    assert (int(got[2].sum()) == 0) == (cfg == "all-padding")


@pytest.mark.parametrize("full", [False, True])
def test_hash_rows_overflowing_slab_runs_again(card, monkeypatch, full):
    """A batch whose tokens pass the slab's capacity (here 5 tokens) runs
    both launches again with room for all: == plain, four launches."""
    from dashing2_tpu_torch.config import Dashing2Options
    from dashing2_tpu_torch.ops import oph_rows as OR
    monkeypatch.setattr(OR, "token_capacity", lambda p: 5)
    codes, hkw, _ = _hash_case("u128-k63-w80" if full else "mini-21-31",
                               False, False)
    x2 = Dashing2Options(seedseed=7).xormask2_hi if full else None
    want = OR.hash_rows_plain(codes.to(card), hkw, None, x2)
    before = OR.hash_launches.launches
    got = OR.hash_rows(codes.to(card), hkw, None, x2)
    assert OR.hash_launches.launches == before + 4
    for g, w in zip(got, want):
        assert (g is None) == (w is None) and (g is None or torch.equal(g, w))


def test_hash_rows_allocates_no_dense_array(card):
    """The card route of hash_rows holds no (R, npos) array: across one
    call on 256 rows of 20,000 random bases (k = 15, w = 31) the peak of
    allocated device memory stays under 8 bytes x (4 kept tokens + 3 a
    row segment + 1 a row) + 1 MiB, where one (R, npos) int64 array
    alone is about 9 kept tokens' bytes."""
    from dashing2_tpu_torch.config import Dashing2Options
    from dashing2_tpu_torch.ops import oph_rows as OR
    from dashing2_tpu_torch.sketch import core as PC
    R, L = 256, 20000
    opts = Dashing2Options(k=15, w=31)
    hkw = PC._hash_kwargs(opts, L - 100)
    rng = np.random.default_rng(5)
    codes = torch.from_numpy(rng.integers(0, 4, (R, L)).astype(np.uint8)
                             ).to(card)
    params = OR.kernel_params(hkw, R, L, 0, 0)
    nseg = OR.segments(params)
    OR.hash_rows(codes, hkw)                  # build and warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = OR.hash_rows(codes, hkw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    kept = int(got[2].sum())
    dense = 8 * R * (L - 15 + 1)
    assert kept > R * (L - 100) // 20
    assert peak <= 8 * (4 * kept + 3 * R * nseg + R) + (1 << 20) < dense
    want = OR.hash_rows_plain(codes, hkw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])


def test_hash_rows_refuses_full_keys_outside_dna128(card):
    from dashing2_tpu_torch.ops import oph_rows as OR
    codes, hkw, _ = _hash_case("dna-k31", False, False)
    with pytest.raises(ValueError, match="128-bit"):
        OR.hash_rows(codes.to(card), hkw, None, 123)


@pytest.mark.parametrize("flags", [
    ["--seq", "-k", "15", "-w", "31"],
    ["--seq", "-k", "15", "-w", "31", "--hp-compress", "--parse-by-seq"],
    ["--seq", "--long-kmers", "-k", "40", "-w", "60", "--parse-by-seq"],
    ["--seq", "-k", "15", "-w", "31", "--parse-by-seq", "--topk", "3"],
    ["--set", "--long-kmers", "-k", "40", "--parse-by-seq"],
    ["--countdict", "--long-kmers", "-k", "40", "--parse-by-seq",
     "--topk", "3"]])
def test_seq_and_u128_cli_on_card_equals_cpu(card, tmp_path, flags):
    """--seq (hash_rows on the card) and u128 exact sets (their joins on
    the card): the CPU run's bytes (the comparison, and -o of --seq)."""
    from dashing2_tpu_torch import cli
    from dashing2_tpu_torch.io.corpus import edited_sequences, write_fasta
    fa = write_fasta(str(tmp_path / "s.fa"), edited_sequences(
        54, 6, 6, length=(200, 5000), n_every=3))
    outs = []
    for dev in ("cuda", "cpu"):
        out, sig = tmp_path / f"o-{dev}", tmp_path / f"s-{dev}"
        extra = ["-o", str(sig)] if "--seq" in flags else []
        before = _hash_launches()
        assert cli.main(["sketch", "--binary-output", "--cmpout", str(out)]
                        + extra + flags + [fa, "--device", dev]) == 0
        assert (_hash_launches() > before) == (dev == "cuda"
                                            and "--seq" in flags)
        outs.append(out.read_bytes()
                    + (sig.read_bytes() if extra else b""))
    assert outs[0] == outs[1] and outs[0]


def _hash_launches() -> int:
    from dashing2_tpu_torch.ops import oph_rows as OR
    return OR.hash_launches.launches


@pytest.mark.parametrize("flags", [
    ["--parse-by-seq"], ["--parse-by-seq", "--fastcmp", "0.5", "--bbit-sigs"],
    ["--parse-by-seq", "-w", "40"], ["--by-chrom"], ["--parse-by-seq", "-B"]])
def test_chunked_cli_on_card_equals_cpu(card, tmp_path, flags):
    """The chunked route's jobs with the registers on the card: the CPU
    run's bytes (the comparison and -o with -s and -N)."""
    from dashing2_tpu_torch import cli
    from dashing2_tpu_torch.io.corpus import edited_sequences, write_fasta
    fa = write_fasta(str(tmp_path / "s.fa"), edited_sequences(
        53, 10, 8, length=(200, 9000), n_every=3))
    outs = []
    for dev in ("cuda", "cpu"):
        out, sig = tmp_path / f"o-{dev}", tmp_path / f"s-{dev}"
        assert cli.main(["sketch", "-k", "21", "-S", "256",
                         "--binary-output", "--cmpout", str(out), "-o",
                         str(sig)] + (["-s", "-N"] if "-B" not in flags
                                      else []) + flags
                        + [fa, fa, "--device", dev]) == 0
        outs.append(out.read_bytes() + sig.read_bytes())
    assert outs[0] == outs[1] and outs[0]


def _css_rows(m: int, seed: int, card):
    """(sx1, srv, k, threshold) on the card: six items as css_sketch_many
    orders them (x1 ascending, +inf past an item's hashes), with equal
    rows planted (equal draws), caps below the width, thresholds that
    keep every row, cut inside the rows or keep none, and one item of
    one row; then tests/css_planted.py's seven items (equal rows across
    and within the kernel's 32-row steps, own-row hits on a step's first
    and last lane, caps of 0, 1, 33 and 95), padded to the width."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from css_planted import planted_rows
    from dashing2_tpu_torch.ops import sketch_kernels as SK
    rng = np.random.default_rng(seed)
    width = 1500
    sx1 = torch.full((6, width), torch.inf, dtype=torch.float64)
    srv = torch.zeros((6, width), dtype=torch.int64)
    for i, n in enumerate((width, 1400, 900, 1200, 1, 700)):
        h = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        h[7:30] = h[0]
        x1, rv = SK._css_x1(torch.from_numpy(h.view(np.int64)), m)
        s, perm = torch.sort(x1, stable=True)
        sx1[i, :n], srv[i, :n] = s, rv[perm]
    k = torch.tensor([width, 1400, 300, 1000, 1, 700])
    base = (np.log(m) + 8.0) / width
    t = torch.tensor([1e300, base, base / 4.0, float(sx1[3, 511]),
                      1e300, float(sx1[5, 0]) / 2.0], dtype=torch.float64)
    (px1, prv, pk, pt), _ = planted_rows(m, seed)
    pad = width - px1.shape[1]
    sx1 = torch.cat([sx1, torch.nn.functional.pad(px1, (0, pad),
                                                  value=torch.inf)])
    srv = torch.cat([srv, torch.nn.functional.pad(prv, (0, pad))])
    return [x.to(card) for x in (sx1, srv, torch.cat([k, pk]),
                                 torch.cat([t, pt]))]


@pytest.mark.parametrize("m", [1, 7, 33, 64, 127, 128, 130, 1024, 4096])
def test_css_kernel_matches_plain(card, m):
    """csrc/css.cu against its plain version and the early-exit walk on
    the card: registers, cutoffs and winners bit for bit; one launch."""
    from dashing2_tpu_torch.ops import css as CSS
    args = _css_rows(m, m, card)
    before = CSS.launches.launches
    got = CSS.css_pass(*args, m, return_ids=True)
    torch.cuda.synchronize()
    assert CSS.launches.launches == before + 1
    want = CSS.css_pass_plain(*args, m, return_ids=True)
    walk = CSS.css_walk_plain(*args, m)
    for g, w, v in zip(got, want, walk):
        assert torch.equal(g.view(torch.int64) if g.is_floating_point()
                           else g, w.view(torch.int64)
                           if w.is_floating_point() else w)
        assert torch.equal(w, v)
    regs, tcut = CSS.css_pass(*args, m)
    assert torch.equal(regs, got[0]) and torch.equal(tcut, got[1])
    cpu = CSS.css_pass(*[a.cpu() for a in args], m, return_ids=True)
    for g, c in zip(got, cpu):
        assert torch.equal(g.cpu(), c)


def test_css_kernel_past_the_staged_rows(card):
    """A block stages the own registers of an item's first 12,256 rows
    in shared memory; rows past them compute theirs in the walk. Two
    items of 14,000 random hashes, every row kept, at m = 8192 (about a
    fifth of the walks pass row 12,256): registers, cutoffs and winners
    == plain bit for bit, and some winners lie past the staged rows."""
    from dashing2_tpu_torch.ops import css as CSS
    from dashing2_tpu_torch.ops import sketch_kernels as SK
    m, n = 8192, 14000
    rng = np.random.default_rng(8)
    h = rng.integers(0, 1 << 64, (2, n), dtype=np.uint64)
    x1, rv = SK._css_x1(torch.from_numpy(h.view(np.int64)).to(card), m)
    sx1, perm = torch.sort(x1, dim=1, stable=True)
    args = [sx1, torch.gather(rv, 1, perm).contiguous(),
            torch.full((2,), n, dtype=torch.int64, device=card),
            torch.full((2,), 1e300, dtype=torch.float64, device=card)]
    got = CSS.css_pass(*args, m, return_ids=True)
    want = CSS.css_pass_plain(*args, m, return_ids=True)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int64) if g.is_floating_point()
                           else g, w.view(torch.int64)
                           if w.is_floating_point() else w)
    assert int((got[2] >= 12256).sum()) > 0


def test_css_sketch_many_launches_the_kernel(card):
    """css_sketch_many on the card goes through csrc/css.cu (one launch a
    pass), with the CPU's registers, passes and winners."""
    from dashing2_tpu_torch.ops import css as CSS
    from dashing2_tpu_torch.ops import sketch_kernels as SK
    rng = np.random.default_rng(3)
    items = [rng.integers(0, 1 << 64, n, dtype=np.uint64)
             for n in (1, 40, 7000, 30000)]
    before = CSS.launches.launches
    got = SK.css_sketch_many(items, 256, card, return_ids=True)
    assert CSS.launches.launches > before
    want = SK.css_sketch_many(items, 256, "cpu", return_ids=True)
    np.testing.assert_array_equal(got[0].view(np.int64),
                                  want[0].view(np.int64))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def _countsketch_cases():
    from countsketch_planted import planted_batches
    return planted_batches()


@pytest.mark.parametrize("case", range(13))
def test_countsketch_kernel_matches_plain(card, case):
    """csrc/countsketch.cu against its plain version on
    tests/countsketch_planted.py's batches (a repeated hash in a dense and
    a sparse bin, sums cancelling on a bin's edges, a ragged last bin,
    streams either side of each form's threshold, ranges that split,
    empty streams among random ones): every stream's count and non-zero
    buckets exactly; one launch a batch."""
    from dashing2_tpu_torch.ops import countsketch as CS
    cases = _countsketch_cases()
    assert len(cases) == 13
    name, streams, cssize = cases[case]
    offsets = np.zeros(len(streams) + 1, np.int64)
    np.cumsum([len(x) for x in streams], out=offsets[1:])
    hv = torch.from_numpy(np.concatenate(streams).view(np.int64))
    off = torch.from_numpy(offsets)
    before = CS.launches.launches
    out, counts = CS.countsketch_batch(hv.to(card), off, cssize)
    torch.cuda.synchronize()
    assert CS.launches.launches == before + 1, name
    want, want_counts = CS.countsketch_batch_plain(hv, off, cssize)
    assert torch.equal(counts.cpu(), want_counts), name
    k = int(want_counts.sum())
    assert torch.equal(out[:k].cpu(), want[:k]), name
    # the same on the card's plain version, and through countsketch_many
    pout, pcounts = CS.countsketch_batch_plain(hv.to(card), off, cssize)
    assert torch.equal(pcounts.cpu(), want_counts)
    assert torch.equal(pout[:k].cpu(), want[:k])
    got = CS.countsketch_many(streams, cssize, card)
    cpu = CS.countsketch_many(streams, cssize, "cpu")
    for (a, b), (c, d) in zip(got, cpu):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_countsketch_kernel_refusals(card):
    """A launch with a bad argument raises before the kernel runs: offsets
    on the card or not rising from 0 to n, a bucket count out of [1,
    2^31), int32 hashes; an all-empty batch launches and counts zeros."""
    from dashing2_tpu_torch.ops import countsketch as CS
    hv = torch.arange(10, dtype=torch.int64, device=card)
    with pytest.raises(TypeError, match="offsets"):
        CS.countsketch_batch(hv, torch.tensor([0, 10], device=card), 7)
    with pytest.raises(ValueError, match="offsets"):
        CS.countsketch_batch(hv, torch.tensor([0, 11]), 7)
    for cssize in (0, 1 << 31):
        with pytest.raises(ValueError, match="cssize"):
            CS.countsketch_batch(hv, torch.tensor([0, 10]), cssize)
    with pytest.raises(TypeError):
        CS.countsketch_batch(hv.to(torch.int32), torch.tensor([0, 10]), 7)
    out, counts = CS.countsketch_batch(hv[:0], torch.zeros(4,
                                                           dtype=torch.int64),
                                       7)
    assert counts.tolist() == [0, 0, 0] and out.shape == (0, 2)


def test_cache_cli_on_card_equals_cpu(card, tmp_path):
    """`--cache --outprefix` on the card: the cold run writes the CPU
    run's artifacts and bytes (the FullSetSketch registers from
    csrc/css.cu, the -P -c buckets from csrc/countsketch.cu), and a warm
    run launches neither kernel."""
    from dashing2_tpu_torch import cli
    from dashing2_tpu_torch.io.corpus import write_corpus
    from dashing2_tpu_torch.ops import countsketch as CS
    from dashing2_tpu_torch.ops import css as CSS
    paths = write_corpus(str(tmp_path / "fa"), seed=12, n_ancestors=3,
                         n_mutants=4, length=3000)
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    for tag, flags in (("fss", ["--full-setsketch"]),
                       ("pmh", ["-P", "-c", "4096"]),
                       ("set", ["--set"])):
        outs, files = [], []
        for dev in ("cuda", "cpu", "cuda"):
            d = tmp_path / f"{tag}-{dev}"
            d.mkdir(exist_ok=True)
            out = tmp_path / f"{tag}-{dev}.bin"
            CSS.launches.reset_launches()
            CS.launches.reset_launches()
            assert cli.main(["sketch", "-k", "21", "-S", "128"] + flags + [
                "--cache", "--outprefix", str(d), "--binary-output",
                "--cmpout", str(out), "-F", str(lst), "--device",
                dev]) == 0
            outs.append(out.read_bytes())
            files.append({f: (d / f).read_bytes()
                          for f in sorted(os.listdir(d))})
            if dev == "cuda" and len(outs) == 1:
                assert CSS.launches.launches > 0 or tag != "fss"
                assert CS.launches.launches > 0 or tag != "pmh"
        # the third run is warm: nothing drawn
        assert CSS.launches.launches == CS.launches.launches == 0
        assert outs[0] == outs[1] == outs[2], tag
        assert files[0] == files[1] == files[2] and files[0], tag
