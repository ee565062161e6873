"""Card-only tests of the port: the CUDA kernel against its plain PyTorch
version, and the CUDA route of the comparison against the CPU route.

Marked `cuda`; each skips without a card. This file imports neither jax
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dashing2_tpu_torch.cmp import core as C
from dashing2_tpu_torch.config import Dashing2DistOptions
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


@pytest.mark.parametrize("m", [30, 64, 1024])
@pytest.mark.parametrize("n", [1, 2, 63, 129, 1025])
def test_kernel_matches_plain(card, n, m):
    a = torch.from_numpy(_packed(n, m, seed=n + m)).to(card)
    before = NT.launches
    got = NT.tri_eq_counts(a, m)
    assert NT.launches == before + 1
    want = NT.tri_eq_counts_plain(a, m)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint16 and got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
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


@pytest.mark.parametrize("upper_only", [False, True])
def test_pairwise_matrix_cuda_equals_cpu(card, upper_only):
    n, m = 300, 256
    rng = np.random.default_rng(5)
    sigs = rng.random((n, m))
    sigs[7] = sigs[3]
    sigs[11, ::5] = 0.0           # empty registers: densified
    opts = Dashing2DistOptions(k=31, sketchsize=m, fd_level=0.5,
                               truncation_method=1)

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
