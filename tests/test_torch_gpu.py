"""Tests of the PyTorch port that need an NVIDIA GPU (marker `gpu`); they
skip on a host without one. Run them on the card, where JAX is not
installed, without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from rnb_neus2_torch.config import HashGridConfig
from rnb_neus2_torch.kernels import hash_grad_small as hgs
from rnb_neus2_torch.kernels import scatter_add as sca
from rnb_neus2_torch.ops import hash_encoding as he
from rnb_neus2_torch.tools import bench_scatter as bench

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,S", [(1 << 21, 4096), (1 << 21, 13824),
                                 (12345, 13824), (1, 4096), (0, 4096),
                                 (1 << 21, 32768), (12345, 29792)])
def test_kernel_matches_plain(cuda, n, S):
    """Float atomics sum in another order: max abs error ≤ 1e-5·(1 + max
    |plain|). Rows that no element touches are exactly 0.0 in both; a
    touched entry whose terms cancel may come out 0.0 in one order and not
    in another. S = 29,792 and 32,768 are over one block's shared memory
    and take one copy of the histogram per 2 blocks of a cluster."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n + S)
    idx = torch.randint(-S // 50, S + S // 50, (n,), generator=gen,
                        device=cuda, dtype=torch.int32)
    idx = torch.where(idx % 5 == 0, idx + 1, idx)
    cf = torch.randn(n, 2, generator=gen, device=cuda)
    before = hgs.launches
    got = hgs.grad_small(idx, cf, S)
    assert hgs.launches == before + (1 if n else 0)
    want = hgs.plain(idx, cf, S)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-5 * (1 + want.abs().max())
    keep = (idx >= 0) & (idx < S)
    untouched = torch.bincount(idx[keep], minlength=S) == 0
    assert untouched.sum() >= S // 5
    assert (got[untouched] == 0).all() and (want[untouched] == 0).all()


def test_kernel_refuses_what_it_cannot_take(cuda):
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    cf = torch.zeros(4, 2, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        hgs.grad_small(idx, torch.zeros(4, 60000, device=cuda), 16)
    with pytest.raises(ValueError, match="shared memory"):
        hgs.grad_small(idx, cf, 1 << 19)
    with pytest.raises(ValueError, match="contiguous"):
        hgs.grad_small(idx, torch.zeros(2, 4, device=cuda).T, 16)
    with pytest.raises(ValueError):
        hgs.grad_small(idx, cf.cpu(), 16)


def test_encode_backward_on_card_matches_cpu(cuda):
    """The training encode's table gradient on the card (levels 0-1 through
    the kernel) against the CPU's plain scatters."""
    static = he.HashGridStatic(HashGridConfig(n_levels=4,
                                              top_resolution=64))
    assert list(he.levels_through_kernel(static)) == [0, 1]
    gen = torch.Generator()
    gen.manual_seed(0)
    x = torch.rand(4096, 3, generator=gen)
    table = torch.randn(static.n_entries, 2, generator=gen) * 1e-2
    cot = torch.randn(4096, static.cfg.output_dim, generator=gen)
    grads = []
    for d in ("cpu", cuda):
        t = table.to(d).requires_grad_(True)
        f, j = he.make_encode_with_jacobian_cv(static)(t, x.to(d), 3)
        loss = (f * cot.to(d)).sum() + sum((jd * cot.to(d)).sum() for jd in j)
        grads.append(torch.autograd.grad(loss, t)[0].cpu())
    scale = grads[0].abs().max()
    assert (grads[0] - grads[1]).abs().max() <= 1e-5 * scale
    assert torch.equal(grads[0] == 0, grads[1] == 0)


@pytest.mark.parametrize("n,S,F", [(1 << 18, 1 << 19, 2), (1 << 18, 39304, 2),
                                   (1 << 18, 373248, 2), (1 << 21, 1 << 19, 2),
                                   (12345, 125000, 2), (1, 4096, 2),
                                   (0, 4096, 2), (1 << 18, 1 << 19, 1),
                                   (5000, 1000, 3)])
def test_scatter_add_matches_plain(cuda, n, S, F):
    """The global-atomics kernel at the main path's shapes (one hashed or
    dense level of a K = 1 step, n = 2^18; the exact backward's 2^21),
    ragged and empty inputs, F = 1 and 3, indices outside [0, S): the
    tolerance and the exact zeros of `test_kernel_matches_plain`."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n + S + F)
    idx = torch.randint(-S // 50, S + S // 50, (n,), generator=gen,
                        device=cuda, dtype=torch.int32)
    idx = torch.where(idx % 5 == 0, idx + 1, idx)
    v = torch.randn(n, F, generator=gen, device=cuda)
    before = sca.launches
    got = sca.scatter_add(idx, v, S)
    assert sca.launches == before + (1 if n else 0)
    want = sca.plain(idx, v, S)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (S, F)
    assert (got - want).abs().max() <= 1e-5 * (1 + want.abs().max())
    keep = (idx >= 0) & (idx < S)
    untouched = torch.bincount(idx[keep], minlength=S) == 0
    assert untouched.sum() >= S // 5
    assert (got[untouched] == 0).all() and (want[untouched] == 0).all()


def test_scatter_add_with_a_padded_hot_row(cuda):
    """Half the elements on one row with zero values, as the padded slots
    of a training batch give: the kernel skips the zeros, and the result is
    still the plain version's (the hot row only gets the non-zero
    values)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    n, S = 1 << 18, 1 << 19
    idx = torch.randint(0, S, (n,), generator=gen, device=cuda,
                        dtype=torch.int32)
    v = torch.randn(n, 2, generator=gen, device=cuda)
    pad = torch.arange(n, device=cuda) >= n // 2
    idx[pad] = 12345
    v[pad] = 0.0
    v[n // 2 - 3:n // 2, :] = -0.0
    got = sca.scatter_add(idx, v, S)
    want = sca.plain(idx, v, S)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-5 * (1 + want.abs().max())
    assert torch.equal(got == 0, want == 0)
    assert not torch.signbit(got[got == 0]).any()


def test_scatter_add_refuses_what_it_cannot_take(cuda):
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sca.scatter_add(idx, torch.zeros(2, 4, device=cuda).T, 16)
    with pytest.raises(ValueError):
        sca.scatter_add(idx, torch.zeros(4, 2), 16)


@pytest.mark.parametrize("k", [1, 2])
def test_stochastic_backward_on_card_matches_cpu(cuda, k):
    """The default config's K-corner backward on the card (levels 0-1
    through the shared-memory kernel, 2-13 through the global-atomics one)
    against the CPU's plain scatters: every sample picks the same corner at
    every level, the table gradients agree within 1e-5 of the largest
    entry, and every entry that no pick touches is exactly 0.0 in both."""
    static = he.HashGridStatic(HashGridConfig())
    gen = torch.Generator()
    gen.manual_seed(k)
    n = 1 << 14
    x = torch.rand(n, 3, generator=gen)
    table = torch.randn(static.n_entries, 2, generator=gen) * 1e-2
    cot = [torch.randn(n, static.cfg.output_dim, generator=gen)
           for _ in range(4)]
    picks, grads = [], []
    for d in ("cpu", cuda):
        xd, cd = x.to(d), [c.to(d) for c in cot]
        base = he._position_hash(xd)
        picks.append([[p.cpu() for p in he.pick_corners(
            *he.level_corner_cotangents(xd, static, lvl, cd[0], cd[1:], 1.0),
            he._draws(base, lvl, k), k)[:2]]
            for lvl in range(static.cfg.n_levels)])
        t = table.to(d).requires_grad_(True)
        f, j = he.make_encode_with_jacobian_cv(static, corner_samples=k)(
            t, xd)
        loss = (f * cd[0]).sum() + sum((jd * c).sum()
                                       for jd, c in zip(j, cd[1:]))
        grads.append(torch.autograd.grad(loss, t)[0].cpu())
    touched = torch.zeros(static.n_entries, dtype=torch.bool)
    for lvl, ((choice_cpu, idx_k), (choice_card, _)) in enumerate(
            zip(*picks)):
        assert torch.equal(choice_cpu, choice_card)
        touched[idx_k + int(static.offsets[lvl])] = True
    scale = grads[0].abs().max()
    assert (grads[0] - grads[1]).abs().max() <= 1e-5 * scale
    assert (grads[0][~touched] == 0).all() and (grads[1][~touched] == 0).all()


INTO = {"scatter_add": (sca, sca.scatter_add_into),
        "hash_grad_small": (hgs, hgs.grad_small_into)}
# a level of the default config that each kernel takes
LEVEL_ROWS = {"scatter_add": 1 << 19, "hash_grad_small": 13824}


def _level_inputs(cuda, name, n, F, seed):
    S = LEVEL_ROWS[name]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    idx = torch.randint(-S // 50, S + S // 50, (n,), generator=gen,
                        device=cuda, dtype=torch.int32)
    idx = torch.where(idx % 5 == 0, idx + 1, idx)
    return S, gen, idx, torch.randn(n, F, generator=gen, device=cuda)


@pytest.mark.parametrize("mode", ["zeroed", "nonzero", "misaligned"])
@pytest.mark.parametrize("F", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(INTO))
def test_in_place_matches_plain(cuda, name, F, mode):
    """Each kernel adds in place into a (S, F) view with sentinel rows on
    both sides (`bench_scatter.check_in_place`): the sentinels and the rows
    that no element touches keep their bits, and the view is within
    1e-5·(1 + max |plain|) of the plain version, on a zeroed or a random
    view. F = 2 and 4 on an aligned view take the float2 loads and vector
    reductions (one element's float2, or pairs of features); F = 1, and
    the view that starts 4 bytes past an 8-byte boundary, take 32-bit
    atomics."""
    mod, fn = INTO[name]
    S, gen, idx, v = _level_inputs(cuda, name, 1 << 18, F, F)
    buf, view = bench.in_place_view(S, F, cuda, gen,
                                    nonzero=mode == "nonzero",
                                    misaligned=mode == "misaligned")
    assert (view.data_ptr() % 8 == 4) == (mode == "misaligned")
    before = mod.launches
    bench.check_in_place(name, fn, buf, view, idx, v)
    assert mod.launches == before + 1


@pytest.mark.parametrize("name", sorted(INTO))
def test_in_place_with_a_padded_hot_row(cuda, name):
    """Half the elements on one row with zero values, as the padded slots
    of a training batch give, into an offset view: the kernel skips the
    zeros, and the result is still the plain version's."""
    mod, fn = INTO[name]
    n = 1 << 18
    S, gen, idx, v = _level_inputs(cuda, name, n, 2, 7)
    pad = torch.arange(n, device=cuda) >= n // 2
    idx[pad] = 1234
    v[pad] = 0.0
    v[n // 2 - 3:n // 2, :] = -0.0
    buf, view = bench.in_place_view(S, 2, cuda, gen)
    bench.check_in_place(name, fn, buf, view, idx, v)
    assert not torch.signbit(view[view == 0]).any()


@pytest.mark.parametrize("pattern", ["warp", "stride3", "runs"])
@pytest.mark.parametrize("name", sorted(INTO))
def test_kernels_on_repeated_rows(cuda, name, pattern):
    """Rows that repeat within a warp, which the warp aggregation sums
    before one atomic: every lane of a warp on one row ("warp"), three
    rows per warp ("stride3"), runs of 1 to 40 equal rows ("runs"); values
    random, some zero. Ones must sum exactly; random values within the
    tolerance."""
    mod, fn = INTO[name]
    n = (1 << 18) + 77
    S = LEVEL_ROWS[name]
    e = torch.arange(n, device=cuda)
    if pattern == "warp":
        idx = (e // 32 * 7919) % S
    elif pattern == "stride3":
        idx = (e % 3) * 1001 + e // 32
    else:
        gen = torch.Generator(device=cuda)
        gen.manual_seed(11)
        starts = torch.rand(n, generator=gen, device=cuda) < 1 / 20
        idx = (torch.cumsum(starts.long(), 0) * 4099) % S
    idx = idx.to(torch.int32)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(12)
    for F in (1, 2, 3):
        ones = torch.ones(n, F, device=cuda)
        got = fn(torch.zeros(S, F, device=cuda), idx, ones)
        want = mod.plain(idx, ones, S)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        v = torch.randn(n, F, generator=gen, device=cuda)
        v[torch.rand(n, generator=gen, device=cuda) < 0.2] = 0.0
        buf, view = bench.in_place_view(S, F, cuda, gen, nonzero=True)
        bench.check_in_place(name, fn, buf, view, idx, v)
