"""Tests of the PyTorch port that need an NVIDIA GPU (marker `gpu`); they
skip on a host without one. Run them on the card, where JAX is not
installed, without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from rnb_neus2_torch.config import HashGridConfig
from rnb_neus2_torch.kernels import corner_backward as cbw
from rnb_neus2_torch.kernels import encode_jacobian as ejac
from rnb_neus2_torch.kernels import hash_corners
from rnb_neus2_torch.kernels import hash_grad_small as hgs
from rnb_neus2_torch.kernels import neus_loss
from rnb_neus2_torch.kernels import scatter_add as sca
from rnb_neus2_torch.ops import hash_encoding as he
from rnb_neus2_torch.testing import loss_batch
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
    """The default config's K-corner backward on the card (the
    `corner_backward` kernel, one launch over all 14 levels) against the
    CPU's plain version: the kernel's own picks are the CPU's at every
    level, the table gradients (the kernel's, and the training encode's
    through autograd) agree within 1e-5 of the largest entry, and every
    entry that no pick touches is exactly 0.0 in all three."""
    static = he.HashGridStatic(HashGridConfig())
    L = static.cfg.n_levels
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
        before = cbw.launches
        g, choices = cbw.corner_backward(static, xd, cd[0], cd[1:], L,
                                         (1.0,) * L, k, 0, static.n_entries,
                                         with_choices=True)
        assert cbw.launches == before + (d != "cpu")
        picks.append(choices.cpu())
        t = table.to(d).requires_grad_(True)
        f, j = he.make_encode_with_jacobian_cv(static, corner_samples=k)(
            t, xd)
        loss = (f * cd[0]).sum() + sum((jd * c).sum()
                                       for jd, c in zip(j, cd[1:]))
        grads += [g.cpu(), torch.autograd.grad(loss, t)[0].cpu()]
    assert cbw.launches == before + 2
    assert torch.equal(picks[0], picks[1])
    xc = x
    touched = torch.zeros(static.n_entries, dtype=torch.bool)
    base = he._position_hash(xc)
    for lvl in range(L):
        _, idx_k, _ = cbw.level_picks(static, xc, cot[0], cot[1:], lvl, 1.0,
                                      k, lvl, base)
        touched[idx_k + int(static.offsets[lvl])] = True
    scale = grads[0].abs().max()
    assert torch.equal(grads[0], grads[1])
    for g in grads[2:]:
        assert (grads[0] - g).abs().max() <= 1e-5 * scale
    assert all((g[~touched] == 0).all() for g in grads)


# the default config; two small ones at F = 1 and 4 (dense and hashed
# levels)
ENCODE_CONFIGS = {
    "default": dict(),
    "f1": dict(n_levels=6, top_resolution=128, log2_hashmap_size=12,
               n_features_per_level=1),
    "f4": dict(n_levels=5, top_resolution=96, log2_hashmap_size=13,
               n_features_per_level=4),
}


def _encode_inputs(static, n, seed, device):
    gen = torch.Generator()
    gen.manual_seed(seed)
    F = static.cfg.n_features_per_level
    x = torch.rand(n, 3, generator=gen)
    x[:3] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                          [0.5, 0.25, 1.0]])[:n]
    table = torch.randn(static.n_entries, F, generator=gen) * 1e-2
    cot = [torch.randn(n, static.cfg.output_dim, generator=gen)
           for _ in range(4)]
    return x.to(device), table.to(device), [c.to(device) for c in cot]


@pytest.mark.parametrize("name,La,valid_level", [
    ("default", 14, None), ("default", 8, None), ("default", 1, None),
    ("default", 14, 9), ("f1", 6, 4), ("f4", 5, None), ("f4", 3, 2)])
def test_encode_jacobian_kernel_matches_plain(cuda, name, La, valid_level):
    """The forward kernel's four outputs equal its plain version's on the
    card and on the CPU bit for bit (int32 views), zeros past La; one
    launch per call."""
    static = he.HashGridStatic(HashGridConfig(**ENCODE_CONFIGS[name]))
    n = 1 << 14
    x, table, _ = _encode_inputs(static, n, La, cuda)
    mask = he._level_mask(La, valid_level)
    before = ejac.launches
    got = ejac.encode_jacobian(table, x, static, La, mask)
    assert ejac.launches == before + 1
    on_card = ejac.plain(table, x, static, La, mask)
    on_cpu = ejac.plain(table.cpu(), x.cpu(), static, La, mask)
    torch.cuda.synchronize()
    F = static.cfg.n_features_per_level
    for g, w, c in zip(got, on_card, on_cpu):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert torch.equal(g.cpu().view(torch.int32), c.view(torch.int32))
        assert not g[:, La * F:].any()
    assert got[0][:, :F].any()


@pytest.mark.parametrize("name,k,salt,valid_level", [
    ("f1", 1, 0, None), ("f1", 3, 2, 4), ("f4", 2, 1, None),
    ("f4", 16, 0, 3), ("default", 4, 5, 10)])
def test_corner_backward_kernel_matches_plain(cuda, name, k, salt,
                                              valid_level):
    """The K-corner kernel at F = 1, 2 and 4 and K up to 16: its choices
    equal the plain version's on the CPU at every level, its table
    gradient is within 1e-5 of the largest entry, and every entry that no
    pick touches is 0.0 in both."""
    static = he.HashGridStatic(HashGridConfig(**ENCODE_CONFIGS[name]))
    L = static.cfg.n_levels
    n = 12345
    x, _, cot = _encode_inputs(static, n, k + salt, cuda)
    mask = he._level_mask(L, valid_level)
    got, choices = cbw.corner_backward(static, x, cot[0], cot[1:], L, mask,
                                       k, salt, static.n_entries,
                                       with_choices=True)
    want, want_choices = cbw.plain(static, x.cpu(), cot[0].cpu(),
                                   [c.cpu() for c in cot[1:]], L, mask, k,
                                   salt, static.n_entries, with_choices=True)
    torch.cuda.synchronize()
    assert torch.equal(choices.cpu(), want_choices)
    got = got.cpu()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    xc, cc = x.cpu(), [c.cpu() for c in cot]
    base = he._position_hash(xc)
    touched = torch.zeros(static.n_entries, dtype=torch.bool)
    for lvl in range(L):
        _, idx, _ = cbw.level_picks(static, xc, cc[0], cc[1:], lvl,
                                    mask[lvl], k, salt * L + lvl, base)
        touched[idx + int(static.offsets[lvl])] = True
    assert not got[~touched].any() and not want[~touched].any()


def test_corner_backward_reads_non_contiguous_cotangents(cuda):
    """Cotangents that are views (transposed storage), as autograd may
    give them: the same choices and table gradient (within 1e-5) as the
    contiguous ones; the views are left as they were."""
    static = he.HashGridStatic(HashGridConfig())
    L = static.cfg.n_levels
    x, _, cot = _encode_inputs(static, 1 << 14, 11, cuda)
    views = [c.t().contiguous().t() for c in cot]
    assert not any(v.is_contiguous() for v in views)
    args = (L, (1.0,) * L, 1, 0, static.n_entries)
    want, wc = cbw.corner_backward(static, x, cot[0], cot[1:], *args,
                                   with_choices=True)
    got, gc = cbw.corner_backward(static, x, views[0], views[1:], *args,
                                  with_choices=True)
    torch.cuda.synchronize()
    assert torch.equal(gc, wc)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert all(torch.equal(v, c) for v, c in zip(views, cot))


def test_encode_kernels_refuse_what_they_cannot_take(cuda):
    """On card tensors: 3 features, K = 0 and 17, float64, more than 32
    levels, tensors on two devices; nothing launches."""
    ok = he.HashGridStatic(HashGridConfig(n_levels=4, top_resolution=64))
    f3 = he.HashGridStatic(HashGridConfig(n_levels=4, top_resolution=64,
                                          n_features_per_level=3))
    l33 = he.HashGridStatic(HashGridConfig(n_levels=33, top_resolution=64))
    before = (ejac.launches, cbw.launches)
    for static, exc in ((f3, ValueError), (l33, ValueError)):
        x, table, cot = _encode_inputs(static, 64, 0, cuda)
        L = static.cfg.n_levels
        with pytest.raises(exc):
            ejac.encode_jacobian(table, x, static, L, (1.0,) * L)
        with pytest.raises(exc):
            cbw.corner_backward(static, x, cot[0], cot[1:], L, (1.0,) * L, 1,
                                0, static.n_entries)
    x, table, cot = _encode_inputs(ok, 64, 0, cuda)
    mask = (1.0,) * 4
    for k in (0, 17):
        with pytest.raises(ValueError):
            cbw.corner_backward(ok, x, cot[0], cot[1:], 4, mask, k, 0,
                                ok.n_entries)
    with pytest.raises(TypeError):
        ejac.encode_jacobian(table.double(), x, ok, 4, mask)
    with pytest.raises(TypeError):
        cbw.corner_backward(ok, x, cot[0].double(), cot[1:], 4, mask, 1, 0,
                            ok.n_entries)
    with pytest.raises(ValueError):
        ejac.encode_jacobian(table.cpu(), x, ok, 4, mask)
    with pytest.raises(ValueError):
        cbw.corner_backward(ok, x, cot[0].cpu(), cot[1:], 4, mask, 1, 0,
                            ok.n_entries)
    assert (ejac.launches, cbw.launches) == before


def _hold_encode_kernels(static, x, table, cot, La, mask, k, salt):
    """Both training-encode kernels on card tensors against their plain
    versions on the CPU: the forward's four outputs bit for bit (zeros
    past La), the backward's choices identical at every level, its
    gradient within 1e-5 of the largest entry and every entry that no
    pick touches 0.0 in both; one launch each (none for the backward at
    La = 0)."""
    xc, tc, cc = x.cpu(), table.cpu(), [c.cpu() for c in cot]
    before = (ejac.launches, cbw.launches)
    got = ejac.encode_jacobian(table, x, static, La, mask)
    g, choices = cbw.corner_backward(static, x, cot[0], cot[1:], La, mask, k,
                                     salt, static.n_entries,
                                     with_choices=True)
    assert (ejac.launches, cbw.launches) == (before[0] + 1,
                                             before[1] + (La > 0))
    want = ejac.plain(tc, xc, static, La, mask)
    wg, wc = cbw.plain(static, xc, cc[0], cc[1:], La, mask, k, salt,
                       static.n_entries, with_choices=True)
    torch.cuda.synchronize()
    F = static.cfg.n_features_per_level
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
        assert not a[:, La * F:].any()
    assert torch.equal(choices.cpu(), wc)
    g = g.cpu()
    assert (g - wg).abs().max() <= 1e-5 * wg.abs().max()
    touched = torch.zeros(static.n_entries, dtype=torch.bool)
    base = he._position_hash(xc)
    for lvl in range(La):
        _, idx, _ = cbw.level_picks(static, xc, cc[0], cc[1:], lvl,
                                    mask[lvl], k, salt * La + lvl, base)
        touched[idx + int(static.offsets[lvl])] = True
    assert not g[~touched].any() and not wg[~touched].any()


def _tile(static, mod):
    """The tile of samples that kernel module `mod` takes at `static`."""
    return hash_corners.tile_plan(static.cfg.n_levels,
                                  static.cfg.n_features_per_level,
                                  mod.TILE)[0]


@pytest.mark.parametrize("rows", ["1", "31", "fwd T-1", "fwd T+1",
                                  "bwd T-1", "bwd T+1", "2^18+5"])
def test_encode_kernels_on_ragged_tiles(cuda, rows):
    """Batches that end inside a tile of either kernel (the plain loads
    and stores of the last tile) and batches of less than one tile, at the
    default config."""
    static = he.HashGridStatic(HashGridConfig())
    if rows[0] in "fb":
        T = _tile(static, ejac if rows[0] == "f" else cbw)
        n = T - 1 if rows.endswith("-1") else T + 1
    else:
        n = {"1": 1, "31": 31, "2^18+5": (1 << 18) + 5}[rows]
    x, table, cot = _encode_inputs(static, n, n, cuda)
    L = static.cfg.n_levels
    _hold_encode_kernels(static, x, table, cot, L, (1.0,) * L, 1, 0)


@pytest.mark.parametrize("La,valid_level", [(0, None), (1, None),
                                            (9, 6), (14, None)])
def test_encode_kernels_at_active_levels(cuda, La, valid_level):
    """La = 0 (all zeros, no backward launch), 1, 9 (under a mask) and
    14 at the default config."""
    static = he.HashGridStatic(HashGridConfig())
    x, table, cot = _encode_inputs(static, 3 * _tile(static, cbw) + 17,
                                   La, cuda)
    _hold_encode_kernels(static, x, table, cot, La,
                         he._level_mask(La, valid_level), 2, 1)


def test_encode_kernels_at_32_levels_of_8_features(cuda):
    """L·F = 256: the smallest tile, in one stage."""
    static = he.HashGridStatic(HashGridConfig(
        n_levels=32, n_features_per_level=8, base_resolution=4,
        top_resolution=256, log2_hashmap_size=12))
    assert hash_corners.tile_plan(32, 8, ejac.TILE) == (32, 1)
    assert hash_corners.tile_plan(32, 8, cbw.TILE) == (32, 1)
    x, table, cot = _encode_inputs(static, 1000, 8, cuda)
    _hold_encode_kernels(static, x, table, cot, 32, (1.0,) * 32, 3, 2)


@pytest.mark.parametrize("name", ["default", "f1", "f4"])
def test_encode_kernels_outside_the_unit_cube(cuda, name):
    """Positions in [-1.5, 2.5): negative and wrapping corners, the dense
    levels' int64 remainder and the hashed levels' uint32 wrap."""
    static = he.HashGridStatic(HashGridConfig(**ENCODE_CONFIGS[name]))
    x, table, cot = _encode_inputs(static, 5000, 3, cuda)
    x = x * 4.0 - 1.5
    L = static.cfg.n_levels
    _hold_encode_kernels(static, x, table, cot, L, (1.0,) * L, 1, 0)


@pytest.mark.parametrize("k", [1, 4, 16])
def test_encode_kernels_with_k_picks(cuda, k):
    """K up to 16 picks at the default config, on a ragged batch."""
    static = he.HashGridStatic(HashGridConfig())
    x, table, cot = _encode_inputs(static, 4 * _tile(static, cbw) + 3, k,
                                   cuda)
    L = static.cfg.n_levels
    _hold_encode_kernels(static, x, table, cot, L, (1.0,) * L, k, 3)


def _misaligned(t):
    """A contiguous copy of `t` that starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("which", ["g_out", "g_jac_z", "positions",
                                   "outputs", "table"])
def test_encode_kernels_on_misaligned_tensors(cuda, which):
    """A cotangent, the positions or the forward's outputs that do not
    start on a 16-byte boundary (a slice at an odd offset) are read or
    written with plain loads and stores, and a table off its rows' 8-byte
    alignment is gathered feature by feature: the same results as aligned
    tensors."""
    static = he.HashGridStatic(HashGridConfig())
    x, table, cot = _encode_inputs(static, 2 * _tile(static, cbw) + 9, 4,
                                   cuda)
    L = static.cfg.n_levels
    if which == "g_out":
        cot[0] = _misaligned(cot[0])
    elif which == "g_jac_z":
        cot[3] = _misaligned(cot[3])
    elif which == "positions":
        x = _misaligned(x)
    elif which == "table":
        table = _misaligned(table)
    if which != "outputs":
        _hold_encode_kernels(static, x, table, cot, L, (1.0,) * L, 2, 0)
        return
    outs = [_misaligned(torch.full((x.shape[0], static.cfg.output_dim),
                                   7.0, device=cuda)) for _ in range(4)]
    got = ejac.encode_jacobian_into(outs, table, x, static, L, (1.0,) * L)
    want = ejac.plain(table.cpu(), x.cpu(), static, L, (1.0,) * L)
    torch.cuda.synchronize()
    assert all(a is b for a, b in zip(got, outs))
    for a, b in zip(outs, want):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


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


def test_device_marching_cubes_matches_host(cuda):
    """Marching cubes on the card equals the numpy version on the same
    res-96 random-field volume: V within 1e-5, F equal."""
    import numpy as np
    from rnb_neus2_torch.mesh.marching import marching_cubes_grid
    from rnb_neus2_torch.mesh.marching_device import marching_cubes_device

    gen = torch.Generator(device=cuda)
    gen.manual_seed(96)
    vol = torch.randn(97, 97, 97, generator=gen, device=cuda)
    V, F = marching_cubes_device(vol, (0.0, 0.0, 0.0), 1.0 / 96)
    V0, F0 = marching_cubes_grid(vol.cpu().numpy(), (0.0, 0.0, 0.0),
                                 1.0 / 96)
    assert V.is_cuda and F.is_cuda and len(F0) > 100_000
    assert V.shape == V0.shape and F.shape == F0.shape
    assert np.abs(V.cpu().numpy() - V0).max() <= 1e-5
    assert np.array_equal(F.cpu().numpy(), F0)


def test_extract_mesh_device_matches_host(cuda):
    """extract_mesh(backend="device") on a NeusField on the card against
    backend="host" (numpy marching cubes of the same volume)."""
    import numpy as np
    from rnb_neus2_torch.config import NetworkConfig
    from rnb_neus2_torch.mesh.extract import extract_mesh
    from rnb_neus2_torch.models.neus_field import NeusField

    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    field = NeusField(HashGridConfig(n_levels=8, log2_hashmap_size=15),
                      NetworkConfig(), cuda, gen)
    with torch.no_grad():   # off the init, where w_enc is zero
        field.sdf_w_enc.normal_(0.0, 0.05, generator=gen)
        field.hash_table.normal_(0.0, 1e-2, generator=gen)
    dev = extract_mesh(field, None, resolution=128, backend="device",
                       with_colors=True)
    host = extract_mesh(field, None, resolution=128, backend="host",
                        with_colors=True)
    assert len(host["F"]) > 5_000 and dev["active_blocks"] > 0
    assert dev["V"].shape == host["V"].shape
    assert np.abs(dev["V"] - host["V"]).max() <= 1e-5
    assert np.array_equal(dev["F"], host["F"])
    assert np.abs(dev["N"] - host["N"]).max() <= 1e-4
    assert np.abs(dev["C"] - host["C"]).max() <= 1e-5


def _small_render_setup(device):
    """A 4-level field sharpened off its init (variance 0.6, noise on the
    table and the SDF MLP's encoding columns) and its occupancy grid."""
    from rnb_neus2_torch.config import NetworkConfig
    from rnb_neus2_torch.grid import occupancy
    from rnb_neus2_torch.models.neus_field import NeusField

    gen = torch.Generator()
    gen.manual_seed(11)
    field = NeusField(HashGridConfig(n_levels=4, top_resolution=64),
                      NetworkConfig(), "cpu", gen)
    with torch.no_grad():
        field.variance.fill_(0.6)
        field.hash_table.add_(1e-2 * torch.randn(field.hash_table.shape,
                                                 generator=gen))
        field.sdf_w_enc.normal_(0.0, 0.05, generator=gen)
        bit = occupancy.update(occupancy.init_state(32), field.density(
            occupancy.cell_positions(32, gen))).bitfield
    return field, bit


def test_render_view_on_card_matches_cpu(cuda):
    """`render_view` on the card against the CPU port on the same
    parameters and bitfield, within 1e-4 (alpha x normal for the
    normal), at render_scale 1 and 0.5."""
    import numpy as np
    from rnb_neus2_torch.config import MarchConfig
    from rnb_neus2_torch.render.renderer import render_view
    from rnb_neus2_torch.testing.synthetic import sphere_dataset

    field, bit = _small_render_setup(cuda)
    ds = sphere_dataset(n_views=2, width=40, height=32, radius=0.25)
    card_field = type(field)(field.grid, field.net, cuda)
    card_field.load_state_dict(field.state_dict())
    for scale in (1.0, 0.5):
        want = render_view(field, None, ds.cameras, 1, bit,
                           MarchConfig(n_ladder=512), max_samples=64,
                           render_scale=scale)
        got = render_view(card_field, None, ds.cameras.to(cuda), 1,
                          bit.to(cuda), MarchConfig(n_ladder=512),
                          max_samples=64, render_scale=scale)
        for k in ("albedo", "alpha", "depth"):
            assert np.abs(got[k] - want[k]).max() <= 1e-4, k
        a = want["alpha"][..., None]
        assert np.abs(a * (got["normal"] - want["normal"])).max() <= 1e-4
        assert want["alpha"].max() > 0.99


def test_train_steps_on_card_follow_the_schedule(cuda):
    """Real `train_steps(600, 25)` on the card read the metrics at the
    steps of the CPU schedule with the step body replaced by a counter
    (the schedule `tests/test_torch_train_steps.py` holds against the JAX
    package), and every step launched the kernels for its level
    bucket."""
    from rnb_neus2_torch.config import (MarchConfig, TestbedConfig,
                                        TrainConfig)
    from rnb_neus2_torch.testing.synthetic import sphere_dataset
    from rnb_neus2_torch.train.trainer import Trainer

    cfg = TestbedConfig(
        grid=HashGridConfig(n_levels=4, top_resolution=64),
        train=TrainConfig(target_batch_size=1 << 13,
                          initial_rays_per_batch=128, occ_grid_size=32),
        march=MarchConfig(n_ladder=512))

    def run(device, dry):
        tr = Trainer(sphere_dataset(n_views=4, width=32, height=32,
                                    radius=0.2), cfg, device=device)
        reads, bodies = [], []
        real_read, real_body = tr._consume_metrics, tr._step_body

        def read(m):
            out = real_read(m) if not dry else {}
            reads.append((tr.step, "rolled_back" in out))
            return out

        def body(n_rays, n_active):
            bodies.append(n_active)
            return {} if dry else real_body(n_rays, n_active)

        tr._consume_metrics, tr._step_body = read, body
        if dry:
            tr.refresh_occupancy = lambda n_active: None
        tr.train_steps(600, 25)
        return reads, bodies

    want, _ = run("cpu", True)
    for mod in (hgs, sca, ejac, cbw):
        mod.reset_launches()
    got, bodies = run(cuda, False)
    torch.cuda.synchronize()
    assert got == want and not any(rb for _, rb in got)
    assert len(bodies) == 600
    # K = 1: one forward and one K-corner backward per step body
    assert (ejac.launches, cbw.launches, hgs.launches, sca.launches) == (
        600, 600, 0, 0)


def test_features_only_encode_on_card_matches_cpu(cuda):
    """`hash_encoding.encode` (the extra modes' and the SDF-only path's
    encode): features within 1e-6, the table gradient through both
    kernels as in phase 3, the positions' cotangent within 1e-4 of its
    largest entry."""
    cfg = HashGridConfig(n_levels=4, top_resolution=64)
    static = he.HashGridStatic(cfg)
    gen = torch.Generator().manual_seed(5)
    table = 1e-2 * torch.randn(static.n_entries, 2, generator=gen)
    x = torch.rand(20000, 3, generator=gen)
    gout = torch.randn(20000, cfg.output_dim, generator=gen)
    res = []
    for d in ("cpu", cuda):
        t = table.to(d).requires_grad_(True)
        p = x.to(d).requires_grad_(True)
        before = (hgs.launches, sca.launches)
        enc = he.encode(t, p, static)
        gt, gp = torch.autograd.grad((enc * gout.to(d)).sum(), (t, p))
        if d != "cpu":
            small = len(he.levels_through_kernel(static))
            assert (hgs.launches - before[0], sca.launches - before[1]) == (
                small, cfg.n_levels - small)
        res.append([v.detach().cpu() for v in (enc, gt, gp)])
    (e0, t0, p0), (e1, t1, p1) = res
    assert (e0 - e1).abs().max() <= 1e-6
    assert (t0 - t1).abs().max() <= 1e-5 * (1 + t0.abs().max())
    assert (p0 - p1).abs().max() <= 1e-4 * p0.abs().max()


def test_extra_mode_encodings_on_card_match_cpu(cuda):
    """The 2-D hash grid and the Takikawa octree: features and table
    gradients (one `scatter_add` launch per level) as above."""
    from rnb_neus2_torch.models.extra_modes import Hash2D
    from rnb_neus2_torch.ops import takikawa
    from rnb_neus2_torch.testing.synthetic import icosphere

    gen = torch.Generator().manual_seed(6)
    enc2 = Hash2D()
    tree = takikawa.build_triangle_octree(
        *icosphere(0.3, (0.5, 0.5, 0.5), subdiv=2), 6, 3)
    cases = [(lambda t, p: enc2.encode(t, p),
              1e-2 * torch.randn(enc2.n_entries, 2, generator=gen),
              torch.rand(20000, 2, generator=gen), enc2.n_levels),
             (lambda t, p: takikawa.encode(t, p, tree),
              1e-2 * torch.randn(tree.n_vertices, 8, generator=gen),
              torch.rand(20000, 3, generator=gen), tree.n_levels)]
    for fn, table, x, levels in cases:
        res = []
        for d in ("cpu", cuda):
            t = table.to(d).requires_grad_(True)
            before = sca.launches
            out = fn(t, x.to(d))
            gout = torch.ones_like(out)
            (g,) = torch.autograd.grad((out * gout).sum(), t)
            if d != "cpu":
                assert sca.launches - before == levels
            res.append((out.detach().cpu(), g.cpu()))
        (o0, g0), (o1, g1) = res
        assert (o0 - o1).abs().max() <= 1e-6
        assert (g0 - g1).abs().max() <= 1e-5 * (1 + g0.abs().max())


def test_cascaded_march_on_card_matches_cpu(cuda):
    """`march` at aabb_scale 4 over a 3-cascade grid at cone 0 and 1/256:
    valid and n_valid bit for bit, t within 1e-6 relative."""
    from rnb_neus2_torch.grid import occupancy
    from rnb_neus2_torch.ops import ray_march

    gen = torch.Generator().manual_seed(7)
    C, G = 3, 128
    pts = occupancy.cascade_cell_positions(G, C, gen)
    r = (pts - 0.5).norm(dim=1)
    dens = ((r - 0.3).abs() < 0.05).float()
    bits = occupancy.update_cascaded(occupancy.init_state_cascaded(G, C),
                                     dens.reshape(C, -1)).bitfield
    o = torch.randn(2048, 3, generator=gen)
    o = 0.5 + 3.6 * o / o.norm(dim=1, keepdim=True)
    d = 0.5 + (torch.rand(2048, 3, generator=gen) - 0.5) * 0.8 - o
    d = d / d.norm(dim=1, keepdim=True)
    u = torch.rand(2048, generator=gen)
    for cone in (0.0, 1.0 / 256.0):
        got = ray_march.march(o.to(cuda), d.to(cuda), bits.to(cuda),
                              u.to(cuda), 1024, 128, cone, aabb_scale=4.0)
        want = ray_march.march(o, d, bits, u, 1024, 128, cone,
                               aabb_scale=4.0)
        assert torch.equal(got.valid.cpu(), want.valid)
        assert torch.equal(got.n_valid.cpu(), want.n_valid)
        v = want.valid
        assert ((got.t.cpu() - want.t).abs()[v]
                <= 1e-6 * want.t.abs()[v]).all()
        assert int(v.sum()) > 0


def test_option_paths_train_on_the_card(cuda):
    """aabb_scale 4, the emulations, the salt and bfloat16 each train a few
    steps on the card (K = 1) with the encode's two kernels launched once
    per step each, and the exact backward's two never."""
    import dataclasses

    from rnb_neus2_torch.config import (LossConfig, MarchConfig,
                                        NetworkConfig, TestbedConfig,
                                        TrainConfig)
    from rnb_neus2_torch.testing.synthetic import sphere_dataset
    from rnb_neus2_torch.train.trainer import Trainer

    ds = sphere_dataset(n_views=4, width=64, height=64, radius=0.25,
                        device=cuda)
    base = TestbedConfig(grid=HashGridConfig(n_levels=4, top_resolution=64),
                         train=TrainConfig(target_batch_size=1 << 14,
                                           occ_grid_size=32))
    variants = [
        dict(grid=HashGridConfig(n_levels=4, top_resolution=64,
                                 aabb_scale=4.0),
             march=MarchConfig(cone_angle=1.0 / 256.0)),
        dict(loss=LossConfig(fp16_grad_emulation=True,
                             rollover_grad_emulation=True)),
        dict(train=dataclasses.replace(base.train, light_prng_salt=1)),
        dict(network=NetworkConfig(compute_dtype="bfloat16")),
    ]
    for kw in variants:
        cfg = dataclasses.replace(base, **kw)
        tr = Trainer(ds, cfg, device=cuda)
        mods = (ejac, cbw, hgs, sca)
        before = [m.launches for m in mods]
        for _ in range(6):
            tr.train_step()
        assert [m.launches - b for m, b in zip(mods, before)] == [
            6, 6, 0, 0], kw


@pytest.mark.parametrize("cards", [1, 2], ids=["one_card", "two_cards"])
def test_two_replicas_on_the_card_match_the_cpu(cuda, monkeypatch, cards):
    """`ParallelTrainer` with two replicas on one card (or one on each of
    two cards: the cross-device copies of the draws, the bitfield, the
    gradients, the metrics and the parameters) against the same two
    replicas on the CPU, 3 steps on the same draws (numbers made on the
    host and moved to the device; the exact backward; one initialization,
    made on the CPU): loss within 1e-5 relative, the bitfield equal,
    parameters within 1e-4 (a tenth of the learning rate, as
    tests/test_torch_trainer_parity.py holds the CPU port to JAX), both
    launches per replica and level bucket, and the replicas identical
    after every step."""
    import numpy as np

    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA devices")

    from rnb_neus2_torch.config import (MarchConfig, NetworkConfig,
                                        TestbedConfig, TrainConfig)
    from rnb_neus2_torch.grid import occupancy
    from rnb_neus2_torch.parallel import ParallelTrainer
    from rnb_neus2_torch.parallel import trainer as ptrainer
    from rnb_neus2_torch.testing.synthetic import sphere_dataset
    from rnb_neus2_torch.train.sampler import RayUniforms

    cfg = TestbedConfig(
        grid=HashGridConfig(n_levels=4, top_resolution=64),
        network=NetworkConfig(stoch_corner_bwd=0),
        train=TrainConfig(target_batch_size=1 << 13,
                          initial_rays_per_batch=128, occ_grid_size=32),
        march=MarchConfig(n_ladder=512))
    real_sample, real_cells = ptrainer.sample_ray_batch, \
        occupancy.cell_positions
    calls = {"sample": 0, "cells": 0}

    def sample(*a, **k):
        uni = k["uniforms"]
        R, dev = uni.xy.shape[0], uni.xy.device
        rng = np.random.default_rng(calls["sample"])
        calls["sample"] += 1
        f = lambda *s: torch.from_numpy(rng.random(s, np.float32)).to(dev)
        k["uniforms"] = RayUniforms(
            xy=f(R, 2), skip=f(R), start=f(R),
            light_idx=torch.from_numpy(rng.integers(0, 3, R)).to(dev))
        return real_sample(*a, **k)

    def cells(g, gen=None, device="cpu"):
        rng = np.random.default_rng(1000 + calls["cells"])
        calls["cells"] += 1
        jitter = torch.from_numpy(rng.random((g ** 3, 3), np.float32))
        return real_cells(g, gen, device, jitter=jitter.to(device))

    monkeypatch.setattr(ptrainer, "sample_ray_batch", sample)
    monkeypatch.setattr(occupancy, "cell_positions", cells)
    ds = sphere_dataset(n_views=4, width=32, height=32, radius=0.2)
    # one initialization for both (a card's generator draws another stream)
    init = ParallelTrainer(ds, cfg, devices=["cpu", "cpu"]).params
    init = {k: v.detach().clone() for k, v in init.items()}
    runs = {}
    card_devs = [torch.device("cuda", i % cards) for i in range(2)]
    for name, devs in (("cpu", ["cpu", "cpu"]), ("card", card_devs)):
        calls.update(sample=0, cells=0)
        tr = ParallelTrainer(ds, cfg, params=init, devices=devs)
        before = (hgs.launches, sca.launches, ejac.launches)
        hist = []
        for _ in range(3):
            hist.append(tr.train_step())
            for rep in tr.replicas[1:]:
                for k, p in rep.params.items():
                    assert torch.equal(p.to(tr.device), tr.params[k]), \
                        (name, k)
        runs[name] = (tr, hist, (hgs.launches - before[0],
                                 sca.launches - before[1],
                                 ejac.launches - before[2]))
    (cpu, cpu_hist, _), (card, card_hist, launches) = runs["cpu"], \
        runs["card"]
    for m, w in zip(card_hist, cpu_hist):
        assert m["loss_total"] == pytest.approx(w["loss_total"], rel=1e-5)
        assert m["rays_per_batch"] == w["rays_per_batch"]
    assert torch.equal(card.occ.bitfield.cpu(), cpu.occ.bitfield)
    with torch.no_grad():
        for k, p in card.params.items():
            assert float((p.cpu() - cpu.params[k]).abs().max()) <= 1e-4, k
    static = he.HashGridStatic(cfg.grid)
    buckets = [m["n_levels_run"] for m in card_hist]
    small = sum(len(he.levels_through_kernel(static, b)) for b in buckets)
    assert launches == (2 * small, 2 * (sum(buckets) - small), 2 * 3)


N_LOSS_CASES = len(loss_batch.EDGE_CASES) + len(loss_batch.TILE_CASES)


@pytest.mark.parametrize("case", range(N_LOSS_CASES + 1))
def test_loss_kernels_match_float64_plain(cuda, case):
    """The loss's three kernels against their plain version run in float64
    with the twin's prefix, and their prefix against the twin
    (`loss_batch.hold_against_float64`, whose tolerances are stated
    there): on the edge-case batch under each configuration of
    `EDGE_CASES`, on the tile batch under `TILE_CASES`, and on a larger
    seeded batch (4,096 rays, 2^15 slots)."""
    if case < N_LOSS_CASES:
        label, args = loss_batch.edge_case_calls(cuda)[case]
    else:
        from rnb_neus2_torch.config import LossConfig, RenderFlags
        from rnb_neus2_torch.render.losses import training_loss

        label = "seeded 4096 x 2^15"
        field, samples, batch = loss_batch.torch_batch(
            loss_batch.loss_batch(1, 4096, 1 << 15), cuda)
        _, (args,) = loss_batch.capture_call(lambda: training_loss(
            field, samples, batch, RenderFlags(), LossConfig()))
    report = loss_batch.hold_against_float64(args, label)
    assert report["ok"], report


def test_loss_kernels_refuse_what_they_cannot_take(cuda):
    label, args = loss_batch.edge_case_calls(cuda)[0]
    sdf, grad, alb, v, dirs, inp, opt = args
    with pytest.raises(TypeError):
        neus_loss.neus_loss(sdf.double(), grad, alb, v, dirs, inp, opt)
    with pytest.raises(ValueError):
        neus_loss.neus_loss(sdf[:-1], grad, alb, v, dirs, inp, opt)
    with pytest.raises(ValueError):
        neus_loss.neus_loss(sdf, grad, alb, v, dirs,
                            inp._replace(dt=inp.dt.cpu()), opt)


# the march kernels' cases: (R, K, S, g, occupied share, cone, aabb_scale,
# blocked); R = 300 is not a multiple of 32, 2^14 rays at 2^16 slots drop
# most of them, S = 16 drops every ray, a 30³ grid takes the coarse grid's
# one-byte reads
MARCH_CASES = {
    "main": (1 << 14, 1024, 1 << 16, 128, 0.05, 0.0, 1.0, None),
    "edge_blocked": (300, 512, 1 << 13, 32, 0.3, 0.0, 1.0, None),
    "grid_30": (300, 512, 1 << 13, 30, 0.3, 0.0, 1.0, None),
    "empty": (300, 512, 1 << 13, 32, 0.0, 0.0, 1.0, None),
    "full": (300, 512, 1 << 13, 32, 1.0, 0.0, 1.0, None),
    "total_0": (300, 512, 16, 32, 1.0, 0.0, 1.0, None),
    "ladder_cone_0": (300, 512, 1 << 13, 32, 0.3, 0.0, 1.0, False),
    "cone_aabb_4": (2048, 1024, 1 << 15, 128, 0.05, 1.0 / 256.0, 4.0,
                    None),
}


@pytest.mark.parametrize("name", sorted(MARCH_CASES))
def test_march_kernels_match_plain(cuda, name):
    """`ops/ray_march.march_flat` on the card (the four march kernels)
    against `march_flat_plain` and `kernels/march.walk_twin` on the same
    card tensors: every field bit for bit, each kernel launched once (the
    coarse grid's only on the blocked path)."""
    from rnb_neus2_torch.ops import ray_march
    from rnb_neus2_torch.testing import march_cases as mc

    R, K, S, g, share, cone, aabb, blocked = MARCH_CASES[name]
    o, d, u = mc.edge_rays(R, R + g, *ray_march._cube(aabb))
    args = [torch.from_numpy(x).to(cuda)
            for x in (o, d, mc.bitfield(g, share, g), u)]
    report = mc.hold(args, K, S, cone, aabb, blocked, name)
    assert report["ok"], report
    if name == "total_0":
        assert report["valid"] == 0 and report["kept"] == 0
    elif share > 0.0:
        assert 0 < report["valid"] <= S


def test_march_kernels_stop_at_nb_flagged_blocks(cuda):
    """R = 9000: NB = 116 < 128 blocks, which the diagonal rays pass; the
    blocked kernels equal the plain blocked march, which differs there
    from the single-phase ladder (the kernels' too)."""
    from rnb_neus2_torch.ops import ray_march
    from rnb_neus2_torch.testing import march_cases as mc

    o, d, u, diag = mc.diagonal_rays(9000, 9000)
    args = [torch.from_numpy(x).to(cuda)
            for x in (o, d, mc.bitfield(128, 0.05, 10024), u)]
    report = mc.hold(args, 1024, 1 << 16, 0.0, label="nb")
    assert report["ok"] and report["NB"] == 116, report
    ladder = mc.hold(args, 1024, 1 << 16, 0.0, blocked=False, label="ladder")
    assert ladder["ok"], ladder
    blocked = ray_march.march_flat(*args, 1024, 1 << 16, 0.0)
    single = ray_march.march_flat(*args, 1024, 1 << 16, 0.0, blocked=False)
    cut = (blocked.n_valid < single.n_valid).cpu()
    assert int(cut.sum()) > diag.sum() // 2
    assert not bool(cut[torch.from_numpy(~diag)].any())


def test_march_kernels_refuse_what_they_cannot_take(cuda):
    from rnb_neus2_torch.ops import ray_march
    from rnb_neus2_torch.testing import march_cases as mc

    o, d, u = (torch.from_numpy(x).to(cuda) for x in mc.edge_rays(64, 2))
    bit = torch.ones(16 ** 3, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="cascaded"):
        ray_march.march_flat(o, d, bit.reshape(2, -1), u, 512, 64, 0.0,
                             aabb_scale=4.0)
    with pytest.raises(ValueError, match="gradient"):
        ray_march.march_flat(o, d.requires_grad_(), bit, u, 512, 64, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        ray_march.march_flat(o, d.detach(), bit.cpu(), u, 512, 64, 0.0)
    with pytest.raises(TypeError):
        ray_march.march_flat(o, d.detach(), bit.to(torch.uint8), u, 512,
                             64, 0.0)
