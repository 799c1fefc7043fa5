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
    hgs.reset_launches()
    sca.reset_launches()
    got, bodies = run(cuda, False)
    torch.cuda.synchronize()
    assert got == want and not any(rb for _, rb in got)
    static = he.HashGridStatic(cfg.grid)
    small = sum(len(he.levels_through_kernel(static, n)) for n in bodies)
    assert len(bodies) == 600
    assert (hgs.launches, sca.launches) == (small, sum(bodies) - small)


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
    steps on the card with both kernels launched per level bucket."""
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
        static = tr.field.static
        before = (hgs.launches, sca.launches)
        buckets = [tr.train_step()["n_levels_run"] for _ in range(6)]
        small = sum(len(he.levels_through_kernel(static, b))
                    for b in buckets)
        assert (hgs.launches - before[0], sca.launches - before[1]) == (
            small, sum(buckets) - small), kw
