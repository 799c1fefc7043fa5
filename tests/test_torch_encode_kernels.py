"""The training encode's two kernel modules on the CPU, where each takes
its plain version: `kernels/encode_jacobian.py` (the forward) and
`kernels/corner_backward.py` (the K-corner backward), against the JAX
package's `make_encode_with_jacobian_cv`; the per-level constants that
their wrappers hand the CUDA kernels; every input they refuse. The
kernels themselves run in tests/test_torch_gpu.py and chip_smoke.py."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rnb_neus2_tpu.config import HashGridConfig as JHashGridConfig
from rnb_neus2_tpu.ops import hash_encoding as jhe
from rnb_neus2_torch.config import HashGridConfig
from rnb_neus2_torch.kernels import corner_backward, encode_jacobian
from rnb_neus2_torch.kernels import hash_corners
from rnb_neus2_torch.ops import hash_encoding as he

# test_torch_hash_encoding.py's small config (3 dense, 3 hashed levels)
# and its all-hashed one, and a 4-feature config
CONFIGS = {
    "small": dict(n_levels=6, top_resolution=128, log2_hashmap_size=14),
    "hashed": dict(n_levels=6, top_resolution=128, log2_hashmap_size=10),
    "f4": dict(n_levels=4, top_resolution=64, log2_hashmap_size=12,
               n_features_per_level=4),
}
N = 203


def _statics(name):
    cfg = CONFIGS[name]
    return (jhe.HashGridStatic(JHashGridConfig(**cfg)),
            he.HashGridStatic(HashGridConfig(**cfg)))


def _inputs(static, seed, n=N):
    """Table (scaled 1e-2), positions with lattice-aligned and boundary
    points, and the four cotangents, float32 from numpy."""
    rng = np.random.default_rng(seed)
    F = static.cfg.n_features_per_level
    table = (rng.standard_normal((static.n_entries, F)) * 1e-2) \
        .astype(np.float32)
    x = rng.random((n, 3)).astype(np.float32)
    x[:4] = np.array([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5],
                      [1, 0, 0.25]], np.float32)
    cots = [rng.standard_normal((n, static.cfg.output_dim))
            .astype(np.float32) for _ in range(4)]
    return table, x, cots


def _active(static, n_active):
    L = static.cfg.n_levels
    return min(L, n_active) if n_active else L


FORWARD_CASES = [("small", None, None), ("small", 4, None),
                 ("small", 2, 3), ("hashed", None, None),
                 ("hashed", 5, 4), ("f4", 3, None), ("f4", None, 2)]


@pytest.mark.parametrize("name,valid_level,n_active", FORWARD_CASES)
def test_forward_twin_matches_jax(name, valid_level, n_active):
    """The forward's plain version equals the JAX forward, run op by op
    (`jax.disable_jit`, no fused multiply-add), in every sample: features
    and the three jacobian columns, zeros past the active levels."""
    jstatic, static = _statics(name)
    table, x, _ = _inputs(static, 1)
    with jax.disable_jit():
        jf, jj = jhe.make_encode_with_jacobian_cv(jstatic, n_active)(
            jnp.asarray(table), jnp.asarray(x), valid_level)
    La = _active(static, n_active)
    mask = he._level_mask(La, valid_level)
    got = encode_jacobian.plain(torch.from_numpy(table), torch.from_numpy(x),
                                static, La, mask)
    for g, w in zip(got, (jf, *jj)):
        assert g.dtype == torch.float32
        assert g.shape == (N, static.cfg.output_dim)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    F = static.cfg.n_features_per_level
    assert all(bool((g[:, La * F:] == 0).all()) for g in got)
    assert bool((got[0][:, :La * F] != 0).any())


@pytest.mark.parametrize("name,valid_level,n_active",
                         [("small", None, None), ("f4", 3, None)])
def test_forward_wrapper_takes_the_plain_version_on_cpu(name, valid_level,
                                                        n_active):
    """On CPU tensors both entry points give the plain version's four
    tensors, bit for bit, launch nothing, and the in-place one writes the
    tensors it is given; the training encode's forward is it."""
    _, static = _statics(name)
    table, x, _ = _inputs(static, 2)
    La = _active(static, n_active)
    mask = he._level_mask(La, valid_level)
    t, xt = torch.from_numpy(table), torch.from_numpy(x)
    want = encode_jacobian.plain(t, xt, static, La, mask)
    before = encode_jacobian.launches
    got = encode_jacobian.encode_jacobian(t, xt, static, La, mask)
    outs = [torch.full((N, static.cfg.output_dim), 7.0)
            for _ in range(4)]
    into = encode_jacobian.encode_jacobian_into(outs, t, xt, static, La,
                                                mask)
    f, j = he.make_encode_with_jacobian_cv(static, n_active)(t, xt,
                                                             valid_level)
    assert encode_jacobian.launches == before
    assert all(a is b for a, b in zip(into, outs))
    for res in (got, into, (f, *j)):
        for g, w in zip(res, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


BACKWARD_CASES = [(name, k, salt, None, None)
                  for name in ("small", "hashed") for k in (1, 2, 4)
                  for salt in (0, 2)] + [
    ("small", 2, 0, 4, None), ("hashed", 1, 2, 2, 5), ("f4", 2, 1, None, 3),
    ("f4", 1, 0, 2, None)]


def _jax_table_grad(jstatic, table, x, cots, k, salt, valid_level, n_active):
    """The JAX package's K-corner table gradient, op by op."""
    jfn = jhe.make_encode_with_jacobian_cv(jstatic, n_active,
                                           corner_samples=k,
                                           corner_salt=salt)

    def jloss(t):
        f, j = jfn(t, jnp.asarray(x), valid_level)
        return jnp.vdot(f, cots[0]) + sum(jnp.vdot(j[d], cots[1 + d])
                                          for d in range(3))

    with jax.disable_jit():
        return np.asarray(jax.grad(jloss)(jnp.asarray(table)))


@pytest.mark.parametrize("name,k,salt,valid_level,n_active",
                         BACKWARD_CASES)
def test_backward_twin_matches_jax(monkeypatch, name, k, salt, valid_level,
                                   n_active):
    """The backward's plain version, one call for all levels, picks the
    JAX package's corners: the same table entries are non-zero, with
    values at rtol 1e-5 / atol 1e-7 of the largest (the JAX backward runs
    op by op, and its scatter and the plain version's add in other
    orders)."""
    monkeypatch.setattr(jhe, "_SCATTER_MODE", "auto")
    jstatic, static = _statics(name)
    table, x, cots = _inputs(static, 3)
    want = _jax_table_grad(jstatic, table, x, cots, k, salt, valid_level,
                           n_active)
    La = _active(static, n_active)
    mask = he._level_mask(La, valid_level)
    tc = [torch.from_numpy(c) for c in cots]
    got = corner_backward.plain(static, torch.from_numpy(x), tc[0], tc[1:],
                                La, mask, k, salt, static.n_entries)
    assert got.dtype == torch.float32
    assert got.shape == (static.n_entries, static.cfg.n_features_per_level)
    got = got.numpy()
    assert (want != 0).any()
    np.testing.assert_array_equal(got != 0.0, want != 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-7 * np.abs(want).max())


@pytest.mark.parametrize("k,salt", [(1, 0), (2, 3), (4, 1)])
def test_choices_are_the_picks_of_pick_corners(k, salt):
    """The (La, K, N) choices equal each level's `pick_corners` choices on
    its draw stream salt·La + level, and the wrappers on CPU tensors give
    the plain version's table gradient bit for bit, with the same
    choices, launching nothing; the training encode's backward is it."""
    _, static = _statics("small")
    _, x, cots = _inputs(static, 4)
    xt, tc = torch.from_numpy(x), [torch.from_numpy(c) for c in cots]
    La, mask = 5, (1.0, 1.0, 1.0, 0.0, 0.0)
    g, choices = corner_backward.plain(static, xt, tc[0], tc[1:], La, mask,
                                       k, salt, static.n_entries,
                                       with_choices=True)
    assert choices.dtype == torch.int8 and choices.shape == (La, k, N)
    base = he._position_hash(xt)
    for lvl in range(La):
        idx, src = he.level_corner_cotangents(xt, static, lvl, tc[0], tc[1:],
                                              mask[lvl])
        want, _, _ = he.pick_corners(idx, src,
                                     he._draws(base, salt * La + lvl, k), k)
        assert torch.equal(choices[lvl].long(), want)
    assert 0 <= int(choices.min()) and int(choices.max()) <= 7
    before = corner_backward.launches
    g2, choices2 = corner_backward.corner_backward(
        static, xt, tc[0], tc[1:], La, mask, k, salt, static.n_entries,
        with_choices=True)
    g3 = corner_backward.corner_backward_into(
        torch.zeros_like(g), static, xt, tc[0], tc[1:], La, mask, k, salt)
    t = torch.zeros(static.n_entries, 2, requires_grad=True)
    f, j = he.make_encode_with_jacobian_cv(static, La, corner_samples=k,
                                           corner_salt=salt)(t, xt, 3)
    loss = (f * tc[0]).sum() + sum((j[d] * tc[1 + d]).sum()
                                   for d in range(3))
    (g4,) = torch.autograd.grad(loss, t)
    assert corner_backward.launches == before
    assert torch.equal(choices2, choices)
    for other in (g2, g3, g4):
        assert torch.equal(other.view(torch.int32), g.view(torch.int32))
    # the locked levels add nothing: their cotangents are all zero
    for lvl in (3, 4):
        off, size = int(static.offsets[lvl]), int(static.table_sizes[lvl])
        assert not bool(g[off:off + size].any())


def test_non_contiguous_cotangents_read_their_columns():
    """Cotangents that come out of autograd as views (here transposed
    copies) give the contiguous ones' gradient and choices."""
    _, static = _statics("hashed")
    _, x, cots = _inputs(static, 5)
    xt = torch.from_numpy(x)
    tc = [torch.from_numpy(c) for c in cots]
    views = [torch.from_numpy(np.ascontiguousarray(c.T)).T for c in cots]
    assert not any(v.is_contiguous() for v in views)
    mask = (1.0,) * 6
    want = corner_backward.corner_backward(static, xt, tc[0], tc[1:], 6,
                                           mask, 2, 1, static.n_entries,
                                           with_choices=True)
    got = corner_backward.corner_backward(static, xt, views[0], views[1:],
                                          6, mask, 2, 1, static.n_entries,
                                          with_choices=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,salt,valid_level,n_active",
                         [("small", 0, None, None), ("small", 3, 2, None),
                          ("hashed", 7, 4, 5), ("f4", 1, None, 3),
                          ("small", 2**31, None, None)])
def test_level_constants_equal_the_twins(name, salt, valid_level, n_active):
    """The per-level constants that the wrappers hand the kernels equal,
    bit for bit, the float32 values the plain versions multiply by (the
    lattice scale, the unlock mask, scale·m as `tensor * (scale * m)`
    rounds it) and the draw stream `_draws` takes (salt·La + level, mod
    2^32, the uniforms equal); the tables' ints are HashGridStatic's."""
    _, static = _statics(name)
    La = _active(static, n_active)
    mask = he._level_mask(La, valid_level)
    lv = hash_corners.level_constants(static, La, mask, salt)
    assert lv.dtype == hash_corners.LEVEL_DTYPE and lv.shape == (La,)
    assert hash_corners.LEVEL_DTYPE.itemsize == 36
    one = torch.ones(1)
    x = torch.from_numpy(_inputs(static, 6, 64)[1])
    base = he._position_hash(x)
    for lvl in range(La):
        _, _, _, scale = he._level_corner_arrays(x, static, lvl)
        m = mask[lvl]
        for field, twin in (("scale", one * scale), ("m", one * m),
                            ("scale_m", one * (scale * m))):
            assert np.float32(lv[field][lvl]).view(np.uint32) \
                == twin.numpy().view(np.uint32)[0], (lvl, field)
        assert int(lv["stream"][lvl]) == (salt * La + lvl) % 2**32
        for k in (1, 3):
            for a, b in zip(he._draws(base, int(lv["stream"][lvl]), k),
                            he._draws(base, salt * La + lvl, k)):
                assert torch.equal(a, b)
        assert (lv["res"][lvl], lv["size"][lvl], lv["offset"][lvl],
                lv["hashed"][lvl]) == (
            static.resolutions[lvl], static.table_sizes[lvl],
            static.offsets[lvl], static.hashed[lvl])
        size = int(static.table_sizes[lvl])
        pow2 = size & (size - 1) == 0
        assert int(lv["size_mask"][lvl]) == (size - 1 if pow2 else 0)


@pytest.mark.parametrize("size", [1, 2, 3, 4096, 13824, 39304, 125000,
                                  373248, 1 << 14, 1 << 19, (1 << 19) + 8,
                                  (1 << 31) - 1, 1 << 31])
def test_size_mask_takes_the_remainder_bit_for_bit(size):
    """`size_mask` is size − 1 exactly when the size is a power of two,
    else 0; where it is set, h & mask equals h % size for uint32 hashes
    (numpy), so the kernels' mask gives the plain version's rows."""
    mask = hash_corners.size_mask(size)
    assert mask == (size - 1 if size & (size - 1) == 0 else 0)
    h = np.random.default_rng(size).integers(0, 2**32, 4096,
                                             dtype=np.uint64)
    h[:4] = [0, 1, 2**32 - 1, 2**31]
    if mask or size == 1:
        np.testing.assert_array_equal(h & np.uint64(mask),
                                      h % np.uint64(size))


def test_level_const_layout_matches_the_header():
    """hash_corners.cuh's LevelConst has LEVEL_DTYPE's fields in its order
    and of its widths, and asserts its size."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "rnb_neus2_torch", "csrc",
                           "hash_corners.cuh")) as f:
        src = f.read()
    body = src[src.index("struct LevelConst {"):]
    body = body[:body.index("};")]
    fields = re.findall(r"^\s*(float|int|uint32_t) (\w+);", body, re.M)
    kinds = {"float": "<f4", "int": "<i4", "uint32_t": "<u4"}
    assert [(name, kinds[t]) for t, name in fields] == [
        (name, hash_corners.LEVEL_DTYPE.fields[name][0].str)
        for name in hash_corners.LEVEL_DTYPE.names]
    assert (f"static_assert(sizeof(LevelConst) == "
            f"{hash_corners.LEVEL_DTYPE.itemsize}") in src


@pytest.mark.parametrize("module", [encode_jacobian, corner_backward],
                         ids=["forward", "backward"])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_tile_plan_fits_shared_memory(module, F):
    """For every L ≤ 32 the kernel's tile is a positive multiple of 32 of
    at most its TILE samples, its stages (two, or one only where two
    tiles of 32 do not fit) fit the 227 KB a block may use, and two
    stages are taken wherever they fit."""
    for L in range(1, hash_corners.MAX_LEVELS + 1):
        T, stages = hash_corners.tile_plan(L, F, module.TILE)
        assert T % 32 == 0 and 32 <= T <= module.TILE, (L, T)
        assert stages in (1, 2)
        smem = (hash_corners.BARRIER_BYTES
                + stages * hash_corners.stage_bytes(T, L, F))
        assert smem <= hash_corners.BLOCK_SHARED_BYTES == 227 * 1024, L
        two = (hash_corners.BARRIER_BYTES
               + 2 * hash_corners.stage_bytes(32, L, F))
        assert stages == (2 if two <= hash_corners.BLOCK_SHARED_BYTES
                          else 1), L
    assert hash_corners.tile_plan(32, 8, module.TILE) == (32, 1)


def _refusal_args(static, **change):
    """Valid arguments of both wrappers at `static`, with `change`
    applied: table, positions, cotangents, La, mask, k."""
    F = static.cfg.n_features_per_level
    n, LF = 8, static.cfg.output_dim
    args = dict(table=torch.zeros(static.n_entries, F),
                positions=torch.rand(n, 3),
                cots=[torch.zeros(n, LF) for _ in range(4)],
                La=static.cfg.n_levels, mask=(1.0,) * static.cfg.n_levels,
                k=1)
    args.update(change)
    return args


def _call_forward(static, a):
    return encode_jacobian.encode_jacobian(a["table"], a["positions"],
                                           static, a["La"], a["mask"])


def _call_backward(static, a):
    return corner_backward.corner_backward(
        static, a["positions"], a["cots"][0], a["cots"][1:], a["La"],
        a["mask"], a["k"], 0, static.n_entries)


def _static(**cfg):
    return he.HashGridStatic(HashGridConfig(**cfg))


REFUSALS = {
    # name: (config, changes, which wrappers, exception)
    "table_float64": ({}, lambda s: dict(
        table=torch.zeros(s.n_entries, 2, dtype=torch.float64)),
        "forward", TypeError),
    "positions_float64": ({}, lambda s: dict(
        positions=torch.rand(8, 3, dtype=torch.float64)), "both",
        TypeError),
    "cotangent_float16": ({}, lambda s: dict(
        cots=[torch.zeros(8, s.cfg.output_dim, dtype=torch.float16)] * 4),
        "backward", TypeError),
    "positions_2d": ({}, lambda s: dict(positions=torch.rand(8, 2)),
                     "both", ValueError),
    "positions_1d": ({}, lambda s: dict(positions=torch.rand(24)),
                     "both", ValueError),
    "table_rows": ({}, lambda s: dict(table=torch.zeros(100, 2)),
                   "forward", ValueError),
    "cotangent_width": ({}, lambda s: dict(
        cots=[torch.zeros(8, 5)] * 4), "backward", ValueError),
    "cotangent_rows": ({}, lambda s: dict(
        cots=[torch.zeros(9, s.cfg.output_dim)] * 4), "backward",
        ValueError),
    "two_jacobian_cotangents": ({}, lambda s: dict(
        cots=[torch.zeros(8, s.cfg.output_dim)] * 3), "backward",
        ValueError),
    "features_3": ({"n_features_per_level": 3}, lambda s: {}, "both",
                   ValueError),
    "features_16": ({"n_features_per_level": 16}, lambda s: {}, "both",
                    ValueError),
    "k_0": ({}, lambda s: dict(k=0), "backward", ValueError),
    "k_17": ({}, lambda s: dict(k=17), "backward", ValueError),
    "levels_33": ({"n_levels": 33, "top_resolution": 64},
                  lambda s: {}, "both", ValueError),
    "active_past_levels": ({}, lambda s: dict(La=15, mask=(1.0,) * 15),
                           "both", ValueError),
    "too_few_masks": ({}, lambda s: dict(mask=(1.0,) * 3), "both",
                      ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_check_inputs_refuses(case):
    """Each wrapper raises on what its kernel does not take, on the CPU
    too (the checks come before the device's dispatch), and launches
    nothing."""
    cfg, change, which, exc = REFUSALS[case]
    static = _static(**cfg)
    args = _refusal_args(static, **change(static))
    calls = {"forward": [_call_forward], "backward": [_call_backward],
             "both": [_call_forward, _call_backward]}[which]
    before = (encode_jacobian.launches, corner_backward.launches)
    for call in calls:
        with pytest.raises(exc):
            call(static, args)
    assert (encode_jacobian.launches, corner_backward.launches) == before


def test_check_out_refuses():
    """The in-place entry points refuse outputs of another shape, type or
    layout."""
    static = _static()
    a = _refusal_args(static)
    LF = static.cfg.output_dim
    good = [torch.zeros(8, LF) for _ in range(4)]
    for outs in (good[:3], [torch.zeros(8, LF + 1)] + good[1:],
                 [torch.zeros(8, LF, dtype=torch.float64)] + good[1:],
                 [torch.zeros(LF, 8).T] + good[1:]):
        with pytest.raises(ValueError):
            encode_jacobian.encode_jacobian_into(
                outs, a["table"], a["positions"], static, a["La"], a["mask"])
    g = torch.zeros(static.n_entries, 2)
    bad = [(g[:-1], None), (g.double(), None), (g.T.contiguous().T, None),
           (g, torch.zeros(14, 1, 8, dtype=torch.int32)),
           (g, torch.zeros(14, 2, 8, dtype=torch.int8)),
           (g, torch.zeros(14, 1, 16, dtype=torch.int8)[..., ::2])]
    for table_grad, choices in bad:
        with pytest.raises(ValueError):
            corner_backward.corner_backward_into(
                table_grad, static, a["positions"], a["cots"][0],
                a["cots"][1:], a["La"], a["mask"], 1, 0, choices)


def test_kernel_modules_import_and_run_without_nvcc():
    """Nothing is built at import: with no nvcc on PATH both modules
    import and their CPU entry points run."""
    code = ("import torch\n"
            "from rnb_neus2_torch.config import HashGridConfig\n"
            "from rnb_neus2_torch.kernels import build, corner_backward, "
            "encode_jacobian\n"
            "from rnb_neus2_torch.ops import hash_encoding as he\n"
            "s = he.HashGridStatic(HashGridConfig(n_levels=2, "
            "top_resolution=16))\n"
            "t, x = torch.zeros(s.n_entries, 2), torch.rand(5, 3)\n"
            "out = encode_jacobian.encode_jacobian(t, x, s, 2, (1.0, 1.0))\n"
            "g = corner_backward.corner_backward(s, x, *out[:1], out[1:], 2,"
            " (1.0, 1.0), 1, 0, s.n_entries)\n"
            "assert not build._LOADED, build._LOADED\n"
            "print('ok', g.shape[0])\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["ok", str(_static(
        n_levels=2, top_resolution=16).n_entries)]
