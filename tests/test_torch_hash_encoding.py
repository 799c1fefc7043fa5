"""Hash-grid encoding of the PyTorch port against the JAX package: hash
indices bit for bit, features and jacobians, the exact table gradient,
the stochastic K-corner backward's draws (bit for bit) and table
gradient, and the plain version of the small-level gradient kernel
against the Pallas kernel in interpret mode."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rnb_neus2_tpu.config import HashGridConfig as JHashGridConfig
from rnb_neus2_tpu.ops import hash_encoding as jhe
from rnb_neus2_torch import interop
from rnb_neus2_torch.config import HashGridConfig
from rnb_neus2_torch.kernels import hash_grad_small, scatter_add
from rnb_neus2_torch.ops import hash_encoding as he

# small config with 3 dense and 3 hashed levels; the default config;
# a config whose every level is hashed (2^10-entry tables)
CONFIGS = {
    "small": dict(n_levels=6, top_resolution=128, log2_hashmap_size=14),
    "default": dict(),
    "hashed": dict(n_levels=6, top_resolution=128, log2_hashmap_size=10),
}


def _positions(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 3)).astype(np.float32)
    # lattice-aligned and boundary points
    x[:4] = np.array([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5],
                      [1, 0, 0.25]], np.float32)
    return x


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_hash_indices_bitwise(name):
    """Every level's 8 corner indices equal the JAX package's uint32 hash
    and dense index bit for bit."""
    jstatic = jhe.HashGridStatic(JHashGridConfig(**CONFIGS[name]))
    static = he.HashGridStatic(HashGridConfig(**CONFIGS[name]))
    x = _positions(517, 0)
    assert static.n_entries == jstatic.n_entries
    for lvl in range(static.cfg.n_levels):
        j_idx, j_w, j_dw, _ = jhe._level_corner_arrays(jnp.asarray(x),
                                                       jstatic, lvl)
        idx, w, dw, _ = he._level_corner_arrays(torch.from_numpy(x), static,
                                                lvl)
        want = np.stack([np.asarray(i) for i in j_idx], axis=1)
        np.testing.assert_array_equal(idx.numpy(), want.astype(np.int64))
        np.testing.assert_array_equal(
            w.numpy(), np.stack([np.asarray(v) for v in j_w], axis=1))
        for d in range(3):
            np.testing.assert_array_equal(
                dw[..., d].numpy(),
                np.stack([np.asarray(v[d]) for v in j_dw], axis=1))


def test_corner_indices_wrap_like_uint32():
    """Negative lattice coordinates wrap as uint32 casts do in JAX."""
    pos = np.array([[-1, -7, 3], [2049, -2049, 77], [-1, -1, -1]], np.int32)
    want = jhe._corner_indices(jnp.asarray(pos), jnp.int32(0),
                               jnp.int32(1 << 19), jnp.int32(1))
    got = he._corner_indices(torch.from_numpy(pos).long(), 0, 1 << 19, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _table(static, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((static.n_entries, 2)).astype(np.float32)


@pytest.mark.parametrize("valid_level,n_active", [(None, None), (4, None),
                                                  (2, 3)])
def test_encode_with_jacobian_matches_jax(valid_level, n_active):
    cfg = CONFIGS["small"]
    jstatic = jhe.HashGridStatic(JHashGridConfig(**cfg))
    static = he.HashGridStatic(HashGridConfig(**cfg))
    table = _table(static, 1)
    x = _positions(301, 2)
    jf, jj = jhe.make_encode_with_jacobian_cv(jstatic, n_active)(
        jnp.asarray(table), jnp.asarray(x), valid_level)
    f, j = he.make_encode_with_jacobian_cv(static, n_active)(
        torch.from_numpy(table), torch.from_numpy(x), valid_level)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-6)
    for d in range(3):
        np.testing.assert_allclose(j[d].numpy(), np.asarray(jj[d]),
                                   rtol=1e-5, atol=1e-6)
    cols = he.encode_columns(torch.from_numpy(table), torch.from_numpy(x),
                             static, valid_level, n_active)
    jcols = jhe.encode_columns(jnp.asarray(table), jnp.asarray(x), jstatic,
                               valid_level, n_active)
    np.testing.assert_allclose(cols.numpy(), np.asarray(jcols), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("valid_level,n_active", [(None, None), (4, 5)])
def test_exact_table_gradient_matches_jax(monkeypatch, valid_level,
                                          n_active):
    """The port's 8-corner backward (plain versions on the CPU) against the
    JAX exact backward in its width-1 scatter mode, on features and
    jacobian cotangents at once. Untouched entries are exactly zero in
    both."""
    monkeypatch.setattr(jhe, "_SCATTER_MODE", "width1")
    cfg = CONFIGS["small"]
    jstatic = jhe.HashGridStatic(JHashGridConfig(**cfg))
    static = he.HashGridStatic(HashGridConfig(**cfg))
    table = _table(static, 3)
    x = _positions(193, 4)
    rng = np.random.default_rng(5)
    L2 = static.cfg.output_dim
    cot_f = rng.standard_normal((193, L2)).astype(np.float32)
    cot_j = [rng.standard_normal((193, L2)).astype(np.float32)
             for _ in range(3)]

    jfn = jhe.make_encode_with_jacobian_cv(jstatic, n_active)

    def jloss(t):
        f, j = jfn(t, jnp.asarray(x), valid_level)
        return jnp.vdot(f, cot_f) + sum(jnp.vdot(j[d], cot_j[d])
                                        for d in range(3))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(table)))

    t = torch.from_numpy(table).requires_grad_(True)
    f, j = he.make_encode_with_jacobian_cv(static, n_active)(
        t, torch.from_numpy(x), valid_level)
    loss = (f * torch.from_numpy(cot_f)).sum() + sum(
        (j[d] * torch.from_numpy(cot_j[d])).sum() for d in range(3))
    (got,) = torch.autograd.grad(loss, t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.numpy() == 0.0, want == 0.0)


def test_small_kernel_plain_version_matches_pallas():
    """The kernel's plain version against the Pallas kernel it replaces,
    run in interpret mode, including indices that both drop."""
    S, n = 512, 300
    rng = np.random.default_rng(6)
    idx = rng.integers(0, S, n).astype(np.int32)
    idx[:7] = [S, S + 1, 1 << 20, S - 1, 0, S + 127, S]
    cf = rng.standard_normal((n, 2)).astype(np.float32)
    want = jhe.grad_onehot_mxu(jnp.asarray(idx), jnp.asarray(cf), S,
                               interpret=True)
    before = hash_grad_small.launches
    got = hash_grad_small.grad_small(torch.from_numpy(idx),
                                     torch.from_numpy(cf), S)
    assert hash_grad_small.launches == before      # CPU: no kernel launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    untouched = np.setdiff1d(np.arange(S), idx)
    assert np.all(got.numpy()[untouched] == 0.0)


def test_small_kernel_wrapper_rejects_bad_inputs():
    idx = torch.zeros(8, dtype=torch.int32)
    cf = torch.zeros(8, 2)
    with pytest.raises(TypeError):
        hash_grad_small.grad_small(idx.long(), cf, 16)
    with pytest.raises(TypeError):
        hash_grad_small.grad_small(idx, cf.double(), 16)
    with pytest.raises(ValueError):
        hash_grad_small.grad_small(idx[:4], cf, 16)
    with pytest.raises(ValueError):
        hash_grad_small.grad_small(idx, cf[:, 0], 16)
    assert hash_grad_small.grad_small(idx[:0], cf[:0], 16).shape == (16, 2)


def test_small_levels_route_to_kernel():
    """At the default config exactly levels 0 and 1 (4096 and 13,824
    entries) take the kernel."""
    static = he.HashGridStatic(HashGridConfig())
    assert [int(s) for s in static.table_sizes[:2]] == [4096, 13824]
    assert list(he.levels_through_kernel(static)) == [0, 1]
    assert list(he.levels_through_kernel(static, 1)) == [0]


@pytest.mark.parametrize("base_resolution", [16, 31, 32])
def test_kernel_levels_are_the_pallas_levels(monkeypatch, base_resolution):
    """A level takes the kernel exactly where the JAX package takes
    `grad_onehot_mxu` on the TPU, also where its (S, F) histogram is over
    one block's shared memory (base resolution 31 or 32: a level 0 of
    29,791 or 32,768 rows at F = 2). The backward sends that level to the
    kernel's in-place wrapper, whose cluster of 8 blocks holds such a table
    whole: one copy per 2 blocks where one block cannot hold it."""
    monkeypatch.setattr(jhe, "_SCATTER_MODE", "auto")
    cfg = dict(n_levels=3, base_resolution=base_resolution)
    jstatic = jhe.HashGridStatic(JHashGridConfig(**cfg))
    static = he.HashGridStatic(HashGridConfig(**cfg))
    mxu = [lvl for lvl in range(3)
           if jhe._bwd_formulation(jstatic, lvl, True) == "mxu"]
    assert list(he.levels_through_kernel(static)) == mxu == [0]
    size = int(static.table_sizes[0])
    assert size == -(-base_resolution ** 3 // 8) * 8
    g = hash_grad_small.replica_blocks(size, 2)
    assert g == (1 if base_resolution == 16 else 2)
    assert hash_grad_small.takes(size, 2)
    rows = -(-size // g)
    assert hash_grad_small.block_bytes(size, 2, g) == (
        rows * 8 + -(-rows // 32) * 4)

    calls = []
    real = hash_grad_small.grad_small_into

    def spy(out, idx, cf):
        calls.append((idx.shape[0], out.shape[0]))
        return real(out, idx, cf)

    monkeypatch.setattr(hash_grad_small, "grad_small_into", spy)
    t = torch.from_numpy(_table(static, 8)).requires_grad_(True)
    f, j = he.make_encode_with_jacobian_cv(static)(
        t, torch.from_numpy(_positions(50, 9)))
    (f.sum() + j[0].sum()).backward()
    assert calls == [(8 * 50, size)]


def test_stochastic_backward_not_ported_raises():
    """The stochastic backward (once refused here) runs: at K = 1 each
    sample adds to one corner per level, so a level's gradient touches at
    most N rows, while the forward is the exact one."""
    static = he.HashGridStatic(HashGridConfig(**CONFIGS["small"]))
    table = torch.from_numpy(_table(static, 10))
    x = torch.from_numpy(_positions(40, 11))
    outs = []
    for k in (0, 1):
        t = table.clone().requires_grad_(True)
        f, j = he.make_encode_with_jacobian_cv(static, corner_samples=k)(
            t, x)
        (g,) = torch.autograd.grad(f.sum() + j[2].sum(), t)
        outs.append((f.detach(), g))
    (f0, g0), (f1, g1) = outs
    assert torch.equal(f0, f1)
    for lvl in range(static.cfg.n_levels):
        off, size = int(static.offsets[lvl]), int(static.table_sizes[lvl])
        rows = int((g1[off:off + size] != 0).any(1).sum())
        assert 0 < rows <= 40
        assert rows <= int((g0[off:off + size] != 0).any(1).sum())
    with pytest.raises(ValueError):
        he.make_encode_with_jacobian_cv(static, corner_samples=-1)


@pytest.mark.parametrize("k,valid_level", [(0, None), (1, None), (2, 5)])
def test_table_gradient_bitwise_as_before(k, valid_level):
    """The backward adds every level into its rows of the one zeroed table
    gradient in place. On the CPU that gives, bit for bit, the table
    gradient of the per-level allocate-and-copy it replaces: the level's
    corner cotangents (and K-corner picks), the plain scatter into a zeroed
    (size, F) table, and a copy into the level's rows."""
    static = he.HashGridStatic(HashGridConfig(**CONFIGS["small"]))
    L, F = static.cfg.n_levels, static.cfg.n_features_per_level
    x = torch.from_numpy(_positions(157, 17))
    rng = np.random.default_rng(18)
    cots = [torch.from_numpy(rng.standard_normal(
        (157, static.cfg.output_dim)).astype(np.float32)) for _ in range(4)]
    t = torch.from_numpy(_table(static, 19) * np.float32(1e-2)
                         ).requires_grad_(True)
    f, j = he.make_encode_with_jacobian_cv(static, corner_samples=k)(
        t, x, valid_level)
    loss = (f * cots[0]).sum() + sum((j[d] * cots[1 + d]).sum()
                                     for d in range(3))
    (got,) = torch.autograd.grad(loss, t)

    want = torch.zeros_like(got)
    base = he._position_hash(x)
    mask = he._level_mask(L, valid_level)
    for lvl in range(L):
        idx, src = he.level_corner_cotangents(x, static, lvl, cots[0],
                                              cots[1:], mask[lvl])
        if k:
            _, idx, src = he.pick_corners(idx, src, he._draws(base, lvl, k),
                                          k)
        off, size = int(static.offsets[lvl]), int(static.table_sizes[lvl])
        want[off:off + size] = scatter_add.plain(
            idx.reshape(-1).to(torch.int32), src.reshape(-1, F).contiguous(),
            size)
    assert bool((want != 0).any())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _uniform_positions(n, seed):
    """Positions whose float32 bit patterns include ±0, 1, the float just
    below 1, denormals and random values: their 32-bit products with the
    mixing constants reach far past 2^63."""
    x = _positions(n, seed)
    x[:6] = np.array([[0.0, -0.0, 1.0], [0.99999994, 1e-45, 0.5],
                      [1.17e-39, 1.0, 0.99999994], [-0.0, -0.0, -0.0],
                      [1.0, 1.0, 1.0], [0.3, 1e-45, -0.0]], np.float32)
    return x


@pytest.mark.parametrize("salt", [0, 1, 5])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_hash_uniforms_bitwise(salt, k):
    """The stochastic backward's draws equal the JAX package's bit for
    bit."""
    x = _uniform_positions(1000, 12)
    want = jhe._hash_uniforms(jnp.asarray(x), salt, k)
    got = he._hash_uniforms(torch.from_numpy(x), salt, k)
    assert len(got) == len(want) == k
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))
        assert 0.0 <= float(g.min()) and float(g.max()) < 1.0


@pytest.mark.parametrize("name,k,valid_level,n_active", [
    ("hashed", 1, None, None), ("hashed", 1, 4, None), ("hashed", 1, 2, 5),
    ("hashed", 2, None, None), ("hashed", 2, 4, None), ("hashed", 2, 3, 3),
    ("small", 1, None, None), ("small", 2, 5, None)])
def test_stochastic_table_gradient_matches_jax(monkeypatch, name, k,
                                               valid_level, n_active):
    """The K-corner backward picks the JAX package's corners: the same
    table entries are non-zero, with values at rtol 1e-5 / atol 1e-7 of
    the largest. The JAX backward runs op by op (`jax.disable_jit`), so
    that no fused multiply-add moves a CDF bound by an ulp."""
    monkeypatch.setattr(jhe, "_SCATTER_MODE", "auto")
    cfg = CONFIGS[name]
    jstatic = jhe.HashGridStatic(JHashGridConfig(**cfg))
    static = he.HashGridStatic(HashGridConfig(**cfg))
    table = _table(static, 13) * np.float32(1e-2)
    x = _positions(211, 14)
    rng = np.random.default_rng(15)
    L2 = static.cfg.output_dim
    cot_f = rng.standard_normal((211, L2)).astype(np.float32)
    cot_j = [rng.standard_normal((211, L2)).astype(np.float32)
             for _ in range(3)]

    jfn = jhe.make_encode_with_jacobian_cv(jstatic, n_active,
                                           corner_samples=k)

    def jloss(t):
        f, j = jfn(t, jnp.asarray(x), valid_level)
        return jnp.vdot(f, cot_f) + sum(jnp.vdot(j[d], cot_j[d])
                                        for d in range(3))

    with jax.disable_jit():
        want = np.asarray(jax.grad(jloss)(jnp.asarray(table)))

    t = torch.from_numpy(table).requires_grad_(True)
    f, j = he.make_encode_with_jacobian_cv(static, n_active,
                                           corner_samples=k)(
        t, torch.from_numpy(x), valid_level)
    loss = (f * torch.from_numpy(cot_f)).sum() + sum(
        (j[d] * torch.from_numpy(cot_j[d])).sum() for d in range(3))
    (got,) = torch.autograd.grad(loss, t)
    got = got.numpy()
    np.testing.assert_array_equal(got != 0.0, want != 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-7 * np.abs(want).max())


def test_stochastic_backward_unbiased():
    """The K-corner backward is an unbiased estimator of the exact table
    gradient: the mean over 12 draw streams (`corner_salt`) at K = 16 lies
    closer to the exact gradient than one K = 2 draw does, by about
    sqrt(96) ≈ 9.8, within the band of the JAX package's slow test of the
    same estimator (6 to 14)."""
    static = he.HashGridStatic(HashGridConfig(**CONFIGS["hashed"]))
    rng = np.random.default_rng(16)
    table = torch.from_numpy(
        (rng.random((static.n_entries, 2)) * 2e-4 - 1e-4).astype(np.float32))
    n, L2 = 129, static.cfg.output_dim
    x = torch.from_numpy(rng.random((n, 3)).astype(np.float32))
    cots = [torch.from_numpy(rng.standard_normal((n, L2)).astype(np.float32))
            for _ in range(4)]

    def grad(k, salt=0):
        t = table.clone().requires_grad_(True)
        f, j = he.make_encode_with_jacobian_cv(
            static, corner_samples=k, corner_salt=salt)(t, x)
        loss = (f * cots[0]).sum() + sum((j[d] * cots[1 + d]).sum()
                                         for d in range(3))
        return torch.autograd.grad(loss, t)[0].double()

    exact = grad(0)
    l2 = exact.norm()
    err2 = float((grad(2) - exact).norm() / l2)
    err_salt = float((sum(grad(16, s) for s in range(12)) / 12
                      - exact).norm() / l2)
    assert err2 > 0.05            # the estimator is stochastic
    assert 6.0 < err2 / err_salt < 14.0, (err2, err_salt)


def test_interop_round_trip():
    from rnb_neus2_tpu.config import NetworkConfig as JNetworkConfig
    from rnb_neus2_tpu.models.neus_field import init_params
    jcfg = JHashGridConfig(**CONFIGS["small"])
    tree = jax.tree_util.tree_map(
        np.asarray, init_params(jax.random.PRNGKey(0), jcfg,
                                JNetworkConfig()))
    back = interop.params_to_jax(interop.params_from_jax(tree))
    flat_a, tdef_a = jax.tree_util.tree_flatten(tree)
    flat_b, tdef_b = jax.tree_util.tree_flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("valid_level", [None, 3])
@pytest.mark.parametrize("name", ["small", "hashed", "default"])
def test_position_differentiable_encode_matches_jax(name, valid_level):
    """`encode_with_jacobian` (the position-differentiable encode): the
    features and jacobians within 1e-6 of the JAX package's generic
    `encode_with_jacobian`, and the gradient wrt the positions and the
    table of a random linear loss of both within 1e-5 of `jax.grad`'s
    (relative to each gradient's largest entry). Positions on the lattice
    and on the cube's faces included; at the default config's 14 levels
    the second-order term carries the lattice scale squared (up to
    2048²)."""
    cfg = CONFIGS[name]
    jstatic = jhe.HashGridStatic(JHashGridConfig(**cfg))
    static = he.HashGridStatic(HashGridConfig(**cfg))
    table = _table(static, 7) * 1e-2
    x = _positions(257, 8)
    rng = np.random.default_rng(9)
    L2 = static.cfg.output_dim
    cot_f = rng.standard_normal((257, L2)).astype(np.float32)
    cot_j = [rng.standard_normal((257, L2)).astype(np.float32)
             for _ in range(3)]

    def jloss(t, xx):
        f, j = jhe.encode_with_jacobian(t, xx, jstatic, valid_level)
        return jnp.vdot(f, cot_f) + sum(jnp.vdot(j[d], cot_j[d])
                                        for d in range(3))

    jf, jj = jhe.encode_with_jacobian(jnp.asarray(table), jnp.asarray(x),
                                      jstatic, valid_level)
    want_t, want_x = (np.asarray(g) for g in jax.grad(jloss, (0, 1))(
        jnp.asarray(table), jnp.asarray(x)))

    t = torch.from_numpy(table).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    f, j = he.encode_with_jacobian(t, xt, static, valid_level)
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(jf),
                               rtol=1e-6, atol=1e-6)
    for d in range(3):
        np.testing.assert_allclose(j[d].detach().numpy(), np.asarray(jj[d]),
                                   rtol=1e-6, atol=1e-6 * float(
                                       np.abs(np.asarray(jj[d])).max()))
    loss = (f * torch.from_numpy(cot_f)).sum() + sum(
        (j[d] * torch.from_numpy(cot_j[d])).sum() for d in range(3))
    got_t, got_x = torch.autograd.grad(loss, (t, xt))
    for got, want in ((got_x, want_x), (got_t, want_t)):
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())
    np.testing.assert_array_equal(got_t.numpy() == 0.0, want_t == 0.0)


def test_position_grad_only_where_asked():
    """The training encode gives the positions no gradient (the JAX
    package's custom VJP zeroes it); the position-differentiable encode
    computes no table gradient for a table that requires none."""
    static = he.HashGridStatic(HashGridConfig(**CONFIGS["small"]))
    table = torch.from_numpy(_table(static, 10))
    x = torch.from_numpy(_positions(64, 11)).requires_grad_(True)
    f, _ = he.make_encode_with_jacobian_cv(static)(
        table.requires_grad_(True), x)
    (gx,) = torch.autograd.grad(f.sum(), x, allow_unused=True)
    assert gx is None
    calls = []
    orig = he.level_table_grad
    try:
        he.level_table_grad = lambda *a: calls.append(a)
        f, _ = he.encode_with_jacobian(table.detach(), x, static)
        (gx,) = torch.autograd.grad(f.sum(), x)
    finally:
        he.level_table_grad = orig
    assert not calls and torch.isfinite(gx).all()
