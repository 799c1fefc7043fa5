"""Cascaded occupancy (aabb_scale > 1) of the PyTorch port against the JAX
package: the mip selection, the per-cascade cell positions, the max-pool,
the update and the lookup bit for bit, and both marches over a (C, G³)
bitfield and over the scaled cube.

The mip is frexp's exponent (the reference's, testbed_nerf.cu:569-583).
The JAX package takes floor(log2(·)) in float32, which rounds up to the
power for a few ulps just below it; there the port is held against numpy's
frexp, and everywhere else against the JAX package bit for bit."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rnb_neus2_tpu.grid import occupancy as jocc
from rnb_neus2_tpu.ops import ray_march as jrm
from rnb_neus2_torch.grid import occupancy as occ
from rnb_neus2_torch.ops import ray_march as rm

G = 128          # the cascaded lookup's grid size (NERF_GRIDSIZE)


def _powers_and_neighbours():
    """Exact powers of two 2^-24 … 2^1 and their float neighbours:
    (at or above a power, just below one)."""
    at, below = [], []
    for k in range(-24, 2):
        v = np.float32(2.0 ** k)
        at.append(v)
        up = down = v
        for _ in range(3):
            up = np.nextafter(up, np.float32(4), dtype=np.float32)
            down = np.nextafter(down, np.float32(0), dtype=np.float32)
            at.append(up)
            below.append(down)
    return np.array(at, np.float32), np.array(below, np.float32)


def _positions_about_powers():
    """(n, 3) positions whose max|pos − 0.5| runs through the floats about
    0.5 + 2^k, k = −20 … 1 (x varies; pos − 0.5 is exact there), those
    maxvals, and which of them lie below their power of two."""
    xs, below = [], []
    for k in range(-20, 2):
        base = np.float32(0.5 + 2.0 ** k)
        xs.append(base)
        below.append(False)
        up = down = base
        for _ in range(3):
            up = np.nextafter(up, np.float32(8), dtype=np.float32)
            down = np.nextafter(down, np.float32(0), dtype=np.float32)
            xs += [up, down]
            below += [False, True]
    x = np.array(xs, np.float32)
    pos = np.stack([x, np.full_like(x, 0.5), np.full_like(x, 0.5)], 1)
    return pos, x - np.float32(0.5), np.array(below)


def _frexp_mip(v, max_cascade):
    return np.clip(np.frexp(np.maximum(v, np.float32(1e-30)))[1] + 1, 0,
                   max_cascade)


def test_mip_from_pos_at_powers_of_two():
    pos, v, below = _positions_about_powers()
    assert np.array_equal(np.abs(pos - np.float32(0.5)).max(1), v)
    got = occ.mip_from_pos(torch.from_numpy(pos), 30).numpy()
    want = np.asarray(jocc.mip_from_pos(jnp.asarray(pos), 30))
    at = ~below
    np.testing.assert_array_equal(got[at], want[at])
    np.testing.assert_array_equal(got, _frexp_mip(v, 30))


@pytest.mark.parametrize("max_cascade", [0, 2, 7])
def test_mip_from_pos_and_dt_bitwise(max_cascade):
    rng = np.random.default_rng(max_cascade)
    pos = rng.uniform(-2.0, 3.0, (20000, 3)).astype(np.float32)
    pos[:500] = 0.5                                   # maxval 0
    dt = (rng.random(20000) ** 4 * 0.05).astype(np.float32)
    np.testing.assert_array_equal(
        occ.mip_from_pos(torch.from_numpy(pos), max_cascade).numpy(),
        np.asarray(jocc.mip_from_pos(jnp.asarray(pos), max_cascade)))
    np.testing.assert_array_equal(
        occ.mip_from_dt(torch.from_numpy(dt), torch.from_numpy(pos),
                        max_cascade).numpy(),
        np.asarray(jocc.mip_from_dt(jnp.asarray(dt), jnp.asarray(pos),
                                    max_cascade)))


def test_mip_from_dt_at_powers_of_two():
    """x = dt·2G at exact powers of two and their neighbours above: bit
    for bit; just below: the frexp rule."""
    at, below = _powers_and_neighbours()
    for vals, exact in ((at, True), (below, False)):
        dt = vals / np.float32(2 * G)
        assert np.array_equal(dt * np.float32(2 * G), vals)
        pos = np.full((len(vals), 3), 0.5, np.float32)
        got = occ.mip_from_dt(torch.from_numpy(dt), torch.from_numpy(pos),
                              5).numpy()
        if exact:
            want = np.asarray(jocc.mip_from_dt(jnp.asarray(dt),
                                               jnp.asarray(pos), 5))
        else:
            e = np.frexp(vals)[1]
            want = np.where(vals < 1.0, 0, np.clip(np.maximum(e, 0), 0, 5))
        np.testing.assert_array_equal(got, want)


def _cascaded_state(C, seed):
    rng = np.random.default_rng(seed)
    dens = (rng.random((C, G ** 3)) * 0.2).astype(np.float32)
    dens[rng.random((C, G ** 3)) < 0.02] = -1.0
    j = jocc.OccupancyState(density=jnp.asarray(dens),
                            bitfield=jnp.asarray(dens > 0.1),
                            mean_density=jnp.float32(0.0),
                            ema_step=jnp.int32(2))
    t = occ.OccupancyState(density=torch.from_numpy(dens),
                           bitfield=torch.from_numpy(dens > 0.1),
                           mean_density=torch.tensor(0.0), ema_step=2)
    return j, t


def test_cascade_cell_positions_with_jax_jitter():
    g, C = 8, 3
    key = jax.random.PRNGKey(5)
    jitter = np.concatenate([
        np.array(jax.random.uniform(jax.random.fold_in(key, m), (g ** 3, 3)))
        for m in range(C)])
    got = occ.cascade_cell_positions(g, C, jitter=torch.from_numpy(jitter))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jocc.cascade_cell_positions(key, g, C)))
    # each cascade spans the cube of side 2^m about the centre
    for m in range(C):
        p = got[m * g ** 3:(m + 1) * g ** 3]
        assert float(p.min()) >= 0.5 - 2.0 ** (m - 1)
        assert float(p.max()) <= 0.5 + 2.0 ** (m - 1)
    gen = torch.Generator().manual_seed(0)
    drawn = occ.cascade_cell_positions(g, C, gen)
    assert drawn.shape == (C * g ** 3, 3)


def test_update_cascaded_and_maxpool_bitwise():
    jstate, state = _cascaded_state(3, 1)
    rng = np.random.default_rng(2)
    fresh = (rng.random((3, G ** 3)) * 0.15).astype(np.float32)
    jnew = jocc.update_cascaded(jstate, jnp.asarray(fresh))
    new = occ.update_cascaded(state, torch.from_numpy(fresh))
    np.testing.assert_array_equal(new.density.numpy(),
                                  np.asarray(jnew.density))
    np.testing.assert_array_equal(new.bitfield.numpy(),
                                  np.asarray(jnew.bitfield))
    # a float32 mean over 2M cells, summed in another order
    assert float(new.mean_density) == pytest.approx(
        float(jnew.mean_density), rel=1e-6)
    assert new.ema_step == int(jnew.ema_step)
    # the pooled fine cascade sits in the central eighth of the next
    bits = torch.zeros(2, G ** 3, dtype=torch.bool)
    bits[0, 0] = True                         # corner cell of cascade 0
    pooled = occ._maxpool_into_next(bits, G)
    q = G // 4
    assert bool(pooled[1].reshape(G, G, G)[q, q, q])
    assert int(pooled[1].sum()) == 1
    np.testing.assert_array_equal(
        pooled.numpy(),
        np.asarray(jocc._maxpool_into_next(jnp.asarray(bits.numpy()), G)))
    assert occ.init_state_cascaded(8, 3).bitfield.shape == (3, 512)


def test_lookup_cascaded_bitwise():
    _, state = _cascaded_state(4, 3)
    rng = np.random.default_rng(4)
    pos = rng.uniform(-3.0, 4.0, (30000, 3)).astype(np.float32)
    dt = (rng.random(30000) * 0.08).astype(np.float32)
    bit = state.bitfield
    for d in (None, dt):
        got = occ.lookup_cascaded(bit, torch.from_numpy(pos),
                                  None if d is None else torch.from_numpy(d))
        want = jocc.lookup_cascaded(jnp.asarray(bit.numpy()),
                                    jnp.asarray(pos),
                                    None if d is None else jnp.asarray(d))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel()


def _rays(R, seed, scale):
    """Rays from outside the scaled cube towards its inside."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3))
    o = 0.5 + 0.9 * scale * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = 0.5 + (rng.random((R, 3)) - 0.5) * 0.6 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), \
        rng.random(R).astype(np.float32)


def _cascaded_bits(C, seed):
    """A (C, G³) bitfield made by `update_cascaded` from a ball of
    density."""
    key = jax.random.PRNGKey(seed)
    pts = np.asarray(jocc.cascade_cell_positions(key, G, C))
    r = np.linalg.norm(pts - 0.5, axis=1)
    dens = np.where(np.abs(r - 0.3) < 0.05, 1.0, 0.0).astype(np.float32)
    st = occ.update_cascaded(occ.init_state_cascaded(G, C),
                             torch.from_numpy(dens.reshape(C, -1)))
    return st.bitfield


@pytest.mark.parametrize("cone", [0.0, 1.0 / 256.0])
def test_cascaded_march_matches_jax(cone):
    """`march` over 3 cascades at aabb_scale 4: valid and n_valid bit for
    bit, t and dt bit for bit at cone 0 and within 1e-6 relative at cone >
    0 (the ladder's float power)."""
    bit = _cascaded_bits(3, 0)
    o, d, u = _rays(128, 1, 4.0)
    with jax.disable_jit():
        want = jrm.march(jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(bit.numpy()), jnp.asarray(u), 1024, 64,
                         cone, aabb_scale=4.0)
    got = rm.march(torch.from_numpy(o), torch.from_numpy(d), bit,
                   torch.from_numpy(u), 1024, 64, cone, aabb_scale=4.0)
    for name in ("valid", "n_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for name in ("t", "dt"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if cone:
            np.testing.assert_allclose(g, w, rtol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)
    assert int(got.n_valid.sum()) > 0


@pytest.mark.parametrize("cone,cascaded", [(0.0, True), (1.0 / 256.0, True),
                                           (0.0, False),
                                           (1.0 / 256.0, False)])
def test_march_flat_aabb_scale_matches_jax(cone, cascaded):
    """`march_flat` at aabb_scale 4 over a (3, G³) bitfield (the
    single-phase ladder, as JAX's auto-select takes for a 2-D bitfield) or
    a 1-D one (blocked at cone 0): the integer outputs bit for bit, t and
    dt bit for bit at cone 0 and within 1e-6 relative at cone > 0."""
    bit = _cascaded_bits(3, 2)
    if not cascaded:
        bit = bit[0]
    o, d, u = _rays(200, 3, 4.0 if cascaded else 1.0)
    S = 1 << 12
    want = jrm.march_flat(jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(bit.numpy()), jnp.asarray(u), 1024, S,
                          cone, aabb_scale=4.0)
    got = rm.march_flat(torch.from_numpy(o), torch.from_numpy(d), bit,
                        torch.from_numpy(u), 1024, S, cone, aabb_scale=4.0)
    for f in ("ray_id", "valid", "seg_start", "n_valid", "ray_kept"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("t", "dt"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if cone:
            np.testing.assert_allclose(g, w, rtol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)
    assert int(got.valid.sum()) > 0
