"""The global-atomics scatter-add kernel's plain version against the JAX
package (its width-1 `.at[].add` scatters and the Pallas one-hot kernel in
interpret mode), the encode backward's routing of every level to one of
the two kernels, and the probe-timing entry point on the CPU."""

import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rnb_neus2_tpu.ops import hash_encoding as jhe
from rnb_neus2_torch.config import HashGridConfig
from rnb_neus2_torch.kernels import (corner_backward, hash_grad_small,
                                     scatter_add)
from rnb_neus2_torch.ops import hash_encoding as he
from rnb_neus2_torch.tools import bench_scatter


def _inputs(n, S, F, seed):
    """Indices in [0, S) with some at or past S (dropped by both), and
    random-normal values."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, S, n).astype(np.int32)
    idx[:6] = [S, S + 1, 1 << 20, S - 1, 0, 2 * S]
    v = rng.standard_normal((n, F)).astype(np.float32)
    return idx, v


@pytest.mark.parametrize("F", [1, 2])
def test_plain_matches_jax_width1_scatter(F):
    """Per column, `jnp.zeros(S).at[idx].add(v, mode="drop")`, the JAX
    package's scatter of the hashed levels."""
    S, n = 1000, 3000
    idx, v = _inputs(n, S, F, F)
    before = scatter_add.launches
    got = scatter_add.scatter_add(torch.from_numpy(idx), torch.from_numpy(v),
                                  S)
    assert scatter_add.launches == before      # CPU: no kernel launch
    assert got.shape == (S, F)
    for f in range(F):
        want = jnp.zeros((S,), jnp.float32).at[jnp.asarray(idx)].add(
            jnp.asarray(v[:, f]), mode="drop")
        np.testing.assert_allclose(got[:, f].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    untouched = np.setdiff1d(np.arange(S), idx)
    assert len(untouched) and np.all(got.numpy()[untouched] == 0.0)


def test_plain_matches_pallas_onehot():
    """At a reduced shape of the one-hot probes (S = 4096, F = 2, ones as
    the probes add, and random values), against the Pallas kernel run in
    interpret mode."""
    S, n = 4096, 2500
    idx, v = _inputs(n, S, 2, 7)
    for vals in (np.ones_like(v), v):
        want = jhe.grad_onehot_mxu(jnp.asarray(idx), jnp.asarray(vals), S,
                                   interpret=True)
        got = scatter_add.plain(torch.from_numpy(idx),
                                torch.from_numpy(vals), S)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_wrapper_rejects_bad_inputs():
    idx = torch.zeros(8, dtype=torch.int32)
    v = torch.zeros(8, 2)
    with pytest.raises(TypeError):
        scatter_add.scatter_add(idx.long(), v, 16)
    with pytest.raises(TypeError):
        scatter_add.scatter_add(idx, v.double(), 16)
    with pytest.raises(ValueError):
        scatter_add.scatter_add(idx[:4], v, 16)
    with pytest.raises(ValueError):
        scatter_add.scatter_add(idx, v, 0)
    assert scatter_add.scatter_add(idx[:0], v[:0], 16).shape == (16, 2)


INTO = {"scatter_add": scatter_add.scatter_add_into,
        "hash_grad_small": hash_grad_small.grad_small_into}
ALLOCATING = {"scatter_add": scatter_add.scatter_add,
              "hash_grad_small": hash_grad_small.grad_small}


@pytest.mark.parametrize("mode", ["zeroed", "nonzero", "misaligned"])
@pytest.mark.parametrize("name", sorted(INTO))
def test_plain_in_place_into_an_offset_view(name, mode):
    """Each in-place wrapper (its plain version on the CPU) adds into a
    contiguous (S, F) view of a larger buffer: every float outside the
    view keeps its bits, every row that no element touches keeps its bits,
    and the view holds its earlier contents plus the scatter (numpy's
    `np.add.at` on the kept indices), zeroed or not, aligned or not."""
    S, n, F = 700, 2500, 2
    idx, v = _inputs(n, S, F, 21)
    gen = torch.Generator()
    gen.manual_seed(22)
    buf, view = bench_scatter.in_place_view(
        S, F, torch.device("cpu"), gen, nonzero=mode == "nonzero",
        misaligned=mode == "misaligned")
    assert view.is_contiguous() and view.shape == (S, F)
    assert (view.data_ptr() % 8 == 4) == (mode == "misaligned")
    assert bool((view != 0).any()) == (mode == "nonzero")
    want = view.numpy().copy()
    keep = (idx >= 0) & (idx < S)
    np.add.at(want, idx[keep], v[keep])
    before = scatter_add.launches, hash_grad_small.launches
    err = bench_scatter.check_in_place(name, INTO[name], buf, view,
                                       torch.from_numpy(idx),
                                       torch.from_numpy(v))
    assert (scatter_add.launches, hash_grad_small.launches) == before
    assert err == 0.0                  # the wrapper is the plain version
    np.testing.assert_allclose(view.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(INTO))
def test_allocating_wrapper_equals_in_place_on_zeros(name):
    S, n = 1000, 3000
    idx, v = _inputs(n, S, 2, 23)
    idx, v = torch.from_numpy(idx), torch.from_numpy(v)
    got = ALLOCATING[name](idx, v, S)
    want = INTO[name](torch.zeros(S, 2), idx, v)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("name", sorted(INTO))
def test_in_place_wrapper_refuses_a_bad_out(name):
    """A non-contiguous, wrongly shaped, wrongly typed or 1-D `out` is
    refused, on the CPU as on the card."""
    fn = INTO[name]
    idx = torch.zeros(8, dtype=torch.int32)
    v = torch.ones(8, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.zeros(2, 16).T, idx, v)
    with pytest.raises(ValueError):
        fn(torch.zeros(16, 3), idx, v)
    with pytest.raises(ValueError):
        fn(torch.zeros(32), idx, v)
    with pytest.raises(TypeError):
        fn(torch.zeros(16, 2, dtype=torch.float64), idx, v)
    with pytest.raises(TypeError):
        fn(torch.zeros(16, 2), idx.long(), v)
    out = torch.zeros(16, 2)
    assert fn(out, idx, v) is out and float(out[0, 0]) == 8.0


@pytest.mark.parametrize("k", [0, 1, 2])
def test_default_config_levels_route_to_the_kernels(monkeypatch, k):
    """At the default config the exact backward sends levels 0 and 1
    (dense, ≤ 2^15 entries, where the JAX package takes `grad_onehot_mxu`)
    to the cluster-shared kernel's in-place wrapper and levels 2-13 to the
    global-atomics kernel's, 8 elements per sample, each into its level's
    rows of the table gradient; the stochastic one (K ≥ 1) makes one call
    of the K-corner kernel's in-place wrapper over all 14 levels into the
    whole table gradient; nothing else scatters."""
    static = he.HashGridStatic(HashGridConfig())
    calls = []

    def spy(name, real):
        def fn(out, idx, v):
            calls.append((name, idx.shape[0], out.shape[0]))
            return real(out, idx, v)
        return fn

    def spy_corners(g_table, static, positions, g_out, g_jac, La, mask, k,
                    salt, choices=None):
        calls.append(("corner_backward", k * positions.shape[0] * La,
                      g_table.shape[0]))
        return real_corners(g_table, static, positions, g_out, g_jac, La,
                            mask, k, salt, choices)

    real_corners = corner_backward.corner_backward_into
    monkeypatch.setattr(hash_grad_small, "grad_small_into",
                        spy("hash_grad_small",
                            hash_grad_small.grad_small_into))
    monkeypatch.setattr(scatter_add, "scatter_add_into",
                        spy("scatter_add", scatter_add.scatter_add_into))
    monkeypatch.setattr(corner_backward, "corner_backward_into",
                        spy_corners)
    n = 37
    rng = np.random.default_rng(k)
    t = torch.from_numpy((rng.standard_normal((static.n_entries, 2)) * 1e-2)
                         .astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(rng.random((n, 3)).astype(np.float32))
    f, j = he.make_encode_with_jacobian_cv(static, corner_samples=k)(t, x)
    (f.sum() + j[0].sum()).backward()
    sizes = [int(s) for s in static.table_sizes]
    want = [("hash_grad_small" if lvl < 2 else "scatter_add", 8 * n,
             sizes[lvl]) for lvl in range(14)]
    if k:
        want = [("corner_backward", k * n * 14, static.n_entries)]
    assert calls == want
    assert sizes[2:5] == [39304, 125000, 373248]
    assert all(s == 1 << 19 for s in sizes[5:])


def test_bench_scatter_runs_every_section_on_cpu(capsys):
    """`python -m rnb_neus2_torch.tools.bench_scatter --device cpu` at a
    reduced n: every probe's sweep, both kernels (their plain versions
    here) checked at every point, one JSON line per point, no time."""
    bench_scatter.main(["--device", "cpu", "--max-n", "3000"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    points = [(s, S) for s, (_, _, pts) in bench_scatter.SECTIONS.items()
              for S, _ in pts]
    assert [(r["section"], r["S"]) for r in rows] == points
    assert len(points) == 11
    for r in rows:
        assert r["n"] == 3000 and r["ms"] is None and r["card"] is None
        assert set(r["kernels"]) == {"scatter_add", "hash_grad_small"}
        assert r["route"] == ("hash_grad_small" if r["S"] <= 1 << 15
                              else "scatter_add")
        assert r["bound_ms"] > 0 and r["bound_by"] == "bytes"
        assert r["replaces"].startswith("tools/profiling/_bench_")
    with pytest.raises(SystemExit):
        bench_scatter.main(["--device", "cpu", "no_such_section"])


def test_bench_scatter_check_catches_a_wrong_table():
    idx = torch.tensor([0, 2, 2], dtype=torch.int32)
    want = scatter_add.plain(idx, torch.ones(3, 1), 4)
    bad = want.clone()
    bad[1] = 1.0                               # an untouched row
    with pytest.raises(AssertionError):
        bench_scatter.check_against_plain("k", bad, want, idx, 4, exact=True)
    with pytest.raises(AssertionError):
        bench_scatter.check_against_plain("k", bad, want, idx, 4,
                                          exact=False)
    assert bench_scatter.check_against_plain("k", want, want, idx, 4,
                                             exact=True) == 0.0


def test_in_place_bound_counts_only_the_rows_added_to():
    """`bound_into_ms` reads idx and values once and each row that the
    input changes twice; the table's fill (`bound_ms`'s S·F·4 bytes) is
    not in it. Out-of-range indices and all-zero values change no row."""
    idx = torch.tensor([0, 2, 2, 5, -1, 7, 3], dtype=torch.int32)
    v = torch.ones(7, 2)
    v[3] = 0.0                                  # row 5 adds only zeros
    v[6] = 0.0                                  # and so does row 3
    assert bench_scatter.rows_added_to(idx, v, 6) == 2   # rows 0 and 2
    ms, by = bench_scatter.scatter_bound_into(7, 2, 2)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (7 * 12 + 2 * 2 * 2 * 4)
                               / bench_scatter.HBM_BYTES_PER_S)
    assert ms < bench_scatter.scatter_bound(7, 1 << 19, 2)[0]
