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
from rnb_neus2_torch.kernels import hash_grad_small, scatter_add
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


@pytest.mark.parametrize("k", [0, 1, 2])
def test_default_config_levels_route_to_the_kernels(monkeypatch, k):
    """At the default config the backward sends levels 0 and 1 (dense,
    ≤ 2^15 entries, where the JAX package takes `grad_onehot_mxu`) to the
    shared-memory kernel's wrapper and levels 2-13 to the global-atomics
    kernel's, with 8 elements per sample in the exact backward and K in
    the stochastic one; nothing else scatters."""
    static = he.HashGridStatic(HashGridConfig())
    calls = []

    def spy(name, real):
        def fn(idx, v, table_size):
            calls.append((name, idx.shape[0], table_size))
            return real(idx, v, table_size)
        return fn

    monkeypatch.setattr(hash_grad_small, "grad_small",
                        spy("hash_grad_small", hash_grad_small.grad_small))
    monkeypatch.setattr(scatter_add, "scatter_add",
                        spy("scatter_add", scatter_add.scatter_add))
    n = 37
    rng = np.random.default_rng(k)
    t = torch.from_numpy((rng.standard_normal((static.n_entries, 2)) * 1e-2)
                         .astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(rng.random((n, 3)).astype(np.float32))
    f, j = he.make_encode_with_jacobian_cv(static, corner_samples=k)(t, x)
    (f.sum() + j[0].sum()).backward()
    per = 8 if k == 0 else k
    sizes = [int(s) for s in static.table_sizes]
    want = [("hash_grad_small" if lvl < 2 else "scatter_add", per * n,
             sizes[lvl]) for lvl in range(14)]
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
