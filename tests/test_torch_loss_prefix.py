"""The loss kernels' transmittance prefix (`kernels/neus_loss.py:
prefix_twin`, the order of csrc/neus_loss.cu's scans) on the CPU: a
literal transcription of the kernels' loops gives the twin's bits; the
twin is within half a float32 step of the exact sum, equal to the CPU's
`torch.cumsum` but for a step at a rare entry, and within a few steps of
JAX's `jnp.cumsum` (the JAX package's `cum_excl`) at a trained step's
2^18 slots and magnitudes; and the plain version fed the twin's prefix
matches the JAX package's `training_loss` and its VJP on the edge-case
batch under `test_torch_neus_loss.py`'s tolerances, the JAX package
summing in the same order, and against the JAX package as it stands
within the two orders' gap; and the check that holds the scan kernel's
logs and prefix against values computed apart from it sees a wrong
log."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_neus_loss as base
from rnb_neus2_torch.kernels import neus_loss
from rnb_neus2_torch.testing import loss_batch as lb

SOURCE = Path(neus_loss.__file__).parent.parent / "csrc" / neus_loss.SOURCE


def trained_logs(seed: int, S: int) -> np.ndarray:
    """Float32 log1p(−α) like a trained step's buffer: rays of 200–320
    slots, faint samples (−1e−3 on average) up to a surface, then
    samples of up to the clamp's −16.1; a twentieth of the slots not
    alive (−0.0). |C| reaches 6–7e5 at 2^18 slots."""
    rng = np.random.default_rng(seed)
    lw = np.zeros(S, np.float32)
    a = 0
    while a < S:
        n = int(rng.integers(200, 320))
        k = int(rng.integers(min(100, n - 1), n))
        b = min(a + n, S)
        lw[a:min(a + k, b)] = -rng.exponential(1e-3, min(a + k, b) - a)
        lw[min(a + k, b):b] = -rng.uniform(1.0, 16.1, b - min(a + k, b))
        a = b
    lw[rng.random(S) < 0.05] = -0.0
    return lw


def steps_of_running(c: np.ndarray, exact: np.ndarray) -> float:
    """The largest |c − exact| in float32 steps of the running max |C|."""
    run = np.maximum.accumulate(np.abs(exact))
    step = np.exp2(np.floor(np.log2(np.maximum(run, 1e-30))) - 23)
    return float(np.max(np.abs(c - exact) / step))


def kernel_loops(lw: np.ndarray, threads: int, per: int) -> np.ndarray:
    """csrc/neus_loss.cu's `block_prefix` and the forward's C, written out
    loop by loop in numpy float64: per tile, each thread's `per` slots
    serially, a Kogge-Stone scan over each warp's lanes, one over the
    block's warps, (warp + lane) + own; the tile totals the same way with
    ⌈tiles/threads⌉ per thread; C = float32(offset + local)."""
    f = np.float64
    warps = threads // 32

    def block_prefix(vals):          # vals: threads·n float64, in place
        n = len(vals) // threads
        out = vals.copy()
        tot = np.zeros(threads, f)
        for t in range(threads):
            s = f(0.0)
            for k in range(n):
                x = out[t * n + k]
                out[t * n + k] = s
                s = f(s + x)
            tot[t] = s
        incl = tot.copy()
        for w in range(warps):
            y = incl[32 * w:32 * w + 32]
            d = 1
            while d < 32:
                y = np.array([f(y[i] + y[i - d]) if i >= d else y[i]
                              for i in range(32)], f)
                d *= 2
            incl[32 * w:32 * w + 32] = y
        wt = np.array([incl[32 * w + 31] for w in range(warps)], f)
        d = 1
        while d < warps:
            wt = np.array([f(wt[i] + wt[i - d]) if i >= d else wt[i]
                           for i in range(warps)], f)
            d *= 2
        for t in range(threads):
            w, lane = divmod(t, 32)
            lane_ex = incl[t - 1] if lane else f(0.0)
            base_ = f((wt[w - 1] if w else f(0.0)) + lane_ex)
            for k in range(n):
                out[t * n + k] = f(base_ + out[t * n + k])
        return out, wt[-1]

    tile = threads * per
    nb = -(-len(lw) // tile)
    x = np.zeros(nb * tile, f)
    x[:len(lw)] = lw
    local, totals = [], np.zeros(threads * -(-nb // threads), f)
    for b in range(nb):
        loc, totals[b] = block_prefix(x[b * tile:(b + 1) * tile])
        local.append(loc)
    off = block_prefix(totals)[0]
    return np.concatenate([f(off[b]) + local[b] for b in range(nb)]
                          ).astype(np.float32)[:len(lw)]


def test_the_tile_plan_matches_the_kernel_source():
    src = SOURCE.read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    per = int(re.search(r"constexpr int kPer = (\d+);", src)[1])
    assert (neus_loss.THREADS, neus_loss.PER) == (threads, per)
    assert neus_loss.TILE == threads * per


@pytest.mark.parametrize("S, threads, per", [
    (2500, 64, 4),       # three tiles, the last one ragged
    (1 << 11, 32, 2),    # tile totals scanned two to a thread
    (700, 256, 4),       # one ragged tile of the real plan
])
def test_the_twin_is_the_kernels_loops(S, threads, per):
    """The twin's vectorized order gives, bit for bit, the loops it
    stands for (signed zeros included)."""
    lw = trained_logs(S, S)
    got = neus_loss.prefix_twin(torch.from_numpy(lw), threads, per).numpy()
    want = kernel_loops(lw, threads, per)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed, S", [(0, 1 << 18), (1, 1 << 18),
                                     (2, 100_003)])
def test_the_twin_is_within_steps_of_float64(seed, S):
    """A tree-ordered float64 sum rounded to float32 once: within half a
    float32 step (and the float64 sums' own error) of the running |C| of
    the exact sum, and each entry within one float32 step of the CPU's
    float32 `torch.cumsum`, which also sums in float64 (measured: every
    entry equal)."""
    lw = trained_logs(seed, S)
    t = torch.from_numpy(lw)
    twin = neus_loss.prefix_twin(t)
    exact = np.concatenate([[0.0], np.cumsum(lw.astype(np.float64))[:-1]])
    assert steps_of_running(twin.double().numpy(), exact) <= 0.5 + 1e-3
    cpu = torch.cat([t.new_zeros(1), torch.cumsum(t, 0)[:-1]])
    assert int(lb._ulps(twin, cpu).max()) <= 1


def test_the_twin_follows_jnp_cumsum():
    """At a trained step's size and magnitudes (2^18 slots, |C| past
    5e5) the card's prefix and the JAX package's `cum_excl` (XLA's
    `jnp.cumsum` on the CPU, a float32 tree order) round alike: XLA's
    within 4 steps of the running |C| of the float64 sum (measured 2.4–
    3.3), the twin within half a step, so within 4.5 of each other
    (measured 2–3)."""
    lw = trained_logs(3, 1 << 18)
    twin = neus_loss.prefix_twin(torch.from_numpy(lw)).double().numpy()
    jx = np.asarray(jnp.concatenate(
        [jnp.zeros(1, jnp.float32), jnp.cumsum(jnp.asarray(lw))[:-1]]),
        np.float64)
    exact = np.concatenate([[0.0], np.cumsum(lw.astype(np.float64))[:-1]])
    assert np.abs(exact).max() > 5e5
    assert steps_of_running(jx, exact) <= 4.0
    assert steps_of_running(twin, jx) <= 4.5


def test_the_prefix_option_takes_its_values_and_keeps_the_gradient():
    """`alpha_and_trans(..., prefix)` takes C's values from `prefix` and
    its gradient from the cumsum: on the edge-case batch the twin's T
    equals exp of the twin's differences bit for bit, and a prefix that
    returns the cumsum's own values gives the version without one, T and
    its gradient wrt sdf, bit for bit."""
    b = lb.loss_batch(0)
    field, samples, batch = lb.torch_batch(b, "cpu")
    _, (args,) = lb.capture_call(lambda: base.losses.training_loss(
        field, samples, batch, base.config.RenderFlags(),
        base.config.LossConfig()))
    sdf, grad, _, v, dirs, inp, opt = args
    S, R = inp.dt.shape[0], inp.seg_start.shape[0]
    x = sdf.detach().clone().requires_grad_()

    def trans(prefix):
        return neus_loss.alpha_and_trans(x, grad.detach(), v.detach(), dirs,
                                         inp, opt, prefix)
    alpha, T_cumsum, _, _ = trans(None)
    T = trans(neus_loss.prefix_twin)[1]
    lw = torch.log1p(-torch.clamp_max(alpha.detach(), 1.0 - 1e-7))
    c = neus_loss.prefix_twin(lw)
    s = torch.clamp_max(inp.seg_start, S - 1)[
        torch.clamp_max(inp.ray_id, R - 1)]
    assert torch.equal(T.detach(), torch.exp(c - c[s]))
    T_same = trans(lambda lw: torch.cat([lw.new_zeros(1),
                                         torch.cumsum(lw, 0)[:-1]]))[1]
    assert torch.equal(T_same, T_cumsum)
    g_same = torch.autograd.grad(T_same.sum(), x)[0]
    g_cumsum = torch.autograd.grad(T_cumsum.sum(), x)[0]
    assert g_cumsum.abs().max() > 0 and torch.equal(g_same, g_cumsum)


def test_the_alpha_option_takes_its_values_and_keeps_the_gradient():
    """`alpha_and_trans(..., alpha_values=a)` takes α's values from `a` at
    the alive slots (0 elsewhere) and its gradient from sdf_to_alpha: on
    the edge-case batch, α's own values give the version without them, α
    and its gradient wrt sdf, bit for bit; other values are taken as
    given, with the same gradient."""
    b = lb.loss_batch(0)
    field, samples, batch = lb.torch_batch(b, "cpu")
    _, (args,) = lb.capture_call(lambda: base.losses.training_loss(
        field, samples, batch, base.config.RenderFlags(),
        base.config.LossConfig()))
    _, grad, _, v, dirs, inp, opt = args
    x = args[0].detach().clone().requires_grad_()

    def alpha(values):
        return neus_loss.alpha_and_trans(x, grad.detach(), v.detach(), dirs,
                                         inp, opt, None, values)[:3:2]
    a, alive = alpha(None)
    w = torch.from_numpy(np.random.default_rng(1).normal(size=a.shape[0])
                         ).float()
    g = torch.autograd.grad((w * a).sum(), x)[0]
    assert g.abs().max() > 0 and not alive.all()
    for values in (a.detach(), a.detach() * 0.5 + 0.25):
        got, _ = alpha(values)
        want = torch.where(alive, values, torch.zeros_like(values))
        assert torch.equal(got.detach(), want)
        assert torch.equal(torch.autograd.grad((w * got).sum(), x)[0], g)


def twin_cumsum(x, logs: np.ndarray):
    """jax.numpy's float cumsum of `x` with the values of the inclusive sum
    whose exclusive form is `prefix_twin(logs)` (`logs`: x's own values,
    recorded by an eager forward) and `jnp.cumsum`'s derivative."""
    ex = neus_loss.prefix_twin(torch.from_numpy(np.array(logs))).numpy()
    values = jnp.asarray(np.concatenate([ex[1:], ex[-1:] + logs[-1:]]))

    @jax.custom_jvp
    def f(x):
        return values

    @f.defjvp
    def _(primals, tangents):
        return f(primals[0]), jnp.cumsum(tangents[0])
    return f(x)


class _Recorded:
    """jax.numpy for the JAX package's losses module, recording the inputs
    of its float `cumsum` (the transmittance's logs) as numpy arrays: an
    eager forward, whose values are concrete."""

    def __init__(self):
        self.logs = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def cumsum(self, x, *a, **k):
        if jnp.issubdtype(x.dtype, jnp.floating):
            self.logs.append(np.asarray(x))
        return jnp.cumsum(x, *a, **k)


class _TwinOrderJnp:
    """jax.numpy for the JAX package's losses module, with its float
    `cumsum` (the transmittance's, `cum_excl = [0, cumsum(lw)[:-1]]`)
    taking the kernels' values of the logs that a `_Recorded` forward on
    the same inputs saw (`twin_cumsum`; no JAX op in that loss runs under
    jit, so both passes compute the same logs). Integer sums (the
    rollover emulation's ranks) stay `jnp.cumsum`."""

    def __init__(self, logs):
        self.logs = iter(logs)

    def __getattr__(self, name):
        return getattr(jnp, name)

    def cumsum(self, x, *a, **k):
        if not jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.cumsum(x, *a, **k)
        return twin_cumsum(x, next(self.logs))


def _jax_logs(b, attrs, flags, cfg, anneal, div):
    """The logs that the JAX package's `training_loss` sums on batch `b`,
    from an eager forward (`_Recorded`)."""
    samples, batch, raw = base._jax_batch(b, attrs)
    out = {"sdf": jnp.asarray(b["sdf"]), "grad": jnp.asarray(b["grad"]),
           "albedo_raw": jnp.asarray(raw),
           "variance": jnp.asarray(b["variance"])}
    rec = _Recorded()
    real, base.jlosses.jnp = base.jlosses.jnp, rec
    try:
        base.jlosses.training_loss(out, samples, batch,
                                   base.jconfig.RenderFlags(**flags),
                                   base.jconfig.LossConfig(**cfg), anneal,
                                   *div)
    finally:
        base.jlosses.jnp = real
    return rec.logs


def test_the_jnp_twin_is_the_twin():
    """`twin_cumsum`'s exclusive form is the twin's, bit for bit, and its
    gradient is `jnp.cumsum`'s."""
    lw = trained_logs(4, 5000)
    x = jnp.asarray(lw)
    got = np.asarray(twin_cumsum(x, lw))[:-1]
    want = neus_loss.prefix_twin(torch.from_numpy(lw)).numpy()[1:]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    w = jnp.asarray(np.random.default_rng(0).normal(size=5000), jnp.float32)
    g = jax.grad(lambda x: jnp.sum(w * twin_cumsum(x, lw)))(x)
    g_ref = jax.grad(lambda x: jnp.sum(w * jnp.cumsum(x)))(x)
    np.testing.assert_array_equal(np.asarray(g), np.asarray(g_ref))


TWIN_CASES = ["default", "l1_bce", "ray_directions", "rollover_emulation",
              "fp16_emulation", "full_buffer", "divisors", "no_albedo",
              "ref_jacobian"]


@pytest.mark.parametrize("case", TWIN_CASES)
def test_plain_fed_the_twin_matches_jax(case, monkeypatch):
    """The port's loss with the kernels' prefix order (`plain` with
    `prefix=prefix_twin`, what the card computes) against the JAX
    package's `training_loss`, its metrics and its VJP, the JAX package's
    prefix taking the twin's values of its own logs (`_TwinOrderJnp`),
    on the edge-case batch under the tolerances of
    `test_torch_neus_loss.py`. (With XLA's own order the two sums are
    up to 4.5 float32 steps of |C| apart, so log T up to 9, 2.7e-4 at this
    batch's |C| ≈ 346, above those tolerances' rtol of 1e-4:
    `test_the_twin_follows_jnp_cumsum` holds the orders to each other.)"""
    full, attrs, flags, cfg, anneal, div = base.CASES[case]
    b = lb.loss_batch(0, full=full)
    logs = _jax_logs(b, attrs, flags, cfg, anneal, div)
    monkeypatch.setattr(base.jlosses, "jnp", _TwinOrderJnp(logs))
    jt, jm, jg = base._jax(b, attrs, flags, cfg, anneal, div)
    monkeypatch.undo()
    monkeypatch.setattr(neus_loss, "neus_loss", lambda *a: neus_loss.plain(
        *a, prefix=neus_loss.prefix_twin))
    pt, pm, pg = base._port(b, attrs, flags, cfg, anneal, div)
    assert pt == pytest.approx(jt, rel=1e-5)
    for k in base.METRICS:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5, err_msg=k)
    for k in ("n_samples_kept", "n_rays_alive"):
        assert int(pm[k]) == int(jm[k]), k
    c, jc = pm["_per_ray_color_logged"], jm["_per_ray_color_logged"]
    np.testing.assert_allclose(c, jc, rtol=2e-4,
                               atol=1e-5 * np.abs(jc).max())
    for name, a, w in zip(lb.FIELD + ("ray_d",), pg, jg):
        a, scale = a.reshape(w.shape), np.abs(w).max()
        off = ~np.isclose(a, w, rtol=1e-4, atol=1e-6 * scale)
        assert off.mean() <= 0.03, (name, off.mean())
        assert np.abs(a - w).max() <= base.WORST.get(case, 5e-5) * scale, \
            name


def _edge_args(b, attrs, flags, cfg, anneal, div):
    """The CPU `neus_loss` call's arguments of `training_loss` on batch
    `b` under one configuration."""
    field, samples, batch = lb.torch_batch(b, "cpu", attrs)
    _, (args,) = lb.capture_call(lambda: base.losses.training_loss(
        field, samples, batch, base.config.RenderFlags(**flags),
        base.config.LossConfig(**cfg), anneal, *div))
    return (*[x.detach() for x in args[:5]], *args[5:])


# XLA's order and the twin's are each within 4.5 float32 steps of the
# other's entries (`test_the_twin_follows_jnp_cumsum`); log T is a
# difference of two entries
PREFIX_GAP_STEPS = 2 * 4.5


@pytest.mark.parametrize("case", TWIN_CASES)
def test_plain_fed_the_twin_matches_unpatched_jax(case):
    """What the card computes (`plain` with `prefix=prefix_twin`) against
    the JAX package's `training_loss` and its VJP as they stand, XLA
    summing the transmittance's logs in its own order, on the edge-case
    batch. The two prefixes put log T up to PREFIX_GAP_STEPS float32 steps
    of the batch's largest |C| apart (`gap`, 2.7e-4 at its |C| ≈ 346), so
    the entry-by-entry rtol of `test_plain_fed_the_twin_matches_jax` (1e-4
    for the gradients, 2e-4 for the colour) widens by that gap; the share
    of entries off (3%), each tensor's worst entry (`WORST`), the total
    and the metrics keep their tolerances (measured: at most 2.2% of
    ∇sdf's entries off rtol 1e-4 under l1_bce, 0.6% off 3e-4; worst
    entries within 3e-4 of the largest under l1_bce and fp16, 2.3e-5
    elsewhere)."""
    full, attrs, flags, cfg, anneal, div = base.CASES[case]
    b = lb.loss_batch(0, full=full)
    sdf, grad, _, v, dirs, inp, opt = _edge_args(b, attrs, flags, cfg,
                                                 anneal, div)
    alpha = neus_loss.alpha_and_trans(sdf, grad, v, dirs, inp, opt)[0]
    c = neus_loss.prefix_twin(lb.plain_logs(alpha))
    gap = float(np.expm1(PREFIX_GAP_STEPS
                         * lb._max_step(float(c.abs().max()))))
    jt, jm, jg = base._jax(b, attrs, flags, cfg, anneal, div)
    real = neus_loss.neus_loss
    neus_loss.neus_loss = lambda *a: neus_loss.plain(
        *a, prefix=neus_loss.prefix_twin)
    try:
        pt, pm, pg = base._port(b, attrs, flags, cfg, anneal, div)
    finally:
        neus_loss.neus_loss = real
    assert pt == pytest.approx(jt, rel=1e-5)
    for k in base.METRICS:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5, err_msg=k)
    for k in ("n_samples_kept", "n_rays_alive"):
        assert int(pm[k]) == int(jm[k]), k
    col, jcol = pm["_per_ray_color_logged"], jm["_per_ray_color_logged"]
    np.testing.assert_allclose(col, jcol, rtol=2e-4 + gap,
                               atol=1e-5 * np.abs(jcol).max())
    for name, a, w in zip(lb.FIELD + ("ray_d",), pg, jg):
        a, scale = a.reshape(w.shape), np.abs(w).max()
        off = ~np.isclose(a, w, rtol=1e-4 + gap, atol=1e-6 * scale)
        assert off.mean() <= 0.03, (name, off.mean())
        assert np.abs(a - w).max() <= base.WORST.get(case, 5e-5) * scale, \
            name


@pytest.mark.parametrize("fault", [None, "shift", "no_clamp",
                                   "dead_slots", "alpha", "prefix"])
def test_the_scan_check_sees_a_wrong_log(fault):
    """`loss_batch.scan_checks` holds the scan's α, logs and C against
    values computed apart from the kernels, on the edge-case batch: the
    float32 plain version's α, logs and the twin of them, standing in for
    the kernels' output, pass; logs with a fault of the scan's α→lw step
    (each with the twin of the wrong logs as C, which a check against the
    twin of the kernels' own logs cannot see) fail `lw`; an α off by 1e-3
    with its own logs fails `alpha`; a C one off past slot 1000 fails
    `C_vs_plain_twin`."""
    b = lb.loss_batch(0)
    sdf, grad, _, v, dirs, inp, opt = _edge_args(b, True, {}, {}, 1.0, ())
    alpha32, _, alive, _ = neus_loss.alpha_and_trans(sdf, grad, v, dirs,
                                                     inp, opt)
    d = [x.double() for x in (sdf, grad, v, dirs)]
    inp64 = type(inp)(*(x.double() if isinstance(x, torch.Tensor)
                        and x.is_floating_point() else x for x in inp))
    alpha64 = neus_loss.alpha_and_trans(*d, inp64, opt)[0]
    lw32 = lb.plain_logs(alpha32)
    cum_ref = neus_loss.prefix_twin(lw32)
    assert (alpha32 > lb.LW_CAP).any() and not alive.all()
    alpha, lw, cum = alpha32, lw32, cum_ref
    if fault == "shift":
        lw = torch.roll(lw32, 1)
    elif fault == "no_clamp":
        lw = torch.log1p(-alpha32)
    elif fault == "dead_slots":
        lw = torch.where(alive, lw32, torch.full_like(lw32, -1e-3))
    elif fault == "alpha":
        alpha = torch.where(alive, (alpha32 + 1e-3).clamp_max(1.0), alpha32)
        lw = lb.plain_logs(alpha)
    if fault in ("shift", "no_clamp", "dead_slots", "alpha"):
        cum = neus_loss.prefix_twin(lw)
    elif fault == "prefix":
        cum = cum_ref.clone()
        cum[1000:] += 1.0
    failed = lb.scan_checks(lw, cum, alpha, alpha32, alpha64,
                            cum_ref)["failed"]
    want = {None: [], "alpha": ["alpha"], "prefix": ["C_vs_plain_twin"]}
    assert failed == want.get(fault, ["lw"])
