"""The port's `Trainer.train_steps` and the CLI loop on it, against the JAX
package's (`Trainer.train_steps`, `cli/testbed.py`), and error-map
proportional sampling (`train/error_map.py:sample` and its hook in the
sampler).

- Schedule: both trainers run `train_steps(600, 25)` from step 0 with
  the step body, the chunk and the occupancy refresh replaced by
  recorders that only let `step` and the error map's counters advance.
  The sequences of (step, rays bucket, level bucket) per dispatched step,
  the chunk starts and the steps of the metrics reads are equal, at
  `fused_steps` 16 and 1, and on a grid whose level bucket changes inside
  a chunk (the chunk keeps its first step's bucket, as the JAX package's
  fused chunk does).
- CLI: both CLIs with `Trainer.train_steps` replaced by a recorder that
  only advances `step` make the same (start step, n, sync_every) calls
  and log and save meshes at the same steps. Then the port's CLI trains a
  few real steps on the CPU with a trace and a fly-through.
- Real steps: eight steps through `train_steps(8, sync_every=4)` in both
  trainers, on JAX's own draws (as `tests/test_torch_trainer_parity.py`
  does for `train_step`): after each of the two reads, rays per batch
  equal, the loss within 1e-5 relative, the loss, eikonal and mask EMAs
  within 1e-5 relative, the parameters and the EMA parameters within
  1e-4.
- Error-map sampling on JAX's uniforms, with both knobs and with each one
  alone: the images equal, xy and pdf within 1e-6; before the first
  rebuild, the stratified fallback; the sampler with a knob on against
  JAX's `sample_ray_batch`; and the default draws unchanged.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rnb_neus2_tpu import config as jconfig
from rnb_neus2_tpu.cli import testbed as jtestbed
from rnb_neus2_tpu.testing.synthetic import sphere_dataset as jsphere
from rnb_neus2_tpu.train import error_map as jerror_map
from rnb_neus2_tpu.train import sampler as jsampler
from rnb_neus2_tpu.train.trainer import Trainer as JTrainer
from rnb_neus2_torch import config, interop
from rnb_neus2_torch.cli import testbed
from rnb_neus2_torch.grid import occupancy
from rnb_neus2_torch.io.image_io import load_image
from rnb_neus2_torch.render.camera_path import CameraKeyframe, CameraPath
from rnb_neus2_torch.testing.synthetic import (sphere_dataset,
                                               write_prepared_scene)
from rnb_neus2_torch.train import error_map, sampler
from rnb_neus2_torch.train import trainer as trainer_mod
from rnb_neus2_torch.train.sampler import RayUniforms
from rnb_neus2_torch.train.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# ---------------------------------------------------------------------------
# (a) the dispatch and read schedule
# ---------------------------------------------------------------------------

# valid_level_scale 0.00394 on 4 levels: the level bucket goes from 2 to 4
# at step 405, inside the chunk that starts at step 400
SCHEDULES = {"fused16": (16, 0.02), "fused1": (1, 0.02),
             "bucket_in_chunk": (16, 0.00394)}


def _sched_cfg(pkg, fused, vls):
    return pkg.TestbedConfig(
        grid=pkg.HashGridConfig(n_levels=4, top_resolution=32,
                                log2_hashmap_size=12,
                                valid_level_scale=vls),
        train=pkg.TrainConfig(target_batch_size=1 << 10,
                              initial_rays_per_batch=64, occ_grid_size=16,
                              fused_steps=fused),
        march=pkg.MarchConfig(n_ladder=128))


def _port_schedule(fused, vls, n, sync_every):
    tr = Trainer(sphere_dataset(n_views=2, width=8, height=8),
                 _sched_cfg(config, fused, vls), device="cpu")
    rec = []

    def body(n_rays, n_active):
        rec.append(("step", tr.step, n_rays, n_active))
        return {}

    real_chunk = tr._run_chunk

    def chunk(n_rays, n_active, k):
        rec.append(("chunk", tr.step, n_rays, n_active))
        return real_chunk(n_rays, n_active, k)

    tr._step_body = body
    tr._run_chunk = chunk
    tr.refresh_occupancy = lambda n_active: None
    tr._consume_metrics = lambda m: rec.append(("read", tr.step)) or {}
    tr.train_steps(n, sync_every)
    return rec, tr


def _jax_schedule(fused, vls, n, sync_every):
    jtr = JTrainer(jsphere(n_views=2, width=8, height=8),
                   _sched_cfg(jconfig, fused, vls))
    rec = []

    def make_step_fn(r, lb):
        def fn(params, opt_state, emap, bitfield, key, step, lr_scale):
            rec.append(("step", int(step), r, lb))
            return params, opt_state, emap, {}
        return fn

    def make_chunk_fn(r, lb, k):
        def fn(params, opt_state, emap, occ, key, step0, lr_scale):
            rec.append(("chunk", int(step0), r, lb))
            rec.extend(("step", int(step0) + i, r, lb) for i in range(k))
            return params, opt_state, emap, occ, key, {}
        return fn

    jtr._make_step_fn = make_step_fn
    jtr._make_chunk_fn = make_chunk_fn
    jtr._occ_update_fn = lambda n_active, subsampled=False: (
        lambda params, occ, key, step: occ)
    jtr._consume_metrics = lambda m: rec.append(("read", jtr.step)) or {}
    jtr.train_steps(n, sync_every)
    return rec, jtr


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_matches_jax(case):
    fused, vls = SCHEDULES[case]
    got, tr = _port_schedule(fused, vls, 600, 25)
    want, jtr = _jax_schedule(fused, vls, 600, 25)
    assert got == want
    assert (tr.step, tr._emap_counter, tr._emap_interval) == (
        jtr.step, jtr._emap_counter, jtr._emap_interval) == (600, 600 - 320,
                                                             288)
    chunks = [s for kind, s, *_ in got if kind == "chunk"]
    reads = [e[1] for e in got if e[0] == "read"]
    steps = [e for e in got if e[0] == "step"]
    assert [e[1] for e in steps] == list(range(600))
    assert reads[-1] == 600
    if fused == 1:
        assert not chunks
        assert reads == list(range(25, 601, 25))
        return
    # chunks from step 256, never across the rebuilds at 320 and 608
    assert chunks == [256, 272, 288] + list(range(320, 577, 16))
    # a read that falls due inside a chunk waits for the chunk's end
    # (two chunks, 32 steps, once the chunks run back to back)
    assert all(25 <= b - a <= 24 + 16 for a, b in zip(reads, reads[1:-1]))
    assert reads[-4:] == [512, 544, 576, 600]
    held = [(s, lb) for _, s, _, lb in steps if lb != _bucket_of(tr, s)]
    if case == "bucket_in_chunk":
        # steps 405-415 keep the chunk's bucket 2 where 3 levels are open
        assert held == [(s, 2) for s in range(405, 416)]
    else:
        assert held == []


def _bucket_of(tr, step):
    saved, tr.step = tr.step, step
    try:
        return tr._level_bucket()
    finally:
        tr.step = saved


# ---------------------------------------------------------------------------
# (b) the CLI loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    write_prepared_scene(str(root / "scene"), n_views=8, width=32,
                         height=32, radius=0.2)
    cfg = json.load(open(testbed.default_network_config()))
    cfg["encoding"].update(n_levels=4, top_resolution=64,
                           log2_hashmap_size=15)
    net = root / "small.json"
    net.write_text(json.dumps(cfg))
    return str(root / "scene"), str(net)


def _small(net):
    """tests/test_torch_cli.py's small network and flags, without
    --device (the JAX CLI has no such flag)."""
    return ["--network", net, "--target-batch-size", "8192",
            "--occ-grid-size", "32", "--n-ladder", "512", "--resolution",
            "48"]


LOOP_FLAGS = ["--maxiter", "350", "--save-each", "120", "--snapshot-each",
              "90", "--trace-steps", "16", "--n-chips", "1"]


def _record_cli(monkeypatch, capsys, trainer_cls, cli, extract_mod, argv):
    calls, meshes = [], []

    def train_steps(self, n, sync_every=10):
        calls.append((self.step, n, sync_every))
        self.step += n
        return {}

    def extract_mesh(field, params, resolution=512, meta=None, **kw):
        meshes.append(resolution)
        z = np.zeros((0, 3), np.float32)
        return {"V": z, "F": np.zeros((0, 3), np.int64), "N": z, "C": None}

    monkeypatch.setattr(trainer_cls, "train_steps", train_steps)
    monkeypatch.setattr(extract_mod, "extract_mesh", extract_mesh)
    capsys.readouterr()
    assert cli.main(argv) == 0
    text = capsys.readouterr().out
    logged = [int(s) for s in re.findall(r"iteration=(\d+) loss=", text)]
    skipped = [int(s) for s in re.findall(
        r"iteration=(\d+): loss=\S+ is divergent", text)]
    saved = [int(s) for s in re.findall(r"mesh_(\d+)\.obj", text)]
    return calls, logged, skipped, saved, len(meshes)


def test_cli_loop_calls_match_jax(scene, tmp_path, monkeypatch, capsys):
    """The recorded calls fail on the port's earlier loop, which stepped
    with `train_step` and never called `train_steps`."""
    import rnb_neus2_tpu.mesh.extract as jextract
    import rnb_neus2_tpu.mesh.writer as jwriter
    import rnb_neus2_torch.mesh.extract as extract
    import rnb_neus2_torch.mesh.writer as writer
    import rnb_neus2_torch.utils.diagnostics as diagnostics
    from contextlib import nullcontext

    scene_dir, net = scene
    for mod in (jwriter, writer):
        monkeypatch.setattr(mod, "save_mesh", lambda *a, **k: None)
    monkeypatch.setattr(jax.profiler, "trace", lambda d: nullcontext())
    monkeypatch.setattr(diagnostics, "profile_trace",
                        lambda d, device=None: nullcontext())
    argv = ["--scene", scene_dir] + LOOP_FLAGS + _small(net)
    want = _record_cli(monkeypatch, capsys, JTrainer, jtestbed, jextract,
                       argv)
    got = _record_cli(monkeypatch, capsys, Trainer, testbed, extract,
                      argv + ["--device", "cpu"])
    assert got == want
    calls = got[0]
    # to 100 by 25s, then save 120, trace start 256, snapshot 270, ...
    assert calls[:3] == [(0, 90, 25), (90, 10, 25), (100, 20, 25)]
    assert (256, 16, 16) in calls and sum(n for _, n, _ in calls) == 350
    assert got[3] == [120, 240] and got[4] == 2


def test_cli_trains_with_trace_and_flythrough(scene, tmp_path, capsys):
    scene_dir, net = scene
    path = tmp_path / "path.json"
    ds = sphere_dataset(n_views=8, width=32, height=32, radius=0.2)
    rot, org = ds.cameras.rot_c2w.numpy(), ds.cameras.origin.numpy()
    CameraPath([CameraKeyframe.from_matrix(
        np.concatenate([rot[i], org[i][:, None]], axis=1))
        for i in (0, 4)]).save(str(path))
    tdir = tmp_path / "trace"
    assert testbed.main(["--scene", scene_dir, "--maxiter", "8",
                         "--trace-steps", "4", "--trace-dir", str(tdir),
                         "--render-path", str(path), "--render-frames", "2",
                         "--device", "cpu"] + _small(net)) == 0
    out = capsys.readouterr().out
    assert "Wrote a 4-step device trace" in out
    assert "metric reads" in out
    trace = json.loads((tdir / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"sample_and_march", "field_forward", "backward",
            "optimizer"} <= names
    frames = [load_image(os.path.join(scene_dir, "output", "flythrough",
                                      f"{i:05d}.png")) for i in range(2)]
    for f in frames:
        assert f.shape == (32, 32, 4) and np.isfinite(f).all()
    assert np.abs(frames[0] - frames[1]).max() > 0


# ---------------------------------------------------------------------------
# (c) real steps through train_steps
# ---------------------------------------------------------------------------

def _parity_cfg(pkg):
    return pkg.TestbedConfig(
        grid=pkg.HashGridConfig(n_levels=4, top_resolution=64),
        network=pkg.NetworkConfig(stoch_corner_bwd=0),
        train=pkg.TrainConfig(target_batch_size=1 << 13,
                              initial_rays_per_batch=128, occ_grid_size=32,
                              seed=0),
        march=pkg.MarchConfig(n_ladder=512))


def _state(tr, out, params, ema):
    return {"step": tr.step, "n_rays": tr.n_rays,
            "loss_total": out["loss_total"],
            "emas": (tr.loss_ema.value, tr.ek_ema.value, tr.mask_ema.value),
            "params": params, "ema": ema}


def test_train_steps_match_jax_on_its_draws(monkeypatch):
    np_tree = lambda t: jax.tree_util.tree_map(np.array, t)
    jtr = JTrainer(jsphere(n_views=4, width=32, height=32, radius=0.2),
                   _parity_cfg(jconfig))
    tr = Trainer(sphere_dataset(n_views=4, width=32, height=32, radius=0.2),
                 _parity_cfg(config), device="cpu",
                 params=interop.params_from_jax(np_tree(jtr.params)))
    # JAX first: its step and refresh keys, and its state at each read
    keys, want = [], []
    real_step_fn, real_occ_fn = jtr._make_step_fn, jtr._occ_update_fn

    def make_step_fn(r, lb):
        fn = real_step_fn(r, lb)

        def wrapped(params, opt_state, emap, bitfield, key, *a):
            keys.append(("step", key, r))
            return fn(params, opt_state, emap, bitfield, key, *a)
        return wrapped

    def occ_fn(n_active, subsampled=False):
        fn = real_occ_fn(n_active, subsampled)

        def wrapped(params, occ, key, step):
            keys.append(("occ", key, None))
            return fn(params, occ, key, step)
        return wrapped

    real_consume = jtr._consume_metrics

    def consume(m):
        out = real_consume(m)
        want.append(_state(jtr, out,
                           interop.params_from_jax(np_tree(jtr.params)),
                           interop.params_from_jax(
                               np_tree(jtr.opt_state.ema_params))))
        return out

    monkeypatch.setattr(jtr, "_make_step_fn", make_step_fn)
    monkeypatch.setattr(jtr, "_occ_update_fn", occ_fn)
    monkeypatch.setattr(jtr, "_consume_metrics", consume)
    jtr.train_steps(8, sync_every=4)
    assert [s["step"] for s in want] == [4, 8]

    # the port on the same numbers
    g = jtr.cfg.train.occ_grid_size
    uniforms, jitters = [], []
    for kind, key, R in keys:
        if kind == "occ":
            jitters.append(_t(jax.random.uniform(key, (g ** 3, 3))))
            continue
        k_xy, k_skip, k_light, k_start = jax.random.split(key, 4)
        uniforms.append(RayUniforms(
            xy=_t(jax.random.uniform(k_xy, (R, 2))),
            skip=_t(jax.random.uniform(k_skip, (R,))),
            start=_t(jax.random.uniform(k_start, (R,))),
            light_idx=_t(jax.random.randint(k_light, (R,), 0, 3),
                         torch.int64)))
    assert len(uniforms) == 8 and len(jitters) >= 3
    real_sample, real_cells = (trainer_mod.sample_ray_batch,
                               occupancy.cell_positions)
    monkeypatch.setattr(trainer_mod, "sample_ray_batch",
                        lambda *a, **k: real_sample(
                            *a, **{**k, "uniforms": uniforms.pop(0)}))
    monkeypatch.setattr(occupancy, "cell_positions",
                        lambda g, gen=None, device="cpu": real_cells(
                            g, gen, device, jitter=jitters.pop(0)))
    got = []
    real_port_consume = tr._consume_metrics

    def port_consume(m):
        out = real_port_consume(m)
        got.append(_state(tr, out, {k: p.detach().clone()
                                    for k, p in tr.params.items()},
                          {k: p.clone() for k, p in tr.opt.ema.items()}))
        return out

    monkeypatch.setattr(tr, "_consume_metrics", port_consume)
    tr.train_steps(8, sync_every=4)
    assert not uniforms and not jitters
    assert len(got) == len(want) == 2
    for g_, w in zip(got, want):
        assert (g_["step"], g_["n_rays"]) == (w["step"], w["n_rays"])
        assert g_["loss_total"] == pytest.approx(w["loss_total"], rel=1e-5)
        assert g_["emas"] == pytest.approx(w["emas"], rel=1e-5)
        for name in ("params", "ema"):
            for k, want_p in w[name].items():
                err = float((g_[name][k].double() - want_p.double())
                            .abs().max())
                assert err <= 1e-4, (name, k, err)
    assert tr.metric_reads == 2
    np.testing.assert_allclose(tr.loss_graph.values(),
                               jtr.loss_graph.values(), rtol=1e-5)


def test_diagnostics_match_jax():
    """`utils/diagnostics.py`: the loss graph's ring buffer and the
    per-level table statistics, against the JAX package's."""
    from rnb_neus2_tpu.ops.hash_encoding import HashGridStatic as JStatic
    from rnb_neus2_tpu.utils import diagnostics as jdiag
    from rnb_neus2_torch.ops.hash_encoding import HashGridStatic
    from rnb_neus2_torch.utils import diagnostics

    g, jg = diagnostics.LossGraph(capacity=16), jdiag.LossGraph(capacity=16)
    for i, v in enumerate(np.random.default_rng(0).random(40)):
        g.update(float(v))
        jg.update(float(v))
        if i in (5, 15, 16, 39):
            assert np.array_equal(g.values(), jg.values())
    cfg = config.HashGridConfig(n_levels=6, top_resolution=256,
                                log2_hashmap_size=14)
    static = HashGridStatic(cfg)
    table = np.random.default_rng(1).normal(
        size=(static.n_entries, 2)).astype(np.float32)
    table[:100] = 0.0
    got = diagnostics.gather_level_stats(torch.from_numpy(table), static)
    want = jdiag.gather_level_stats(jnp.asarray(table), JStatic(
        jconfig.HashGridConfig(n_levels=6, top_resolution=256,
                               log2_hashmap_size=14)))
    assert [dataclasses.astuple(a) for a in got] \
        == [dataclasses.astuple(b) for b in want]
    assert diagnostics.format_level_stats(got) \
        == jdiag.format_level_stats(want)


# ---------------------------------------------------------------------------
# (f) error-map proportional sampling
# ---------------------------------------------------------------------------

def _emap_states(rebuilt=True):
    """The same error map in both packages: random per-ray losses splatted
    into a 5-image map, then (rebuilt=True) its CDFs built."""
    rng = np.random.default_rng(0)
    n, ew, eh, R = 5, 12, 9, 4000
    img = rng.integers(0, n, R).astype(np.int32)
    xy = rng.random((R, 2)).astype(np.float32)
    loss = (rng.random(R) ** 4).astype(np.float32)
    js = jerror_map.splat(jerror_map.init_state(n, ew, eh),
                          jnp.asarray(img), jnp.asarray(xy),
                          jnp.asarray(loss))
    if rebuilt:
        js = jerror_map.rebuild(js)
    ps = error_map.ErrorMapState(*(_t(a) for a in js))
    return js, ps


@pytest.mark.parametrize("knobs", [(True, True), (True, False),
                                   (False, True), (False, False)],
                         ids=["both", "image", "focal", "none"])
@pytest.mark.parametrize("rebuilt", [True, False],
                         ids=["rebuilt", "before_rebuild"])
def test_error_map_sample_matches_jax(knobs, rebuilt):
    js, ps = _emap_states(rebuilt)
    R = 3001
    key = jax.random.PRNGKey(7)
    img_w, xy_w, pdf_w = (np.array(a) for a in jerror_map.sample(
        js, key, R, *knobs))
    if any(knobs):
        k_i, k_y, k_x = jax.random.split(key, 3)
        u_img = _t(jax.random.uniform(k_i, (R,)))
    else:
        k_x, k_y = jax.random.split(key, 2)
        u_img = None
    u_y = _t(jax.random.uniform(k_y, (R,)))
    u_x = _t(jax.random.uniform(k_x, (R,)))
    img, xy, pdf = error_map.sample(ps, R, u_img, u_y, u_x, *knobs)
    assert np.array_equal(img.numpy(), img_w)
    assert np.abs(xy.numpy() - xy_w).max() <= 1e-6
    assert np.abs(pdf.numpy() - pdf_w).max() <= 1e-6
    if rebuilt and knobs[0]:
        # the error map moves the image draws off the strata
        strata = (np.arange(R) * 5) // R
        assert not np.array_equal(img_w, strata)


@pytest.mark.parametrize("knobs", [(True, True), (False, True)],
                         ids=["both", "focal"])
def test_proportional_sampler_matches_jax(knobs):
    """`sample_ray_batch` with a knob on, on the uniforms of JAX's key
    splits (the sampler's four, then error_map.sample's three)."""
    js, ps = _emap_states()
    jds = jsphere(n_views=5, width=24, height=24, radius=0.2)
    ds = sphere_dataset(n_views=5, width=24, height=24, radius=0.2)
    march = config.MarchConfig(n_ladder=512)
    bit = np.zeros(32 ** 3, bool)
    bit[::3] = True
    R, S = 512, 1 << 13
    key = jax.random.PRNGKey(3)
    jb, jsam, jpos, (jimg, jxy) = jsampler.sample_ray_batch(
        jds, jnp.asarray(bit), key, R, S, jconfig.MarchConfig(n_ladder=512),
        emap_state=js, emap_image_prop=knobs[0], emap_focal_prop=knobs[1])
    k_xy, k_skip, k_light, k_start = jax.random.split(key, 4)
    k_i, k_y, k_x = jax.random.split(k_xy, 3)
    uni = RayUniforms(
        xy=torch.stack([_t(jax.random.uniform(k_x, (R,))),
                        _t(jax.random.uniform(k_y, (R,)))], dim=1),
        skip=_t(jax.random.uniform(k_skip, (R,))),
        start=_t(jax.random.uniform(k_start, (R,))),
        light_idx=_t(jax.random.randint(k_light, (R,), 0, 3), torch.int64),
        img=_t(jax.random.uniform(k_i, (R,))))
    b, sam, pos, (img, xy) = sampler.sample_ray_batch(
        ds, torch.as_tensor(bit), R, S, march, uniforms=uni, emap_state=ps,
        emap_image_prop=knobs[0], emap_focal_prop=knobs[1])
    assert np.array_equal(img.numpy(), np.array(jimg))
    assert np.abs(xy.numpy() - np.array(jxy)).max() <= 1e-6
    assert np.abs(b.pdf.numpy() - np.array(jb.pdf)).max() <= 1e-6
    assert np.array_equal(sam.n_valid.numpy(), np.array(jsam.n_valid))
    assert np.abs(pos.numpy() - np.array(jpos)).max() <= 1e-6


def test_default_draws_unchanged():
    """With both knobs off the trainer draws what it drew before
    proportional sampling was ported: xy, skip, start, light index, in
    that order, and no image draw."""
    gen = torch.Generator()
    gen.manual_seed(5)
    u = sampler.draw_uniforms(100, gen, "cpu")
    gen.manual_seed(5)
    want = (torch.rand((100, 2), generator=gen), torch.rand(100, generator=gen),
            torch.rand(100, generator=gen),
            torch.randint(0, 3, (100,), generator=gen))
    assert u.img is None
    assert all(torch.equal(a, b) for a, b in zip(u[:4], want))
    p = sampler.draw_uniforms(100, gen, "cpu", proportional=True)
    assert p.img.shape == (100,)


def test_trainer_samples_proportionally():
    """Both knobs on: `check_ported` accepts them, the trainer steps past
    the first rebuild, and its images then follow the error map."""
    cfg = _sched_cfg(config, 16, 0.02)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, sample_image_proportional_to_error=True,
        sample_focal_plane_proportional_to_error=True))
    trainer_mod.check_ported(cfg)
    tr = Trainer(sphere_dataset(n_views=2, width=8, height=8), cfg,
                 device="cpu")
    seen = []
    real = trainer_mod.sample_ray_batch

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append((k["uniforms"].img is not None, out[3][0]))
        return out

    trainer_mod.sample_ray_batch = spy
    try:
        tr.train_steps(130, sync_every=25)
    finally:
        trainer_mod.sample_ray_batch = real
    assert bool(tr.emap.valid) and all(has for has, _ in seen)
    assert np.isfinite(tr.loss_ema.value)
