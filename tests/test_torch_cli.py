"""The port's testbed CLI (`python -m rnb_neus2_torch.cli.testbed`)
against the JAX package's: every JAX flag parses, `make_config` gives the
JAX config field for field, a tiny run on the CPU writes mesh_N.obj and
snapshot_N.msgpack, `--snapshot` resumes at the saved step, the fp16 and
rollover emulation flags train, and a flag for a feature the port lacks
exits non-zero naming it, as does `--device cuda` on a host without a
card."""

import argparse
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from rnb_neus2_tpu.cli import testbed as jtestbed
from rnb_neus2_torch.cli import testbed
from rnb_neus2_torch.mesh.writer import load_obj
from rnb_neus2_torch.testing.synthetic import write_prepared_scene
from rnb_neus2_torch.train import snapshot as snap

ARGVS = [
    [],
    ["--maxiter", "300", "--lone", "--no-rgbplus", "--supernormal",
     "--bce", "--relu", "--opti-lights", "--no-albedo", "--mask-weight",
     "0.5", "--seed", "7", "--fractional-training", "100"],
    ["--target-batch-size", "8192", "--occ-grid-size", "32", "--n-ladder",
     "512", "--cone-angle", "0.0039", "--stoch-corner-bwd", "0",
     "--disable-snap-to-center", "--dense-max-entries-log2", "16",
     "--occ-refresh-levels", "6", "--adapt-to-kept", "1"],
    ["--stab-window", "100", "200", "0.5", "--fp16-grad-emu", "0",
     "--rollover-grad-emu", "0", "--rgbplus-ref-jacobian"],
    ["--no-stab-window", "--network", "base.json"],
]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the test workers share the host's cores, and
    at these sizes more threads only wait on each other (a tiny run took
    7x longer with 8 threads on a busy host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _parse(mod, argv):
    return mod.build_argparser().parse_args(["--scene", "s"] + argv)


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_make_config_matches_jax(argv):
    got = dataclasses.asdict(testbed.make_config(_parse(testbed, argv)))
    want = dataclasses.asdict(jtestbed.make_config(_parse(jtestbed, argv)))
    assert got == want


def _value(action):
    if action.nargs == 0:
        return []
    n = action.nargs if isinstance(action.nargs, int) else 1
    sample = {int: "3", float: "0.5"}.get(action.type, "x")
    return [sample] * n


def test_every_jax_flag_parses():
    port = {s for a in testbed.build_argparser()._actions
            for s in a.option_strings}
    argv = []
    for action in jtestbed.build_argparser()._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        assert set(action.option_strings) <= port, action.option_strings
        argv += [action.option_strings[0]] + _value(action)
    args = testbed.build_argparser().parse_args(argv)
    assert args.device == "cuda"


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    write_prepared_scene(str(root / "scene"), n_views=8, width=32,
                         height=32, radius=0.2)
    cfg = json.load(open(testbed.default_network_config()))
    cfg["encoding"].update(n_levels=4, top_resolution=64,
                           log2_hashmap_size=15)
    net = root / "small.json"
    net.write_text(json.dumps(cfg))
    return str(root / "scene"), str(net)


def _small(net):
    return ["--device", "cpu", "--network", net, "--target-batch-size",
            "8192", "--occ-grid-size", "32", "--n-ladder", "512",
            "--resolution", "48"]


def test_tiny_cpu_run_writes_mesh_and_snapshot_and_resumes(scene, capsys):
    scene_dir, net = scene
    out = os.path.join(scene_dir, "output")
    assert testbed.main(["--scene", scene_dir, "--maxiter", "20",
                         "--save-snapshot", "--snapshot-each", "10"]
                        + _small(net)) == 0
    first = capsys.readouterr().out
    assert "iteration=20 loss=" in first and "ms/step" in first
    path = os.path.join(out, "snapshot_20.msgpack")
    assert int(snap.load_snapshot(path)["step"]) == 20
    assert int(snap.load_snapshot(os.path.join(
        out, "snapshot_latest.msgpack"))["step"]) == 10
    assert testbed.main(["--scene", scene_dir, "--maxiter", "30",
                         "--snapshot", path, "--save-mesh",
                         "--save-snapshot", "--opti-lights"]
                        + _small(net)) == 0
    second = capsys.readouterr().out
    assert "Loaded snapshot at step 20" in second
    assert "Trained 10 steps" in second
    V, F = load_obj(os.path.join(out, "mesh_30.obj"))
    assert len(V) > 0 and len(F) > 0 and np.isfinite(V).all()
    data = snap.load_snapshot(os.path.join(out, "snapshot_30.msgpack"))
    assert int(data["step"]) == 30
    assert json.loads(data["config_json"])["train"]["max_steps"] == 30


@pytest.mark.parametrize("argv,feature", [
    (["--n-chips", "2"], "data parallelism"),
])
def test_unported_flags_exit_nonzero(scene, capsys, argv, feature):
    scene_dir, net = scene
    rc = testbed.main(["--scene", scene_dir, "--maxiter", "5"] + argv
                      + _small(net))
    assert rc != 0
    assert feature in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--fp16-grad-emu", "1"],
                                  ["--rollover-grad-emu", "1"],
                                  ["--fp16-grad-emu", "1",
                                   "--rollover-grad-emu", "1"]])
def test_emulation_flags_train(scene, capsys, argv):
    scene_dir, net = scene
    assert testbed.main(["--scene", scene_dir, "--maxiter", "3"] + argv
                        + _small(net)) == 0
    assert "iteration=3 loss=" in capsys.readouterr().out


def test_no_card_no_fallback(scene, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device runs")
    scene_dir, net = scene
    argv = ["--scene", scene_dir, "--maxiter", "5", "--network", net]
    assert testbed.main(argv) != 0
    assert "cuda" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(scene_dir, "output",
                                           "snapshot_5.msgpack"))
