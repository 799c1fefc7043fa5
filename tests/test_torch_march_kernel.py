"""The march kernels' loops (`kernels/march.walk_twin`) and the plain march
(`ops/ray_march.march_flat_plain`) against the JAX package's `march_flat`,
every output bit for bit (t and dt within 1e-6 relative at cone > 0, whose
geometric phase calls a float power), on seeded numpy inputs; and the
wrapper's refusals. The kernels themselves run on the card only
(`tests/test_torch_gpu.py -k march`, `chip_smoke.py` phase 23)."""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnb_neus2_tpu.ops import ray_march as jrm
from rnb_neus2_torch.kernels import march as mk
from rnb_neus2_torch.ops import ray_march as rm
from rnb_neus2_torch.testing import march_cases as mc

FIELDS = rm.FlatSamples._fields


def _jax(o, d, bit, u, K, S, cone, aabb, blocked):
    """The JAX package's march, op by op (under jit XLA may contract
    `startt + k·dt_min` into a fused multiply-add)."""
    return jrm.march_flat(jnp.asarray(o), jnp.asarray(d), jnp.asarray(bit),
                          jnp.asarray(u), K, S, cone, aabb_scale=aabb,
                          blocked=blocked)


def _assert_equal(got, want, cone, label):
    for f, a in zip(FIELDS, got):
        b = np.asarray(getattr(want, f))
        a = a.numpy()
        if cone > 0.0 and f in ("t", "dt"):
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=label + f)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype),
                                          err_msg=label + f)


# (R, K, S, g, occupied share, cone, aabb_scale, blocked); one R, K, g
# and, but at total_0, one S, so that the JAX ops compile for few shapes
CASES = {
    "blocked": (300, 512, 1 << 13, 32, 0.3, 0.0, 1.0, None),
    "empty": (300, 512, 1 << 13, 32, 0.0, 0.0, 1.0, None),
    "full_drops": (300, 512, 1 << 13, 32, 1.0, 0.0, 1.0, None),
    "total_0": (300, 512, 16, 32, 1.0, 0.0, 1.0, None),
    "ladder_cone_0": (300, 512, 1 << 13, 32, 0.3, 0.0, 1.0, False),
    "cone_aabb_4": (300, 512, 1 << 13, 32, 0.3, 1.0 / 256.0, 4.0, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_and_plain_match_jax(name):
    """R = 300: not a multiple of 32 (nor of a count block's 8 rays)."""
    R, K, S, g, frac, cone, aabb, blocked = CASES[name]
    o, d, u = mc.edge_rays(R, R + g, *rm._cube(aabb))
    bit = mc.bitfield(g, frac, g)
    want = _jax(o, d, bit, u, K, S, cone, aabb, blocked)
    args = [torch.from_numpy(x) for x in (o, d, bit, u)]
    reads = {}
    twin = mk.walk_twin(*args, K, S, cone, aabb, blocked, reads=reads)
    plain = rm.march_flat_plain(*args, K, S, cone, aabb, blocked)
    _assert_equal(twin, want, cone, f"{name} twin ")
    _assert_equal(plain, want, cone, f"{name} plain ")
    p = mk.plan(args[0], args[2], K, S, cone, aabb, blocked)
    assert p.blocked == (blocked is None and cone == 0.0)
    n_valid, kept = twin[5], twin[6]
    valid = int(twin[3].sum())
    if name == "total_0":
        assert n_valid[0] > S and valid == 0 and not bool(kept.any())
    if frac > 0.0 and name != "total_0":    # the budget drops rays
        assert 0 < valid <= S and not bool(kept.all()) and bool(kept[0])
    if name == "empty":
        assert int(n_valid.sum()) == 0 and reads["fine"].numel() == 0
    # the NaN rays (kind 3) have no sample; the -0.0 and ±inf rays do
    kind = mc.edge_kinds(R)
    assert int(n_valid[kind == 3].sum()) == 0
    if frac == 1.0:
        assert (n_valid[kind == 4] > 0).all() and (n_valid[kind == 5] > 0).all()
        assert (n_valid[kind == 2] > 0).all()
    # a walk reads the bitfield at most once per ladder point of its ray
    assert reads["fine"].numel() <= R * p.K
    assert (reads["coarse"].numel() > 0) == p.blocked


def test_twin_truncates_at_nb_flagged_blocks():
    """R = 9000 > 8192: each ray walks only its first NB = 116 of K/8 = 128
    blocks. Rays along the cube's diagonal place all 1024 ladder points in
    it, past the 116th block, so the blocked path differs from the
    single-phase ladder there. The twin against the plain version, which
    tests/test_torch_march.py holds against JAX at these sizes (its rays
    never pass 116 blocks); nine scan tiles."""
    R, K, S, g = 9000, 1024, 1 << 16, 128
    bit = torch.from_numpy(mc.bitfield(g, 0.05, R + K))
    o, d, u, diag = mc.diagonal_rays(R, R)
    o, d, u = (torch.from_numpy(x) for x in (o, d, u))
    p = mk.plan(o, bit, K, S, 0.0)
    assert p.blocked and p.NB == 116 < p.KB == 128
    plain = rm.march_flat_plain(o, d, bit, u, K, S, 0.0)
    twin = mk.walk_twin(o, d, bit, u, K, S, 0.0)
    for f, a, b in zip(FIELDS, twin, plain):
        assert torch.equal(a, b), f
    ladder = rm.march_flat_plain(o, d, bit, u, K, S, 0.0, blocked=False)
    cut = plain.n_valid < ladder.n_valid
    assert int(cut.sum()) > diag.sum() // 2
    assert not bool(cut[torch.from_numpy(~diag)].any())
    assert int(plain.valid.sum()) > 0 and not bool(plain.ray_kept.all())


def _cpu_args(R=8, g=16):
    o, d, u = (torch.from_numpy(x) for x in mc.edge_rays(R, 1))
    return o, d, torch.ones(g ** 3, dtype=torch.bool), u


def test_wrapper_refuses_what_the_kernels_do_not_take():
    """The kernels' checks run before any launch, so they raise here too:
    a cascaded bitfield and rays that require grad by name, CPU tensors
    for want of a card."""
    o, d, bit, u = _cpu_args()
    with pytest.raises(ValueError, match="cascaded"):
        mk.march_flat(o, d, bit.reshape(2, -1), u, 512, 64, 0.0)
    with pytest.raises(ValueError, match="gradient"):
        mk.march_flat(o.clone().requires_grad_(), d, bit, u, 512, 64, 0.0)
    with pytest.raises(ValueError, match="gradient"):
        mk.march_flat(o, d.clone().requires_grad_(), bit, u, 512, 64, 0.0)
    with pytest.raises(ValueError, match="cone 0"):
        mk.march_flat(o, d, bit, u, 512, 64, 1.0 / 256.0, blocked=True)
    with pytest.raises(TypeError, match="float32"):
        mk.march_flat(o.double(), d, bit, u, 512, 64, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        mk.march_flat(o, d, bit, u, 512, 64, 0.0)
    before = [c.launches for c in mk.COUNTERS]
    rm.march_flat(o, d, bit, u, 512, 64, 0.0)      # CPU: the plain version
    assert [c.launches for c in mk.COUNTERS] == before


def test_the_struct_matches_the_kernel_source():
    """`_Args` has the field names and types, in order, of
    csrc/march.cu's MarchArgs."""
    src = (Path(mk.__file__).parent.parent / "csrc" / mk.SOURCE).read_text()
    body = re.search(r"struct MarchArgs {(.*?)\n};", src, re.S)[1]
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    fields = re.findall(r"^\s*(?:const )?([\w ]+?)(\*?)\s+(\w+);", body,
                        re.M)
    want = [(n, ctypes.c_void_p if star else kinds[t.strip()])
            for t, star, n in fields]
    assert mk._Args._fields_ == want
    assert re.search(rf"kWarps = {mk.WARPS};", src)
    assert re.search(rf"kScanThreads = {mk.SCAN_TILE};", src)
    assert re.search(rf"kMaxSide = {mk.MAX_SIDE};", src)
    assert re.search(rf"kBlock = {mk.BLOCK};", src) and mk.BLOCK == rm.BLOCK
