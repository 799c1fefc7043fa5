"""Image files and the scene loader of the PyTorch port against cv2 and the
JAX package.

PNG: the port's reader equals `cv2.imread(IMREAD_UNCHANGED)` with cv2's
BGR(A) flipped, for 8 and 16 bit, every channel count and files whose
rows use every filter type; cv2 reads the port's writer back exactly;
what the readers still refuse (a PIZ EXR, a progressive JPEG, a tiled or
planar-separate TIFF) raises by name. image_io: every loader
equals the JAX package's on the same file. Loader: `load_transform_json`
of both packages on one scene directory is bitwise equal in normals,
albedos, alphas and the skip candidate, and equal in cameras; with k1–p2
and with F-theta, `rays_from_pixels` agrees within 1e-6. The scene that
the port writes decodes to `sphere_dataset` within the 16-bit
quantization (the rule of tests/test_cli_pipeline.py).
"""

import json
import shutil
import struct
import zlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

cv2 = pytest.importorskip("cv2")

from rnb_neus2_tpu.geom.camera import rays_from_pixels as j_rays
from rnb_neus2_tpu.io import dataset as jdataset
from rnb_neus2_tpu.io import image_io as jimage_io
from rnb_neus2_tpu.testing.synthetic import \
    write_prepared_scene as j_write_scene
from rnb_neus2_torch.geom.camera import rays_from_pixels
from rnb_neus2_torch.io import dataset, errors, image_io, png
from rnb_neus2_torch.testing.synthetic import (sphere_dataset,
                                               write_prepared_scene)

COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _encode(img, filters, color_type=None, interlace=0) -> bytes:
    """A PNG of img (uint8/uint16, (H, W, C), RGB(A)) whose row r uses
    filter filters[r % len(filters)]: the encoder of PNG section 9."""
    h, w, ch = img.shape
    nb = img.dtype.itemsize
    bpp = ch * nb
    raw = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))) \
        .view(np.uint8).reshape(h, w * bpp).astype(np.int64)
    rows = []
    for r in range(h):
        x = raw[r]
        b = raw[r - 1] if r else np.zeros_like(x)
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
        ft = filters[r % len(filters)]
        if ft == 4:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        else:
            pred = [0, a, b, (a + b) // 2][ft]
        rows.append(np.concatenate([[ft], (x - pred) & 255]))
    data = np.concatenate(rows).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    ct = COLOR_TYPE[ch] if color_type is None else color_type
    ihdr = struct.pack(">IIBBBBB", w, h, nb * 8, ct, 0, 0, interlace)
    return (png.SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


def _cv2_rgb(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3 and img.shape[2] >= 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def _image(rng, dtype, ch, h=13, w=21):
    hi = np.iinfo(dtype).max
    return rng.integers(0, hi, (h, w, ch), dtype=dtype, endpoint=True)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_png_reader_matches_cv2_every_filter(tmp_path, dtype, ch):
    rng = np.random.default_rng(ch)
    img = _image(rng, dtype, ch)
    # smooth content too, where Paeth and Average pick every predictor
    img[::2] = np.sort(img[::2], axis=1)
    path = tmp_path / "f.png"
    path.write_bytes(_encode(img, [0, 1, 2, 3, 4, 4, 3, 1]))
    got = png.read_png(path)
    want = img[..., 0] if ch == 1 else img
    np.testing.assert_array_equal(got, want)
    assert got.dtype == dtype
    ref = _cv2_rgb(path)
    if ch == 2:   # cv2 reads grey+alpha as BGRA
        np.testing.assert_array_equal(ref, img[..., [0, 0, 0, 1]])
        np.testing.assert_array_equal(image_io.read_raw(path), ref)
    else:
        np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("ch", [1, 3, 4])
def test_png_writer_read_back_by_cv2(tmp_path, dtype, ch):
    img = _image(np.random.default_rng(7), dtype, ch)
    path = tmp_path / "w.png"
    png.write_png(path, img[..., 0] if ch == 1 else img)
    ref = _cv2_rgb(path)
    np.testing.assert_array_equal(ref, img[..., 0] if ch == 1 else img)
    # and the port reads what cv2 writes (its own filter choice)
    cv_path = tmp_path / "cv.png"
    cv2.imwrite(str(cv_path), img[..., [2, 1, 0, 3][:ch]] if ch > 1
                else img[..., 0])
    np.testing.assert_array_equal(png.read_png(cv_path), ref)


def _tiff_header(tags) -> bytes:
    """A little-endian TIFF whose one IFD holds `tags` ({tag: SHORT})."""
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHIHH", t, 3, 1, v, 0) for t, v in sorted(tags.items()))
    return b"II*\x00" + struct.pack("<I", 8) + ifd + bytes(4)


def test_png_refuses_what_it_does_not_read(tmp_path):
    """What the readers still refuse raises by name: a PIZ-compressed EXR
    and a BMP, which cv2 reads (UnsupportedImage), and a hierarchical JPEG
    and an Orientation 6 TIFF, which cv2 cannot read either
    (UnreadableImage, a FileNotFoundError as the JAX loaders raise for
    cv2's None, asserted beside cv2's None on the same bytes)."""
    image_io.save_exr(np.zeros((4, 5, 3), np.float32), tmp_path / "x.exr")
    blob = (tmp_path / "x.exr").read_bytes()
    key = b"compression\0compression\0" + struct.pack("<i", 1)
    (tmp_path / "piz.exr").write_bytes(blob.replace(key + b"\x03",
                                                    key + b"\x04"))
    cv2.imwrite(str(tmp_path / "b.bmp"), np.zeros((9, 9, 3), np.uint8))
    (tmp_path / "b.img").write_bytes((tmp_path / "b.bmp").read_bytes())
    for name, what in (("piz.exr", "PIZ"), ("b.img", "BMP")):
        with pytest.raises(errors.UnsupportedImage,
                           match=f"{what}.*not supported"):
            image_io.load_image(tmp_path / name)
    jpg = cv2.imencode(".jpg", np.zeros((9, 9, 3), np.uint8))[1].tobytes()
    (tmp_path / "h.jpg").write_bytes(jpg.replace(b"\xff\xc0", b"\xff\xc5",
                                                 1))
    base = {256: 8, 257: 8, 258: 8, 259: 1, 262: 1, 277: 1}
    (tmp_path / "o6.tif").write_bytes(_tiff_header({**base, 257: 9,
                                                    274: 6}))
    for name, what in (("h.jpg", "hierarchical"), ("o6.tif", "Orientation")):
        assert cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(FileNotFoundError, match=f"Cannot read.*{what}"):
            image_io.load_image(tmp_path / name)
    (tmp_path / "z.png").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(errors.UnreadableImage, match="not a PNG"):
        png.read_png(tmp_path / "z.png")


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_image_loaders_match_jax(tmp_path, dtype, ch):
    img = _image(np.random.default_rng(10 + ch), dtype, ch)
    path = tmp_path / "i.png"
    path.write_bytes(_encode(img, [4, 1, 3, 0, 2]))
    for name in ("load_image", "load_image_raw16", "load_normal"):
        got, want = getattr(image_io, name)(path), \
            getattr(jimage_io, name)(path)
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.dtype == want.dtype, name


@pytest.mark.parametrize("bit_depth", [8, 16])
def test_save_image_matches_jax(tmp_path, bit_depth):
    rng = np.random.default_rng(bit_depth)
    img = rng.uniform(-0.1, 1.1, (9, 11, 4)).astype(np.float32)
    img[0, 0, 0] = np.nan
    image_io.save_image(img, tmp_path / "p.png", bit_depth)
    jimage_io.save_image(img, tmp_path / "j.png", bit_depth)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "p.png"), cv2.IMREAD_UNCHANGED),
        cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED))
    n = rng.uniform(-1, 1, (9, 11, 3))
    image_io.save_normal_16bit(n, tmp_path / "pn.png")
    jimage_io.save_normal_16bit(n, tmp_path / "jn.png")
    np.testing.assert_array_equal(png.read_png(tmp_path / "pn.png"),
                                  png.read_png(tmp_path / "jn.png"))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    kw = dict(n_views=3, width=20, height=16, radius=0.2,
              albedo_scales=[(1.0, 0.9, 1.1)] * 3)
    return (write_prepared_scene(str(root / "port"), **kw),
            j_write_scene(str(root / "jax"), **kw))


def test_port_scene_pixels_equal_jax_scene(scenes):
    port, jax_dir = scenes
    for sub in ("normals", "albedos"):
        for i in range(3):
            name = f"{sub}/{i:05d}.png"
            np.testing.assert_array_equal(
                png.read_png(f"{port}/{name}"),
                _cv2_rgb(f"{jax_dir}/{name}"), err_msg=name)
    with open(f"{port}/transform.json") as f, \
            open(f"{jax_dir}/transform.json") as g:
        assert json.load(f) == json.load(g)


def _assert_datasets_equal(ds, jds):
    for f in ("normals", "albedos", "alpha_normal", "alpha_albedo",
              "skip_candidate"):
        np.testing.assert_array_equal(getattr(ds, f).numpy(),
                                      np.asarray(getattr(jds, f)),
                                      err_msg=f)
    for f in ("rot_c2w", "origin", "focal", "principal"):
        np.testing.assert_array_equal(getattr(ds.cameras, f).numpy(),
                                      np.asarray(getattr(jds.cameras, f)),
                                      err_msg=f)
    assert ds.cameras.resolution == jds.cameras.resolution
    assert vars(ds.meta) == vars(jds.meta)


@pytest.mark.parametrize("which", [0, 1], ids=["port_scene", "jax_scene"])
def test_load_transform_json_matches_jax(scenes, which):
    scene = scenes[which]
    _assert_datasets_equal(dataset.load_transform_json(scene),
                           jdataset.load_transform_json(scene))


def test_loaded_scene_matches_sphere_dataset(scenes):
    ds = dataset.load_transform_json(scenes[0])
    mem = sphere_dataset(n_views=3, width=20, height=16, radius=0.2)
    np.testing.assert_allclose(ds.cameras.origin.numpy(),
                               mem.cameras.origin.numpy(), atol=1e-5)
    inside = mem.alpha_normal.numpy() > 0.5
    assert np.abs(ds.normals.numpy()[inside]
                  - mem.normals.numpy()[inside]).max() < 5e-3
    np.testing.assert_array_equal(ds.alpha_normal.numpy() > 0.5, inside)


@pytest.mark.parametrize("lens", ["opencv", "ftheta"])
def test_distorted_rays_match_jax(scenes, tmp_path, lens):
    scene = tmp_path / "scene"
    shutil.copytree(scenes[0], scene)
    with open(scene / "transform.json") as f:
        tj = json.load(f)
    if lens == "opencv":
        tj.update(k1=-0.12, k2=0.03, p1=1e-3, p2=-2e-3)
    else:
        tj.update({f"ftheta_p{i}": v for i, v in
                   enumerate([0.0, 3.1e-3, 1e-7, -2e-9, 1e-12])})
    with open(scene / "transform.json", "w") as f:
        json.dump(tj, f)
    ds = dataset.load_transform_json(str(scene))
    jds = jdataset.load_transform_json(str(scene))
    field = "distortion" if lens == "opencv" else "ftheta"
    np.testing.assert_array_equal(getattr(ds.cameras, field).numpy(),
                                  np.asarray(getattr(jds.cameras, field)))
    rng = np.random.default_rng(5)
    img = rng.integers(0, 3, 256)
    xy = rng.random((256, 2)).astype(np.float32)
    o, d = rays_from_pixels(ds.cameras, torch.as_tensor(img),
                            torch.as_tensor(xy))
    jo, jd = j_rays(jds.cameras, jnp.asarray(img), jnp.asarray(xy))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    # without lens fields, the pinhole rays of the code before lens
    # support, bit for bit
    plain = ds.cameras._replace(distortion=None, ftheta=None)
    idx, xy_t = torch.as_tensor(img), torch.as_tensor(xy)
    _, d0 = rays_from_pixels(plain, idx, xy_t)
    W, H = plain.resolution
    pp, f = plain.principal[idx], plain.focal[idx]
    x = (xy_t[:, 0] - pp[:, 0]) * W / f[:, 0]
    y = (xy_t[:, 1] - pp[:, 1]) * H / f[:, 1]
    want = torch.einsum("rij,rj->ri", plain.rot_c2w[idx],
                        torch.stack([x, y, torch.ones_like(x)], dim=1))
    want = want / torch.linalg.norm(want, dim=1, keepdim=True)
    assert torch.equal(d0, want)
    moved = ds.to("cpu").cameras
    assert torch.equal(getattr(moved, field), getattr(ds.cameras, field))


def test_prepare_handles_unreadable_files_as_jax(tmp_path):
    """A scene in which cv2 cannot read one normal map, one albedo and
    one mask (a hierarchical JPEG under each name): the JAX package skips
    the view with a warning, fills the albedo with ones and makes the
    mask opaque (and leaves the mask out of the silhouette scaling); the
    port does the same, to the byte."""
    from test_torch_image_formats import _cv2_rgb, _write_scene

    import rnb_neus2_tpu.io.prepare as jprepare
    from rnb_neus2_torch.io import prepare

    data = _write_scene(str(tmp_path / "in"), "png", "tif", "png", {})
    data["views"].append(dict(data["views"][0]))
    data["views"][3]["c2w"] = data["views"][0]["c2w"].copy()
    data["views"][3]["c2w"][:3, 3] *= 1.1
    jpg = cv2.imencode(".jpg", np.zeros((9, 9, 3), np.uint8))[1].tobytes()
    bad = jpg.replace(b"\xff\xc0", b"\xff\xc5", 1)
    for i, key in ((0, "normal_path"), (1, "albedo_path"), (2, "mask_path")):
        path = str(tmp_path / "in" / f"bad_{key}.png")
        with open(path, "wb") as f:
            f.write(bad)
        assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is None
        data["views"][i][key] = path
    logs = {}
    for name, mod in (("port", prepare), ("jax", jprepare)):
        lines = []

        class Log:
            def info(self, msg):
                lines.append(("info", msg))

            def warning(self, msg):
                lines.append(("warning", msg))
        out = mod.prepare_testbed_data(data, str(tmp_path / name),
                                       logger=Log(),
                                       scaling_mode="silhouettes")
        logs[name] = (out, lines)
    (out, lines), (jout, jlines) = logs["port"], logs["jax"]
    assert out["n_frames"] == jout["n_frames"] == 3
    np.testing.assert_allclose(out["scale_matrix"], jout["scale_matrix"],
                               rtol=1e-9)
    assert [m for k, m in lines if k == "warning"] == \
        [m for k, m in jlines if k == "warning"] == \
        [f"Cannot read: {data['views'][0]['normal_path']}"]
    tj, jtj = (json.load(open(tmp_path / d / "transform.json"))
               for d in ("port", "jax"))
    assert len(tj["frames"]) == len(jtj["frames"]) == 3
    for fr, jfr in zip(tj["frames"], jtj["frames"]):
        np.testing.assert_allclose(fr["transform_matrix"],
                                   jfr["transform_matrix"], rtol=1e-9)
        for k in ("normal_path", "albedo_path"):
            got = png.read_png(tmp_path / "port" / fr[k])
            np.testing.assert_array_equal(got, _cv2_rgb(
                tmp_path / "jax" / jfr[k]))
    # view 1's albedo (frame 0) is all ones; view 2's alphas (frame 1)
    # are opaque
    alb = png.read_png(tmp_path / "port" / tj["frames"][0]["albedo_path"])
    assert (alb[..., :3] == 65535).all()
    nrm = png.read_png(tmp_path / "port" / tj["frames"][1]["normal_path"])
    assert (nrm[..., 3] == 65535).all()
