"""The port's msgpack codec (`rnb_neus2_torch/utils/msgpack_codec.py`)
against `msgpack` and flax: `packb` gives the bytes of `msgpack.packb`
with flax's extension hook and of flax's `msgpack_serialize` for the same
object, at every header width; `unpackb` reads flax's bytes, chunked
arrays included, as flax reads them."""

import msgpack
import numpy as np
import pytest
from flax import serialization

from rnb_neus2_torch.utils import msgpack_codec as mc

SNAPSHOT_DTYPES = [np.float32, np.float16, np.int32, np.uint32, np.bool_,
                   np.uint8]


def _ref(obj) -> bytes:
    return msgpack.packb(obj, default=serialization._msgpack_ext_pack)


def _sorted(obj):
    """flax's msgpack_serialize writes every map with sorted keys."""
    if isinstance(obj, dict):
        return {k: _sorted(obj[k]) for k in sorted(obj)}
    return obj


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert type(a) is type(b), (type(a), type(b))
        if isinstance(a, (np.ndarray, np.generic)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        elif isinstance(a, float) and np.isnan(a):
            assert np.isnan(b)
        else:
            assert a == b


@pytest.mark.parametrize("dtype", SNAPSHOT_DTYPES,
                         ids=lambda d: np.dtype(d).name)
def test_arrays_and_scalars_match_flax(dtype):
    rng = np.random.default_rng(0)
    arr = (rng.standard_normal((3, 5)) * 100).astype(dtype)
    obj = {"array": arr, "zero_d": np.asarray(arr.flat[0]),
           "scalar": arr.flat[1], "empty": np.zeros((0, 2), dtype),
           "column": np.ascontiguousarray(arr[:, 1])}
    assert mc.packb(obj) == _ref(obj)
    assert mc.packb(_sorted(obj)) == serialization.msgpack_serialize(obj)
    _same(mc.unpackb(mc.packb(obj)), serialization.msgpack_restore(
        _ref(obj)))


@pytest.mark.parametrize("value", [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
    -2 ** 31 - 1, -2 ** 63, 0.0, -1.5, 1e300, float("nan"), True, False,
    None, "", "x" * 31, "x" * 32, "é" * 200, "y" * 70000, b"", b"z" * 255,
    b"z" * 256, b"z" * 70000])
def test_scalars_strings_and_bins_match_msgpack(value):
    assert mc.packb(value) == _ref(value)
    _same(mc.unpackb(mc.packb(value)), msgpack.unpackb(_ref(value)))


def test_large_containers_match_msgpack():
    obj = {"map16": {str(i): i for i in range(40)},
           "map_fix": {str(i): -i for i in range(15)},
           "array16": list(range(20)), "array_fix": list(range(15)),
           "nested": [[{"a": [1, 2.5, None]}]],
           "big_bin": np.arange(20000, dtype=np.float32),   # 80 KB payload
           "str8": "s" * 200}
    assert mc.packb(obj) == _ref(obj)
    assert mc.packb(_sorted(obj)) == serialization.msgpack_serialize(obj)
    _same(mc.unpackb(mc.packb(obj)), msgpack.unpackb(
        _ref(obj), ext_hook=serialization._msgpack_ext_unpack))
    # a map of more than 65535 keys takes the 32-bit header
    wide = {str(i): i % 7 for i in range(70000)}
    assert mc.packb(wide) == _ref(wide)


def test_reads_flax_bytes_including_chunked_arrays(monkeypatch):
    rng = np.random.default_rng(1)
    tree = {"params": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                       "b": np.zeros(3, np.float16)},
            "step": np.int32(7), "key": np.array([1, 2], np.uint32),
            "flag": np.bool_(True), "config_json": "{}"}
    _same(mc.unpackb(serialization.msgpack_serialize(tree)),
          serialization.msgpack_restore(serialization.msgpack_serialize(
              tree)))
    # flax writes an array above its chunk size as a map of flat chunks
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = rng.standard_normal((10, 7)).astype(np.float32)
    blob = serialization.msgpack_serialize({"big": big, "small": big[:1]})
    assert b"__msgpack_chunked_array__" in blob
    got = mc.unpackb(blob)
    np.testing.assert_array_equal(got["big"], big)
    np.testing.assert_array_equal(got["small"], big[:1])


def test_refusals():
    with pytest.raises(TypeError):
        mc.packb({"a": object()})
    with pytest.raises(ValueError):
        mc.unpackb(mc.packb([1, 2]) + b"\x00")
    with pytest.raises(ValueError, match="ext type"):
        mc.unpackb(msgpack.packb(msgpack.ExtType(5, b"abc")))
