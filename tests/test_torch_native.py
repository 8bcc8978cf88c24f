"""The port's native host-IO core (``sparkdl_tpu_torch/native``), held to
the JAX package's core bit for bit (both build here with g++, libjpeg and
libpng): JPEG and PNG, gray, RGB and RGBA, several sizes, through
``decode_resize_batch`` and ``resize_batch_rgb``; ``decodeResizeBatch``
and ``structsToBatch`` against the JAX package's default route (the core);
the PIL route where the core is disabled or does not build; and the
``io.decode`` fault site, which routes around the core."""

import io as _io

import numpy as np
import pytest

import sparkdl_tpu.native as jax_native
import sparkdl_tpu_torch.native as native
from sparkdl_tpu.image import io as jax_io
from sparkdl_tpu_torch.image import io as port_io


def _encode(arr, fmt, **kw):
    from PIL import Image

    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(21)
    out = []
    for h, w in [(80, 100), (299, 350), (31, 17), (640, 480)]:
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        out.append(_encode(rgb, "JPEG", quality=90))
        out.append(_encode(rgb, "PNG"))
    gray = rng.integers(0, 256, (60, 45), dtype=np.uint8)
    out += [_encode(gray, "JPEG"), _encode(gray, "PNG"),
            _encode(rng.integers(0, 256, (50, 70, 4), dtype=np.uint8), "PNG"),
            _encode(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8), "JPEG",
                    progressive=True),
            b"not an image", b""]
    return out


@pytest.fixture()
def pil_route():
    """The core as ``SPARKDL_TPU_DISABLE_NATIVE`` leaves it (unloaded)."""
    with native.disabled():
        yield


def test_core_builds_under_build_keyed_by_its_source():
    built, why = native.status()
    assert built and why == "" and jax_native.native_available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "sparkdl_tpu_torch"
    assert path.parent.parent.name == "build"
    assert path.name.startswith("libsparkdl_native_")


@pytest.mark.parametrize("size", [(224, 224), (299, 299), (48, 56), (7, 300)])
def test_decode_resize_batch_is_jax_s_bit_for_bit(blobs, size):
    h, w = size
    got, ok = native.decode_resize_batch(blobs, h, w)
    want, want_ok = jax_native.decode_resize_batch(blobs, h, w)
    assert got.shape == (len(blobs), h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(ok, want_ok)
    assert ok.tolist()[-2:] == [False, False] and ok[:-2].all()
    np.testing.assert_array_equal(got, want)
    assert not got[-2:].any()
    # one thread or many: the same bytes
    one, _ = native.decode_resize_batch(blobs, h, w, num_threads=1)
    np.testing.assert_array_equal(one, got)


@pytest.mark.parametrize("size", [(224, 224), (33, 20), (100, 100)])
def test_resize_batch_rgb_is_jax_s_bit_for_bit(size):
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in [(100, 100), (299, 400), (12, 9), (224, 224)]]
    got = native.resize_batch_rgb(imgs, *size)
    np.testing.assert_array_equal(got, jax_native.resize_batch_rgb(imgs,
                                                                  *size))
    with pytest.raises(ValueError, match="uint8"):
        native.resize_batch_rgb([np.zeros((4, 4), np.uint8)], 8, 8)
    assert native.resize_batch_rgb([], 4, 4).shape == (0, 4, 4, 3)


def test_native_close_to_pil(blobs):
    """The core's resize is not PIL's: within the JAX package's limit of 8
    in mean absolute difference (``tests/test_native.py``)."""
    from PIL import Image

    got, _ = native.decode_resize_batch(blobs[:8], 64, 72)
    for i, blob in enumerate(blobs[:8]):
        ref = np.asarray(Image.open(_io.BytesIO(blob)).convert("RGB")
                         .resize((72, 64), Image.BILINEAR))
        assert np.abs(got[i].astype(int) - ref).mean() < 8.0


def test_decode_resize_batch_is_jax_s_default_route(blobs):
    got, ok = port_io.decodeResizeBatch(blobs, 40, 50)
    want, want_ok = jax_io.decodeResizeBatch(blobs, 40, 50)
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, native.decode_resize_batch(blobs, 40, 50)[0])


def _structs(rng):
    from sparkdl_tpu.image.schema import imageArrayToStruct

    return [imageArrayToStruct(rng.integers(0, 256, (h, w, c),
                                            dtype=np.uint8), origin="o")
            for h, w, c in [(9, 7, 3), (30, 40, 1), (16, 16, 4),
                            (64, 48, 3), (5, 5, 3)]]


@pytest.mark.parametrize("n", [3, 5])
def test_structs_to_batch_is_jax_s_default_route(n):
    """Four structs or more take the core's resize, as in the JAX package;
    fewer take PIL."""
    structs = _structs(np.random.default_rng(8))[:n]
    got = port_io.structsToBatch(structs, 24, 20)
    np.testing.assert_array_equal(got, jax_io.structsToBatch(structs, 24, 20))
    if n >= 4:
        rgb = [jax_io.structToModelInput(s, s["height"], s["width"])
               for s in structs]
        np.testing.assert_array_equal(
            got, native.resize_batch_rgb([np.ascontiguousarray(a)
                                          for a in rgb], 24, 20))


def test_pil_route_when_disabled(blobs, pil_route):
    built, why = native.status()
    assert not built and "SPARKDL_TPU_DISABLE_NATIVE" in why
    assert native.decode_resize_batch(blobs, 8, 8) is None
    assert native.resize_batch_rgb([np.zeros((4, 4, 3), np.uint8)], 2,
                                   2) is None
    got, ok = port_io.decodeResizeBatch(blobs, 20, 24)
    assert ok.tolist() == [True] * (len(blobs) - 2) + [False, False]
    for i in np.nonzero(ok)[0]:
        arr = jax_io.PIL_decode(blobs[i])
        np.testing.assert_array_equal(
            got[i], jax_io.resizeImage(arr, 20, 24)[:, :, ::-1])
    structs = _structs(np.random.default_rng(8))
    np.testing.assert_array_equal(
        port_io.structsToBatch(structs, 24, 20),
        np.stack([jax_io.structToModelInput(s, 24, 20) for s in structs]))


def test_pil_route_when_the_build_fails(blobs, monkeypatch, tmp_path):
    """Host code degrades: a core that does not compile (no g++ or no
    jpeglib.h / png.h on the machine) leaves the PIL route, and says
    why."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with native.unloaded():
        built, why = native.status()
        assert not built and why.startswith("g++ failed")
        assert "no_such_header.h" in why
        got, ok = port_io.decodeResizeBatch(blobs[:3], 10, 12)
        assert ok.all() and got.shape == (3, 10, 12, 3)
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_decode_fault_routes_around_the_core(blobs):
    """A plan with ``io.decode`` rules decodes in row order on PIL, so the
    scheduled row is the one dropped; the other rows are PIL's."""
    from sparkdl_tpu_torch import faults

    assert native.native_available()
    plan = faults.FaultPlan.parse("seed=1;io.decode:error:exc=decode,at=2")
    with faults.active(plan):
        got, ok = port_io.decodeResizeBatch(blobs[:6], 16, 16)
    assert plan.fired("io.decode") == 1
    assert ok.tolist() == [True, False, True, True, True, True]  # 2nd call
    assert not got[1].any()
    for i in (0, 2, 3, 4, 5):
        arr = jax_io.PIL_decode(blobs[i])
        np.testing.assert_array_equal(
            got[i], jax_io.resizeImage(arr, 16, 16)[:, :, ::-1])
    clean, clean_ok = port_io.decodeResizeBatch(blobs[:6], 16, 16)
    assert clean_ok.all()
    np.testing.assert_array_equal(
        clean, native.decode_resize_batch(blobs[:6], 16, 16)[0])
