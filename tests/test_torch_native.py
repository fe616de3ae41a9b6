"""The port's host image library (``tandem_tpu_torch/native_bridge.py`` on
``csrc/host_image.c``, built here with the host C compiler) against its
plain versions, OpenCV and the JAX package's native bridge.

- The C decoder equals ``data/replica.decode_png`` bit for bit (dtype,
  shape, every sample) on every PNG under tests/fixtures and on PNGs that
  OpenCV writes at every compression level (OpenCV picks the row filters):
  8 and 16 bits, grey, grey+alpha (written here), RGB and RGBA, random and
  constant images; through ``bgr8`` it equals cv2.imread(IMREAD_COLOR).
- ``remap_u8`` equals the port's numpy ``remap_u8`` bit for bit (both
  float64) and, with the LUT, the JAX package's numpy formula bit for bit;
  against the JAX native (float32) remap it agrees within 1e-3.
- ``bgr_pack_u8`` and ``bgr_to_rgb_chw`` equal numpy exactly.
- The prefetcher delivers byte-identical frames under forward skips and
  backward seeks, stops its worker on close while the worker waits and when
  it is collected, and ImageFolderReader uses it; ``preload`` gives the
  same frames as the default route.
"""

import gc
import os
import struct
import threading
import time
import zlib

import numpy as np
import pytest

from tandem_tpu import native_bridge as jnb
from tandem_tpu_torch import native_bridge as nb
from tandem_tpu_torch.data import reader as treader
from tandem_tpu_torch.data.png_format import bgr8
from tandem_tpu_torch.data.replica import decode_png, read_png
from tandem_tpu_torch.data.undistort import remap_u8 as remap_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
TRAJ = os.path.join(FIXTURES, "replica_traj", "scene0")


def _fixture_pngs():
    out = []
    for root, _, files in os.walk(FIXTURES):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".png")]
    return sorted(out)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_decoder_equals_decode_png_on_every_fixture():
    paths = _fixture_pngs()
    assert len(paths) > 300
    kinds = set()
    for p in paths:
        ref = read_png(p)
        got = nb.read_png_native(p)
        assert _same(got, ref), p
        kinds.add((ref.dtype.name, ref.ndim))
    # images (8-bit RGB) and depths (16-bit grey) are both among them
    assert ("uint8", 3) in kinds and ("uint16", 2) in kinds


def _synthetic_images():
    rng = np.random.RandomState(7)
    for dtype, hi in ((np.uint8, 256), (np.uint16, 65536)):
        for ch in (1, 3, 4):
            shape = (23, 37) if ch == 1 else (23, 37, ch)
            yield f"random {dtype.__name__} {ch}", \
                rng.randint(0, hi, shape).astype(dtype)
            yield f"constant {dtype.__name__} {ch}", \
                np.full(shape, hi // 3, dtype)
            ramp = (np.add.outer(np.arange(23), 3 * np.arange(37)) * 97
                    % hi).astype(dtype)
            yield f"ramp {dtype.__name__} {ch}", (
                ramp if ch == 1 else np.repeat(ramp[..., None], ch, -1))


def test_decoder_on_opencv_pngs_at_every_level(tmp_path):
    """OpenCV chooses the row filters; every level 0-9 of every case."""
    cv2 = pytest.importorskip("cv2")
    n = 0
    for name, img in _synthetic_images():
        for level in range(10):
            path = str(tmp_path / "x.png")
            assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION,
                                           level])
            data = open(path, "rb").read()
            ref = decode_png(data)
            got = nb.decode_png_native(data)
            assert _same(got, ref), (name, level)
            assert np.array_equal(
                bgr8(got), cv2.imread(path, cv2.IMREAD_COLOR)), (name, level)
            n += 1
    assert n == 18 * 10


def _png(img: np.ndarray, filters, idat_parts: int = 1) -> bytes:
    """A PNG whose rows use the given filter types (cycled), its data split
    over ``idat_parts`` IDAT chunks: exercises every filter, grey+alpha
    (which OpenCV does not write) and multiple IDAT chunks."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    bpp = ch * img.dtype.itemsize
    rows = img.astype(img.dtype.newbyteorder(">")).reshape(h, -1) \
        .view(np.uint8).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if f == 0:
            line = cur
        elif f == 1:
            line = cur - a
        elif f == 2:
            line = cur - up
        elif f == 3:
            line = cur - (a + up) // 2
        else:
            pa, pb, pc = np.abs(up - c), np.abs(a - c), np.abs(a + up - 2 * c)
            p = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
            line = cur - p
        raw += bytes([f]) + (line % 256).astype(np.uint8).tobytes()
    comp = zlib.compress(bytes(raw), 9)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8 * img.dtype.itemsize, ctype, 0, 0, 0))
    step = -(-len(comp) // idat_parts)
    for i in range(0, len(comp), step):
        out += chunk(b"IDAT", comp[i:i + step])
    return out + chunk(b"IEND", b"")


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_decoder_every_filter_and_split_idat(ch, dtype):
    rng = np.random.RandomState(ch)
    hi = np.iinfo(dtype).max + 1
    shape = (17, 29) if ch == 1 else (17, 29, ch)
    img = rng.randint(0, hi, shape).astype(dtype)
    for filters in ((0,), (1,), (2,), (3,), (4,), (4, 1, 2, 3, 0)):
        data = _png(img, filters, idat_parts=3)
        got = nb.decode_png_native(data)
        assert _same(got, decode_png(data)), filters
        assert np.array_equal(got, img), filters


def test_decoder_rejects_an_unknown_filter():
    data = bytearray(_png(np.zeros((4, 5), np.uint8), (0,)))
    raw = bytearray(zlib.decompress(bytes(data[8 + 25 + 8:-12 - 4])))
    raw[2 * 6] = 7                          # row 2's filter byte
    comp = zlib.compress(bytes(raw))
    body = struct.pack(">I", len(comp)) + b"IDAT" + comp
    body += struct.pack(">I", zlib.crc32(b"IDAT" + comp) & 0xFFFFFFFF)
    bad = bytes(data[:8 + 25]) + body + bytes(data[-12:])
    for decode in (decode_png, nb.decode_png_native):
        with pytest.raises(ValueError, match="unknown row filter 7"):
            decode(bad)


def test_no_fallback_when_the_library_cannot_build(monkeypatch, tmp_path):
    monkeypatch.setattr(nb, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nb, "CC_FLAGS", nb.CC_FLAGS + ["-no-such-flag"])
    with pytest.raises(RuntimeError, match="host library build failed"):
        nb.build()


def _maps(rng, out_h, out_w, in_h, in_w, lo=-2.0, hi=1.0):
    mx = (rng.rand(out_h, out_w) * (in_w - 1 + hi - lo) + lo)
    my = (rng.rand(out_h, out_w) * (in_h - 1 + hi - lo) + lo)
    return mx.astype(np.float32), my.astype(np.float32)


def test_remap_equals_numpy_and_jax():
    rng = np.random.RandomState(3)
    for c in (1, 3):
        img = rng.randint(0, 256, (40, 50) if c == 1 else (40, 50, c)) \
            .astype(np.uint8)
        # negative, interior and past-the-edge entries
        mx, my = _maps(rng, 30, 33, 40, 50)
        got = nb.remap_u8(img, mx, my)
        assert _same(got, remap_numpy(img, mx, my))
        # the JAX native remap (float32; its own edge rule past in - 1.001)
        ix, iy = _maps(rng, 30, 33, 40, 50, lo=0.0, hi=-1.01)
        np.testing.assert_allclose(nb.remap_u8(img, ix, iy),
                                   jnb.remap_u8(img, ix, iy), atol=1e-3)


def test_remap_with_the_lut():
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (40, 50, 3)).astype(np.uint8)
    mx, my = _maps(rng, 30, 33, 40, 50)
    lut = np.cumsum(rng.rand(256)).astype(np.float32)
    lut = 255 * lut / lut[-1]
    got = nb.remap_u8(img, mx, my, lut)
    # the JAX package's numpy remap with the LUT, in float64
    out = remap_numpy(img, mx, my)
    i0 = np.clip(out.astype(int), 0, 254)
    f = out - i0
    assert _same(got, lut[i0] * (1 - f) + lut[i0 + 1] * f)
    ix, iy = _maps(rng, 30, 33, 40, 50, lo=0.0, hi=-1.01)
    np.testing.assert_allclose(nb.remap_u8(img, ix, iy, lut),
                               jnb.remap_u8(img, ix, iy, lut256=lut),
                               atol=1e-3)


def test_bgr_pack_and_rgb_chw():
    rng = np.random.RandomState(11)
    bgrs = [rng.randint(0, 256, (32, 48, 3)).astype(np.uint8)
            for _ in range(5)]
    ref = np.ascontiguousarray(np.transpose(
        np.stack([b[..., ::-1] for b in bgrs]), (0, 3, 1, 2)))
    assert _same(nb.bgr_pack_u8(bgrs), ref)
    assert _same(nb.bgr_pack_u8(bgrs), jnb.bgr_pack_u8(bgrs))
    chw = nb.bgr_to_rgb_chw(bgrs[0])
    assert _same(chw, (bgrs[0][..., ::-1].astype(np.float32) / 255.0)
                 .transpose(2, 0, 1))
    with pytest.raises(ValueError):
        nb.bgr_pack_u8([bgrs[0], bgrs[1][:-1]])


def _frames(tmp_path, n=12, shape=(32, 40, 3), seed=0):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        p = str(tmp_path / f"{i:03d}.png")
        cv2.imwrite(p, rng.randint(0, 255, shape).astype(np.uint8))
        paths.append(p)
    return cv2, paths


def test_prefetch_image_loader(tmp_path):
    """Byte-identical frames under forward skips and backward seeks (the
    worker only decodes forward; a spent frame is decoded in the reader)."""
    cv2, paths = _frames(tmp_path)
    pl = nb.PrefetchImageLoader(paths, ahead=3)
    try:
        for i in (0, 1, 2, 5, 6, 3, 11, 0, 4):
            assert np.array_equal(pl.read(i),
                                  cv2.imread(paths[i], cv2.IMREAD_COLOR)), i
        with pytest.raises(IndexError):
            pl.read(12)
    finally:
        pl.close()
    assert not pl._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        pl.read(0)


def test_prefetch_forward_skip_past_a_full_window(tmp_path):
    """ahead=1: the worker fills frames 0 and 1, then read(5) seeks it
    forward past them; the read must return, not wait for room in the
    cache (10 s limit)."""
    cv2, paths = _frames(tmp_path, n=8)
    pl = nb.PrefetchImageLoader(paths, ahead=1)
    st = pl._st
    got = []
    try:
        assert _wait(lambda: st.decoded_next == 2)
        t = threading.Thread(target=lambda: got.append(pl.read(5)),
                             daemon=True)
        t.start()
        t.join(10)
        assert not t.is_alive(), "read(5) hung"
        assert np.array_equal(got[0], cv2.imread(paths[5], cv2.IMREAD_COLOR))
        assert np.array_equal(pl.read(6),
                              cv2.imread(paths[6], cv2.IMREAD_COLOR))
    finally:
        pl.close()
    assert not pl._thread.is_alive()


def _wait(cond, seconds=10.0):
    t0 = time.time()
    while not cond() and time.time() - t0 < seconds:
        time.sleep(0.01)
    return cond()


def test_prefetch_close_while_the_worker_waits(tmp_path):
    _, paths = _frames(tmp_path, n=20)
    pl = nb.PrefetchImageLoader(paths, ahead=2)
    st = pl._st
    # the worker fills its window (frames 0..2) and waits on the condition
    assert _wait(lambda: st.decoded_next == 3)
    time.sleep(0.05)
    assert st.decoded_next == 3 and pl._thread.is_alive()
    pl.close()
    assert not pl._thread.is_alive()


def test_prefetch_close_wakes_a_blocked_read(tmp_path):
    """A read blocked on a frame the worker has not reached returns (it
    raises) once the loader is closed, instead of waiting forever."""
    _, paths = _frames(tmp_path, n=6)
    pl = nb.PrefetchImageLoader(paths, ahead=1)
    st = pl._st
    gate = threading.Event()
    real = nb.read_bgr8

    def slow(path):
        gate.wait(10)
        return real(path)
    nb.read_bgr8 = slow
    errors = []

    def reader():
        try:
            pl.read(4)
        except RuntimeError as e:
            errors.append(e)
    try:
        t = threading.Thread(target=reader)
        t.start()
        assert _wait(lambda: st.consumer == 4)
        closer = threading.Thread(target=pl.close)
        closer.start()
        gate.set()
        closer.join(10)
        t.join(10)
        assert not t.is_alive() and not closer.is_alive()
        assert not pl._thread.is_alive()
        assert errors and "closed" in str(errors[0])
    finally:
        nb.read_bgr8 = real
        gate.set()


def test_reader_worker_stops_when_the_reader_is_collected(tmp_path):
    _frames(tmp_path, n=10)
    r = treader.ImageFolderReader(str(tmp_path))
    r.get_image(0)
    r.get_image(3)
    thread = r._prefetch._thread
    assert thread.is_alive()
    del r
    gc.collect()
    thread.join(10)
    assert not thread.is_alive()


def test_reader_uses_the_prefetcher_and_preload_equals_it(tmp_path):
    _frames(tmp_path, n=6, shape=(32, 64, 3), seed=1)
    r = treader.ImageFolderReader(str(tmp_path))
    p = treader.ImageFolderReader(str(tmp_path), preload=True)
    try:
        assert r._prefetch is not None and p._prefetch is None
        assert sorted(p._cache) == list(range(6))
        for i in (0, 1, 4, 2, 5):
            g1, t1, e1 = r.get_image(i)
            g2, t2, e2 = p.get_image(i)
            assert _same(g1, g2) and (t1, e1) == (t2, e2)
            assert _same(r.get_image_bgr(i), p.get_image_bgr(i))
            assert g1.shape == (32, 64) and g1.dtype == np.uint8
    finally:
        r.close()


def test_preload_on_the_trajectory_fixture():
    """preload=True and the prefetching route give the same frames as the
    JAX reader (cv2) on the fixture, frame for frame."""
    from tandem_tpu.data.reader import ImageFolderReader as JReader
    path = os.path.join(TRAJ, "images")
    r = treader.ImageFolderReader(path, preload=True)
    j = JReader(path)
    for i in (0, 9, 63):
        assert _same(r.get_image(i)[0], j.get_image(i)[0])
        assert _same(r.get_image_bgr(i), j.get_image_bgr(i))
