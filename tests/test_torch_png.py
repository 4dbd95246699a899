"""The port's standard-library PNG route (``data/native.py``: ``read_png``
and ``decode_zlib``, zlib and numpy) against the native libpng decoder on
the same files: bitwise, for grey, grey+alpha, RGB and RGBA, every row
filter, at the files' size and resized.  The files are written here with
the standard library, each row's filter chosen in turn.  What the route
does not read (16-bit, palette, interlaced) raises ``IOError`` naming the
file, and ``decode_batch`` falls back to it without the library and
imageio."""
import struct
import sys
import zlib

import numpy as np
import pytest

from eamm_tpu_torch.data import native

# colour type -> channels
COLORS = {0: 1, 4: 2, 2: 3, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png(img: np.ndarray, color: int, filters, depth: int = 8,
         interlace: int = 0) -> bytes:
    """An 8-bit PNG of ``img`` [h, w, c], row y filtered by filters[y]."""
    h, w, bpp = img.shape
    raw = img.reshape(h, w * bpp).astype(np.int64)
    body, prev = bytearray(), np.zeros(w * bpp, np.int64)
    for y in range(h):
        line, f = raw[y], int(filters[y])
        left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [0, left, prev, (left + prev) // 2,
                np.array([_paeth(a, b, c)
                          for a, b, c in zip(left, prev, upleft)])][f]
        body.append(f)
        body += bytes(((line - pred) & 255).astype(np.uint8))
        prev = line
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                          0, interlace))
            + _chunk(b"IDAT", zlib.compress(bytes(body)))
            + _chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One file per colour type, 37 x 29, the rows' filters cycling
    through all five from a different start in each file."""
    work = tmp_path_factory.mktemp("png")
    rng = np.random.RandomState(0)
    out = []
    for i, (color, c) in enumerate(COLORS.items()):
        img = (rng.rand(37, 29, c) * 255).astype(np.uint8)
        path = str(work / f"c{color}.png")
        with open(path, "wb") as f:
            f.write(_png(img, color, (np.arange(37) + i) % 5))
        out.append((path, img))
    return out


def test_read_png_undoes_every_filter(files):
    for path, img in files:
        assert np.array_equal(native.read_png(path), img), path


@pytest.mark.parametrize("hw", [(37, 29), (64, 48), (20, 13)])
def test_zlib_route_is_bitwise_the_native_library(files, hw):
    if not native.native_available():
        pytest.fail(f"the native decoder did not build: "
                    f"{native.build_error()}")
    paths = [p for p, _ in files]
    ours = native.decode_zlib(paths, *hw)
    ref = native.decode_batch(paths, *hw)
    assert ours.dtype == ref.dtype == np.float32
    assert np.array_equal(ours.view(np.uint32), ref.view(np.uint32))


def test_unread_forms_raise_by_name(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    cases = {"sixteen.png": (_png(img, 2, [0] * 4, depth=16), "bit depth 16"),
             "palette.png": (_png(img[..., :1], 3, [0] * 4), "palette"),
             "interlaced.png": (_png(img, 2, [0] * 4, interlace=1),
                                "interlaced")}
    for name, (data, what) in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(IOError, match=what) as err:
            native.decode_zlib([str(path)], 4, 4)
        assert name in str(err.value)


def test_decode_batch_falls_back_to_zlib(files, monkeypatch):
    """Without the library and without imageio, ``decode_batch`` takes the
    zlib route, and ``route`` and ``build_error`` say so."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_error", "no png.h")
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    monkeypatch.setattr(native, "_no_imageio", False)
    paths = [p for p, _ in files]
    assert native.route() == "zlib" and native._no_imageio
    assert "zlib route" in native.build_error()
    assert np.array_equal(native.decode_batch(paths, 20, 13),
                          native.decode_zlib(paths, 20, 13))
