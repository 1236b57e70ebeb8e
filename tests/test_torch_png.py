"""The port's PNG codec (``datasets/png.py``) against PIL, the decoder the
reference reads TUM and ScanNet images with.  Decoded pixels must be equal
(exact integers), on PIL-written files and on hand-filtered scanlines of
every filter type."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from instancefusion_tpu_torch.datasets import png

H, W = 23, 31  # odd sizes: rows and pixels that do not pack evenly


def _image(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "gray8":
        return rng.integers(0, 256, (H, W), dtype=np.uint8)
    if kind == "rgb8":
        return rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    if kind == "rgba8":
        return rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    # 16-bit depth as TUM stores it: 0.5-3 m at 1/5000 m, with holes.
    d = (rng.uniform(0.5, 3.0, (H, W)) * 5000).astype(np.uint16)
    d[rng.uniform(size=(H, W)) < 0.1] = 0
    return d


def _pil_png(image: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray16"])
def test_decode_equals_pil(kind):
    data = _pil_png(_image(kind, 1))
    ref = np.asarray(Image.open(io.BytesIO(data)))
    got = png.decode(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _filter_rows(raw: np.ndarray, kind: int, bpp: int) -> bytes:
    """PNG-encode every row of `raw` (H, stride) uint8 with filter `kind`,
    straight from the specification (one byte at a time)."""
    out = bytearray()
    prev = [0] * raw.shape[1]
    for row in raw.tolist():
        out.append(kind)
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            out.append((x - pred) % 256)
        prev = row
    return bytes(out)


def _png_bytes(ihdr: tuple, idat: bytes) -> bytes:
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", *ihdr))
            + chunk(b"IDAT", zlib.compress(idat)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_every_filter_type(kind):
    for name, color, bits, bpp in (("rgb8", 2, 8, 3), ("gray16", 0, 16, 2)):
        image = _image(name, 10 + kind)
        raw = (image.astype(">u2") if bits == 16 else image).view(np.uint8).reshape(H, -1)
        data = _png_bytes((W, H, bits, color, 0, 0, 0), _filter_rows(raw, kind, bpp))
        np.testing.assert_array_equal(png.decode(data), image)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), image)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_written_png_reads_back_in_pil(kind, tmp_path):
    image = _image(kind, 2)
    path = tmp_path / "x.png"
    png.write(str(path), image)
    with Image.open(path) as im:
        back = np.asarray(im)
    np.testing.assert_array_equal(back, image)
    np.testing.assert_array_equal(png.read(str(path)), image)
    assert png.read_header(str(path)) == (W, H)


def test_rejects_corrupt_and_unsupported():
    data = bytearray(_pil_png(_image("rgb8", 3)))
    data[40] ^= 0xFF  # inside the first IDAT payload: its CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(data))
    pal = io.BytesIO()
    Image.fromarray(_image("gray8", 4)).convert("P").save(pal, format="PNG")
    with pytest.raises(ValueError, match="unsupported"):
        png.decode(pal.getvalue())
