"""Image I/O on the host (counterpart of ``pbrt_tpu/core/imageio.py``).

* PFM: header "PF"/"Pf", the scale's sign gives the byte order, rows
  stored bottom-up; read and written here with numpy alone.
* PNG: read and written through PIL, imported only when a PNG is read
  or written (8-bit RGB over 255 on read, no degamma; write quantizes
  ``clamp(255 gamma_correct(v) + 0.5, 0, 255)``).
* EXR and TGA raise, as in the reference.

``write_image`` writes only the ``output_bounds`` crop.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from pbrt_tpu_torch import gamma_correct


class ImageIOError(ValueError):
    pass


def to_byte(v):
    """Gamma-correct float -> byte, vectorized."""
    return np.clip(255.0 * gamma_correct(np.asarray(v, dtype=np.float32)) + 0.5, 0.0,
                   255.0).astype(np.uint8)


def _read_pfm(name: str, float_t):
    with open(name, "rb") as f:
        data = f.read()
    pos = 0

    def read_word():
        nonlocal pos
        start = pos
        while pos < len(data) and data[pos:pos + 1] not in (b" ", b"\n", b"\t"):
            pos += 1
        word = data[start:pos].decode("ascii")
        pos += 1  # one whitespace byte
        return word

    hdr = read_word()
    if hdr not in ("PF", "Pf"):
        raise ImageIOError(f"invalid PFM header {hdr!r}")
    n_channels = 3 if hdr == "PF" else 1
    width = int(read_word())
    height = int(read_word())
    scale = float(read_word())
    n_floats = n_channels * width * height
    dt = np.dtype("<f4") if scale < 0 else np.dtype(">f4")
    raw = np.frombuffer(data[pos:pos + 4 * n_floats], dtype=dt).astype(np.float64)
    raw = raw * abs(scale) if abs(scale) != 1.0 else raw
    img = raw.reshape(height, width, n_channels)[::-1]  # rows bottom-up
    if n_channels == 1:
        img = np.repeat(img, 3, axis=-1)
    return img.astype(float_t), (width, height)


def read_image(name: str, float_t=np.float32):
    """Read an image -> ([H, W, 3] RGB in the policy's float ``float_t``,
    (width, height))."""
    ext = Path(name).suffix.lower()
    if ext == ".png":
        from PIL import Image

        with Image.open(name) as im:
            arr = np.asarray(im.convert("RGB"), dtype=float_t) / float_t(255.0)
        return arr, (arr.shape[1], arr.shape[0])
    if ext == ".pfm":
        return _read_pfm(name, float_t)
    if ext in (".exr", ".tga"):
        raise ImageIOError(f"reading '{ext}' files is not yet implemented")
    raise ImageIOError(f"unknown extension '{ext}'")


def _write_pfm(name: str, rgb: np.ndarray, width: int, height: int) -> None:
    host_le = sys.byteorder == "little"
    with open(name, "wb") as f:
        f.write(f"PF\n{width} {height}\n{-1.0 if host_le else 1.0}\n".encode("ascii"))
        img = np.asarray(rgb, dtype=np.float32).reshape(height, width, 3)
        f.write(img[::-1].astype("<f4" if host_le else ">f4").tobytes())


def write_image(name: str, rgb, output_bounds, total_resolution=None) -> None:
    """Write the ``output_bounds`` crop of RGB data (flat [w h 3] or
    [h, w, 3]); the format follows the extension."""
    w, h = output_bounds.diagonal()
    rgb = np.asarray(rgb, dtype=np.float32).reshape(h, w, 3)
    ext = Path(name).suffix.lower()
    if ext == ".png":
        from PIL import Image

        Image.fromarray(to_byte(rgb), mode="RGB").save(name, format="PNG")
    elif ext == ".pfm":
        _write_pfm(name, rgb, w, h)
    elif ext in (".exr", ".tga"):
        raise ImageIOError(f"writing '{ext}' files is not implemented")
    else:
        raise ImageIOError(f"unknown file extension {ext}")
