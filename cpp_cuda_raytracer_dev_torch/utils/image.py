"""Image output + HUD logging utilities (the JAX package's
``utils/image.py``, numpy only, byte for byte the same files).

The reference presents frames with StretchDIBits into a Win32 window and
redraws a console HUD in place with VT escapes (WinMain.cpp:217,225-234).
A headless renderer has no window; the equivalents are PPM/PNG artifacts
on disk and an in-place terminal HUD for the animation driver.
"""

from __future__ import annotations

import sys

import numpy as np


def to_display(image_bottom_up: np.ndarray) -> np.ndarray:
    """Flip the renderer's bottom-up row order (DIB convention,
    WinMain.cpp:217) to top-down for normal image files."""
    return np.asarray(image_bottom_up)[::-1]


def write_ppm(path: str, image_bottom_up: np.ndarray) -> None:
    """Binary PPM (P6) writer — zero-dependency frame artifact."""
    img = to_display(image_bottom_up).astype(np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def write_png(path: str, image_bottom_up: np.ndarray) -> None:
    """Minimal PNG writer (zlib stored blocks via the stdlib)."""
    import struct
    import zlib

    img = to_display(image_bottom_up).astype(np.uint8)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", header))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


class Hud:
    """In-place multi-line console status block (VT save/restore cursor,
    the reference's \\x1b[s / \\x1b[u trick, WinMain.cpp:225-234)."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stdout
        self._lines = 0

    def update(self, lines: list[str]) -> None:
        s = self.stream
        if self._lines:
            s.write(f"\x1b[{self._lines}F")  # cursor up to block start
        for line in lines:
            s.write("\x1b[2K" + line + "\n")
        self._lines = len(lines)
        s.flush()
