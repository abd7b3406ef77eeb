"""Decoded image data on the host.

Parity: reference src/scene/cpu/image_data.rs:14-59 (HalaImageData):
decodes image files and maps to device formats. The reference maps
Rgb8 -> R8G8B8_UNORM, Rgba8 -> B8G8R8A8_UNORM, Rgba32F ->
R32G32B32A32_SFLOAT; here every texture becomes an f32 RGBA numpy
array (normalized for LDR), since device sampling reads SoA float
stacks, not Vulkan formats. RGB8 sources are expanded to RGBA with
alpha=255 exactly like gltf_loader.rs:407-419 ("GPU does not support
RGB8").
"""

from __future__ import annotations

import dataclasses
import enum
import io
import os

import numpy as np

from ...error import HalaRendererError


class ImageFormat(enum.IntEnum):
    R8G8B8A8_UNORM = 0
    R32G32B32A32_SFLOAT = 1


@dataclasses.dataclass
class ImageData:
    width: int
    height: int
    format: ImageFormat
    # Raw pixels: (H, W, 4). uint8 for UNORM, float32 for SFLOAT.
    pixels: np.ndarray
    num_of_mips: int = 1

    def as_float_rgba(self) -> np.ndarray:
        """(H, W, 4) float32 in [0,1] for LDR / linear HDR values."""
        if self.format == ImageFormat.R32G32B32A32_SFLOAT:
            return self.pixels.astype(np.float32)
        return self.pixels.astype(np.float32) / 255.0

    @staticmethod
    def from_array(arr: np.ndarray) -> "ImageData":
        arr = np.asarray(arr)
        if arr.ndim != 3:
            raise HalaRendererError(f"Image array must be HxWxC, got {arr.shape}")
        h, w, c = arr.shape
        if c == 3:  # RGB expand, alpha = max (gltf_loader.rs:407-419 parity)
            if arr.dtype == np.uint8:
                alpha = np.full((h, w, 1), 255, np.uint8)
            else:
                alpha = np.ones((h, w, 1), arr.dtype)
            arr = np.concatenate([arr, alpha], axis=-1)
        if arr.dtype == np.uint8:
            return ImageData(w, h, ImageFormat.R8G8B8A8_UNORM, arr)
        return ImageData(w, h, ImageFormat.R32G32B32A32_SFLOAT, arr.astype(np.float32))

    @staticmethod
    def load(path_or_bytes, mime: str | None = None) -> "ImageData":
        """Decode PNG/JPEG via PIL, or Radiance .hdr via the built-in decoder."""
        if isinstance(path_or_bytes, (str, os.PathLike)):
            path = os.fspath(path_or_bytes)
            with open(path, "rb") as f:
                data = f.read()
            if path.lower().endswith(".hdr"):
                mime = "image/vnd.radiance"
        else:
            data = bytes(path_or_bytes)
        if mime == "image/vnd.radiance" or data[:10] in (b"#?RADIANCE", b"#?RGBE\n\x20\x20\x20"):
            return ImageData.from_array(decode_radiance_hdr(data))
        try:
            from PIL import Image
        except ImportError as e:  # pragma: no cover
            raise HalaRendererError("PIL unavailable for image decode", e)
        img = Image.open(io.BytesIO(data))
        if img.mode not in ("RGB", "RGBA"):
            img = img.convert("RGBA")
        return ImageData.from_array(np.asarray(img))


def decode_radiance_hdr(data: bytes) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) decoder -> (H, W, 3) float32.

    Supports the common -Y H +X W orientation with adaptive RLE scanlines
    (the format emitted by Blender/pbrt). Fills the envmap loading role of
    the reference's `image` crate HDR decode (envmap.rs:57-60).
    """
    stream = io.BytesIO(data)
    line = stream.readline()
    if not line.startswith(b"#?"):
        raise HalaRendererError("Not a Radiance HDR file")
    # header
    while True:
        line = stream.readline()
        if line in (b"\n", b"\r\n", b""):
            break
    dims = stream.readline().split()
    if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
        raise HalaRendererError(f"Unsupported HDR orientation: {dims}")
    height, width = int(dims[1]), int(dims[3])

    rgbe = np.zeros((height, width, 4), np.uint8)
    buf = stream.read()
    pos = 0
    for y in range(height):
        # new-style RLE scanline marker: 0x02 0x02 hi lo
        if (
            width >= 8
            and width < 32768
            and buf[pos] == 2
            and buf[pos + 1] == 2
            and ((buf[pos + 2] << 8) | buf[pos + 3]) == width
        ):
            pos += 4
            row = np.zeros((4, width), np.uint8)
            for ch in range(4):
                x = 0
                while x < width:
                    count = buf[pos]
                    pos += 1
                    if count > 128:  # run
                        row[ch, x : x + count - 128] = buf[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        row[ch, x : x + count] = np.frombuffer(
                            buf, np.uint8, count, pos
                        )
                        pos += count
                        x += count
            rgbe[y] = row.T
        else:  # flat scanline
            row = np.frombuffer(buf, np.uint8, width * 4, pos).reshape(width, 4)
            rgbe[y] = row
            pos += width * 4

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    rgb = rgbe[..., :3].astype(np.float32) * scale[..., None]
    return rgb
