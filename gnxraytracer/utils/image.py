"""Image IO and tonemapping.

The reference keeps an in-loop tonemap inside its FrameBuffer
(/root/reference/ui/FrameBuffer.h:137-149) — a running average followed by
exposure mapping 1-exp(-v/(1-0.75)) to 8-bit.  Here the film stays linear
HDR (correct for parity/gradients); tonemapping happens only at export,
replicating the reference curve for visual comparison.
"""

import struct
import zlib

import numpy as np


def tonemap_reference(img):
    """The reference exposure curve: 1 - exp(-v / (1 - 0.75))
    (ui/FrameBuffer.h:142-147)."""
    return 1.0 - np.exp(-np.asarray(img) / 0.25)


def to_srgb(img):
    x = np.clip(np.asarray(img), 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x, 1.055 * x ** (1 / 2.4) - 0.055)


def to_uint8(img):
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def encode_png(arr):
    """8-bit RGB (H,W,3) -> PNG bytes, with the standard library only."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, _ = arr.shape

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    # every scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)],
                         axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def save_png(path, img, tonemap="reference"):
    """Save linear HDR (H,W,3) to PNG.  tonemap: reference | srgb | none."""
    if tonemap == "reference":
        img = tonemap_reference(img)
    elif tonemap == "srgb":
        img = to_srgb(img)
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(img)))
    return path


def load_hdr(path):
    """Radiance RGBE (.hdr) decoder -> float32 (H,W,3) linear radiance.

    Written from the public RGBE spec (the reference uses stb_image's
    stbi_loadf for the same format).  Handles new-style RLE scanlines and
    flat data.
    """
    with open(path, "rb") as f:
        data = f.read()
    # header ends at the first blank line
    pos = 0
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    # resolution line, e.g. "-Y 500 +X 1000"
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    height = int(res[1])
    width = int(res[3])
    body = np.frombuffer(data, np.uint8, offset=pos)

    rgbe = np.zeros((height, width, 4), np.uint8)
    if width < 8 or width > 0x7FFF or body[0] != 2 or body[1] != 2:
        # flat (non-RLE) data
        rgbe = body[: height * width * 4].reshape(height, width, 4)
    else:
        off = 0
        for y in range(height):
            assert body[off] == 2 and body[off + 1] == 2
            off += 4  # 0x02 0x02 + 2-byte width
            for c in range(4):
                x = 0
                while x < width:
                    count = int(body[off])
                    off += 1
                    if count > 128:  # run
                        rgbe[y, x: x + count - 128, c] = body[off]
                        off += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x: x + count, c] = body[off: off + count]
                        off += count
                        x += count
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def load_image(path, gamma=True, flip_v=False):
    """Load LDR/HDR image as float32 (H,W,3) linear.

    LDR images are gamma-decoded like the reference ImageTexture
    (textures/ImageTexture.h gamma convert); HDR (.hdr) decoded by our
    RGBE reader (imageio tone-maps .hdr to uint8, losing radiance).
    """
    if path.lower().endswith(".hdr"):
        arr = load_hdr(path)
        if flip_v:
            arr = arr[::-1]
        return arr
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError(f"loading the LDR image {path} needs the imageio "
                          "package, which is not installed") from e

    arr = np.asarray(imageio.imread(path)).astype(np.float32)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    arr = arr[..., :3]
    arr = arr / 255.0
    if gamma:
        arr = np.where(arr <= 0.04045, arr / 12.92, ((arr + 0.055) / 1.055) ** 2.4)
    if flip_v:
        arr = arr[::-1]
    return arr
