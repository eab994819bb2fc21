"""Process set-up and I/O with no accelerator or optional package: the
compile-cache location, the hash-keyed native library, the standard-library
PNG writer, the LDR loader's missing-package error, and the multi-host
combine."""

import hashlib
import os
import struct
import sys
import zlib

import jax
import numpy as np
import pytest

from gnxraytracer.utils import image, runtime


def _decode_png(data):
    """(H, W, 3) uint8 from an 8-bit RGB, filter-0 PNG (what encode_png
    writes), checking every chunk's CRC."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    raw = raw.reshape(h, 1 + 3 * w)
    assert not raw[:, 0].any()  # filter type 0 on every scanline
    return raw[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("tonemap", ["reference", "srgb", "none"])
def test_save_png_roundtrip(tmp_path, tonemap):
    img = np.random.RandomState(3).rand(5, 7, 3).astype(np.float32) * 2.0
    out = image.save_png(str(tmp_path / "x.png"), img, tonemap=tonemap)
    with open(out, "rb") as f:
        got = _decode_png(f.read())
    mapped = {"reference": image.tonemap_reference, "srgb": image.to_srgb,
              "none": lambda x: x}[tonemap](img)
    np.testing.assert_array_equal(got, image.to_uint8(mapped))


def test_ldr_loader_names_missing_package(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError, match="imageio"):
        image.load_image(str(tmp_path / "tex.jpg"))


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_follows_env(monkeypatch, tmp_path,
                                   restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_default_in_repo(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".cache", "jax_cache")
    assert runtime.setup_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_native_library_keyed_on_source_hash():
    """A checkout never loads a binary built from other source: the
    library's file name carries the hash of the tracked C++ source."""
    from gnxraytracer import native

    with open(native._SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = native._so_path()
    assert os.path.basename(so) == f"libgnx_native-{digest}.so"
    assert os.path.dirname(so) == native._BUILD


def test_combine_partials_single_process():
    from gnxraytracer.parallel import multihost

    partial = np.random.RandomState(0).rand(4, 5, 3).astype(np.float32)
    out = multihost.combine_partials(partial, 3.0, 6.0)
    np.testing.assert_allclose(out, partial * 0.5, rtol=1e-6)
