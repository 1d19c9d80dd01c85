"""Volume rendering and LOD tools — the framework's ``vdb_render`` /
``vdb_lod`` (``openvdb/cmd/openvdb_render``, ``openvdb/cmd/openvdb_lod``).

``render_volume`` is an orthographic emission-absorption integrator over a
dense density grid with simple depth cueing — enough to produce the
water-cube-drop frames the reference showcases (``screenshots/grid*_*.png``)
without GL dependencies.  Output formats match ``vdb_render``'s suffix
dispatch: ``.png`` (minimal zlib encoder), ``.ppm`` (binary P6), and
``.exr`` (minimal uncompressed scanline FLOAT OpenEXR) — no imaging
library is needed.

``build_lod`` produces the mean-pooled mip pyramid of ``vdb_lod``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, img: np.ndarray):
    """Write an (H, W) grayscale or (H, W, 3) RGB uint8 PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        color_type, nch = 0, 1
        img = img[..., None]
    else:
        color_type, nch = 2, 3
    h, w = img.shape[:2]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def render_volume(density: np.ndarray, axis: int = 2, absorption=0.1,
                  color=(70, 130, 200), background=(255, 255, 255),
                  scatter: float = 1.5, gain: float = 0.2,
                  cutoff: float = 0.005):
    """Orthographic emission-absorption render of a density grid.

    Integrates transmittance along ``axis`` (front-to-back) with density-
    proportional in-scatter; adds a cheap depth cue so nearer fluid is
    brighter.  The light-model knobs mirror the reference ``vdb_render``
    fog options (``cmd/openvdb_render/main.cc:82-111`` VolumeRender):
    ``absorption`` = -absorb (scalar or per-RGB 3-vector), ``scatter`` =
    -scatter coefficient on the in-scatter term, ``gain`` = -gain light
    multiplier, ``cutoff`` = -cutoff transmittance early-out (voxels
    behind T < cutoff contribute nothing).  Defaults chosen so the
    historical (absorption=0.1) images are unchanged at the default
    scatter/gain (the product scatter*gain*... normalizes to the old
    emission weight).
    Returns an (H, W, 3) uint8 image.
    """
    d = np.moveaxis(np.asarray(density, np.float32), axis, 0)
    nz = d.shape[0]
    absorb = np.broadcast_to(np.asarray(absorption, np.float32), (3,))
    a_lum = float(absorb.mean())
    # emission weight: reference-normalized so scatter=1.5, gain=0.2
    # reproduces the legacy single-knob images exactly
    emis = (scatter * gain) / (1.5 * 0.2)
    acc = np.zeros(d.shape[1:] + (3,), np.float32)
    transmittance = np.ones(d.shape[1:] + (3,), np.float32)
    depth_cue = np.linspace(1.0, 0.55, nz, dtype=np.float32)
    col = np.asarray(color, np.float32)
    bg = np.asarray(background, np.float32)
    for k in range(nz):
        a = 1.0 - np.exp(-absorb[None, None, :] * d[k][..., None])
        live = transmittance.mean(axis=-1, keepdims=True) >= cutoff
        acc += np.where(live, transmittance * a * emis * depth_cue[k], 0.0)
        transmittance *= (1.0 - a)
    img = acc * col + transmittance * bg
    # orient: world +y up -> image row 0 at top
    return np.clip(img, 0, 255).astype(np.uint8).transpose(1, 0, 2)[::-1]


def build_lod(values: np.ndarray, levels: int | None = None):
    """Mean-pooled mip pyramid (``vdb_lod`` analogue).  Pads each level to
    even extents with zeros.  Returns [level0, level1, ...]."""
    out = [np.asarray(values, np.float32)]
    v = out[0]
    while (levels is None and min(v.shape) > 1) or \
          (levels is not None and len(out) <= levels and min(v.shape) > 1):
        pad = [(0, s % 2) for s in v.shape]
        v = np.pad(v, pad)
        v = v.reshape(v.shape[0] // 2, 2, v.shape[1] // 2, 2,
                      v.shape[2] // 2, 2).mean(axis=(1, 3, 5))
        out.append(v)
        if levels is not None and len(out) > levels:
            break
    return out


def write_ppm(path: str, img: np.ndarray):
    """Binary P6 PPM, as ``vdb_render``'s ``.ppm`` path writes
    (``openvdb/cmd/openvdb_render/main.cc:405-408``)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def write_exr(path: str, img: np.ndarray):
    """Minimal OpenEXR 2.0 writer: single-part scanline, FLOAT channels,
    no compression — the format ``vdb_render`` emits for ``.exr`` targets
    (``openvdb/cmd/openvdb_render/main.cc:410``), readable by any EXR
    consumer.  ``img``: (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA;
    uint8 inputs are mapped to [0, 1] floats.
    """
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = img.astype("<f4")
    if img.ndim == 2:
        img = img[..., None]
    h, w, nch = img.shape
    names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}[nch]

    def attr(name: bytes, typ: bytes, payload: bytes) -> bytes:
        return (name + b"\0" + typ + b"\0"
                + struct.pack("<i", len(payload)) + payload)

    # channel list: sorted by name, each {name, pixel_type=2 (FLOAT),
    # pLinear, reserved[3], xSampling, ySampling}
    order = sorted(range(nch), key=lambda i: names[i])
    chl = b"".join(names[i].encode() + b"\0"
                   + struct.pack("<i4B2i", 2, 0, 0, 0, 0, 1, 1)
                   for i in order) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (attr(b"channels", b"chlist", chl)
              + attr(b"compression", b"compression", b"\0")      # NONE
              + attr(b"dataWindow", b"box2i", box)
              + attr(b"displayWindow", b"box2i", box)
              + attr(b"lineOrder", b"lineOrder", b"\0")          # INCREASING_Y
              + attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
              + attr(b"screenWindowCenter", b"v2f",
                     struct.pack("<2f", 0.0, 0.0))
              + attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
              + b"\0")
    magic = struct.pack("<i", 20000630) + struct.pack("<i", 2)   # version 2
    line_bytes = 8 + w * 4 * nch          # y + size + pixel data
    table_pos = len(magic) + len(header)
    data_pos = table_pos + 8 * h
    offsets = b"".join(struct.pack("<Q", data_pos + y * line_bytes)
                       for y in range(h))
    with open(path, "wb") as f:
        f.write(magic + header + offsets)
        for y in range(h):
            f.write(struct.pack("<2i", y, w * 4 * nch))
            for i in order:                       # per-channel planar rows
                f.write(img[y, :, i].tobytes())


def read_exr(path: str):
    """Read back files produced by ``write_exr`` (uncompressed scanline
    FLOAT) — test oracle and a convenience for pipelines without an EXR
    library."""
    with open(path, "rb") as f:
        buf = f.read()
    assert struct.unpack("<i", buf[:4])[0] == 20000630, "not an EXR"
    pos = 8
    channels, width, height = [], None, None
    while buf[pos] != 0:
        e = buf.index(b"\0", pos); name = buf[pos:e].decode(); pos = e + 1
        e = buf.index(b"\0", pos); typ = buf[pos:e].decode(); pos = e + 1
        (sz,) = struct.unpack_from("<i", buf, pos); pos += 4
        payload = buf[pos:pos + sz]; pos += sz
        if name == "channels":
            q = 0
            while payload[q] != 0:
                ce = payload.index(b"\0", q)
                cname = payload[q:ce].decode()
                ptype = struct.unpack_from("<i", payload, ce + 1)[0]
                assert ptype == 2, "only FLOAT channels supported"
                channels.append(cname)
                q = ce + 1 + 16
        elif name == "dataWindow":
            x0, y0, x1, y1 = struct.unpack("<4i", payload)
            width, height = x1 - x0 + 1, y1 - y0 + 1
        elif name == "compression":
            assert payload[0] == 0, "only uncompressed supported"
    pos += 1                                   # header terminator
    pos += 8 * height                          # offset table
    out = np.empty((height, width, len(channels)), np.float32)
    for _ in range(height):
        y, sz = struct.unpack_from("<2i", buf, pos); pos += 8
        row = np.frombuffer(buf, "<f4", width * len(channels), pos)
        out[y] = row.reshape(len(channels), width).T
        pos += sz
    # reorder sorted-channel planes back to R,G,B(,A) / Y
    srt = sorted(channels)
    want = [c for c in ("R", "G", "B", "A", "Y") if c in channels]
    idx = [srt.index(c) for c in want]
    return out[..., idx], want


def write_image(path: str, img: np.ndarray):
    """Extension-dispatched image writer: .png / .ppm / .exr, matching
    ``vdb_render``'s output selection by file suffix."""
    low = path.lower()
    if low.endswith(".ppm"):
        write_ppm(path, img)
    elif low.endswith(".exr"):
        write_exr(path, img)
    else:
        write_png(path, img)
