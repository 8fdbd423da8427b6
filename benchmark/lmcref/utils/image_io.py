"""Image I/O: OpenEXR (pure-python reader/writer), LDR via PIL, tonemapping.

Replaces the reference's OpenImageIO dependency (reference src/image.cpp,
vendored oiio/ tree) with a small host-side implementation:
  * EXR scanline files with ZIP/ZIPS/none compression, half/float channels
    (enough for the bundled scenes: sunsky.exr and the committed renders).
  * PNG/JPG via PIL with the same sRGB gamma-2.2 decode the reference's
    BitmapTexture applies to 8-bit images (src/bitmaptexture.h:75-160).
  * A filmic tonemapper standing in for the external `hdrmanip --tonemap
    filmic` the reference shells out to (src/mlt.cpp:188-189).
"""

import struct
import zlib

import numpy as np

_EXR_MAGIC = b'\x76\x2f\x31\x01'
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2


def _parse_exr_header(data):
    pos = 8
    attrs = {}
    while True:
        end = data.index(b'\x00', pos)
        if end == pos:
            pos += 1
            break
        name = data[pos:end].decode('ascii'); pos = end + 1
        end = data.index(b'\x00', pos)
        typ = data[pos:end].decode('ascii'); pos = end + 1
        size = struct.unpack('<i', data[pos:pos + 4])[0]; pos += 4
        attrs[name] = (typ, data[pos:pos + size]); pos += size
    return attrs, pos


def _parse_channels(raw):
    chans = []
    p = 0
    while raw[p] != 0:
        e = raw.index(b'\x00', p)
        name = raw[p:e].decode('ascii'); p = e + 1
        ptype, = struct.unpack('<i', raw[p:p + 4]); p += 16
        chans.append((name, ptype))
    return chans


def _exr_predictor_undo(buf):
    """EXR zip postprocess: delta-decode then de-interleave."""
    arr = np.frombuffer(buf, np.uint8).astype(np.int64)
    arr[1:] -= 128
    arr = np.cumsum(arr, dtype=np.int64) % 256
    arr = arr.astype(np.uint8)
    # de-interleave: first half -> even bytes, second half -> odd bytes
    out = np.empty_like(arr)
    half = (len(arr) + 1) // 2
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out.tobytes()


def _exr_predictor_apply(buf):
    arr = np.frombuffer(buf, np.uint8)
    half = (len(arr) + 1) // 2
    inter = np.empty_like(arr)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    d = inter.astype(np.int64)
    d[1:] = d[1:] - inter[:-1].astype(np.int64) + 128
    d = (d % 256).astype(np.uint8)
    return d.tobytes()


def read_exr(path):
    """Read an RGB EXR file into a float32 [H, W, 3] array."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:4] != _EXR_MAGIC:
        raise ValueError(f'{path}: not an EXR file')
    attrs, pos = _parse_exr_header(data)
    chans = _parse_channels(attrs['channels'][1])
    xmin, ymin, xmax, ymax = struct.unpack('<4i', attrs['dataWindow'][1])
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    comp = attrs['compression'][1][0]
    if comp not in (0, 2, 3):
        raise ValueError(f'{path}: unsupported EXR compression {comp}')
    lines_per_block = {0: 1, 2: 1, 3: 16}[comp]
    nblocks = (height + lines_per_block - 1) // lines_per_block
    # skip line-offset table
    pos += 8 * nblocks

    bpp = {_PT_HALF: 2, _PT_FLOAT: 4, _PT_UINT: 4}
    dtypes = {_PT_HALF: np.float16, _PT_FLOAT: np.float32, _PT_UINT: np.uint32}
    chan_data = {name: np.zeros((height, width), np.float32) for name, _ in chans}
    line_bytes = sum(bpp[pt] for _, pt in chans) * width

    for _ in range(nblocks):
        y, sz = struct.unpack('<ii', data[pos:pos + 8]); pos += 8
        raw = data[pos:pos + sz]; pos += sz
        ny = min(lines_per_block, ymax - y + 1)
        expect = line_bytes * ny
        if comp in (2, 3) and sz < expect:
            raw = _exr_predictor_undo(zlib.decompress(raw))
        buf = np.frombuffer(raw, np.uint8)
        off = 0
        for ly in range(ny):
            for name, pt in chans:  # channels are alphabetical within a scanline
                n = bpp[pt] * width
                vals = buf[off:off + n].view(dtypes[pt]).astype(np.float32)
                chan_data[name][y - ymin + ly] = vals
                off += n

    r = chan_data.get('R')
    g = chan_data.get('G', r)
    b = chan_data.get('B', r)
    if r is None:
        first = next(iter(chan_data.values()))
        r = g = b = first
    return np.stack([r, g, b], -1)


def write_exr(path, img):
    """Write a float32 [H, W, 3] array as a ZIP-compressed scanline EXR."""
    img = np.asarray(img, np.float32)
    height, width, _ = img.shape

    def attr(name, typ, payload):
        return (name.encode() + b'\x00' + typ.encode() + b'\x00'
                + struct.pack('<i', len(payload)) + payload)

    chan = b''
    for name in (b'B', b'G', b'R'):
        chan += name + b'\x00' + struct.pack('<iiii', _PT_FLOAT, 0, 1, 1)
    chan += b'\x00'
    box = struct.pack('<4i', 0, 0, width - 1, height - 1)
    header = _EXR_MAGIC + struct.pack('<i', 2)
    header += attr('channels', 'chlist', chan)
    header += attr('compression', 'compression', b'\x03')
    header += attr('dataWindow', 'box2i', box)
    header += attr('displayWindow', 'box2i', box)
    header += attr('lineOrder', 'lineOrder', b'\x00')
    header += attr('pixelAspectRatio', 'float', struct.pack('<f', 1.0))
    header += attr('screenWindowCenter', 'v2f', struct.pack('<2f', 0, 0))
    header += attr('screenWindowWidth', 'float', struct.pack('<f', 1.0))
    header += b'\x00'

    nblocks = (height + 15) // 16
    blocks = []
    for bi in range(nblocks):
        y0 = bi * 16
        ny = min(16, height - y0)
        rows = []
        for ly in range(ny):
            row = img[y0 + ly]
            for c in (2, 1, 0):  # B, G, R order
                rows.append(row[:, c].astype('<f4').tobytes())
        raw = b''.join(rows)
        comp = zlib.compress(_exr_predictor_apply(raw))
        if len(comp) >= len(raw):
            comp = raw
        blocks.append(struct.pack('<ii', y0, len(comp)) + comp)

    offset_table = b''
    off = len(header) + 8 * nblocks
    for blk in blocks:
        offset_table += struct.pack('<Q', off)
        off += len(blk)
    with open(path, 'wb') as f:
        f.write(header + offset_table + b''.join(blocks))


def read_image(path, gamma_decode=True):
    """Read any supported image into float32 [H, W, 3] linear RGB.

    8-bit images get the gamma-2.2 decode the reference's texture system
    applies (src/bitmaptexture.h GammaDecompress)."""
    p = str(path)
    if p.lower().endswith('.exr'):
        return read_exr(p)
    from PIL import Image
    img = Image.open(p).convert('RGB')
    arr = np.asarray(img, np.float32) / 255.0
    if gamma_decode:
        arr = arr ** 2.2
    return arr


def write_image(path, img):
    p = str(path)
    img = np.asarray(img, np.float32)
    if p.lower().endswith('.exr'):
        write_exr(p, img)
        return
    from PIL import Image
    ldr = np.clip(tonemap_filmic(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(ldr).save(p)


def tonemap_filmic(x):
    """Hejl/Burgess-Dawson filmic curve (as in hdrmanip's filmic mode)."""
    x = np.maximum(np.asarray(x, np.float32) - 0.004, 0.0)
    return (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)


def relmse(img, ref, eps=1e-2):
    """Relative mean-squared error vs a reference image."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.mean((img - ref) ** 2 / (ref ** 2 + eps)))
