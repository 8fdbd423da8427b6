"""Bitmap textures as one flat atlas (port of scene/textures.py).

Every texel's 2x2 bilinear neighbourhood, with its texture's own periodic
wrap, is packed into one 12-float row, so a lookup is one row gather.
Texture i's rows start at ``offset[i]``: the JAX package's flat layout,
with the offsets kept as int32 (the JAX package stores them in an f32
column that is exact only below 2**24 rows). 8-bit sources get the
gamma-2.2 decode after interpolation.
"""

import dataclasses

import numpy as np
import torch

from ..utils import image_io


@dataclasses.dataclass
class TexturePack:
    """Device-side atlas of all bitmap textures of a scene."""
    neigh: torch.Tensor    # [T, 12] (v00, v10, v01, v11) rows, all textures
    offset: torch.Tensor   # [N] int32 first row of each texture
    size: torch.Tensor     # [N, 2] int32 (h, w)
    gamma: torch.Tensor    # [N]
    uvscale: torch.Tensor  # [N, 2]

    @property
    def count(self):
        return self.size.shape[0]


def _pack_neighborhoods(data, size):
    """[N, H, W, 12] of (v00, v10, v01, v11) with per-texture wrap."""
    data = np.asarray(data)
    N, H, W, _ = data.shape
    out = np.zeros((N, H, W, 12), np.float32)
    for i in range(N):
        h, w = int(size[i][0]), int(size[i][1])
        im = data[i, :h, :w]
        xr = (np.arange(w) + 1) % w
        yr = (np.arange(h) + 1) % h
        out[i, :h, :w, 0:3] = im
        out[i, :h, :w, 3:6] = im[:, xr]
        out[i, :h, :w, 6:9] = im[yr]
        out[i, :h, :w, 9:12] = im[yr][:, xr]
    return out


def _flatten_neigh(neigh_padded, size):
    """[N, Hmax, Wmax, 12] -> ([T, 12], int32 row offsets [N])."""
    texels = [int(h) * int(w) for h, w in size]
    if sum(texels) >= 2 ** 31:
        raise ValueError(f'texture atlas of {sum(texels)} texels: int32 row '
                         f'offsets hold at most 2**31 - 1')
    rows = [neigh_padded[i, :int(h), :int(w)].reshape(-1, 12)
            for i, (h, w) in enumerate(size)]
    offset = np.concatenate([[0], np.cumsum(texels)[:-1]]).astype(np.int32)
    return np.concatenate(rows, 0), offset


class TextureBuilder:
    """Host-side accumulation of scene textures."""

    def __init__(self):
        self.images = []
        self.gammas = []
        self.uvscales = []
        self.avgs = []
        self._cache = {}

    def add_bitmap(self, filename, uvscale=(1.0, 1.0)):
        key = (str(filename), tuple(uvscale))
        if key in self._cache:
            return self._cache[key]
        p = str(filename)
        is_ldr = not p.lower().endswith(('.exr', '.hdr', '.pfm'))
        # raw values; the gamma decode follows the bilinear interpolation
        raw = image_io.read_image(p, gamma_decode=False)
        gamma = 2.2 if is_ldr else 1.0
        tid = len(self.images)
        self.images.append(raw)
        self.gammas.append(gamma)
        self.uvscales.append(tuple(uvscale))
        self.avgs.append(np.mean(raw.reshape(-1, 3) ** gamma, 0))
        self._cache[key] = tid
        return tid

    def avg(self, tid):
        return self.avgs[tid]

    def host_arrays(self):
        """dict(neigh [T,12], offset [N] int32, size [N,2] int32, gamma
        [N], uvscale [N,2]); one dummy 1x1 texture when there is none, as
        in the JAX package."""
        images = self.images or [np.zeros((1, 1, 3), np.float32)]
        gammas = self.gammas or [1.0]
        uvscales = self.uvscales or [(1.0, 1.0)]
        hmax = max(im.shape[0] for im in images)
        wmax = max(im.shape[1] for im in images)
        data = np.zeros((len(images), hmax, wmax, 3), np.float32)
        size = np.zeros((len(images), 2), np.int32)
        for i, im in enumerate(images):
            data[i, :im.shape[0], :im.shape[1]] = im
            size[i] = im.shape[:2]
        neigh, offset = _flatten_neigh(_pack_neighborhoods(data, size), size)
        return dict(neigh=neigh, offset=offset, size=size,
                    gamma=np.asarray(gammas, np.float32),
                    uvscale=np.asarray(uvscales, np.float32))


def texture_pack(host, device, dtype=torch.float32):
    """TexturePack on `device` from TextureBuilder.host_arrays(), its
    float tables in `dtype`."""
    t = lambda k, dt: torch.as_tensor(np.array(host[k], dt), device=device)
    return TexturePack(neigh=t('neigh', np.float32).to(dtype),
                       offset=t('offset', np.int32),
                       size=t('size', np.int32),
                       gamma=t('gamma', np.float32).to(dtype),
                       uvscale=t('uvscale', np.float32).to(dtype))


def eval_texture(pack: TexturePack, tex_id, st):
    """Bilinear periodic lookup; tex_id [...] int32, st [..., 2] ->
    [..., 3]. tex_id < 0 gives 1.0 (the caller multiplies by its constant
    value). Texel centres at (i + 0.5), the finest level only, periodic
    wrap, then pow(gamma) on the interpolated value."""
    tid = torch.clamp(tex_id, min=0).long()
    h = pack.size[tid, 0]
    w = pack.size[tid, 1]
    uvs = pack.uvscale[tid]
    s = st[..., 0] * uvs[..., 0]
    t = st[..., 1] * uvs[..., 1]
    x = s * w.to(s.dtype) - 0.5
    y = t * h.to(t.dtype) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    wi = torch.clamp(w, min=1)
    hi = torch.clamp(h, min=1)
    x0i = torch.remainder(x0.to(torch.int32), wi)
    y0i = torch.remainder(y0.to(torch.int32), hi)
    nb = pack.neigh[(pack.offset[tid] + y0i * wi + x0i).long()]
    v00 = nb[..., 0:3]
    v10 = nb[..., 3:6]
    v01 = nb[..., 6:9]
    v11 = nb[..., 9:12]
    val = (v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy)
           + v01 * (1 - fx) * fy + v11 * fx * fy)
    val = torch.pow(torch.clamp(val, min=0.0), pack.gamma[tid][..., None])
    return torch.where((tex_id < 0)[..., None], torch.ones_like(val), val)
