"""Film accumulation (port of ops/film.py): nearest-pixel box-filter splats
as one ``index_add_`` on the flat film (of one [H, W, 3] film, or of a
stack of per-shard partial films [S, H, W, 3])."""

import torch


def splat(buffer, screen_pos, contrib, mask=None, shard_idx=None):
    """Add contribs [...,3] at screen_pos [...,2] (in [0,1)) into the film
    buffer [H,W,3] in place and return it. Non-finite contributions (and
    those outside mask) are dropped. With shard_idx (int [...], one film
    shard per point) the buffer is [S,H,W,3] and each point lands in its
    shard."""
    h, w = buffer.shape[-3], buffer.shape[-2]
    ix = torch.clamp((screen_pos[..., 0] * w).to(torch.int64), 0, w - 1)
    iy = torch.clamp((screen_pos[..., 1] * h).to(torch.int64), 0, h - 1)
    finite = torch.isfinite(contrib).all(-1)
    if mask is not None:
        finite &= mask
    contrib = torch.where(finite[..., None], contrib,
                          torch.zeros_like(contrib))
    idx = iy * w + ix
    if buffer.ndim == 4:
        if shard_idx is None:
            raise ValueError('a [S, H, W, 3] film needs shard_idx')
        idx = idx + shard_idx.to(torch.int64) * (h * w)
    buffer.view(-1, 3).index_add_(0, idx.reshape(-1), contrib.reshape(-1, 3))
    return buffer
