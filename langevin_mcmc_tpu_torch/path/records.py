"""Fixed-shape path records (port of path/records.py).

A path is a dataclass of [C, ...] tensors padded to max_depth D; its
(camDepth s, lightDepth t) tags are per-lane integers.

PSS layout, dim = 2 * pathLength with pathLength = s + t - 1:
  t >= 2 :  [lgt rndPos(2), lgt rndDir(2), lgt bsdfRnd x (t-2)] ++ cam part
  s >= 2 :  cam part = [screenPos(2), cam bsdfRnd x (s-2),
                        directLightRnd(2) if t == 1]
  s == 1 :  the light part only.
"""

import dataclasses
import functools

import numpy as np
import torch

from ..utils import vecmath as vm


@dataclasses.dataclass
class PathRecord:
    time: torch.Tensor          # [C]
    lgt_light_id: torch.Tensor  # [C] int32
    lgt_lprim: torch.Tensor     # [C] int32 (global tri id)
    lgt_rnd_pos: torch.Tensor   # [C,2]
    lgt_rnd_dir: torch.Tensor   # [C,2]
    screen_pos: torch.Tensor    # [C,2]
    cam_tri: torch.Tensor       # [C,D] int32, -1 = no hit
    cam_bsdf_rnd: torch.Tensor  # [C,D,2]
    cam_bsdf_disc: torch.Tensor  # [C,D]
    cam_use_abs: torch.Tensor   # [C,D] bool
    cam_rr: torch.Tensor        # [C,D]
    cam_nee_light: torch.Tensor  # [C,D] int32
    cam_nee_lprim: torch.Tensor  # [C,D] int32
    cam_nee_rnd: torch.Tensor   # [C,D,2]
    lgt_tri: torch.Tensor       # [C,D] int32
    lgt_bsdf_rnd: torch.Tensor  # [C,D,2]
    lgt_bsdf_disc: torch.Tensor  # [C,D]
    lgt_use_abs: torch.Tensor   # [C,D] bool
    lgt_rr: torch.Tensor        # [C,D]
    env_lprim: torch.Tensor     # [C] int32, -1 if none
    cam_depth: torch.Tensor     # [C] int32 (s)
    lgt_depth: torch.Tensor     # [C] int32 (t)

    @property
    def max_depth(self):
        return self.cam_tri.shape[-1]


def empty_record(C, D, device):
    f = lambda *s: torch.zeros((C,) + s, device=device)
    i = lambda *s: torch.full((C,) + s, -1, dtype=torch.int32, device=device)
    b = lambda *s: torch.zeros((C,) + s, dtype=torch.bool, device=device)
    return PathRecord(
        time=f(), lgt_light_id=i(), lgt_lprim=i(),
        lgt_rnd_pos=f(2), lgt_rnd_dir=f(2), screen_pos=f(2),
        cam_tri=i(D), cam_bsdf_rnd=f(D, 2), cam_bsdf_disc=f(D),
        cam_use_abs=b(D), cam_rr=torch.ones((C, D), device=device),
        cam_nee_light=i(D), cam_nee_lprim=i(D), cam_nee_rnd=f(D, 2),
        lgt_tri=i(D), lgt_bsdf_rnd=f(D, 2), lgt_bsdf_disc=f(D),
        lgt_use_abs=b(D), lgt_rr=torch.ones((C, D), device=device),
        env_lprim=i(), cam_depth=i(), lgt_depth=i())


@dataclasses.dataclass
class Contribs:
    """Dense (s,t)-indexed contribution grid of one generated path.

    cam-side slots [C, D, D+2]: [c, k] is found at camera depth c with
    k = 0 -> (c+2, 0) hit light, k = 1 -> (c+2, 1) NEE, k = 2+l -> (c+2, 2+l)
    connection to light vertex l. lgt-side slots [C, D]: [l] is (1, 2+l)
    connect-to-camera."""
    screen_pos: torch.Tensor   # [C,D,D+2,2]
    contrib: torch.Tensor      # [C,D,D+2,3]
    ls_score: torch.Tensor     # [C,D,D+2]
    ss_score: torch.Tensor
    mis_weight: torch.Tensor
    l_screen_pos: torch.Tensor  # [C,D,2]
    l_contrib: torch.Tensor     # [C,D,3]
    l_ls_score: torch.Tensor    # [C,D]
    l_ss_score: torch.Tensor
    l_mis_weight: torch.Tensor

    @property
    def max_depth(self):
        return self.l_ls_score.shape[-1]

    def flatten(self):
        """Per-slot arrays [C, NSLOT] of the structurally reachable slots
        (s + t - 1 <= D), plus the static (s_tags, t_tags)."""
        D = self.max_depth
        C = self.ls_score.shape[0]
        _, _, s_tags, t_tags = _slot_tables(D)
        cs, lsel, _, _ = slot_tables_on(D, self.ls_score.device)

        def flat(cam, lgt, vec=0):
            cshape = (C, D * (D + 2)) + ((vec,) if vec else ())
            return torch.cat([cam.reshape(cshape)[:, cs], lgt[:, lsel]], 1)

        return dict(
            screen_pos=flat(self.screen_pos, self.l_screen_pos, 2),
            contrib=flat(self.contrib, self.l_contrib, 3),
            ls_score=flat(self.ls_score, self.l_ls_score),
            ss_score=flat(self.ss_score, self.l_ss_score),
            mis_weight=flat(self.mis_weight, self.l_mis_weight),
        ), s_tags, t_tags


def _slot_tables(D):
    """Static flatten tables: reachable cam/lgt slot indices + (s,t) tags."""
    c_idx, k_idx = np.meshgrid(np.arange(D), np.arange(D + 2), indexing='ij')
    s_cam = (c_idx + 2).reshape(-1)
    t_cam = np.where(k_idx == 0, 0, np.where(k_idx == 1, 1, k_idx)).reshape(-1)
    cam_sel = np.nonzero((s_cam + t_cam - 1) <= D)[0].astype(np.int32)
    t_lgt = np.arange(D) + 2
    lgt_sel = np.nonzero((1 + t_lgt - 1) <= D)[0].astype(np.int32)
    s_tags = np.concatenate([s_cam[cam_sel], np.ones(len(lgt_sel), np.int64)])
    t_tags = np.concatenate([t_cam[cam_sel], t_lgt[lgt_sel]])
    return cam_sel, lgt_sel, s_tags.astype(np.int32), t_tags.astype(np.int32)


@functools.lru_cache(maxsize=None)
def slot_tables_on(D, device):
    """_slot_tables(D) on device, made once a (D, device): (cam_sel,
    lgt_sel) int64, (s_tags, t_tags) int32. A captured chain step copies
    nothing from the host."""
    cam_sel, lgt_sel, s_tags, t_tags = _slot_tables(D)
    on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return (on(cam_sel, torch.int64), on(lgt_sel, torch.int64),
            on(s_tags, torch.int32), on(t_tags, torch.int32))


def empty_contribs(C, D, device):
    f = lambda *s: torch.zeros((C,) + s, device=device)
    return Contribs(
        screen_pos=f(D, D + 2, 2), contrib=f(D, D + 2, 3),
        ls_score=f(D, D + 2), ss_score=f(D, D + 2), mis_weight=f(D, D + 2),
        l_screen_pos=f(D, 2), l_contrib=f(D, 3), l_ls_score=f(D),
        l_ss_score=f(D), l_mis_weight=f(D))


# ---------------------------------------------------------------------------
# PSS <-> record mapping
# ---------------------------------------------------------------------------

def pss_dim(record):
    return 2 * (record.cam_depth + record.lgt_depth - 1)


def _slot_layout(record):
    s = record.cam_depth
    t = record.lgt_depth
    has_lgt = t >= 2
    lgt_len = torch.clamp(t - 2, min=0)
    cam_base = torch.where(has_lgt, 4 + 2 * lgt_len, torch.zeros_like(t))
    has_screen = s >= 2
    cam_len = torch.clamp(s - 2, min=0)
    nee_off = cam_base + 2 + 2 * cam_len
    return dict(has_lgt=has_lgt, lgt_len=lgt_len, cam_base=cam_base,
                has_screen=has_screen, cam_len=cam_len, nee_off=nee_off,
                has_nee=(t == 1), s=s, t=t)


def _pss_slots(record):
    """Every PSS slot of the layout as (offset index [C,G], valid [C,G],
    record value [C,G]) in the JAX registration order."""
    D = record.max_depth
    lay = _slot_layout(record)
    C = record.time.shape[0]
    dev = record.time.device
    full = lambda v: torch.full((C,), v, dtype=torch.int64, device=dev)
    idx, val, x = [], [], []

    def put(i, valid, value):
        idx.append(i.long())
        val.append(torch.broadcast_to(valid, (C,)))
        x.append(value)

    for k in range(2):
        put(full(k), lay['has_lgt'], record.lgt_rnd_pos[:, k])
    for k in range(2):
        put(full(2 + k), lay['has_lgt'], record.lgt_rnd_dir[:, k])
    for i in range(D):
        for k in range(2):
            put(full(4 + 2 * i + k), lay['has_lgt'] & (i < lay['lgt_len']),
                record.lgt_bsdf_rnd[:, i, k])
    for k in range(2):
        put(lay['cam_base'] + k, lay['has_screen'], record.screen_pos[:, k])
    for i in range(D):
        for k in range(2):
            put(lay['cam_base'] + 2 + 2 * i + k,
                lay['has_screen'] & (i < lay['cam_len']),
                record.cam_bsdf_rnd[:, i, k])
    nee_idx = torch.clamp(lay['s'] - 2, 0, D - 1).long()
    nee_rnd = record.cam_nee_rnd[torch.arange(C, device=dev), nee_idx]
    for k in range(2):
        put(lay['nee_off'] + k, lay['has_nee'] & lay['has_screen'],
            nee_rnd[:, k])
    return (torch.stack(idx, 1), torch.stack(val, 1), torch.stack(x, 1),
            lay, nee_idx)


def get_path_pss(record, max_dim):
    """Record -> padded PSS vector [C, max_dim]."""
    idx, valid, x, _, _ = _pss_slots(record)
    C = idx.shape[0]
    # valid slots never collide; invalid ones go to a scratch column
    tgt = torch.where(valid, torch.clamp(idx, 0, max_dim - 1),
                      torch.full_like(idx, max_dim))
    pss = torch.zeros((C, max_dim + 1), device=x.device, dtype=x.dtype)
    pss.scatter_(1, tgt, torch.where(valid, x, torch.zeros_like(x)))
    return pss[:, :max_dim]


def apply_pss_offset(record, offset):
    """Perturb the record's PSS by `offset` [C, max_dim] (modulo 1); slots
    beyond the path's dim are ignored. Plain gathers from the offset."""
    D = record.max_depth
    max_dim = offset.shape[-1]
    idx, valid, _, lay, nee_idx = _pss_slots(record)
    vals = torch.gather(offset, 1, torch.clamp(idx, 0, max_dim - 1))
    vals = torch.where(valid, vals, torch.zeros_like(vals))
    C = vals.shape[0]
    g = 0

    def take(n):
        nonlocal g
        out = vals[:, g:g + n]
        g += n
        return out

    new_lgt_pos = vm.modulo(record.lgt_rnd_pos + take(2), 1.0)
    new_lgt_dir = vm.modulo(record.lgt_rnd_dir + take(2), 1.0)
    new_lgt_bsdf = vm.modulo(record.lgt_bsdf_rnd + take(2 * D).reshape(C, D, 2),
                             1.0)
    new_screen = vm.modulo(record.screen_pos + take(2), 1.0)
    new_cam_bsdf = vm.modulo(record.cam_bsdf_rnd + take(2 * D).reshape(C, D, 2),
                             1.0)
    nee_off = take(2)
    sel = (torch.arange(D, device=offset.device) == nee_idx[:, None])[..., None]
    new_nee = vm.modulo(record.cam_nee_rnd
                        + torch.where(sel, nee_off[:, None, :],
                                      torch.zeros_like(record.cam_nee_rnd)),
                        1.0)
    return dataclasses.replace(
        record, lgt_rnd_pos=new_lgt_pos, lgt_rnd_dir=new_lgt_dir,
        lgt_bsdf_rnd=new_lgt_bsdf, screen_pos=new_screen,
        cam_bsdf_rnd=new_cam_bsdf, cam_nee_rnd=new_nee)


def to_subpath(record, s, t):
    """Tag the record with its chosen (s,t); the env hit clears when t != 0."""
    s = torch.as_tensor(s, dtype=torch.int32, device=record.time.device)
    t = torch.as_tensor(t, dtype=torch.int32, device=record.time.device)
    return dataclasses.replace(
        record, cam_depth=torch.broadcast_to(s, record.time.shape).clone(),
        lgt_depth=torch.broadcast_to(t, record.time.shape).clone(),
        env_lprim=torch.where(t != 0, torch.full_like(record.env_lprim, -1),
                              record.env_lprim))
