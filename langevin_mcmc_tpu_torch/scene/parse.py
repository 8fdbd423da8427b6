"""Mitsuba-0.5-style scene XML parser (port of scene/parse.py).

Supports the ported configuration: perspective sensor + hdrfilm, static
``obj`` / ``serialized`` shapes, ``diffuse`` / ``phong`` (optionally
``twosided``) BSDFs with constant reflectances, ``area`` emitters and the
``<dpt>`` options block. Everything else the JAX parser reads raises
``NotImplementedError`` naming the feature.
"""

import os
import re
import xml.etree.ElementTree as ET

import numpy as np

from . import transforms as T
from .camera import camera_arrays
from .mesh import load_obj, load_serialized
from .scenedata import BSDF_LAMBERTIAN, BSDF_PHONG, LIGHT_AREA, build_scene
from ..options import Options


def _parse_vec3(value):
    parts = [p for p in re.split(r'[, ]+', value.strip()) if p]
    if len(parts) == 1:
        v = float(parts[0])
        return np.array([v, v, v], np.float64)
    return np.array([float(p) for p in parts[:3]], np.float64)


def _parse_transform(node):
    """Accumulate child transforms left-multiplied."""
    m = np.eye(4)
    for child in node:
        tag = child.tag.lower()
        if tag == 'scale':
            if child.get('value') is not None:
                s = float(child.get('value'))
                m = T.scale([s, s, s]) @ m
            else:
                m = T.scale([float(child.get('x', 1.0)),
                             float(child.get('y', 1.0)),
                             float(child.get('z', 1.0))]) @ m
        elif tag == 'translate':
            m = T.translate([float(child.get('x', 0.0)),
                             float(child.get('y', 0.0)),
                             float(child.get('z', 0.0))]) @ m
        elif tag == 'rotate':
            axis = [float(child.get('x', 0.0)), float(child.get('y', 0.0)),
                    float(child.get('z', 0.0))]
            m = T.rotate(float(child.get('angle', 0.0)), axis) @ m
        elif tag == 'lookat':
            m = T.look_at(_parse_vec3(child.get('origin')),
                          _parse_vec3(child.get('target')),
                          _parse_vec3(child.get('up'))) @ m
        elif tag == 'matrix':
            vals = [float(x) for x in
                    re.split(r'[, ]+', child.get('value').strip()) if x]
            m = np.array(vals).reshape(4, 4) @ m
    return m


class _BSDFSpec:
    def __init__(self):
        self.type = BSDF_LAMBERTIAN
        self.twosided = False
        self.kd = np.array([0.5, 0.5, 0.5])
        self.ks = np.array([0.2, 0.2, 0.2])
        self.exponent = 30.0
        self.ks_weight = 0.0


def _lum(v):
    return 0.212671 * v[0] + 0.715160 * v[1] + 0.072169 * v[2]


def _parse_value(node):
    if node.tag in ('texture', 'ref'):
        raise NotImplementedError('bitmap textures are not ported yet')
    return _parse_vec3(node.get('value'))


def _parse_bsdf(node, twosided=False):
    btype = node.get('type')
    spec = _BSDFSpec()
    spec.twosided = twosided
    if btype == 'twosided':
        for child in node:
            if child.tag == 'bsdf':
                return _parse_bsdf(child, True)
        raise ValueError('twosided without nested bsdf')
    if btype == 'diffuse':
        spec.type = BSDF_LAMBERTIAN
        for child in node:
            if child.get('name') == 'reflectance' or child.tag in ('texture',
                                                                   'ref'):
                spec.kd = _parse_value(child)
    elif btype == 'phong':
        spec.type = BSDF_PHONG
        for child in node:
            name = child.get('name')
            if name == 'diffuseReflectance':
                spec.kd = _parse_value(child)
            elif name == 'specularReflectance':
                spec.ks = _parse_value(child)
            elif name == 'exponent':
                spec.exponent = float(_parse_value(child)[0])
        s = _lum(spec.kd) + _lum(spec.ks)
        spec.ks_weight = _lum(spec.ks) / s if s > 0 else 0.0
    elif btype == 'roughdielectric':
        raise NotImplementedError('roughdielectric BSDF is not ported yet')
    else:
        raise ValueError(f'unknown bsdf type {btype}')
    return spec


def _parse_shape_transform(node):
    m = np.eye(4)
    for child in node:
        if child.get('name') == 'toWorld':
            if child.tag == 'animation':
                raise NotImplementedError('moving geometry is not ported yet')
            if child.tag == 'transform':
                m = _parse_transform(child)
    return m


_UNPORTED_OPTIONS = {
    'largestepmultiplexed': 'multiplexed large steps',
    'samplecache': 'cache-seeded large steps',
    'uselightcoordinatesampling': 'light-coordinate sampling'}


def _parse_options(node):
    keymap = {
        'integrator': ('integrator', str), 'spp': ('spp', int),
        'bidirectional': ('bidirectional', None),
        'numinitsamples': ('num_init_samples', int),
        'largestepprob': ('large_step_probability', float),
        'largestepscale': ('large_step_prob_scale', float),
        'mindepth': ('min_depth', int), 'maxdepth': ('max_depth', int),
        'directspp': ('direct_spp', int),
        'perturbstddev': ('perturb_std_dev', float),
        'roughnessthreshold': ('roughness_threshold', float),
        'uniformmixprob': ('uniform_mixing_probability', float),
        'numchains': ('num_chains', int), 'seedoffset': ('seed_offset', int),
        'reportintervalspp': ('report_interval_spp', int),
        'mala': ('mala', None), 'h2mc': ('h2mc', None),
        'mala-stepsize': ('mala_stepsize', float),
        'mala-gn': ('mala_gn', float),
    }
    kw = {}
    for child in node:
        name = child.get('name')
        val = child.get('value')
        if name in _UNPORTED_OPTIONS:
            if val == 'true':
                raise NotImplementedError(
                    f'{_UNPORTED_OPTIONS[name]} is not ported yet')
            continue
        if name not in keymap:
            continue
        field, conv = keymap[name]
        kw[field] = (val == 'true') if conv is None else conv(val)
    opts = Options().replace(**kw)
    if opts.integrator == 'mcmc' and not (opts.mala or opts.h2mc):
        raise NotImplementedError('isotropic-only small steps (neither MALA '
                                  'nor H2MC) are not ported yet')
    return opts


def parse_scene_host(filename, film_wh=None):
    """Parse a scene XML file into host arrays.
    Returns (host dict, Options, output_name)."""
    scene_dir = os.path.dirname(os.path.abspath(filename))
    root = ET.parse(filename).getroot()
    options = Options()
    cam = None
    output_name = 'image'
    bsdf_map = {}
    meshes, mesh_mats, mesh_lights, mat_specs, lights = [], [], [], [], []

    def add_mat(spec):
        mat_specs.append(spec)
        return len(mat_specs) - 1

    for child in root:
        tag = child.tag
        if tag == 'dpt':
            options = _parse_options(child)
        elif tag == 'sensor':
            fov = 45.0
            near_clip, far_clip = 1e-2, 1000.0
            to_world = T.AnimatedTransform(np.eye(4))
            width = height = 512
            for c in child:
                name = c.get('name')
                if name == 'nearClip':
                    near_clip = float(c.get('value'))
                elif name == 'farClip':
                    far_clip = float(c.get('value'))
                elif name == 'fov':
                    fov = float(c.get('value'))
                elif name == 'toWorld':
                    if c.tag == 'animation':
                        raise NotImplementedError(
                            'camera motion is not ported yet')
                    to_world = T.AnimatedTransform(_parse_transform(c))
                elif c.tag == 'film':
                    for g in c:
                        gname = g.get('name')
                        if gname == 'width':
                            width = int(g.get('value'))
                        elif gname == 'height':
                            height = int(g.get('value'))
                        elif gname == 'filename':
                            output_name = g.get('value')
            if film_wh is not None:
                width, height = film_wh
            cam = camera_arrays(to_world, fov, width, height, near_clip,
                                far_clip)
        elif tag == 'bsdf':
            bsdf_map[child.get('id')] = add_mat(_parse_bsdf(child))
        elif tag == 'texture':
            raise NotImplementedError('bitmap textures are not ported yet')
        elif tag == 'emitter':
            etype = child.get('type')
            if etype in ('point', 'envmap'):
                raise NotImplementedError(
                    f'{etype} emitters are not ported yet')
            raise ValueError(f'unsupported emitter {etype}')
        elif tag == 'shape':
            stype = child.get('type')
            mat_id = None
            for c in child:
                if c.tag == 'bsdf':
                    mat_id = add_mat(_parse_bsdf(c))
                    break
                if c.tag == 'ref':
                    mat_id = bsdf_map[c.get('id')]
                    break
            if mat_id is None:
                mat_id = add_mat(_BSDFSpec())
            tw = _parse_shape_transform(child)
            fname = None
            shape_index = 0
            flip_normals = face_normals = False
            for c in child:
                name = c.get('name')
                if name == 'filename':
                    fname = os.path.join(scene_dir, c.get('value'))
                elif name == 'shapeIndex':
                    shape_index = int(c.get('value'))
                elif name == 'flipNormals':
                    flip_normals = c.get('value') == 'true'
                elif name == 'faceNormals':
                    face_normals = c.get('value') == 'true'
            if stype == 'serialized':
                mesh = load_serialized(fname, shape_index, tw, tw, False,
                                       flip_normals, face_normals)
            elif stype == 'obj':
                mesh = load_obj(fname, tw, tw, False, flip_normals,
                                face_normals)
            else:
                raise ValueError(f'unsupported shape {stype}')
            area_light_id = -1
            for c in child:
                if c.tag == 'emitter':
                    if c.get('type') != 'area':
                        raise NotImplementedError(
                            f'{c.get("type")} emitters are not ported yet')
                    radiance = np.ones(3)
                    for g in c:
                        if g.get('name') == 'radiance':
                            radiance = _parse_vec3(g.get('value'))
                    lights.append(dict(emission=radiance, shape=len(meshes)))
                    area_light_id = len(lights) - 1
            meshes.append(mesh)
            mesh_mats.append(mat_id)
            mesh_lights.append(area_light_id)

    host = assemble_host(cam, meshes, mesh_mats, mesh_lights, mat_specs,
                         lights)
    return host, options, output_name


def parse_scene(filename, film_wh=None, device='cuda'):
    """Parse a scene XML file onto `device` (the card by default; a machine
    without one must ask for device='cpu').
    Returns (SceneData, Options, output_name)."""
    host, options, output_name = parse_scene_host(filename, film_wh)
    return build_scene(host, device), options, output_name


def assemble_host(cam, meshes, mesh_mats, mesh_lights, mat_specs, lights):
    """Flatten parsed meshes/materials/lights into the host arrays of the
    JAX assemble_scene (same dtypes, same values)."""
    from ..ops.intersect import build_matmul_tables
    f32 = np.float32
    tri_p, tri_n, tri_st, tri_mat, tri_shape, tri_light = [], [], [], [], [], []
    mesh_tri_offset = []
    for si, mesh in enumerate(meshes):
        idx = mesh.indices
        ntri = idx.shape[0]
        mesh_tri_offset.append(sum(len(m.indices) for m in meshes[:si]))
        tri_p.append(mesh.position[:, idx])
        tri_n.append(mesh.normal[:, idx])
        tri_st.append(mesh.st[idx])
        tri_mat.append(np.full(ntri, mesh_mats[si], np.int32))
        tri_shape.append(np.full(ntri, si, np.int32))
        tri_light.append(np.full(ntri, mesh_lights[si], np.int32))
    tri_p = np.concatenate(tri_p, axis=1).astype(f32)
    tri_n = np.concatenate(tri_n, axis=1).astype(f32)
    tri_st = np.concatenate(tri_st, axis=0).astype(f32)

    L = max(len(lights), 1)
    amax = max([len(meshes[lt['shape']].indices) for lt in lights] + [1])
    ltype = np.zeros(L, np.int32)
    lweight = np.zeros(L, f32)
    lemission = np.zeros((L, 3), f32)
    light_tri = np.zeros((L, amax), np.int32)
    light_tri_cdf = np.zeros((L, amax + 1), f32)
    light_tri_pmf = np.zeros((L, amax), f32)
    light_ntri = np.zeros(L, np.int32)
    light_inv_area = np.zeros(L, f32)
    for li, lt in enumerate(lights):
        ltype[li] = LIGHT_AREA
        lweight[li] = 1.0
        lemission[li] = lt['emission']
        mesh = meshes[lt['shape']]
        idx = mesh.indices
        p = mesh.position[0]
        e1 = p[idx[:, 1]] - p[idx[:, 0]]
        e2 = p[idx[:, 2]] - p[idx[:, 0]]
        areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        total = areas.sum()
        n = len(areas)
        cdf = np.zeros(n + 1)
        np.cumsum(areas / n, out=cdf[1:])
        func_int = cdf[-1]
        cdf = cdf / func_int if func_int > 0 else np.arange(n + 1) / n
        light_tri[li, :n] = mesh_tri_offset[lt['shape']] + np.arange(n)
        light_tri_cdf[li, :n + 1] = cdf
        light_tri_cdf[li, n + 1:] = 1.0
        light_tri_pmf[li, :n] = areas / max(total, 1e-30)
        light_ntri[li] = n
        light_inv_area[li] = 1.0 / max(total, 1e-30)
    lcdf = np.zeros(L + 1, f32)
    np.cumsum(lweight / L, out=lcdf[1:])
    fi = lcdf[-1]
    lcdf = lcdf / fi if fi > 0 else (np.arange(L + 1) / L).astype(f32)

    pmin = tri_p.reshape(-1, 3).min(0)
    pmax = tri_p.reshape(-1, 3).max(0)
    center = 0.5 * (pmin + pmax)
    radius = float(np.linalg.norm(pmax - center)) * 1000.0
    isect_B, isect_C, isect_ok = build_matmul_tables(tri_p[0])
    neg = lambda: np.full(len(mat_specs), -1, np.int32)
    return dict(
        tri_p=tri_p, tri_n=tri_n, tri_st=tri_st,
        tri_mat=np.concatenate(tri_mat), tri_shape=np.concatenate(tri_shape),
        tri_light=np.concatenate(tri_light),
        mat_type=np.array([s.type for s in mat_specs], np.int32),
        mat_twosided=np.array([s.twosided for s in mat_specs], bool),
        mat_kd=np.stack([s.kd for s in mat_specs]).astype(f32),
        mat_ks=np.stack([s.ks for s in mat_specs]).astype(f32),
        mat_exponent=np.array([s.exponent for s in mat_specs], f32),
        mat_ks_weight=np.array([s.ks_weight for s in mat_specs], f32),
        mat_kd_tex=neg(), mat_ks_tex=neg(), mat_exponent_tex=neg(),
        mat_alpha_tex=neg(),
        light_type=ltype, light_weight=lweight, light_cdf=lcdf,
        light_emission=lemission, light_tri=light_tri,
        light_tri_cdf=light_tri_cdf, light_tri_pmf=light_tri_pmf,
        light_ntri=light_ntri, light_inv_area=light_inv_area,
        bsphere_center=center.astype(f32), bsphere_radius=f32(radius),
        isect_B=isect_B, isect_C=isect_C, isect_ok=isect_ok,
        num_lights=len(lights), camera=cam)
