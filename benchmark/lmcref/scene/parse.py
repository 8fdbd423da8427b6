"""Mitsuba-0.5-style scene XML parser (port of scene/parse.py).

Supports the node set of the JAX parser: perspective sensor + hdrfilm,
``obj`` / ``serialized`` shapes, ``diffuse`` / ``phong`` /
``roughdielectric`` (optionally ``twosided``) BSDFs, ``bitmap`` textures
(inline or referenced by id), ``point`` / ``envmap`` / ``area`` emitters,
two-keyframe ``<animation name="toWorld">`` on shapes, the sensor and the
env map, and the ``<dpt>`` options block.
"""

import os
import re
import xml.etree.ElementTree as ET

import numpy as np

from . import transforms as T
from .camera import camera_arrays
from .mesh import load_obj, load_serialized
from .scenedata import (BSDF_LAMBERTIAN, BSDF_PHONG, BSDF_ROUGH_DIELECTRIC,
                        LIGHT_AREA, LIGHT_ENV, LIGHT_POINT, build_scene,
                        env_host_arrays)
from .textures import TextureBuilder
from ..options import Options
from ..utils import image_io


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
        self.kd_tex = -1
        self.ks = np.array([0.2, 0.2, 0.2])
        self.ks_tex = -1
        self.exponent = 30.0
        self.exponent_tex = -1
        self.ks_weight = 0.0
        self.eta = 1.5046 / 1.000277
        self.alpha = 0.1
        self.alpha_tex = -1


def _lum(v):
    return 0.212671 * v[0] + 0.715160 * v[1] + 0.072169 * v[2]


def _parse_map(node, tex_builder, tex_map, scene_dir):
    """An rgb/float/spectrum/texture/ref child -> (value, tex_id, avg). A
    bitmap texture gives value (1,1,1), tex_id >= 0 and its gamma-decoded
    mean as avg (Phong's KsWeight reads it)."""
    if node.tag == 'texture':
        tid, avg = _parse_texture(node, tex_builder, scene_dir)
        return np.ones(3), tid, avg
    if node.tag == 'ref':
        tid, avg = tex_map[node.get('id')]
        return np.ones(3), tid, avg
    v = _parse_vec3(node.get('value'))
    return v, -1, v


def _parse_texture(node, tex_builder, scene_dir):
    filename = None
    uvscale = 1.0
    for child in node:
        name = child.get('name')
        if name == 'filename':
            filename = os.path.join(scene_dir, child.get('value'))
        elif name == 'uvscale':
            uvscale = float(child.get('value'))
    tid = tex_builder.add_bitmap(filename, (uvscale, uvscale))
    return tid, tex_builder.avg(tid)


def _parse_bsdf(node, tex_builder, tex_map, scene_dir, twosided=False):
    btype = node.get('type')
    spec = _BSDFSpec()
    spec.twosided = twosided
    pm = lambda c: _parse_map(c, tex_builder, tex_map, scene_dir)
    if btype == 'twosided':
        for child in node:
            if child.tag == 'bsdf':
                return _parse_bsdf(child, tex_builder, tex_map, scene_dir,
                                   True)
        raise ValueError('twosided without nested bsdf')
    if btype == 'diffuse':
        spec.type = BSDF_LAMBERTIAN
        for child in node:
            if child.get('name') == 'reflectance' or child.tag in ('texture',
                                                                   'ref'):
                spec.kd, spec.kd_tex, _ = pm(child)
    elif btype == 'phong':
        spec.type = BSDF_PHONG
        kd_avg = np.array([0.5, 0.5, 0.5])
        ks_avg = np.array([0.2, 0.2, 0.2])
        for child in node:
            name = child.get('name')
            if name == 'diffuseReflectance':
                spec.kd, spec.kd_tex, kd_avg = pm(child)
            elif name == 'specularReflectance':
                spec.ks, spec.ks_tex, ks_avg = pm(child)
            elif name == 'exponent':
                v, spec.exponent_tex, _ = pm(child)
                spec.exponent = float(v[0])
        # KsWeight from the average luminances; a texture map contributes
        # its decoded mean
        kd_l = _lum(kd_avg) if spec.kd_tex >= 0 else _lum(spec.kd)
        ks_l = _lum(ks_avg) if spec.ks_tex >= 0 else _lum(spec.ks)
        s = kd_l + ks_l
        spec.ks_weight = ks_l / s if s > 0 else 0.0
    elif btype == 'roughdielectric':
        spec.type = BSDF_ROUGH_DIELECTRIC
        int_ior, ext_ior = 1.5046, 1.000277
        spec.kd = np.ones(3)  # Kt
        spec.ks = np.ones(3)
        for child in node:
            name = child.get('name')
            if name == 'intIOR':
                int_ior = float(child.get('value'))
            elif name == 'extIOR':
                ext_ior = float(child.get('value'))
            elif name == 'alpha':
                v, spec.alpha_tex, _ = pm(child)
                spec.alpha = float(v[0])
            elif name == 'specularReflectance':
                spec.ks, spec.ks_tex, _ = pm(child)
            elif name == 'specularTransmittance':
                spec.kd, spec.kd_tex, _ = pm(child)
        spec.eta = int_ior / ext_ior
    else:
        raise ValueError(f'unknown bsdf type {btype}')
    return spec


def _parse_keyframes(node):
    """The two keyframe matrices of an <animation> node."""
    ms = [_parse_transform(g) for g in node if g.tag == 'transform']
    return ms[0], ms[1]


def _parse_to_world(node):
    """A toWorld <transform> or two-keyframe <animation> as an
    AnimatedTransform."""
    if node.tag == 'animation':
        return T.AnimatedTransform(*_parse_keyframes(node))
    return T.AnimatedTransform(_parse_transform(node))


def _parse_shape_transforms(node):
    """(toWorld at keyframe 0, at keyframe 1, is_moving) of a shape."""
    tw0 = tw1 = np.eye(4)
    is_moving = False
    for child in node:
        if child.get('name') == 'toWorld':
            if child.tag == 'transform':
                tw0 = tw1 = _parse_transform(child)
            elif child.tag == 'animation':
                tw0, tw1 = _parse_keyframes(child)
                is_moving = True
    return tw0, tw1, is_moving


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
        'uselightcoordinatesampling': ('use_light_coordinate_sampling', None),
        'largestepmultiplexed': ('large_step_multiplexed', None),
        'mala': ('mala', None), 'h2mc': ('h2mc', None),
        'mala-stepsize': ('mala_stepsize', float),
        'mala-gn': ('mala_gn', float),
        'samplecache': ('sample_from_global_cache', None),
    }
    kw = {}
    for child in node:
        name = child.get('name')
        val = child.get('value')
        if name not in keymap:
            continue
        field, conv = keymap[name]
        kw[field] = (val == 'true') if conv is None else conv(val)
    return Options().replace(**kw)


def parse_scene_host(filename, film_wh=None):
    """Parse a scene XML file into host arrays.
    Returns (host dict, Options, output_name)."""
    scene_dir = os.path.dirname(os.path.abspath(filename))
    root = ET.parse(filename).getroot()
    options = Options()
    cam = None
    output_name = 'image'
    tex_builder = TextureBuilder()
    tex_map = {}
    bsdf_map = {}
    meshes, mesh_mats, mesh_lights, mat_specs, lights = [], [], [], [], []
    env = None

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
                    to_world = _parse_to_world(c)
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
            bsdf_map[child.get('id')] = add_mat(
                _parse_bsdf(child, tex_builder, tex_map, scene_dir))
        elif tag == 'texture':
            tex_map[child.get('id')] = _parse_texture(child, tex_builder,
                                                      scene_dir)
        elif tag == 'emitter':
            etype = child.get('type')
            if etype == 'point':
                pos = np.zeros(3)
                intensity = np.ones(3)
                for c in child:
                    name = c.get('name')
                    if name == 'position':
                        pos = np.array([float(c.get('x', 0.0)),
                                        float(c.get('y', 0.0)),
                                        float(c.get('z', 0.0))])
                    elif name == 'intensity':
                        intensity = _parse_vec3(c.get('value'))
                lights.append(dict(type=LIGHT_POINT, pos=pos,
                                   emission=intensity))
            elif etype == 'envmap':
                env_file = None
                to_world = T.AnimatedTransform(np.eye(4))
                for c in child:
                    name = c.get('name')
                    if name == 'filename':
                        env_file = os.path.join(scene_dir, c.get('value'))
                    elif name == 'toWorld':
                        to_world = _parse_to_world(c)
                lights.append(dict(type=LIGHT_ENV, pos=np.zeros(3),
                                   emission=np.zeros(3)))
                env = dict(image=image_io.read_image(env_file),
                           to_world=to_world, light_id=len(lights) - 1)
            else:
                raise ValueError(f'unsupported emitter {etype}')
        elif tag == 'shape':
            stype = child.get('type')
            mat_id = None
            for c in child:
                if c.tag == 'bsdf':
                    mat_id = add_mat(_parse_bsdf(c, tex_builder, tex_map,
                                                 scene_dir))
                    break
                if c.tag == 'ref':
                    mat_id = bsdf_map[c.get('id')]
                    break
            if mat_id is None:
                mat_id = add_mat(_BSDFSpec())
            tw0, tw1, is_moving = _parse_shape_transforms(child)
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
                mesh = load_serialized(fname, shape_index, tw0, tw1,
                                       is_moving, flip_normals, face_normals)
            elif stype == 'obj':
                mesh = load_obj(fname, tw0, tw1, is_moving, flip_normals,
                                face_normals)
            else:
                raise ValueError(f'unsupported shape {stype}')
            area_light_id = -1
            for c in child:
                # any emitter nested in a shape is an area light, whatever
                # its type, as in the JAX parser
                if c.tag == 'emitter':
                    radiance = np.ones(3)
                    for g in c:
                        if g.get('name') == 'radiance':
                            radiance = _parse_vec3(g.get('value'))
                    lights.append(dict(type=LIGHT_AREA, pos=np.zeros(3),
                                       emission=radiance, shape=len(meshes)))
                    area_light_id = len(lights) - 1
            meshes.append(mesh)
            mesh_mats.append(mat_id)
            mesh_lights.append(area_light_id)

    host = assemble_host(cam, meshes, mesh_mats, mesh_lights, mat_specs,
                         lights, env, tex_builder)
    return host, options, output_name


def parse_scene(filename, film_wh=None, device='cpu', dtype=None):
    """Parse a scene XML file onto `device`, its float tables in `dtype`
    (default float32). Returns (SceneData, Options, output_name)."""
    import torch
    host, options, output_name = parse_scene_host(filename, film_wh)
    return (build_scene(host, device, dtype or torch.float32), options,
            output_name)


def assemble_host(cam, meshes, mesh_mats, mesh_lights, mat_specs, lights,
                  env, tex_builder):
    """Flatten parsed meshes/materials/lights/env map into the host arrays
    of the JAX assemble_scene (same dtypes, same values)."""
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
    has_motion = any(m.is_moving for m in meshes)

    L = max(len(lights), 1)
    amax = max([len(meshes[lt['shape']].indices) for lt in lights
                if lt['type'] == LIGHT_AREA] + [1])
    ltype = np.zeros(L, np.int32)
    lweight = np.zeros(L, f32)
    lpos = np.zeros((L, 3), f32)
    lemission = np.zeros((L, 3), f32)
    light_tri = np.zeros((L, amax), np.int32)
    light_tri_cdf = np.zeros((L, amax + 1), f32)
    light_tri_pmf = np.zeros((L, amax), f32)
    light_ntri = np.zeros(L, np.int32)
    light_inv_area = np.zeros(L, f32)
    for li, lt in enumerate(lights):
        ltype[li] = lt['type']
        lweight[li] = 1.0
        lpos[li] = lt['pos']
        lemission[li] = lt['emission']
        if lt['type'] != LIGHT_AREA:
            continue
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

    # bounding sphere, radius inflated x1000
    pmin = tri_p.reshape(-1, 3).min(0)
    pmax = tri_p.reshape(-1, 3).max(0)
    center = 0.5 * (pmin + pmax)
    radius = float(np.linalg.norm(pmax - center)) * 1000.0
    eta = np.array([s.eta for s in mat_specs], f32)
    spec = lambda k, dt: np.array([getattr(s, k) for s in mat_specs], dt)
    host = dict(
        tri_p=tri_p, tri_n=tri_n, tri_st=tri_st,
        tri_mat=np.concatenate(tri_mat), tri_shape=np.concatenate(tri_shape),
        tri_light=np.concatenate(tri_light),
        mat_type=spec('type', np.int32), mat_twosided=spec('twosided', bool),
        mat_kd=np.stack([s.kd for s in mat_specs]).astype(f32),
        mat_kd_tex=spec('kd_tex', np.int32),
        mat_ks=np.stack([s.ks for s in mat_specs]).astype(f32),
        mat_ks_tex=spec('ks_tex', np.int32),
        mat_exponent=spec('exponent', f32),
        mat_exponent_tex=spec('exponent_tex', np.int32),
        mat_ks_weight=spec('ks_weight', f32),
        mat_eta=eta, mat_inv_eta=1.0 / eta, mat_alpha=spec('alpha', f32),
        mat_alpha_tex=spec('alpha_tex', np.int32),
        light_type=ltype, light_weight=lweight, light_cdf=lcdf,
        light_pos=lpos, light_emission=lemission, light_tri=light_tri,
        light_tri_cdf=light_tri_cdf, light_tri_pmf=light_tri_pmf,
        light_ntri=light_ntri, light_inv_area=light_inv_area,
        bsphere_center=center.astype(f32), bsphere_radius=f32(radius),
        num_lights=len(lights), has_motion=has_motion,
        env_light_id=-1 if env is None else env['light_id'],
        camera=cam, textures=tex_builder.host_arrays())
    host.update(env_host_arrays(None if env is None else env['image'],
                                None if env is None else env['to_world']))
    return host
