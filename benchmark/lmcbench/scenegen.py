"""The benchmark's frozen copy of the port's scene generator
(langevin_mcmc_tpu_torch/testscenes.py as of the benchmark's first
version; numpy only): the same OBJ and EXR files and scene XML, so a
later change to the port's generator cannot move a cell's scene. It
writes OBJ and EXR files and a Mitsuba-0.5 scene XML whose <dpt> block
selects MCMC with MALA, H2MC or isotropic-only small steps, or plain MC.

* ``box``: a tessellated Phong torus in a closed diffuse box lit by one
  quad area light.
* ``open``: no walls and no ceiling, lit by an env map (a sky gradient
  with a small, very bright sun disc), one point light and the quad area
  light; the torus is a rough dielectric, it stands on a floor with a
  bitmap texture beside a textured Phong sphere. Camera rays reach the
  sky and rays leaving the torus miss every triangle.

small=True writes the CPU-sized form: the small torus, small images, a 64x48
film, 1,024 chains and 4,096 bootstrap samples. kernel iso sets neither
mala nor h2mc (the isotropic-only small step). large_step multiplexed
sets largestepmultiplexed; cache sets it and samplecache (cache-seeded
large steps, with MALA); light_coords sets uselightcoordinatesampling.
motion gives the torus and the quad light two keyframes (a rotation
about the vertical through their centre and a translation), pans the
camera and, on the open scene, turns the env map about the vertical.
"""

import os

import numpy as np

from lmcref.utils.image_io import write_exr

# flagship torus: 192 x 64 quads = 24,576 triangles
TORUS_SEGMENTS = (192, 64)
SMALL_TORUS_SEGMENTS = (32, 16)


def torus_mesh(nu, nv, major=1.25, minor=0.45, tilt_deg=55.0,
               center=(0.0, 0.0, 1.4)):
    """Vertices [nu*nv, 3] and triangles [2*nu*nv, 3] (0-based) of a torus
    tilted about the x axis, wound so face normals point outward."""
    u = 2.0 * np.pi * np.arange(nu) / nu
    v = 2.0 * np.pi * np.arange(nv) / nv
    uu, vv = np.meshgrid(u, v, indexing='ij')
    ring = major + minor * np.cos(vv)
    p = np.stack([ring * np.cos(uu), ring * np.sin(uu),
                  minor * np.sin(vv)], -1).reshape(-1, 3)
    a = np.radians(tilt_deg)
    rot = np.array([[1.0, 0.0, 0.0],
                    [0.0, np.cos(a), -np.sin(a)],
                    [0.0, np.sin(a), np.cos(a)]])
    p = p @ rot.T + np.asarray(center)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing='ij')
    i1, j1 = (i + 1) % nu, (j + 1) % nv
    a0, a1 = i * nv + j, i1 * nv + j
    b0, b1 = i1 * nv + j1, i * nv + j1
    tris = np.concatenate([np.stack([a0, a1, b0], -1).reshape(-1, 3),
                           np.stack([a0, b0, b1], -1).reshape(-1, 3)])
    return p, tris


def _write_obj(path, verts, tris, st=None):
    """OBJ with one texture coordinate per vertex when st [V, 2] is given
    (faces then read f v/vt)."""
    with open(path, 'w') as f:
        for x, y, z in verts:
            f.write(f'v {x:.9g} {y:.9g} {z:.9g}\n')
        if st is not None:
            for u, v in st:
                f.write(f'vt {u:.9g} {v:.9g}\n')
        for a, b, c in tris + 1:
            if st is None:
                f.write(f'f {a} {b} {c}\n')
            else:
                f.write(f'f {a}/{a} {b}/{b} {c}/{c}\n')


def _quad(p0, p1, p2, p3):
    """Two triangles of the quad p0 p1 p2 p3 (counter-clockwise seen from
    the side its normal points to)."""
    return (np.array([p0, p1, p2, p3], float),
            np.array([[0, 1, 2], [0, 2, 3]]))


# box [-5,5]^2 x [0,6]; each face's normal points into the box
_FLOOR = _quad((-5, -5, 0), (5, -5, 0), (5, 5, 0), (-5, 5, 0))
_BACK = _quad((-5, 5, 0), (5, 5, 0), (5, 5, 6), (-5, 5, 6))
_FRONT = _quad((-5, -5, 0), (-5, -5, 6), (5, -5, 6), (5, -5, 0))
_LEFT = _quad((-5, -5, 0), (-5, 5, 0), (-5, 5, 6), (-5, -5, 6))
_RIGHT = _quad((5, -5, 0), (5, -5, 6), (5, 5, 6), (5, 5, 0))
_LIGHT = _quad((-1.5, -1.5, 5.9), (-1.5, 1.5, 5.9), (1.5, 1.5, 5.9),
               (1.5, -1.5, 5.9))


LARGE_STEPS = ('plain', 'multiplexed', 'cache')
KERNELS = ('mala', 'h2mc', 'iso')

TORUS_CENTER = (0.0, 0.0, 1.4)
LIGHT_CENTER = (0.0, 0.0, 5.9)
# keyframe 1 of --motion: (degrees about the vertical through the centre,
# translation) of the torus and of the quad light; the camera's target
# shift; the env map's turn about the vertical (degrees)
TORUS_MOTION = (15.0, (0.35, 0.2, 0.0))
LIGHT_MOTION = (30.0, (0.5, -0.4, 0.0))
CAMERA_PAN = (0.6, 0.0, 0.0)
ENV_TURN = 25.0


def _vec(v):
    return ', '.join(f'{x:g}' for x in v)


def _shape_to_world(motion, center, spin):
    """The toWorld of a shape: none when static; else keyframe 0 the
    identity and keyframe 1 a turn of spin[0] degrees about the vertical
    through center followed by the translation spin[1]."""
    if not motion:
        return ''
    angle, move = spin
    cx, cy, cz = center
    to = [c + m for c, m in zip(center, move)]
    return f'''
        <animation name="toWorld">
            <transform><translate x="0"/></transform>
            <transform>
                <translate x="{0.0 - cx:g}" y="{0.0 - cy:g}" z="{0.0 - cz:g}"/>
                <rotate z="1" angle="{angle:g}"/>
                <translate x="{to[0]:g}" y="{to[1]:g}" z="{to[2]:g}"/>
            </transform>
        </animation>'''


def _dpt(integrator, max_depth, num_init_samples, kernel, num_chains,
         large_step='plain', light_coords=False):
    flags = ''.join(
        f'\n        <boolean name="{name}" value="true"/>'
        for name, on in ((kernel, kernel != 'iso'),
                         ('largestepmultiplexed', large_step != 'plain'),
                         ('samplecache', large_step == 'cache'),
                         ('uselightcoordinatesampling', light_coords))
        if on)
    return f'''    <dpt>
        <string  name="integrator" value="{integrator}"/>
        <integer name="mindepth" value="-1"/>
        <integer name="maxdepth" value="{max_depth}"/>
        <boolean name="bidirectional" value="true"/>
        <integer name="spp" value="4"/>
        <integer name="numchains" value="{num_chains}"/>
        <integer name="numinitsamples" value="{num_init_samples}"/>
        <integer name="directspp" value="1"/>{flags}
    </dpt>'''


def _sensor(origin, target, width, height, name, motion=False):
    """The sensor; with motion its target moves by CAMERA_PAN between the
    keyframes (a pan)."""
    look = lambda t: f'<lookat target="{_vec(t)}" origin="{_vec(origin)}" ' \
        f'up="0, 0, 1"/>'
    if motion:
        target1 = [a + b for a, b in zip(target, CAMERA_PAN)]
        to_world = f'''<animation name="toWorld">
            <transform>{look(target)}</transform>
            <transform>{look(target1)}</transform>
        </animation>'''
    else:
        to_world = f'''<transform name="toWorld">
            {look(target)}
        </transform>'''
    return f'''    <sensor type="perspective">
        <float name="fov" value="60"/>
        <string name="fovAxis" value="x"/>
        <float name="nearClip" value="0.01"/>
        <float name="farClip" value="100"/>
        {to_world}
        <film type="hdrfilm">
            <integer name="width" value="{width}"/>
            <integer name="height" value="{height}"/>
            <string name="filename" value="{name}"/>
        </film>
    </sensor>'''


def write_scene(out_dir, small=False, width=1024, height=768, max_depth=8,
                num_init_samples=300000, kernel='mala', integrator='mcmc',
                scene='box', num_chains=65536, large_step='plain',
                light_coords=False, motion=False):
    """Write the scene's files and scene.xml into out_dir; returns the XML
    path. scene: 'box' or 'open' (see the module docstring). small=True
    gives a ~1,000-triangle torus (and small images) for tests. The <dpt>
    block holds the flagship's spp 4 and directspp 1, num_chains (65,536
    for the flagship), the integrator ('mcmc' or 'mc'), the small-step
    kernel of 'mcmc' ('mala', 'h2mc' or 'iso'), the large step ('plain',
    'multiplexed' or 'cache': multiplexed and cache-seeded) and
    light-coordinate sampling. motion: the --motion keyframes (see the
    module docstring)."""
    if kernel not in KERNELS or integrator not in ('mcmc', 'mc'):
        raise ValueError(f'kernel {kernel!r}, integrator {integrator!r}')
    if scene not in ('box', 'open') or large_step not in LARGE_STEPS:
        raise ValueError(f'scene {scene!r}, large step {large_step!r}')
    os.makedirs(out_dir, exist_ok=True)
    nu, nv = SMALL_TORUS_SEGMENTS if small else TORUS_SEGMENTS
    dpt = _dpt(integrator, max_depth, num_init_samples, kernel, num_chains,
               large_step, light_coords)
    if scene == 'open':
        return _write_open(out_dir, small, (nu, nv), width, height, dpt,
                           motion)
    _write_obj(os.path.join(out_dir, 'torus.obj'), *torus_mesh(nu, nv))
    walls = [_FLOOR, _BACK, _FRONT]
    wv = np.concatenate([w[0] for w in walls])
    wt = np.concatenate([w[1] + 4 * k for k, w in enumerate(walls)])
    _write_obj(os.path.join(out_dir, 'walls.obj'), wv, wt)
    _write_obj(os.path.join(out_dir, 'left.obj'), *_LEFT)
    _write_obj(os.path.join(out_dir, 'right.obj'), *_RIGHT)
    _write_obj(os.path.join(out_dir, 'light.obj'), *_LIGHT)
    torus_tw = _shape_to_world(motion, TORUS_CENTER, TORUS_MOTION)
    light_tw = _shape_to_world(motion, LIGHT_CENTER, LIGHT_MOTION)
    xml = f'''<?xml version='1.0' encoding='utf-8'?>
<scene version="0.5.0">
{dpt}
{_sensor((0, -4.6, 3.2), TORUS_CENTER, width, height, 'torus', motion)}
    <shape type="obj">
        <string name="filename" value="torus.obj"/>{torus_tw}
        <bsdf type="phong">
            <spectrum name="diffuseReflectance" value="0.25, 0.3, 0.5"/>
            <spectrum name="specularReflectance" value="0.4, 0.4, 0.4"/>
            <float name="exponent" value="40"/>
        </bsdf>
    </shape>
    <shape type="obj">
        <string name="filename" value="walls.obj"/>
        <bsdf type="diffuse">
            <spectrum name="reflectance" value="0.7, 0.65, 0.6"/>
        </bsdf>
    </shape>
    <shape type="obj">
        <string name="filename" value="left.obj"/>
        <bsdf type="diffuse">
            <spectrum name="reflectance" value="0.6, 0.15, 0.15"/>
        </bsdf>
    </shape>
    <shape type="obj">
        <string name="filename" value="right.obj"/>
        <bsdf type="diffuse">
            <spectrum name="reflectance" value="0.15, 0.6, 0.2"/>
        </bsdf>
    </shape>
    <shape type="obj">
        <string name="filename" value="light.obj"/>{light_tw}
        <bsdf type="diffuse">
            <spectrum name="reflectance" value="0.0, 0.0, 0.0"/>
        </bsdf>
        <emitter type="area">
            <spectrum name="radiance" value="20.0, 20.0, 20.0"/>
        </emitter>
    </shape>
</scene>
'''
    path = os.path.join(out_dir, 'scene.xml')
    with open(path, 'w') as f:
        f.write(xml)
    return path


# open scene: env map, textures, sphere
ENV_SIZE = (512, 1024)          # (h, w) of the env map
SMALL_ENV_SIZE = (64, 128)
FLOOR_TEX = 1024                # floor texture side
SMALL_FLOOR_TEX = 64
SPHERE_TEX = 256
SMALL_SPHERE_TEX = 32
SPHERE_SEGMENTS = (64, 32)
SMALL_SPHERE_SEGMENTS = (16, 8)
SUN_DIR = (0.45, -0.55, 0.70)   # world, z up
SUN_RADIUS_DEG = 2.0
SUN_RADIANCE = 2000.0


def sphere_mesh(nu, nv, center, radius):
    """UV sphere: vertices [(nu+1)*(nv+1), 3], st [.., 2] and triangles
    (0-based, outward), with a seam column so st runs 0..1."""
    u = np.arange(nu + 1) / nu
    v = np.arange(nv + 1) / nv
    uu, vv = np.meshgrid(u, v, indexing='ij')
    phi, theta = 2.0 * np.pi * uu, np.pi * vv
    p = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                  np.cos(theta)], -1).reshape(-1, 3)
    st = np.stack([uu, vv], -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing='ij')
    a0, a1 = i * (nv + 1) + j, (i + 1) * (nv + 1) + j
    b0, b1 = a1 + 1, a0 + 1
    tris = np.concatenate([np.stack([a0, b1, b0], -1).reshape(-1, 3),
                           np.stack([a0, b0, a1], -1).reshape(-1, 3)])
    # drop the zero-area triangles at the poles
    area = np.linalg.norm(np.cross(p[tris[:, 1]] - p[tris[:, 0]],
                                   p[tris[:, 2]] - p[tris[:, 0]]), axis=1)
    return p * radius + np.asarray(center), st, tris[area > 1e-12]


def _smooth_noise(n, cells, rng):
    """[n, n] value noise in [0, 1): a random cells x cells grid,
    bilinearly upsampled with periodic wrap."""
    g = rng.random((cells, cells))
    x = np.arange(n) * cells / n
    i0 = np.floor(x).astype(int)
    f = x - i0
    i1 = (i0 + 1) % cells
    rows = g[i0] * (1 - f)[:, None] + g[i1] * f[:, None]
    return rows[:, i0] * (1 - f)[None] + rows[:, i1] * f[None]


def floor_texture(n, seed=0):
    """[n, n, 3] checker of 8 x 8 cells, modulated by value noise."""
    rng = np.random.default_rng(seed)
    k = (np.arange(n) * 8 // n) % 2
    check = (k[:, None] ^ k[None, :]).astype(bool)
    a = np.array([0.80, 0.75, 0.68])
    b = np.array([0.22, 0.28, 0.34])
    base = np.where(check[..., None], a, b)
    return (base * (0.8 + 0.2 * _smooth_noise(n, 16, rng))[..., None]
            ).astype(np.float32)


def sphere_texture(n, seed=1):
    """[n, n, 3] warm stripes along the sphere's s, modulated by noise."""
    rng = np.random.default_rng(seed)
    x = np.arange(n) / n
    stripe = 0.5 + 0.5 * np.sin(2 * np.pi * 6 * x)[:, None] \
        * np.ones((1, n))
    t = (0.7 * stripe + 0.3 * _smooth_noise(n, 8, rng))[..., None]
    return (np.array([0.75, 0.35, 0.12]) * t
            + np.array([0.15, 0.12, 0.1]) * (1 - t)).astype(np.float32)


def env_map(h, w):
    """[h, w, 3] lat-long sky in the env light's space (y up: row 0 is the
    zenith): a blue-to-white gradient above the horizon, a dim ground
    below, and a sun disc of SUN_RADIUS_DEG at SUN_DIR (world) of radiance
    SUN_RADIANCE."""
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2.0 * np.pi
    th, ph = np.meshgrid(theta, phi, indexing='ij')
    # the lat-long direction of pixel centres, light space
    d = np.stack([np.sin(ph) * np.sin(th), np.cos(th),
                  -np.cos(ph) * np.sin(th)], -1)
    up = d[..., 1:2]
    zenith = np.array([0.15, 0.35, 0.85])
    horizon = np.array([0.85, 0.88, 0.95])
    ground = np.array([0.12, 0.10, 0.08])
    a = np.clip(up, 0.0, 1.0) ** 0.5
    img = np.where(up > 0, horizon * (1 - a) + zenith * a, ground)
    # world z-up -> light y-up (the env map's toWorld is rotate x 90)
    sx, sy, sz = np.asarray(SUN_DIR) / np.linalg.norm(SUN_DIR)
    sun = np.array([sx, sz, -sy])
    cos_sun = np.cos(np.radians(SUN_RADIUS_DEG))
    img = np.where((d @ sun)[..., None] >= cos_sun, SUN_RADIANCE, img)
    return img.astype(np.float32)


def _write_open(out_dir, small, torus_segments, width, height, dpt,
                motion):
    """The open scene's files; returns the XML path."""
    _write_obj(os.path.join(out_dir, 'torus.obj'),
               *torus_mesh(*torus_segments))
    fv = np.array([(-20, -20, 0), (20, -20, 0), (20, 20, 0), (-20, 20, 0)],
                  float)
    _write_obj(os.path.join(out_dir, 'floor.obj'), fv,
               np.array([[0, 1, 2], [0, 2, 3]]),
               st=np.array([(0, 0), (1, 0), (1, 1), (0, 1)], float))
    sv, sst, stri = sphere_mesh(
        *(SMALL_SPHERE_SEGMENTS if small else SPHERE_SEGMENTS),
        center=(2.7, 0.9, 0.9), radius=0.9)
    _write_obj(os.path.join(out_dir, 'sphere.obj'), sv, stri, st=sst)
    _write_obj(os.path.join(out_dir, 'light.obj'), *_LIGHT)
    write_exr(os.path.join(out_dir, 'floor.exr'),
              floor_texture(SMALL_FLOOR_TEX if small else FLOOR_TEX))
    write_exr(os.path.join(out_dir, 'sphere.exr'),
              sphere_texture(SMALL_SPHERE_TEX if small else SPHERE_TEX))
    write_exr(os.path.join(out_dir, 'sky.exr'),
              env_map(*(SMALL_ENV_SIZE if small else ENV_SIZE)))
    torus_tw = _shape_to_world(motion, TORUS_CENTER, TORUS_MOTION)
    light_tw = _shape_to_world(motion, LIGHT_CENTER, LIGHT_MOTION)
    if motion:
        env_tw = f'''<animation name="toWorld">
            <transform><rotate x="1" angle="90"/></transform>
            <transform>
                <rotate x="1" angle="90"/>
                <rotate z="1" angle="{ENV_TURN:g}"/>
            </transform>
        </animation>'''
    else:
        env_tw = '''<transform name="toWorld">
            <rotate x="1" angle="90"/>
        </transform>'''
    xml = f'''<?xml version='1.0' encoding='utf-8'?>
<scene version="0.5.0">
{dpt}
{_sensor((0, -6, 2.2), (0, 0, 1.2), width, height, 'open', motion)}
    <emitter type="envmap">
        <string name="filename" value="sky.exr"/>
        {env_tw}
    </emitter>
    <emitter type="point">
        <point name="position" x="-2.5" y="-1.5" z="3.5"/>
        <spectrum name="intensity" value="40, 36, 30"/>
    </emitter>
    <texture type="bitmap" id="stripes">
        <string name="filename" value="sphere.exr"/>
        <float name="uvscale" value="1"/>
    </texture>
    <shape type="obj">
        <string name="filename" value="torus.obj"/>{torus_tw}
        <bsdf type="roughdielectric">
            <float name="alpha" value="0.1"/>
            <float name="intIOR" value="1.5"/>
            <float name="extIOR" value="1.0"/>
        </bsdf>
    </shape>
    <shape type="obj">
        <string name="filename" value="floor.obj"/>
        <bsdf type="diffuse">
            <texture type="bitmap" name="reflectance">
                <string name="filename" value="floor.exr"/>
                <float name="uvscale" value="8"/>
            </texture>
        </bsdf>
    </shape>
    <shape type="obj">
        <string name="filename" value="sphere.obj"/>
        <bsdf type="phong">
            <ref name="diffuseReflectance" id="stripes"/>
            <spectrum name="specularReflectance" value="0.3, 0.3, 0.3"/>
            <float name="exponent" value="60"/>
        </bsdf>
    </shape>
    <shape type="obj">
        <string name="filename" value="light.obj"/>{light_tw}
        <bsdf type="diffuse">
            <spectrum name="reflectance" value="0.0, 0.0, 0.0"/>
        </bsdf>
        <emitter type="area">
            <spectrum name="radiance" value="20.0, 20.0, 20.0"/>
        </emitter>
    </shape>
</scene>
'''
    path = os.path.join(out_dir, 'scene.xml')
    with open(path, 'w') as f:
        f.write(xml)
    return path

