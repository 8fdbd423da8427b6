"""Generated test scenes (numpy only): a tessellated Phong torus in a
diffuse box lit by one quad area light, written as OBJ files plus a
Mitsuba-0.5 scene XML whose <dpt> block selects MCMC with MALA or H2MC
small steps, or plain MC. Both the JAX package's parser and the port's
read the files.

    python -m langevin_mcmc_tpu_torch.testscenes out_dir [--small]
"""

import argparse
import os

import numpy as np

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


def _write_obj(path, verts, tris):
    with open(path, 'w') as f:
        for x, y, z in verts:
            f.write(f'v {x:.9g} {y:.9g} {z:.9g}\n')
        for a, b, c in tris + 1:
            f.write(f'f {a} {b} {c}\n')


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


def write_scene(out_dir, small=False, width=1024, height=768, max_depth=8,
                num_init_samples=300000, kernel='mala', integrator='mcmc'):
    """Write the OBJ files and scene.xml into out_dir; returns the XML path.
    small=True gives a ~1,000-triangle torus for tests. The <dpt> block
    holds the flagship's spp 4, 65,536 chains and directspp 1, the
    integrator ('mcmc' or 'mc') and the small-step kernel of 'mcmc'
    ('mala' or 'h2mc')."""
    if kernel not in ('mala', 'h2mc') or integrator not in ('mcmc', 'mc'):
        raise ValueError(f'kernel {kernel!r}, integrator {integrator!r}')
    os.makedirs(out_dir, exist_ok=True)
    nu, nv = SMALL_TORUS_SEGMENTS if small else TORUS_SEGMENTS
    _write_obj(os.path.join(out_dir, 'torus.obj'), *torus_mesh(nu, nv))
    walls = [_FLOOR, _BACK, _FRONT]
    wv = np.concatenate([w[0] for w in walls])
    wt = np.concatenate([w[1] + 4 * k for k, w in enumerate(walls)])
    _write_obj(os.path.join(out_dir, 'walls.obj'), wv, wt)
    _write_obj(os.path.join(out_dir, 'left.obj'), *_LEFT)
    _write_obj(os.path.join(out_dir, 'right.obj'), *_RIGHT)
    _write_obj(os.path.join(out_dir, 'light.obj'), *_LIGHT)
    xml = f'''<?xml version='1.0' encoding='utf-8'?>
<scene version="0.5.0">
    <dpt>
        <string  name="integrator" value="{integrator}"/>
        <integer name="mindepth" value="-1"/>
        <integer name="maxdepth" value="{max_depth}"/>
        <boolean name="bidirectional" value="true"/>
        <integer name="spp" value="4"/>
        <integer name="numchains" value="65536"/>
        <integer name="numinitsamples" value="{num_init_samples}"/>
        <integer name="directspp" value="1"/>
        <boolean name="{kernel}" value="true"/>
    </dpt>
    <sensor type="perspective">
        <float name="fov" value="60"/>
        <string name="fovAxis" value="x"/>
        <float name="nearClip" value="0.01"/>
        <float name="farClip" value="100"/>
        <transform name="toWorld">
            <lookat target="0, 0, 1.4" origin="0, -4.6, 3.2" up="0, 0, 1"/>
        </transform>
        <film type="hdrfilm">
            <integer name="width" value="{width}"/>
            <integer name="height" value="{height}"/>
            <string name="filename" value="torus"/>
        </film>
    </sensor>
    <shape type="obj">
        <string name="filename" value="torus.obj"/>
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
        <string name="filename" value="light.obj"/>
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


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('out_dir')
    ap.add_argument('--small', action='store_true')
    ap.add_argument('--kernel', choices=('mala', 'h2mc'), default='mala')
    ap.add_argument('--integrator', choices=('mcmc', 'mc'), default='mcmc')
    args = ap.parse_args()
    print(write_scene(args.out_dir, small=args.small, kernel=args.kernel,
                      integrator=args.integrator))
