"""Perspective / orthographic cameras as batched ray-generation functions.

Replaces the reference's Transform-chain camera classes
(/root/reference/core/Camera.h:50-82, camera/Perspective.cpp:16-135,
camera/Orthographic.cpp): the raster->screen->camera->world chain is
precomputed host-side into a single 4x4 raster-to-camera matrix plus the
camera-to-world matrix, and ray generation is one fused batched op —
exactly the kind of small dense matmul + elementwise work XLA maps well.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.sampling import concentric_sample_disk
from ..utils.math import HIGHEST, normalize

PERSPECTIVE = 0
ORTHOGRAPHIC = 1


class Camera(NamedTuple):
    """Pytree camera. kind is static; matrices are device arrays so they can
    be differentiated (camera gradients) if desired."""
    kind: int  # static: PERSPECTIVE | ORTHOGRAPHIC
    raster_to_camera: jnp.ndarray  # (4,4)
    camera_to_world: jnp.ndarray  # (4,4)
    lens_radius: float
    focal_distance: float
    shutter_open: float
    shutter_close: float
    width: int
    height: int


def _flatten(c):
    return (c.raster_to_camera, c.camera_to_world), (
        c.kind, c.lens_radius, c.focal_distance, c.shutter_open, c.shutter_close,
        c.width, c.height,
    )


def _unflatten(aux, ch):
    kind, lr, fd, so, sc, w, h = aux
    return Camera(kind, ch[0], ch[1], lr, fd, so, sc, w, h)


jax.tree_util.register_pytree_node(Camera, _flatten, _unflatten)


# ---------------------------------------------------------------------------
# Host-side transform builders (numpy float64 for precision, cast to f32)
# ---------------------------------------------------------------------------

def look_at(eye, look, up):
    """World-to-camera inverse: returns camera-to-world 4x4 (pbrt LookAt
    builds camera-to-world directly; reference Transform.cpp LookAt)."""
    eye, look, up = (np.asarray(v, np.float64) for v in (eye, look, up))
    d = look - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    right = right / np.linalg.norm(right)
    new_up = np.cross(d, right)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = eye
    return m


def perspective_projection(fov_deg, near=1e-2, far=1000.0):
    """Perspective camera-to-screen (reference Transform.cpp Perspective)."""
    persp = np.array(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [0, 0, far / (far - near), -far * near / (far - near)],
            [0, 0, 1, 0],
        ],
        np.float64,
    )
    inv_tan = 1.0 / np.tan(np.deg2rad(fov_deg) / 2)
    scale = np.diag([inv_tan, inv_tan, 1.0, 1.0])
    return scale @ persp


def _screen_window(width, height):
    """Default screen window from aspect (camera/Perspective.cpp:118-131)."""
    frame = width / height
    if frame > 1:
        return (-frame, frame, -1.0, 1.0)
    return (-1.0, 1.0, -1.0 / frame, 1.0 / frame)


def _raster_to_screen(width, height, win):
    x0, x1, y0, y1 = win
    screen_to_raster = (
        np.diag([width, height, 1.0, 1.0])
        @ np.diag([1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0, 1.0])
        @ _translate(-x0, -y1, 0.0)
    )
    return np.linalg.inv(screen_to_raster)


def _translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = [x, y, z]
    return m


def make_perspective_camera(width, height, eye, look, up=(0.0, 1.0, 0.0),
                            fov=90.0, lens_radius=0.0, focal_distance=3.0,
                            shutter=(0.0, 1.0)):
    """Reference CreatePerspectiveCamera defaults: fov=90, no DoF
    (camera/Perspective.cpp:114-135)."""
    cam_to_world = look_at(eye, look, up)
    cam_to_screen = perspective_projection(fov)
    raster_to_camera = np.linalg.inv(cam_to_screen) @ _raster_to_screen(
        width, height, _screen_window(width, height)
    )
    return Camera(
        kind=PERSPECTIVE,
        raster_to_camera=jnp.asarray(raster_to_camera, jnp.float32),
        camera_to_world=jnp.asarray(cam_to_world, jnp.float32),
        lens_radius=float(lens_radius),
        focal_distance=float(focal_distance),
        shutter_open=float(shutter[0]),
        shutter_close=float(shutter[1]),
        width=width,
        height=height,
    )


def make_orthographic_camera(width, height, eye, look, up=(0.0, 1.0, 0.0),
                             lens_radius=0.0, focal_distance=3.0,
                             shutter=(0.0, 1.0)):
    """Orthographic projection camera (camera/Orthographic.cpp:11-110):
    camera-to-screen = Scale(1,1,1/(far-near)) * Translate(0,0,-near)."""
    cam_to_world = look_at(eye, look, up)
    near, far = 0.0, 1.0
    cam_to_screen = np.diag([1.0, 1.0, 1.0 / (far - near), 1.0]) @ _translate(0, 0, -near)
    raster_to_camera = np.linalg.inv(cam_to_screen) @ _raster_to_screen(
        width, height, _screen_window(width, height)
    )
    return Camera(
        kind=ORTHOGRAPHIC,
        raster_to_camera=jnp.asarray(raster_to_camera, jnp.float32),
        camera_to_world=jnp.asarray(cam_to_world, jnp.float32),
        lens_radius=float(lens_radius),
        focal_distance=float(focal_distance),
        shutter_open=float(shutter[0]),
        shutter_close=float(shutter[1]),
        width=width,
        height=height,
    )


# ---------------------------------------------------------------------------
# Batched ray generation
# ---------------------------------------------------------------------------

def _xform_point(m, p):
    """Apply 4x4 m to (..., 3) points with perspective divide."""
    ph = jnp.matmul(p, m[:3, :3].T, precision=HIGHEST) + m[:3, 3]
    w = jnp.matmul(p, m[3, :3].T, precision=HIGHEST) + m[3, 3]
    return ph / w[..., None]


def _xform_vector(m, v):
    return jnp.matmul(v, m[:3, :3].T, precision=HIGHEST)


def generate_rays(camera: Camera, p_film, time_u, p_lens_u):
    """Batched GenerateRay (camera/Perspective.cpp:35-60 semantics).

    p_film: (N, 2) raster coords; time_u, p_lens_u: sampler dims.
    Returns (origins (N,3), directions (N,3), time (N,)) in world space.
    """
    n = p_film.shape[0]
    p_raster = jnp.concatenate([p_film, jnp.zeros((n, 1), p_film.dtype)], axis=-1)
    p_camera = _xform_point(camera.raster_to_camera, p_raster)
    if camera.kind == PERSPECTIVE:
        o = jnp.zeros((n, 3), jnp.float32)
        d = normalize(p_camera)
    else:
        o = p_camera
        d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (n, 3))
    if camera.lens_radius > 0:
        p_lens = camera.lens_radius * concentric_sample_disk(p_lens_u)
        ft = camera.focal_distance / d[..., 2]
        p_focus = o + ft[..., None] * d
        o = jnp.concatenate([p_lens, jnp.zeros((n, 1), jnp.float32)], axis=-1)
        d = normalize(p_focus - o)
    time = camera.shutter_open + time_u * (camera.shutter_close - camera.shutter_open)
    o_world = _xform_point(camera.camera_to_world, o)
    d_world = normalize(_xform_vector(camera.camera_to_world, d))
    return o_world, d_world, time


class RayDifferentials(NamedTuple):
    """Auxiliary +1-pixel rays (core/Geometry.h:856 RayDifferential)."""
    rx_o: jnp.ndarray  # (N,3)
    rx_d: jnp.ndarray
    ry_o: jnp.ndarray
    ry_d: jnp.ndarray


def generate_ray_differentials(camera: Camera, p_film, time_u, p_lens_u):
    """Batched GenerateRayDifferential (core/Camera.cpp: offset pFilm by one
    pixel in x and y; camera/Perspective.cpp:62-106 semantics — the same
    lens sample is reused for the auxiliary rays).

    Returns (o, d, time, RayDifferentials)."""
    o, d, time = generate_rays(camera, p_film, time_u, p_lens_u)
    dx = jnp.asarray([1.0, 0.0], p_film.dtype)
    dy = jnp.asarray([0.0, 1.0], p_film.dtype)
    rx_o, rx_d, _ = generate_rays(camera, p_film + dx, time_u, p_lens_u)
    ry_o, ry_d, _ = generate_rays(camera, p_film + dy, time_u, p_lens_u)
    return o, d, time, RayDifferentials(rx_o, rx_d, ry_o, ry_d)


def scale_differentials(o, d, rd: RayDifferentials, s):
    """RayDifferential::ScaleDifferentials (core/Geometry.h:885): shrink the
    one-pixel offsets by s = 1/sqrt(spp) (core/Integrator.cpp render loop)."""
    return RayDifferentials(
        rx_o=o + (rd.rx_o - o) * s,
        rx_d=d + (rd.rx_d - d) * s,
        ry_o=o + (rd.ry_o - o) * s,
        ry_d=d + (rd.ry_d - d) * s,
    )
