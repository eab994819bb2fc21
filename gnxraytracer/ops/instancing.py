"""Object instancing: transformed copies of a base mesh sharing geometry.

Wavefront equivalent of the reference's TransformedPrimitive
(/root/reference/core/Primitive.h:55, core/Primitive.cpp:80-101): instead
of a wrapper object holding a PrimitiveToWorld AnimatedTransform, an
instance is a row of a small transform table. Intersection transforms the
whole ray wavefront into each instance's object space (unnormalized
direction, so tHit is measured in world units exactly as the reference's
`r.tMax` narrowing expects) and intersects the shared base mesh; results
combine with where-masks over the static instance loop. Supports per-
instance keyframe motion via utils.transform.AnimatedTransform — the
reference's `PrimitiveToWorld.Interpolate(r.time)` (Primitive.cpp:84)
becomes one batched matrix interpolate per instance.

Normals return to world space through the inverse-transpose, hit points
through the forward transform — same math as SurfaceInteraction's
Transform operator the reference applies at Primitive.cpp:95.
"""

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..constants import INFINITY
from ..utils import transform as tf
from ..utils.math import HIGHEST
from . import intersect

# number of instances is static (scene-build constant); the per-instance
# loop unrolls under jit


class InstanceTable(NamedTuple):
    obj_to_world: jnp.ndarray  # (I, 4, 4)
    world_to_obj: jnp.ndarray  # (I, 4, 4)
    # optional keyframe motion: end-of-shutter matrices (same as start when
    # static); interpolation is a lerp/slerp via make_animated wrapper
    animated: Optional[tuple] = None  # tuple of AnimatedTransform or None


def make_instances(matrices):
    """Build an InstanceTable from (I, 4, 4) object-to-world matrices."""
    m = np.asarray(matrices, np.float64)
    inv = np.linalg.inv(m)
    return InstanceTable(
        obj_to_world=jnp.asarray(m, jnp.float32),
        world_to_obj=jnp.asarray(inv, jnp.float32),
        animated=None,
    )


def make_animated_instances(m_start, m_end, t0=0.0, t1=1.0):
    """Instances with two-keyframe motion (TransformedPrimitive with an
    actually-animated PrimitiveToWorld)."""
    base = make_instances(m_start)
    ats = tuple(
        tf.make_animated_transform(np.asarray(m_start[i]), np.asarray(m_end[i]),
                                   t0, t1)
        for i in range(len(m_start))
    )
    return base._replace(animated=ats)


def _xform_ray(m, o, d):
    """Transform rays by a single 4x4 (or per-lane (N,4,4)). Direction is
    NOT renormalized so t parameterization is preserved."""
    if m.ndim == 2:
        o2 = jnp.matmul(o, m[:3, :3].T, precision=HIGHEST) + m[:3, 3]
        d2 = jnp.matmul(d, m[:3, :3].T, precision=HIGHEST)
    else:
        o2 = jnp.einsum("nij,nj->ni", m[..., :3, :3], o,
                        precision=HIGHEST) + m[..., :3, 3]
        d2 = jnp.einsum("nij,nj->ni", m[..., :3, :3], d, precision=HIGHEST)
    return o2, d2


class InstanceHit(NamedTuple):
    hit: jnp.ndarray       # (N,) bool
    t: jnp.ndarray         # (N,) world-space t
    tri: jnp.ndarray       # (N,) triangle id within the base mesh
    inst: jnp.ndarray      # (N,) instance id
    b: jnp.ndarray         # (N,3) barycentrics


def instanced_closest_hit(verts, tris, table: InstanceTable, o, d, t_max,
                          time=None, bvh=None):
    """Closest hit over all instances of the base mesh (the wavefront
    equivalent of TransformedPrimitive::Intersect, Primitive.cpp:80-97).
    With `bvh` (built over the base mesh) each instance walk uses packet
    traversal instead of brute force."""
    n = o.shape[0]
    n_inst = table.obj_to_world.shape[0]
    t_best = jnp.asarray(t_max, jnp.float32) * jnp.ones((n,), jnp.float32)
    hit = jnp.zeros((n,), bool)
    tri = jnp.zeros((n,), jnp.int32)
    inst = jnp.zeros((n,), jnp.int32)
    bary = jnp.zeros((n, 3), jnp.float32)
    for i in range(n_inst):
        if table.animated is not None and time is not None:
            w2o = jnp.linalg.inv(tf.interpolate(table.animated[i], time))
            oo, do = _xform_ray(w2o, o, d)
        else:
            oo, do = _xform_ray(table.world_to_obj[i], o, d)
        if bvh is not None:
            from .bvh import packet_closest_hit_xla
            th = packet_closest_hit_xla(bvh, oo, do, t_best)
        else:
            th = intersect.closest_triangle_hit(oo, do, t_best, verts, tris)
        better = th.hit & (th.t < t_best)
        t_best = jnp.where(better, th.t, t_best)
        hit = hit | better
        tri = jnp.where(better, th.tri, tri)
        inst = jnp.where(better, i, inst)
        bary = jnp.where(better[:, None], th.b, bary)
    return InstanceHit(hit=hit, t=jnp.where(hit, t_best, INFINITY), tri=tri,
                       inst=inst, b=bary)


def instanced_any_hit(verts, tris, table: InstanceTable, o, d, t_max,
                      time=None, bvh=None):
    """Occlusion query over all instances (TransformedPrimitive IntersectP)."""
    n = o.shape[0]
    occ = jnp.zeros((n,), bool)
    for i in range(table.obj_to_world.shape[0]):
        if table.animated is not None and time is not None:
            w2o = jnp.linalg.inv(tf.interpolate(table.animated[i], time))
            oo, do = _xform_ray(w2o, o, d)
        else:
            oo, do = _xform_ray(table.world_to_obj[i], o, d)
        if bvh is not None:
            from .bvh import packet_any_hit_xla
            occ = occ | packet_any_hit_xla(bvh, oo, do, t_max)
        else:
            occ = occ | intersect.any_triangle_hit(oo, do, t_max, verts, tris)
    return occ


def instance_hit_geometry(verts, tris, table: InstanceTable, h: InstanceHit,
                          time=None):
    """World-space hit point and geometric normal for an InstanceHit —
    the interaction transform-back of Primitive.cpp:95 (normals via the
    inverse-transpose)."""
    tv = tris[h.tri]
    p0 = verts[tv[:, 0]]
    p1 = verts[tv[:, 1]]
    p2 = verts[tv[:, 2]]
    p_obj = h.b[:, 0:1] * p0 + h.b[:, 1:2] * p1 + h.b[:, 2:3] * p2
    ng_obj = jnp.cross(p1 - p0, p2 - p0)
    if table.animated is not None and time is not None:
        o2w = jnp.stack([tf.interpolate(table.animated[i], time)
                         for i in range(table.obj_to_world.shape[0])])
        m = o2w[h.inst]
        w2o = jnp.linalg.inv(m)
    else:
        m = table.obj_to_world[h.inst]
        w2o = table.world_to_obj[h.inst]
    p_w = jnp.einsum("nij,nj->ni", m[:, :3, :3], p_obj,
                     precision=HIGHEST) + m[:, :3, 3]
    # normal transform: (M^-1)^T
    ng_w = jnp.einsum("nji,nj->ni", w2o[:, :3, :3], ng_obj,
                      precision=HIGHEST)
    ng_w = ng_w / jnp.maximum(
        jnp.linalg.norm(ng_w, axis=-1, keepdims=True), 1e-20
    )
    return p_w, ng_w
