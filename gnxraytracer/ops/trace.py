"""Scene-level ray casting: closest-hit and any-hit over all primitive
types, plus surface-interaction construction.

Functional equivalent of Scene::Intersect / Scene::IntersectP +
SurfaceInteraction (/root/reference/core/Scene.cpp:12-24,
core/Interaction.h:96): a hit record is SoA arrays carrying prim ids; the
surface interaction gathers positions/normals/uv and builds the shading
frame, mirroring Triangle::Intersect's output fields
(shape/Triangle.cpp:228-300) without the per-hit heap objects.
"""

from typing import NamedTuple

import jax.numpy as jnp

from ..constants import INFINITY, gamma
from ..utils.math import (HIGHEST, coordinate_system, cross, dot,
                          face_forward, normalize)
from . import intersect

PRIM_NONE = -1
PRIM_TRI = 0
PRIM_SPH = 1
PRIM_INST = 2  # instanced base-mesh triangle; prim = inst * n_inst_tris + tri


class Hit(NamedTuple):
    hit: jnp.ndarray       # (N,) bool
    t: jnp.ndarray         # (N,)
    kind: jnp.ndarray      # (N,) int32: PRIM_TRI / PRIM_SPH (valid where hit)
    prim: jnp.ndarray      # (N,) int32 triangle or sphere index
    b: jnp.ndarray         # (N,3) triangle barycentrics


class Interaction(NamedTuple):
    p: jnp.ndarray         # (N,3) hit point
    p_err: jnp.ndarray     # (N,3) conservative position error bound
    ng: jnp.ndarray        # (N,3) geometric normal
    ns: jnp.ndarray        # (N,3) shading normal
    ss: jnp.ndarray        # (N,3) shading tangent (dpdu orthogonalized)
    ts: jnp.ndarray        # (N,3) shading bitangent
    uv: jnp.ndarray        # (N,2)
    wo: jnp.ndarray        # (N,3) world, toward viewer
    mat: jnp.ndarray       # (N,) int32 material id
    light: jnp.ndarray     # (N,) int32 area light id or -1


def scene_intersect(scene, cfg, o, d, t_max):
    """Closest hit across triangles and spheres."""
    n = o.shape[0]
    t_best = jnp.asarray(t_max, jnp.float32)
    if jnp.ndim(t_best) == 0:
        t_best = jnp.full((n,), t_best)
    hit = jnp.zeros((n,), bool)
    kind = jnp.full((n,), PRIM_NONE, jnp.int32)
    prim = jnp.zeros((n,), jnp.int32)
    bary = jnp.zeros((n, 3), jnp.float32)

    if cfg.n_tris > 0:
        if getattr(cfg, "n_big", 0) > 0 and cfg.use_bvh:
            # big-prim separation: a few huge triangles (e.g. the ground
            # plane) are brute-forced OUTSIDE the BVH — kept in the tree
            # they join every packet block's node-set union; tested first,
            # their hit t also caps the walk below
            bt = scene.geom.triangles[scene.big_tri_idx]
            bh = intersect.closest_triangle_hit(o, d, t_best,
                                                scene.geom.vertices, bt)
            better = bh.hit & (bh.t < t_best)
            t_best = jnp.where(better, bh.t, t_best)
            hit = hit | better
            kind = jnp.where(better, PRIM_TRI, kind)
            prim = jnp.where(better, scene.big_tri_idx[bh.tri], prim)
            bary = jnp.where(better[..., None], bh.b, bary)
        if cfg.use_bvh:
            mode = getattr(cfg, "bvh_mode", "packet")
            if not getattr(cfg, "bvh_stackless", True):
                mode = "stack"
            key = getattr(cfg, "sort_key", "oct_morton")
            if mode == "kernel":
                from .bvh_kernel import closest_hit

                th = closest_hit(scene.bvh, o, d, t_best)
            elif mode == "packet":
                from .bvh import packet_closest_hit_xla

                th = packet_closest_hit_xla(scene.bvh, o, d, t_best,
                                            sort_key=key)
            elif mode == "stackless":
                from .bvh import bvh_closest_hit_stackless

                th = bvh_closest_hit_stackless(scene.bvh, o, d, t_best)
            else:
                from .bvh import bvh_closest_hit

                th = bvh_closest_hit(scene.bvh, scene.geom.vertices,
                                     scene.geom.triangles, o, d, t_best)
        else:
            th = intersect.closest_triangle_hit(
                o, d, t_best, scene.geom.vertices, scene.geom.triangles
            )
        better = th.hit & (th.t < t_best)
        t_best = jnp.where(better, th.t, t_best)
        hit = hit | better
        kind = jnp.where(better, PRIM_TRI, kind)
        prim = jnp.where(better, th.tri, prim)
        bary = jnp.where(better[..., None], th.b, bary)

    if cfg.n_sphs > 0:
        sh = intersect.closest_sphere_hit(
            o, d, t_best, scene.geom.sph_center, scene.geom.sph_radius
        )
        better = sh.hit & (sh.t < t_best)
        t_best = jnp.where(better, sh.t, t_best)
        hit = hit | better
        kind = jnp.where(better, PRIM_SPH, kind)
        prim = jnp.where(better, sh.sph, prim)

    if getattr(cfg, "n_inst", 0) > 0:
        from . import instancing

        ig = scene.instanced
        table = instancing.InstanceTable(ig.obj_to_world, ig.world_to_obj)
        ih = instancing.instanced_closest_hit(ig.verts, ig.tris, table, o, d,
                                              t_best, bvh=ig.bvh)
        better = ih.hit & (ih.t < t_best)
        t_best = jnp.where(better, ih.t, t_best)
        hit = hit | better
        kind = jnp.where(better, PRIM_INST, kind)
        prim = jnp.where(better, ih.inst * cfg.n_inst_tris + ih.tri, prim)
        bary = jnp.where(better[..., None], ih.b, bary)

    return Hit(hit, jnp.where(hit, t_best, INFINITY), kind, prim, bary)


def scene_occluded(scene, cfg, o, d, t_max):
    """Any-hit (VisibilityTester::Unoccluded -> !IntersectP,
    core/Light.cpp:28-31)."""
    n = o.shape[0]
    occ = jnp.zeros((n,), bool)
    if cfg.n_tris > 0:
        if getattr(cfg, "n_big", 0) > 0 and cfg.use_bvh:
            bt = scene.geom.triangles[scene.big_tri_idx]
            occ = occ | intersect.any_triangle_hit(
                o, d, t_max, scene.geom.vertices, bt)
            # already-occluded lanes skip the walk (dead-lane sort key)
            t_max = jnp.where(occ, 0.0, jnp.asarray(t_max, jnp.float32)
                              * jnp.ones((n,), jnp.float32))
        if cfg.use_bvh:
            mode = getattr(cfg, "bvh_mode", "packet")
            if not getattr(cfg, "bvh_stackless", True):
                mode = "stack"
            key = getattr(cfg, "sort_key", "oct_morton")
            if mode == "kernel":
                from .bvh_kernel import any_hit

                occ = occ | any_hit(scene.bvh, o, d, t_max)
            elif mode == "packet":
                from .bvh import packet_any_hit_xla

                occ = occ | packet_any_hit_xla(scene.bvh, o, d, t_max,
                                               sort_key=key)
            elif mode == "stackless":
                from .bvh import bvh_any_hit_stackless

                occ = occ | bvh_any_hit_stackless(scene.bvh, o, d, t_max)
            else:
                from .bvh import bvh_any_hit

                occ = occ | bvh_any_hit(scene.bvh, scene.geom.vertices,
                                        scene.geom.triangles, o, d, t_max)
        else:
            occ = occ | intersect.any_triangle_hit(
                o, d, t_max, scene.geom.vertices, scene.geom.triangles
            )
    if cfg.n_sphs > 0:
        ok, _ = intersect.ray_spheres(o, d, t_max, scene.geom.sph_center,
                                      scene.geom.sph_radius)
        occ = occ | jnp.any(ok, axis=-1)
    if getattr(cfg, "n_inst", 0) > 0:
        from . import instancing

        ig = scene.instanced
        table = instancing.InstanceTable(ig.obj_to_world, ig.world_to_obj)
        occ = occ | instancing.instanced_any_hit(ig.verts, ig.tris, table,
                                                 o, d, t_max, bvh=ig.bvh)
    return occ


# Max triangle count for the one-hot-matmul attribute path: a (N, T)
# one-hot times (T, 26) table replaces ~10 per-lane gathers.  Whether it
# beats jnp.take on the GPU is not measured yet (ROADMAP A4).
ONEHOT_MAX_TRIS = 256


def _tri_attr_table(g):
    """Packed (T, 26) per-triangle attribute table:
    p0|p1|p2 (9), uv0|uv1|uv2 (6), n0|n1|n2 (9), mat (1), light (1).
    Loop-invariant inside jit — XLA hoists the build out of the bounce loop."""
    t = g.triangles
    cols = [g.vertices[t[:, 0]], g.vertices[t[:, 1]], g.vertices[t[:, 2]]]
    if g.uvs is not None:
        cols += [g.uvs[t[:, 0]], g.uvs[t[:, 1]], g.uvs[t[:, 2]]]
    else:
        nt = t.shape[0]
        cols += [jnp.zeros((nt, 2)),
                 jnp.broadcast_to(jnp.asarray([1.0, 0.0]), (nt, 2)),
                 jnp.broadcast_to(jnp.asarray([1.0, 1.0]), (nt, 2))]
    if g.normals is not None:
        cols += [g.normals[t[:, 0]], g.normals[t[:, 1]], g.normals[t[:, 2]]]
    else:
        cols += [jnp.zeros((t.shape[0], 3))] * 3
    cols += [g.tri_mat[:, None].astype(jnp.float32),
             g.tri_light[:, None].astype(jnp.float32)]
    return jnp.concatenate(cols, axis=1)


def onehot_gather(table, idx, n_rows):
    """Gather rows of a small (T, K) table by (N,) indices as a one-hot
    matmul instead of a per-lane gather.  HIGHEST precision: in TF32 the
    product would round the table's vertex positions to ~10 mantissa
    bits."""
    oh = (idx[:, None] == jnp.arange(n_rows)[None, :]).astype(jnp.float32)
    return jnp.dot(oh, table, precision=HIGHEST,
                   preferred_element_type=jnp.float32)


def tri_emission_attrs(scene, cfg, prim_idx):
    """(p0, p1, p2, light_id) of a triangle hit — the data the integrators
    need to evaluate emitted radiance at a BSDF-sampled hit. One-hot matmul
    for small scenes, gathers otherwise."""
    g = scene.geom
    if 0 < cfg.n_tris <= ONEHOT_MAX_TRIS:
        attrs = onehot_gather(_tri_attr_table(g), prim_idx, cfg.n_tris)
        return (attrs[:, 0:3], attrs[:, 3:6], attrs[:, 6:9],
                jnp.round(attrs[:, 25]).astype(jnp.int32))
    tri = g.triangles[prim_idx]
    return (g.vertices[tri[:, 0]], g.vertices[tri[:, 1]],
            g.vertices[tri[:, 2]], g.tri_light[prim_idx])


def tri_light_and_ng(scene, cfg, hit: Hit):
    """(light_id, ng) of a triangle hit — the ONLY Interaction fields the
    emission term reads.  Used by the pipelined loop to evaluate emission
    at full width without building the whole interaction there (the rest
    of the interaction is built post-compaction).  Matches
    make_interaction's ng exactly, including the shading-normal
    face_forward fixup."""
    g = scene.geom
    is_tri = hit.kind == PRIM_TRI
    tri_idx = jnp.where(is_tri, hit.prim, 0)
    if 0 < cfg.n_tris <= ONEHOT_MAX_TRIS:
        attrs = onehot_gather(_tri_attr_table(g), tri_idx, cfg.n_tris)
        p0, p1, p2 = attrs[:, 0:3], attrs[:, 3:6], attrs[:, 6:9]
        light = jnp.round(attrs[:, 25]).astype(jnp.int32)
        n0, n1, n2 = attrs[:, 15:18], attrs[:, 18:21], attrs[:, 21:24]
        has_normals = g.normals is not None
    else:
        tri = g.triangles[tri_idx]
        p0 = g.vertices[tri[:, 0]]
        p1 = g.vertices[tri[:, 1]]
        p2 = g.vertices[tri[:, 2]]
        light = g.tri_light[tri_idx]
        has_normals = g.normals is not None
        if has_normals:
            n0 = g.normals[tri[:, 0]]
            n1 = g.normals[tri[:, 1]]
            n2 = g.normals[tri[:, 2]]
    ng = normalize(cross(p0 - p2, p1 - p2))
    if has_normals:
        b = hit.b
        ns = normalize(b[:, 0:1] * n0 + b[:, 1:2] * n1 + b[:, 2:3] * n2,
                       eps=1e-20)
        degen = jnp.sum(ns * ns, axis=-1) < 0.5
        ns = jnp.where(degen[:, None], ng, ns)
        ng = face_forward(ng, ns)
    return jnp.where(is_tri, light, -1), ng


def make_interaction(scene, cfg, o, d, hit: Hit) -> Interaction:
    """Build the surface interaction for each (possibly invalid) lane."""
    g = scene.geom
    is_tri = hit.kind == PRIM_TRI
    tri_idx = jnp.where(is_tri, hit.prim, 0)
    if 0 < cfg.n_tris <= ONEHOT_MAX_TRIS:
        attrs = onehot_gather(_tri_attr_table(g), tri_idx, cfg.n_tris)
        return _interaction_from_attrs(scene, cfg, o, d, hit, attrs)
    tri = g.triangles[tri_idx]
    p0 = g.vertices[tri[:, 0]]
    p1 = g.vertices[tri[:, 1]]
    p2 = g.vertices[tri[:, 2]]
    b = hit.b
    # Triangle hit point from barycentrics (Triangle.cpp: pHit = b0 p0 + ...)
    p_tri = b[:, 0:1] * p0 + b[:, 1:2] * p1 + b[:, 2:3] * p2
    # error bound pError = gamma(7) * sum |bi pi| (Triangle.cpp:224)
    p_err_tri = gamma(7) * (
        jnp.abs(b[:, 0:1] * p0) + jnp.abs(b[:, 1:2] * p1) + jnp.abs(b[:, 2:3] * p2)
    )
    ng_tri = normalize(cross(p0 - p2, p1 - p2))
    dpdu_tri = p1 - p0  # default UVs (0,0),(1,0),(1,1) -> dpdu = p1 - p0
    if g.uvs is not None:
        uv0 = g.uvs[tri[:, 0]]
        uv1 = g.uvs[tri[:, 1]]
        uv2 = g.uvs[tri[:, 2]]
        duv02 = uv0 - uv2
        duv12 = uv1 - uv2
        det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
        inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        dp02 = p0 - p2
        dp12 = p1 - p2
        dpdu_uv = (duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12) * inv[:, None]
        dpdu_tri = jnp.where((jnp.abs(det) > 1e-12)[:, None], dpdu_uv, dpdu_tri)
        uv_tri = b[:, 0:1] * uv0 + b[:, 1:2] * uv1 + b[:, 2:3] * uv2
    else:
        # default UVs: uv = b0*(0,0) + b1*(1,0) + b2*(1,1)
        uv_tri = jnp.stack([b[:, 1] + b[:, 2], b[:, 2]], axis=-1)
    if g.normals is not None:
        n0 = g.normals[tri[:, 0]]
        n1 = g.normals[tri[:, 1]]
        n2 = g.normals[tri[:, 2]]
        ns_tri = normalize(b[:, 0:1] * n0 + b[:, 1:2] * n1 + b[:, 2:3] * n2, eps=1e-20)
        degen = jnp.sum(ns_tri * ns_tri, axis=-1) < 0.5
        ns_tri = jnp.where(degen[:, None], ng_tri, ns_tri)
        # align ng with ns hemisphere (Triangle.cpp shading-geometry fixup)
        ng_tri = face_forward(ng_tri, ns_tri)
    else:
        ns_tri = ng_tri
    mat_tri = g.tri_mat[tri_idx]
    light_tri = g.tri_light[tri_idx]
    return _finish_interaction(scene, cfg, o, d, hit, p_tri, p_err_tri,
                               ng_tri, ns_tri, dpdu_tri, uv_tri, mat_tri,
                               light_tri)


def _interaction_from_attrs(scene, cfg, o, d, hit: Hit, attrs):
    """Triangle interaction from the packed one-hot-matmul attribute row
    (same math as the gather path, operating on (N, 26) columns)."""
    g = scene.geom
    b = hit.b
    p0 = attrs[:, 0:3]
    p1 = attrs[:, 3:6]
    p2 = attrs[:, 6:9]
    p_tri = b[:, 0:1] * p0 + b[:, 1:2] * p1 + b[:, 2:3] * p2
    p_err_tri = gamma(7) * (
        jnp.abs(b[:, 0:1] * p0) + jnp.abs(b[:, 1:2] * p1) + jnp.abs(b[:, 2:3] * p2)
    )
    ng_tri = normalize(cross(p0 - p2, p1 - p2))
    dpdu_tri = p1 - p0
    uv0 = attrs[:, 9:11]
    uv1 = attrs[:, 11:13]
    uv2 = attrs[:, 13:15]
    if g.uvs is not None:
        duv02 = uv0 - uv2
        duv12 = uv1 - uv2
        det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
        inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        dp02 = p0 - p2
        dp12 = p1 - p2
        dpdu_uv = (duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12) * inv[:, None]
        dpdu_tri = jnp.where((jnp.abs(det) > 1e-12)[:, None], dpdu_uv, dpdu_tri)
    uv_tri = b[:, 0:1] * uv0 + b[:, 1:2] * uv1 + b[:, 2:3] * uv2
    if g.normals is not None:
        n0 = attrs[:, 15:18]
        n1 = attrs[:, 18:21]
        n2 = attrs[:, 21:24]
        ns_tri = normalize(b[:, 0:1] * n0 + b[:, 1:2] * n1 + b[:, 2:3] * n2,
                           eps=1e-20)
        degen = jnp.sum(ns_tri * ns_tri, axis=-1) < 0.5
        ns_tri = jnp.where(degen[:, None], ng_tri, ns_tri)
        ng_tri = face_forward(ng_tri, ns_tri)
    else:
        ns_tri = ng_tri
    # ids round-trip exactly through the f32 matmul (one-hot is exact 0/1,
    # small ints are exact in bf16/f32); round defensively anyway
    mat_tri = jnp.round(attrs[:, 24]).astype(jnp.int32)
    light_tri = jnp.round(attrs[:, 25]).astype(jnp.int32)
    return _finish_interaction(scene, cfg, o, d, hit, p_tri, p_err_tri,
                               ng_tri, ns_tri, dpdu_tri, uv_tri, mat_tri,
                               light_tri)


def _instanced_intermediates(scene, cfg, hit: Hit):
    """Triangle interaction intermediates for instance-hit lanes: the base
    triangle's vertices/normals are transformed to world per lane (gathering
    the (I,4,4) tables), then the standard world-space triangle formulas
    apply — bit-equivalent to intersecting a flattened copy, which is the
    semantics of TransformedPrimitive::Intersect's interaction transform-back
    (core/Primitive.cpp:95)."""
    ig = scene.instanced
    is_inst = hit.kind == PRIM_INST
    code = jnp.where(is_inst, hit.prim, 0)
    inst = code // cfg.n_inst_tris
    tidx = code % cfg.n_inst_tris
    m = ig.obj_to_world[inst]        # (N,4,4)
    w2o = ig.world_to_obj[inst]
    tv = ig.tris[tidx]

    def to_world_p(p):
        return jnp.einsum("nij,nj->ni", m[:, :3, :3], p,
                          precision=HIGHEST) + m[:, :3, 3]

    p0 = to_world_p(ig.verts[tv[:, 0]])
    p1 = to_world_p(ig.verts[tv[:, 1]])
    p2 = to_world_p(ig.verts[tv[:, 2]])
    b = hit.b
    p = b[:, 0:1] * p0 + b[:, 1:2] * p1 + b[:, 2:3] * p2
    p_err = gamma(7) * (
        jnp.abs(b[:, 0:1] * p0) + jnp.abs(b[:, 1:2] * p1) + jnp.abs(b[:, 2:3] * p2)
    )
    ng = normalize(cross(p0 - p2, p1 - p2))
    dpdu = p1 - p0
    if ig.uvs is not None:
        uv0, uv1, uv2 = ig.uvs[tv[:, 0]], ig.uvs[tv[:, 1]], ig.uvs[tv[:, 2]]
        duv02 = uv0 - uv2
        duv12 = uv1 - uv2
        det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
        inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        dpdu_uv = (duv12[:, 1:2] * (p0 - p2) - duv02[:, 1:2] * (p1 - p2)) * inv[:, None]
        dpdu = jnp.where((jnp.abs(det) > 1e-12)[:, None], dpdu_uv, dpdu)
        uv = b[:, 0:1] * uv0 + b[:, 1:2] * uv1 + b[:, 2:3] * uv2
    else:
        uv = jnp.stack([b[:, 1] + b[:, 2], b[:, 2]], axis=-1)
    if ig.normals is not None:
        # normals through the inverse-transpose (Primitive.cpp:95 semantics)
        def to_world_n(nv):
            return jnp.einsum("nji,nj->ni", w2o[:, :3, :3], nv,
                              precision=HIGHEST)

        ns = normalize(
            b[:, 0:1] * to_world_n(ig.normals[tv[:, 0]])
            + b[:, 1:2] * to_world_n(ig.normals[tv[:, 1]])
            + b[:, 2:3] * to_world_n(ig.normals[tv[:, 2]]), eps=1e-20)
        degen = jnp.sum(ns * ns, axis=-1) < 0.5
        ns = jnp.where(degen[:, None], ng, ns)
        ng = face_forward(ng, ns)
    else:
        ns = ng
    over = ig.inst_mat[inst]
    mat = jnp.where(over >= 0, over, ig.tri_mat[tidx])
    light = jnp.full_like(mat, -1)  # instances carry no area light (like the
    # reference, where TransformedPrimitive::GetAreaLight is never an emitter)
    return p, p_err, ng, ns, dpdu, uv, mat, light


def _finish_interaction(scene, cfg, o, d, hit, p_tri, p_err_tri, ng_tri,
                        ns_tri, dpdu_tri, uv_tri, mat_tri, light_tri):
    g = scene.geom
    if getattr(cfg, "n_inst", 0) > 0:
        (p_i, pe_i, ng_i, ns_i, dpdu_i, uv_i, mat_i,
         light_i) = _instanced_intermediates(scene, cfg, hit)
        im = (hit.kind == PRIM_INST)
        imc = im[:, None]
        p_tri = jnp.where(imc, p_i, p_tri)
        p_err_tri = jnp.where(imc, pe_i, p_err_tri)
        ng_tri = jnp.where(imc, ng_i, ng_tri)
        ns_tri = jnp.where(imc, ns_i, ns_tri)
        dpdu_tri = jnp.where(imc, dpdu_i, dpdu_tri)
        uv_tri = jnp.where(imc, uv_i, uv_tri)
        mat_tri = jnp.where(im, mat_i, mat_tri)
        light_tri = jnp.where(im, light_i, light_tri)
    if cfg.n_sphs > 0:
        is_sph = hit.kind == PRIM_SPH
        sph_idx = jnp.where(is_sph, hit.prim, 0)
        c = g.sph_center[sph_idx]
        r = g.sph_radius[sph_idx]
        p_s = o + hit.t[:, None] * d
        # reproject onto the sphere (pbrt sphere hit refinement)
        rel = p_s - c
        rel = rel * (r / jnp.maximum(jnp.sqrt(jnp.sum(rel * rel, -1)), 1e-12))[:, None]
        p_sph = c + rel
        ng_sph = normalize(rel)
        # spherical uv + dpdu = (-y, x, 0) * 2pi
        phi = jnp.arctan2(rel[:, 1], rel[:, 0])
        phi = jnp.where(phi < 0, phi + 2 * jnp.pi, phi)
        theta = jnp.arccos(jnp.clip(rel[:, 2] / jnp.maximum(r, 1e-12), -1.0, 1.0))
        uv_sph = jnp.stack([phi / (2 * jnp.pi), theta / jnp.pi], axis=-1)
        dpdu_sph = jnp.stack([-rel[:, 1], rel[:, 0], jnp.zeros_like(r)], axis=-1)
        p_err_sph = gamma(5) * jnp.abs(p_sph)
        mat_sph = g.sph_mat[sph_idx]
        light_sph = g.sph_light[sph_idx]

        pick = is_sph[:, None]
        p = jnp.where(pick, p_sph, p_tri)
        p_err = jnp.where(pick, p_err_sph, p_err_tri)
        ng = jnp.where(pick, ng_sph, ng_tri)
        ns = jnp.where(pick, ng_sph, ns_tri)
        dpdu = jnp.where(pick, dpdu_sph, dpdu_tri)
        uv = jnp.where(pick, uv_sph, uv_tri)
        mat = jnp.where(is_sph, mat_sph, mat_tri)
        light = jnp.where(is_sph, light_sph, light_tri)
    else:
        p, p_err, ng, ns, dpdu, uv, mat, light = (
            p_tri, p_err_tri, ng_tri, ns_tri, dpdu_tri, uv_tri, mat_tri, light_tri
        )

    # bump mapping (Material::Bump, core/Material.cpp:16): displace the
    # shading normal by forward differences of a height texture in uv
    if getattr(cfg, "has_bump", False) and scene.textures is not None:
        from .texture import bilinear_lookup

        atlas, offs, sizes = scene.textures
        b_tex = scene.materials.bump_tex[jnp.maximum(mat, 0)]
        b_scale = scene.materials.bump_scale[jnp.maximum(mat, 0)]
        has_b = b_tex >= 0
        tid = jnp.maximum(b_tex, 0)
        du = 0.5 / sizes[0].astype(jnp.float32)
        h0 = bilinear_lookup(atlas, offs, sizes, tid, uv)[..., 0]
        hu = bilinear_lookup(atlas, offs, sizes, tid,
                             uv + jnp.asarray([1.0, 0.0]) * du)[..., 0]
        hv = bilinear_lookup(atlas, offs, sizes, tid,
                             uv + jnp.asarray([0.0, 1.0]) * du)[..., 0]
        dhdu = (hu - h0) / du * b_scale
        dhdv = (hv - h0) / du * b_scale
        # perturbed frame: dpdu' = dpdu + dh/du * ns ; dpdv from ts
        ts0 = cross(ns, normalize(dpdu, eps=1e-20))
        dpdu_b = dpdu + dhdu[:, None] * ns
        dpdv_b = ts0 + dhdv[:, None] * ns
        ns_b = normalize(cross(dpdu_b, dpdv_b), eps=1e-20)
        ns_b = face_forward(ns_b, ns)
        ns = jnp.where(has_b[:, None], ns_b, ns)
        dpdu = jnp.where(has_b[:, None], dpdu_b, dpdu)

    # shading frame: ss = normalized dpdu orthogonalized against ns
    ss = dpdu - ns * jnp.sum(ns * dpdu, axis=-1, keepdims=True)
    len2 = jnp.sum(ss * ss, axis=-1)
    ss_cs, _ = coordinate_system(ns)
    ss = jnp.where((len2 > 1e-12)[:, None], ss * jax_rsqrt(len2)[:, None], ss_cs)
    ts = cross(ns, ss)

    return Interaction(
        p=p, p_err=p_err, ng=ng, ns=ns, ss=ss, ts=ts, uv=uv,
        wo=normalize(-d), mat=mat, light=light,
    )


def jax_rsqrt(x):
    return 1.0 / jnp.sqrt(jnp.maximum(x, 1e-24))


def triangle_dpduv(scene, hit: Hit):
    """Parametric partials dpdu/dpdv of the hit triangle from its UV chart
    (Triangle::Intersect, shape/Triangle.cpp:180-227 region)."""
    g = scene.geom
    tri_idx = jnp.where(hit.kind == PRIM_TRI, hit.prim, 0)
    tri = g.triangles[tri_idx]
    p0 = g.vertices[tri[:, 0]]
    p1 = g.vertices[tri[:, 1]]
    p2 = g.vertices[tri[:, 2]]
    if g.uvs is not None:
        uv0, uv1, uv2 = g.uvs[tri[:, 0]], g.uvs[tri[:, 1]], g.uvs[tri[:, 2]]
    else:
        uv0 = jnp.zeros((tri.shape[0], 2))
        uv1 = jnp.broadcast_to(jnp.asarray([1.0, 0.0]), uv0.shape)
        uv2 = jnp.broadcast_to(jnp.asarray([1.0, 1.0]), uv0.shape)
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    dp02 = p0 - p2
    dp12 = p1 - p2
    det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
    inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)[:, None]
    dpdu = (duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12) * inv
    dpdv = (-duv12[:, 0:1] * dp02 + duv02[:, 0:1] * dp12) * inv
    # degenerate chart: orthonormal fallback (Triangle.cpp CoordinateSystem)
    ng = normalize(cross(dp02, dp12), eps=1e-20)
    fb_u, fb_v = coordinate_system(ng)
    bad = (jnp.abs(det) <= 1e-12)[:, None]
    return jnp.where(bad, fb_u, dpdu), jnp.where(bad, fb_v, dpdv)


def compute_differentials(p, n, dpdu, dpdv, rd, return_dp=False):
    """SurfaceInteraction::ComputeDifferentials
    (core/Interaction.cpp:65-114): intersect the two auxiliary rays with
    the tangent plane, then solve the 2x2 system for (du,dv) per axis.

    rd: camera.RayDifferentials. Returns (duvdx (N,2), duvdy (N,2)); with
    return_dp also (dpdx (N,3), dpdy (N,3)) — the surface footprint the
    specular differential propagation (whitted) spawns its auxiliary
    origins from (core/Integrator.cpp:339-340 `isect.p + isect.dpdx`).
    """
    d_plane = dot(n, p)

    def aux(o_a, d_a):
        denom = dot(n, d_a)
        t = -(dot(n, o_a) - d_plane) / jnp.where(jnp.abs(denom) < 1e-9,
                                                 jnp.where(denom < 0, -1e-9, 1e-9),
                                                 denom)
        ok = jnp.abs(denom) >= 1e-9
        return o_a + t[:, None] * d_a, ok

    px, okx = aux(rd.rx_o, rd.rx_d)
    py, oky = aux(rd.ry_o, rd.ry_d)
    dpdx = px - p
    dpdy = py - p

    # choose the two coordinate dims where |n| is smallest
    an = jnp.abs(n)
    use_yz = (an[:, 0] > an[:, 1]) & (an[:, 0] > an[:, 2])
    use_xz = ~use_yz & (an[:, 1] > an[:, 2])

    def pick2(v):
        a = jnp.where(use_yz, v[:, 1], v[:, 0])
        b = jnp.where(use_yz | use_xz, v[:, 2], v[:, 1])
        return a, b

    a00, a10 = pick2(dpdu)
    a01, a11 = pick2(dpdv)
    det = a00 * a11 - a01 * a10
    inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)

    def solve(b):
        b0, b1 = pick2(b)
        du = (a11 * b0 - a01 * b1) * inv
        dv = (a00 * b1 - a10 * b0) * inv
        return jnp.stack([du, dv], -1)

    duvdx = jnp.where(okx[:, None], solve(dpdx), 0.0)
    duvdy = jnp.where(oky[:, None], solve(dpdy), 0.0)
    if return_dp:
        return duvdx, duvdy, jnp.where(okx[:, None], dpdx, 0.0), \
            jnp.where(oky[:, None], dpdy, 0.0)
    return duvdx, duvdy


def to_local(it: Interaction, v):
    """World -> shading frame (BSDF::WorldToLocal, Reflection.h:116)."""
    return jnp.stack([dot(v, it.ss), dot(v, it.ts), dot(v, it.ns)], axis=-1)


def to_world(it: Interaction, v):
    return (
        v[..., 0:1] * it.ss + v[..., 1:2] * it.ts + v[..., 2:3] * it.ns
    )


def offset_ray_origin(p, p_err, ng, w):
    """Robust ray-origin offset (core/Geometry.h OffsetRayOrigin): move
    along ng by the projected error bound, toward the side of w."""
    d = jnp.sum(jnp.abs(ng) * p_err, axis=-1, keepdims=True) + 1e-5
    offset = d * ng
    offset = jnp.where(jnp.sum(w * ng, axis=-1, keepdims=True) < 0, -offset, offset)
    return p + offset


def spawn_ray(it: Interaction, w):
    return offset_ray_origin(it.p, it.p_err, it.ng, w), w


def shadow_ray(it: Interaction, target, is_infinite):
    """Ray toward a light sample point; returns (o, d_unit, t_max)."""
    o = offset_ray_origin(it.p, it.p_err, it.ng, target - it.p)
    to_t = target - o
    dist = jnp.sqrt(jnp.maximum(jnp.sum(to_t * to_t, -1), 1e-20))
    d = to_t / dist[:, None]
    t_max = jnp.where(is_infinite, INFINITY, dist * (1.0 - 1e-3))
    return o, d, t_max
