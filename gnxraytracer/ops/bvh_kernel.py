"""GPU BVH traversal kernel (Pallas, Triton route): one ray per lane.

Each lane walks the per-octant ordered threaded BVH that ops/bvh.py builds
(first8/miss8 cursor links, fixed LEAF_SIZE leaf rows in leaf_soa) with a
single int32 cursor and no stack, the same automaton as the XLA reference
walks bvh_closest_hit_stackless / bvh_any_hit_stackless.  A program holds
BLOCK lanes and loops until every lane's cursor has run off the tree:
node and leaf rows arrive through gathered loads (they stay in L2 across
the programs of a cast), lanes that are not at a leaf mask their leaf
loads off, and dead lanes (t_max <= 0) start finished.

The leaf test is intersect._watertight_one, the same permute/shear/
zero-snapped edge-function test as brute force and the packet walk, so
the kernel's hit set is the reference's.  Rays are sampled detached
(README "Design notes"), so the kernel has no gradient of its own: its
inputs pass through stop_gradient and its outputs are constants to AD.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..constants import INFINITY
from .bvh import BVH, LEAF_SIZE
from .intersect import TriHit, _watertight_one

# Rays per program.  One warp (32 lanes) per program keeps the walk's
# divergence at warp granularity, like a hand-written CUDA traversal; on
# the H100 32 beat 64 and 128 (PERF.md).
BLOCK = 32
NUM_WARPS = 1

# rows of the packed (8, N) ray slab handed to the kernel
_OX, _OY, _OZ, _DX, _DY, _DZ, _TMAX = range(7)


def _ray_frame(dx, dy, dz):
    """Per-lane slab reciprocal, octant and watertight permute/shear
    (intersect._permute_shear without the argmax: kz is the first axis of
    largest |d|, exactly what argmax picks)."""
    def safe_inv(x):
        return 1.0 / jnp.where(jnp.abs(x) < 1e-20,
                               jnp.where(x < 0, -1e-20, 1e-20), x)

    adx, ady, adz = jnp.abs(dx), jnp.abs(dy), jnp.abs(dz)
    m0 = (adx >= ady) & (adx >= adz)
    m1 = ~m0 & (ady >= adz)
    pz = jnp.where(m0, dx, jnp.where(m1, dy, dz))
    px = jnp.where(m0, dy, jnp.where(m1, dz, dx))
    py = jnp.where(m0, dz, jnp.where(m1, dx, dy))
    octant = ((dx < 0).astype(jnp.int32) | ((dy < 0).astype(jnp.int32) << 1)
              | ((dz < 0).astype(jnp.int32) << 2))
    return ((safe_inv(dx), safe_inv(dy), safe_inv(dz)), octant,
            (m0, m1, -px / pz, -py / pz, 1.0 / pz))


def _walk_kernel(rays_ref, node_f_ref, node_i_ref, first_ref, miss_ref,
                 leaf_f_ref, leaf_id_ref, *out_refs, n_nodes, any_hit):
    ox, oy, oz = rays_ref[_OX, :], rays_ref[_OY, :], rays_ref[_OZ, :]
    dx, dy, dz = rays_ref[_DX, :], rays_ref[_DY, :], rays_ref[_DZ, :]
    t_max = rays_ref[_TMAX, :]
    (ix, iy, iz), octant, (m0, m1, sx, sy, sz) = _ray_frame(dx, dy, dz)
    link = octant * n_nodes
    b = ox.shape[0]

    def gather(ref, idx, mask=None):
        if mask is None:
            return ref[idx]
        return plgpu.load(ref.at[idx], mask=mask, other=0)

    def step(cursor, t_best):
        """Slab test of each active lane's node.  Returns (active, leaf:
        the box hit is a leaf, the lane's next cursor, the node's leaf
        row offset)."""
        active = cursor >= 0
        node = jnp.maximum(cursor, 0)
        nb = node * 6
        t0x = (gather(node_f_ref, nb) - ox) * ix
        t0y = (gather(node_f_ref, nb + 1) - oy) * iy
        t0z = (gather(node_f_ref, nb + 2) - oz) * iz
        t1x = (gather(node_f_ref, nb + 3) - ox) * ix
        t1y = (gather(node_f_ref, nb + 4) - oy) * iy
        t1z = (gather(node_f_ref, nb + 5) - oz) * iz
        tn = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                     jnp.minimum(t0y, t1y)),
                         jnp.minimum(t0z, t1z))
        tf = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                     jnp.maximum(t0y, t1y)),
                         jnp.maximum(t0z, t1z)) * (1.0 + 2.0 * 7.2e-7)
        hit = active & (tn <= tf) & (tf > 0) & (tn < t_best)
        offset = gather(node_i_ref, node * 2)
        n_prims = gather(node_i_ref, node * 2 + 1)
        leaf = hit & (n_prims > 0)
        inner = hit & (n_prims == 0)
        nxt = jnp.where(inner, gather(first_ref, link + node),
                        gather(miss_ref, link + node))
        return active, leaf, nxt, offset

    def leaf_row(row, leaf, t_best):
        r9 = row * 9
        q = [gather(leaf_f_ref, r9 + c, leaf) for c in range(9)]
        ids = gather(leaf_id_ref, row, leaf)
        valid, t, _b0, b1, b2 = _watertight_one(
            ox, oy, oz, m0, m1, sx, sy, sz, t_best,
            (q[0], q[1], q[2]), (q[3], q[4], q[5]), (q[6], q[7], q[8]))
        valid = valid & leaf & (ids >= 0) & (t < t_best)
        return valid, t, ids, b1, b2

    cursor0 = jnp.where(t_max > 0, 0, -1).astype(jnp.int32)
    max_steps = n_nodes + 1  # each node is entered at most once per lane

    if any_hit:
        (occ_ref,) = out_refs

        def cond(c):
            cursor, _occ, it = c
            return (jnp.max(cursor) >= 0) & (it < max_steps)

        def body(c):
            cursor, occ, it = c
            active, leaf, nxt, offset = step(cursor, t_max)
            for k in range(LEAF_SIZE):
                valid, _t, _ids, _b1, _b2 = leaf_row(offset + k, leaf, t_max)
                occ = occ | valid
            cursor = jnp.where(active, jnp.where(occ, -1, nxt), cursor)
            return cursor, occ, it + 1

        _, occ, _ = jax.lax.while_loop(
            cond, body, (cursor0, jnp.zeros((b,), jnp.bool_), jnp.int32(0)))
        occ_ref[...] = occ.astype(jnp.int32)
        return

    t_ref, prim_ref, uv_ref = out_refs

    def cond(c):
        return (jnp.max(c[0]) >= 0) & (c[-1] < max_steps)

    def body(c):
        cursor, t_best, prim, u, v, it = c
        active, leaf, nxt, offset = step(cursor, t_best)
        for k in range(LEAF_SIZE):
            valid, t, ids, b1, b2 = leaf_row(offset + k, leaf, t_best)
            t_best = jnp.where(valid, t, t_best)
            prim = jnp.where(valid, ids, prim)
            u = jnp.where(valid, b1, u)
            v = jnp.where(valid, b2, v)
        cursor = jnp.where(active, nxt, cursor)
        return cursor, t_best, prim, u, v, it + 1

    zeros = jnp.zeros((b,), jnp.float32)
    _, t_best, prim, u, v, _ = jax.lax.while_loop(
        cond, body, (cursor0, t_max, jnp.full((b,), -1, jnp.int32), zeros,
                     zeros, jnp.int32(0)))
    t_ref[...] = t_best
    prim_ref[...] = prim
    uv_ref[0, :] = u
    uv_ref[1, :] = v


def kernel_tables(bvh: BVH):
    """Flat device tables the kernel gathers from.  Trees built without
    per-octant links (hand-built tests) get the single DFS threading in
    all eight octant slots."""
    nn = bvh.offset.shape[0]
    if bvh.first8 is None:
        first = jnp.where(bvh.n_prims == 0, jnp.arange(1, nn + 1), bvh.miss)
        first8 = jnp.broadcast_to(first.astype(jnp.int32), (8, nn))
        miss8 = jnp.broadcast_to(bvh.miss, (8, nn))
    else:
        first8, miss8 = bvh.first8, bvh.miss8
    node_f = jnp.concatenate([bvh.bounds_lo, bvh.bounds_hi], axis=1)
    node_i = jnp.stack([bvh.offset, bvh.n_prims], axis=1)
    leaf_f = bvh.leaf_soa
    leaf_id = bvh.prim_idx
    if leaf_id.shape[0] == 0:  # leafless tree: keep gathers in bounds
        leaf_f = jnp.zeros((1, 9), jnp.float32)
        leaf_id = jnp.full((1,), -1, jnp.int32)
    return (node_f.reshape(-1), node_i.reshape(-1).astype(jnp.int32),
            first8.reshape(-1).astype(jnp.int32),
            miss8.reshape(-1).astype(jnp.int32),
            leaf_f.reshape(-1), leaf_id.astype(jnp.int32))


def _ray_slab(o, d, t_max, n_pad):
    """(8, n_pad) SoA ray slab; padding lanes are dead (t_max = 0)."""
    n = o.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    slab = jnp.concatenate([o.T, d.T, t_max[None], jnp.zeros((1, n))], 0)
    slab = jnp.pad(slab.astype(jnp.float32), ((0, 0), (0, n_pad - n)))
    return jax.lax.stop_gradient(slab)


def _default_interpret():
    return jax.default_backend() == "cpu"


@functools.partial(jax.jit, static_argnames=("any_hit", "interpret"))
def _walk(tables, slab, *, any_hit, interpret):
    n_pad = slab.shape[1]
    n_nodes = tables[2].shape[0] // 8
    ray_spec = pl.BlockSpec((8, BLOCK), lambda i: (0, i))
    lane_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    table_specs = [pl.BlockSpec(t.shape, lambda i: (0,)) for t in tables]
    if any_hit:
        out_shape = jax.ShapeDtypeStruct((n_pad,), jnp.int32)
        out_specs = lane_spec
    else:
        out_shape = (jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                     jax.ShapeDtypeStruct((n_pad,), jnp.int32),
                     jax.ShapeDtypeStruct((2, n_pad), jnp.float32))
        out_specs = (lane_spec, lane_spec,
                     pl.BlockSpec((2, BLOCK), lambda i: (0, i)))
    kernel = functools.partial(_walk_kernel, n_nodes=n_nodes, any_hit=any_hit)
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(n_pad // BLOCK,),
        in_specs=[ray_spec] + table_specs,
        out_specs=out_specs,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bvh_any_hit" if any_hit else "bvh_closest_hit",
    )(slab, *tables)


def _prepare(bvh, o, d, t_max):
    n = o.shape[0]
    n_pad = max(BLOCK, -(-n // BLOCK) * BLOCK)
    tables = jax.lax.stop_gradient(kernel_tables(bvh))
    return _ray_slab(jax.lax.stop_gradient(o), jax.lax.stop_gradient(d),
                     jax.lax.stop_gradient(t_max), n_pad), tables


def closest_hit(bvh: BVH, o, d, t_max, *, interpret=None):
    """Closest hit of N rays; TriHit with b = (1-u-v, u, v) like the
    packet walk.  interpret=None runs the kernel in interpret mode only on
    the CPU backend (tests)."""
    if interpret is None:
        interpret = _default_interpret()
    n = o.shape[0]
    slab, tables = _prepare(bvh, o, d, t_max)
    t, prim, uv = _walk(tables, slab, any_hit=False, interpret=interpret)
    t, prim, u, v = t[:n], prim[:n], uv[0, :n], uv[1, :n]
    hit = prim >= 0
    return TriHit(hit=hit, t=jnp.where(hit, t, INFINITY),
                  tri=jnp.maximum(prim, 0),
                  b=jnp.stack([1.0 - u - v, u, v], -1))


def any_hit(bvh: BVH, o, d, t_max, *, interpret=None):
    """Occlusion (IntersectP semantics): (N,) bool."""
    if interpret is None:
        interpret = _default_interpret()
    n = o.shape[0]
    slab, tables = _prepare(bvh, o, d, t_max)
    occ = _walk(tables, slab, any_hit=True, interpret=interpret)
    return occ[:n] > 0
