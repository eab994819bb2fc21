"""The GPU BVH traversal kernel (ops/bvh_kernel.py) against the XLA walks
and brute force (the kernel in Pallas interpret mode on the CPU), the
wrapper's padding and shapes, the per-platform choice of BVH walk, AD
through the kernel route, and the pinned matmul precision of the device
path.  Tests marked `gpu` run the compiled kernel on the card; they skip
elsewhere (chip_smoke.py runs them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gnxraytracer.constants import INFINITY
from gnxraytracer.ops import bvh as bvh_mod
from gnxraytracer.ops import bvh_kernel, intersect

RAY_KINDS = ("camera", "bounce", "shadow", "dead", "ragged")


def _blob_and_soup(seed=0):
    """A small displaced blob (shared edges, coherent surface) plus a
    random triangle soup around it (overlaps, incoherent depth order)."""
    from gnxraytracer.scene.loaders import make_blob_mesh

    v, t, _n, _uv = make_blob_mesh(12)
    rs = np.random.RandomState(seed)
    soup = (rs.randn(60 * 3, 3) * 1.5).astype(np.float32)
    soup_t = (np.arange(60 * 3).reshape(60, 3) + len(v)).astype(np.int32)
    verts = np.concatenate([np.asarray(v, np.float32), soup])
    tris = np.concatenate([np.asarray(t, np.int32), soup_t])
    return verts, tris


def _rays(kind, verts, tris, seed=1):
    """(o, d, t_max) numpy rays of one kind."""
    rs = np.random.RandomState(seed)
    n = 37 if kind == "ragged" else 96
    if kind == "camera":
        # pinhole: one origin, directions through a small image plane
        o = np.broadcast_to(np.array([0.3, 0.5, 6.0], np.float32), (n, 3))
        px = rs.rand(n, 2).astype(np.float32) * 2.0 - 1.0
        d = np.concatenate([px, -np.full((n, 1), 2.5, np.float32)], 1)
    else:
        o = (rs.randn(n, 3) * 2.0).astype(np.float32)
        d = rs.randn(n, 3).astype(np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, 1e30, np.float32)
    if kind == "shadow":
        ref = intersect.closest_triangle_hit(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
            jnp.asarray(verts), jnp.asarray(tris))
        # half the lanes stop just short of their first hit, half beyond
        t_hit = np.where(np.asarray(ref.hit), np.asarray(ref.t), 3.0)
        t_max = np.where(np.arange(n) % 2 == 0, 0.999 * t_hit,
                         1.5 * t_hit).astype(np.float32)
    if kind == "dead":
        t_max[::3] = 0.0
    return (np.ascontiguousarray(o), d.astype(np.float32),
            t_max.astype(np.float32))


@pytest.fixture(scope="module")
def scene_tree():
    verts, tris = _blob_and_soup()
    return verts, tris, bvh_mod.build_bvh(verts, tris)


def _same_hits(got, ref, n):
    gh, rh = np.asarray(got.hit), np.asarray(ref.hit)
    assert gh.shape == (n,) and np.asarray(got.b).shape == (n, 3)
    np.testing.assert_array_equal(gh, rh)
    np.testing.assert_array_equal(np.asarray(got.tri)[rh],
                                  np.asarray(ref.tri)[rh])
    np.testing.assert_allclose(np.asarray(got.t)[rh], np.asarray(ref.t)[rh],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.b)[rh], np.asarray(ref.b)[rh],
                               atol=1e-5)


@pytest.mark.parametrize("reference", ["brute_force", "stackless"])
@pytest.mark.parametrize("kind", RAY_KINDS)
def test_closest_hit_matches(scene_tree, kind, reference):
    verts, tris, tree = scene_tree
    o, d, t_max = (jnp.asarray(x) for x in _rays(kind, verts, tris))
    got = bvh_kernel.closest_hit(tree, o, d, t_max, interpret=True)
    if reference == "brute_force":
        ref = intersect.closest_triangle_hit(o, d, t_max, jnp.asarray(verts),
                                             jnp.asarray(tris))
    else:
        ref = bvh_mod.bvh_closest_hit_stackless(tree, o, d, t_max)
    assert np.asarray(ref.hit).any()
    _same_hits(got, ref, o.shape[0])
    if kind == "dead":
        assert not np.asarray(got.hit)[::3].any()


@pytest.mark.parametrize("kind", RAY_KINDS)
def test_any_hit_matches(scene_tree, kind):
    verts, tris, tree = scene_tree
    o, d, t_max = (jnp.asarray(x) for x in _rays(kind, verts, tris))
    got = np.asarray(bvh_kernel.any_hit(tree, o, d, t_max, interpret=True))
    brute = np.asarray(intersect.any_triangle_hit(
        o, d, t_max, jnp.asarray(verts), jnp.asarray(tris)))
    walk = np.asarray(bvh_mod.bvh_any_hit_stackless(tree, o, d, t_max))
    assert got.shape == (o.shape[0],) and got.dtype == bool
    np.testing.assert_array_equal(got, brute)
    np.testing.assert_array_equal(got, walk)
    if kind == "shadow":
        # lanes stopping short of their first hit are never occluded
        assert got.any() and not got[::2].any()


class TestWatertightLeaf:
    """The kernel's leaf test is the watertight one: rays aimed exactly at
    the shared diagonal of a two-triangle quad must all hit (plain
    Moller-Trumbore leaks ~20% of them through the edge)."""

    def _edge_targets(self, n=500):
        verts = np.asarray([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                            [0.0, 1.0, 0.0], [1.0, 1.0, 0.0]], np.float32)
        tris = np.asarray([[0, 1, 2], [1, 3, 2]], np.int32)
        s = np.random.RandomState(1).rand(n).astype(np.float32)
        targets = np.stack([s, 1 - s, np.zeros_like(s)], -1)
        o = np.broadcast_to(np.asarray([0.3, 0.3, 5.0], np.float32), (n, 3))
        d = targets - o
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        return verts, tris, jnp.asarray(o), jnp.asarray(d)

    def test_shared_edge_no_leak_closest(self):
        verts, tris, o, d = self._edge_targets()
        th = bvh_kernel.closest_hit(bvh_mod.build_bvh(verts, tris), o, d,
                                    1e30, interpret=True)
        assert bool(np.asarray(th.hit).all()), (
            f"{int((~np.asarray(th.hit)).sum())}/500 rays leaked through "
            "the shared edge")

    def test_shared_edge_no_leak_anyhit(self):
        verts, tris, o, d = self._edge_targets()
        occ = bvh_kernel.any_hit(bvh_mod.build_bvh(verts, tris), o, d, 1e30,
                                 interpret=True)
        assert bool(np.asarray(occ).all())

    def test_hit_set_matches_brute_force(self):
        verts, tris, o, d = self._edge_targets()
        th = bvh_kernel.closest_hit(bvh_mod.build_bvh(verts, tris), o, d,
                                    1e30, interpret=True)
        ref = intersect.closest_triangle_hit(
            o, d, jnp.full(500, 1e30, jnp.float32), jnp.asarray(verts),
            jnp.asarray(tris))
        np.testing.assert_array_equal(np.asarray(th.hit), np.asarray(ref.hit))
        np.testing.assert_allclose(np.asarray(th.t), np.asarray(ref.t),
                                   rtol=1e-5)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 70])
def test_wrapper_pads_and_slices(scene_tree, n):
    """Ragged ray counts pad to whole blocks of dead lanes and come back at
    their own length; a scalar t_max broadcasts."""
    verts, tris, tree = scene_tree
    o, d, _ = _rays("bounce", verts, tris, seed=n)
    o, d = jnp.asarray(o[:n]), jnp.asarray(d[:n])
    blk = bvh_kernel.BLOCK
    n_pad = -(-n // blk) * blk
    slab = bvh_kernel._ray_slab(o, d, 1e30, n_pad)
    assert slab.shape == (8, n_pad)
    assert not np.asarray(slab[6, n:]).any()  # padding lanes are dead
    th = bvh_kernel.closest_hit(tree, o, d, 1e30, interpret=True)
    assert th.t.shape == (n,) and th.tri.shape == (n,)
    assert th.b.shape == (n, 3) and th.hit.dtype == bool
    np.testing.assert_array_equal(
        np.asarray(th.t) < INFINITY, np.asarray(th.hit))
    occ = bvh_kernel.any_hit(tree, o, d, 1e30, interpret=True)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(th.hit))


def test_tables_without_octant_links(scene_tree):
    """A tree without first8/miss8 walks the single DFS threading in every
    octant slot and still finds the brute-force hits."""
    verts, tris, tree = scene_tree
    bare = tree._replace(first8=None, miss8=None)
    node_f, node_i, first, miss, leaf_f, leaf_id = bvh_kernel.kernel_tables(
        bare)
    nn = tree.offset.shape[0]
    assert first.shape == miss.shape == (8 * nn,)
    assert node_f.shape == (6 * nn,) and node_i.shape == (2 * nn,)
    assert leaf_f.shape == (9 * leaf_id.shape[0],)
    o, d, t_max = (jnp.asarray(x) for x in _rays("bounce", verts, tris))
    ref = intersect.closest_triangle_hit(o, d, t_max, jnp.asarray(verts),
                                         jnp.asarray(tris))
    _same_hits(bvh_kernel.closest_hit(bare, o, d, t_max, interpret=True),
               ref, o.shape[0])


@pytest.mark.parametrize("any_hit", [False, True])
def test_lowers_for_cuda(scene_tree, any_hit):
    """The kernel lowers through Pallas's Triton route for the CUDA
    platform (no card needed): catches primitives that route cannot
    lower before they reach the card."""
    _, _, tree = scene_tree
    fn = bvh_kernel.any_hit if any_hit else bvh_kernel.closest_hit
    o = jnp.zeros((100, 3), jnp.float32)
    d = jnp.ones((100, 3), jnp.float32)
    low = jax.jit(lambda o, d: fn(tree, o, d, 1e30, interpret=False)).trace(
        o, d).lower(lowering_platforms=("cuda",))
    assert "__gpu$xla.gpu.triton" in low.as_text()


@pytest.mark.parametrize("platform,mode", [("gpu", "kernel"),
                                           ("cpu", "packet"),
                                           ("tpu", None), ("rocm", None)])
def test_default_bvh_mode_per_platform(platform, mode):
    from gnxraytracer.models.integrators import path

    if mode is None:
        with pytest.raises(ValueError, match="no BVH walk"):
            path.default_bvh_mode(platform)
    else:
        assert path.default_bvh_mode(platform) == mode


def test_make_config_picks_walk_for_backend():
    from gnxraytracer.models.integrators import path
    from gnxraytracer.scene import presets

    scene, _ = presets.envmap_mesh(8, 8, mesh_tris=60)
    cfg = path.make_config(scene, 8, 8, spp=1, use_bvh=True)
    assert cfg.bvh_mode == path.default_bvh_mode(jax.default_backend())
    forced = path.make_config(scene, 8, 8, spp=1, use_bvh=True,
                              bvh_mode="kernel")
    assert forced.bvh_mode == "kernel"


def test_grad_through_kernel_route():
    """jax.grad of a small render whose casts go through the kernel: the
    kernel's inputs are detached, gradients flow through shading."""
    from gnxraytracer.models.integrators import path
    from gnxraytracer.ops import samplers
    from gnxraytracer.scene import presets

    scene, cam = presets.envmap_mesh(6, 6, mesh_tris=60)
    cfg = path.make_config(scene, 6, 6, spp=1, max_depth=2, spp_chunk=1,
                           use_bvh=True, bvh_mode="kernel",
                           texture_filter="bilinear")
    smp = samplers.make_sobol_sampler(1)

    def loss(kd):
        s = scene._replace(materials=scene.materials._replace(kd=kd))
        return jnp.mean(path.render_chunk(s, cam, smp, cfg, 0, 1))

    kd = scene.materials.kd
    g = jax.grad(loss)(kd)
    assert np.isfinite(np.asarray(g)).all() and np.abs(np.asarray(g)).max() > 0
    stackless = cfg._replace(bvh_mode="stackless")
    ref = path.render_chunk(scene, cam, smp, stackless, 0, 1)
    np.testing.assert_allclose(
        np.asarray(path.render_chunk(scene, cam, smp, cfg, 0, 1)),
        np.asarray(ref), rtol=1e-5, atol=1e-6)


def _dot_precisions(jaxpr):
    """Precision of every dot_general in a jaxpr, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    out += _dot_precisions(sub)
    return out


@pytest.mark.parametrize("scene_name", ["cornell", "mesh"])
def test_every_dot_is_highest_precision(scene_name):
    """On a GPU an f32 dot with no precision set may run in TF32; every
    dot_general of a render chunk must ask for HIGHEST."""
    from gnxraytracer.models.integrators import path
    from gnxraytracer.ops import samplers
    from gnxraytracer.scene import presets

    if scene_name == "cornell":
        scene, cam = presets.cornell_box(8, 8)
        cfg = path.make_config(scene, 8, 8, spp=2, max_depth=3, spp_chunk=2,
                               fast_mis=True)
    else:
        scene, cam = presets.envmap_mesh(8, 8, mesh_tris=60)
        cfg = path.make_config(scene, 8, 8, spp=2, max_depth=3, spp_chunk=2,
                               fast_mis=True, use_bvh=True, bvh_mode="kernel")
    smp = samplers.make_sobol_sampler(2)
    closed = jax.make_jaxpr(
        lambda s: path.render_chunk(scene, cam, smp, cfg, s, 2))(0)
    precisions = _dot_precisions(closed.jaxpr)
    assert precisions, "no dot_general traced: the check would be vacuous"
    highest = jax.lax.Precision.HIGHEST
    for p in precisions:
        assert p is not None and all(x == highest for x in p), p


@pytest.mark.gpu
def test_compiled_kernel_matches_stackless(gpu, scene_tree):
    """The kernel as compiled for the card against the XLA walk."""
    verts, tris, tree = scene_tree
    for kind in RAY_KINDS:
        o, d, t_max = (jax.device_put(jnp.asarray(x), gpu)
                       for x in _rays(kind, verts, tris))
        got = bvh_kernel.closest_hit(tree, o, d, t_max)
        _same_hits(got, bvh_mod.bvh_closest_hit_stackless(tree, o, d, t_max),
                   o.shape[0])
        np.testing.assert_array_equal(
            np.asarray(bvh_kernel.any_hit(tree, o, d, t_max)),
            np.asarray(bvh_mod.bvh_any_hit_stackless(tree, o, d, t_max)))
