"""A/B of the BVH walks in the mesh cell, on the GPU, in one process.

Compiles one mesh-cell chunk (bench.py's mesh configuration: 500x500,
spp_chunk 4 = 1M lanes, depth 8, fast MIS, pipelined casts, staged
compaction) per walk:

  kernel         ops/bvh_kernel.py, rays in wavefront order
  kernel_sorted  the kernel behind the coherence sort (bvh.ray_sort_perm)
  packet         XLA packet walk (bvh.packet_closest_hit_xla / any_hit)
  stackless      XLA per-lane walk (bvh.bvh_closest_hit_stackless / ...)

then times single chunks in turns (A B C D, D C B A, ...), so drift of the
card's clocks hits every variant alike, and checks that every variant
renders the same image.  Also times the closest-hit cast alone on the
cell's 250k camera rays and on one bounce of 250k cosine rays.

    python tools/ab_traversal.py [--rounds 3] [--variants kernel,packet]
"""

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gnxraytracer.utils.runtime import (  # noqa: E402
    gpu_name_and_power_limit, setup_compile_cache)

VARIANTS = ("kernel", "kernel_sorted", "packet", "stackless")


@functools.lru_cache(maxsize=None)
def _sorted_kernel():
    """bvh_kernel's two casts behind the per-cast coherence sort."""
    from gnxraytracer.ops import bvh as bvh_mod
    from gnxraytracer.ops import bvh_kernel
    from gnxraytracer.ops.intersect import TriHit

    kernel_closest, kernel_any = bvh_kernel.closest_hit, bvh_kernel.any_hit

    def perm(bvh, o, d, t_max):
        t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32),
                                 (o.shape[0],))
        p, inv = bvh_mod.ray_sort_perm(o, d, bvh.bounds_lo[0],
                                       bvh.bounds_hi[0], t_max=t_max)
        return p, inv, t_max

    def closest(bvh, o, d, t_max, **kw):
        p, inv, t_max = perm(bvh, o, d, t_max)
        h = kernel_closest(bvh, o[p], d[p], t_max[p], **kw)
        return TriHit(h.hit[inv], h.t[inv], h.tri[inv], h.b[inv])

    def any_(bvh, o, d, t_max, **kw):
        p, inv, t_max = perm(bvh, o, d, t_max)
        return kernel_any(bvh, o[p], d[p], t_max[p], **kw)[inv]

    return closest, any_


def compile_variant(name, scene, camera, sampler, cfg):
    """Lower + compile one chunk of `name`; returns (compiled, seconds)."""
    from gnxraytracer.models.integrators import path
    from gnxraytracer.ops import bvh_kernel

    mode = "kernel" if name.startswith("kernel") else name

    def chunk(scene, camera, sampler, cfg, sample_start, n_samples):
        # a new function per variant: jit's trace cache keys on it
        return path.render_chunk(scene, camera, sampler, cfg, sample_start,
                                 n_samples)

    jitted = jax.jit(chunk, static_argnames=("cfg", "n_samples"))
    saved = (bvh_kernel.closest_hit, bvh_kernel.any_hit)
    if name == "kernel_sorted":
        # trace.py imports the wrappers at trace time: swap them for the
        # trace of this variant only
        bvh_kernel.closest_hit, bvh_kernel.any_hit = _sorted_kernel()
    try:
        t0 = time.perf_counter()
        compiled = jitted.lower(scene, camera, sampler,
                                cfg=cfg._replace(bvh_mode=mode),
                                sample_start=0, n_samples=cfg.spp_chunk
                                ).compile()
    finally:
        bvh_kernel.closest_hit, bvh_kernel.any_hit = saved
    return compiled, time.perf_counter() - t0


def cast_timings(scene, camera, cfg, names, reps=5):
    """Median seconds of one closest-hit cast per walk, on camera rays and
    on one bounce of cosine rays from the camera hits."""
    from gnxraytracer.constants import INFINITY
    from gnxraytracer.ops import bvh as bvh_mod
    from gnxraytracer.ops import bvh_kernel, samplers, trace
    from gnxraytracer.ops.sampling import cosine_sample_hemisphere
    from gnxraytracer.scene import camera as cam_mod

    hw = cfg.width * cfg.height
    smp = samplers.make_sobol_sampler(4)
    pixel = jnp.arange(hw, dtype=jnp.int32)
    p_film, t_u, p_lens = samplers.camera_sample(smp, pixel,
                                                 jnp.zeros_like(pixel),
                                                 cfg.width)
    o, d, _ = cam_mod.generate_rays(camera, p_film, t_u, p_lens)
    t_inf = jnp.full((hw,), INFINITY, jnp.float32)
    walks = {
        "kernel": bvh_kernel.closest_hit,
        "kernel_sorted": _sorted_kernel()[0],
        "packet": bvh_mod.packet_closest_hit_xla,
        "stackless": bvh_mod.bvh_closest_hit_stackless,
    }
    ref = jax.jit(bvh_mod.bvh_closest_hit_stackless)(scene.bvh, o, d, t_inf)
    hit = trace.Hit(ref.hit, ref.t,
                    jnp.where(ref.hit, trace.PRIM_TRI, trace.PRIM_NONE),
                    ref.tri, ref.b)
    it = trace.make_interaction(scene, cfg, o, d, hit)
    wi = trace.to_world(it, cosine_sample_hemisphere(
        jax.random.uniform(jax.random.PRNGKey(3), (hw, 2))))
    wi = jnp.where((jnp.sum(wi * it.ng, -1) < 0)[:, None], -wi, wi)
    bo, bd = trace.spawn_ray(it, wi)
    t_b = jnp.where(ref.hit, INFINITY, 0.0)
    out = {}
    for name in names:
        f = jax.jit(walks[name])
        for tag, args in (("camera", (o, d, t_inf)), ("bounce", (bo, bd, t_b))):
            jax.block_until_ready(f(scene.bvh, *args))
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(f(scene.bvh, *args))
                ts.append(time.perf_counter() - t0)
            out[f"{name}/{tag}"] = sorted(ts)[reps // 2]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    names = args.variants.split(",")
    assert jax.devices()[0].platform == "gpu", jax.devices()
    setup_compile_cache()
    from bench import mesh_config
    from gnxraytracer.ops import samplers
    from gnxraytracer.scene import presets

    print(gpu_name_and_power_limit(), flush=True)
    scene, camera = presets.envmap_mesh(500, 500)
    cfg = mesh_config(scene, 500, 500, spp=64)
    sampler = samplers.make_sobol_sampler(64)
    print(json.dumps({"casts_s": cast_timings(scene, camera, cfg, names)}),
          flush=True)

    compiled, compile_s = {}, {}
    for name in names:
        compiled[name], compile_s[name] = compile_variant(
            name, scene, camera, sampler, cfg)
        print(f"{name}: compiled in {compile_s[name]:.1f} s", flush=True)
    walls = {n: [] for n in names}
    imgs = {}
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            s = 4 * (r % 16)
            t0 = time.perf_counter()
            img, nrays = jax.block_until_ready(
                compiled[name](scene, camera, sampler, sample_start=s))
            walls[name].append(time.perf_counter() - t0)
            if r == 0:
                imgs[name] = (np.asarray(img), float(nrays))
    base, base_rays = imgs[names[0]]
    result = {"nvidia_smi": gpu_name_and_power_limit(),
              "compile_s": compile_s, "chunk_walls_s": walls,
              "chunk_median_s": {n: float(np.median(w))
                                 for n, w in walls.items()}}
    for name in names:
        img, nrays = imgs[name]
        result.setdefault("image_mean_rel_diff", {})[name] = float(
            abs(img.mean() - base.mean()) / base.mean())
        result.setdefault("scene_casts", {})[name] = nrays
    print(json.dumps(result))


if __name__ == "__main__":
    main()
