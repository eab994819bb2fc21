"""Benchmark: Mpaths/s and wall-clock to 256 spp on the Cornell box
(BASELINE.md metric), plus the reference app's Whitted workload and the
mesh + environment workload.  Runs on the GPU only and prints ONE JSON
line that names the card (nvidia-smi name and power limit) and the device
as JAX reports it.

The reference publishes no numbers (BASELINE.md), so the baseline is the
reference itself, measured on a 2-core Xeon host: the headless oracle
(tools/ref_oracle = the reference's unmodified render core) on the same
workloads.  See BASELINE_MEASURED.json; regenerate with
`python tools/parity.py baseline`.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from gnxraytracer.utils.runtime import (gpu_name_and_power_limit,
                                             setup_compile_cache)

_HERE = os.path.dirname(os.path.abspath(__file__))


def _measured_baseline(workload):
    """The reference renderer's measured Mpaths/s on `workload`
    (tools/parity.py baseline -> BASELINE_MEASURED.json)."""
    with open(os.path.join(_HERE, "BASELINE_MEASURED.json")) as f:
        return json.load(f)["workloads"][workload]["Mpaths_per_s"]


def _reps(fn, reps=3):
    """Median-of-N timing of fn() -> (wall_s, n_rays): returns the median,
    min and max wall and the last run's ray count."""
    runs = [fn() for _ in range(reps)]
    walls = sorted(w for w, _ in runs)
    return walls[len(walls) // 2], walls[0], walls[-1], runs[-1][1]


def _timed_render(render_chunk, width, height, spp, spp_chunk, count_rays):
    """Time one full render of `spp` samples in spp_chunk-sized chunks,
    ending in block_until_ready.  Returns (wall_s, n_rays or None)."""
    t0 = time.perf_counter()
    acc = jnp.zeros((width * height, 3), jnp.float32)
    nrays = jnp.zeros((), jnp.float32)
    for s in range(0, spp, spp_chunk):
        out = render_chunk(s)
        if count_rays:
            out, nr = out
            nrays = nrays + nr
        acc = acc + out
    jax.block_until_ready((acc, nrays))
    return time.perf_counter() - t0, (float(nrays) if count_rays else None)


def main():
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {jax.devices()}")
    setup_compile_cache()
    from gnxraytracer.models.integrators import path
    from gnxraytracer.ops import samplers
    from gnxraytracer.scene import presets

    width = height = 500
    spp = 256
    max_depth = 8
    spp_chunk = 4  # 1M lanes per chunk

    scene, camera = presets.cornell_box(width=width, height=height)
    # fast_mis: the folded-MIS estimator (2 scene casts/bounce, same
    # expectation as the reference's 3-cast EstimateDirect; see
    # models/integrators/path.trace_paths_fast + tests)
    cfg = path.make_config(scene, width, height, spp=spp, max_depth=max_depth,
                           spp_chunk=spp_chunk, rr_threshold=1.0,
                           fast_mis=True,
                           # tail compaction: bounces 5-8 run at 1/8 width
                           # (Russian roulette leaves few lanes alive)
                           compact_tail=True,
                           # measured useful scene casts
                           count_rays=True)
    # Owen-scrambled Sobol: same-or-better equidistribution than Halton
    sampler = samplers.make_sobol_sampler(spp)

    def chunk(s):
        return path._render_chunk_jit(scene, camera, sampler, cfg, s,
                                      spp_chunk)

    jax.block_until_ready(chunk(0))  # compile
    # n_rays: measured useful scene casts (alive lanes)
    wall, wall_min, wall_max, n_rays = _reps(lambda: _timed_render(
        chunk, width, height, spp, spp_chunk, True))
    n_paths = width * height * spp
    mpaths = n_paths / wall / 1e6
    dev = jax.devices()[0]
    result = {
        "metric": "cornell_500px_256spp_Mpaths_per_s",
        "value": round(mpaths, 3),
        "unit": "Mpaths/s",
        "vs_baseline": round(mpaths / _measured_baseline(
            "path_500px_256spp"), 2),
        "wall_s_256spp": round(wall, 3),
        "wall_s_min": round(wall_min, 3),
        "wall_s_max": round(wall_max, 3),
        "Mrays_per_s": round(n_rays / wall / 1e6, 1),
        "rays_per_path": round(n_rays / n_paths, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "nvidia_smi": gpu_name_and_power_limit(),
    }
    # the reference app's own default workload: Whitted depth 5, 32 spp
    # (ui/RenderThread.cpp:159,163)
    result.update(bench_whitted())
    # BASELINE config 4: dragon-scale mesh + ImageTexture + HDR env + Sobol
    result.update(bench_mesh())
    print(json.dumps(result))


def bench_whitted(width=500, height=500, spp=32, max_depth=5):
    from gnxraytracer.models.integrators import path, whitted
    from gnxraytracer.ops import samplers
    from gnxraytracer.scene import presets

    scene, camera = presets.cornell_box(width=width, height=height)
    spp_chunk = 8
    cfg = path.make_config(scene, width, height, spp=spp,
                           max_depth=max_depth, spp_chunk=spp_chunk)
    sampler = samplers.make_halton_sampler(spp, width, height)

    def chunk(s):
        return whitted._render_chunk_jit(scene, camera, sampler, cfg, s,
                                         spp_chunk)

    jax.block_until_ready(chunk(0))
    wall, wall_min, wall_max, _ = _reps(lambda: _timed_render(
        chunk, width, height, spp, spp_chunk, False))
    mp = width * height * spp / wall / 1e6
    return {"whitted_Mpaths_per_s": round(mp, 3),
            "whitted_vs_baseline": round(mp / _measured_baseline(
                "whitted_500px_32spp"), 2),
            "whitted_wall_s_32spp": round(wall, 3),
            "whitted_wall_s_min": round(wall_min, 3),
            "whitted_wall_s_max": round(wall_max, 3)}


def mesh_config(scene, width, height, spp, max_depth=8, spp_chunk=4, **kw):
    """The mesh workload's render configuration (also chip_smoke.py's).

    compact_stages + pipeline_casts: every bounce's shading runs at the
    width of lanes whose cast actually hit; survivors are re-compacted as
    the wavefront dies.  Unbiased (pre-thinning Russian roulette), and
    every stage's pre-thin probability is 1 on this workload, so the
    estimator is bit-identical to the classic loop (guarded by
    test_reference_parity_mesh_bench_estimator)."""
    from gnxraytracer.models.integrators import path

    return path.make_config(scene, width, height, spp=spp,
                            max_depth=max_depth, spp_chunk=spp_chunk,
                            rr_threshold=1.0, fast_mis=True,
                            compact_tail=True, pipeline_casts=True,
                            compact_stages=((0, 2), (1, 16), (2, 32),
                                            (4, 64)),
                            count_rays=True, **kw)


def bench_mesh(width=500, height=500, spp=64, max_depth=8):
    from gnxraytracer.models.integrators import path
    from gnxraytracer.ops import samplers
    from gnxraytracer.scene import presets

    scene, camera = presets.envmap_mesh(width, height)  # ~105k tris
    n_tris = int(scene.geom.triangles.shape[0])
    spp_chunk = 4
    cfg = mesh_config(scene, width, height, spp, max_depth, spp_chunk)
    sampler = samplers.make_sobol_sampler(spp)

    def chunk(s):
        return path._render_chunk_jit(scene, camera, sampler, cfg, s,
                                      spp_chunk)

    jax.block_until_ready(chunk(0))
    wall, wall_min, wall_max, n_rays = _reps(lambda: _timed_render(
        chunk, width, height, spp, spp_chunk, True))
    n_paths = width * height * spp
    mp = n_paths / wall / 1e6
    return {
        "mesh_tris": n_tris,
        "mesh_vs_baseline": round(mp / _measured_baseline(
            "envmesh_500px_64spp"), 2),
        "mesh_bvh_mode": cfg.bvh_mode,
        "mesh_Mpaths_per_s": round(mp, 3),
        "mesh_wall_s_64spp": round(wall, 3),
        "mesh_wall_s_min": round(wall_min, 3),
        "mesh_wall_s_max": round(wall_max, 3),
        "mesh_Mrays_per_s": round(n_rays / wall / 1e6, 3),
        "mesh_rays_per_path": round(n_rays / n_paths, 2),
    }


if __name__ == "__main__":
    main()
