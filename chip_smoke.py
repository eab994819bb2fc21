"""Smoke check of the renderer on one NVIDIA GPU, through the entry points a
user calls (path.make_config -> path._render_chunk_jit /
whitted._render_chunk_jit, parallel.sharding.make_train_step).

    python chip_smoke.py               # phases 1-6, one card
    python chip_smoke.py --four-cards  # only the 4-card path (phase 7)

Phases (each at the full width of the cells bench.py runs):
  1. device: the card's name and power limit, JAX's device list; a run
     that finds no GPU exits non-zero and renders nothing
  2. Cornell path cell: 500x500, depth 8, fast MIS, tail compaction,
     Sobol, 4 chunks of 4 spp (1M lanes each)
  3. oracle parity: the Cornell path / Whitted / direct goldens of the
     unmodified reference renderer (tests/golden) at the fast-tier
     thresholds of tests/test_reference_parity.py
  4. Whitted cell: 500x500, depth 5, Halton, 2 chunks of 8 spp
  5. mesh cell: the 104,882-triangle envmap_mesh scene, 2 chunks through
     the BVH traversal kernel; the kernel's hits against the XLA stackless
     walk on camera and bounce rays; one chunk rendered both ways; the
     GPU-marked tests
  6. gradient step: one make_train_step step on a 1-device mesh for
     Cornell and the mesh scene at 128x128; every named parameter class
     must receive a gradient
  7. (--four-cards) the Cornell cell sharded over 4 cards against 1 card,
     and three train steps on 4 cards against 1 card

Everything runs in this one process, which holds the card(s).  The last
line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import contextlib
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))


@contextlib.contextmanager
def phase(name):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def compile_chunk(jitted, args, cfg, n_samples):
    """Lower + compile one chunk of `jitted(*args, cfg, sample_start,
    n_samples)`; returns (compiled, compile_s)."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, cfg=cfg, sample_start=0,
                            n_samples=n_samples).compile()
    return compiled, time.perf_counter() - t0


def run_chunks(compiled, args, starts, count_rays):
    """Run the compiled chunk at each sample start, timing each to
    block_until_ready.  Returns (sum image, total rays, per-chunk walls)."""
    import jax

    acc, nrays, walls = 0.0, 0.0, []
    for s in starts:
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args, sample_start=s))
        walls.append(time.perf_counter() - t0)
        if count_rays:
            out, nr = out
            nrays += float(nr)
        acc = acc + out
    return acc, nrays, walls


def check_image(tag, img, n_lanes):
    import numpy as np

    img = np.asarray(img)
    assert np.isfinite(img).all(), f"{tag}: non-finite pixels"
    assert img.mean() > 0, f"{tag}: black image"
    print(f"{tag}: mean radiance {img.mean() / n_lanes:.6f}, "
          f"shape {img.shape}", flush=True)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def cornell_cell(width=500, height=500, spp=256):
    """The Cornell path cell of bench.py."""
    from gnxraytracer.models.integrators import path
    from gnxraytracer.ops import samplers
    from gnxraytracer.scene import presets

    scene, camera = presets.cornell_box(width=width, height=height)
    cfg = path.make_config(scene, width, height, spp=spp, max_depth=8,
                           spp_chunk=4, rr_threshold=1.0, fast_mis=True,
                           compact_tail=True, count_rays=True)
    return scene, camera, samplers.make_sobol_sampler(spp), cfg


def phase_cornell():
    from gnxraytracer.models.integrators import path

    scene, camera, sampler, cfg = cornell_cell()
    compiled, c_s = compile_chunk(path._render_chunk_jit,
                                  (scene, camera, sampler), cfg, 4)
    img, nrays, walls = run_chunks(compiled, (scene, camera, sampler),
                                   [0, 4, 8, 12], True)
    print(f"cornell: compile {c_s:.2f} s, chunk walls (s) {walls}, "
          f"{nrays:.0f} scene casts", flush=True)
    assert nrays > 0, "cornell: no rays counted"
    check_image("cornell", img, 16)


def phase_parity():
    sys.path.insert(0, os.path.join(_HERE, "tests"))
    import test_reference_parity as trp

    for name in ("ref_path_cornell", "ref_whitted_cornell",
                 "ref_direct_cornell"):
        mean_err, block_err = trp.check_parity(
            name, spp=trp.FAST_SPP, block_tol=trp.FAST_BLOCK_TOL,
            mean_tol=trp.FAST_MEAN_TOL)
        print(f"parity {name} @ {trp.FAST_SPP} spp: channel-mean err "
              f"{mean_err:.4f} (< {trp.FAST_MEAN_TOL}), block8 err "
              f"{block_err:.4f} (< {trp.FAST_BLOCK_TOL})", flush=True)


def phase_whitted():
    from gnxraytracer.models.integrators import path, whitted
    from gnxraytracer.ops import samplers
    from gnxraytracer.scene import presets

    scene, camera = presets.cornell_box(width=500, height=500)
    cfg = path.make_config(scene, 500, 500, spp=32, max_depth=5, spp_chunk=8)
    sampler = samplers.make_halton_sampler(32, 500, 500)
    compiled, c_s = compile_chunk(whitted._render_chunk_jit,
                                  (scene, camera, sampler), cfg, 8)
    img, _, walls = run_chunks(compiled, (scene, camera, sampler), [0, 8],
                               False)
    print(f"whitted: compile {c_s:.2f} s, chunk walls (s) {walls}",
          flush=True)
    check_image("whitted", img, 16)


def compare_casts(scene, camera, cfg):
    """BVH casts of the kernel against the XLA stackless walk on the mesh
    cell's camera rays and one bounce of cosine-distributed rays from the
    camera hits (closest hit), and on those bounce rays with a finite
    t_max (any hit)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gnxraytracer.constants import INFINITY
    from gnxraytracer.ops import bvh as bvh_mod
    from gnxraytracer.ops import bvh_kernel, samplers, trace
    from gnxraytracer.ops.sampling import cosine_sample_hemisphere
    from gnxraytracer.scene import camera as cam_mod

    hw = cfg.width * cfg.height
    sampler = samplers.make_sobol_sampler(4)
    pixel = jnp.arange(hw, dtype=jnp.int32)
    p_film, t_u, p_lens = samplers.camera_sample(
        sampler, pixel, jnp.zeros_like(pixel), cfg.width)
    o, d, _ = cam_mod.generate_rays(camera, p_film, t_u, p_lens)
    bvh = scene.bvh
    kernel_ch = jax.jit(bvh_kernel.closest_hit)
    kernel_any = jax.jit(bvh_kernel.any_hit)
    ref_ch = jax.jit(bvh_mod.bvh_closest_hit_stackless)
    ref_any = jax.jit(bvh_mod.bvh_any_hit_stackless)

    def agree(tag, k, r):
        kh, rh = np.asarray(k.hit), np.asarray(r.hit)
        same = (kh == rh) & np.where(rh, np.asarray(k.tri) == np.asarray(r.tri),
                                     True)
        both = kh & rh
        kt, rt = np.asarray(k.t)[both], np.asarray(r.t)[both]
        t_rel = np.abs(kt - rt) / np.maximum(np.abs(rt), 1e-30)
        t_max_rel = float(t_rel.max()) if both.any() else 0.0
        print(f"casts {tag}: {int(rh.sum())} of {rh.size} rays hit; prim "
              f"agrees on {same.mean():.6f}; t rel diff max {t_max_rel:.3g}",
              flush=True)
        assert same.mean() >= 0.9999, f"{tag}: prims disagree"
        assert t_max_rel <= 1e-5, f"{tag}: t disagrees"

    t_inf = jnp.full((hw,), INFINITY, jnp.float32)
    cam_k = kernel_ch(bvh, o, d, t_inf)
    cam_r = ref_ch(bvh, o, d, t_inf)
    agree("camera", cam_k, cam_r)

    hit = trace.Hit(cam_r.hit, cam_r.t,
                    jnp.where(cam_r.hit, trace.PRIM_TRI, trace.PRIM_NONE),
                    cam_r.tri, cam_r.b)
    it = trace.make_interaction(scene, cfg, o, d, hit)
    u = jax.random.uniform(jax.random.PRNGKey(7), (hw, 2))
    wi = trace.to_world(it, cosine_sample_hemisphere(u))
    wi = jnp.where((jnp.sum(wi * it.ng, -1) < 0)[:, None], -wi, wi)
    bo, bd = trace.spawn_ray(it, wi)
    t_b = jnp.where(cam_r.hit, INFINITY, 0.0)
    agree("bounce", kernel_ch(bvh, bo, bd, t_b), ref_ch(bvh, bo, bd, t_b))
    # shadow-like: every other live lane stops at a finite distance
    t_s = jnp.where(jnp.arange(hw) % 2 == 0, t_b, jnp.minimum(t_b, 0.3))
    occ_k = np.asarray(kernel_any(bvh, bo, bd, t_s))
    occ_r = np.asarray(ref_any(bvh, bo, bd, t_s))
    print(f"casts any-hit: {int(occ_r.sum())} occluded; agrees on "
          f"{(occ_k == occ_r).mean():.6f}", flush=True)
    assert (occ_k == occ_r).mean() >= 0.9999, "any-hit disagrees"


def run_gpu_tests():
    """The GPU-marked tests, in this process (it already holds the card)."""
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(_HERE, "tests", "test_bvh_kernel.py")],
                     plugins=[Count()])
    print(f"gpu tests: exit {rc}, {Count.passed} passed", flush=True)
    assert rc == 0 and Count.passed > 0, "GPU-marked tests failed"


def phase_mesh():
    import jax.numpy as jnp
    import numpy as np

    from bench import mesh_config
    from gnxraytracer.models.integrators import path
    from gnxraytracer.ops import samplers
    from gnxraytracer.scene import presets

    t0 = time.perf_counter()
    scene, camera = presets.envmap_mesh(500, 500)
    print(f"mesh: {scene.geom.triangles.shape[0]} triangles, "
          f"{scene.bvh.offset.shape[0]} BVH nodes, scene build "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    cfg = mesh_config(scene, 500, 500, spp=64)
    assert cfg.bvh_mode == "kernel", cfg.bvh_mode
    sampler = samplers.make_sobol_sampler(64)
    args = (scene, camera, sampler)
    compiled, c_s = compile_chunk(path._render_chunk_jit, args, cfg, 4)
    print(f"mesh chunk (kernel) memory: {compiled.memory_analysis()}",
          flush=True)
    img, nrays, walls = run_chunks(compiled, args, [0, 4], True)
    print(f"mesh (kernel): compile {c_s:.2f} s, chunk walls (s) {walls}, "
          f"{nrays:.0f} scene casts", flush=True)
    check_image("mesh", img, 8)

    compare_casts(scene, camera, cfg)

    ref_cfg = cfg._replace(bvh_mode="stackless")
    ref_c, rc_s = compile_chunk(path._render_chunk_jit, args, ref_cfg, 4)
    print(f"mesh chunk (stackless) memory: {ref_c.memory_analysis()}",
          flush=True)
    ref_img, _, ref_walls = run_chunks(ref_c, args, [0], True)
    ker_img, _, _ = run_chunks(compiled, args, [0], True)
    km, rm = float(jnp.mean(ker_img)), float(jnp.mean(ref_img))
    print(f"mesh (stackless): compile {rc_s:.2f} s, chunk wall (s) "
          f"{ref_walls}; chunk-0 mean radiance kernel {km:.6f} vs "
          f"stackless {rm:.6f} (rel {abs(km - rm) / rm:.2e})", flush=True)
    assert np.isfinite(np.asarray(ref_img)).all()
    assert abs(km - rm) <= 0.005 * rm, "kernel and XLA walk images differ"

    run_gpu_tests()


def train_step_check(tag, scene, camera, sampler, cfg, mesh, want):
    """One make_train_step step; every class in `want` must move."""
    import jax.numpy as jnp
    import numpy as np

    from gnxraytracer.parallel import sharding

    params = sharding.extract_params(scene)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    step = sharding.make_train_step(cfg, mesh)
    t0 = time.perf_counter()
    loss, new = step(params, scene, camera, sampler, target, lr=1.0)
    loss = float(loss)
    print(f"train {tag}: loss {loss:.6g}, first step (compile + run) "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    assert np.isfinite(loss), f"{tag}: non-finite loss"
    for k in want:
        g = np.abs(np.asarray(params[k]) - np.asarray(new[k]))
        assert np.isfinite(g).all(), f"{tag}: non-finite {k}"
        print(f"train {tag}: |grad {k}| max {g.max():.3g}", flush=True)
        assert g.max() > 0, f"{tag}: zero gradient for {k}"


def phase_gradient():
    from gnxraytracer.models.integrators import path
    from gnxraytracer.ops import samplers
    from gnxraytracer.parallel import sharding
    from gnxraytracer.scene import presets

    mesh = sharding.make_mesh(1)
    scene, camera = presets.cornell_box(128, 128)
    cfg = path.make_config(scene, 128, 128, spp=4, max_depth=3, spp_chunk=4)
    train_step_check("cornell", scene, camera, samplers.make_sobol_sampler(4),
                     cfg, mesh, ("kd", "light_emit"))
    scene, camera = presets.envmap_mesh(128, 128)
    cfg = path.make_config(scene, 128, 128, spp=4, max_depth=3, spp_chunk=4)
    assert cfg.bvh_mode == "kernel", cfg.bvh_mode
    train_step_check("mesh", scene, camera, samplers.make_sobol_sampler(4),
                     cfg, mesh, ("kd", "env_image", "tex_atlas"))


def phase_four_cards(size=500, train_size=128):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gnxraytracer.models.integrators import path
    from gnxraytracer.ops import samplers
    from gnxraytracer.parallel import sharding
    from gnxraytracer.scene import presets

    assert len(jax.devices()) >= 4, f"need 4 cards, have {jax.devices()}"
    mesh4, mesh1 = sharding.make_mesh(4), sharding.make_mesh(1)
    scene, camera, sampler, cfg = cornell_cell(size, size, spp=16)

    out = sharding.render_chunk_sharded(scene, camera, sampler, cfg, mesh4,
                                        0, 4)
    print(f"sharded chunk: {out.shape} {out.sharding}", flush=True)
    for s in out.addressable_shards:
        print(f"  pixel rows {s.index[0]} on {s.device}", flush=True)
    assert len({s.device for s in out.addressable_shards}) == 4

    walls = {}
    imgs = {}
    for tag, m in (("4 cards", mesh4), ("1 card", mesh1)):
        sharding.render_sharded(scene, camera, sampler, cfg, m)  # compile
        t0 = time.perf_counter()
        imgs[tag] = sharding.render_sharded(scene, camera, sampler, cfg, m)
        walls[tag] = time.perf_counter() - t0
    b4, b1 = (imgs[t].reshape(size // 4, 4, size // 4, 4, 3).mean((1, 3))
              for t in ("4 cards", "1 card"))
    rel = np.abs(b4 - b1) / np.maximum(np.abs(b1), 1e-3 * b1.mean())
    print(f"render_sharded 16 spp, wall to host (s): {walls}; block4 "
          f"rel diff max {rel.max():.3g}", flush=True)
    assert np.isfinite(imgs["4 cards"]).all() and rel.max() <= 1e-5

    scene, camera = presets.cornell_box(train_size, train_size)
    cfg = path.make_config(scene, train_size, train_size, spp=4, max_depth=3,
                           spp_chunk=4)
    sampler = samplers.make_sobol_sampler(4)
    target = jnp.zeros((train_size, train_size, 3), jnp.float32)
    lr = 0.1
    runs = {}
    for tag, m in (("4 cards", mesh4), ("1 card", mesh1)):
        step = sharding.make_train_step(cfg, m)
        params = sharding.extract_params(scene)
        losses, grads = [], []
        for _ in range(3):
            loss, new = step(params, scene, camera, sampler, target, lr=lr)
            losses.append(float(loss))
            grads.append({k: (np.asarray(params[k]) - np.asarray(new[k])) / lr
                          for k in params})
            params = new
        runs[tag] = (losses, grads)
    (l4, g4), (l1, g1) = runs["4 cards"], runs["1 card"]
    print(f"train losses 4 cards {l4} vs 1 card {l1}", flush=True)
    for a, b in zip(l4, l1):
        assert abs(a - b) <= 1e-4 * abs(b), "losses differ"
    worst = max(float(np.max(np.abs(a[k] - b[k]) - 1e-4 * np.abs(b[k])))
                for a, b in zip(g4, g1) for k in a)
    print(f"train gradients: max(|g4 - g1| - 1e-4 |g1|) = {worst:.3g} "
          f"(must be <= 1e-4)", flush=True)
    assert worst <= 1e-4, "gradients differ"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card path and what it is "
                         "compared with")
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX found {devices}); nothing run")
    from gnxraytracer.utils.runtime import (gpu_name_and_power_limit,
                                                 setup_compile_cache)

    cache = setup_compile_cache()
    with phase("1 device"):
        print(f"jax {jax.__version__}; devices {devices}; compile cache "
              f"{cache}")
        print(gpu_name_and_power_limit(), flush=True)
    if args.four_cards:
        count = 4
        with phase("7 four cards"):
            phase_four_cards()
    else:
        count = 1
        with phase("2 cornell path cell"):
            phase_cornell()
        with phase("3 oracle parity"):
            phase_parity()
        with phase("4 whitted cell"):
            phase_whitted()
        with phase("5 mesh cell"):
            phase_mesh()
        with phase("6 gradient step"):
            phase_gradient()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))


if __name__ == "__main__":
    main()
