"""Command-line interface — replaces the reference's Qt UI layer
(/root/reference/ui/): scene presets instead of hardcoded
RenderThread::run, progressive rendering with per-frame stats
(frame time / FPS / Mpaths/s, mirroring RenderThread.cpp:177-184's status
output), PNG export with the reference tonemap, and checkpoint/resume of
the linear accumulation state (a capability the reference lacks —
SURVEY.md §5).

Usage:
  python -m gnxraytracer.cli render --preset cornell --spp 64 \\
      --integrator path --out out.png [--checkpoint state.npz] [--resume]
  python -m gnxraytracer.cli presets
"""

import argparse
import json
import sys
import time

import numpy as np


PRESETS = {
    "cornell": "Cornell box + area light + skybox (reference default scene)",
    "cornell-mesh": "Cornell + procedural high-poly mesh via BVH (dragon stand-in)",
    "cornell-glass": "Cornell with glass/mirror/disney spheres (BASELINE cfg 3)",
    "sphere": "Single matte sphere + point light (BASELINE cfg 1)",
    "volume": "Volumetric Cornell: grid medium + homogeneous glass (BASELINE cfg 5)",
    "envmap": "Mesh + InfiniteAreaLight HDR environment (BASELINE cfg 4)",
    "gmd": "Cornell + Glass/Mirror/Disney boxes (oracle parity twin)",
    "metal": "Cornell + the reference app's Metal/Plastic presets (parity twin)",
    "gridvol": "Cornell + GridDensityMedium from density_render.70.volume",
}


def build_preset(name, width, height, spp):
    from .scene import presets

    if name == "cornell":
        return presets.cornell_box(width, height)
    if name == "cornell-mesh":
        from .scene.loaders import make_test_mesh

        mesh = make_test_mesh(5)
        return presets.cornell_box(width, height, mesh=mesh, bvh=True)
    if name == "cornell-glass":
        return presets.cornell_glass(width, height)
    if name == "sphere":
        return presets.sphere_point_light(width, height)
    if name == "volume":
        return presets.volumetric_cornell(width, height)
    if name == "envmap":
        return presets.envmap_mesh(width, height)
    if name == "gmd":
        return presets.cornell_gmd(width, height)
    if name == "metal":
        return presets.cornell_metal(width, height)
    if name == "gridvol":
        return presets.cornell_gridvol(width, height)
    raise SystemExit(f"unknown preset {name}; try: {', '.join(PRESETS)}")


def get_integrator(name):
    from .models.integrators import direct, path, volpath, whitted

    return {"path": path, "whitted": whitted, "direct": direct,
            "volpath": volpath}[name]


def cmd_render(args):
    import jax
    import jax.numpy as jnp

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from .models.integrators import path as path_mod
    from .ops import samplers
    from .utils.image import save_png
    from .utils.runtime import setup_compile_cache

    setup_compile_cache()

    scene, camera = build_preset(args.preset, args.width, args.height, args.spp)
    integ = get_integrator(args.integrator)
    cfg = path_mod.make_config(
        scene, args.width, args.height, spp=args.spp, max_depth=args.max_depth,
        spp_chunk=args.spp_chunk, rr_threshold=args.rr_threshold,
        fast_mis=args.fast_mis,
    )
    if args.sampler == "halton":
        sampler = samplers.make_halton_sampler(args.spp, args.width, args.height)
    elif args.sampler == "sobol":
        sampler = samplers.make_sobol_sampler(args.spp)
    else:
        sampler = samplers.make_random_sampler(args.spp, seed=args.seed)

    live_png = None
    if args.live:
        from .utils.viewer import LivePngWriter

        live_png = LivePngWriter(args.live, tonemap=args.tonemap)
    term_lines = 0

    hw = args.width * args.height
    acc = jnp.zeros((hw, 3), jnp.float32)
    start_spp = 0
    if args.resume and args.checkpoint:
        try:
            ck = np.load(args.checkpoint)
            acc = jnp.asarray(ck["acc"])
            start_spp = int(ck["spp"])
            print(f"resumed at {start_spp} spp from {args.checkpoint}")
        except FileNotFoundError:
            pass

    t_all = time.time()
    s = start_spp
    paths_done = 0
    while s < args.spp:
        ns = min(args.spp_chunk, args.spp - s)
        t0 = time.time()
        acc = acc + integ._render_chunk_jit(scene, camera, sampler, cfg, s, ns)
        acc.block_until_ready()
        dt = time.time() - t0
        s += ns
        paths_done += ns * hw
        stats = {
            "spp": s,
            "frame_time_s": round(dt, 3),
            "fps": round(1.0 / dt, 2),
            "Mpaths_per_s": round(ns * hw / dt / 1e6, 3),
        }
        print(json.dumps(stats), flush=True)
        if live_png is not None or args.view:
            cur = np.asarray(acc).reshape(args.height, args.width, 3) / max(s, 1)
            if live_png is not None:
                live_png.update(cur)
            if args.view:
                from .utils.viewer import term_preview, term_redraw_prefix

                sys.stdout.write(term_redraw_prefix(term_lines + 1))
                term_lines = term_preview(cur, max_cols=args.view_cols,
                                          tonemap=args.tonemap)
                print(json.dumps(stats), flush=True)
        if args.checkpoint and (s % max(args.spp_chunk * 4, 1) == 0 or s >= args.spp):
            np.savez(args.checkpoint, acc=np.asarray(acc), spp=s)

    img = np.asarray(acc).reshape(args.height, args.width, 3) / max(s, 1)
    wall = time.time() - t_all
    print(json.dumps({"total_s": round(wall, 2), "spp": s, "mean": float(img.mean())}))
    if args.out:
        save_png(args.out, img, tonemap=args.tonemap)
        print(f"wrote {args.out}")
    if args.out_npy:
        np.save(args.out_npy, img)
        print(f"wrote {args.out_npy}")


def cmd_presets(_args):
    for k, v in PRESETS.items():
        print(f"{k:15s} {v}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="gnxraytracer")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a preset scene")
    r.add_argument("--preset", default="cornell", choices=sorted(PRESETS))
    r.add_argument("--width", type=int, default=500)
    r.add_argument("--height", type=int, default=500)
    r.add_argument("--spp", type=int, default=32)
    r.add_argument("--spp-chunk", type=int, default=4)
    r.add_argument("--max-depth", type=int, default=5)
    r.add_argument("--rr-threshold", type=float, default=1.0)
    r.add_argument("--integrator", default="path",
                   choices=["path", "whitted", "direct", "volpath"])
    r.add_argument("--sampler", default="halton",
                   choices=["halton", "sobol", "random"])
    r.add_argument("--fast-mis", action="store_true",
                   help="folded-MIS estimator (2 scene casts/bounce)")
    r.add_argument("--live", default=None, metavar="PNG",
                   help="rewrite this PNG after every chunk (live viewer)")
    r.add_argument("--view", action="store_true",
                   help="draw a live ANSI preview in the terminal")
    r.add_argument("--view-cols", type=int, default=80)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--out", default=None)
    r.add_argument("--out-npy", default=None)
    r.add_argument("--tonemap", default="reference",
                   choices=["reference", "srgb", "none"])
    r.add_argument("--checkpoint", default=None)
    r.add_argument("--resume", action="store_true")
    r.add_argument("--cpu", action="store_true", help="force CPU backend")
    r.set_defaults(fn=cmd_render)

    q = sub.add_parser("presets", help="list scene presets")
    q.set_defaults(fn=cmd_presets)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
