"""Reference parity harness (VERDICT round-1 item #1, round-2 items #3/#4).

Drives the headless reference oracle (tools/ref_oracle/) — the UNMODIFIED
reference render core with a linear FrameBuffer stub — over the parity
configs, stores its linear float images as goldens in tests/golden/, and
records the reference's measured throughput for bench.py's vs_baseline.

Usage:
  python tools/parity.py goldens        # (re)generate tests/golden/ref_*.npz
  python tools/parity.py gradients      # FD gradient goldens (kd / Le / sigma)
  python tools/parity.py baseline       # measure reference Mpaths/s at bench scale
  python tools/parity.py compare        # render ours (CPU) and print error table

Acceptance bar (also documented in PARITY.md): bit parity is impossible
(static per-bounce sampler dims vs the reference's data-dependent counter),
so parity is statistical: at equal scene/integrator settings, the 8x8
block-averaged images must agree within the MC standard error envelope.
"""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
ORACLE = os.path.join(REPO, "tools", "ref_oracle", "build", "oracle")
GOLDEN = os.path.join(REPO, "tests", "golden")
BLOB_3D = "/tmp/parity_blob.3d"
BLOB_SEG = 50  # 2*50^2 = 5000 tris: oracle renders it at 2048 spp in minutes

# name -> dict(w, h, spp, integ, depth, sigma, strategy, skybox, scene,
#              kd, le)
# spp is high so the oracle golden's own MC error is small vs ours.
def _cfg(w, h, spp, integ, depth, sigma, strategy, skybox, scene="cornell",
         kd=1.0, le=5.0, **extra):
    return dict(w=w, h=h, spp=spp, integ=integ, depth=depth, sigma=sigma,
                strategy=strategy, skybox=skybox, scene=scene, kd=kd, le=le,
                **extra)


CONFIGS = {
    "ref_path_cornell": _cfg(64, 64, 2048, "path", 8, 60.0, "uniform", 1),
    "ref_path_lambert": _cfg(64, 64, 2048, "path", 8, 0.0, "uniform", 0),
    "ref_direct_cornell": _cfg(64, 64, 2048, "direct", 5, 0.0, "uniform", 0),
    "ref_whitted_cornell": _cfg(64, 64, 2048, "whitted", 5, 60.0, "uniform", 1),
    "ref_path_cornell128": _cfg(128, 128, 1024, "path", 8, 60.0, "uniform", 1),
    # round-3 additions (VERDICT item 4): BASELINE configs 3/4/5
    "ref_gmd_cornell": _cfg(64, 64, 2048, "path", 8, 0.0, "uniform", 0,
                            scene="gmd"),
    "ref_envmesh": _cfg(64, 64, 1024, "path", 8, 0.0, "uniform", 0,
                        scene="envmesh"),
    "ref_volpath_hom": _cfg(64, 64, 2048, "volpath", 8, 0.0, "uniform", 0,
                            scene="volpath"),
    # round-4 (VERDICT r3 item 4): BASELINE config 5 proper — grid medium
    # from density_render.70.volume (delta tracking + ratio-tracking Tr)
    "ref_gridvol": _cfg(64, 64, 2048, "volpath", 8, 0.0, "uniform", 0,
                        scene="gridvol"),
    # round-4 (VERDICT r3 missing #6): the reference app's own Metal +
    # Plastic presets (ui/MaterialList.cpp:49-69) — the two material
    # families no oracle scene exercised
    "ref_metal_cornell": _cfg(64, 64, 2048, "path", 8, 0.0, "uniform", 0,
                              scene="metal"),
}

# FD gradient goldens (VERDICT item 3): central differences of the oracle's
# Cornell render w.r.t. the white-wall kd scale, the area-light radiance,
# and the Matte sigma.  The oracle's Halton stream is deterministic, so the
# +h/-h renders share every sample decision and the FD noise is dominated
# by the parameter's own effect (common random numbers).
GRAD_CONFIGS = {
    # name: (param, h, base cfg)
    "ref_grad_kd": ("kd", 0.05,
                    _cfg(32, 32, 4096, "path", 8, 0.0, "uniform", 0)),
    "ref_grad_le": ("le", 0.25,
                    _cfg(32, 32, 4096, "path", 8, 0.0, "uniform", 0)),
    "ref_grad_sigma": ("sigma", 5.0,
                       _cfg(32, 32, 4096, "path", 8, 60.0, "uniform", 0)),
    # round-4 breadth (VERDICT r3 item 5): pscale is a scene-specific
    # parameter scale wired through the oracle (oracle_main.cpp):
    #   gmd     -> Disney roughness x pscale (DisneyMaterial.h:17)
    #   volpath -> homogeneous sigma_a/sigma_s x pscale
    #              (media/HomogeneousMedium.cpp:17-43)
    #   envmesh -> InfiniteAreaLight power x pscale
    #              (lights/InfiniteAreaLight.cpp:62-121)
    "ref_grad_disney_rough": ("pscale", 0.2,
                              _cfg(32, 32, 4096, "path", 8, 0.0, "uniform",
                                   0, scene="gmd")),
    "ref_grad_med_sigma": ("pscale", 0.1,
                           _cfg(32, 32, 4096, "volpath", 8, 0.0, "uniform",
                                0, scene="volpath")),
    "ref_grad_env": ("pscale", 0.2,
                     _cfg(32, 32, 2048, "path", 8, 0.0, "uniform", 0,
                          scene="envmesh")),
}


def build_oracle():
    if not os.path.exists(ORACLE):
        subprocess.run([os.path.join(REPO, "tools", "ref_oracle", "build.sh")],
                       check=True)


def _write_blob(n_seg=BLOB_SEG):
    path = BLOB_3D if n_seg == BLOB_SEG else f"/tmp/parity_blob_{n_seg}.3d"
    if not os.path.exists(path):
        from gnxraytracer.scene.loaders import make_blob_mesh, save_3d

        v, t, _n, _uv = make_blob_mesh(n_seg)
        save_3d(path, v, t)
    return path


def run_oracle(name, cfg):
    build_oracle()
    raw = f"/tmp/{name}.raw"
    argv = [ORACLE, raw, str(cfg["w"]), str(cfg["h"]), str(cfg["spp"]),
            cfg["integ"], str(cfg["depth"]), str(cfg["sigma"]),
            cfg["strategy"], str(cfg["skybox"]), cfg["scene"],
            str(cfg["kd"]), str(cfg["le"])]
    if cfg["scene"] == "envmesh":
        argv.append(_write_blob(cfg.get("mesh_seg", BLOB_SEG)))
    elif "pscale" in cfg:
        argv.append("-")  # placeholder mesh arg
    if "pscale" in cfg:
        argv.append(str(cfg["pscale"]))
    r = subprocess.run(argv, stdout=subprocess.DEVNULL,
                       stderr=subprocess.PIPE, check=True)
    meta = json.loads(r.stderr.decode().strip().splitlines()[-1])
    img = np.fromfile(raw, np.float32).reshape(cfg["h"], cfg["w"], 3)
    return img, meta


def cmd_goldens():
    os.makedirs(GOLDEN, exist_ok=True)
    only = sys.argv[2:] if len(sys.argv) > 2 else None
    for name, cfg in CONFIGS.items():
        if only and name not in only:
            continue
        img, meta = run_oracle(name, cfg)
        out = os.path.join(GOLDEN, f"{name}.npz")
        np.savez_compressed(out, image=img, meta=json.dumps(meta))
        print(f"{out}: mean={img.mean():.4f} {meta}")


def cmd_gradients():
    """FD gradient goldens: oracle renders at param +/- h, stored raw so
    the test can block-average and difference them itself."""
    os.makedirs(GOLDEN, exist_ok=True)
    only = sys.argv[2:] if len(sys.argv) > 2 else None
    for name, (param, h, cfg) in GRAD_CONFIGS.items():
        if only and name not in only:
            continue
        imgs = {}
        for sgn, tag in ((+1, "plus"), (-1, "minus")):
            c = dict(cfg)
            if param == "kd":
                c["kd"] = cfg["kd"] + sgn * h
            elif param == "le":
                c["le"] = cfg["le"] + sgn * h
            elif param == "pscale":
                c["pscale"] = 1.0 + sgn * h
            else:
                c["sigma"] = cfg["sigma"] + sgn * h
            imgs[tag], meta = run_oracle(f"{name}_{tag}", c)
        out = os.path.join(GOLDEN, f"{name}.npz")
        np.savez_compressed(out, plus=imgs["plus"], minus=imgs["minus"],
                            h=h, param=param, meta=json.dumps(cfg))
        fd = (imgs["plus"] - imgs["minus"]) / (2 * h)
        print(f"{out}: d(mean)/d{param} = {fd.mean((0, 1))}")


def cmd_baseline():
    """Measure the reference at the two headline workloads on this host."""
    out = {}
    for key, cfg in {
        # bench.py workload: 500^2, 256 spp, path depth 8
        "path_500px_256spp": _cfg(500, 500, 256, "path", 8, 60.0, "uniform", 1),
        # the reference app's own default: whitted depth 5, 32 spp
        "whitted_500px_32spp": _cfg(500, 500, 32, "whitted", 5, 60.0, "uniform", 1),
        # BASELINE config 4 scale: envmesh at bench resolution with the
        # DRAGON-SCALE blob (n_seg=229 -> ~105k tris, the same size
        # bench.py renders) so mesh_vs_baseline compares like with like
        "envmesh_500px_64spp": _cfg(500, 500, 64, "path", 8, 0.0, "uniform", 0,
                                    scene="envmesh", mesh_seg=229),
    }.items():
        _, meta = run_oracle("baseline_" + key, cfg)
        out[key] = meta
        print(key, meta)
    path = os.path.join(REPO, "BASELINE_MEASURED.json")
    with open(path, "w") as f:
        json.dump({
            "host": "2-core Xeon 2.1GHz (builder VM), reference compiled -O2 -fopenmp",
            "note": "headless oracle (tools/ref_oracle) = unmodified reference "
                    "render core; scene = RenderThread.cpp Cornell minus the "
                    "missing dragon asset",
            "workloads": out,
        }, f, indent=1)
    print("wrote", path)


def block_mean(img, b=8):
    h, w, c = img.shape
    return img[: h // b * b, : w // b * b].reshape(h // b, b, w // b, b, c).mean((1, 3))


def compare_one(name, ours, spp_ours):
    z = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    ref = z["image"]
    meta = json.loads(str(z["meta"]))
    d = ours - ref
    bref, bours = block_mean(ref), block_mean(ours)
    bd = np.abs(bours - bref).mean() / max(bref.mean(), 1e-9)
    return {
        "config": name,
        "ref_mean": [round(float(x), 4) for x in ref.mean((0, 1))],
        "ours_mean": [round(float(x), 4) for x in ours.mean((0, 1))],
        "pix_mad_rel": round(float(np.abs(d).mean() / ref.mean()), 4),
        "block8_mad_rel": round(float(bd), 4),
        "ref_spp": meta["spp"], "ours_spp": spp_ours,
    }


def build_our_scene(meta):
    """Build our twin of an oracle scene from golden metadata."""
    from gnxraytracer.scene import presets

    w, h = meta["w"], meta["h"]
    scene_name = meta.get("scene", "cornell")
    if scene_name == "cornell":
        return presets.cornell_box(w, h, sigma=meta["sigma"],
                                   skybox=bool(meta["skybox"]))
    if scene_name == "gmd":
        return presets.cornell_gmd(w, h, sigma=meta["sigma"])
    if scene_name == "volpath":
        return presets.cornell_homogeneous(w, h)
    if scene_name == "gridvol":
        return presets.cornell_gridvol(w, h)
    if scene_name == "metal":
        return presets.cornell_metal(w, h)
    if scene_name == "envmesh":
        scene, cam, _mesh = presets.envmap_mesh_parity(
            w, h, n_seg=BLOB_SEG, sigma=meta["sigma"])
        return scene, cam
    raise ValueError(scene_name)


def render_ours(name, spp):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from gnxraytracer.models.integrators import direct as D
    from gnxraytracer.models.integrators import path as P
    from gnxraytracer.models.integrators import volpath as V
    from gnxraytracer.models.integrators import whitted as Wt
    from gnxraytracer.ops import samplers

    z = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    meta = json.loads(str(z["meta"]))
    w, h = meta["w"], meta["h"]
    scene, cam = build_our_scene(meta)
    cfg = P.make_config(scene, w, h, spp=spp, max_depth=meta["max_depth"],
                        spp_chunk=32)
    smp = samplers.make_halton_sampler(spp, w, h)
    mod = {"path": P, "direct": D, "whitted": Wt, "volpath": V}[meta["integrator"]]
    acc = jnp.zeros((w * h, 3), jnp.float32)
    s = 0
    while s < spp:
        ns = min(32, spp - s)
        acc = acc + mod._render_chunk_jit(scene, cam, smp, cfg, s, ns)
        s += ns
    return np.asarray(acc).reshape(h, w, 3) / spp


def cmd_compare():
    spp = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    only = sys.argv[3:] if len(sys.argv) > 3 else None
    for name in CONFIGS:
        if name.endswith("128"):
            continue
        if only and name not in only:
            continue
        ours = render_ours(name, spp)
        print(json.dumps(compare_one(name, ours, spp)))


if __name__ == "__main__":
    cmd = sys.argv[1] if len(sys.argv) > 1 else "compare"
    {"goldens": cmd_goldens, "gradients": cmd_gradients,
     "baseline": cmd_baseline, "compare": cmd_compare}[cmd]()
