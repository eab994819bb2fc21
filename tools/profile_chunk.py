"""Profile chunks of one cell on the GPU with the JAX profiler and print the
device time by operation, the device busy share of the traced window, and
the kernel time of the BVH traversal kernel.

    python tools/profile_chunk.py [--cell mesh|cornell] [--chunks 2]
        [--out chiprun_out/profile_mesh]

Writes the trace (perfetto_trace.json.gz + .xplane.pb) under --out and a
summary JSON beside it; tools/profile_fusions.py groups the same trace by
fusion.  Take end-to-end times with the profiler off (bench.py).
"""

import argparse
import glob
import gzip
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from gnxraytracer.utils.runtime import (  # noqa: E402
    gpu_name_and_power_limit, setup_compile_cache)


def load_trace(out_dir):
    """(events, process names) of the newest perfetto trace under out_dir."""
    files = sorted(glob.glob(os.path.join(out_dir, "**",
                                          "perfetto_trace.json.gz"),
                             recursive=True), key=os.path.getmtime)
    assert files, f"no perfetto trace under {out_dir}"
    with gzip.open(files[-1], "rt") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    names = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    return events, names


def device_summary(events, names):
    """Per-op device time, busy share of the device window, and the
    traversal kernel's time.  Device processes are those whose name says
    GPU; busy time is the union of their op intervals."""
    dev_pids = {p for p, n in names.items() if "GPU" in n or "gpu" in n}
    ops = [e for e in events if e.get("ph") == "X" and e["pid"] in dev_pids
           and e.get("dur", 0) > 0]
    assert ops, f"no device events; processes: {sorted(names.values())}"
    per_op, count = defaultdict(float), defaultdict(int)
    for e in ops:
        key = e["name"].split(".")[0]
        per_op[key] += e["dur"] / 1e3
        count[key] += 1
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in ops)
    busy, cur_lo, cur_hi = 0.0, spans[0][0], spans[0][1]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    window = spans[-1][1] - spans[0][0]
    kernel = sum(v for k, v in per_op.items() if "bvh_" in k)
    return {
        "device_processes": sorted(names[p] for p in dev_pids),
        "window_ms": window / 1e3,
        "busy_ms": busy / 1e3,
        "busy_share": busy / window,
        "bvh_kernel_ms": kernel,
        "top_ops_ms": dict(sorted(per_op.items(), key=lambda kv: -kv[1])[:40]),
        "top_ops_count": {k: count[k] for k in sorted(
            per_op, key=lambda k: -per_op[k])[:40]},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="mesh", choices=["mesh", "cornell"])
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    assert jax.devices()[0].platform == "gpu", jax.devices()
    setup_compile_cache()
    out = args.out or os.path.join("chiprun_out", f"profile_{args.cell}")
    from bench import mesh_config
    from gnxraytracer.models.integrators import path
    from gnxraytracer.ops import samplers
    from gnxraytracer.scene import presets

    if args.cell == "mesh":
        scene, camera = presets.envmap_mesh(500, 500)
        cfg = mesh_config(scene, 500, 500, spp=64)
    else:
        scene, camera = presets.cornell_box(500, 500)
        cfg = path.make_config(scene, 500, 500, spp=256, max_depth=8,
                               spp_chunk=4, rr_threshold=1.0, fast_mis=True,
                               compact_tail=True, count_rays=True)
    sampler = samplers.make_sobol_sampler(cfg.spp)

    def chunk(s):
        return path._render_chunk_jit(scene, camera, sampler, cfg, s,
                                      cfg.spp_chunk)

    jax.block_until_ready(chunk(0))  # compile outside the trace
    t0 = time.perf_counter()
    with jax.profiler.trace(out, create_perfetto_trace=True):
        for i in range(args.chunks):
            jax.block_until_ready(chunk(cfg.spp_chunk * (i + 1)))
    wall = time.perf_counter() - t0
    summary = device_summary(*load_trace(out))
    summary.update(cell=args.cell, chunks=args.chunks,
                   traced_wall_s=wall, nvidia_smi=gpu_name_and_power_limit())
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
