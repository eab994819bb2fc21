"""Group the device events of a profiler trace by XLA fusion / kernel and
its source location (the trace tools/profile_chunk.py writes).

    python tools/profile_fusions.py chiprun_out/profile_mesh [-v]
"""

import json
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_chunk import load_trace  # noqa: E402


def main():
    events, names = load_trace(sys.argv[1])
    dev_pids = {p for p, n in names.items() if "GPU" in n or "gpu" in n}
    agg, cnt, sample = defaultdict(float), defaultdict(int), {}
    for ev in events:
        if ev.get("ph") != "X" or ev["pid"] not in dev_pids:
            continue
        args = ev.get("args", {})
        key = (ev["name"].split(".")[0],
               (args.get("tf_op", "") or args.get("long_name", ""))[:140],
               args.get("source_info", "")[:80])
        agg[key] += ev.get("dur", 0) / 1e3
        cnt[key] += 1
        sample.setdefault(key, {k: str(v)[:200] for k, v in args.items()})
    rows = sorted(agg.items(), key=lambda kv: -kv[1])
    print(f"total device time listed: {sum(v for _, v in rows):.1f} ms")
    for (nm, op, src), v in rows[:40]:
        print(f"{v:9.2f} ms x{cnt[(nm, op, src)]:4d}  {nm:24s} {op}")
        if src:
            print(f"            src: {src}")
    if rows and "-v" in sys.argv:
        print(json.dumps(sample[rows[0][0]], indent=1))


if __name__ == "__main__":
    main()
