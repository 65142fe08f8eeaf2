"""Device time per detector stage, from a profiler trace of the jitted
program.

    python tools/trace_stages.py [--backend scan] [--out DIR]

Compiles the vmapped detect program at the bench scene (1080p mono8, batch
8), times it untraced (warmup, then `jax.block_until_ready`), then traces
five calls with `jax.profiler`. Each device kernel is attributed to the detector stages
(`detector.STAGES`) named in the op_name metadata of the HLO instruction it
ran. Prints one JSON line: per-stage
device ms per call, the device's busy and idle share of the traced window,
and each stage's share of device time; `--out` also receives the JSON and
the 40 longest kernels. XLA's command buffers are switched off, so that
every kernel carries its own HLO annotation in the trace; the untraced time
is therefore that of the program without command buffers, not of the
production program (`bench.py` times that). Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import tempfile
import time

HW = (1080, 1920)   # the bench scene
BATCH = 8
ITERS = 5

def _scope_path(op_name: str, stages) -> str | None:
    """'jit(f)/vmap(ccl)/while/body/vmap(contraction)/sort' -> 'ccl/contraction'."""
    known = set(stages)
    parts = []
    for comp in op_name.split("/"):
        m = re.fullmatch(r"(?:\w+\()*([\w.]+)\)*", comp)
        name = m.group(1) if m else comp
        if name in known and name not in parts:
            parts.append(name)
    return "/".join(parts) or None


def instruction_stages(hlo_text: str, stages) -> dict[str, str]:
    """HLO instruction name -> stage path, from op_name metadata; an
    instruction without a scope (e.g. a fusion) takes the first scope found
    in the computations it calls."""
    comp_of, own, calls = {}, {}, collections.defaultdict(list)
    members = collections.defaultdict(list)
    comp = None
    for line in hlo_text.splitlines():
        head = re.match(r"\s*(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s*->.*\{\s*$", line)
        if head and "=" not in line.split("(")[0]:
            comp = head.group(1)
            continue
        inst = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=", line)
        if not inst or comp is None:
            continue
        name = inst.group(1)
        comp_of[name] = comp
        members[comp].append(name)
        m = re.search(r'op_name="([^"]*)"', line)
        if m:
            path = _scope_path(m.group(1), stages)
            if path:
                own[name] = path
        for c in re.findall(r"(?:calls|to_apply|body|condition|branch_computations)="
                            r"\{?%?([\w.\-]+(?:,\s*%?[\w.\-]+)*)\}?", line):
            calls[name].extend(x.strip().lstrip("%") for x in c.split(","))

    def resolve(name, seen):
        if name in own:
            return own[name]
        for c in calls.get(name, ()):
            if c in seen:
                continue
            seen.add(c)
            for member in members.get(c, ()):
                path = resolve(member, seen)
                if path:
                    return path
        return None

    return {n: resolve(n, set()) or "other" for n in comp_of}


def reduce_trace(xplane: str, inst_stage: dict[str, str], module: str):
    """Device-plane events of one xplane file -> (per-stage ns, busy ns,
    window ns, top kernels)."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane)
    per_stage = collections.Counter()
    per_kernel = collections.Counter()
    intervals = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                mod = str(stats.get("hlo_module", ""))
                if op is None:
                    continue
                dur = int(ev.duration_ns)
                start = int(ev.start_ns)
                intervals.append((start, start + dur))
                stage = inst_stage.get(str(op), "other") \
                    if module in mod else "other_module"
                per_stage[stage] += dur
                per_kernel[(stage, str(op))] += dur
    if not intervals:
        raise RuntimeError("no annotated device events in the trace")
    intervals.sort()
    busy, cur_s, cur_e = 0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    return per_stage, busy, window, per_kernel.most_common(40)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="scan")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()

    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from isaac_ros_apriltag_tpu import DetectorConfig
    from isaac_ros_apriltag_tpu.detector import STAGES, build_detect_fn
    from isaac_ros_apriltag_tpu.utils.cache import enable_compile_cache
    from isaac_ros_apriltag_tpu.utils.device import require_gpu
    from isaac_ros_apriltag_tpu.utils.render import six_tag_scene

    dev = require_gpu("trace_stages")[0]
    enable_compile_cache()
    H, W = HW
    cam, frame, _ = six_tag_scene(H, W)
    x = jnp.asarray(np.stack([frame] * BATCH))
    fn = jax.vmap(build_detect_fn(DetectorConfig(backend=args.backend,
                                                 tag_size=0.3), cam, "mono8"))
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(x).compile()
    compile_s = time.perf_counter() - t0
    hlo = compiled.as_text()
    module = re.search(r"HloModule\s+([\w.\-]+)", hlo).group(1)
    inst_stage = instruction_stages(hlo, STAGES)

    out = jax.block_until_ready(compiled(x))
    n_det = int(np.asarray(out[1].num_detections).sum())
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = compiled(x)
    jax.block_until_ready(out)
    wall_ms = 1000 * (time.perf_counter() - t0) / ITERS

    tdir = tempfile.mkdtemp(prefix="trace_stages_")
    jax.profiler.start_trace(tdir)
    for _ in range(ITERS):
        out = compiled(x)
    jax.block_until_ready(out)
    jax.profiler.stop_trace()
    xplane = glob.glob(os.path.join(tdir, "plugins", "profile", "*",
                                    "*.xplane.pb"))[0]
    per_stage, busy, window, top = reduce_trace(xplane, inst_stage, module)
    total = sum(v for k, v in per_stage.items() if k != "other_module")
    res = {
        "platform": dev.platform, "device_kind": dev.device_kind,
        "hw": [H, W], "batch": BATCH, "backend": args.backend,
        "iters": ITERS, "detections": n_det,
        "compile_s": round(compile_s, 2),
        "untraced_ms_per_call_no_command_buffers": round(wall_ms, 3),
        "device_ms_per_call": {k: round(v / 1e6 / ITERS, 4)
                               for k, v in per_stage.most_common()},
        "stage_share": {k: round(v / total, 4)
                        for k, v in per_stage.most_common()
                        if k != "other_module"},
        "busy_ms_per_call": round(busy / 1e6 / ITERS, 4),
        "window_ms_per_call": round(window / 1e6 / ITERS, 4),
        "idle_share": round(1.0 - busy / window, 4),
    }
    print(json.dumps(res), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"stages_{args.backend}.json"), "w") as f:
            json.dump(dict(res, top_kernels=[
                [s, op, round(ns / 1e6 / ITERS, 4)]
                for (s, op), ns in top]), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
