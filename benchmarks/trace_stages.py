#!/usr/bin/env python
"""Per-stage device time of the VGA u16 stream (batch 8) from a profiler
trace, with the bytes each stage moves against the card's HBM rate.

One process, one GPU. XLA's command buffers (CUDA graphs) are off, so
that every kernel event names its HLO instruction; the step time this
tool prints is that of this mode, and the served program (command
buffers on) is timed by chip_smoke.py and bench.py. The tool runs the
entry's own program (``Segmenter.device_forward_stream``), times it end
to end (labels on the host), traces one batch with ``jax.profiler`` and
reduces the trace:

  * every kernel event is matched to its HLO instruction in the compiled
    module by the event's ``hlo_op`` stat;
  * the instruction's ``op_name`` metadata carries the ``jax.named_scope``
    path (pipeline.py: unproject, normals, seeds, grow, cluster;
    planar_batched.py: stage_a, closure_epochs, flood; connectivity.py:
    ccl), which assigns the event to a stage (innermost scope wins);
  * the bytes of a launch are what it has to move (``launch_bytes``);
  * a stage's bound is its bytes over the card's HBM rate, as the
    profiler reports it for the device. A stage whose bytes over its time
    come out above that rate gets no ratio: either its count is too high
    or its data came from L2, and the table says so.

The device idle share is one minus the union of kernel intervals over the
traced step's host span. A large plain copy measured in the same process
gives the rate a real kernel reaches on this card.

Run on the GPU: python benchmarks/trace_stages.py [--out DIR]
Writes DIR/trace_stages.json, and the trace with the compiled module's
text under DIR/trace_stages_xplane/; prints a table in which every line
names the card and its power limit.
"""

import argparse
import collections
import glob
import json
import os
import re
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, W, BATCH = 480, 640, 8

# Innermost first: an event belongs to the first scope in its op_name path
# found in this list.
STAGES = ("flood", "closure_epochs", "stage_a", "grow", "ccl", "cluster",
          "discontinuity", "seeds", "normals", "unproject")

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2,
                "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
                "f64": 8, "c64": 8, "c128": 16}
_SHAPE = re.compile(r"\b(" + "|".join(_DTYPE_BYTES) + r")\[([\d,]*)\]")
_INSTR = re.compile(r"^\s+(ROOT\s+)?%?([\w.\-]+) = (.*)$")
_OPCODE = re.compile(r"(?:^|[\s)])([a-z][\w\-]*)\(")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"\bcalls=%?([\w.\-]+)")
_COMPUTATION = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)")

# Ops that read only a window of their first operand, ops that pass their
# first operand's elements through unchanged, and ops that update their
# first operand in place when they are a fusion's result.
_WINDOW = ("slice", "dynamic-slice", "gather")
_VIEW = ("bitcast", "reshape", "get-tuple-element")
_IN_PLACE = ("dynamic-update-slice", "scatter")

Instr = collections.namedtuple(
    "Instr", "opcode sizes operands calls root op_name")


def shape_sizes(text):
    """Bytes of each array in a shape's text (one per tuple element)."""
    sizes = []
    for dt, dims in _SHAPE.findall(text):
        n = 1
        for d in filter(None, dims.split(",")):
            n *= int(d)
        sizes.append(n * _DTYPE_BYTES[dt])
    return sizes


def shape_bytes(text):
    return sum(shape_sizes(text))


def parse_module(text):
    """{computation name: {instruction name: Instr}} of an optimized HLO
    module's text."""
    comps, body = {}, None
    for line in text.splitlines():
        if line.strip() == "}":
            body = None
            continue
        if not line.startswith(" ") and line.rstrip().endswith("{"):
            body = comps.setdefault(_COMPUTATION.match(line).group(1), {})
            continue
        m = _INSTR.match(line)
        if body is None or not m:
            continue
        root, name, rhs = m.groups()
        op = _OPCODE.search(rhs)
        if not op:
            continue
        depth, i = 1, op.end()
        while i < len(rhs) and depth:
            depth += {"(": 1, ")": -1}.get(rhs[i], 0)
            i += 1
        calls = _CALLS.search(rhs, i)
        op_name = _OP_NAME.search(rhs)
        body[name] = Instr(
            opcode=op.group(1), sizes=shape_sizes(rhs[:op.start(1)]),
            operands=re.findall(r"%([\w.\-]+)", rhs[op.end():i - 1]),
            calls=calls.group(1) if calls else None, root=bool(root),
            op_name=op_name.group(1) if op_name else "")
    return comps


def fusion_bytes(comp):
    """Bytes a fused computation moves. A parameter is read in full
    unless the computation only takes windows of it (then the windows
    count) or updates it in place (then nothing of it is read); the result
    is written in full, except that an in-place update writes its
    window."""
    users = collections.defaultdict(list)
    for name, ins in comp.items():
        for k, o in enumerate(ins.operands):
            users[o].append((name, k))

    def demand(name):
        ins = comp[name]
        full = sum(ins.sizes)
        kept = ins.opcode in _IN_PLACE     # the result aliases the input
        total = 0 if kept or not ins.root else full
        for u, k in users[name]:
            user = comp[u]
            if user.opcode in _VIEW or (k == 0 and user.opcode in _IN_PLACE):
                total += demand(u)
            elif k == 0 and user.opcode in _WINDOW:
                total += sum(user.sizes)
            elif user.opcode == "tuple" and user.root:
                total += 0 if kept else full
            else:
                return full
        return min(total, full)

    def written(name):
        ins = comp[name]
        if ins.opcode == "tuple":
            return sum(written(o) for o in ins.operands)
        if ins.opcode == "bitcast":
            return written(ins.operands[0])
        if ins.opcode == "dynamic-update-slice":
            return sum(comp[ins.operands[1]].sizes)
        if ins.opcode == "scatter":      # operands, indices, updates
            n = len(ins.operands) // 2
            return sum(sum(comp[o].sizes) for o in ins.operands[n + 1:])
        return sum(ins.sizes)

    reads = sum(demand(name) for name, ins in comp.items()
                if ins.opcode == "parameter")
    root = next(name for name, ins in comp.items() if ins.root)
    return reads + written(root)


def parse_hlo(text):
    """{instruction name: (bytes it moves, op_name)} for the instructions
    of an optimized HLO module that can launch work: those outside fused
    computations."""
    comps = parse_module(text)
    fused = {ins.calls for body in comps.values() for ins in body.values()
             if ins.opcode == "fusion"}
    sizes = {name: sum(ins.sizes) for body in comps.values()
             for name, ins in body.items()}
    out = {}
    for cname, body in comps.items():
        if cname in fused:
            continue
        for name, ins in body.items():
            if ins.opcode == "fusion":
                nbytes = fusion_bytes(comps[ins.calls])
            else:
                # a library call's tuple result ends in its scratch space
                written = (ins.sizes[:1] if ins.opcode == "custom-call"
                           else ins.sizes)
                nbytes = (sum(sizes.get(o, 0) for o in ins.operands)
                          + sum(written))
            out[name] = (nbytes, ins.op_name)
    return out


def stage_of(op_name):
    # scopes appear bare ("grow/...") or wrapped by transforms ("vmap(grow)")
    words = set(re.findall(r"[A-Za-z_]+", op_name))
    for s in STAGES:
        if s in words:
            return s
    return "other"


def _norm(name):
    return re.sub(r"[.\-]", "_", name)


def stage_rows(stages, hbm_bytes_per_s):
    """Table rows, slowest stage first, of ``{stage: {ns, launches,
    bytes}}`` against the HBM rate. A stage whose count exceeds what HBM
    can deliver in its time gets no ratio."""
    rows = []
    for st, v in sorted(stages.items(), key=lambda kv: -kv[1]["ns"]):
        bound_ns = v["bytes"] / hbm_bytes_per_s * 1e9
        rate = v["bytes"] / (v["ns"] / 1e9) if v["ns"] else 0.0
        above = rate > hbm_bytes_per_s
        rows.append({
            "stage": st, "device_ms_per_batch": v["ns"] / 1e6,
            "launches": v["launches"],
            "us_per_launch": v["ns"] / 1e3 / v["launches"],
            "bytes": v["bytes"], "bytes_per_s": rate,
            "hbm_bound_ms": bound_ns / 1e6,
            "above_hbm_rate": above,
            "times_off_bound": (v["ns"] / bound_ns
                                if bound_ns and not above else None)})
    return rows


def reduce_trace(xplane_path, hlo, host_span_ns):
    """Stages, busy time, idle share and top kernels of the kernel
    events in one trace file; also the HBM rate the profiler reports."""
    from jax.profiler import ProfileData
    by_norm = {_norm(k): v for k, v in hlo.items()}
    prof = ProfileData.from_file(xplane_path)
    stages = collections.defaultdict(
        lambda: {"ns": 0, "launches": 0, "bytes": 0})
    kernels = collections.defaultdict(lambda: [0, 0, 0, ""])
    intervals, hbm = [], None
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        hbm = hbm or dict(plane.stats).get("memory_bandwidth")
        # kernels run on the "Stream #..." lines; derived lines repeat them
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                dur = int(ev.duration_ns)
                intervals.append((int(ev.start_ns), int(ev.start_ns) + dur))
                key = _norm(str(dict(ev.stats).get("hlo_op", "")))
                if key in by_norm:
                    nbytes, op_name = by_norm[key]
                    st = stage_of(op_name)
                    k = kernels[key]
                    k[0] += dur
                    k[1] += 1
                    k[2], k[3] = nbytes, op_name
                else:       # copies to the host: loop predicates, results
                    nbytes, st = 0, "memcpy" if "Memcpy" in ev.name \
                        else "unmatched"
                stages[st]["ns"] += dur
                stages[st]["launches"] += 1
                stages[st]["bytes"] += nbytes
    if not hbm:
        sys.exit("trace_stages: the trace reports no device memory rate")
    intervals.sort()
    busy, cur_s, cur_e = 0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:40]
    return {
        "hbm_bytes_per_s": hbm,
        "stages": stage_rows(stages, hbm),
        "device_busy_ns": busy,
        "idle_share": 1 - busy / host_span_ns,
        "top_kernels": [{"hlo": k, "ns": v[0], "launches": v[1],
                         "bytes_per_launch": v[2], "op_name": v[3][:160]}
                        for k, v in top],
    }


def copy_bandwidth(jax, jnp, nbytes=1 << 30):
    """Bytes/s of a large plain elementwise copy (read + write)."""
    x = jnp.ones((nbytes // 4,), jnp.float32)
    f = jax.jit(lambda a: a + 1.0)
    f(x).block_until_ready()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        f(x).block_until_ready()
        times.append(time.perf_counter() - t0)
    return 2 * nbytes / min(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=")

    import jax
    import jax.numpy as jnp
    from pcseg_tpu.models import pipeline
    from pcseg_tpu.utils import runtime

    if jax.default_backend() != "gpu":
        sys.exit("trace_stages: JAX found no GPU")
    dev = runtime.device_record()
    card = dev["card"]
    runtime.enable_compile_cache()

    seg = pipeline.Segmenter(pipeline.SegmenterConfig())
    _, stream_args = runtime.room_stream_batch(BATCH, H, W)

    def step():
        return jax.device_get(seg.device_forward_stream(*stream_args))

    t0 = time.perf_counter()
    step()
    compile_s = time.perf_counter() - t0
    text = seg._forward_stream.lower(*stream_args).compile().as_text()
    _, times = runtime.timed(step, 5)
    step_s = statistics.median(times)

    trace_dir = os.path.join(args.out, "trace_stages_xplane")
    with jax.profiler.trace(trace_dir):
        t0 = time.perf_counter_ns()
        step()
        host_span = time.perf_counter_ns() - t0
    with open(os.path.join(trace_dir, "module.hlo.txt"), "w") as f:
        f.write(text)
    path = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                         "*", "*.xplane.pb")))[-1]
    red = reduce_trace(path, parse_hlo(text), host_span)
    copy_bps = copy_bandwidth(jax, jnp)
    hbm = red["hbm_bytes_per_s"]

    result = {
        "device": dev, "shape": [BATCH, H, W], "command_buffers": False,
        "compile_s": compile_s, "step_ms_median": step_s * 1e3,
        "step_ms_all": [t * 1e3 for t in times],
        "traced_host_span_ms": host_span / 1e6,
        "device_busy_ms": red["device_busy_ns"] / 1e6,
        "idle_share": red["idle_share"],
        "hbm_bytes_per_s": hbm, "copy_bytes_per_s": copy_bps,
        "stages": red["stages"], "top_kernels": red["top_kernels"],
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "trace_stages.json"), "w") as f:
        json.dump(result, f, indent=2)

    print(f"stream VGA batch {BATCH}, command buffers off: compile "
          f"{compile_s:.1f} s, step {step_s * 1e3:.1f} ms (median of 5)  "
          f"[{card}]")
    print(f"traced step: host span {host_span / 1e6:.1f} ms, device busy "
          f"{red['device_busy_ns'] / 1e6:.1f} ms, idle share "
          f"{red['idle_share']:.4f}  [{card}]")
    print(f"plain 1 GiB copy: {copy_bps / 1e12:.3f} TB/s (HBM rate "
          f"{hbm / 1e12:.3f} TB/s)  [{card}]")
    for r in red["stages"]:
        off = ("above HBM rate: count too high or data in L2"
               if r["above_hbm_rate"] else
               "-" if r["times_off_bound"] is None else
               f"x{r['times_off_bound']:.1f} off bound")
        print(f"  {r['stage']:15s} {r['device_ms_per_batch']:9.3f} ms "
              f"{r['launches']:6d} launches {r['us_per_launch']:8.1f} us "
              f"each {r['bytes'] / 1e9:8.3f} GB bound "
              f"{r['hbm_bound_ms']:7.3f} ms  {off}  [{card}]")


if __name__ == "__main__":
    main()
