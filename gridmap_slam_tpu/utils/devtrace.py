"""Per-layer device time of one jitted call, read from a JAX profiler trace.

A layer is a `jax.named_scope` in the engine (`ENGINE_LAYERS`: the
likelihood-field build, the scan matcher, the map update).  Each kernel
event in the trace names the HLO instruction it ran (its `hlo_op` stat).
The compiled module's text maps every instruction to a layer: by the scope
in its `op_name` metadata, or, where XLA dropped the scope, by the source
files on its stack frames; a fusion takes the layer most of its fused
instructions have.  Kernels that map to no layer count as "other".
"""

from __future__ import annotations

import collections
import glob
import os
import re
from typing import Dict, Sequence, Tuple

# layer -> (named scope, source files whose ops belong to it)
ENGINE_LAYERS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "llfield": ("llfield", ("ops/grid.py",)),
    "matcher": ("matcher", ("ops/matcher.py", "ops/matcher_matmul.py",
                            "ops/matcher_splat.py")),
    "map_update": ("map_update", ("ops/raycast.py",)),
}

_COMP_START = re.compile(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$")
_INSTR = re.compile(r"^\s*(?:ROOT )?%?([\w.\-]+) = ")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_FRAME_ID = re.compile(r"stack_frame_id=(\d+)")
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_TABLE_ROW = re.compile(r"^(\d+) (.*)$")


def _tables(text: str):
    """FileNames, FileLocations and StackFrames tables of an HLO dump."""
    files, locs, frames = {}, {}, {}
    section = None
    for line in text.splitlines():
        if line in ("FileNames", "FunctionNames", "FileLocations",
                    "StackFrames"):
            section = line
            continue
        if not line.strip():
            section = None
            continue
        m = _TABLE_ROW.match(line)
        if section is None or m is None:
            continue
        key, body = int(m.group(1)), m.group(2)
        if section == "FileNames":
            files[key] = body.strip('"')
        elif section == "FileLocations":
            locs[key] = int(re.search(r"file_name_id=(\d+)", body).group(1))
        elif section == "StackFrames":
            loc = int(re.search(r"file_location_id=(\d+)", body).group(1))
            parent = int(re.search(r"parent_frame_id=(\d+)", body).group(1))
            frames[key] = (loc, parent)
    return files, locs, frames


def hlo_layers(hlo_text: str, layers=ENGINE_LAYERS) -> Dict[str, str]:
    """Instruction name -> layer for every instruction of a compiled HLO
    module (`compiled.as_text()`) that belongs to one."""
    files, locs, frames = _tables(hlo_text)

    def frame_files(fid):
        seen = set()
        while fid in frames and fid not in seen:
            seen.add(fid)
            loc, parent = frames[fid]
            yield files.get(locs.get(loc), "")
            fid = parent

    def own_layer(line):
        m = _OP_NAME.search(line)
        if m:
            path = "/" + m.group(1) + "/"
            for layer, (scope, _) in layers.items():
                if f"/{scope}/" in path:
                    return layer
        m = _FRAME_ID.search(line)
        if m:
            for fname in frame_files(int(m.group(1))):
                for layer, (_, srcs) in layers.items():
                    if any(fname.endswith(src) for src in srcs):
                        return layer
        return None

    comp_votes = collections.defaultdict(collections.Counter)
    instr_layer, instr_calls = {}, {}
    comp = None
    for line in hlo_text.splitlines():
        m = _COMP_START.match(line)
        if m and not line.startswith(" "):
            comp = m.group(1)
            continue
        m = _INSTR.match(line)
        if m is None or comp is None:
            continue
        name = m.group(1)
        layer = own_layer(line)
        instr_layer[name] = layer
        if layer is not None:
            comp_votes[comp][layer] += 1
        c = _CALLS.search(line)
        if c:
            instr_calls[name] = c.group(1)
    out = {}
    for name, layer in instr_layer.items():
        votes = comp_votes.get(instr_calls.get(name))
        if votes:
            layer = votes.most_common(1)[0][0]
        if layer is not None:
            out[name] = layer
    return out


def kernel_events(trace_dir: str):
    """(hlo_op, start_ns, duration_ns) of every kernel in the newest trace
    under `trace_dir`.  Device planes when the trace has any (GPU); the
    host's XLA threads otherwise (CPU backend)."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = ProfileData.from_file(max(paths, key=os.path.getmtime))
    planes = list(data.planes)
    device = [p for p in planes if p.name.startswith("/device:")]
    events = []
    for plane in device or planes:
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if "hlo_op" in stats:
                    events.append((str(stats["hlo_op"]), ev.start_ns,
                                   ev.duration_ns))
    return events


def layer_times(events, instr_layers: Dict[str, str],
                layers: Sequence[str] = tuple(ENGINE_LAYERS)) -> dict:
    """Sum kernel time per layer.  Returns {"layers": {layer: ns, ...,
    "other": ns}, "kernel_ns": total, "busy_ns": union of kernel
    intervals, "span_ns": first start to last end, "top_other": the
    five costliest unattributed instructions}."""
    per = {name: 0.0 for name in layers}
    per["other"] = 0.0
    other = collections.Counter()
    for op, _, dur in events:
        layer = instr_layers.get(op)
        if layer is None:
            other[op] += dur
            layer = "other"
        per[layer] += dur
    spans = sorted((s, s + d) for _, s, d in events)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return {"layers": per, "kernel_ns": sum(per.values()), "busy_ns": busy,
            "span_ns": (spans[-1][1] - spans[0][0]) if spans else 0.0,
            "top_other": other.most_common(5)}


# XLA's GPU backend launches runs of kernels as CUDA-graph command buffers,
# which the trace shows as one `command_buffer` event; the traced program
# is compiled without them so that every kernel has its own event.
TRACE_COMPILER_OPTIONS = {"xla_gpu_enable_command_buffer": ""}


def trace_layer_times(fn, args, trace_dir: str,
                      layers=ENGINE_LAYERS) -> dict:
    """Compile `fn` (a jax.jit function that donates nothing) for `args`
    with TRACE_COMPILER_OPTIONS, run it once to warm up and once under the
    profiler, and reduce the trace with `layer_times`."""
    import jax

    compiled = fn.lower(*args).compile(
        compiler_options=TRACE_COMPILER_OPTIONS)
    jax.block_until_ready(compiled(*args))
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(compiled(*args))
    return layer_times(kernel_events(trace_dir),
                       hlo_layers(compiled.as_text(), layers),
                       tuple(layers))
