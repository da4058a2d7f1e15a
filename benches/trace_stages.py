#!/usr/bin/env python3
"""Device time of each encoder stage, from one ``jax.profiler`` trace.

    python benches/trace_stages.py [--out DIR]

Encodes one warm batch of the flagship configuration (Mgzip level 3,
64 x 128 KiB) and one of level 6 (the Gzip stream with its 32 KiB halo)
under the profiler. Every device op is attributed to the named scope of
its stage (``match``, ``parse``, ``emit`` with ``pack`` and ``checksum``
inside it, ``compact``;
see ``gzp_tpu.ops.deflate_kernel``) through the op metadata of the
compiled module. Prints one JSON line per configuration: device time per
stage, the sorts' share of each stage, and the ten costliest ops. The
trace files and a sample of raw events go under ``DIR``.

XLA:GPU normally replays a program's kernels as CUDA graphs, which the
trace shows as opaque ``command_buffer`` events; this script turns them
off (``--xla_gpu_enable_command_buffer=``) so that every kernel carries
its own HLO op name. Per-kernel times are therefore those of plain
launches.
"""

from __future__ import annotations

import argparse
import collections
import glob
import io
import json
import os
import re
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ("checksum", "pack", "compact", "match", "parse", "emit")  # innermost first
# functions whose frames mark a stage; looked up innermost frame first
STAGE_FUNCS = {
    "crc32_device": "checksum", "adler32_device": "checksum",
    "pack_entries_sortscan": "pack", "pack_entries_grouped": "pack",
    "compact_outputs": "compact", "match_stage": "match",
    "parse_stage": "parse", "emit_stage": "emit",
}
_INSTR = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?op_name="([^"]*)"')
_FRAME = re.compile(r"stack_frame_id=(\d+)")
_TABLE_ROW = re.compile(r'^(\d+) (.*)$')


def _tables(hlo_text: str) -> dict[str, dict[int, str]]:
    """The FunctionNames / FileLocations / StackFrames tables of an HLO dump."""
    tables, cur = {}, None
    for line in hlo_text.splitlines():
        if line in ("FileNames", "FunctionNames", "FileLocations", "StackFrames"):
            cur = tables.setdefault(line, {})
            continue
        m = _TABLE_ROW.match(line) if cur is not None else None
        if m:
            cur[int(m.group(1))] = m.group(2)
        elif line.strip():
            cur = None
    return tables


def _frame_stage(frame: int, tables) -> str | None:
    funcs, locs, frames = (tables.get(k, {}) for k in
                           ("FunctionNames", "FileLocations", "StackFrames"))
    seen = set()
    while frame in frames and frame not in seen:
        seen.add(frame)
        row = frames[frame]
        loc = int(re.search(r"file_location_id=(\d+)", row).group(1))
        fn = re.search(r"function_name_id=(\d+)", locs.get(loc, ""))
        name = funcs.get(int(fn.group(1)), "").strip('"') if fn else ""
        if name in STAGE_FUNCS:
            return STAGE_FUNCS[name]
        frame = int(re.search(r"parent_frame_id=(\d+)", row).group(1))
    return None


_COMP = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+) \(.*\{\s*$")
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_TARGET = re.compile(r'custom_call_target="([^"]*)"')


def _sort_computations(hlo_text: str) -> set[str]:
    """Names of the computations that hold an HLO ``sort``."""
    out, cur = set(), None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m:
            cur = m.group(1)
        elif cur is not None and " sort(" in line:
            out.add(cur)
    return out


def _is_sort(line: str, sort_comps: set[str]) -> bool:
    """A sort is an HLO ``sort``, a fusion that calls one (XLA's own sort
    kernel), or a sort library call (CUB radix sort)."""
    if " sort(" in line:
        return True
    target = _TARGET.search(line)
    if target:
        return "sort" in target.group(1).lower()
    calls = _CALLS.search(line)
    return bool(calls and calls.group(1) in sort_comps)


def op_stages(hlo_text: str) -> dict[str, tuple[str, bool]]:
    """HLO instruction name -> (stage, is_sort) from the compiled module.

    The stage comes from the instruction's source stack frames when the
    dump has them, else from its ``jax.named_scope`` path; see
    :func:`_is_sort` for what counts as a sort."""
    tables = _tables(hlo_text)
    sort_comps = _sort_computations(hlo_text)
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        parts = m.group(2).split("/")
        frame = _FRAME.search(line)
        stage = _frame_stage(int(frame.group(1)), tables) if frame else None
        stage = stage or next((s for s in STAGES if s in parts), "other")
        out[m.group(1)] = (stage, _is_sort(line, sort_comps))
    return out


def device_events(trace_dir: str):
    """(op name, duration ns, stats) of every kernel on the GPU streams."""
    import jax

    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb"))
    data = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    for plane in data.planes:
        if "/device:GPU" not in plane.name:
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                stats["kernel"] = ev.name
                yield str(stats.get("hlo_op", ev.name)), ev.duration_ns, stats


def reduce_trace(events, stages: dict[str, tuple[str, bool]]) -> dict:
    per_stage = collections.Counter()
    sort_ns = collections.Counter()
    per_op = collections.Counter()
    op_count = collections.Counter()
    for name, dur, _ in events:
        stage, is_sort = stages.get(name, ("other", False))
        per_stage[stage] += dur
        if is_sort:
            sort_ns[stage] += dur
        per_op[(name, stage)] += dur
        op_count[(name, stage)] += 1
    total = sum(per_stage.values())
    return {
        "device_ms": total / 1e6,
        "stage_ms": {s: per_stage[s] / 1e6 for s in (*STAGES, "other") if per_stage[s]},
        "sort_ms": {s: sort_ns[s] / 1e6 for s in sort_ns},
        "top10": [
            {"op": n, "stage": s, "ms": d / 1e6, "launches": op_count[(n, s)]}
            for (n, s), d in per_op.most_common(10)
        ],
    }


def trace_config(label, fmt, level, block, batch, out_dir, seed=1234):
    import jax
    import jax.numpy as jnp

    from bench import make_corpus
    from gzp_tpu import ParCompress

    w = ParCompress(fmt, io.BytesIO(), num_threads=batch,
                    compression_level=level, buffer_size=block)
    n = w.block_size
    arr = np.frombuffer(make_corpus(batch * n, seed=seed), np.uint8).reshape(batch, n)
    lengths = np.full(batch, n, np.int32)
    finals = np.zeros(batch, bool)
    halo, dict_lens = w._make_halo(arr, lengths)
    args = [jnp.asarray(x) for x in (arr, lengths, finals, halo, dict_lens) if x is not None]
    hlo = w._encoder.lower(*args).compile().as_text()
    stages = op_stages(hlo)
    jax.block_until_ready(w._encoder(*args))  # warm: compile outside the trace
    tdir = os.path.join(out_dir, label)
    jax.profiler.start_trace(tdir)
    jax.block_until_ready(w._encoder(*args))
    jax.profiler.stop_trace()
    w.finish()
    events = list(device_events(tdir))
    res = reduce_trace(events, stages)
    res.update(config=label, batch=batch, block=n, level=level, events=len(events))
    with open(os.path.join(out_dir, f"{label}_hlo.txt"), "w") as f:
        f.write(hlo)
    with open(os.path.join(out_dir, f"{label}_events.json"), "w") as f:
        json.dump(
            {"sample": [(n_, d, {k: str(v) for k, v in s.items()}) for n_, d, s in events[:40]],
             "unmapped": sorted({n_ for n_, _, _ in events if n_ not in stages})[:50]},
            f, indent=1,
        )
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/trace_stages")
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
    )

    from gzp_tpu import Gzip, Mgzip
    from gzp_tpu.utils.testing import enable_compilation_cache

    enable_compilation_cache()
    for label, fmt, level in (("mgzip-l3", Mgzip, 3), ("gzip-l6", Gzip, 6)):
        res = trace_config(label, fmt, level, 128 * 1024, args.batch, args.out)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
