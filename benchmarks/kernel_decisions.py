#!/usr/bin/env python
"""Kernel decisions for the count pipeline on the GPU: what XLA makes of
the plain window pack and of the sorts, and how long each takes.

For the build-k15 shape (16,777,216-base genome, k = 15) and the
build-k23-reads shape (150 Mbase of reads, k = 23) it prints:

- the window pack (2-bit unpack -> log-doubling pack -> reverse
  complement -> canonical min) compiled alone by XLA: its fusion count in
  the optimized HLO, its time, and its distance from the bytes roofline
  (packed codes read + keys written, at 3.35 TB/s);
- every sort of the fused count programs (count_kmers_frag,
  count_to_set_frag): whether XLA lowered it to CUB's radix sort (a
  custom call whose target contains "DeviceRadixSort") or to its own
  comparison sort, with operand types;
- the time of the main sort, of the compaction sort, and of the whole
  count program, each alone;
- with --trace-dir, the device time by operation of a jax.profiler
  trace (e.g. `chip_smoke.py --trace DIR`), top operations first.

    python benchmarks/kernel_decisions.py [--trace-dir DIR] [--only SECTION] [--scale N]

Times are medians of --reps runs, each ending in block_until_ready.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

SHAPES = (
    # (label, k, bases, fragments)
    ("build-k15", 15, 1 << 24, (1 << 24) // 10_000 + 1),
    ("build-k23-reads", 23, 150_000_000, 1_000_000),
)


def median_time(fn, reps: int) -> float:
    import jax

    jax.block_until_ready(fn())  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def hlo_sorts(text: str) -> list:
    """(kind, shapes) per sort in optimized HLO text: kind is 'cub' for a
    DeviceRadixSort custom call, 'xla' for XLA's own sort instruction."""
    out = []
    for line in text.splitlines():
        if "custom-call(" in line and "DeviceRadixSort" in line:
            out.append(("cub", line.split("=", 1)[1].split("custom-call(")[0].strip()))
        elif re.search(r"=\s*\S.*\ssort\(", line):
            out.append(("xla", line.split("=", 1)[1].split(" sort(")[0].strip()))
    return out


def n_fusions(text: str) -> int:
    """Fusion instructions in the entry computation of optimized HLO."""
    entry = text[text.index("ENTRY"):]
    entry = entry[: entry.index("\n}")]
    return len(re.findall(r"\sfusion\(", entry))


def shape_report(label: str, k: int, bases: int, n_frag: int, reps: int) -> None:
    import jax
    import jax.numpy as jnp

    from kmerset_tpu.ops import count as C

    n_keys = bases - (k - 1)
    n = C.good_sort_size(n_keys)
    L = n + k - 1
    rng = np.random.default_rng(k)
    packed = jnp.asarray(rng.integers(0, 256, (L + 3) // 4, dtype=np.uint8))
    bounds = np.linspace(0, bases, n_frag + 1).astype(np.int32)[1:]
    bp = 1 << max(12, int(bounds.shape[0] - 1).bit_length())
    bounds = jnp.asarray(np.concatenate([bounds, np.full(bp - bounds.shape[0], bases, np.int32)]))
    total = jnp.asarray(bases, jnp.int64)
    print(f"== {label}: k={k}, {bases} bases, sort size class {n}")

    # Window pack alone, in the production layout.
    key_bytes = 4 if k <= C.SINGLE_MAX_K else 8
    floor = (packed.shape[0] + key_bytes * n) / HBM_BYTES_PER_S
    pack_j = jax.jit(lambda p: C._window_keys(C._unpack2(p, L), k, True))
    txt = pack_j.lower(packed).compile().as_text()
    t = median_time(lambda: pack_j(packed), reps)
    print(f"  pack: {n_fusions(txt)} fusion(s), {t * 1e3:.4f} ms, roofline "
          f"{floor * 1e3:.4f} ms ({t / floor:.2f}x off)")

    # The fused count programs and their sorts.
    for name, f, extra in (("count_kmers_frag", C.count_kmers_frag, ()),
                           ("count_to_set_frag", C.count_to_set_frag, (1,))):
        lowered = f.lower(packed, bounds, total, L, k, True, *extra)
        txt = lowered.compile().as_text()
        t = median_time(lambda: f(packed, bounds, total, L, k, True, *extra), reps)
        print(f"  {name}: {t * 1e3:.4f} ms ({n_keys / t / 1e6:.1f} Mwindows/s), "
              f"{n_fusions(txt)} fusions")
        for kind, shape in hlo_sorts(txt):
            print(f"    sort [{kind}] {shape}")

    # The sorts alone, on the operands they get in the pipeline.
    keys = pack_j(packed)
    if k <= C.SINGLE_MAX_K:
        lanes = (keys[:n_keys],)
    else:
        lanes = (keys[0][:n_keys], keys[1][:n_keys])
    nk = len(lanes)
    main = jax.jit(lambda *ls: jax.lax.sort(ls, num_keys=nk, is_stable=False))
    t_main = median_time(lambda: main(*lanes), reps)
    srt = main(*lanes)
    flag = jnp.int32(1 << 28) if nk > 1 else jnp.int32(1 << 30)
    sel = jnp.asarray(rng.random(n_keys) < 0.5)
    fused = (jnp.where(sel, srt[0], srt[0] | flag),) + tuple(srt[1:])
    counts = jnp.ones(n_keys, jnp.int32)
    comp_set = jax.jit(lambda *ls: jax.lax.sort(ls, num_keys=nk, is_stable=False))
    comp_cnt = jax.jit(lambda *ls: jax.lax.sort(ls, num_keys=nk, is_stable=False))
    t_set = median_time(lambda: comp_set(*fused), reps)
    t_cnt = median_time(lambda: comp_cnt(*fused, counts), reps)
    for nm, fn, args in (("main sort", main, lanes), ("compaction sort (set)", comp_set, fused),
                         ("compaction sort (+counts)", comp_cnt, fused + (counts,))):
        kinds = [kd for kd, _ in hlo_sorts(fn.lower(*args).compile().as_text())]
        tt = {"main sort": t_main, "compaction sort (set)": t_set}.get(nm, t_cnt)
        print(f"  {nm}: {tt * 1e3:.4f} ms, {n_keys} x {nk} key lane(s), lowered to {kinds}")


def trace_report(trace_dir: str, top: int) -> None:
    import jax

    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))
    if not files:
        print(f"no .xplane.pb under {trace_dir}")
        return
    pd = jax.profiler.ProfileData.from_file(files[-1])
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        by_name = defaultdict(lambda: [0, 0])
        spans = []
        for line in plane.lines:
            for ev in line.events:
                by_name[ev.name][0] += ev.duration_ns
                by_name[ev.name][1] += 1
                spans.append((ev.start_ns, ev.end_ns))
        if not spans:
            continue
        spans.sort()
        busy, cur_s, cur_e = 0, *spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = spans[-1][1] - spans[0][0]
        print(f"== trace {plane.name}: busy {busy / 1e6:.3f} ms of a "
              f"{window / 1e6:.3f} ms window (idle {1 - busy / max(window, 1):.3f})")
        for name, (ns, cnt) in sorted(by_name.items(), key=lambda x: -x[1][0])[:top]:
            print(f"  {ns / 1e6:10.3f} ms  {cnt:6d}x  {name[:110]}")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--trace-dir", default="")
    p.add_argument("--only", choices=("shapes", "trace"), default="",
                   help="run one section only")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--scale", type=int, default=1,
                   help="divide the input sizes by this (rehearsals only)")
    args = p.parse_args()

    import jax

    from kmerset_tpu.ops.backend import enable_compile_cache

    enable_compile_cache()
    smi = shutil.which("nvidia-smi")
    if smi:
        print(subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
    dev = jax.devices()[0]
    print(f"jax {jax.__version__}, {dev.platform} {dev.device_kind}")
    if args.only in ("", "shapes"):
        for label, k, bases, n_frag in SHAPES:
            shape_report(label, k, bases // args.scale, max(1, n_frag // args.scale),
                         args.reps)
    if args.trace_dir and args.only in ("", "trace"):
        trace_report(args.trace_dir, args.top)


if __name__ == "__main__":
    main()
