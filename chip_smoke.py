#!/usr/bin/env python
"""Smoke test of the three user pipelines on one GPU, with outputs checked.

Runs in one process, through the CLI entry points a user calls:

  build-k15        kmerset-build --k 15 --cutoff 1 --check on a seeded
                   16,777,216-base genome (FASTA, 10 kb records): device
                   count, resident count -> graph fusion, device side tables
                   and successor, --check decode.  The dump must be
                   byte-identical to a host-forced build of the same file.
  build-k23-reads  kmerset-build --k 23 --cutoff 4 on a seeded bacterial
                   read set (5 Mbase genome, 150-base reads at 30x, 1%
                   substitution errors) read as gzip FASTA through
                   --decompressor "gzip -d": the (hi, lo) pair-lane count
                   and the device cutoff filter.  Byte-identical to host.
  multiset         kmerset-multiple-compress then -decompress over 8 related
                   sets (4.4 Mbase strains, 0.2% mutations of one genome,
                   k = 15); every decompressed set's size and hash must equal
                   kmerset-stat's for its input.

The host arms run in the same process with KMERSET_TPU_FORCE_BACKEND=host.
Every phase also checks that no device path fell back to the host
(backend.FALLBACK_COUNT), that the native host library is loaded, and that
JAX's backend is the GPU.

    python chip_smoke.py                 # one card (restricts visibility)
    python chip_smoke.py --four-cards    # mesh path on four cards only:
                                         # build-k15 and the multi-set
                                         # compress, auto-routed, against
                                         # their host-forced arms
    python chip_smoke.py --trace DIR     # also profile build-k15 into DIR

The last line of standard output is {"ok": true, "device": {...}} when every
phase passed; without a GPU, or on any failure, the script exits non-zero
and prints no such line.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

GENOME15_BASES = 1 << 24
READS_GENOME = 5_000_000
READ_LEN = 150
READ_COVERAGE = 30
READ_ERROR = 0.01
STRAIN_BASES = 4_400_000
STRAIN_MUTATION = 0.002
N_STRAINS = 8


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card mesh phase and its host arm")
    p.add_argument("--trace", default="",
                   help="capture a jax.profiler trace of build-k15 here")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--scale", type=int, default=1,
                   help="divide every input size by this (rehearsals only)")
    return p.parse_args(argv)


# -- seeded inputs ----------------------------------------------------------

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def write_fasta(path: str, codes: np.ndarray, record: int) -> None:
    """Base codes as a FASTA of `record`-base records."""
    bases = _ACGT[codes]
    with open(path, "wb") as f:
        for i in range(0, codes.shape[0], record):
            f.write(b">r%d\n" % (i // record))
            f.write(bases[i : i + record].tobytes())
            f.write(b"\n")


def write_reads_gz(path: str, rng, genome_len: int) -> int:
    """Seeded read set: a random genome sampled as READ_LEN-base reads at
    READ_COVERAGE x from both strands, with READ_ERROR substitutions,
    written as gzip (level 1) FASTA.  Returns the number of reads."""
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    n = genome_len * READ_COVERAGE // READ_LEN
    starts = rng.integers(0, genome_len - READ_LEN + 1, n)
    reads = genome[starts[:, None] + np.arange(READ_LEN)]
    rev = rng.random(n) < 0.5
    reads[rev] = 3 - reads[rev, ::-1]
    flat = reads.reshape(-1)
    err = rng.integers(0, flat.shape[0], rng.binomial(flat.shape[0], READ_ERROR))
    flat[err] = (flat[err] + rng.integers(1, 4, err.shape[0], dtype=np.uint8)) & 3
    digits = (np.arange(n)[:, None] // 10 ** np.arange(8, -1, -1)) % 10
    rows = np.empty((n, 2 + 9 + 1 + READ_LEN + 1), dtype=np.uint8)
    rows[:, 0], rows[:, 1] = ord(">"), ord("r")
    rows[:, 2:11] = digits + ord("0")
    rows[:, 11] = rows[:, -1] = ord("\n")
    rows[:, 12:-1] = _ACGT[reads]
    gz = zlib.compressobj(1, zlib.DEFLATED, 31)
    with open(path, "wb") as f:
        f.write(gz.compress(rows.tobytes()))
        f.write(gz.flush())
    return n


# -- instrumentation --------------------------------------------------------

ROUTES: collections.Counter = collections.Counter()


def _spy(patch, owner, name: str, label=None) -> None:
    """Counts successful calls (non-None result) of owner.name in ROUTES."""
    orig = getattr(owner, name)

    def wrapped(*a, **kw):
        r = orig(*a, **kw)
        if r is not None:
            ROUTES[label(r) if label else name] += 1
        return r

    patch(owner, name, wrapped)


def install_spies(resident_log: list, patch=setattr) -> None:
    """Wraps the device and mesh entry points to record the routes taken,
    and KmerCounter.from_fasta to record whether the count left a resident
    device handle.  `patch` sets an attribute (a test passes its
    monkeypatch.setattr)."""
    from kmerset_tpu.core import kmer_set_set
    from kmerset_tpu.core.kmer_counter import KmerCounter
    from kmerset_tpu.ops import backend, neighbors, resident, unitigs
    from kmerset_tpu.parallel import driver

    for name in ("device_count", "device_count_chunked", "device_unique",
                 "device_unique_chunked"):
        _spy(patch, backend, name)
    for name in ("mesh_count", "mesh_unitig_succ", "mesh_pointer_double",
                 "mesh_chain_group", "mesh_emit_chains", "mesh_matching",
                 "mesh_overlap_edges"):
        _spy(patch, driver, name)
    _spy(patch, neighbors, "device_side_tables")
    _spy(patch, unitigs, "device_unitig_succ")
    _spy(patch, unitigs, "device_unitig_sides")
    _spy(patch, resident.DeviceKmers, "filtered", lambda r: "device_cutoff_filter")
    _spy(patch, kmer_set_set, "_make_weight_oracle",
         lambda r: f"oracle:{type(r).__name__}")

    from_fasta = KmerCounter.from_fasta

    def from_fasta_spy(*a, **kw):
        c = from_fasta(*a, **kw)
        resident_log.append(c._device is not None)
        return c

    patch(KmerCounter, "from_fasta", staticmethod(from_fasta_spy))


class LogCapture(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages: list = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def values(self, prefix: str) -> list:
        return [int(m[len(prefix):]) for m in self.messages if m.startswith(prefix)]


@contextlib.contextmanager
def forced(backend_name: str):
    prev = os.environ.get("KMERSET_TPU_FORCE_BACKEND")
    if backend_name:
        os.environ["KMERSET_TPU_FORCE_BACKEND"] = backend_name
    else:
        os.environ.pop("KMERSET_TPU_FORCE_BACKEND", None)
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("KMERSET_TPU_FORCE_BACKEND", None)
        else:
            os.environ["KMERSET_TPU_FORCE_BACKEND"] = prev


def run_cli(main, argv: list) -> None:
    try:
        main(argv)
    except SystemExit as e:
        if e.code not in (None, 0):
            raise RuntimeError(f"CLI exited {e.code}: {argv}") from e


def timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def stat_sets(files: list, k: int) -> list:
    """(size, hash) per file from kmerset-stat, host-forced."""
    from kmerset_tpu.cli import kmerset_stat

    buf = io.StringIO()
    with forced("host"), contextlib.redirect_stdout(buf):
        run_cli(kmerset_stat.main, ["--k", str(k), *files])
    rows = [line.split("\t") for line in buf.getvalue().splitlines() if line]
    return [(int(r[2]), int(r[3])) for r in rows]


# -- phases -----------------------------------------------------------------


def phase_build_k15(ctx) -> dict:
    from kmerset_tpu.cli import kmerset_build

    rng = np.random.default_rng(ctx.seed)
    fa = os.path.join(ctx.work, "genome15.fasta")
    write_fasta(fa, rng.integers(0, 4, GENOME15_BASES // ctx.scale, dtype=np.uint8),
                10_000)
    out_dev = os.path.join(ctx.work, "k15_dev.txt")
    out_host = os.path.join(ctx.work, "k15_host.txt")
    argv = ["--k", "15", "--cutoff", "1", "--check"]
    trace = ["--trace", ctx.trace] if ctx.trace else []
    n_log = len(ctx.log.messages)
    ctx.resident.clear()
    dev_s = timed(lambda: run_cli(kmerset_build.main, argv + trace + ["--out", out_dev, fa]))
    kmers = ctx.log.values("kmer_set.Size() = ")[-1]
    if "kmer_set_compact -> KmerSet: ok" not in ctx.log.messages[n_log:]:
        raise AssertionError("--check decode did not report ok")
    if not ctx.four_cards and ctx.resident != [True]:
        raise AssertionError(f"count left no resident device handle: {ctx.resident}")
    with forced("host"):
        host_s = timed(lambda: run_cli(kmerset_build.main, argv + ["--out", out_host, fa]))
    if not same_bytes(out_dev, out_host):
        raise AssertionError("device dump differs from the host-forced dump")
    return {"kmers": kmers, "wall_s": dev_s, "host_wall_s": host_s,
            "dump_bytes": os.path.getsize(out_dev)}


def phase_build_k23_reads(ctx) -> dict:
    from kmerset_tpu.cli import kmerset_build
    from kmerset_tpu.ops import backend

    rng = np.random.default_rng(ctx.seed + 1)
    fa = os.path.join(ctx.work, "reads23.fasta.gz")
    n_reads = write_reads_gz(fa, rng, READS_GENOME // ctx.scale)
    out_dev = os.path.join(ctx.work, "k23_dev.txt")
    out_host = os.path.join(ctx.work, "k23_host.txt")
    argv = ["--k", "23", "--cutoff", "4", "--decompressor", "gzip -d"]
    dev_s = timed(lambda: run_cli(kmerset_build.main, argv + ["--out", out_dev, fa]))
    kmers = ctx.log.values("kmer_set.Size() = ")[-1]
    cut = ctx.log.values("cutoff_count = ")[-1]
    with forced("host"):
        host_s = timed(lambda: run_cli(kmerset_build.main, argv + ["--out", out_host, fa]))
    if not same_bytes(out_dev, out_host):
        raise AssertionError("device dump differs from the host-forced dump")
    graph = "device" if backend.should_use_device_graph(kmers, resident=True) else "host"
    return {"kmers": kmers, "cut": cut, "reads": n_reads, "wall_s": dev_s,
            "host_wall_s": host_s, "spss_route_by_gate": graph}


def make_strains(ctx, tag: str, build_force: str) -> list:
    """N_STRAINS compact set files built by kmerset-build from FASTAs of
    mutated copies of one seeded genome."""
    from kmerset_tpu.cli import kmerset_build

    rng = np.random.default_rng(ctx.seed + 2)
    n = STRAIN_BASES // ctx.scale
    base = rng.integers(0, 4, n, dtype=np.uint8)
    files = []
    with forced(build_force):
        for i in range(N_STRAINS):
            strain = base.copy()
            pos = rng.integers(0, n, int(n * STRAIN_MUTATION))
            strain[pos] = (strain[pos] + rng.integers(1, 4, pos.shape[0], dtype=np.uint8)) & 3
            fa = os.path.join(ctx.work, f"{tag}{i}.fasta")
            write_fasta(fa, strain, 10_000)
            out = os.path.join(ctx.work, f"{tag}{i}.txt")
            run_cli(kmerset_build.main, ["--k", "15", "--out", out, fa])
            files.append(out)
    return files


def decompressed_sets(ctx, directory: str) -> list:
    from kmerset_tpu.cli import kmerset_multiple_decompress

    n_log = len(ctx.log.messages)
    run_cli(kmerset_multiple_decompress.main, ["--k", "15", directory])
    msgs = ctx.log.messages[n_log:]
    sizes = [int(m.split("= ")[1]) for m in msgs if m.startswith("kmer_set.Size() = ")]
    hashes = [int(m.split("= ")[1]) for m in msgs if m.startswith("kmer_set.Hash() = ")]
    return list(zip(sizes, hashes))


def phase_multiset(ctx) -> dict:
    from kmerset_tpu.cli import kmerset_multiple_compress

    files = make_strains(ctx, "strain", "")
    want = stat_sets(files, 15)
    out = os.path.join(ctx.work, "multiset")
    compress_s = timed(lambda: run_cli(
        kmerset_multiple_compress.main,
        ["--k", "15", "--out", out, "--out_graph", out + ".dot", *files],
    ))
    got = []
    decompress_s = timed(lambda: got.extend(decompressed_sets(ctx, out)))
    if got[: len(want)] != want:
        raise AssertionError(f"decompressed (size, hash) {got} != stat {want}")
    return {"kmers": sum(s for s, _ in want), "sets": len(want),
            "wall_s": compress_s, "decompress_s": decompress_s,
            "input_bytes": sum(os.path.getsize(f) for f in files),
            "output_bytes": sum(os.path.getsize(os.path.join(out, f))
                                for f in os.listdir(out))}


def phase_four_cards(ctx) -> dict:
    import jax

    from kmerset_tpu.cli import kmerset_multiple_compress

    info = phase_build_k15(ctx)
    if not ROUTES.get("mesh_count"):
        raise AssertionError("build-k15 did not route its count through the mesh")
    files = make_strains(ctx, "mstrain", "host")
    want = stat_sets(files, 15)
    out_m = os.path.join(ctx.work, "multiset_mesh")
    out_h = os.path.join(ctx.work, "multiset_host")
    # Auto routing with four cards visible: the weight oracle's work
    # crosses the mesh gate at this size.  (Forcing the mesh would also
    # send each of the greedy loop's small SPSS builds through the
    # sharded graph programs, one compile per size class.)
    info["multiset_mesh_s"] = timed(lambda: run_cli(
        kmerset_multiple_compress.main, ["--k", "15", "--out", out_m, *files]))
    if not ROUTES.get("oracle:_MeshWeightOracle"):
        raise AssertionError("the multi-set weight oracle did not take the mesh")
    with forced("host"):
        info["multiset_host_s"] = timed(lambda: run_cli(
            kmerset_multiple_compress.main, ["--k", "15", "--out", out_h, *files]))
    names = sorted(os.listdir(out_m))
    if names != sorted(os.listdir(out_h)) or not all(
        same_bytes(os.path.join(out_m, f), os.path.join(out_h, f)) for f in names
    ):
        raise AssertionError("mesh multi-set output differs from the host-forced arm")
    with forced("host"):
        got = decompressed_sets(ctx, out_m)
    if got[: len(want)] != want:
        raise AssertionError(f"decompressed (size, hash) {got} != stat {want}")
    for d in jax.devices():
        st = d.memory_stats() or {}
        print(f"  {d}: peak_bytes_in_use {st.get('peak_bytes_in_use')} "
              f"bytes_in_use {st.get('bytes_in_use')} bytes_limit {st.get('bytes_limit')}")
    return info


# -- driver -----------------------------------------------------------------


def run_phases(ctx, phases, expect_platform: str) -> bool:
    import jax

    from kmerset_tpu.core import native
    from kmerset_tpu.ops import backend

    ok = True
    for name, fn in phases:
        ROUTES.clear()
        before = backend.FALLBACK_COUNT
        t0 = time.perf_counter()
        try:
            info = fn(ctx)
            problems = []
            if backend.FALLBACK_COUNT != before:
                problems.append(f"{backend.FALLBACK_COUNT - before} device fallbacks")
            if native.get_lib() is None:
                problems.append("native host library not loaded")
            if jax.default_backend() != expect_platform:
                problems.append(f"backend is {jax.default_backend()}")
            if problems:
                raise AssertionError("; ".join(problems))
            status = "ok"
        except Exception as e:  # noqa: BLE001 - report every phase, then fail
            import traceback

            traceback.print_exc()
            info, status, ok = {}, f"FAILED: {e!r}", False
        total = time.perf_counter() - t0
        print(f"[{name}] {status} (phase {total:.3f} s incl. inputs and host arm)")
        for key, val in info.items():
            print(f"  {key}: {val}")
        print(f"  routes: {dict(ROUTES) or 'host only'}", flush=True)
    return ok


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.four_cards:
        vis = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = vis.split(",")[0] if vis else "0"
    import jax

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX's backend is {jax.default_backend()}", file=sys.stderr)
        return 2
    return run(args, "gpu")


def run(args, expect_platform: str) -> int:
    import jax

    sys.path.insert(0, ROOT)
    subprocess.run(["make", "-B", "-C", os.path.join(ROOT, "native"),
                    f"PY={sys.executable}"], check=True, stdout=subprocess.DEVNULL)
    from kmerset_tpu.core import native
    from kmerset_tpu.ops import backend
    from kmerset_tpu.utils.log import init_default_logger

    if native.get_lib() is None:
        print("native/libkmerio.so did not load", file=sys.stderr)
        return 1
    backend.enable_compile_cache()
    smi = shutil.which("nvidia-smi")
    if smi:
        print(subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
    devs = jax.devices()
    if args.four_cards and len(devs) < 4:
        print(f"--four-cards needs 4 devices, found {len(devs)}", file=sys.stderr)
        return 1
    dev = devs[0]
    print(f"jax {jax.__version__}, {len(devs)} x {dev.device_kind}, bytes_limit "
          f"{(dev.memory_stats() or {}).get('bytes_limit')}")
    # Phase times include what a user's process pays on the way (the link
    # probe, in the first device arm); the window sizing that only inputs
    # past the static ceiling pay runs after the phases.
    print(f"static MAX_DEVICE_WINDOWS {backend.MAX_DEVICE_WINDOWS}, "
          f"CHUNK_WINDOWS {backend.CHUNK_WINDOWS}")

    ctx = argparse.Namespace(seed=args.seed, scale=args.scale, trace=args.trace,
                             four_cards=args.four_cards, resident=[],
                             log=LogCapture(), work=tempfile.mkdtemp(prefix="kmerset_smoke_"))
    init_default_logger().addHandler(ctx.log)
    install_spies(ctx.resident)
    if args.four_cards:
        phases = [("four-cards", phase_four_cards)]
    else:
        phases = [("build-k15", phase_build_k15),
                  ("build-k23-reads", phase_build_k23_reads),
                  ("multiset", phase_multiset)]
    try:
        ok = run_phases(ctx, phases, expect_platform)
    finally:
        shutil.rmtree(ctx.work, ignore_errors=True)
    slow = backend._slow_link()
    print(f"link probe: {'slow' if slow else 'fast'}")
    for k in (15, 23):
        t0 = time.perf_counter()
        max_w, chunk_w = backend.size_device_windows(backend.MAX_DEVICE_WINDOWS + 1, k)
        print(f"k={k} past the static ceiling: MAX_DEVICE_WINDOWS {max_w}, "
              f"CHUNK_WINDOWS {chunk_w} (sized in {time.perf_counter() - t0:.3f} s)")
    ok = ok and not slow
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
