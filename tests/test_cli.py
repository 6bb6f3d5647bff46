"""End-to-end CLI tests: the full build -> stat -> multiple-compress ->
multiple-decompress round trip, with hash verification exactly as the
reference README prescribes (reference: README.md:42-163)."""

import re
import subprocess
import sys

import numpy as np
import pytest

from kmerset_tpu.core import kmer as kc
from kmerset_tpu.utils.random import get_random_read


def _run(args, **kw):
    return subprocess.run(
        [sys.executable, "-m", args[0], *args[1:]],
        capture_output=True,
        text=True,
        **kw,
    )


def _write_fasta(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">{i}\n{r}\n")


@pytest.fixture(scope="module")
def genome_reads():
    rng = np.random.default_rng(0)
    genome = kc.codes_to_string(rng.integers(0, 4, size=3000).astype(np.uint8))
    reads = [genome[i : i + 120] for i in range(0, len(genome) - 120, 37)]
    return genome, reads


def test_build_stat_roundtrip(tmp_path, genome_reads):
    genome, reads = genome_reads
    fasta = str(tmp_path / "reads.fasta")
    _write_fasta(fasta, reads)
    out = str(tmp_path / "set.txt")

    r = _run(
        ["kmerset_tpu.cli.kmerset_build", "--k", "15", "--check", "--out", out, fasta]
    )
    assert r.returncode == 0, r.stderr
    assert "kmer_set_compact -> KmerSet: ok" in r.stderr

    r2 = _run(["kmerset_tpu.cli.kmerset_stat", "--k", "15", out])
    assert r2.returncode == 0, r2.stderr
    i, f, size, hash_ = r2.stdout.strip().split("\t")
    assert i == "0" and f == out
    assert int(size) > 0

    # Hash printed by build must equal hash printed by stat.
    m = re.search(r"kmer_set\.Hash\(\) = (\d+)", r.stderr)
    assert m and m.group(1) == hash_


def test_build_gzip_and_cutoff(tmp_path, genome_reads):
    genome, reads = genome_reads
    fasta = str(tmp_path / "reads.fasta.gz")
    data = "".join(f">{i}\n{r}\n" for i, r in enumerate(reads))
    subprocess.run(f"gzip > {fasta}", shell=True, input=data.encode(), check=True)
    out = str(tmp_path / "set.txt.gz")
    r = _run(
        [
            "kmerset_tpu.cli.kmerset_build",
            "--k", "23",
            "--decompressor", "gzip -d",
            "--compressor", "gzip",
            "--cutoff", "2",
            "--check",
            "--out", out,
            fasta,
        ]
    )
    assert r.returncode == 0, r.stderr
    r2 = _run(
        ["kmerset_tpu.cli.kmerset_stat", "--k", "23", "--decompressor", "gzip -d", out]
    )
    assert r2.returncode == 0, r2.stderr


def test_multiple_compress_decompress(tmp_path, genome_reads):
    genome, reads = genome_reads
    # 4 related sets: shared genome core + private mutations.
    rng = np.random.default_rng(1)
    set_files = []
    stat_lines = []
    for s in range(4):
        extra = kc.codes_to_string(rng.integers(0, 4, size=400).astype(np.uint8))
        fasta = str(tmp_path / f"r{s}.fasta")
        _write_fasta(fasta, reads + [extra])
        out = str(tmp_path / f"s{s}.txt")
        r = _run(["kmerset_tpu.cli.kmerset_build", "--k", "15", "--out", out, fasta])
        assert r.returncode == 0, r.stderr
        set_files.append(out)
    r = _run(["kmerset_tpu.cli.kmerset_stat", "--k", "15", *set_files])
    assert r.returncode == 0
    stats = [line.split("\t") for line in r.stdout.strip().splitlines()]

    outdir = str(tmp_path / "compressed")
    dot = str(tmp_path / "g.dot")
    r = _run(
        [
            "kmerset_tpu.cli.kmerset_multiple_compress",
            "--k", "15",
            "--out", outdir,
            "--out_graph", dot,
            *set_files,
        ]
    )
    assert r.returncode == 0, r.stderr
    dot_text = open(dot).read()
    assert dot_text.startswith("digraph G {")

    r = _run(
        ["kmerset_tpu.cli.kmerset_multiple_decompress", "--k", "15", outdir]
    )
    assert r.returncode == 0, r.stderr
    hashes = re.findall(r"kmer_set\.Hash\(\) = (\d+)", r.stderr)
    sizes = re.findall(r"kmer_set\.Size\(\) = (\d+)", r.stderr)
    # First 4 reconstructed sets must match the stat output of the originals.
    for i in range(4):
        assert hashes[i] == stats[i][3], f"hash mismatch for set {i}"
        assert sizes[i] == stats[i][2], f"size mismatch for set {i}"


def test_spss_benchmark(tmp_path, genome_reads):
    genome, reads = genome_reads
    fasta = str(tmp_path / "reads.fasta")
    _write_fasta(fasta, reads)
    out = str(tmp_path / "set.txt")
    r = _run(["kmerset_tpu.cli.kmerset_build", "--k", "15", "--out", out, fasta])
    assert r.returncode == 0
    r = _run(["kmerset_tpu.cli.spss_benchmark", "--k", "15", "--repeats", "1", out])
    assert r.returncode == 0, r.stderr
    fields = r.stdout.strip().split()
    # t1 w1 t1' ok1 t2 w2 t2' ok2
    assert len(fields) == 8
    assert fields[3] == "1" and fields[7] == "1"


def test_unsupported_k():
    r = _run(["kmerset_tpu.cli.kmerset_build", "--k", "14", "/dev/null"])
    assert r.returncode != 0
    assert "unsupported k value" in (r.stderr + r.stdout)


@pytest.mark.parametrize("k", [19, 23, 31])
def test_build_check_other_k(tmp_path, genome_reads, k):
    """k=19 (int32-pair keys, N=10) and k=23 (N=14) round-trip via --check
    (reference k dispatch: src/kmerset-build.cc:130-143); k=31 is this
    build's int64-layout CLI extension (core/config.py CLI_SUPPORTED_K)."""
    genome, reads = genome_reads
    fasta = str(tmp_path / "reads.fasta")
    _write_fasta(fasta, reads)
    out = str(tmp_path / f"set{k}.txt")
    r = _run(
        ["kmerset_tpu.cli.kmerset_build", "--k", str(k), "--check", "--out", out, fasta]
    )
    assert r.returncode == 0, r.stderr
    assert "kmer_set_compact -> KmerSet: ok" in r.stderr
    r2 = _run(["kmerset_tpu.cli.kmerset_stat", "--k", str(k), out])
    assert r2.returncode == 0, r2.stderr
    assert int(r2.stdout.strip().split("\t")[2]) > 0


def test_build_mesh_backend_matches_host(tmp_path, genome_reads):
    """kmerset-build routed through the 8-virtual-device mesh produces a
    byte-identical output file and hash to the host backend (the
    production scale-out wiring, parallel/driver.py)."""
    import os

    genome, reads = genome_reads
    fasta = str(tmp_path / "reads.fasta")
    _write_fasta(fasta, reads)
    outs = {}
    hashes = {}
    for mode in ("host", "mesh"):
        out = str(tmp_path / f"set_{mode}.txt")
        env = dict(os.environ)
        env["KMERSET_TPU_FORCE_BACKEND"] = mode
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        r = _run(
            ["kmerset_tpu.cli.kmerset_build", "--k", "15", "--check",
             "--out", out, fasta],
            env=env,
        )
        assert r.returncode == 0, r.stderr
        m = re.search(r"kmer_set\.Hash\(\) = (\d+)", r.stderr)
        assert m, r.stderr
        hashes[mode] = m.group(1)
        with open(out) as f:
            outs[mode] = f.read()
    assert hashes["mesh"] == hashes["host"]
    assert outs["mesh"] == outs["host"]


def test_spss_benchmark_buckets_warns(tmp_path, genome_reads):
    """--buckets != 1 is accepted but warns loudly (documented no-op:
    the SPSS matching here is bucket-free and deterministic)."""
    genome, reads = genome_reads
    fasta = str(tmp_path / "reads.fasta")
    _write_fasta(fasta, reads)
    out = str(tmp_path / "set.txt")
    r = _run(["kmerset_tpu.cli.kmerset_build", "--k", "15", "--out", out, fasta])
    assert r.returncode == 0, r.stderr
    r2 = _run(
        ["kmerset_tpu.cli.spss_benchmark", "--k", "15", "--buckets", "4", out]
    )
    assert r2.returncode == 0, r2.stderr
    assert "--buckets has no effect" in r2.stderr
    # One line: t weight t' ok per mode, ok = 1 for both.
    fields = r2.stdout.strip().split()
    assert len(fields) == 8 and fields[3] == "1" and fields[7] == "1"


def test_workers_flag_accepted_and_applied(tmp_path, genome_reads):
    """--workers N runs the whole pipeline with the native OpenMP pool
    sized to N (reference thread-pool semantics, lib/flags.h:25-53)."""
    genome, reads = genome_reads
    fasta = str(tmp_path / "reads.fasta")
    _write_fasta(fasta, reads)
    outs = {}
    for w in ("1", "2"):
        out = str(tmp_path / f"set_w{w}.txt")
        r = _run(
            ["kmerset_tpu.cli.kmerset_build", "--k", "15", "--workers", w,
             "--out", out, fasta]
        )
        assert r.returncode == 0, r.stderr
        with open(out) as f:
            outs[w] = f.read()
    # Output is deterministic regardless of thread count.
    assert outs["1"] == outs["2"]


def test_build_trace_flag_produces_profile(tmp_path, genome_reads):
    """--trace DIR captures a jax.profiler trace during the build
    (SURVEY §5.1: the XLA-timeline upgrade of the reference's stopwatch
    logs, spss-benchmark.cc:21,80-87)."""
    import os

    genome, reads = genome_reads
    fasta = str(tmp_path / "reads.fasta")
    _write_fasta(fasta, reads)
    trace_dir = str(tmp_path / "trace")
    r = _run(
        ["kmerset_tpu.cli.kmerset_build", "--k", "15", "--trace", trace_dir,
         "--out", str(tmp_path / "s.txt"), fasta]
    )
    assert r.returncode == 0, r.stderr
    found = []
    for root, _dirs, files in os.walk(trace_dir):
        found += [f for f in files if f.endswith((".pb", ".json.gz", ".trace.json.gz", ".xplane.pb"))]
    assert found, f"no trace artifacts under {trace_dir}"


def test_build_check_is_a_real_decode(tmp_path, genome_reads, monkeypatch):
    """--check must decode from the SPSS strings, not the seeded cache:
    a corrupted encoder (here: the last SPSS string dropped after
    encoding, cache left intact) must fail the check with exit 1.
    Regression: the cache-hit check compared the source array with
    itself and could never fail."""
    from kmerset_tpu.cli import kmerset_build as kb
    from kmerset_tpu.core.kmer_set_compact import KmerSetCompact
    from kmerset_tpu.core.strings import PackedStrings

    _, reads = genome_reads
    fa = tmp_path / "r.fasta"
    _write_fasta(fa, reads)

    real = KmerSetCompact.from_kmer_set.__func__

    def corrupt(cls, kmer_set, canonical, fast=True):
        obj = real(cls, kmer_set, canonical, fast)
        obj.spss = PackedStrings.from_strings(obj.spss.to_strings()[:-1])
        return obj

    monkeypatch.setattr(
        KmerSetCompact, "from_kmer_set", classmethod(corrupt)
    )
    monkeypatch.setattr(
        sys, "argv",
        ["x", "--k", "15", "--cutoff", "1", "--check",
         "--out", str(tmp_path / "o.txt"), str(fa)],
    )
    # Logger state added by the in-process main() is restored by the
    # autouse _restore_kmerset_logger fixture (tests/conftest.py).
    with pytest.raises(SystemExit) as e:
        kb.main()
    assert e.value.code == 1


def test_paths_with_spaces_through_compressor_pipes(tmp_path, genome_reads):
    """File paths are shell-quoted in every popen pipe (FASTA fast path,
    read_lines, write_lines): a directory with spaces round-trips through
    gzip build -> stat."""
    _, reads = genome_reads
    d = tmp_path / "space dir"
    d.mkdir()
    fa = d / "r 0.fasta"
    _write_fasta(fa, reads)
    subprocess.run(["gzip", "-kf", str(fa)], check=True)
    out = d / "out set.txt.gz"
    r = _run([
        "kmerset_tpu.cli.kmerset_build", "--k", "15", "--cutoff", "1",
        "--check", "--decompressor", "gzip -d", "--compressor", "gzip",
        "--out", str(out), str(fa) + ".gz",
    ])
    assert r.returncode == 0, r.stderr
    r2 = _run([
        "kmerset_tpu.cli.kmerset_stat", "--k", "15",
        "--decompressor", "gzip -d", str(out),
    ])
    assert r2.returncode == 0, r2.stderr
    assert "\t544\t" in r2.stdout or re.search(r"\t\d+\t\d+$", r2.stdout.strip())


def test_multiple_compress_mesh_backend_matches_host(tmp_path, genome_reads):
    """kmerset-multiple-compress forced through the 8-virtual-device mesh
    (weight oracle + any device-gated SPSS phases) produces a compressed
    directory whose decompression yields the same per-set Size/Hash as the
    host run — the multi-set analogue of the mesh build e2e test."""
    import os

    genome, reads = genome_reads
    rng = np.random.default_rng(7)
    set_files = []
    for s in range(3):
        extra = kc.codes_to_string(rng.integers(0, 4, size=300).astype(np.uint8))
        fasta = str(tmp_path / f"r{s}.fasta")
        _write_fasta(fasta, reads + [extra])
        out = str(tmp_path / f"s{s}.txt")
        r = _run(["kmerset_tpu.cli.kmerset_build", "--k", "15", "--out", out, fasta])
        assert r.returncode == 0, r.stderr
        set_files.append(out)

    results = {}
    for mode in ("host", "mesh"):
        env = dict(os.environ)
        env["KMERSET_TPU_FORCE_BACKEND"] = mode
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        outdir = str(tmp_path / f"compressed_{mode}")
        r = _run(
            ["kmerset_tpu.cli.kmerset_multiple_compress", "--k", "15",
             "--out", outdir, *set_files],
            env=env,
        )
        assert r.returncode == 0, r.stderr
        r = _run(
            ["kmerset_tpu.cli.kmerset_multiple_decompress", "--k", "15", outdir],
            env=env,
        )
        assert r.returncode == 0, r.stderr
        results[mode] = (
            re.findall(r"kmer_set\.Hash\(\) = (\d+)", r.stderr),
            re.findall(r"kmer_set\.Size\(\) = (\d+)", r.stderr),
        )
    # The originals (first 3 reconstructions) must agree exactly; the
    # children split may differ only if the oracle's weights differed,
    # which byte-identical sketches forbid — assert full equality.
    assert results["mesh"] == results["host"]


def test_chip_smoke_refuses_cpu(tmp_path):
    """chip_smoke.py run where JAX finds no GPU exits non-zero and prints
    no result line."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "chip_smoke.py")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


@pytest.mark.parametrize("phase", ["build_k15", "build_k23_reads", "multiset"])
def test_chip_smoke_phases_on_cpu(phase, tmp_path, monkeypatch):
    """chip_smoke.py's phases at 1/256 of their size, with the device paths
    forced onto the CPU backend: the device arm equals the host-forced arm
    (byte-identical dumps; decompressed size/hash equal kmerset-stat's),
    and the routes it records are the device ones."""
    import argparse
    import importlib.util
    import os

    from kmerset_tpu.ops import backend
    from kmerset_tpu.utils.log import init_default_logger

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py")
    )
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "device")
    ctx = argparse.Namespace(seed=1, scale=256, trace="", four_cards=False,
                             resident=[], log=cs.LogCapture(), work=str(tmp_path))
    init_default_logger().addHandler(ctx.log)
    cs.install_spies(ctx.resident, monkeypatch.setattr)
    before = backend.FALLBACK_COUNT
    info = getattr(cs, f"phase_{phase}")(ctx)
    assert backend.FALLBACK_COUNT == before
    assert info["kmers"] > 0
    assert cs.ROUTES.get("device_count") or cs.ROUTES.get("device_unique")
