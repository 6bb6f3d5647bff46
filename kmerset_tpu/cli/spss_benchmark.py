"""spss-benchmark: A/B harness timing SPSS construction, fast (parallel
matching) vs slow (sequential greedy, the UST-comparison mode), printing
`time weight time ok` per mode per repeat (reference: src/spss-benchmark.cc)."""

from __future__ import annotations

import argparse
import sys
import time

from ..core import spss as spss_mod
from ..core.config import get_config
from ..ops.backend import enable_compile_cache
from ..core.kmer_set_compact import KmerSetCompact
from ..utils import flags as flag_util
from ..utils.log import enable_debug_logs, init_default_logger


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=(
            "Runs a benchmark for SPSS construction using a single k-mer "
            "set. Usage: spss-benchmark [options] <path to file>"
        )
    )
    flag_util.add_common_flags(parser, canonical=False)
    # Accepted for reference CLI compatibility (reference:
    # src/spss-benchmark.cc:28): the reference's lock-bucket concurrency
    # knob.  The vectorized greedy here is deterministic and bucket-free,
    # so the value has no effect on output or timing.
    parser.add_argument(
        "--buckets", type=int, default=1, help="number of buckets for SPSS calculation"
    )
    parser.add_argument("--repeats", type=int, default=1, help="number of repeats")
    parser.add_argument("file", help="path to compact set file")
    args = flag_util.parse_args(parser, argv)

    logger = init_default_logger()
    if args.debug:
        enable_debug_logs()
    flag_util.check_k(args.k)
    flag_util.apply_workers(args)
    enable_compile_cache()
    cfg = get_config(args.k)
    if args.buckets != 1:
        # Loud, documented no-op (reference: src/spss-benchmark.cc:28
        # feeds n_buckets into GetSPSSCanonical's lock-bucket partition,
        # spss.h:701,1044, trading determinism for concurrency; the
        # matching here is bucket-free and deterministic by design).
        logger.warning(
            "--buckets has no effect: SPSS construction is bucket-free "
            "(deterministic handshake matching); flag accepted for "
            "reference CLI compatibility"
        )

    try:
        compact = KmerSetCompact.load(cfg.k, args.file, args.decompressor)
    except Exception as e:  # noqa: BLE001
        logger.error("failed to load: %s", e)
        sys.exit(1)
    kmer_set = compact.to_kmer_set(True)

    logger.info("kmer_set.Size() = %d", kmer_set.size())
    logger.info("kmer_set.Hash() = %d", kmer_set.hash())

    logger.info("constructing unitigs")
    unitigs = spss_mod.get_unitigs_canonical(kmer_set)
    logger.info("constructed unitigs")

    trace_ctx = flag_util.trace_context(args)
    with trace_ctx:
        _run_repeats(args, cfg, logger, kmer_set, unitigs)


def _run_repeats(args, cfg, logger, kmer_set, unitigs):
    for _ in range(args.repeats):
        out = []
        for fast in (False, True):
            logger.info("fast = %s", fast)

            t0 = time.monotonic()
            spss = spss_mod.get_spss_canonical_from_unitigs(unitigs, cfg.k, fast)
            elapsed = time.monotonic() - t0
            logger.info("constructed spss: elapsed = %f", elapsed)
            out.append(f"{elapsed}")

            total_size = spss.weight()
            logger.info("total_size = %d", total_size)
            out.append(f"{total_size}")

            t0 = time.monotonic()
            reconstructed = spss_mod.get_kmer_set_from_spss(spss, cfg.k, True)
            elapsed = time.monotonic() - t0
            logger.info("reconstructed: elapsed = %f", elapsed)
            out.append(f"{elapsed}")

            is_equal = kmer_set.equals(reconstructed)
            logger.info("is_equal = %s", is_equal)
            out.append("1" if is_equal else "0")

        print(" ".join(out))


if __name__ == "__main__":
    main()
