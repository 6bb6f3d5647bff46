"""kmerset-build: FASTA -> counted, cutoff-filtered, SPSS-compressed k-mer
set file (reference: src/kmerset-build.cc)."""

from __future__ import annotations

import argparse
import sys

from ..core.config import get_config
from ..ops.backend import enable_compile_cache
from ..core.kmer_counter import KmerCounter
from ..core.kmer_set_compact import KmerSetCompact
from ..utils import flags as flag_util
from ..utils.log import enable_debug_logs, init_default_logger


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=(
            "Reads a FASTA file and constructs a set of k-mers. "
            "Usage: kmerset-build [options] <path to file>"
        )
    )
    flag_util.add_common_flags(parser, compressor=True)
    parser.add_argument(
        "--cutoff",
        type=int,
        default=1,
        help="ignore k-mers that appear less often than this value",
    )
    flag_util.add_bool_flag(
        parser,
        "check",
        False,
        "does compression & decompression to see if it is working correctly",
    )
    parser.add_argument("--out", default="", help="output file name")
    parser.add_argument("file", help="path to FASTA file")
    args = flag_util.parse_args(parser, argv)

    logger = init_default_logger()
    if args.debug:
        enable_debug_logs()
    flag_util.check_k(args.k)
    flag_util.apply_workers(args)
    enable_compile_cache()
    cfg = get_config(args.k)

    # Multi-host bring-up (KMERSET_TPU_DISTRIBUTED): joins this process
    # into a jax.distributed mesh so counting shards across hosts.
    from ..parallel.driver import maybe_init_distributed

    maybe_init_distributed()

    with flag_util.trace_context(args):
        logger.info("constructing kmer_counter")
        try:
            counter = KmerCounter.from_fasta(
                cfg.k, args.file, args.decompressor, args.canonical,
                spss_ahead=True,
            )
        except Exception as e:  # noqa: BLE001 - CLI boundary
            logger.error("failed to parse FASTA file: %s", e)
            sys.exit(1)
        logger.info("constructed kmer_counter")

        logger.info("constructing kmer_set")
        kmer_set, cutoff_count = counter.to_kmer_set(args.cutoff)
        logger.info("constructed kmer_set")
        logger.info("cutoff_count = %d", cutoff_count)
        logger.info("kmer_set.Size() = %d", kmer_set.size())
        logger.info("kmer_set.Hash() = %d", kmer_set.hash())

        logger.info("constructing kmer_set_compact")
        compact = KmerSetCompact.from_kmer_set(kmer_set, args.canonical, fast=True)
        logger.info("constructed kmer_set_compact")
        logger.info("kmer_set_compact.Size() = %d", compact.size())

    if args.check:
        # Decode from the SPSS strings through a FRESH compact set:
        # from_kmer_set seeds the decode cache with the source kmers, so
        # compact.to_kmer_set would compare the array with itself and the
        # check could never fail (the reference's check is a real decode,
        # src/kmerset-build.cc:91-101).
        decompressed = KmerSetCompact(compact.k, compact.spss).to_kmer_set(
            args.canonical
        )
        if kmer_set.equals(decompressed):
            logger.info("kmer_set_compact -> KmerSet: ok")
        else:
            logger.error("kmer_set_compact -> KmerSet: failed")
            sys.exit(1)

    if args.out:
        try:
            compact.dump(args.out, args.compressor)
        except Exception as e:  # noqa: BLE001
            logger.error("failed to dump kmer_set_compact: %s", e)
            sys.exit(1)


if __name__ == "__main__":
    main()
