"""kmerset-stat: print `i\\tfile\\tsize\\thash` TSV for compact set files
(reference: src/kmerset-stat.cc)."""

from __future__ import annotations

import argparse
import sys

from ..core.config import get_config
from ..ops.backend import enable_compile_cache
from ..core.kmer_set_compact import KmerSetCompact
from ..utils import flags as flag_util
from ..utils.log import enable_debug_logs, init_default_logger


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=(
            "Prints the metadata of a k-mer set. "
            "Usage: kmerset-stat [options] <path to file>"
        )
    )
    flag_util.add_common_flags(parser)
    parser.add_argument("files", nargs="+", help="paths to compact set files")
    args = flag_util.parse_args(parser, argv)

    logger = init_default_logger()
    if args.debug:
        enable_debug_logs()
    flag_util.check_k(args.k)
    flag_util.apply_workers(args)
    enable_compile_cache()
    cfg = get_config(args.k)

    with flag_util.trace_context(args):  # --trace captures the hot phase
        for i, file_name in enumerate(args.files):
            logger.info("processing: i = %d, file_name = %s", i, file_name)
            try:
                compact = KmerSetCompact.load(
                    cfg.k, file_name, args.decompressor
                )
            except Exception as e:  # noqa: BLE001
                logger.error("failed to load kmer_set_compact: %s", e)
                sys.exit(1)
            kmer_set = compact.to_kmer_set(args.canonical)
            size = kmer_set.size()
            hash_ = kmer_set.hash()
            logger.info("size = %d", size)
            logger.info("hash = %d", hash_)
            # Same TSV as the reference (kmerset-stat.cc:68-69).
            print(f"{i}\t{file_name}\t{size}\t{hash_}")


if __name__ == "__main__":
    main()
