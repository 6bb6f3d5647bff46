"""kmerset-multiple-decompress: reconstruct and log each original set from
a compressed directory (reference: src/kmerset-multiple-decompress.cc).

Verification protocol (reference README.md:120-135): the logged
Hash()/Size() per set must match the `kmerset-stat` output for the original
inputs."""

from __future__ import annotations

import argparse
import sys

from ..core.config import get_config
from ..ops.backend import enable_compile_cache
from ..core.kmer_set_set import KmerSetSetReader
from ..utils import flags as flag_util
from ..utils.log import enable_debug_logs, init_default_logger


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=(
            'Decompresses the output of "kmerset-multiple-compress". '
            "Usage: kmerset-multiple-decompress [options] <path to directory>"
        )
    )
    flag_util.add_common_flags(parser)
    parser.add_argument(
        "--extension", default="txt", help="extension of files in folder"
    )
    parser.add_argument("directory", help="path to directory")
    args = flag_util.parse_args(parser, argv)

    logger = init_default_logger()
    if args.debug:
        enable_debug_logs()
    flag_util.check_k(args.k)
    flag_util.apply_workers(args)
    enable_compile_cache()
    cfg = get_config(args.k)

    logger.info("loading kmer_set_set_reader")
    try:
        reader = KmerSetSetReader.from_directory(
            cfg, args.directory, args.extension, args.decompressor, args.canonical
        )
    except Exception as e:  # noqa: BLE001
        logger.error("failed to load data: %s", e)
        sys.exit(1)
    logger.info("loaded kmer_set_set_reader")
    logger.info("kmer_set_set_reader.Size() = %d", reader.size())

    with flag_util.trace_context(args):  # --trace captures the hot phase
        # get_all decodes each shared child file once across the sweep
        # (the reference re-loads per set, kmer_set_set.h:704-745);
        # output lines are identical to per-set get() calls.
        try:
            it = reader.get_all(workers=args.workers)
            for i in range(reader.size()):
                logger.info("constructing kmer_set: i = %d", i)
                _, kmer_set = next(it)
                logger.info("constructed kmer_set: i = %d", i)
                logger.info("kmer_set.Hash() = %d", kmer_set.hash())
                logger.info("kmer_set.Size() = %d", kmer_set.size())
        except Exception as e:  # noqa: BLE001
            logger.error("failed to construct kmer_set: %s", e)
            sys.exit(1)


if __name__ == "__main__":
    main()
