"""Shared CLI flag plumbing (reference: lib/flags.h:12-53).

argparse stand-in for absl::flags with the same flag surface and help
strings; boolean flags accept --flag / --noflag / --flag=true|false like
absl.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

from ..core.config import CLI_SUPPORTED_K

FLAG_MESSAGES = {
    "k": "the length of k-mers",
    "debug": "enable debugging messages",
    "compressor": (
        'a program to compress output files; e.g., "bzip2" for bzip2, '
        '"gzip" for gzip, and "" for no compression'
    ),
    "decompressor": (
        'a program to decompress input files; e.g., "bzip2 -d" for bzip2, '
        '"gzip -d" for gzip, and "" for no decompression'
    ),
    "workers": "number of threads to use",
    "canonical": "set this flag when handling canonical k-mers",
}


def get_flag_message(name: str) -> str:
    return FLAG_MESSAGES.get(name, "")


def _str2bool(v: str) -> bool:
    if v.lower() in ("true", "t", "1", "yes"):
        return True
    if v.lower() in ("false", "f", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"invalid boolean: {v}")


def add_bool_flag(parser: argparse.ArgumentParser, name: str, default: bool, help_: str):
    parser.add_argument(
        f"--{name}",
        nargs="?",
        const=True,
        default=default,
        type=_str2bool,
        help=help_,
    )
    parser.add_argument(
        f"--no{name}", dest=name, action="store_false", help=argparse.SUPPRESS
    )
    if not hasattr(parser, "_bool_flags"):
        parser._bool_flags = set()  # type: ignore[attr-defined]
    parser._bool_flags.add(name)  # type: ignore[attr-defined]


def parse_args(parser: argparse.ArgumentParser, argv: List[str] | None = None):
    """parse_args with absl bool-flag semantics: a bare `--flag` never
    consumes the following token (argparse's nargs='?' would swallow a
    positional, e.g. `--canonical dir`); it is rewritten to `--flag=true`
    (reference absl behavior, lib/flags.h:12-22)."""
    import sys

    if argv is None:
        argv = sys.argv[1:]
    bools = getattr(parser, "_bool_flags", set())
    argv = [a + "=true" if a.startswith("--") and a[2:] in bools else a for a in argv]
    return parser.parse_args(argv)


def add_common_flags(
    parser: argparse.ArgumentParser,
    *,
    compressor: bool = False,
    canonical: bool = True,
) -> None:
    parser.add_argument("--k", type=int, default=15, help=get_flag_message("k"))
    add_bool_flag(parser, "debug", False, get_flag_message("debug"))
    parser.add_argument(
        "--decompressor", default="", help=get_flag_message("decompressor")
    )
    if compressor:
        parser.add_argument(
            "--compressor", default="", help=get_flag_message("compressor")
        )
    parser.add_argument(
        "--workers", type=int, default=1, help=get_flag_message("workers")
    )
    # Extension over the reference flag surface (SURVEY §5.1): the
    # reference's only tracing is stopwatch logs (spss-benchmark.cc:21,
    # 80-87); here the full XLA op timeline is capturable.
    parser.add_argument(
        "--trace",
        default="",
        help="capture a jax.profiler trace of the run into this directory",
    )
    if canonical:
        add_bool_flag(parser, "canonical", True, get_flag_message("canonical"))


def trace_context(args):
    """Context manager for --trace: a `jax.profiler.trace` capture when a
    directory was given, a no-op otherwise (SURVEY §5.1's upgrade of the
    reference's stopwatch narration)."""
    import contextlib

    trace_dir = getattr(args, "trace", "")
    if not trace_dir:
        return contextlib.nullcontext()
    import jax

    return jax.profiler.trace(trace_dir)


def apply_workers(args) -> None:
    """Applies --workers to the native OpenMP pool — the reference sizes
    its boost::asio thread pools from this flag (lib/flags.h:25-53);
    here every OpenMP-parallel native loop honors it the same way."""
    from ..core import native

    native.set_threads(getattr(args, "workers", 1))


def check_k(k: int) -> None:
    if k not in CLI_SUPPORTED_K:
        # Exit code 1 like the reference (kmerset-build.cc:140-142;
        # SystemExit with a string message exits 1, with an int exits
        # that int — a bare message would exit 0 via argparse paths).
        print(f"unsupported k value: {k}", file=sys.stderr)
        raise SystemExit(1)
