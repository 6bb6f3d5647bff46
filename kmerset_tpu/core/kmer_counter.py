"""KmerCounter: sort-based k-mer counting.

The reference counts k-mers into 1<<N hash-map buckets with per-thread
buffers and try_lock merges (reference: lib/core/kmer_counter.h:40-133).
The array formulation here: extract every window, canonicalize, then
sort + segment-count — no hash tables, no locks, and the hot loop is a
fixed-shape vector program (see kmerset_tpu.ops.count for the device path).

Counts saturate at a maximum value exactly like the reference's AddWithMax
with its uint8 default ValueType (reference: lib/core/kmer_counter.h:28-38,48).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import arrays
from . import io as core_io
from . import kmer as kmer_ops
from .kmer_set import KmerSet

DEFAULT_VALUE_MAX = 255  # uint8 ValueType default (reference: kmer_counter.h:48)


def extract_kmers(
    codes: np.ndarray, offsets: np.ndarray, k: int, canonical: bool
) -> np.ndarray:
    """All k-mers from concatenated fragments, canonicalized if asked.

    codes: flat 2-bit codes; offsets: fragment boundaries (windows never
    cross a fragment boundary, replicating the split-at-'N' behavior,
    reference: lib/core/kmer_counter.h:78-96).
    """
    n_pos = codes.shape[0] - k + 1
    if n_pos <= 0:
        return np.empty(0, dtype=np.int64)
    windows = kmer_ops.kmers_from_codes(codes, k)
    # Window at p is valid iff it does not straddle a fragment boundary:
    # every interior boundary b invalidates starts [b-k+1, b).  Marked via
    # a difference array + cumsum (two tiny scatters instead of two
    # n_pos-sized binary-search passes).
    bounds = offsets[1:-1] if offsets.shape[0] > 2 else np.empty(0, np.int64)
    d = np.zeros(n_pos + 1, dtype=np.int32)
    lo = np.maximum(bounds - k + 1, 0)
    hi = np.minimum(bounds, n_pos)
    np.add.at(d, lo[lo < hi], 1)
    np.add.at(d, hi[lo < hi], -1)
    invalid = np.cumsum(d[:-1]) > 0
    kmers = windows[~invalid]
    if canonical:
        kmers = kmer_ops.canonical(kmers, k)
    return kmers


class KmerCounter:
    """Sorted-array multiset of k-mers with saturating counts."""

    def __init__(
        self,
        k: int,
        kmers: np.ndarray | None = None,
        counts: np.ndarray | None = None,
        value_max: int = DEFAULT_VALUE_MAX,
    ):
        self.k = k
        self.value_max = value_max
        self.kmers = (
            np.asarray(kmers, dtype=np.int64) if kmers is not None else np.empty(0, np.int64)
        )
        # `counts` may be a 0-arg fetch closure (the device backend's
        # deferred transfer, ops/backend.device_count lazy_counts): the
        # download happens on first host access, and never if the flow
        # (e.g. a cutoff<=1 build) does not read counts at all.
        self._counts_fetch = counts if callable(counts) else None
        if callable(counts):
            self._counts = None
        else:
            self._counts = (
                np.asarray(counts, dtype=np.int64)
                if counts is not None
                else np.empty(0, np.int64)
            )
        self._pending: List[Tuple[int, int]] = []
        # Device-resident mirror of `kmers` (ops/resident.DeviceKmers),
        # set by the device counting path; carried into the KmerSet by
        # to_kmer_set so the SPSS graph phase skips its upload.
        self._device = None
        # Lazy-fetch recovery: (codes, offsets) retained while a
        # deferred counts transfer is outstanding, so a post-count
        # device failure degrades to a host recount instead of losing
        # the counts (see _recount_host).
        self._recover = None
        self._canonical = True

    @property
    def counts(self) -> np.ndarray:
        if self._counts is None:
            try:
                self._counts = np.asarray(self._counts_fetch(), dtype=np.int64)
            except Exception as e:  # noqa: BLE001 - device died post-count
                # The deferred device transfer failed.  On an accelerator
                # that is an error (_note_fallback re-raises); on the CPU
                # backend recount on the host from the retained codes —
                # the same fallback the eager path has in device_count.
                from ..ops.backend import _note_fallback
                from ..utils.log import get_logger

                _note_fallback("deferred_counts", e)
                get_logger().warning(
                    "deferred counts transfer failed (%r); recounting on host", e
                )
                self._counts = self._recount_host()
            self._counts_fetch = None
            self._recover = None
        return self._counts

    @counts.setter
    def counts(self, value) -> None:
        self._counts_fetch = None
        self._counts = np.asarray(value, dtype=np.int64)

    def _recount_host(self) -> np.ndarray:
        """Host recount aligned to self.kmers (lazy-fetch disaster path;
        raises if the recount disagrees with the device keys rather than
        returning silently wrong counts)."""
        if self._recover is None:
            raise RuntimeError(
                "deferred counts lost and no codes retained to recount"
            )
        codes, offsets = self._recover
        kmers = extract_kmers(codes, offsets, self.k, self._canonical)
        uniq, counts = arrays.sorted_unique_counts(kmers)
        if uniq.shape[0] != self.kmers.shape[0] or not np.array_equal(
            uniq, self.kmers
        ):
            raise RuntimeError("host recount disagrees with device keys")
        return np.minimum(counts, self.value_max).astype(np.int64)

    # -- construction (reference: lib/core/kmer_counter.h:62-209) ----------

    @classmethod
    def from_fasta(
        cls, k: int, file_name: str, decompressor: str, canonical: bool,
        value_max: int = DEFAULT_VALUE_MAX, spss_ahead: bool = False,
    ) -> "KmerCounter":
        # Fast path: one native pass FASTA bytes -> codes + offsets
        # (native/kmerio.c), skipping Python line splitting entirely.
        from . import native

        if native.get_lib() is not None:
            try:
                if decompressor:
                    import shlex
                    import subprocess

                    # Quote the path (data, not shell syntax) like
                    # core/io.read_lines; the command stays user-owned.
                    proc = subprocess.run(
                        f"{decompressor} < {shlex.quote(file_name)}",
                        shell=True,
                        capture_output=True,
                    )
                    if proc.returncode != 0:
                        raise core_io.IOError_(
                            f"process failed with non-zero exit code: {proc.returncode}"
                        )
                    data = proc.stdout
                else:
                    with open(file_name, "rb") as f:
                        data = f.read()
            except OSError as e:
                raise core_io.IOError_(f"failed to open file: {file_name}") from e
            try:
                parsed = native.parse_fasta_bytes(data)
            except ValueError as e:
                raise core_io.IOError_(str(e)) from e
            if parsed is not None:
                codes, offsets = parsed
                return cls._from_codes(
                    k, codes, offsets, canonical, value_max, spss_ahead
                )
        lines = core_io.read_lines(file_name, decompressor)
        return cls.from_fasta_lines(k, lines, canonical, value_max, spss_ahead)

    @classmethod
    def _from_codes(
        cls, k: int, codes: np.ndarray, offsets: np.ndarray, canonical: bool,
        value_max: int = DEFAULT_VALUE_MAX, spss_ahead: bool = False,
    ) -> "KmerCounter":
        n_windows = max(0, codes.shape[0] - k + 1)
        if n_windows:
            from ..ops import backend

            # Multi-device mesh first (counts inputs one chip cannot hold,
            # parallel/driver.py); then the single-chip fused pipeline.
            from ..parallel import driver

            if driver.should_use_mesh(n_windows):
                result = driver.mesh_count(codes, offsets, k, canonical)
                if result is not None:
                    uniq, counts = result
                    return cls(k, uniq, np.minimum(counts, value_max), value_max)
            if backend.should_use_device_chunked(n_windows, k):
                # Out-of-core single chip: chunked device counting +
                # host merge of the sorted runs (ops/backend.py).
                result = backend.device_count_chunked(
                    codes, offsets, k, canonical
                )
                if result is not None:
                    uniq, counts = result
                    return cls(k, uniq, np.minimum(counts, value_max), value_max)
            if backend.should_use_device(
                n_windows, spss_ahead, k=k, canonical=canonical
            ):
                result = backend.device_count(
                    codes, offsets, k, canonical, resident=True,
                    value_max=value_max, spss_ahead=spss_ahead,
                    lazy_counts=spss_ahead,
                )
                if result is not None:
                    uniq, counts, handle = result
                    # A callable is the deferred counts transfer (already
                    # device-saturated at value_max); materialized arrays
                    # get the host-side clamp like every other path.
                    if not callable(counts):
                        counts = np.minimum(counts, value_max)
                    counter = cls(k, uniq, counts, value_max)
                    if callable(counts):
                        counter._recover = (codes, offsets)
                        counter._canonical = canonical
                    # Keep the sorted set on-device so the SPSS graph
                    # phase skips its re-upload (ops/resident.py).
                    counter._device = handle
                    return counter
        # Host int32 fast path for the 30-bit key widths (k <= 15): one
        # native rolling pass emits dense int32 canonical keys — half the
        # sort bytes and none of the int64 window/rc temporaries of the
        # generic path (the same representation choice as the device
        # pipeline, ops/count.py).
        if k <= 15:
            from . import native

            keys = native.canonical_windows32(
                codes.astype(np.uint8, copy=False), offsets, k, canonical
            )
            if keys is not None:
                if keys.shape[0] == 0:
                    return cls(k, None, None, value_max)
                keys.sort(kind="stable")
                boundary = np.empty(keys.shape[0], dtype=bool)
                boundary[0] = True
                np.not_equal(keys[1:], keys[:-1], out=boundary[1:])
                idx = np.flatnonzero(boundary)
                uniq = keys[idx].astype(np.int64)
                counts = np.diff(np.append(idx, keys.shape[0]))
                return cls(k, uniq, np.minimum(counts, value_max), value_max)
        kmers = extract_kmers(codes, offsets, k, canonical)
        uniq, counts = arrays.sorted_unique_counts(kmers)
        return cls(k, uniq, np.minimum(counts, value_max), value_max)

    @classmethod
    def from_fasta_lines(
        cls, k: int, lines: List[str], canonical: bool,
        value_max: int = DEFAULT_VALUE_MAX, spss_ahead: bool = False,
    ) -> "KmerCounter":
        reads = core_io.parse_fasta_lines(lines)
        return cls.from_reads(k, reads, canonical, value_max, spss_ahead)

    @classmethod
    def from_reads(
        cls, k: int, reads: List[str], canonical: bool,
        value_max: int = DEFAULT_VALUE_MAX, spss_ahead: bool = False,
    ) -> "KmerCounter":
        codes, offsets = core_io.reads_to_codes(reads)
        return cls._from_codes(k, codes, offsets, canonical, value_max, spss_ahead)

    # -- incremental adds (reference Add, lib/core/kmer_counter.h:257-264) --

    def add(self, kmer: int, v: int = 1) -> "KmerCounter":
        self._pending.append((int(kmer), int(v)))
        return self

    def _flush(self) -> None:
        if not self._pending:
            return
        # Incremental adds invalidate any device-resident mirror.
        self._device = None
        pend = np.array(self._pending, dtype=np.int64)
        self._pending.clear()
        all_k = np.concatenate([self.kmers, pend[:, 0]])
        all_v = np.concatenate([self.counts, pend[:, 1]])
        order = np.argsort(all_k, kind="stable")
        all_k, all_v = all_k[order], all_v[order]
        uniq, start = np.unique(all_k, return_index=True)
        sums = np.add.reduceat(all_v, start) if all_k.size else all_v
        self.kmers = uniq
        self.counts = np.minimum(sums, self.value_max)

    # -- queries -----------------------------------------------------------

    def size(self) -> int:
        self._flush()
        return int(self.kmers.shape[0])

    def get(self, kmer: int) -> int:
        self._flush()
        idx = np.searchsorted(self.kmers, kmer)
        if idx < self.kmers.shape[0] and self.kmers[idx] == kmer:
            return int(self.counts[idx])
        return 0

    def to_kmer_set(self, cutoff: int) -> Tuple[KmerSet, int]:
        """Filters out k-mers with count < cutoff; returns (set, n_cut)
        (reference: lib/core/kmer_counter.h:211-243).  A device-resident
        mirror is filtered on-device in parallel and carried into the
        KmerSet (count -> graph fusion, ops/resident.py)."""
        self._flush()
        if cutoff <= 1:
            # Nothing to filter: reuse the sorted array (skips a full
            # fancy-index copy — ~233 MB at 29M k-mers).
            ks = KmerSet(self.k, self.kmers, _sorted=True)
            if self._device is not None and self._device.valid_for(
                ks.kmers, self.k
            ):
                ks.device = self._device
            return ks, 0
        keep = self.counts >= cutoff
        n_cut = int(np.count_nonzero(~keep))
        ks = KmerSet(self.k, self.kmers[keep], _sorted=True)
        if self._device is not None and self._device.valid_for(
            self.kmers, self.k
        ):
            dh = self._device.filtered(cutoff, self.value_max)
            if dh is not None and dh.n == ks.size():
                # Verified stamp: the host array came from an independent
                # host-side filter, so the device endpoints are read back
                # and compared (a same-cardinality divergence must drop
                # the handle, not validate it).
                ks.device = dh.with_verified_endpoints(ks.kmers)
        return ks, n_cut
