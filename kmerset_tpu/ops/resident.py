"""Device-resident k-mer set handle: count -> graph fusion.

The counting pipeline (ops/count.py) materializes the sorted unique
(canonical) k-mer array ON the accelerator, and until round 4 threw the
device copy away: `backend.device_count` downloaded it, and the graph
phase (`ops/unitigs.device_unitig_succ`) re-uploaded the same bytes
minutes later.  On a slow link the re-upload alone (4-8 B/k-mer)
was the reason the graph offload gate stayed closed
(reference hot loop replaced by that phase: lib/core/spss.h:238-273).

`DeviceKmers` keeps the set resident between the phases: created from
the count outputs while they are still device arrays, shrunk on-device
to the exact pow2-padded layout the graph front-end consumes
(ops/neighbors.pad_pow2 semantics: int32 + PAD32 tail for k <= 15,
int64 + SENTINEL tail otherwise), optionally cutoff-filtered on-device
(mirroring the host `KmerCounter.to_kmer_set`, reference:
lib/core/kmer_counter.h:211-243, including the saturating value_max).

The handle is an *optimization hint*, never a source of truth: the host
array remains authoritative, and consumers must call `valid_for(A, k)`
— which checks length, k, and both endpoint values against the host
array — before trusting it.  Any mismatch silently drops back to the
upload path.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

from .count import SENTINEL
from .neighbors import PAD32


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _build_shrink():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)

    @partial(jax.jit, static_argnames=("P", "to32"))
    def shrink(uniq, counts, n, P: int, to32: bool):
        """Slices the count outputs (sentinel-padded to the window-count
        size class) down to the pow2(n_unique) graph layout, converting
        to the int32 lane for k <= 15.  n is traced (no recompile per
        unique count within a size class)."""
        if uniq.shape[0] >= P:
            a = uniq[:P]
            c = counts[:P]
        else:  # 3*2^p count layout can sit below pow2(n)
            pad = P - uniq.shape[0]
            a = jnp.concatenate([uniq, jnp.full(pad, SENTINEL, uniq.dtype)])
            c = jnp.concatenate([counts, jnp.zeros(pad, counts.dtype)])
        pos = jax.lax.broadcasted_iota(jnp.int32, (P,), 0)
        live = pos < n
        if to32:
            a = jnp.where(live, a, 0).astype(jnp.int32)
            a = jnp.where(live, a, PAD32)
        else:
            a = jnp.where(live, a, SENTINEL)
        return a, jnp.where(live, c, 0).astype(jnp.int32)

    return shrink


def _build_filter():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)

    @partial(jax.jit, static_argnames=("cutoff", "value_max"))
    def filter_cutoff(arr, counts, cutoff: int, value_max: int):
        """On-device cutoff filter: drops keys whose saturated count is
        below the cutoff and re-partitions survivors to a sorted prefix
        (padding tail keeps the layout's fill value).  Tail counts are 0,
        so padding is dropped by the same test (cutoff >= 2 here)."""
        keep = jnp.minimum(counts, value_max) >= cutoff
        fill = PAD32 if arr.dtype == jnp.int32 else SENTINEL
        fused = jnp.where(keep, arr, fill)
        (s,) = jax.lax.sort((fused,), num_keys=1, is_stable=False)
        return s, jnp.sum(keep, dtype=jnp.int32)

    return filter_cutoff


_shrink = None
_filter = None


class DeviceKmers:
    """Sorted unique k-mers resident on the accelerator, in the exact
    layout `ops/unitigs.device_unitig_succ` consumes.

    arr: jax array of size pow2(n) — int32 with PAD32 tail (k <= 15) or
    int64 with SENTINEL tail; counts: aligned int32 (None once filtered);
    first/last: host endpoint values for `valid_for` integrity checks.
    """

    __slots__ = (
        "arr", "counts", "n", "k", "canonical", "first", "last", "sides"
    )

    def __init__(self, arr, counts, n, k, canonical, first, last):
        self.arr = arr
        self.counts = counts
        self.n = int(n)
        self.k = k
        self.canonical = canonical
        self.first = first
        self.last = last
        # Pre-dispatched side-code array (ops/unitigs.unitig_sides jit
        # output, still on device) — see prefetch_sides.
        self.sides = None

    def prefetch_sides(self) -> None:
        """Dispatches the graph front-end's side-code jit on the resident
        array NOW (async), so its device compute overlaps the count
        phase's key/count downloads; the SPSS phase collects the finished
        array via device_unitig_sides.  Canonical-only (the side-code
        format is); failures are silent (the graph phase just
        recomputes)."""
        if not self.canonical:
            return
        try:
            from . import unitigs

            # Sliced to the live prefix NOW (n is known) so the whole
            # array can later be copied host-side as-is — an async copy
            # of the padded array would transfer up to 2x the bytes.
            self.sides = unitigs.dispatch_sides(self.arr, self.k)[: self.n]
        except Exception:  # noqa: BLE001 - prefetch is best-effort
            self.sides = None

    def start_sides_download(self) -> None:
        """Begins the device->host copy of the prefetched side codes
        (async; jax starts it once the dispatch completes).  Called when
        the count phase's own downloads are done, so the transfer rides
        the otherwise-idle link while the host runs the delta decode and
        the SPSS phase prologue."""
        if self.sides is not None:
            try:
                self.sides.copy_to_host_async()
            except Exception:  # noqa: BLE001 - best-effort
                pass

    @classmethod
    def from_count_outputs(
        cls, uniq, counts, n: int, k: int, canonical: bool,
        uniq_host: np.ndarray | None = None,
    ) -> Optional["DeviceKmers"]:
        """uniq/counts: the still-on-device count pipeline outputs
        (sentinel-padded).  Endpoint checksums come from `uniq_host` (the
        trimmed host copy) when given, or later via `with_endpoints` —
        until stamped, valid_for refuses the handle.  Returns None when
        the handle cannot be built (never raises into the count path)."""
        global _shrink
        if n <= 0:
            return None
        try:
            if _shrink is None:
                _shrink = _build_shrink()
            to32 = k <= 15
            arr, cnts = _shrink(uniq, counts, n, _pow2(n), to32)
            first = int(uniq_host[0]) if uniq_host is not None else None
            last = int(uniq_host[-1]) if uniq_host is not None else None
            return cls(arr, cnts, n, k, canonical, first, last)
        except Exception as e:  # noqa: BLE001 - hint only
            from .backend import _note_fallback

            _note_fallback("device_resident", e)
            return None

    def valid_for(self, kmers: np.ndarray, k: int) -> bool:
        """True iff this handle provably mirrors the host array: same k,
        same length, same endpoint values."""
        n = kmers.shape[0]
        return (
            self.k == k
            and self.n == n
            and n > 0
            and self.first is not None
            and self.first == int(kmers[0])
            and self.last == int(kmers[-1])
        )

    def filtered(
        self, cutoff: int, value_max: int
    ) -> Optional["DeviceKmers"]:
        """New handle with count < cutoff keys dropped, on-device
        (the device half of KmerCounter.to_kmer_set; endpoints are
        refreshed by the caller via `with_endpoints`)."""
        global _filter
        if self.counts is None:
            return None
        try:
            if _filter is None:
                _filter = _build_filter()
            arr, n_kept = _filter(self.arr, self.counts, cutoff, value_max)
            return DeviceKmers(
                arr, None, int(n_kept), self.k, self.canonical, None, None
            )
        except Exception as e:  # noqa: BLE001
            from .backend import _note_fallback

            _note_fallback("device_resident_filter", e)
            return None

    def with_endpoints(self, kmers: np.ndarray) -> Optional["DeviceKmers"]:
        """Stamps host endpoint checksums from the authoritative host
        array (lengths must already agree).  Only valid when the host
        array was itself materialized FROM this device array (the count
        download path) — for independently derived arrays (the host-side
        cutoff filter) use with_verified_endpoints instead, which
        actually reads the device endpoints back."""
        if self.n != kmers.shape[0] or self.n == 0:
            return None
        self.first = int(kmers[0])
        self.last = int(kmers[-1])
        return self

    def with_verified_endpoints(
        self, kmers: np.ndarray
    ) -> Optional["DeviceKmers"]:
        """Fetches a spaced sample of this handle's actual device values
        (both endpoints + 14 evenly spaced interior positions) and
        compares them against the independently computed host array: a
        filtered device copy that diverged from the host filter — even
        one keeping the same cardinality AND endpoints — must NOT be
        stamped as valid (the SPSS phase would silently consume wrong
        device keys).  One tiny gather; returns None on any mismatch."""
        if self.n != kmers.shape[0] or self.n == 0:
            return None
        idx = np.unique(
            np.linspace(0, self.n - 1, num=min(self.n, 16), dtype=np.int64)
        )
        try:
            sample = np.asarray(self.arr[idx]).astype(np.int64)
        except Exception as e:  # noqa: BLE001 - device died: drop the hint
            from .backend import _note_fallback

            _note_fallback("device_resident_endpoints", e)
            return None
        if not np.array_equal(sample, kmers[idx]):
            from .backend import _note_fallback

            _note_fallback(
                "device_resident_endpoints",
                RuntimeError("device/host sample mismatch after filter"),
            )
            return None
        self.first = int(kmers[0])
        self.last = int(kmers[-1])
        return self

    def graph_input(self):
        """The device array in device_unitig_succ's input layout."""
        return self.arr
