"""Delta-compressed key downloads for slow host<->device links.

The count pipeline's dominant link cost is downloading the sorted unique
key array (4-8 B/k-mer).
Sorted keys are gap-encoded instead: consecutive deltas of a dense
canonical set are small (mean gap = keyspace / n), so nearly all fit one
byte (k <= 15) or two (larger k), and the overflows ride an exception
table whose capacity is sized from the canonical-density model
(plan_escape: {2^p, 3*2^(p-1)} classes, int32 rows when keys fit 31
bits).  The wire format is 1-2 B/k-mer plus the table — a 3-6x cut of
the big transfer.

Encoding (on device, one jit per size class):
  d[i] = uniq[i] - uniq[i-1]  (d[0] = uniq[0], so decode is a plain
  cumsum from 0 — the first key needs no separate channel)
  dsmall[i] = min(d[i], ESC) as uint8/uint16 (ESC = dtype max)
  exceptions: positions with d >= ESC, in ascending order, as
  (position, true delta) rows (int64, or int32 when keys fit 31
  bits); capacity from plan_escape, sentinel-padded.
  The last exception row carries (n_overflow, uniq[n-1]) — the
  overflow count decides raw fallback and the last key is an
  end-to-end integrity check on the decode.

Decoding (host): patch the true deltas over the escaped positions and
cumsum.  Any inconsistency (overflow beyond CAP, integrity mismatch)
returns None and the caller downloads the raw array instead — the
device copy is still resident, so the fallback costs only the bytes
this path tried to save.

This replaces link bytes, not reference behavior: the reference runs
host-only and never serializes this array (its counterpart is the
in-memory bucket map, lib/core/kmer_counter.h:40-133).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

CAP = 1 << 16  # exception slots per download (1 MB on the wire)
_IDX_SENTINEL = (1 << 31) - 1


def _build_encode():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)

    @partial(jax.jit, static_argnames=("esc", "cap", "narrow"))
    def encode(uniq, n, esc: int, cap: int, narrow: bool):
        """uniq: (P,) int64 sorted ascending on [0, n), arbitrary tail.
        Returns (dsmall (P,) uint8|uint16, exc (cap+1, 2) int64 — or
        int32 when `narrow`, for keys/deltas under 2^31 (k <= 15): half
        the exception wire)."""
        P = uniq.shape[0]
        prev = jnp.concatenate([jnp.zeros((1,), uniq.dtype), uniq[:-1]])
        d = uniq - prev  # d[0] = uniq[0]
        pos = jax.lax.broadcasted_iota(jnp.int32, (P,), 0)
        live = pos < n
        d = jnp.where(live, d, 0)
        over = d >= esc
        dt = jnp.uint8 if esc == 255 else jnp.uint16
        dsmall = jnp.minimum(d, esc).astype(dt)
        # Overflow positions to the front, ascending (they already are by
        # position; the sort just compacts them past the sentinels).
        key = jnp.where(over, pos, jnp.int32(_IDX_SENTINEL))
        (key,) = jax.lax.sort((key,), num_keys=1, is_stable=False)
        exc_idx = key[:cap]
        safe = jnp.clip(exc_idx, 0, P - 1)
        exc_val = jnp.where(exc_idx < P, d[safe], 0)
        n_over = jnp.sum(over, dtype=jnp.int64)
        last = uniq[jnp.maximum(n - 1, 0)]
        exc = jnp.concatenate(
            [
                jnp.stack([exc_idx.astype(jnp.int64), exc_val], axis=1),
                jnp.stack([n_over, last]).reshape(1, 2),
            ]
        )
        if narrow:
            exc = exc.astype(jnp.int32)
        return dsmall, exc

    return encode


_encode = None


def expected_escape(n: int, k: int, canonical: bool) -> Optional[int]:
    """ESC width whose expected exception count fits CAP with margin, or
    None when even uint16 deltas would overflow too often.

    Non-canonical keys are ~uniform over [0, 4^k): gaps are ~geometric
    with mean space/n, so expected overflows = n * exp(-esc * n / space).

    Canonical keys min(x, rc(x)) are NOT uniform: a key u is canonical
    iff u <= rc(u), so the density falls ~linearly across the keyspace,
    f(u) ~ (2/S)(1 - u/S) — the upper range is sparse and its gaps are
    huge.  Integrating the local geometric overflow probability over
    that density gives expected overflows = 2n(1 - e^-a(1+a)) / a^2
    with a = 2*esc*n/S.  The uniform model underestimates this ~80x
    (k=15, n=16.5M: 535k real overflows vs 6.5k predicted), which made
    every production build silently fall back to the raw download.

    The decoder's overflow check keeps correctness either way; an 8x
    margin absorbs model error."""
    plan = plan_escape(n, k, canonical)
    return plan[0] if plan is not None else None


CAP_MAX = 1 << 21  # adaptive exception slots are capped here


def plan_escape(n: int, k: int, canonical: bool):
    """(esc, cap, narrow) minimizing estimated wire bytes, or None.

    cap is the exception capacity: 1.4x the model's expected overflow
    count (the density model measured within 1% on the bench genome;
    the decoder's overflow check falls back to the raw download if a
    real set beats the margin), floored at CAP and rounded up to a
    {2^p, 3*2^(p-1)} size class so the encode jit compiles per class,
    not per build.  `narrow` marks int32 exception rows (valid when
    keys < 2^31, i.e. k <= 15 — half the row bytes).  The wire
    estimate per candidate width:
        bytes = n * width + cap * row_bytes
    uint8 with a large adaptive table beats uint16 for dense canonical
    k=15 sets (16.5M keys: 16.5 MB + ~6 MB of int32 rows vs 33 MB),
    while sparse sets still pick uint16 or reject the format."""
    if n <= 0:
        return None
    import math

    space = float(4**k)
    best = None
    for esc in (255, 65535):
        a = esc * n / space
        if canonical:
            a *= 2.0
            expected = 2.0 * n * (1.0 - math.exp(-a) * (1.0 + a)) / (a * a)
        else:
            expected = n * math.exp(-a)
        cap = _cap_class(max(CAP, int(1.4 * expected) + 1))
        if cap > CAP_MAX:
            continue  # expected overflows beyond any sensible table
        narrow = k <= 15
        row = 8 if narrow else 16
        width = 1 if esc == 255 else 2
        wire = n * width + cap * row
        if wire >= 8 * n:  # raw int64 download would be no worse
            continue
        if best is None or wire < best[0]:
            best = (wire, esc, cap, narrow)
    if best is None:
        return None
    return best[1], best[2], best[3]


def _cap_class(c: int) -> int:
    """Smallest {2^p, 3*2^(p-1)} class >= c (one jit compile per class)."""
    p = max(0, (c - 1).bit_length())
    three = 3 << max(0, p - 2)
    if three >= c and three < (1 << p):
        return three
    return 1 << p


def dispatch_delta(uniq, n: int, k: int, canonical: bool):
    """Dispatches the gap encode (async) and returns the on-device
    (deltas, exceptions) pair for fetch_delta, or None when the density
    heuristic rejects the format.  Splitting dispatch from fetch lets
    the caller queue more device work (the side-code prefetch) behind
    the encode so its compute overlaps the download DMA — dispatched
    the other way round, the fetch would wait out that compute first."""
    global _encode
    try:
        plan = plan_escape(n, k, canonical)
        if plan is None:
            return None
        esc, cap, narrow = plan
        if _encode is None:
            _encode = _build_encode()
        dsmall, exc = _encode(uniq, n, esc, cap, narrow)
        return dsmall[:n], exc
    except Exception as e:  # noqa: BLE001 - fall back to raw download
        from .backend import _note_fallback

        _note_fallback("delta_dispatch", e)
        return None


def fetch_delta(pending, n: int):
    """Collects a dispatch_delta result: downloads the two wire arrays
    and reconstructs the int64 keys, or returns None (raw fallback)."""
    try:
        dsmall, exc = pending
        d_h = np.asarray(dsmall)
        exc_h = np.asarray(exc)
        # The table has min(P, CAP) exception rows + 1 tail row (the
        # device slice key[:CAP] shrinks when the padded array is
        # shorter than CAP).
        cap_eff = exc_h.shape[0] - 1
        n_over, last = int(exc_h[-1, 0]), int(exc_h[-1, 1])
        if n_over > cap_eff:
            from .backend import _note_fallback

            _note_fallback(
                "delta_download",
                RuntimeError(
                    f"{n_over} gap overflows exceed the {cap_eff}-slot "
                    "exception table (raw download fallback)"
                ),
            )
            return None
        from ..core import native

        out = native.delta_decode(d_h, exc_h, n_over)
        if out is None:
            # NumPy fallback: widen, patch, cumsum (2 full int64 passes
            # vs the C routine's single streaming pass).  Same
            # monotonicity guard as the C decode: patched deltas past
            # position 0 must be positive or the keys are corrupt.
            d64 = d_h.astype(np.int64)
            idx = exc_h[:n_over, 0]
            d64[idx] = exc_h[:n_over, 1]
            if d64.shape[0] and (
                d64[0] < 0 or (d64.shape[0] > 1 and int(d64[1:].min()) <= 0)
            ):
                return None
            out = np.cumsum(d64)
        if n and int(out[-1]) != last:
            from .backend import _note_fallback

            _note_fallback(
                "delta_download",
                RuntimeError("delta decode integrity mismatch"),
            )
            return None
        return out
    except Exception as e:  # noqa: BLE001 - fall back to raw download
        from .backend import _note_fallback

        _note_fallback("delta_download", e)
        return None


def device_delta_download(uniq, n: int, k: int, canonical: bool):
    """One-call dispatch + fetch (see dispatch_delta/fetch_delta);
    returns the reconstructed int64 uniq[:n], or None.  Never raises."""
    pending = dispatch_delta(uniq, n, k, canonical)
    if pending is None:
        return None
    return fetch_delta(pending, n)
