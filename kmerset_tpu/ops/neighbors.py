"""Device neighbor/degree tables for de Bruijn graph construction.

Hot loop #2 of the reference (8 hash Contains() per k-mer,
reference: lib/core/spss.h:238-273) as one batched sort-join: the 8
extension candidates of every k-mer (4 next + 4 prev) are resolved in a
single `lookup_join` over the sorted set — two bandwidth-bound sorts
instead of 8 binary-search passes (see ops/join.py).

Arrays are padded to power-of-two size classes so jit caches stay small.
`tables_traced` is the shared traced construction, also used by the
fused unitig front-end (ops/unitigs.py).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np

from .count import SENTINEL  # canonical definition (one source of truth)


def pad_pow2(a: np.ndarray, fill) -> np.ndarray:
    n = a.shape[0]
    size = 1 << max(0, (n - 1).bit_length())
    if size == n:
        return a
    return np.concatenate([a, np.full(size - n, fill, dtype=a.dtype)])


PAD32 = np.int32((1 << 30) - 1)  # all-T: never a canonical value (odd k)


def _rc32(x, k: int):
    """Reverse complement of 2k <= 30-bit packed k-mers in int32 lanes
    (the int64 5-round shuffle of core/kmer.py reverse_complement, one
    round shorter).  x must be non-negative."""
    import jax
    import jax.numpy as jnp

    M2 = jnp.int32(0x33333333)
    M4 = jnp.int32(0x0F0F0F0F)
    M8 = jnp.int32(0x00FF00FF)
    x = ~x
    x = ((x >> 2) & M2) | ((x & M2) << 2)
    x = ((x >> 4) & M4) | ((x & M4) << 4)
    x = ((x >> 8) & M8) | ((x & M8) << 8)
    x = ((x >> 16) & jnp.int32(0xFFFF)) | (x << 16)
    return jax.lax.shift_right_logical(x, jnp.int32(32 - 2 * k)) & jnp.int32(
        (1 << (2 * k)) - 1
    )


def tables_traced(A, k: int, canonical: bool, with_base: bool = False):
    """Traced side-table construction (call under jit with jnp arrays).

    A: (n,) int64 sorted (sentinel-padded) — or int32 with PAD32 padding
    for the canonical k <= 15 fast path (half the sort bytes, native
    int32 compares).  Returns ((rdeg, rnbr, rsame), (ldeg, lnbr, lsame))
    of int32/int32/bool shape (n,) arrays; padding rows carry junk the
    caller trims.  with_base appends the winning extension base c (int32,
    valid where deg == 1) to each side tuple — the 1-byte side-code wire
    format needs it (ops/unitigs.device_unitig_sides).
    """
    import jax
    import jax.numpy as jnp

    from ..core import kmer as kmer_ops
    from .join import lookup_join, lookup_join32

    n = A.shape[0]
    use32 = A.dtype == jnp.int32
    use_pair = (not use32) and canonical and 15 < k <= 23
    cands = []
    ncans = []
    if use_pair:
        # Pair-lane fast path for 38/46-bit keys: int32 (hi, lo) lanes
        # with khi = ceil(k/2) bases in hi (count.py _khi convention).
        # Sentinel padding clamps to the all-T key, which is never
        # canonical, so set padding cannot false-match.
        khi = (k + 1) // 2
        klo = k - khi
        mlo = jnp.int32((1 << (2 * klo)) - 1)
        mhi = jnp.int32((1 << (2 * khi)) - 1)
        Ac = jnp.minimum(A, jnp.int64((1 << (2 * k)) - 1))
        Ahi = jax.lax.shift_right_logical(Ac, jnp.int64(2 * klo)).astype(
            jnp.int32
        )
        Alo = (Ac & jnp.int64(mlo)).astype(jnp.int32)

        def rc_pair(h, l):
            rcl = _rc32(l, klo)
            rch = _rc32(h, khi)
            rh = ((rcl << (2 * (khi - klo))) | jax.lax.shift_right_logical(
                rch, jnp.int32(2 * klo)
            )) & mhi
            rl = rch & mlo
            return rh, rl

        pair_cands = []
        for right in (True, False):
            for c in range(4):
                cc = jnp.int32(c)
                if right:
                    # ((key << 2) | c) & mask(2k)
                    ch = ((Ahi << 2) | jax.lax.shift_right_logical(
                        Alo, jnp.int32(2 * klo - 2)
                    )) & mhi
                    cl = ((Alo << 2) | cc) & mlo
                else:
                    # (key >> 2) | (c << (2k - 2))
                    cl = jax.lax.shift_right_logical(Alo, jnp.int32(2)) | (
                        (Ahi & jnp.int32(3)) << (2 * klo - 2)
                    )
                    ch = jax.lax.shift_right_logical(Ahi, jnp.int32(2)) | (
                        cc << (2 * khi - 2)
                    )
                rh, rl = rc_pair(ch, cl)
                less = (ch < rh) | ((ch == rh) & (cl <= rl))
                nh = jnp.where(less, ch, rh)
                nl = jnp.where(less, cl, rl)
                pair_cands.append((ch, cl))
                ncans.append((nh, nl))
        from .join import lookup_join_pair

        found, idx = lookup_join_pair(
            Ahi,
            Alo,
            jnp.concatenate([h for h, _ in ncans]),
            jnp.concatenate([l for _, l in ncans]),
            n_groups=8,
        )

        out = []
        for side in range(2):
            deg = jnp.zeros(n, dtype=jnp.int32)
            nbr = jnp.zeros(n, dtype=jnp.int32)
            same = jnp.zeros(n, dtype=bool)
            base = jnp.zeros(n, dtype=jnp.int32)
            for c in range(4):
                g = side * 4 + c
                nh, nl = ncans[g]
                ok = found[g] & ((nh != Ahi) | (nl != Alo))
                first = ok & (deg == 0)
                nbr = jnp.where(first, idx[g], nbr)
                ch, cl = pair_cands[g]
                same = jnp.where(first, (ch != nh) | (cl != nl), same)
                if with_base:
                    base = jnp.where(first, jnp.int32(c), base)
                deg += ok
            out.append((deg, nbr, same, base) if with_base else (deg, nbr, same))
        return out[0], out[1]
    if use32:
        # canonical-only int32 path: PAD32 (all-T) can never equal a
        # canonical query, so set-padding rows cannot false-match.
        if not (canonical and k <= 15):
            # Not assert: must survive python -O — a directed caller on
            # this path would silently get canonical-min candidates.
            raise ValueError("int32 side tables are canonical-only, k <= 15")
        m30 = jnp.int32((1 << (2 * k)) - 1)
        for right in (True, False):
            for c in range(4):
                cc = jnp.int32(c)
                if right:
                    cand = ((A << 2) & m30) | cc
                else:
                    cand = jax.lax.shift_right_logical(A, jnp.int32(2)) | (
                        cc << (2 * (k - 1))
                    )
                ncans.append(jnp.minimum(cand, _rc32(cand, k)))
                cands.append(cand)
        found, idx = lookup_join32(A, jnp.concatenate(ncans), n_groups=8)
    else:
        for right in (True, False):
            for c in range(4):
                cand = (
                    kmer_ops.next_kmer(A, k, c) if right else kmer_ops.prev_kmer(A, k, c)
                )
                ncans.append(kmer_ops.canonical(cand, k) if canonical else cand)
                cands.append(cand)
        found, idx = lookup_join(A, jnp.concatenate(ncans), n_groups=8)

    out = []
    for side in range(2):
        deg = jnp.zeros(n, dtype=jnp.int32)
        nbr = jnp.zeros(n, dtype=jnp.int32)
        same = jnp.zeros(n, dtype=bool)
        base = jnp.zeros(n, dtype=jnp.int32)
        for c in range(4):
            g = side * 4 + c
            ok = found[g] & (ncans[g] != A)
            first = ok & (deg == 0)
            nbr = jnp.where(first, idx[g], nbr)
            if canonical:
                same = jnp.where(first, cands[g] != ncans[g], same)
            if with_base:
                base = jnp.where(first, jnp.int32(c), base)
            deg += ok
        out.append((deg, nbr, same, base) if with_base else (deg, nbr, same))
    return out[0], out[1]


def _build():
    import jax

    jax.config.update("jax_enable_x64", True)

    return partial(jax.jit, static_argnames=("k", "canonical"))(tables_traced)


_side_tables = None


def device_side_tables(
    A: np.ndarray, k: int, canonical: bool, resident=None
) -> Optional[Tuple]:
    """Computes both side tables on the accelerator; returns
    ((rdeg, rnbr, rsame), (ldeg, lnbr, lsame)) as numpy arrays trimmed to
    len(A), or None if the device path is unavailable.  `resident` (a
    validated ops/resident.DeviceKmers) supplies the set already
    on-device, skipping the upload — only usable when its lane layout
    matches this call's (int32 handles are canonical-only)."""
    global _side_tables
    try:
        if _side_tables is None:
            _side_tables = _build()
        use32 = canonical and k <= 15
        if resident is not None and (
            resident.graph_input().dtype == (np.int32 if use32 else np.int64)
        ):
            Ap = resident.graph_input()
        elif use32:
            Ap = pad_pow2(A.astype(np.int32), PAD32)
        else:
            Ap = pad_pow2(A, SENTINEL)
        n = A.shape[0]
        (r, l) = _side_tables(Ap, k, canonical)
        out = []
        for deg, nbr, same in (r, l):
            out.append(
                (
                    np.asarray(deg[:n]).astype(np.int64),
                    np.asarray(nbr[:n]).astype(np.int64),
                    np.asarray(same[:n]),
                )
            )
        return out[0], out[1]
    except Exception as e:  # noqa: BLE001 - fall back to host
        from .backend import _note_fallback

        _note_fallback("device_side_tables", e)
        return None
