"""Device unitig front-end: fused side tables -> terminals -> successor.

One jitted program computes, for a sorted canonical k-mer array, the
oriented successor array and chain-start classification of the bidirected
de Bruijn graph (reference semantics: lib/core/spss.h:238-313 neighbor
tables, 276-313 terminal tests, 394-423 orientation flips).  Returning
only `succ` (one int32 per oriented node) plus terminal masks moves
~9 bytes/k-mer off the device instead of the ~26 bytes/k-mer of the raw
side tables; the sequential chain walk + string emission stay on the host
(native/kmerio.c), which needs exactly these arrays.

Orientation convention matches core/spss.py: node u = (entity << 1) | o,
o=0 exits the right side, o=1 exits the left; mirror(u) = u ^ 1.
The side-table construction is shared with ops/neighbors.py.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np

from .neighbors import SENTINEL, pad_pow2, tables_traced


def _build():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)

    @partial(jax.jit, static_argnames=("k",))
    def unitig_succ(A, k: int):
        """A: (n,) int64 sorted canonical (sentinel-padded).

        Returns (succ (2n,) int32 with -1 at terminal exits,
                 term_l, term_r, both) each (n,) bool."""
        (rdeg, rnbr, rsame), (ldeg, lnbr, lsame) = tables_traced(A, k, True)

        # Terminal tests (reference: lib/core/spss.h:276-313): a side is
        # terminal unless its unique mate's corresponding side also has a
        # unique back-edge.
        mate_r = jnp.where(rsame, rdeg[rnbr], ldeg[rnbr])
        term_r = (rdeg != 1) | (mate_r != 1)
        mate_l = jnp.where(lsame, ldeg[lnbr], rdeg[lnbr])
        term_l = (ldeg != 1) | (mate_l != 1)

        succ_r = jnp.where(term_r, -1, 2 * rnbr + rsame)
        succ_l = jnp.where(term_l, -1, 2 * lnbr + (~lsame).astype(jnp.int32))
        # Orientation-major (2, n), interleaved on the host.
        succ2 = jnp.stack([succ_r, succ_l], axis=0)
        both = term_l & term_r
        return succ2.astype(jnp.int32), term_l, term_r, both

    return unitig_succ


def _build_sides():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)

    @partial(jax.jit, static_argnames=("k",))
    def unitig_sides(A, k: int):
        """Per-entity 1-byte side codes — the slow-link wire format of
        the graph front-end (16x smaller than succ + masks).  Byte:
        bit0 term_r, bits1-2 base_r, bit3 same_r, bit4 term_l,
        bits5-6 base_l, bit7 same_l; base/same bits are zeroed on
        terminal sides so the stream is deterministic.  The host
        rebuilds the identical succ array with one fp probe per
        non-terminal side (native kmerio_succ_from_sides)."""
        (
            (rdeg, rnbr, rsame, rbase),
            (ldeg, lnbr, lsame, lbase),
        ) = tables_traced(A, k, True, with_base=True)
        mate_r = jnp.where(rsame, rdeg[rnbr], ldeg[rnbr])
        term_r = (rdeg != 1) | (mate_r != 1)
        mate_l = jnp.where(lsame, ldeg[lnbr], rdeg[lnbr])
        term_l = (ldeg != 1) | (mate_l != 1)
        r_part = jnp.where(
            term_r,
            jnp.int32(1),
            (rbase << 1) | (rsame.astype(jnp.int32) << 3),
        )
        l_part = jnp.where(
            term_l,
            jnp.int32(16),
            (lbase << 5) | (lsame.astype(jnp.int32) << 7),
        )
        return (r_part | l_part).astype(jnp.uint8)

    return unitig_sides


_unitig_sides = None


def dispatch_sides(arr, k: int):
    """Launches the side-code jit on an already-on-device array and
    returns the (unfetched) device result — the prefetch hook the
    counting phase uses to overlap this compute with its own downloads
    (ops/resident.DeviceKmers.prefetch_sides)."""
    global _unitig_sides
    if _unitig_sides is None:
        _unitig_sides = _build_sides()
    return _unitig_sides(arr, k)


def device_unitig_sides(A: np.ndarray, k: int, resident=None):
    """Side-code bytes (n,) uint8 for the host succ reconstruction, or
    None when the device path is unavailable.  `resident` = validated
    DeviceKmers handle (no upload; a prefetched side-code array from the
    count phase is collected directly).  Otherwise A is staged like
    device_unitig_succ."""
    global _unitig_sides
    try:
        if _unitig_sides is None:
            _unitig_sides = _build_sides()
        n = A.shape[0]
        if resident is not None and resident.sides is not None:
            s = resident.sides
            # Prefetched arrays are pre-sliced to n (and possibly already
            # copied host-side, resident.start_sides_download); slicing
            # again would spawn a fresh device buffer and a fresh copy.
            return np.asarray(s if s.shape[0] == n else s[:n])
        if resident is not None:
            Ap = resident.graph_input()
        elif k <= 15:
            from .neighbors import PAD32

            Ap = pad_pow2(A.astype(np.int32), PAD32)
        else:
            Ap = pad_pow2(A, SENTINEL)
        sides = _unitig_sides(Ap, k)
        return np.asarray(sides[:n])
    except Exception as e:  # noqa: BLE001 - fall back
        from .backend import _note_fallback

        _note_fallback("device_unitig_sides", e)
        return None


_unitig_succ = None


def device_unitig_succ(A: np.ndarray, k: int, resident=None) -> Optional[Tuple]:
    """(succ, term_l, term_r, both) as host arrays trimmed to len(A), or
    None when the device path is unavailable.  `resident` (a validated
    ops/resident.DeviceKmers) supplies the set already on-device in the
    exact padded layout, skipping the upload entirely — the count->graph
    fusion of the build pipeline."""
    global _unitig_succ
    try:
        if _unitig_succ is None:
            _unitig_succ = _build()
        n = A.shape[0]
        if resident is not None:
            Ap = resident.graph_input()
        elif k <= 15:
            # Canonical int32 fast path (ops/neighbors.py tables_traced):
            # half the join sort bytes, native int32 compares.
            from .neighbors import PAD32

            Ap = pad_pow2(A.astype(np.int32), PAD32)
        else:
            Ap = pad_pow2(A, SENTINEL)
        succ2, term_l, term_r, both = _unitig_succ(Ap, k)
        s2 = np.asarray(succ2)
        succ = np.empty(2 * n, dtype=np.int64)
        succ[0::2] = s2[0, :n]
        succ[1::2] = s2[1, :n]
        return (
            succ,
            np.asarray(term_l[:n]),
            np.asarray(term_r[:n]),
            np.asarray(both[:n]),
        )
    except Exception as e:  # noqa: BLE001 - fall back to host
        from .backend import _note_fallback

        _note_fallback("device_unitig_succ", e)
        return None
