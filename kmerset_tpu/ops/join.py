"""Sort-join primitives: batched membership lookup in sorted sets.

A replacement for per-query binary search: XLA lowers `searchsorted` to
log2(n) dependent gather passes.  A sort-join instead pays two unstable
sorts plus two cummax scans, and answers every query in one shot (which
of the two is faster on the GPU is not yet measured):

  1. concatenate [set, queries] with a tag key (0 = set row, 1 = query)
  2. sort by (key, tag) — every query lands directly after the equal set
     row, if one exists
  3. forward-cummax of set-row keys/indices propagates "the last set row
     at or before me"; a query is found iff that key equals its own
  4. a second sort by (tag, slot) restores query order

This is the device form of the reference's hash-membership hot loop
(reference: lib/core/spss.h:238-273 does 8 hash Contains() per k-mer;
lib/core/kmer_set.h:93-105 is the underlying bucket lookup).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)


@partial(jax.jit, static_argnames=("n_groups",))
def lookup_join(A: jnp.ndarray, Q: jnp.ndarray, n_groups: int = 1):
    """Membership of every query in sorted A.

    A: (n,) sorted int array (int32 or int64).  Padding rows ARE allowed
    — duplicated sentinel tails are how every production caller pads —
    as long as no padding value can equal a query (the membership answer
    for a padding value would be a true match).  Keys must also exceed
    iinfo(dtype).min: that value seeds the cummax scan, so a query equal
    to it would read as found even when absent.
    Q: (m,) queries, m a multiple of n_groups.
    Returns (found, idx): bool/int32 arrays shaped (n_groups, m // n_groups)
    where found[g, i] says Q[g * gsz + i] is in A and idx[g, i] is its
    position (0 where not found).
    """
    n, m = A.shape[0], Q.shape[0]
    key = jnp.concatenate([A, Q.astype(A.dtype)])
    tag = jnp.concatenate(
        [jnp.zeros(n, jnp.int32), jnp.ones(m, jnp.int32)]
    )
    slot = jnp.concatenate(
        [
            jax.lax.broadcasted_iota(jnp.int32, (n,), 0),
            jax.lax.broadcasted_iota(jnp.int32, (m,), 0),
        ]
    )
    key_s, tag_s, slot_s = jax.lax.sort(
        (key, tag, slot), num_keys=2, is_stable=False
    )
    is_set = tag_s == 0
    min_key = jnp.iinfo(A.dtype).min
    akey = jax.lax.cummax(jnp.where(is_set, key_s, min_key), axis=0)
    aidx = jax.lax.cummax(jnp.where(is_set, slot_s, -1), axis=0)
    found = ~is_set & (akey == key_s)
    idx = jnp.maximum(aidx, 0)
    # Restore query order: set rows (tag 0) sort to the front.
    _, _, found_q, idx_q = jax.lax.sort(
        (tag_s, slot_s, found, idx), num_keys=2, is_stable=False
    )
    gsz = m // n_groups
    return found_q[n:].reshape(n_groups, gsz), idx_q[n:].reshape(n_groups, gsz)


@partial(jax.jit, static_argnames=("n_groups",))
def lookup_join32(A: jnp.ndarray, Q: jnp.ndarray, n_groups: int = 1):
    """int32 fast path of `lookup_join` for keys < 2^31 - 1 after tag
    fusion (2k <= 30-bit k-mer keys: fused = key << 1 | tag fits int32).

    Halves the sort bytes and replaces emulated 64-bit compares with
    native int32 ones: sort 1 carries (fused_key, slot) instead of
    (key64, tag, slot); sort 2 carries (tag<<30|slot, idx|found<<30)
    instead of four lanes.  Requires max(n, m) < 2^30 (slot and idx
    pack independently — the check below enforces exactly this) and A
    sorted int32 (set padding rows must hold values no query can
    equal).
    """
    n, m = A.shape[0], Q.shape[0]
    # Slot/idx/found pack into bits [0,30) with the tag/found flag at
    # bit 30 — silently wrong beyond that, so fail the trace instead
    # (callers gate via backend.MAX_DEVICE_GRAPH_KMERS well below this).
    if max(n, m) >= (1 << 30):  # not assert: must survive python -O
        raise ValueError("lookup_join32: slot packing needs n, m < 2^30")
    one = jnp.int32(1)
    fused = jnp.concatenate([A << 1, (Q << 1) | one])
    slot = jnp.concatenate(
        [
            jax.lax.broadcasted_iota(jnp.int32, (n,), 0),
            jax.lax.broadcasted_iota(jnp.int32, (m,), 0),
        ]
    )
    fused_s, slot_s = jax.lax.sort((fused, slot), num_keys=1, is_stable=False)
    is_set = (fused_s & one) == 0
    key_s = jax.lax.shift_right_logical(fused_s, one)
    akey = jax.lax.cummax(jnp.where(is_set, key_s, jnp.int32(-1)), axis=0)
    aidx = jax.lax.cummax(jnp.where(is_set, slot_s, jnp.int32(-1)), axis=0)
    found = ~is_set & (akey == key_s)
    idx = jnp.maximum(aidx, 0)
    # Restore query order: tag in bit 30 puts set rows first (slot < 2^30).
    rkey = jnp.where(is_set, slot_s, slot_s | jnp.int32(1 << 30))
    payload = idx | jnp.where(found, jnp.int32(1 << 30), jnp.int32(0))
    _, payload_q = jax.lax.sort((rkey, payload), num_keys=1, is_stable=False)
    pq = payload_q[n:]
    gsz = m // n_groups
    found_q = (pq & jnp.int32(1 << 30)) != 0
    idx_q = pq & jnp.int32((1 << 30) - 1)
    return found_q.reshape(n_groups, gsz), idx_q.reshape(n_groups, gsz)


@partial(jax.jit, static_argnames=("n_groups",))
def lookup_join_pair(Ahi, Alo, Qhi, Qlo, n_groups: int = 1):
    """Pair-key (int32 hi/lo lanes) variant of `lookup_join32` for
    38/46-bit k-mer keys (k = 19/23): the tag fuses into the lo lane's
    bit 0 (2*klo <= 22 bits leaves headroom), so sort 1 carries three
    int32 lanes with num_keys=2 instead of (key64, tag, slot).  The
    found/idx scan packs (hi, lo) into int64 — scans are bandwidth-cheap;
    only the sorts matter.  Requires max(n, m) < 2^30 (slot and idx
    pack independently; the check below enforces exactly this) and A
    sorted with padding rows no query can equal (all-T keys are
    non-canonical).
    """
    n, m = Ahi.shape[0], Qhi.shape[0]
    if max(n, m) >= (1 << 30):  # not assert: must survive python -O
        raise ValueError("lookup_join_pair: slot packing needs n, m < 2^30")
    one = jnp.int32(1)
    hi = jnp.concatenate([Ahi, Qhi])
    lof = jnp.concatenate([Alo << 1, (Qlo << 1) | one])
    slot = jnp.concatenate(
        [
            jax.lax.broadcasted_iota(jnp.int32, (n,), 0),
            jax.lax.broadcasted_iota(jnp.int32, (m,), 0),
        ]
    )
    hi_s, lof_s, slot_s = jax.lax.sort(
        (hi, lof, slot), num_keys=2, is_stable=False
    )
    is_set = (lof_s & one) == 0
    key64 = (hi_s.astype(jnp.int64) << 32) | jax.lax.shift_right_logical(
        lof_s, one
    ).astype(jnp.int64)
    akey = jax.lax.cummax(jnp.where(is_set, key64, jnp.int64(-1)), axis=0)
    aidx = jax.lax.cummax(jnp.where(is_set, slot_s, jnp.int32(-1)), axis=0)
    found = ~is_set & (akey == key64)
    idx = jnp.maximum(aidx, 0)
    rkey = jnp.where(is_set, slot_s, slot_s | jnp.int32(1 << 30))
    payload = idx | jnp.where(found, jnp.int32(1 << 30), jnp.int32(0))
    _, payload_q = jax.lax.sort((rkey, payload), num_keys=1, is_stable=False)
    pq = payload_q[n:]
    gsz = m // n_groups
    found_q = (pq & jnp.int32(1 << 30)) != 0
    idx_q = pq & jnp.int32((1 << 30) - 1)
    return found_q.reshape(n_groups, gsz), idx_q.reshape(n_groups, gsz)


def intersection_count(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """|A ∩ B| for sorted-unique A, B via one sort + one shifted compare
    (the sketch-similarity kernel, reference: lib/core/kmer_set_set.h:158-184)."""
    key = jnp.concatenate([A, B])
    (s,) = jax.lax.sort((key,), num_keys=1, is_stable=False)
    return jnp.sum(s[1:] == s[:-1])

