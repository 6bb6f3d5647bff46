"""Multi-device sharding: the distributed backend the reference never had.

The reference is single-node shared-memory only (SURVEY.md §5.8); all of
its parallelism is thread pools + mutexes.  The scale-out implemented
here:

- 1-D device mesh over axis "kv" (k-mer space).  The k-mer key range is
  the shard axis — the same top-bits decomposition the reference uses for
  its lock-free buckets (reference: lib/core/kmer_set.h:20-31), so every
  device owns a contiguous range of the sorted k-mer space.
- counting: each device window-packs + canonicalizes its shard of the
  input (data parallel), then a radix exchange between devices
  (`lax.all_to_all`, NVLink on a multi-GPU host) re-shards candidates by key range so each device
  sort/unique-counts only its owned range.
- reductions: sizes via psum, the order-independent XOR set hash via
  all_gather + local XOR (XOR is commutative; psum would not preserve it).

This replaces the reference's thread-local-buffer + try_lock merge
(reference: lib/core/kmer_counter.h:105-126) with collective re-sharding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.count import (
    SENTINEL,
    SINGLE_MAX_K,
    _S_SENT,
    _compact,
    _run_lengths,
    _single_windows,
    canonical_windows,
)

AXIS = "kv"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the first n devices.  KMERSET_TPU_MESH_DEVICES caps
    the default (testing odd mesh sizes; pinning a CLI to a device
    subset).  Nothing in the shard layout assumes a power of two — the
    key range splits by _owner_edges and exchange capacities are
    per-pair — and the non-pow2 case is pinned by parity tests."""
    import os

    devices = jax.devices()
    if n_devices is None:
        env = os.environ.get("KMERSET_TPU_MESH_DEVICES", "")
        if env.isdigit() and int(env) > 0:
            n_devices = int(env)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (AXIS,))


def _owner_edges(k: int, n_dev: int) -> np.ndarray:
    """Key-range boundaries: device d owns [edges[d], edges[d+1])."""
    space = 1 << (2 * k)
    return np.arange(n_dev + 1, dtype=np.int64) * (space // n_dev) + np.minimum(
        np.arange(n_dev + 1, dtype=np.int64), space % n_dev
    )


@functools.lru_cache(maxsize=256)
def sharded_count_fn(mesh: Mesh, k: int, canonical: bool, capacity: int):
    """Builds the jitted multi-device counting step.

    Input (per device): codes_local (L,) int32, valid_local (L,) bool.
    Output (per device): owned sorted unique kmers (capacity,), counts,
    n_unique, and the global (replicated) total size.

    capacity: max k-mers any (src, dst) pair may exchange; overflow drops
    are counted and returned so callers can retry with a larger capacity.
    """
    n_dev = mesh.devices.size
    edges = _owner_edges(k, n_dev)
    # For k <= 15 the whole pipeline — window keys, the local sorts, and
    # the all_to_all exchange — runs on int32 (2k <= 30 bits), halving
    # the bytes exchanged between devices.
    narrow = k <= SINGLE_MAX_K
    sent = _S_SENT if narrow else SENTINEL

    def step(codes_local, valid_local):
        if narrow:
            can = _single_windows(codes_local.astype(jnp.int32), k, canonical)
        else:
            can = canonical_windows(codes_local, k, canonical)
        key = jnp.where(valid_local, can, sent)
        (s,) = jax.lax.sort((key,), num_keys=1, is_stable=False)
        # Destination ranges: sorted keys are already grouped by owner.
        bounds = jnp.searchsorted(s, jnp.asarray(edges[1:-1], dtype=s.dtype))
        lo = jnp.concatenate([jnp.zeros(1, bounds.dtype), bounds])
        n_valid = jnp.sum(key != sent).astype(bounds.dtype)
        hi = jnp.concatenate([bounds, n_valid[None]])
        # Build fixed-capacity send buffer (n_dev, capacity).
        slot = jnp.arange(capacity, dtype=bounds.dtype)[None, :]
        src_idx = lo[:, None] + slot
        in_range = src_idx < hi[:, None]
        gathered = s[jnp.clip(src_idx, 0, s.shape[0] - 1)]
        send = jnp.where(in_range, gathered, sent)
        dropped = jnp.sum(jnp.maximum(hi - lo - capacity, 0))

        recv = jax.lax.all_to_all(send, AXIS, split_axis=0, concat_axis=0, tiled=False)
        (mine,) = jax.lax.sort((recv.reshape(-1),), num_keys=1, is_stable=False)
        prev = jnp.concatenate([jnp.full((1,), -1, dtype=mine.dtype), mine[:-1]])
        live = mine != sent
        boundary = live & (mine != prev)
        counts = _run_lengths(boundary, live)
        cs, cc = _compact(
            jnp.where(boundary, 0, 1).astype(jnp.int32), (mine,), (counts,)
        )
        n_unique = jnp.sum(boundary)
        m = mine.shape[0]
        pos = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)
        in_range = pos < n_unique
        uniq = jnp.where(in_range, cs.astype(jnp.int64), SENTINEL)
        counts = jnp.where(in_range, cc, 0)
        total = jax.lax.psum(n_unique, AXIS)
        dropped_total = jax.lax.psum(dropped, AXIS)
        return uniq, counts, n_unique[None], total[None], dropped_total[None]

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P(AXIS), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def _rc_bits(x, k: int, nbits: int):
    """Reverse complement of packed k-mers as a bit swizzle: complement
    every base, reverse 2-bit lanes, shift down to 2k bits.  The int32
    half is ops/neighbors._rc32 (one shared implementation); the int64
    half is the 5-round shuffle of core/kmer.py reverse_complement."""
    if nbits == 32:
        from ..ops.neighbors import _rc32

        return _rc32(x, k)
    m2 = jnp.int64(0x3333333333333333)
    m4 = jnp.int64(0x0F0F0F0F0F0F0F0F)
    m8 = jnp.int64(0x00FF00FF00FF00FF)
    m16 = jnp.int64(0x0000FFFF0000FFFF)
    x = ~x
    x = ((x >> 2) & m2) | ((x & m2) << 2)
    x = ((x >> 4) & m4) | ((x & m4) << 4)
    x = (jax.lax.shift_right_logical(x, jnp.int64(8)) & m8) | ((x & m8) << 8)
    x = (jax.lax.shift_right_logical(x, jnp.int64(16)) & m16) | ((x & m16) << 16)
    x = jax.lax.shift_right_logical(x, jnp.int64(32)) | (x << 32)
    return jax.lax.shift_right_logical(x, jnp.int64(64 - 2 * k))


def _route_queries(
    Q, edges_inner, qcap: int, n_dev: int, sent, answer_fn, values=None
):
    """Generic owner-routed lookup inside a shard_map step.

    Q: (m,) per-device query keys, ascending-owner partitionable by
    `edges_inner` ((n_dev-1,) split points, same dtype).  Sentinel
    queries are allowed but NEVER cross the wire: they sort to the tail,
    are excluded from every lane, and their answer slots are filled
    LOCALLY with hard 0 of the lane dtype — answer_fn is never consulted
    for them.  Callers whose miss encoding is nonzero (e.g. a 1<<40
    marker) MUST therefore gate sentinel slots on their own aliveness
    mask rather than relying on the answer value (sharded_matching_fn's
    'alive' gate is the pattern).  Every slot appears exactly once in
    the final slot-keyed realign sort — routed real slots from the back
    lanes, sentinel slots from the local fill — so no scatter is needed.
    answer_fn(recv_flat) -> answers aligned with its input; any integer
    dtype — pointer doubling and matching return packed int64 answers
    and unpack the halves (do NOT narrow the answer lane to int32).
    With `values` (an (m,) int32 payload lane riding alongside Q),
    answer_fn is called as answer_fn(recv_q, recv_v) — the owner sees
    every (key, value) record sent to it, enabling owner-side
    aggregation (e.g. per-key minima) in the same round trip.
    Returns (answers (m,) in Q order, answer_fn's dtype; dropped count
    psum'd).
    """
    m = Q.shape[0]
    slot = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)
    if values is None:
        Qs, slot_s = jax.lax.sort((Q, slot), num_keys=1, is_stable=False)
    else:
        Qs, slot_s, vals_s = jax.lax.sort(
            (Q, slot, values), num_keys=1, is_stable=False
        )
    bounds = jnp.searchsorted(Qs, edges_inner.astype(Qs.dtype))
    lo = jnp.concatenate([jnp.zeros(1, bounds.dtype), bounds])
    # Sentinel (padding) queries sort to the tail and never cross the
    # wire: the last owner's lane carries only the real queries, so qcap
    # sizes against data rather than padding (callers previously paid
    # guaranteed overflow retries — each a recompile — just to ship
    # sentinels).  Padding slots are realigned locally below.
    n_valid = jnp.searchsorted(Qs, jnp.asarray(sent, Qs.dtype)).astype(
        bounds.dtype
    )
    hi = jnp.concatenate([bounds, n_valid[None]])
    lane = jnp.arange(qcap, dtype=bounds.dtype)[None, :]
    src_idx = lo[:, None] + lane
    in_range = src_idx < hi[:, None]
    clip = jnp.clip(src_idx, 0, m - 1)
    send_q = jnp.where(in_range, Qs[clip], sent)
    send_s = jnp.where(in_range, slot_s[clip], jnp.int32(-1))
    dropped = jnp.sum(jnp.maximum(hi - lo - qcap, 0))

    # The slot lane is NOT exchanged at all: the owner never reads it
    # (answers align positionally), and the return path reconstructs
    # alignment from the sender's own send_s (see below) — so the slot
    # lane costs zero collectives in either direction.
    recv_q = jax.lax.all_to_all(send_q, AXIS, 0, 0, tiled=False)
    if values is None:
        raw = answer_fn(recv_q.reshape(-1))
    else:
        send_v = jnp.where(in_range, vals_s[clip], jnp.int32(0))
        recv_v = jax.lax.all_to_all(send_v, AXIS, 0, 0, tiled=False)
        raw = answer_fn(recv_q.reshape(-1), recv_v.reshape(-1))
    # answer_fn may return several lanes (a tuple) from one routing —
    # all lanes ride one return exchange set and one realign sort.
    multi = isinstance(raw, tuple)
    lanes = raw if multi else (raw,)
    backs = [
        jax.lax.all_to_all(
            a.reshape(n_dev, qcap), AXIS, 0, 0, tiled=False
        ).reshape(-1)
        for a in lanes
    ]
    # The slot lane needs no return trip: all_to_all is a transpose
    # across (device, row), so applying it twice is the identity — the
    # sender's own send_s already equals what a returned slot lane would
    # carry, row for row, aligned with the back lanes.  (Verified
    # bit-identical; the slot lane thus costs no collective in either
    # direction.)
    bs = send_s.reshape(-1)
    # Local miss lanes for the unrouted sentinel slots (answers read as
    # 0 of the lane dtype); every slot then appears exactly once in the
    # realign sort — routed real slots from the back lanes, padding
    # slots from here.  (If a real slot overflowed its lane, it is
    # missing and alignment past it is garbage — but `dropped` is
    # necessarily nonzero then, so callers retry; same contract as
    # before.)
    qpos = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)
    pad_key = jnp.where(qpos >= n_valid.astype(jnp.int32), slot_s, jnp.int32(m))
    skey = jnp.concatenate([jnp.where(bs < 0, jnp.int32(m), bs), pad_key])
    full = [
        jnp.concatenate([ab, jnp.zeros(m, ab.dtype)]) for ab in backs
    ]
    realigned = jax.lax.sort((skey, *full), num_keys=1, is_stable=False)
    outs = [ab[:m] for ab in realigned[1:]]
    out = tuple(outs) if multi else outs[0]
    return out, jax.lax.psum(dropped, AXIS)


@functools.lru_cache(maxsize=256)
def sharded_side_tables_fn(mesh: Mesh, k: int, canonical: bool, qcap: int):
    """Builds the jitted multi-device side-table step — the distributed
    form of SPSS hot loop #2 (8 membership lookups per k-mer, reference:
    lib/core/spss.h:238-313), the largest host phase of kmerset-build.

    Input: A sharded P(kv) as per-device sorted key-range blocks of equal
    capacity, SENTINEL-padded (same layout as every sharded structure
    here).  Output: (rdeg, rnbr, rsame, ldeg, lnbr, lsame, dropped), all
    sharded like A; nbr holds DENSE global indices (position in the
    concatenation of live prefixes), directly comparable to the host
    `native.side_tables` on the gathered array.

    Pattern: each device derives its 8 extension candidates locally,
    canonicalizes, routes queries to their key-range owner with a
    fixed-capacity all_to_all (qcap per (src, dst) lane; overflow is
    counted in `dropped` so callers can retry bigger), the owner answers
    by sort-join against its sorted block, and a reverse all_to_all +
    one slot-keyed sort puts answers back in candidate order.
    """
    n_dev = mesh.devices.size

    def step(a_local):
        (rdeg, rnbr, rsame), (ldeg, lnbr, lsame), _live, _offs, dropped = (
            _side_tables_core(a_local, k, canonical, qcap, n_dev)
        )
        return rdeg, rnbr, rsame, ldeg, lnbr, lsame, dropped[None]

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(AXIS),),
        out_specs=(
            P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(),
        ),
        check_vma=False,
    )
    return jax.jit(sharded)


def _side_tables_core(a_local, k: int, canonical: bool, qcap: int, n_dev: int):
    """Per-device side-table body (runs inside shard_map): returns
    ((rdeg, rnbr, rsame), (ldeg, lnbr, lsame), live, offs, dropped) with
    nbr in dense-global indexing and offs the per-device dense offsets."""
    edges = _owner_edges(k, n_dev)
    narrow = k <= SINGLE_MAX_K
    dt = jnp.int32 if narrow else jnp.int64
    nbits = 32 if narrow else 64
    sent = _S_SENT if narrow else SENTINEL
    kmask = dt((1 << (2 * k)) - 1) if narrow else jnp.int64((1 << (2 * k)) - 1)

    cap = a_local.shape[0]
    live = a_local != sent
    n_live = jnp.sum(live, dtype=jnp.int32)
    # Dense global offset of this shard: exclusive cumsum over the
    # gathered live counts.
    all_live = jax.lax.all_gather(n_live, AXIS)
    my = jax.lax.axis_index(AXIS)
    offs = jnp.cumsum(all_live) - all_live
    my_off = offs[my]

    a = a_local.astype(dt)
    # 8 candidate families: side 0 = right (next), side 1 = left (prev);
    # 4 bases each.
    cands = []
    for side in (0, 1):
        for c in range(4):
            if side == 0:
                cand = ((a << 2) | dt(c)) & kmask
            else:
                cand = jax.lax.shift_right_logical(a, dt(2)) | (
                    dt(c) << (2 * (k - 1))
                )
            if canonical:
                rc = _rc_bits(cand, k, nbits)
                ncan = jnp.minimum(cand, rc)
                same = cand != ncan
            else:
                ncan = cand
                same = jnp.zeros(cand.shape, bool)
            cands.append((ncan, same))
    Q = jnp.stack([q for q, _ in cands]).reshape(-1)  # (8*cap,)
    Q = jnp.where(jnp.tile(live, 8), Q, sent)

    def membership(rq):
        # (key, tag) sort-join of recv queries against the local sorted
        # block (sentinels sort to the tail, never equal a live key).
        mm = rq.shape[0]
        keyj = jnp.concatenate([a, rq])
        tag = jnp.concatenate(
            [jnp.zeros(cap, jnp.int32), jnp.ones(mm, jnp.int32)]
        )
        pos = jnp.concatenate(
            [
                jax.lax.broadcasted_iota(jnp.int32, (cap,), 0),
                jax.lax.broadcasted_iota(jnp.int32, (mm,), 0),
            ]
        )
        ks_, tg_, ps = jax.lax.sort(
            (keyj, tag, pos), num_keys=2, is_stable=False
        )
        is_set = tg_ == 0
        akey = jax.lax.cummax(jnp.where(is_set, ks_, dt(-1)), axis=0)
        aidx = jax.lax.cummax(jnp.where(is_set, ps, jnp.int32(-1)), axis=0)
        hit = ~is_set & (akey == ks_) & (ks_ != sent)
        gidx = jnp.maximum(aidx, 0) + my_off  # dense global index
        rkey = jnp.where(is_set, jnp.int32(-1), ps)
        packed = jnp.where(hit, gidx | jnp.int32(1 << 30), gidx)
        _, packed_q = jax.lax.sort((rkey, packed), num_keys=1, is_stable=False)
        return packed_q[cap:]

    ans, dropped = _route_queries(
        Q, jnp.asarray(edges[1:-1]), qcap, n_dev, sent, membership
    )
    ans8 = ans.reshape(8, cap)
    found8 = (ans8 & jnp.int32(1 << 30)) != 0
    idx8 = ans8 & jnp.int32((1 << 30) - 1)

    tables = []
    for side in (0, 1):
        deg = jnp.zeros(cap, jnp.int32)
        nbr = jnp.zeros(cap, jnp.int32)
        samef = jnp.zeros(cap, bool)
        for c in range(4):
            f = side * 4 + c
            ncan, same = cands[f]
            found = found8[f] & live & (ncan != a)
            first = found & (deg == 0)
            nbr = jnp.where(first, idx8[f], nbr)
            samef = jnp.where(first, same, samef)
            deg = deg + found.astype(jnp.int32)
        tables.append((deg, nbr, samef))
    return tables[0], tables[1], live, offs, dropped


@functools.lru_cache(maxsize=256)
def sharded_unitig_succ_fn(mesh: Mesh, k: int, qcap: int):
    """Full mesh front-end of canonical unitig construction: sharded
    side tables + a second owner-routed exchange fetching each unique
    neighbor's degree pair, then the terminal tests and oriented
    successor assembly (the distributed form of ops/unitigs.py's fused
    device front-end; reference: lib/core/spss.h:276-423).

    Input: A sharded P(kv) (sorted key-range blocks, SENTINEL-padded).
    Output (sharded like A, dense-global node ids): succ_r, succ_l
    (int32, -1 = terminal; value = 2 * global_nbr + flip), term_l,
    term_r, both, plus the replicated dropped count (retry bigger qcap
    when nonzero).
    """
    n_dev = mesh.devices.size

    def step(a_local):
        (rdeg, rnbr, rsame), (ldeg, lnbr, lsame), live, offs, d1 = (
            _side_tables_core(a_local, k, True, qcap, n_dev)
        )
        cap = a_local.shape[0]
        n_live = jnp.sum(live, dtype=jnp.int32)
        my = jax.lax.axis_index(AXIS)
        my_off = offs[my]
        total = jax.lax.psum(n_live, AXIS)

        # Mate-degree fetch: for each side's unique neighbor (global
        # dense index), fetch (rdeg, ldeg) at that index.  Index-owner
        # split points are the dense offsets themselves.
        isent = jnp.int32(2**31 - 1)
        q_r = jnp.where(live & (rdeg > 0), rnbr, isent)
        q_l = jnp.where(live & (ldeg > 0), lnbr, isent)
        Qi = jnp.concatenate([q_r, q_l])

        # Mate-degree lookup by dense index: the shared scatter-free
        # cummax lookup with one packed (rdeg | ldeg << 3) lane.
        val = (rdeg & 7) | ((ldeg & 7) << 3)
        (ans,), d2 = _route_queries(
            Qi, offs[1:].astype(jnp.int32), qcap, n_dev, isent,
            _local_multi_lookup(cap, my_off, (val,)),
        )
        mr_deg = ans[:cap]
        ml_deg = ans[cap:]
        mate_r = jnp.where(rsame, mr_deg & 7, (mr_deg >> 3) & 7)
        mate_l = jnp.where(lsame, (ml_deg >> 3) & 7, ml_deg & 7)

        # Terminal tests + oriented successor
        # (reference: lib/core/spss.h:276-313,394-423).
        term_r = (rdeg != 1) | (mate_r != 1)
        term_l = (ldeg != 1) | (mate_l != 1)
        succ_r = jnp.where(
            term_r, jnp.int32(-1), 2 * rnbr + rsame.astype(jnp.int32)
        )
        succ_l = jnp.where(
            term_l, jnp.int32(-1), 2 * lnbr + (~lsame).astype(jnp.int32)
        )
        both = term_l & term_r & live
        dropped = d1 + d2
        return succ_r, succ_l, term_l, term_r, both, total[None], dropped[None]

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(AXIS),),
        out_specs=(
            P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(), P(),
        ),
        check_vma=False,
    )
    return jax.jit(sharded)


def _local_multi_lookup(cap, base, lanes):
    """Returns an answer_fn (for _route_queries) serving one int32 value
    per lane at local dense indices [base, base + cap): every owned index
    exists exactly once, so ONE merge sort answers every lane, with one
    monotone packed cummax per lane recovering exact values without any
    scatter (misses read as 0, so lane values must keep bit 31 clear).
    answer_fn returns a tuple of int32 arrays, one per lane — they ride
    _route_queries' multi-lane return path in the same routing."""

    def fn(rq):
        mm = rq.shape[0]
        jloc = rq - base
        keyj = jnp.concatenate(
            [jax.lax.broadcasted_iota(jnp.int32, (cap,), 0), jloc]
        )
        tag = jnp.concatenate(
            [jnp.zeros(cap, jnp.int32), jnp.ones(mm, jnp.int32)]
        )
        pos = jnp.concatenate(
            [
                jax.lax.broadcasted_iota(jnp.int32, (cap,), 0),
                jax.lax.broadcasted_iota(jnp.int32, (mm,), 0),
            ]
        )
        padded = [
            jnp.concatenate([v, jnp.zeros(mm, jnp.int32)]) for v in lanes
        ]
        merged = jax.lax.sort(
            (keyj, tag, pos, *padded), num_keys=2, is_stable=False
        )
        ks_, tg_, ps = merged[:3]
        is_set = tg_ == 0
        k64 = ks_.astype(jnp.int64)
        outs = []
        for sv in merged[3:]:
            pk = jnp.where(
                is_set,
                (k64 << 32) | (sv.astype(jnp.int64) & 0xFFFFFFFF),
                jnp.int64(-1),
            )
            pr = jax.lax.cummax(pk, axis=0)
            ok = (pr >> 32) == k64
            outs.append(jnp.where(ok, pr & 0xFFFFFFFF, 0).astype(jnp.int32))
        rkey = jnp.where(is_set, jnp.int32(-1), ps)
        realigned = jax.lax.sort((rkey, *outs), num_keys=1, is_stable=False)
        return tuple(a[cap:] for a in realigned[1:])

    return fn


@functools.lru_cache(maxsize=256)
def sharded_pointer_double_fn(mesh: Mesh, rounds: int, with_labels: bool):
    """Distributed pointer doubling — the chain/cycle resolution
    primitive (core/graph.py::pointer_double) over a mesh-sharded
    successor array, replacing the reference's sequential walks and
    union-find at scales one chip cannot hold (reference:
    lib/core/spss.h:394-423,1541-1647).

    Layout: fixed stride — device d owns global node ids
    [d*cap, (d+1)*cap); succ values are global ids or -1.  Each round
    routes every node's current pointer to its owner (one all_to_all
    query cycle, qcap = cap so overflow is impossible), answers with the
    owner's packed (done | dist | ptr) state via the scatter-free
    monotone-cummax lookup, and applies the doubling update.  `rounds`
    must be >= ceil(log2(longest chain)) + 1; matching
    core/graph.pointer_double's round count gives bit-identical results.

    Returns (end, dist, is_chain, min_label) sharded like succ
    (min_label = input labels when with_labels is False).
    """
    n_dev = mesh.devices.size
    # dist rides bits [0, 30) of the packed hi half; bit 30 is the done
    # flag.  Cycle nodes' dist doubles every round (2^r after r rounds),
    # so it MUST be masked on write: at rounds >= 31 (padded N > 2^29)
    # an unmasked 2^30 would spuriously set the done bit and mark cycle
    # nodes as chains (silently dropping their k-mers downstream).  The
    # masked value only differs for non-chain nodes, whose dist is
    # unused — chain dists are true distances < N <= 2^30 and unmasked.
    DIST_MASK = jnp.int32((1 << 30) - 1)

    def step(succ_local, labels_local):
        cap = succ_local.shape[0]
        my = jax.lax.axis_index(AXIS)
        base = (my * cap).astype(jnp.int32)
        ids = jax.lax.broadcasted_iota(jnp.int32, (cap,), 0) + base
        edges_inner = (jnp.arange(1, n_dev, dtype=jnp.int32)) * jnp.int32(cap)
        isent = jnp.int32(2**31 - 1)

        done0 = succ_local < 0
        ptr = jnp.where(done0, ids, succ_local.astype(jnp.int32))
        dist = jnp.where(done0, jnp.int32(0), jnp.int32(1))
        mlab = labels_local.astype(jnp.int32)

        def round_(_, carry):
            ptr, dist, mlab, frozen_pre = carry
            # Lane 0: (done << 30) | (dist & DIST_MASK); lane 1: ptr;
            # with labels, lane 2: the running min-label — all three
            # answered by ONE owner routing per round (one query sort,
            # one exchange set) instead of a second full cycle for the
            # label lane.
            st_hi = (done0.astype(jnp.int32) << 30) | (dist & DIST_MASK)
            lanes = (st_hi, ptr, mlab) if with_labels else (st_hi, ptr)
            ans, _dropped = _route_queries(
                ptr,
                edges_inner,
                cap,
                n_dev,
                isent,
                _local_multi_lookup(cap, base, lanes),
            )
            t_hi, t_ptr = ans[0], ans[1]
            t_done = (t_hi >> 30) != 0
            t_dist = t_hi & DIST_MASK
            if with_labels:
                mlab = jnp.where(
                    frozen_pre, mlab, jnp.minimum(mlab, ans[2])
                )
            dist = jnp.where(
                frozen_pre, dist, dist + jnp.where(t_done, 0, t_dist)
            )
            ptr = jnp.where(frozen_pre, ptr, jnp.where(t_done, ptr, t_ptr))
            return ptr, dist, mlab, frozen_pre | t_done

        # A loop, not `rounds` unrolled copies of the routing cycle: the
        # unrolled program grows with the round count, and its GPU
        # compile with it.
        ptr, dist, mlab, reached = jax.lax.fori_loop(
            0, rounds, round_, (ptr, dist, mlab, done0)
        )
        return ptr, dist, reached, mlab

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        check_vma=False,
    )
    return jax.jit(sharded)


@functools.lru_cache(maxsize=256)
def sharded_hash_fn(mesh: Mesh):
    """Order-independent XOR hash of a key-range-sharded sorted set
    (reference Hash semantics, lib/core/kmer_set.h:221-244): per-device
    XOR, then all_gather + XOR across devices."""

    def step(kmers_local):
        live = kmers_local != SENTINEL
        h = jnp.bitwise_xor.reduce(jnp.where(live, kmers_local, 0))
        all_h = jax.lax.all_gather(h, AXIS)
        return jnp.bitwise_xor.reduce(all_h)[None]

    sharded = jax.shard_map(
        step, mesh=mesh, in_specs=(P(AXIS),), out_specs=P(), check_vma=False
    )
    return jax.jit(sharded)


@functools.lru_cache(maxsize=256)
def sharded_set_algebra_fn(mesh: Mesh):
    """Builds the jitted multi-device set-algebra step over key-range
    sharded sorted sets (the distributed form of the reference's bucket-
    local Add/Sub/Intersection, lib/core/kmer_set.h:164-219,286-305).

    Because both operands are sharded by the same key ranges, intersection
    and difference are device-local: one (key, tag) sort classifies every
    element, and only the sizes cross devices (psum).  Inputs are
    sentinel-padded sorted uniques; outputs are sentinel-padded sorted
    uniques of the same capacity plus replicated global sizes.
    """

    def step(a_local, b_local):
        na = a_local.shape[0]
        key = jnp.concatenate([a_local, b_local])
        tag = jnp.concatenate(
            [jnp.zeros(na, jnp.int32), jnp.ones(b_local.shape[0], jnp.int32)]
        )
        key_s, tag_s = jax.lax.sort((key, tag), num_keys=2, is_stable=False)
        live = key_s != SENTINEL
        nxt = jnp.concatenate([key_s[1:], jnp.full((1,), -1, key_s.dtype)])
        prv = jnp.concatenate([jnp.full((1,), -1, key_s.dtype), key_s[:-1]])
        inter = live & (tag_s == 0) & (nxt == key_s)
        a_only = live & (tag_s == 0) & (nxt != key_s)
        b_only = live & (tag_s == 1) & (prv != key_s)

        def compact(mask):
            out, = jax.lax.sort(
                (jnp.where(mask, key_s, SENTINEL),), num_keys=1, is_stable=False
            )
            return out

        sizes = jnp.stack([jnp.sum(inter), jnp.sum(a_only), jnp.sum(b_only)])
        total = jax.lax.psum(sizes, AXIS)
        return compact(inter), compact(a_only), compact(b_only), total[None]

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P(AXIS), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


@functools.lru_cache(maxsize=256)
def sharded_sketch_weights_fn(mesh: Mesh):
    """Pairwise sketch-intersection sizes over key-range sharded sketches
    (the distributed KmerSetSet similarity phase, reference:
    lib/core/kmer_set_set.h:158-219).  Each device intersects its key
    range of every pair locally (row-wise sort), then sizes are psum'd —
    sketches are never gathered.

    Input: sketches (n_sets, S) sharded on S (each device holds its key
    range of every sketch, sentinel-padded), pair index arrays (n_pairs,).
    Output: (n_pairs,) global intersection sizes, replicated.
    """

    def step(sk_local, ia, ib):
        a = sk_local[ia]
        b = sk_local[ib]
        merged = jnp.concatenate([a, b], axis=1)
        s = jax.lax.sort(merged, dimension=1, is_stable=False)
        hit = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] != SENTINEL)
        local = jnp.sum(hit, axis=1, dtype=jnp.int64)
        return jax.lax.psum(local, AXIS)

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(None, AXIS), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(sharded)


def _group_records_by_end(end_local, dist_local, sel_local, lanes, n_dev):
    """Owner-routed chain grouping shared by sharded_chain_group_fn and
    sharded_emit_fn: route each selected record (end, dist, node id,
    *lanes) to the owner of its `end` id (stride layout: device d owns
    ids [d*cap, (d+1)*cap)), then locally sort by (end asc, dist desc)
    so every chain lies start->end contiguously.  Groups are owner-local
    by construction, so the device-block concatenation is globally
    grouped.  Per-(src,dst) lanes = cap, so the exchange can never
    overflow (a source holds only cap records).  dist < 2^30, so the
    monotone 0x3FFFFFFF - dist flip is exact.

    Returns (sorted end keys with sentinel 2^31-1, tuple of grouped
    lanes: node ids first, then `lanes` in order)."""
    cap = end_local.shape[0]
    isent = jnp.int32(2**31 - 1)
    my = jax.lax.axis_index(AXIS)
    base = (my * cap).astype(jnp.int32)
    ids = jax.lax.broadcasted_iota(jnp.int32, (cap,), 0) + base
    e = jnp.where(sel_local, end_local.astype(jnp.int32), isent)
    d = dist_local.astype(jnp.int32)
    pre = jax.lax.sort((e, d, ids, *lanes), num_keys=1, is_stable=False)
    es, ds = pre[0], pre[1]
    edges_inner = jnp.arange(1, n_dev, dtype=jnp.int32) * jnp.int32(cap)
    bounds = jnp.searchsorted(es, edges_inner)
    n_valid = jnp.sum(e != isent).astype(bounds.dtype)
    lo = jnp.concatenate([jnp.zeros(1, bounds.dtype), bounds])
    hi = jnp.concatenate([bounds, n_valid[None]])
    lane = jnp.arange(cap, dtype=bounds.dtype)[None, :]
    src = lo[:, None] + lane
    in_r = src < hi[:, None]
    clip = jnp.clip(src, 0, cap - 1)

    def xchg(vals, fill):
        send = jnp.where(in_r, vals[clip], fill)
        return jax.lax.all_to_all(send, AXIS, 0, 0, tiled=False).reshape(-1)

    fe = xchg(es, isent)
    fd = xchg(ds, jnp.int32(0))
    fills = (jnp.int32(-1),) + tuple(jnp.int32(0) for _ in lanes)
    fl = [xchg(v, f) for v, f in zip(pre[2:], fills)]
    neg = jnp.int32(0x3FFFFFFF) - fd
    grouped = jax.lax.sort((fe, neg, *fl), num_keys=2, is_stable=False)
    return grouped[0], tuple(grouped[2:])


@functools.lru_cache(maxsize=256)
def sharded_chain_group_fn(mesh: Mesh):
    """Distributed chain grouping — the string-emission front half of the
    walk phase (reference: the sequential path walks of
    lib/core/spss.h:394-423,936-1011) as one owner-routed exchange.

    After pointer doubling every chain node knows (end, dist).  Grouping
    the nodes of each chain contiguously in start->end order is then a
    key exchange: route each node record to the owner of its `end` id
    (stride layout: device d owns ids [d*cap, (d+1)*cap)), and locally
    sort by (end asc, dist desc).  Groups are owner-local by
    construction, so the device-block concatenation is globally grouped;
    the host only slices group boundaries and writes bytes.

    Per-(src,dst) lanes = cap, so the exchange can never overflow (a
    source holds only cap records).  Inputs (stride-sharded): end_local
    int32, dist_local int32, sel_local bool (False rides along as
    sentinel).  Outputs (per device, n_dev*cap each): sorted end keys
    (sentinel 2^31-1) and node ids.
    """
    n_dev = mesh.devices.size

    def step(end_local, dist_local, sel_local):
        es2, (ns2,) = _group_records_by_end(
            end_local, dist_local, sel_local, (), n_dev
        )
        return es2, ns2

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS)),
        check_vma=False,
    )
    return jax.jit(sharded)


@functools.lru_cache(maxsize=256)
def sharded_emit_fn(mesh: Mesh, k: int, ocap: int):
    """Distributed string emission — the back half of the walk phase
    (reference ConcatenateKmers + the emission loops,
    lib/core/spss.h:25-41,936-1011): groups chain records by end owner
    exactly like sharded_chain_group_fn, but every record also carries
    its oriented k-mer value, and each device renders its groups straight
    to a 2-bit base-code stream.  The host never touches the k-mer array
    again after the exchange — it only concatenates per-device byte
    blocks and slices group boundaries, so emission scales with the mesh
    instead of one host's memory bandwidth.

    Per record lanes exchanged: (end, dist, node id, vhi, vlo) where
    vhi bit 30 is the orientation flip and vhi/vlo split the 2k-bit
    forward k-mer value (hi bits in vhi).  The device applies the
    reverse complement for flipped records (the bit-swizzle _rc_bits)
    and extracts base j of each record's contribution as
    (value >> 2*(L-1-j)) & 3 with L = k for the chain head, 1 otherwise
    (= kmer.codes_from_kmer's layout, so output bytes are identical to
    the host _emit_kmer_chains).

    ocap: per-device output-code capacity.  A device needs
    n_records + (k-1)*n_groups codes for the groups it owns; shortfall
    is counted and psum'd in `overflow` so callers retry bigger.

    Outputs (per device): codes (ocap,) int8, sorted end keys (N,),
    node ids (N,), n_out (1,), overflow (1, replicated).
    """
    n_dev = mesh.devices.size
    narrow = k <= SINGLE_MAX_K

    def step(end_local, dist_local, sel_local, vhi_local, vlo_local):
        isent = jnp.int32(2**31 - 1)
        es2, (ns2, vh2, vl2) = _group_records_by_end(
            end_local, dist_local, sel_local, (vhi_local, vlo_local), n_dev
        )

        live = es2 != isent
        prev = jnp.concatenate([jnp.full((1,), -1, es2.dtype), es2[:-1]])
        head = live & (es2 != prev)
        flip = (vh2 >> 30) & 1
        if narrow:
            fwd = vl2
            ov = jnp.where(flip != 0, _rc_bits(fwd, k, 32), fwd).astype(
                jnp.int64
            )
        else:
            fwd = ((vh2 & jnp.int32(0x3FFFFFFF)).astype(jnp.int64) << 32) | (
                vl2.astype(jnp.int64) & jnp.int64(0xFFFFFFFF)
            )
            ov = jnp.where(flip != 0, _rc_bits(fwd, k, 64), fwd)
        L = jnp.where(head, jnp.int32(k), jnp.where(live, 1, 0))
        cum = jnp.cumsum(L) - L  # exclusive offsets; strictly increasing
        n_out = jnp.sum(L)  # over the live prefix (dead lanes add 0)
        p = jax.lax.broadcasted_iota(jnp.int32, (ocap,), 0)
        r = jnp.clip(
            jnp.searchsorted(cum, p, side="right").astype(jnp.int32) - 1,
            0,
            cum.shape[0] - 1,
        )
        q = p - cum[r]
        shift = (2 * (L[r] - 1 - q)).astype(jnp.int64)
        code = (ov[r] >> shift) & 3
        codes = jnp.where(p < n_out, code, 0).astype(jnp.int8)
        overflow = jnp.maximum(n_out - ocap, 0)
        return (
            codes,
            es2,
            ns2,
            jnp.minimum(n_out, ocap)[None],
            jax.lax.psum(overflow, AXIS)[None],
        )

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


@functools.lru_cache(maxsize=256)
def sharded_matching_fn(mesh: Mesh):
    """Distributed handshake matching — the greedy edge-selection phase
    of the SPSS path cover (reference's bucket-locked try_lock greedy,
    lib/core/spss.h:796-817,1445-1498) over a device mesh.

    The priority-ordered greedy matching is UNIQUE (an edge is selected
    iff it is the minimum-priority live edge at both of its ports), so
    this produces bit-identical results to core.graph.handshake_matching
    and the native sequential scan.

    Layout: ports stride-sharded (device d owns [d*pcap, (d+1)*pcap));
    edges stride-sharded in priority order (priority = global position,
    padding pa = -1).  Each round: (A) edges query both ports' free
    flags, (B) live edges send (port, priority) records and owners
    answer the per-port minimum in the same round trip, (C) winning
    edges (min at both ports) route (port, partner) records to the port
    owners, which mark matches scatter-free.  At least the globally
    minimum live edge wins every round, so the loop terminates.

    Inputs: pa_local, pb_local (ecap,) int32; match0_local (pcap,) int32
    (shape carrier).  Output: match sharded by port (-1 = unmatched).
    """
    n_dev = mesh.devices.size

    def step(pa_local, pb_local, match0):
        ecap = pa_local.shape[0]
        pcap = match0.shape[0]
        my = jax.lax.axis_index(AXIS)
        pbase = (my * pcap).astype(jnp.int32)
        ebase = (my * ecap).astype(jnp.int32)
        prio = jax.lax.broadcasted_iota(jnp.int32, (ecap,), 0) + ebase
        psent = jnp.int32(2**31 - 1)
        pedges = jnp.arange(1, n_dev, dtype=jnp.int32) * jnp.int32(pcap)
        qcap = 2 * ecap  # every (port, prio) record could share one owner

        free0 = jnp.ones((pcap,), jnp.bool_)
        m0 = jnp.full((pcap,), -1, jnp.int32)
        alive0 = pa_local >= 0

        def best_fn(rq, rv):
            """Per-port minimum of rv over the received records,
            answered at every record (sentinel ports answer garbage,
            dropped at the caller)."""
            mm = rq.shape[0]
            pos = jax.lax.broadcasted_iota(jnp.int32, (mm,), 0)
            kq, kv, kp = jax.lax.sort((rq, rv, pos), num_keys=2, is_stable=False)
            head = jnp.concatenate(
                [jnp.ones(1, jnp.bool_), kq[1:] != kq[:-1]]
            )
            k64 = kq.astype(jnp.int64)
            packed = jnp.where(
                head, (k64 << 32) | (kv.astype(jnp.int64) & 0xFFFFFFFF),
                jnp.int64(-1),
            )
            pr = jax.lax.cummax(packed, axis=0)
            ok = (pr >> 32) == k64
            val = jnp.where(ok, pr & 0xFFFFFFFF, jnp.int64(1) << 40)
            _, out = jax.lax.sort((kp, val), num_keys=1, is_stable=False)
            return out

        def body(state):
            free, match, alive = state
            # (A) both ports still free?
            fi = free.astype(jnp.int32)
            Q = jnp.concatenate(
                [
                    jnp.where(alive, pa_local, psent),
                    jnp.where(alive, pb_local, psent),
                ]
            )
            (ansA,), _ = _route_queries(
                Q, pedges, qcap, n_dev, psent,
                _local_multi_lookup(pcap, pbase, (fi,)),
            )
            fa = ansA[:ecap] != 0
            fb = ansA[ecap:] != 0
            alive = alive & fa & fb
            # (B) per-port minimum priority over live edges.
            Q2 = jnp.concatenate(
                [
                    jnp.where(alive, pa_local, psent),
                    jnp.where(alive, pb_local, psent),
                ]
            )
            V2 = jnp.concatenate([prio, prio])
            ansB, _ = _route_queries(
                Q2, pedges, qcap, n_dev, psent, best_fn, values=V2
            )
            p64 = prio.astype(jnp.int64)
            win = alive & (ansB[:ecap] == p64) & (ansB[ecap:] == p64)
            # (C) winners claim both ports: route (port, partner)
            # records to the owners, which update free/match without
            # scatter (each port receives at most one record per round).
            WQ = jnp.concatenate(
                [
                    jnp.where(win, pa_local, psent),
                    jnp.where(win, pb_local, psent),
                ]
            )
            WV = jnp.concatenate([pb_local, pa_local])
            mw = WQ.shape[0]
            WQs, WVs = jax.lax.sort((WQ, WV), num_keys=1, is_stable=False)
            bounds = jnp.searchsorted(WQs, pedges)
            lo = jnp.concatenate([jnp.zeros(1, bounds.dtype), bounds])
            n_v = jnp.sum(WQ != psent).astype(bounds.dtype)
            hi = jnp.concatenate([bounds, n_v[None]])
            lane = jnp.arange(qcap, dtype=bounds.dtype)[None, :]
            src = lo[:, None] + lane
            in_r = src < hi[:, None]
            clip = jnp.clip(src, 0, mw - 1)
            send_p = jnp.where(in_r, WQs[clip], psent)
            send_v = jnp.where(in_r, WVs[clip], jnp.int32(-1))
            rp = jax.lax.all_to_all(send_p, AXIS, 0, 0, tiled=False).reshape(-1)
            rv = jax.lax.all_to_all(send_v, AXIS, 0, 0, tiled=False).reshape(-1)
            # Owner update via merge sort + packed cummax (records first
            # within a key so owned slots read the propagated value).
            mm = rp.shape[0]
            jloc = rp - pbase
            keyj = jnp.concatenate(
                [jloc, jax.lax.broadcasted_iota(jnp.int32, (pcap,), 0)]
            )
            tag = jnp.concatenate(
                [jnp.zeros(mm, jnp.int32), jnp.ones(pcap, jnp.int32)]
            )
            pos = jnp.concatenate(
                [
                    jnp.full(mm, pcap, jnp.int32),
                    jax.lax.broadcasted_iota(jnp.int32, (pcap,), 0),
                ]
            )
            vals = jnp.concatenate([rv, jnp.zeros(pcap, jnp.int32)])
            ks, ts, ps, vs = jax.lax.sort(
                (keyj, tag, pos, vals), num_keys=2, is_stable=False
            )
            is_rec = ts == 0
            k64 = ks.astype(jnp.int64)
            packed = jnp.where(
                is_rec & (ks >= 0) & (ks < pcap),
                (k64 << 32) | (vs.astype(jnp.int64) & 0xFFFFFFFF),
                jnp.int64(-1),
            )
            pr = jax.lax.cummax(packed, axis=0)
            hit = (pr >> 32) == k64
            part = (pr & 0xFFFFFFFF).astype(jnp.int32)
            # realign owned slots to local order
            skey = jnp.where(is_rec, jnp.int32(pcap), ps)
            _, hit_o, part_o = jax.lax.sort(
                (skey, hit.astype(jnp.int32), part), num_keys=1, is_stable=False
            )
            hit_l = hit_o[:pcap] != 0
            match = jnp.where(hit_l, part_o[:pcap], match)
            free = free & ~hit_l
            alive = alive & ~win
            return free, match, alive

        def cond(state):
            _, _, alive = state
            return jax.lax.psum(jnp.sum(alive.astype(jnp.int32)), AXIS) > 0

        _, match, _ = jax.lax.while_loop(cond, body, (free0, m0, alive0))
        return match

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS)),
        out_specs=P(AXIS),
        check_vma=False,
    )
    return jax.jit(sharded)


@functools.lru_cache(maxsize=256)
def sharded_overlap_edges_fn(mesh: Mesh, k: int, qcap: int):
    """Distributed unitig overlap-edge discovery — SPSS stage-2's
    candidate enumeration (reference hash multimaps of unitig
    prefixes/suffixes, lib/core/spss.h:619-695,1057-1145) as one
    build-and-probe exchange pair over the mesh.

    Each device owns a block of unitigs and contributes its (first,
    last) k-mers to a key-range sharded lookup table (combined key =
    (value << 1) | table_bit, int64: 2k+1 bits — 61 at the driver's
    k <= 30 ceiling, which keeps every key below this function's 2^62
    sentinel; k = 31 keys would reach it, so the driver routes k = 31
    to the host join instead), then probes the
    16 gluing candidates per unitig (4 bases x {next, rc(next), prev,
    rc(prev)}) through the owner-routed query cycle.  Assumes P and S
    values are globally unique (true for unitigs: every k-mer appears
    exactly once across an SPSS) — the driver guards this.

    Inputs (stride-sharded, (ucap,) int64, -1 padding): p_local,
    s_local.  Output: (16 * ucap,) int32 per device — per (join type,
    unitig) the partner id | found << 30 — plus the psum'd dropped
    count (retry with a larger qcap when nonzero).
    """
    n_dev = mesh.devices.size
    edges2 = jnp.asarray(_owner_edges(k, n_dev)[1:-1] * 2, dtype=jnp.int64)
    sent2 = jnp.int64(1) << 62
    kmask = jnp.int64((1 << (2 * k)) - 1)

    def step(p_local, s_local):
        ucap = p_local.shape[0]
        my = jax.lax.axis_index(AXIS)
        ids = jax.lax.broadcasted_iota(jnp.int32, (ucap,), 0) + (
            my * ucap
        ).astype(jnp.int32)
        live = p_local >= 0
        p = p_local.astype(jnp.int64)
        s = s_local.astype(jnp.int64)

        # Build the combined table: route (key', id) records to the
        # value's key-range owner.  Per-pair lanes = 2 * ucap (a source
        # holds only that many records), so the build cannot overflow.
        tkey = jnp.concatenate(
            [
                jnp.where(live, p << 1, sent2),
                jnp.where(live, (s << 1) | 1, sent2),
            ]
        )
        tval = jnp.concatenate([ids, ids])
        tks, tvs = jax.lax.sort((tkey, tval), num_keys=1, is_stable=False)
        mlen = 2 * ucap
        bounds = jnp.searchsorted(tks, edges2)
        lo = jnp.concatenate([jnp.zeros(1, bounds.dtype), bounds])
        n_v = jnp.sum(tkey != sent2).astype(bounds.dtype)
        hi = jnp.concatenate([bounds, n_v[None]])
        lane = jnp.arange(mlen, dtype=bounds.dtype)[None, :]
        src = lo[:, None] + lane
        in_r = src < hi[:, None]
        clip = jnp.clip(src, 0, mlen - 1)
        send_k = jnp.where(in_r, tks[clip], sent2)
        send_v = jnp.where(in_r, tvs[clip], jnp.int32(-1))
        rk = jax.lax.all_to_all(send_k, AXIS, 0, 0, tiled=False).reshape(-1)
        rv = jax.lax.all_to_all(send_v, AXIS, 0, 0, tiled=False).reshape(-1)
        tk_s, tv_s = jax.lax.sort((rk, rv), num_keys=1, is_stable=False)
        tsz = tk_s.shape[0]

        # Probe queries, in the host _join discovery-priority order
        # (core/spss._candidate_port_edges_canonical): per base c all
        # right-left rows then all right-right rows, then the left
        # families.
        qs = []
        for c in range(4):
            nx = ((s << 2) | c) & kmask
            qs.append(nx << 1)  # right(i)-left(j): vs P table
            qs.append((_rc_bits(nx, k, 64) << 1) | 1)  # right-right: vs S
        for c in range(4):
            pv = (p >> 2) | (jnp.int64(c) << (2 * (k - 1)))
            qs.append((pv << 1) | 1)  # left(i)-right(j): vs S
            qs.append(_rc_bits(pv, k, 64) << 1)  # left-left: vs P
        Q = jnp.where(jnp.tile(live, 16), jnp.stack(qs).reshape(-1), sent2)

        def probe(rq):
            mm = rq.shape[0]
            keyj = jnp.concatenate([tk_s, rq])
            tag = jnp.concatenate(
                [jnp.zeros(tsz, jnp.int32), jnp.ones(mm, jnp.int32)]
            )
            pos = jnp.concatenate(
                [
                    jax.lax.broadcasted_iota(jnp.int32, (tsz,), 0),
                    jax.lax.broadcasted_iota(jnp.int32, (mm,), 0),
                ]
            )
            ks_, tg_, ps = jax.lax.sort(
                (keyj, tag, pos), num_keys=2, is_stable=False
            )
            is_set = tg_ == 0
            akey = jax.lax.cummax(
                jnp.where(is_set, ks_, jnp.int64(-1)), axis=0
            )
            apos = jax.lax.cummax(
                jnp.where(is_set, ps, jnp.int32(-1)), axis=0
            )
            hit = (~is_set) & (akey == ks_) & (ks_ != sent2)
            pid = tv_s[jnp.maximum(apos, 0)]
            packed = jnp.where(hit, pid | jnp.int32(1 << 30), jnp.int32(0))
            rkey = jnp.where(is_set, jnp.int32(-1), ps)
            _, out = jax.lax.sort((rkey, packed), num_keys=1, is_stable=False)
            return out[tsz:]

        # Duplicate-key detection rides the already-sorted owner table
        # (free adjacent compare): the probe answers only one partner per
        # key, so duplicated prefix/suffix values would silently drop
        # edges — the driver falls back to the host join when dup > 0.
        # (Unitigs of one SPSS can never trigger this; the flag replaces
        # two O(n log n) host np.unique guards per call.)
        dup = jnp.sum((tk_s[1:] == tk_s[:-1]) & (tk_s[1:] != sent2))
        ans, dropped = _route_queries(Q, edges2, qcap, n_dev, sent2, probe)
        return ans, dropped[None], jax.lax.psum(dup, AXIS)[None]

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)
