"""Device (XLA) k-mer counting pipeline.

The jittable, fixed-shape core of the counter (reference hot loop:
lib/core/kmer_counter.h:80-96 — per-window substring hashing into bucket
maps), as one XLA program:

    pack windows -> reverse complement -> canonical min -> sort ->
    segment boundaries -> run lengths -> compaction

All shapes are static: invalid windows (crossing fragment boundaries, or
padding) carry a sentinel key that sorts to the end; `n_unique` marks the
live prefix of the outputs.

Key representation: k <= 15 uses one int32 key; k <= 23 runs on (hi, lo)
int32 pairs — hi holds the first ceil(k/2) bases, lo the rest (<= 24 bits
each for the CLI k's) — sorted lexicographically with
lax.sort(num_keys=2), the int32 decomposition of the reference's
bucket/key split (reference: lib/core/kmer_set.h:20-31); k > 23 uses
int64 keys (x64 mode is enabled on import).  Whether the pair layout
still pays against one int64 key is an open measurement.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)

SENTINEL = np.int64(1 << 62)  # > any 2k-bit k-mer key (k <= 31: max 2^62 - 1)
SINGLE_MAX_K = 15  # 2k <= 30 bits fits one non-negative int32
PAIR_MAX_K = 23
_HI_SENT = np.int32(1 << 30)
_S_SENT = np.int32((1 << 31) - 1)


def _khi(k: int) -> int:
    return (k + 1) // 2


def _pack_contig(codes: jnp.ndarray, start: int, m: int, dtype) -> jnp.ndarray:
    """out[p] = codes[p+start] .. codes[p+start+m-1] packed 2 bits/base,
    first position most significant, via log-doubling rolls.

    Building the length-2^l packs by pairing (l rolls) and then combining
    one pack per set bit of m costs ~2*log2(m) rolls instead of the m rolls
    of the naive left-shift accumulation.
    """
    c = codes.astype(dtype)
    if start:
        c = jnp.roll(c, -start)
    packs = [c]  # packs[l][p] = window of 2^l bases starting at p
    span = 1
    while span * 2 <= m:
        prev = packs[-1]
        packs.append((prev << (2 * span)) | jnp.roll(prev, -span))
        span *= 2
    out = None
    pos = 0
    for l in range(len(packs) - 1, -1, -1):
        size = 1 << l
        if not (m & size):
            continue
        piece = packs[l] if pos == 0 else jnp.roll(packs[l], -pos)
        out = piece if out is None else ((out << (2 * size)) | piece)
        pos += size
    return out


def _pack_span(codes: jnp.ndarray, positions: range, dtype) -> jnp.ndarray:
    """Packs codes[p + q] for q in `positions` (first listed = most
    significant lane) for every window start p."""
    # Every caller builds step-1 ranges; the doubling path IS the
    # implementation (a naive per-base fallback was dead code).
    assert positions.step == 1, positions
    return _pack_contig(codes, positions.start, len(positions), dtype)


def _pack_span_rc(codes: jnp.ndarray, positions: range, dtype) -> jnp.ndarray:
    """Same but for the reverse complement: base t of the rc-window is
    3 - codes[p + k - 1 - t], so `positions` are given already reflected
    (step -1 — the only shape callers build)."""
    if positions.step == -1:
        # Descending positions hi..lo of 3-codes == ascending pack of the
        # mirrored pairing: build with doubling on the reflected sequence.
        lo_q = positions[-1]
        m = len(positions)
        d = (3 - codes).astype(dtype)
        if lo_q:
            d = jnp.roll(d, -lo_q)
        # packs[l][p] = d[p+2^l-1] .. d[p] (descending within the window)
        packs = [d]
        span = 1
        while span * 2 <= m:
            prev = packs[-1]
            packs.append((jnp.roll(prev, -span) << (2 * span)) | prev)
            span *= 2
        out = None
        pos = 0  # bases consumed from the high end
        for l in range(len(packs) - 1, -1, -1):
            size = 1 << l
            if not (m & size):
                continue
            off = m - pos - size  # this piece covers d[off .. off+size-1]
            piece = packs[l] if off == 0 else jnp.roll(packs[l], -off)
            out = piece if out is None else ((out << (2 * size)) | piece)
            pos += size
        return out
    # Callers always reflect to step -1; see _pack_span.
    raise AssertionError(positions)


def _single_windows(codes: jnp.ndarray, k: int, canonical: bool) -> jnp.ndarray:
    """One int32 canonical window key per position (k <= 15: 2k <= 30 bits)."""
    fwd = _pack_span(codes, range(0, k), jnp.int32)
    if not canonical:
        return fwd
    rc = _pack_span_rc(codes, range(k - 1, -1, -1), jnp.int32)
    return jnp.minimum(fwd, rc)


def _pair_windows(codes: jnp.ndarray, k: int, canonical: bool):
    """(hi, lo) int32 canonical window keys."""
    kh = _khi(k)
    hi = _pack_span(codes, range(0, kh), jnp.int32)
    lo = _pack_span(codes, range(kh, k), jnp.int32)
    if not canonical:
        return hi, lo
    # rc base t = 3 - codes[p + k - 1 - t]; hi spans t in [0, kh),
    # lo spans t in [kh, k).
    rhi = _pack_span_rc(codes, range(k - 1, k - 1 - kh, -1), jnp.int32)
    rlo = _pack_span_rc(codes, range(k - 1 - kh, -1, -1), jnp.int32)
    less = (rhi < hi) | ((rhi == hi) & (rlo < lo))
    return jnp.where(less, rhi, hi), jnp.where(less, rlo, lo)


def _int64_windows(codes: jnp.ndarray, k: int, canonical: bool) -> jnp.ndarray:
    fwd = _pack_span(codes, range(0, k), jnp.int64)
    if not canonical:
        return fwd
    rc = _pack_span_rc(codes, range(k - 1, -1, -1), jnp.int64)
    return jnp.minimum(fwd, rc)


def _window_keys(codes: jnp.ndarray, k: int, canonical: bool):
    """Window keys of unpacked codes in the count layout for k: one int32
    array (k <= 15), an int32 (hi, lo) pair (k <= 23), or int64."""
    if k <= SINGLE_MAX_K:
        return _single_windows(codes, k, canonical)
    if k <= PAIR_MAX_K:
        return _pair_windows(codes, k, canonical)
    return _int64_windows(codes, k, canonical)


def canonical_windows(codes: jnp.ndarray, k: int, canonical: bool) -> jnp.ndarray:
    """int64 canonical window keys (used by the sharded mesh path)."""
    if k <= SINGLE_MAX_K:
        return _single_windows(codes, k, canonical).astype(jnp.int64)
    if k <= PAIR_MAX_K:
        hi, lo = _pair_windows(codes, k, canonical)
        klo = k - _khi(k)
        return (hi.astype(jnp.int64) << (2 * klo)) | lo.astype(jnp.int64)
    return _int64_windows(codes, k, canonical)


def _run_lengths(boundary: jnp.ndarray, live: jnp.ndarray) -> jnp.ndarray:
    """Length of the run starting at each boundary position, scatter-free:
    a reverse cummin of boundary indices gives each position the next run
    head, and the length is the distance to it."""
    n = boundary.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    term = jnp.where(boundary | ~live, idx, jnp.int32(n))
    rc = jax.lax.cummin(term, axis=0, reverse=True)
    nb_excl = jnp.concatenate([rc[1:], jnp.full((1,), n, jnp.int32)])
    return nb_excl - idx


def _compact(order_key: jnp.ndarray, keys, extras=()):
    """Partitions elements with order_key 0 to the front, preserving sorted
    key order (one extra sort instead of a scatter).  `keys` are already
    sorted, so including them as secondary sort keys makes an *unstable*
    sort order-preserving."""
    res = jax.lax.sort(
        (order_key, *keys, *extras), num_keys=1 + len(keys), is_stable=False
    )
    return res[1:]


def good_sort_size(n: int) -> int:
    """Padded size class >= n: the smallest 2^p or 3*2^p.

    Every distinct input length is a new static shape of the jitted count
    programs, so sizes are rounded up to a few classes to bound
    recompiles; worst-case padding is ~50% (just above a power of two),
    ~17% amortized over uniform sizes."""
    if n <= 1024:
        return max(n, 1)
    p2 = 1 << (n - 1).bit_length()
    three = 3 * (p2 >> 2)
    if three >= n:
        return three
    return p2


def _valid_windows(valid, k: int):
    """Drops the trailing k-1 positions before sorting: a window starting
    there runs off the end of the codes, so `valid` is False by
    construction (window_validity) and the keys are sentinels.  Callers
    pad the codes so that len - (k-1) lands on a size class of
    good_sort_size."""
    n = valid.shape[0] - (k - 1)
    return valid[:n] if n > 0 else valid


def _sorted_runs(win, valid, k: int):
    """Sort all window keys and mark run boundaries.

    `win` are the window keys (_window_keys layout) of at least
    valid.shape[0] windows; `valid` covers only the windows that fit in
    the codes (_valid_windows), and invalid windows get sentinel keys.

    Returns (to_int64, sorted_keys, live, boundary) where sorted_keys is
    a tuple of key arrays (single int32 for k <= 15, an int32 pair for
    k <= 23, single int64 above) and to_int64 combines compacted keys.
    Run lengths are NOT materialized here — callers use `_run_lengths`
    (reverse cummin scan) or, when only thresholding on a small cutoff,
    the cheaper `_run_reaches` shifted compare."""
    n_keys = valid.shape[0]
    if k <= SINGLE_MAX_K:
        key = jnp.where(valid, win[:n_keys], _S_SENT)
        (s,) = jax.lax.sort((key,), num_keys=1, is_stable=False)
        prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), s[:-1]])
        live = s != _S_SENT
        boundary = live & (s != prev)

        def to64(keys):
            return keys[0].astype(jnp.int64)

        keys = (s,)
    elif k <= PAIR_MAX_K:
        hi, lo = win
        hi = jnp.where(valid, hi[:n_keys], _HI_SENT)
        lo = jnp.where(valid, lo[:n_keys], 0)
        sh, sl = jax.lax.sort((hi, lo), num_keys=2, is_stable=False)
        ph = jnp.concatenate([jnp.full((1,), -1, jnp.int32), sh[:-1]])
        pl = jnp.concatenate([jnp.full((1,), -1, jnp.int32), sl[:-1]])
        live = sh != _HI_SENT
        boundary = live & ((sh != ph) | (sl != pl))
        klo = k - _khi(k)

        def to64(keys):
            h, l = keys
            return (h.astype(jnp.int64) << (2 * klo)) | l.astype(jnp.int64)

        keys = (sh, sl)
    else:
        key = jnp.where(valid, win[:n_keys], SENTINEL)
        (s,) = jax.lax.sort((key,), num_keys=1, is_stable=False)
        prev = jnp.concatenate([jnp.full((1,), -1, dtype=s.dtype), s[:-1]])
        live = s != SENTINEL
        boundary = live & (s != prev)

        def to64(keys):
            return keys[0]

        keys = (s,)
    return to64, keys, live, boundary


def _run_reaches(keys, live, c: int) -> jnp.ndarray:
    """True at run heads whose run length is >= c, without materializing
    run lengths: the head at i has count >= c iff position i+c-1 is live
    and holds the same key — two shifted compares instead of the reverse
    cummin scan of `_run_lengths`."""
    if c <= 1:
        return jnp.ones(live.shape, dtype=bool)
    if c - 1 >= live.shape[0]:
        # Fewer keys than cutoff-1: no run can reach c (and the shifted
        # concatenates below would be shape-mismatched).
        return jnp.zeros(live.shape, dtype=bool)
    eq = jnp.ones(live.shape, dtype=bool)
    for key in keys:
        shifted = jnp.concatenate(
            [key[c - 1 :], jnp.full((c - 1,), -1, key.dtype)]
        )
        eq &= shifted == key
    shifted_live = jnp.concatenate([live[c - 1 :], jnp.zeros(c - 1, bool)])
    return eq & shifted_live


def _compact_runs(to64, keys, select, extras=()):
    """Stable-partitions selected run heads to the front and finalizes the
    (uniq int64, compacted extras, n_selected) outputs.

    The partition flag is fused into unused high bits of the leading sort
    key (2k-bit keys always leave headroom below the sentinel bit), so the
    compaction sort carries no separate order-key operand: selected heads
    keep their value and sort ascending to the front; everything else gets
    the flag bit and lands behind them in one unstable single/pair-key
    sort.  The selected prefix is bit-identical to the original keys."""
    lead = keys[0]
    if lead.dtype == jnp.int32:
        # pair layout: hi <= 2*ceil(k/2) <= 24 bits, _HI_SENT = 2^30;
        # single layout: key <= 30 bits, _S_SENT = 2^31 - 1 (bit 30 set).
        flag = jnp.int32(1 << 28) if len(keys) > 1 else jnp.int32(1 << 30)
    else:
        flag = SENTINEL  # 2^62 > any 2k-bit key (k <= 31)
    fused = jnp.where(select, lead, lead | flag)
    res = jax.lax.sort(
        (fused, *keys[1:], *extras), num_keys=len(keys), is_stable=False
    )
    nk = len(keys)
    ckeys, cextras = res[:nk], res[nk:]
    n_sel = jnp.sum(select)
    n = select.shape[0]
    pos = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    in_range = pos < n_sel
    uniq = jnp.where(in_range, to64(ckeys), SENTINEL)
    cextras = tuple(jnp.where(in_range, e, 0) for e in cextras)
    return uniq, cextras, n_sel


def _count_impl(win, valid: jnp.ndarray, k: int):
    to64, keys, live, boundary = _sorted_runs(win, valid, k)
    counts = _run_lengths(boundary, live)
    uniq, (cc,), n_sel = _compact_runs(to64, keys, boundary, (counts,))
    return uniq, cc, n_sel


@partial(jax.jit, static_argnames=("k", "canonical"))
def count_kmers(codes: jnp.ndarray, valid: jnp.ndarray, k: int, canonical: bool):
    """codes: (L,) uint8/int32 base codes; valid: (L,) bool window validity.

    Returns (uniq, counts, n_unique): uniq[:n_unique] are the sorted
    distinct (canonical) k-mers as int64, counts aligned; tail is sentinel.
    """
    return _count_impl(_window_keys(codes, k, canonical), _valid_windows(valid, k), k)


def _unpack2(packed, L: int):
    """(ceil(L/4),) uint8 with 4 codes/byte (low bits first — the
    kmerio_pack2 layout) -> (L,) int32 base codes.  The 2-bit wire
    format quarters the codes upload; XLA lowers the stack+reshape to
    one relayout pass."""
    b = packed.astype(jnp.int32)
    four = jnp.stack(
        [b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3], axis=1
    )
    return four.reshape(-1)[:L]


def _frag_window_validity(bounds, total, L: int, k: int):
    """Traced window validity from fragment boundaries: a window starting
    at s is valid iff no boundary lies in (s, s+k-1] and it is fully
    inside the unpadded input (host reference: `window_validity`).  The
    next-boundary-after-s lookup is the `_run_lengths` reverse-cummin
    pattern, so no per-position mask is uploaded (`bounds` is a few KB)."""
    idx = jax.lax.broadcasted_iota(jnp.int32, (L + 1,), 0)
    isb = jnp.zeros((L + 1,), bool).at[bounds].set(True)
    term = jnp.where(isb, idx, jnp.int32(L + 1))
    rc = jax.lax.cummin(term, axis=0, reverse=True)
    nxt = rc[1:]  # min boundary strictly greater than s, length L
    pos = jax.lax.broadcasted_iota(jnp.int32, (L,), 0)
    return (nxt > pos + (k - 1)) & (pos < jnp.asarray(total, jnp.int32))


@partial(jax.jit, static_argnames=("L", "k", "canonical"))
def count_kmers_frag(packed, bounds, total, L: int, k: int, canonical: bool):
    """count_kmers with the slim wire format: packed (ceil(L/4),) uint8
    2-bit codes (kmerio_pack2 layout), bounds (B,) int32 sorted fragment
    boundaries (offsets[1:], padded by repeating the total length),
    total the traced unpadded length, L the static unpacked code count.
    Uploads 0.25 B/base instead of the 4 B/base int32 codes + 1 B/base
    bool mask of the count_kmers staging; window validity is computed on
    device (_frag_window_validity)."""
    win = _window_keys(_unpack2(packed, L), k, canonical)
    valid = _valid_windows(_frag_window_validity(bounds, total, L, k), k)
    return _count_impl(win, valid, k)


# Run-length threshold tests stay shifted-compares up to this cutoff; the
# scan-based run lengths win beyond it.
_MAX_SHIFT_CUTOFF = 8


@partial(jax.jit, static_argnames=("k", "canonical", "cutoff"))
def count_to_set(codes, valid, k: int, canonical: bool, cutoff: int):
    """Full counter -> cutoff-filtered set step (reference ToKmerSet,
    lib/core/kmer_counter.h:211-243), fused: the cutoff test is applied to
    the run heads before one compaction pass (the flag-fused partition
    sort of `_compact_runs`)."""
    return _count_to_set_impl(
        _window_keys(codes, k, canonical), _valid_windows(valid, k), k, cutoff
    )


def _count_to_set_impl(win, valid, k: int, cutoff: int):
    to64, keys, live, boundary = _sorted_runs(win, valid, k)
    if cutoff <= _MAX_SHIFT_CUTOFF:
        keep = boundary & _run_reaches(keys, live, cutoff)
    else:
        keep = boundary & (_run_lengths(boundary, live) >= cutoff)
    n_unique = jnp.sum(boundary)
    uniq, _, n_kept = _compact_runs(to64, keys, keep)
    return uniq, n_kept, n_unique - n_kept


@partial(jax.jit, static_argnames=("L", "k", "canonical", "cutoff"))
def count_to_set_frag(
    packed, bounds, total, L: int, k: int, canonical: bool, cutoff: int
):
    """count_to_set with the slim upload format of count_kmers_frag
    (2-bit packed codes + boundary array; validity computed on device)."""
    win = _window_keys(_unpack2(packed, L), k, canonical)
    valid = _valid_windows(_frag_window_validity(bounds, total, L, k), k)
    return _count_to_set_impl(win, valid, k, cutoff)


def window_validity(offsets: np.ndarray, total: int, k: int) -> np.ndarray:
    """Host helper: windows fully inside one fragment are valid
    (split-at-'N' semantics, reference: lib/core/kmer_counter.h:78).

    A window starting at s is invalid iff some fragment boundary o
    (interior or the terminal `total`) lies in (s, s + k - 1] — i.e.
    s in [o - k + 1, o).  Only those (k-1)-wide bands are materialized
    (<= (k-1) * n_fragments indices), instead of several full-length
    int64 temporaries: at the out-of-core scales that route through the
    mesh/chunked paths the old formulation transiently allocated ~24x
    the codes array."""
    valid = np.ones(total, dtype=bool)
    if total == 0 or k <= 1:
        return valid
    from ..core.graph import expand_ranges

    o = np.asarray(offsets, dtype=np.int64)[1:]
    lo = np.maximum(o - (k - 1), 0)
    _, idx = expand_ranges(lo, np.minimum(o, total))
    valid[idx] = False
    return valid


def pad_to(x: np.ndarray, size: int, fill=0) -> np.ndarray:
    if x.shape[0] >= size:
        return x[:size]
    pad = np.full(size - x.shape[0], fill, dtype=x.dtype)
    return np.concatenate([x, pad])
