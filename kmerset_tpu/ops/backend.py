"""Backend selection: host NumPy vs device (GPU) for the counting path.

Policy: the device pipeline pays jax import + compile + transfer overhead,
so it only wins for large inputs.  The threshold is overridable via
KMERSET_TPU_MIN_DEVICE_WINDOWS; KMERSET_TPU_FORCE_BACKEND=host|device
forces a side (tests force host implicitly by running tiny inputs).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..utils.log import get_logger

_log = get_logger()

# Count of device-path attempts on the CPU backend that fell back to host
# with an exception (tests force device paths there and assert on it).
FALLBACK_COUNT = 0


def _note_fallback(where: str, e: Exception) -> None:
    """Called by every device entry point that caught `e`.  On an
    accelerator the failure is re-raised: a broken device path must not
    pass for a working, slow host run.  On the CPU backend (tests force
    device paths there) it is counted and logged, and the caller takes
    the host path."""
    import jax

    if jax.default_backend() != "cpu":
        e.add_note(f"device path {where} failed")
        raise e
    global FALLBACK_COUNT
    FALLBACK_COUNT += 1
    _log.debug("device path %s failed, falling back to host: %r", where, e)


# Offload crossovers (windows for the count, k-mers for the graph phase:
# fused side tables -> successor, ops/unitigs.py).  Not yet re-derived on
# the GPU.
DEFAULT_MIN_DEVICE_WINDOWS = 1 << 21
DEFAULT_MIN_DEVICE_GRAPH = 1 << 23
_GRAPH_SLOW_FACTOR = 64


def _env_int(name: str, default: int) -> int:
    """Env-var integer with a logged fallback (a malformed override must
    degrade to the default, not crash every gated call)."""
    v = os.environ.get(name, "")
    if not v:
        return default
    try:
        return int(v)
    except ValueError:
        _log.warning("ignoring malformed %s=%r (using %d)", name, v, default)
        return default


def _threshold() -> int:
    return _env_int("KMERSET_TPU_MIN_DEVICE_WINDOWS", DEFAULT_MIN_DEVICE_WINDOWS)


class _StageTimer:
    """Per-call stage timestamps, printed to stderr when
    KMERSET_TPU_TIMING is set (the dispatch-gap probe; zero cost when
    off).  Each tick records the wall time since the previous tick, so
    the printout is a contiguous accounting of the call."""

    __slots__ = ("t0", "prev", "items", "name")

    def __init__(self, name: str):
        import time as _time

        self.name = name
        self.t0 = self.prev = _time.perf_counter()
        self.items = []

    def tick(self, label: str) -> None:
        import time as _time

        now = _time.perf_counter()
        self.items.append((label, now - self.prev))
        self.prev = now

    def done(self) -> None:
        import sys as _sys
        import time as _time

        total = _time.perf_counter() - self.t0
        parts = " ".join(f"{l}={dt:.3f}" for l, dt in self.items)
        print(f"[timing] {self.name}: {parts} total={total:.3f}", file=_sys.stderr)


class _NullTimer:
    __slots__ = ()

    def tick(self, label: str) -> None:
        pass

    def done(self) -> None:
        pass


_NULL_TIMER = _NullTimer()


def _stage_timer(name: str):
    if os.environ.get("KMERSET_TPU_TIMING"):
        return _StageTimer(name)
    return _NULL_TIMER


def _graph_threshold() -> int:
    return _env_int("KMERSET_TPU_MIN_DEVICE_GRAPH", DEFAULT_MIN_DEVICE_GRAPH)


def _force() -> str:
    return os.environ.get("KMERSET_TPU_FORCE_BACKEND", "")


def _have_native() -> bool:
    """True when the C helper library is loadable (the slow-link side-code
    wire format depends on its succ rebuild, native kmerio_succ_from_sides)."""
    try:
        from ..core import native

        return native.get_lib() is not None
    except Exception:  # noqa: BLE001 - availability probe only
        return False


_SLOW_LINK_FACTOR = 64
_link_slow: Optional[bool] = None

# The checkout (or install prefix) holding the package: the default home
# of the compile cache (enable_compile_cache).
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def _slow_link() -> bool:
    """True when host<->device transfers run far below PCIe speed (e.g. a
    remote device).  Offload pipelines that round-trip data per byte of
    input only pay off on a fast link, so slow links scale every size
    threshold up by _SLOW_LINK_FACTOR.  Probed once per process (one
    ~8 MB round trip); override with KMERSET_TPU_LINK=fast|slow."""
    global _link_slow
    if _link_slow is None:
        env = os.environ.get("KMERSET_TPU_LINK", "")
        if env in ("fast", "slow"):
            _link_slow = env == "slow"
            return _link_slow
        if not _backend_alive():
            # No device backend: nothing to offload over.
            _link_slow = True
            return _link_slow
        try:
            import time

            import jax

            x = np.zeros(1 << 21, dtype=np.int32)  # 8 MB
            f = jax.jit(lambda a: a + 1)
            np.asarray(f(x))  # compile + warm
            t0 = time.perf_counter()
            np.asarray(f(x))
            dt = time.perf_counter() - t0
            bw = 2 * x.nbytes / max(dt, 1e-9)
            _link_slow = bw < (1 << 30)  # < 1 GB/s round trip
        except Exception:  # noqa: BLE001
            # Probe failure (device busy, flaky jit): slow for this
            # process, so no offload gate opens on a link it could not time.
            _link_slow = True
    return _link_slow


_backend_ready: Optional[bool] = None


def _accelerator_requested() -> bool:
    """True when this process is meant to run on an accelerator:
    JAX_PLATFORMS names one, or it is unset and JAX's CUDA plugin is
    installed."""
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats:
        return any(p.strip() not in ("", "cpu") for p in plats.split(","))
    try:
        import pkgutil

        import jax_plugins
    except ImportError:
        return False
    return any(
        m.name.startswith("xla_cuda") for m in pkgutil.iter_modules(jax_plugins.__path__)
    )


def _backend_alive() -> bool:
    """Initializes JAX's default backend once; True when it came up.  A
    process meant for an accelerator (_accelerator_requested) whose
    backend fails or comes up as the CPU raises instead: the host paths
    are no stand-in for a device that is missing or broken."""
    global _backend_ready
    if _backend_ready is None:
        import jax

        want = _accelerator_requested()
        try:
            platform = jax.default_backend()
        except Exception as e:  # noqa: BLE001 - re-raised when a device is expected
            if want:
                raise RuntimeError(
                    "an accelerator was requested but JAX's backend failed to start"
                ) from e
            _backend_ready = False
            return False
        if want and platform == "cpu":
            raise RuntimeError(
                "an accelerator was requested but JAX's backend is the CPU "
                "(set JAX_PLATFORMS=cpu to run on the host)"
            )
        _backend_ready = True
    return _backend_ready


def _cpu_backend() -> bool:
    """True when jax's default backend is the host CPU itself (or no
    backend came up — see _backend_alive).  The offload pipelines exist
    to use an accelerator; routed to XLA-CPU they lose to the
    native/NumPy host paths, paying an XLA-CPU recompile per size class.
    Tests that exercise the device code paths on CPU set
    KMERSET_TPU_FORCE_BACKEND=device, which bypasses this check."""
    if not _backend_alive():
        return True
    try:
        import jax

        return jax.default_backend() == "cpu"
    except Exception:  # noqa: BLE001 - no jax => no device either
        return True


# Single-card capacity ceiling for the one-shot counting program, and the
# per-shot window count of the out-of-core chunked path (at most half of
# it: two live chunks must fit where one maximal count did).  Inputs up to
# this ceiling use these values as they are; past it, on a device,
# size_device_windows() derives both from the card's memory.  Larger-than-
# card sets are the mesh backend's job (parallel/mesh.py).
MAX_DEVICE_WINDOWS = 1 << 29
CHUNK_WINDOWS = 1 << 28
# Sized (MAX, CHUNK) per count layout (its representative k), per process.
_sized_windows: dict = {}
# Windows of the count program compiled to read its memory footprint.
_PROBE_WINDOWS = 1 << 20
# Index arithmetic of the count program is int32.
_WINDOWS_CAP = 1 << 30


def count_bytes_per_window(k: int) -> float:
    """Device bytes the fused count program (count_kmers_frag) takes per
    window at k: arguments, outputs and temporaries from XLA's memory
    analysis of one compile at _PROBE_WINDOWS."""
    import jax

    from .count import count_kmers_frag

    n = _PROBE_WINDOWS
    L = n + k - 1
    packed = jax.ShapeDtypeStruct(((L + 3) // 4,), np.uint8)
    bounds = jax.ShapeDtypeStruct((4096,), np.int32)
    total = jax.ShapeDtypeStruct((), np.int64)
    m = (
        count_kmers_frag.lower(packed, bounds, total, L, k, True)
        .compile()
        .memory_analysis()
    )
    used = m.argument_size_in_bytes + m.output_size_in_bytes + m.temp_size_in_bytes
    return used / n


def _layout_ks(k: Optional[int]) -> Tuple[int, ...]:
    """Representative k of each count layout a count at k may use: the
    int32 single lane (k <= 15), the int32 (hi, lo) pair (k <= 23), the
    int64 lane; k = None means any k, sized by the two larger layouts."""
    from .count import PAIR_MAX_K, SINGLE_MAX_K

    if k is None:
        return (PAIR_MAX_K, 31)
    if k <= SINGLE_MAX_K:
        return (SINGLE_MAX_K,)
    return (PAIR_MAX_K,) if k <= PAIR_MAX_K else (31,)


def size_device_windows(
    n_windows: int = 0, k: Optional[int] = None
) -> Tuple[int, int]:
    """(one-shot ceiling, chunk windows) for a count of n_windows at k.
    Up to MAX_DEVICE_WINDOWS, and on the CPU backend or a device that
    reports no memory limit, the module values stand and nothing is
    probed.  Past it, on a device, both are sized from the card's
    memory_stats()["bytes_limit"]: 90% of the limit over the count
    program's bytes per window in k's layout, with room for up to 1.5x
    padding to a size class (good_sort_size); the chunk is the largest
    power of two at most half of that, so chunks need no padding.  That
    compiles the count program once per layout per process (a few
    seconds), so only inputs too big for the static ceiling pay it."""
    static = (MAX_DEVICE_WINDOWS, CHUNK_WINDOWS)
    if n_windows <= MAX_DEVICE_WINDOWS or _cpu_backend():
        return static
    ks = _layout_ks(k)
    if ks not in _sized_windows:
        import time

        import jax

        limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
        if not limit:
            _sized_windows[ks] = static
            return static
        t0 = time.perf_counter()
        per_window = max(count_bytes_per_window(kk) for kk in ks)
        one_shot = min(int(0.9 * limit / (1.5 * per_window)), _WINDOWS_CAP)
        chunk = 1 << ((one_shot // 2).bit_length() - 1)
        _sized_windows[ks] = (one_shot, chunk)
        _log.info(
            "device windows for k in %s: one-shot %d, chunk %d "
            "(bytes_limit %d, sized in %.3f s)",
            ks, one_shot, chunk, limit, time.perf_counter() - t0,
        )
    return _sized_windows[ks]


def should_use_device_chunked(n_windows: int, k: Optional[int] = None) -> bool:
    """Out-of-core single-chip counting: inputs past the one-shot sort
    ceiling are counted in CHUNK_WINDOWS slices and merged on the host.
    Only worth it off the mesh path (a second device would take it), on a
    non-slow link (the codes stream crosses the link once per chunk)."""
    force = _force()
    if force == "host":
        return False
    if n_windows <= size_device_windows(n_windows, k)[0]:
        return False  # the one-shot path owns this range
    if force == "device":
        return True
    if _cpu_backend():
        return False
    return not _slow_link()


def should_use_device(
    n_windows: int, spss_ahead: bool = False,
    k: int | None = None, canonical: bool = True,
) -> bool:
    """`spss_ahead` marks a count whose result feeds an SPSS build in the
    same process (kmerset-build, KmerSetCompact round trips): the count
    then leaves a device-resident handle (ops/resident.py) that lets the
    graph phase skip its upload AND replaces the host side-table cost —
    so on a slow link the gate opens at the graph threshold (~8M) instead
    of the counting slow-link factor (~128M), amortizing the link over
    both phases.

    When `k` is given, the slow-link spss_ahead arm additionally
    requires the key download to have a compact wire format for the
    worst-case key count (every window unique): for sparse keyspaces
    (k = 19/23) the delta plan rejects and the download would be the
    raw 8 B/key, which on a slow link costs more than the host count.
    Small inputs pass regardless (raw is cheap there)."""
    force = _force()
    if force == "host":
        return False
    if force == "device":
        # Even forced, respect the one-shot count's memory ceiling —
        # mirrors should_use_device_graph's forced cap; oversize inputs
        # go to the chunked/mesh paths.
        return n_windows <= size_device_windows(n_windows, k)[0]
    if n_windows < _threshold() or _cpu_backend():
        return False
    if n_windows > size_device_windows(n_windows, k)[0]:
        return False
    if not _slow_link() or n_windows >= _threshold() * _SLOW_LINK_FACTOR:
        return True
    if not (spss_ahead and n_windows >= _graph_threshold()):
        return False
    if k is not None and n_windows * 8 > (32 << 20):
        from .deltas import plan_escape

        if plan_escape(n_windows, k, canonical) is None:
            # Raw-download wire would eat the offload win.  This is the
            # worst-case (every window unique) model: a high-coverage
            # input whose real key count is far below n_windows loses
            # the offload here — conservative by design, and logged so
            # the refusal is not silent.
            _log.debug(
                "slow-link count gate closed for k=%d at %d windows: "
                "no compact key wire format at worst-case density",
                k, n_windows,
            )
            return False
    return True


# Upper cap for the graph-side joins: lookup_join32/lookup_join_pair
# (ops/join.py) pack slots and found-flags into int32 bits [0, 30), and
# the side-table path issues m = 8 * padded_n queries — so padded_n must
# stay well under 2^27.  Mirrors MAX_DEVICE_WINDOWS for the count path.
MAX_DEVICE_GRAPH_KMERS = 1 << 26


def should_use_device_graph(n_kmers: int, resident: bool = False) -> bool:
    """`resident=True` means the sorted set is already ON the device
    (a DeviceKmers handle from the count phase, ops/resident.py): the
    upload leg — the reason the slow-link factor existed — is gone, so
    the gate opens at the base threshold even on a slow link.  The
    succ/terminal download (~11 B/k-mer) remains, but so does the host
    side-table cost it displaces."""
    force = _force()
    if force == "host":
        return False
    if force == "device":
        return n_kmers <= MAX_DEVICE_GRAPH_KMERS
    if n_kmers < _graph_threshold() or n_kmers > MAX_DEVICE_GRAPH_KMERS:
        return False
    if _cpu_backend():
        return False
    if resident:
        return True
    return not _slow_link() or n_kmers >= _graph_threshold() * _GRAPH_SLOW_FACTOR


def enable_compile_cache() -> None:
    """Persistent XLA compilation cache, so repeated CLI runs skip
    recompiles.  When JAX_COMPILATION_CACHE_DIR is set, JAX reads it
    itself and no directory is set here; otherwise the cache is
    <repo>/.jax_cache, one fixed path (the path is part of what a later
    process must find again).  An installed (non-editable) package would
    put that under site-packages: set JAX_COMPILATION_CACHE_DIR there."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update(
            "jax_compilation_cache_dir", os.path.join(_REPO_ROOT, ".jax_cache")
        )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def _staged_windows_u8(codes: np.ndarray, offsets: np.ndarray, k: int):
    """Slim staging for the frag-validity count entries: 2-bit packed
    codes (0.25 B/base up the link) + the pow2-padded int32 boundary
    array + the unpadded length + the static unpacked code count
    (count_kmers_frag unpacks and computes the window-validity mask on
    device).  Returns (packed, bounds_i32, total, L) or None for inputs
    under one window."""
    from .count import good_sort_size

    total = codes.shape[0]
    if total < k:
        return None
    n_keys = total - (k - 1)
    target = good_sort_size(n_keys)
    codes = codes.astype(np.uint8, copy=False)
    if target != n_keys:
        codes = np.concatenate(
            [codes, np.zeros(target - n_keys, np.uint8)]
        )
    bounds = np.asarray(offsets, dtype=np.int64)[1:]
    # Floor the pad class at 4096: the boundary count is a second jit
    # compilation dimension, and one class covering every input up to
    # 4096 fragments (16 KB of upload) avoids a fresh multi-second
    # compile of the fused count pipeline per fragment-count pow2 class.
    bp = 1 << max(12, int(bounds.shape[0] - 1).bit_length())
    if bp > bounds.shape[0]:
        bounds = np.concatenate(
            [bounds, np.full(bp - bounds.shape[0], total, np.int64)]
        )
    from ..core import native

    return (
        native.pack2(np.ascontiguousarray(codes)),
        bounds.astype(np.int32),
        total,
        codes.shape[0],
    )


def device_unique(
    codes: np.ndarray, offsets: np.ndarray, k: int, canonical: bool
) -> Optional[np.ndarray]:
    """Sorted distinct (canonical) k-mers of the fragment stream on the
    accelerator — the decode direction (GetKmerSetFromSPSS, reference:
    lib/core/spss.h:1862-1941) runs the counting pipeline at cutoff 1 and
    skips count materialization entirely."""
    try:
        from .count import count_to_set_frag  # noqa: F401 - import probe
    except Exception:  # noqa: BLE001
        return None
    try:
        # Same dispatch/trim pair the chunked path drives — one
        # implementation of the staging and slicing, not two.
        t = _unique_dispatch(codes, offsets, k, canonical)
        if t is None:
            return None
        return _unique_fetch(t)
    except Exception as e:  # noqa: BLE001
        _note_fallback("device_unique", e)
        return None


def _merge_count_pair(ak, ac, bk, bc):
    """One merge of two sorted-unique (keys, counts) runs, summing counts
    of shared keys (native one-pass merge; numpy stable-sort fallback)."""
    from ..core import native

    m = native.merge_counts(ak, ac, bk, bc)
    if m is None:
        keys = np.concatenate([ak, bk])
        cnts = np.concatenate([ac, bc])
        if keys.size == 0:
            return keys, cnts
        order = np.argsort(keys, kind="stable")
        keys, cnts = keys[order], cnts[order]
        boundary = np.empty(keys.shape[0], dtype=bool)
        boundary[0] = True
        np.not_equal(keys[1:], keys[:-1], out=boundary[1:])
        idx = np.flatnonzero(boundary)
        m = keys[idx], np.add.reduceat(cnts, idx)
    return m


def _merge_key_pair(ak, bk):
    """Keys-only sorted-union merge (kmerio_merge_counts' NULL-count
    mode; np.union1d fallback)."""
    from ..core import native

    m = native.merge_keys(ak, bk)
    if m is None:
        m = np.union1d(ak, bk)
    return m


def _merge_cascade(parts: list, merge_pair):
    """Balanced pairwise merge of sorted runs down to one."""
    while len(parts) > 1:
        nxt = []
        for i in range(0, len(parts) - 1, 2):
            a, b = parts[i], parts[i + 1]
            if isinstance(a, tuple):
                nxt.append(merge_pair(a[0], a[1], b[0], b[1]))
            else:
                nxt.append(merge_pair(a, b))
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def _merge_count_runs(parts: list) -> Tuple[np.ndarray, np.ndarray]:
    return _merge_cascade(parts, _merge_count_pair)


def _chunk_slices(codes: np.ndarray, offsets: np.ndarray, k: int):
    """Yields (codes_slice, offsets_slice) per CHUNK_WINDOWS-window chunk,
    each with a k-1 code halo (the mesh shard-layout boundary treatment,
    parallel/driver._shard_layout): windows starting in [lo, hi) see
    their true fragment cover, so per-chunk validity equals the global
    one.  Fragment boundaries are located with searchsorted on the
    already-sorted offsets instead of clipping the whole array."""
    n_windows = codes.shape[0] - (k - 1)
    chunk = size_device_windows(n_windows, k)[1]
    lo = 0
    while lo < n_windows:
        hi = min(lo + chunk, n_windows)
        hi_code = hi + k - 1
        a = np.searchsorted(offsets, lo, side="right")
        b = np.searchsorted(offsets, hi_code, side="left")
        offs_c = np.unique(
            np.concatenate([[0], offsets[a:b] - lo, [hi_code - lo]])
        )
        yield codes[lo:hi_code], offs_c
        lo = hi


def _count_dispatch(codes, offsets, k, canonical):
    """Stages one chunk and launches the fused count program WITHOUT
    blocking (jax dispatch is async): returns opaque device handles for
    _count_fetch, or None for empty inputs."""
    from .count import count_kmers_frag

    staged = _staged_windows_u8(codes, offsets, k)
    if staged is None:
        return None
    packed, bounds, total, L = staged
    return count_kmers_frag(packed, bounds, total, L, k, canonical)


def _count_fetch(t) -> Tuple[np.ndarray, np.ndarray]:
    uniq, counts, n_unique = t
    n = int(n_unique)
    return np.asarray(uniq[:n]), np.asarray(counts[:n], dtype=np.int64)


def _unique_dispatch(codes, offsets, k, canonical):
    from .count import count_to_set_frag

    staged = _staged_windows_u8(codes, offsets, k)
    if staged is None:
        return None
    packed, bounds, total, L = staged
    uniq, n_kept, _ = count_to_set_frag(packed, bounds, total, L, k, canonical, 1)
    return uniq, n_kept


def _unique_fetch(t) -> np.ndarray:
    uniq, n_kept = t
    return np.asarray(uniq[: int(n_kept)])


def _device_chunked(codes, offsets, k, canonical, dispatch, fetch,
                    merge_pair, tag):
    """Shared driver of the out-of-core chunked paths: runs the fused
    one-shot program per halo chunk and combines the sorted per-chunk
    results with a balanced cascade of merge_pair calls.  Replaces the
    reference's shared-memory bucket merge
    (lib/core/kmer_counter.h:105-126) at out-of-core scale.

    Double-buffered: chunk i+1 is staged and DISPATCHED (async) before
    chunk i's results are downloaded, so the chip sorts one chunk while
    the link carries the previous one's outputs — CHUNK_WINDOWS is at
    most half the one-shot ceiling precisely so two chunks' working sets
    fit in device memory together."""
    try:
        if codes.shape[0] - (k - 1) <= 0:
            return None
        parts = []
        pending = None
        for codes_c, offs_c in _chunk_slices(codes, offsets, k):
            cur = dispatch(codes_c, offs_c, k, canonical)
            if cur is None:
                return None
            if pending is not None:
                parts.append(fetch(pending))
            pending = cur
        if pending is not None:
            parts.append(fetch(pending))
        if not parts:
            return None
        return _merge_cascade(parts, merge_pair)
    except Exception as e:  # noqa: BLE001
        _note_fallback(tag, e)
        return None


def device_count_chunked(
    codes: np.ndarray, offsets: np.ndarray, k: int, canonical: bool
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Out-of-core single-chip counting: CHUNK_WINDOWS-window halo chunks
    through the fused one-shot pipeline, merged on the host — so a lone
    chip keeps its full counting throughput on inputs its HBM cannot
    hold in one sort."""
    return _device_chunked(
        codes, offsets, k, canonical,
        _count_dispatch, _count_fetch,
        _merge_count_pair, "device_count_chunked",
    )


def device_unique_chunked(
    codes: np.ndarray, offsets: np.ndarray, k: int, canonical: bool
) -> Optional[np.ndarray]:
    """Out-of-core decode direction: halo chunks through the cutoff-1
    unique pipeline, combined by keys-only sorted-union merges."""
    return _device_chunked(
        codes, offsets, k, canonical,
        _unique_dispatch, _unique_fetch,
        _merge_key_pair, "device_unique_chunked",
    )


DELTA_MIN_KEYS = 1 << 20


def device_count(
    codes: np.ndarray, offsets: np.ndarray, k: int, canonical: bool,
    resident: bool = False, value_max: int = 0, spss_ahead: bool = False,
    lazy_counts: bool = False,
) -> Optional[Tuple]:
    """Counts k-mers on the accelerator; returns (uniq, counts) — plus a
    DeviceKmers handle (or None) as a third element when `resident` is
    asked — or None if the device path is unavailable (caller falls back
    to host).  The handle keeps the sorted unique array ON the device so
    the graph phase skips its re-upload (ops/resident.py).

    `value_max > 0` saturates counts ON the device before the download
    (the host stores min(count, value_max) anyway — reference AddWithMax,
    lib/core/kmer_counter.h:28-38); with the uint8 default that shrinks
    the counts transfer 8x and the k <= 15 int32 uniq conversion halves
    the key transfer.  Chunked/merge callers pass value_max=0: partial
    counts must stay raw or cross-chunk sums would saturate early."""
    try:
        from .count import count_kmers_frag
    except Exception:  # noqa: BLE001 - any jax failure => host fallback
        return None
    tm = _stage_timer("device_count")
    try:
        staged = _staged_windows_u8(codes, offsets, k)
        if staged is None:
            return None
        packed, bounds, total, L = staged
        tm.tick("stage")
        uniq, counts, n_unique = count_kmers_frag(
            packed, bounds, total, L, k, canonical
        )
        tm.tick("dispatch")
        n = int(n_unique)
        tm.tick("sync_n")
        # Gap-encoded key download (1-2 B/k-mer instead of 4-8,
        # ops/deltas.py): the encode is DISPATCHED before any other
        # device work so the wire arrays exist early and their DMA can
        # overlap the side-code prefetch's compute — queued after it,
        # the fetch would wait out that whole jit first.
        delta_pending = None
        # Size first: small counts must not trigger the 8 MB link probe
        # (and its disk-cache write) for a branch already known dead.
        if n >= DELTA_MIN_KEYS and _slow_link():
            from .deltas import dispatch_delta, fetch_delta

            delta_pending = dispatch_delta(uniq, n, k, canonical)
            tm.tick("delta_dispatch")
        handle = None
        if resident:
            # Dispatch the resident shrink BEFORE the blocking downloads
            # so the device-to-device copy overlaps the link transfer.
            from .resident import DeviceKmers

            handle = DeviceKmers.from_count_outputs(
                uniq, counts, n, k, canonical
            )
            tm.tick("shrink_dispatch")
            if (
                handle is not None
                and spss_ahead
                # Mirror should_use_device_graph's bounds: below the
                # graph threshold the SPSS phase will route host-side
                # and the prefetched side-code jit (a multi-second cold
                # compile), its compute, and its download would all be
                # discarded.
                and _graph_threshold() <= n <= MAX_DEVICE_GRAPH_KMERS
                and _slow_link()
                and _have_native()
            ):
                # A build follows on a slow link: the graph phase will
                # consume side codes (the 1-byte wire format needs the
                # native succ rebuild) — dispatch their jit now so its
                # device compute overlaps the key download below.
                handle.prefetch_sides()
                tm.tick("sides_dispatch")
        uniq_h = None
        if delta_pending is not None:
            uniq_h = fetch_delta(delta_pending, n)
            tm.tick("delta_fetch")
        if uniq_h is None:
            uniq_n = uniq[:n]
            if value_max and k <= 15:
                # 2k <= 30-bit keys: convert on-device, download 4 B/key.
                uniq_n = uniq_n.astype(np.int32)
            uniq_h = np.asarray(uniq_n).astype(np.int64, copy=False)
            tm.tick("raw_fetch")
        def _trim_counts():
            counts_n = counts[:n]
            if value_max:
                import jax.numpy as jnp

                counts_n = jnp.minimum(counts_n, value_max)
                if value_max <= 255:
                    counts_n = counts_n.astype(np.uint8)
            return counts_n

        if lazy_counts:
            # The build flow (cutoff <= 1) never reads counts: defer the
            # transfer behind a closure the counter materializes on first
            # host access (KmerCounter.counts).  The trim itself is
            # dispatched NOW (async) so only the saturated uint8 array
            # (1 B/key) stays pinned in HBM through the graph phase, not
            # the padded int32 count buffer.
            trimmed = _trim_counts()

            def counts_h():
                return np.asarray(trimmed).astype(np.int64, copy=False)
        else:
            counts_h = np.asarray(_trim_counts()).astype(np.int64, copy=False)
        tm.tick("counts")
        if not resident:
            tm.done()
            return uniq_h, counts_h
        if handle is not None:
            handle = handle.with_endpoints(uniq_h)
            if handle is not None:
                # The blocking downloads above are done — let the
                # prefetched side codes cross the now-idle link while
                # the host works toward the SPSS phase.
                handle.start_sides_download()
        tm.tick("endpoints")
        tm.done()
        return uniq_h, counts_h, handle
    except Exception as e:  # noqa: BLE001
        _note_fallback("device_count", e)
        return None
