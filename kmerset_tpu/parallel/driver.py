"""Production multi-device counting driver.

Routes `KmerCounter` construction onto a device mesh when one is
available: shards the input code stream across devices (with k-1 halos so
no window is lost at shard boundaries — unlike the reference, whose
shared-memory merge never faces the problem, lib/core/kmer_counter.h:105-126),
runs the radix-exchange counting step (`parallel.mesh.sharded_count_fn`),
and retries with doubled exchange capacity whenever key skew overflows a
(src, dst) lane — the `dropped` counter exists exactly for this loop.

Single-process: plain numpy in, numpy out (jit scatters to local devices).
Multi-process (`jax.distributed`): every process holds the same input
stream (each CLI process reads the same file), feeds its addressable
shards via `make_array_from_process_local_data`, and the compacted
results are gathered back with `multihost_utils.process_allgather`.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np

from ..utils.log import get_logger

_log = get_logger()


def _mesh_env_capacity() -> Optional[int]:
    """A malformed override degrades to the default with a warning (same
    contract as ops/backend._env_int) — raising here would be swallowed
    by the mesh routers' blanket fallbacks and silently disable the
    whole mesh backend."""
    v = os.environ.get("KMERSET_TPU_MESH_CAPACITY", "")
    if not v:
        return None
    try:
        cap = int(v)
        if cap <= 0:
            raise ValueError("capacity must be positive")
        return cap
    except ValueError:
        _log.warning(
            "ignoring malformed KMERSET_TPU_MESH_CAPACITY=%r (using defaults)", v
        )
        return None


def _pad_stride(n_dev: int, arr: np.ndarray, fill, dtype) -> np.ndarray:
    """Pads a length-n array to the device-strided layout (cap * n_dev,
    cap = ceil(n / n_dev)), fill value in the tail — the staging step
    every mesh router shares."""
    n = arr.shape[0]
    cap = math.ceil(n / n_dev)
    out = np.full(cap * n_dev, fill, dtype=dtype)
    out[:n] = arr
    return out


def _led_chain_selection(
    end: np.ndarray, is_chain: np.ndarray, starts: np.ndarray, n: int
) -> np.ndarray:
    """Node mask of the chains led by `starts` (parity-critical: decides
    which chains the grouped/emit paths produce — one definition, shared
    by mesh_chain_group and mesh_emit_chains)."""
    keep_end = np.zeros(n, dtype=bool)
    keep_end[end[starts]] = True
    return is_chain & keep_end[end]


def _mesh_available() -> Optional[bool]:
    """Shared transport/topology gate of the mesh routers: True = forced
    on, False = forced off or unusable, None = usable (size gates
    decide)."""
    from ..ops import backend

    force = os.environ.get("KMERSET_TPU_FORCE_BACKEND", "")
    if force == "mesh":
        return True
    if force in ("host", "device"):
        return False
    if not backend._backend_alive():
        return False  # dead/hung device transport (see ops/backend.py)
    try:
        import jax

        if len(jax.devices()) < 2:
            return False
    except Exception:  # noqa: BLE001 - no jax => no mesh
        return False
    if backend._cpu_backend():
        return False  # virtual CPU meshes are for tests, not production
    return None


def should_use_mesh(n_windows: int) -> bool:
    """Mesh counting pays a full all_to_all; it wins when there is more
    than one device and the input is big enough (or too big for one chip,
    ops/backend.MAX_DEVICE_WINDOWS)."""
    from ..ops import backend

    avail = _mesh_available()
    if avail is not None:
        return avail
    if backend._slow_link():
        # Counting's OUTPUT dominates a slow link: codes go up at
        # 1 byte/window but (uniq, counts) come back at ~16 — at any
        # size the gather alone exceeds the host's whole count time
        # (should_use_device_chunked refuses the same class for the
        # same reason).  Only the forced mode routes here.
        return False
    if n_windows > backend.MAX_DEVICE_WINDOWS:
        return True  # too big for the one-shot single-card count
    return n_windows >= backend._threshold()


def should_use_mesh_graph(n_nodes: int) -> bool:
    """Mesh gate for the graph phases (side tables, successor assembly,
    pointer doubling, chain grouping/emission, matching, overlap edges):
    same transport/topology checks as `should_use_mesh`, sized by the
    graph-offload crossover (ops/backend._graph_threshold, ~8M nodes —
    graph exchanges carry several lanes per node and lose to the
    host/native path well past the counting crossover at 2^21).  No
    unconditional big-input route: the host graph path is complete at
    any size, so an oversized input on a slow link stays host-bound."""
    from ..ops import backend

    avail = _mesh_available()
    if avail is not None:
        return avail
    if n_nodes < backend._graph_threshold():
        return False
    return not backend._slow_link() or n_nodes >= (
        backend._graph_threshold() * backend._GRAPH_SLOW_FACTOR
    )


def _shard_layout(n_windows: int, n_dev: int, k: int):
    """Per-device window count W (sort-friendly) and code length Lh with
    the k-1 halo; device d covers global window starts [d*W, (d+1)*W)."""
    from ..ops.count import good_sort_size

    W = good_sort_size(max(1, math.ceil(n_windows / n_dev)))
    return W, W + k - 1


def _initial_capacity(W: int, n_dev: int) -> int:
    env = _mesh_env_capacity()
    if env:
        return env
    # Expected (src, dst) load is W / n_dev for uniform keys; 2x headroom
    # rounded to a power of two keeps the exchange + recv sort on XLA's
    # fast sizes (n_dev is a power of two on real meshes).
    target = max(1024, 2 * W // n_dev)
    return 1 << (target - 1).bit_length()


def mesh_count(
    codes: np.ndarray,
    offsets: np.ndarray,
    k: int,
    canonical: bool,
    mesh=None,
    need_counts: bool = True,
) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Counts k-mers across the device mesh; returns (uniq, counts) or
    None when unavailable (caller falls back to single-device/host).
    need_counts=False skips the counts gather — the decode direction
    only wants the distinct keys, and counts are ~8 bytes/window of
    host<->device (and in multi-process mode cross-host) traffic."""
    try:
        import jax

        from ..ops.count import window_validity
        from .mesh import make_mesh, sharded_count_fn
    except Exception:  # noqa: BLE001
        return None
    try:
        total = codes.shape[0]
        n_windows = total - (k - 1)
        if n_windows <= 0:
            return None
        if mesh is None:
            mesh = make_mesh()
        n_dev = int(mesh.devices.size)
        if n_dev < 1:
            return None
        valid = window_validity(offsets, total, k)
        W, Lh = _shard_layout(n_windows, n_dev, k)

        # Stage in the input's own dtype (uint8 from the FASTA parser):
        # the kernel widens on-device, and an int32 host copy would 4x
        # the staging memory of exactly the over-one-chip inputs this
        # path exists for.
        codes_sh = np.zeros((n_dev, Lh), dtype=codes.dtype)
        valid_sh = np.zeros((n_dev, Lh), dtype=bool)
        for d in range(n_dev):
            lo = d * W
            span = min(max(total - lo, 0), Lh)
            if span > 0:
                codes_sh[d, :span] = codes[lo : lo + span]
            vspan = min(max(n_windows - lo, 0), W)
            if vspan > 0:
                valid_sh[d, :vspan] = valid[lo : lo + vspan]
        codes_flat = codes_sh.reshape(-1)
        valid_flat = valid_sh.reshape(-1)

        codes_in = _stride_global(mesh, codes_flat)
        valid_in = _stride_global(mesh, valid_flat)

        capacity = _initial_capacity(W, n_dev)
        # 32 attempts (like the sibling loops): heavy key skew on large
        # meshes — or a small capacity override — can need far more than
        # the 8 doublings this loop once allowed before reaching the
        # guaranteed-success capacity W.
        for _attempt in range(32):
            fn = sharded_count_fn(mesh, k, canonical, capacity)
            uniq, counts, n_unique, tot, dropped = fn(codes_in, valid_in)
            n_dropped = int(np.asarray(jax.device_get(dropped))[0])
            if n_dropped == 0:
                break
            # Key skew overflowed a (src, dst) lane; the step dropped
            # k-mers, so the result is unusable — double and re-run.
            # capacity == W cannot drop (a src holds at most W windows).
            if capacity >= W:  # pragma: no cover - defensive
                return None
            _log.info(
                "mesh exchange overflow (dropped = %d, capacity = %d); retrying",
                n_dropped,
                capacity,
            )
            capacity = min(2 * capacity, W)
        else:
            return None

        m = n_dev * capacity  # per-device output width
        uniq = _gather_global(uniq, np.int64).reshape(n_dev, m)
        n_unique = _gather_global(n_unique, np.int64).reshape(n_dev)
        parts_k = [uniq[d, : n_unique[d]] for d in range(n_dev)]
        # Device d owns key range d: concatenation is globally sorted.
        out_k = np.concatenate(parts_k).astype(np.int64)
        if not need_counts:
            return out_k, None
        counts = _gather_global(counts, np.int64).reshape(n_dev, m)
        parts_c = [counts[d, : n_unique[d]] for d in range(n_dev)]
        out_c = np.concatenate(parts_c).astype(np.int64)
        return out_k, out_c
    except Exception as e:  # noqa: BLE001 - mesh path is best-effort
        from ..ops.backend import _note_fallback

        _note_fallback("mesh_count", e)
        return None


def mesh_unitig_succ(A: np.ndarray, k: int, mesh=None):
    """Mesh front-end of canonical unitig construction: key-range shards
    A, runs sharded side tables + mate exchange + successor assembly
    (parallel/mesh.sharded_unitig_succ_fn), retries on exchange overflow,
    and assembles the host-layout (succ, term_l, term_r, both) arrays the
    chain walk consumes.  Returns None when unavailable."""
    try:
        import jax  # noqa: F401

        from .mesh import _S_SENT, SENTINEL, _owner_edges, make_mesh
        from .mesh import sharded_unitig_succ_fn
    except Exception:  # noqa: BLE001
        return None
    try:
        n = A.shape[0]
        if n == 0 or n >= (1 << 30):  # dense ids pack under the found bit
            return None
        if mesh is None:
            mesh = make_mesh()
        n_dev = int(mesh.devices.size)
        # Same narrow/sentinel choice as the kernel's _side_tables_core
        # (a literal 15 here could silently diverge from the kernel's
        # padding convention if the constant ever moves).
        from ..ops.count import SINGLE_MAX_K

        narrow = k <= SINGLE_MAX_K
        sent = int(_S_SENT) if narrow else int(SENTINEL)
        dt = np.int32 if narrow else np.int64
        edges = _owner_edges(k, n_dev)
        # A is sorted (the function's output alignment relies on
        # concat(parts) == A), so the owner slices are two binary
        # searches — not n_dev full boolean scans of an 8M+ array.
        idx = np.searchsorted(A, edges)
        parts = [A[idx[d] : idx[d + 1]] for d in range(n_dev)]
        biggest = max(max(p.shape[0] for p in parts), 2)
        cap = 1 << (2 * biggest - 1).bit_length()
        blocks = np.full((n_dev, cap), sent, dtype=dt)
        for d, p in enumerate(parts):
            blocks[d, : p.shape[0]] = p

        blocks_in = _stride_global(mesh, blocks.reshape(-1))

        qcap = _mesh_env_capacity() or (
            1 << (max(1024, 16 * cap // n_dev) - 1).bit_length()
        )
        # 8 * cap lanes can never overflow (a device holds at most
        # 8 * cap queries total), so the doubling always terminates.
        qcap_max = 8 * cap
        for _attempt in range(32):
            fn = sharded_unitig_succ_fn(mesh, k, qcap)
            succ_r, succ_l, term_l, term_r, both, total, dropped = fn(
                blocks_in
            )
            n_dropped = int(np.asarray(jax.device_get(dropped))[0])
            if n_dropped == 0:
                break
            if qcap >= qcap_max:  # pragma: no cover - defensive ceiling
                return None
            _log.info(
                "mesh unitig exchange overflow (dropped = %d, qcap = %d); retrying",
                n_dropped,
                qcap,
            )
            qcap = min(2 * qcap, qcap_max)
        else:  # pragma: no cover - unreachable with the ceiling
            return None
        if int(np.asarray(jax.device_get(total))[0]) != n:
            return None  # shard assembly mismatch; fall back

        def collect(x, dtype):
            x = _gather_global(x, np.int64).reshape(n_dev, cap)
            return np.concatenate(
                [x[d, : parts[d].shape[0]] for d in range(n_dev)]
            ).astype(dtype)

        succ = np.empty(2 * n, dtype=np.int64)
        succ[0::2] = collect(succ_r, np.int64)
        succ[1::2] = collect(succ_l, np.int64)
        return (
            succ,
            collect(term_l, bool),
            collect(term_r, bool),
            collect(both, bool),
        )
    except Exception as e:  # noqa: BLE001
        from ..ops.backend import _note_fallback

        _note_fallback("mesh_unitig_succ", e)
        return None


def _stride_global(mesh, blocks_flat: np.ndarray):
    """Feeds a host-replicated stride-layout array to a shard_map input:
    pass-through single-process; in multi-process mode wraps the
    process's addressable slice as one global array (every process holds
    the same host copy, matching the CLI convention of driver.py)."""
    import jax

    if jax.process_count() <= 1:
        return blocks_flat
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .mesh import AXIS

    n_dev = int(mesh.devices.size)
    cap = blocks_flat.shape[0] // n_dev
    sharding = NamedSharding(mesh, P(AXIS))
    # This process's devices may occupy any positions in the mesh order
    # (e.g. a KMERSET_TPU_MESH_DEVICES-truncated mesh can take 4 devices
    # from process 0 and 2 from process 1), and they need not even be
    # contiguous — slice by actual mesh position, not process_index
    # arithmetic.
    local_pos = [
        i for i, d in enumerate(mesh.devices.flat)
        if d.process_index == jax.process_index()
    ]
    local = np.concatenate(
        [blocks_flat[p * cap : (p + 1) * cap] for p in local_pos]
    )
    return jax.make_array_from_process_local_data(
        sharding, local, (n_dev * cap,)
    )


def _gather_global(arr, dtype=np.int64) -> np.ndarray:
    """Materializes a (possibly process-spanning) sharded array on every
    host: addressable shards fill a zero buffer, allgather-sum merges
    (each index is addressed by exactly one process, the rest contribute
    zero)."""
    import jax

    if jax.process_count() <= 1:
        return np.asarray(jax.device_get(arr)).astype(dtype)
    from jax.experimental import multihost_utils

    buf = np.zeros(arr.shape, dtype=dtype)
    for sh in arr.addressable_shards:
        buf[sh.index] = np.asarray(sh.data, dtype=dtype)
    return multihost_utils.process_allgather(buf).sum(axis=0).astype(dtype)


def mesh_pointer_double(succ: np.ndarray, labels: np.ndarray | None = None, mesh=None):
    """Distributed chain/cycle resolution (mesh.sharded_pointer_double_fn)
    with the host calling convention of core.graph.pointer_double:
    pads succ to a device-strided layout (appended padding nodes are
    self-terminating, original ids unchanged), runs the owner-routed
    doubling rounds, and trims.  Returns (end, dist, is_chain, min_label)
    or None when unavailable."""
    try:
        from .mesh import make_mesh, sharded_pointer_double_fn
    except Exception:  # noqa: BLE001
        return None
    try:
        n = succ.shape[0]
        if n == 0 or n >= (1 << 30):
            return None
        if mesh is None:
            mesh = make_mesh()
        n_dev = int(mesh.devices.size)
        N = math.ceil(n / n_dev) * n_dev
        sp = _pad_stride(n_dev, succ.astype(np.int32), -1, np.int32)
        lp = _pad_stride(
            n_dev,
            (
                labels.astype(np.int32)
                if labels is not None
                # int32 from the start: a bare np.zeros(n) is float64 —
                # 8 GB transient at the 2^30 scales this path targets,
                # feeding a lane the kernel ignores without labels.
                else np.zeros(n, np.int32)
            ),
            0,
            np.int32,
        )
        rounds = max(1, int(np.ceil(np.log2(max(N, 2)))) + 1)
        fn = sharded_pointer_double_fn(mesh, rounds, labels is not None)
        end, dist, is_chain, mlab = fn(
            _stride_global(mesh, sp), _stride_global(mesh, lp)
        )
        return (
            _gather_global(end)[:n],
            _gather_global(dist)[:n],
            _gather_global(is_chain, np.int64)[:n] != 0,
            _gather_global(mlab)[:n] if labels is not None else None,
        )
    except Exception as e:  # noqa: BLE001
        from ..ops.backend import _note_fallback

        _note_fallback("mesh_pointer_double", e)
        return None


def maybe_init_distributed() -> None:
    """Env-gated multi-host bring-up for the CLI layer.

    KMERSET_TPU_DISTRIBUTED=auto  -> jax.distributed.initialize() with
                                     JAX's own cluster detection
    KMERSET_TPU_DISTRIBUTED=addr:port,N,i -> explicit coordinator spec
    unset/empty                   -> no-op (single host)

    With the explicit spec on a GPU host each process must own only its
    card, or every process reserves memory on every card: unless the
    launcher already restricted it (CUDA_VISIBLE_DEVICES or
    JAX_LOCAL_DEVICE_IDS), process i takes local device i.
    """
    spec = os.environ.get("KMERSET_TPU_DISTRIBUTED", "")
    if not spec:
        return
    import jax

    if spec in ("1", "auto"):
        jax.distributed.initialize()
    else:
        try:
            addr, n, pid = spec.split(",")
            n_i, pid_i = int(n), int(pid)
        except ValueError as e:
            raise ValueError(
                "malformed KMERSET_TPU_DISTRIBUTED=%r: expected "
                "'auto' or 'addr:port,num_processes,process_id'" % spec
            ) from e
        from ..ops.backend import _accelerator_requested

        kw = {}
        if _accelerator_requested() and not (
            os.environ.get("CUDA_VISIBLE_DEVICES")
            or os.environ.get("JAX_LOCAL_DEVICE_IDS")
        ):
            kw["local_device_ids"] = [pid_i]
        jax.distributed.initialize(addr, n_i, pid_i, **kw)
    _log.info(
        "jax.distributed: process %d / %d", jax.process_index(), jax.process_count()
    )


def mesh_chain_group(succ: np.ndarray, starts: np.ndarray, mesh=None, pd=None):
    """Distributed chain grouping with the host calling convention of
    core.spss._chains_grouped / native.chain_walk: groups the nodes of
    the chains led by `starts` contiguously in (chain, position) order,
    one group per start, concatenated in `starts` order.

    Pipeline: distributed pointer doubling resolves (end, dist) per node
    (mesh.sharded_pointer_double_fn), then one owner-routed exchange
    groups records by end id and orders them start->end
    (mesh.sharded_chain_group_fn).  The host only slices boundaries and
    permutes whole groups — no per-node pointer chase anywhere.

    Multi-process aware (every process holds the same host arrays, as
    in the CLI convention); returns None when unavailable so callers
    fall back to the native walk.
    """
    try:
        import jax  # noqa: F401

        from .mesh import make_mesh, sharded_chain_group_fn
    except Exception:  # noqa: BLE001
        return None
    try:
        n = succ.shape[0]
        if n == 0 or n >= (1 << 30) or starts.size == 0:
            return None
        if mesh is None:
            mesh = make_mesh()
        if pd is None:  # callers may pass a precomputed doubling result
            pd = mesh_pointer_double(succ, mesh=mesh)
        if pd is None:
            return None
        end, dist, is_chain, _ = pd
        sel = _led_chain_selection(end, is_chain, starts, n)

        n_dev = int(mesh.devices.size)
        ep = _pad_stride(n_dev, end.astype(np.int32), 0, np.int32)
        dp = _pad_stride(n_dev, dist.astype(np.int32), 0, np.int32)
        sp = _pad_stride(n_dev, sel, False, bool)
        fn = sharded_chain_group_fn(mesh)
        es, ns = fn(
            _stride_global(mesh, ep),
            _stride_global(mesh, dp),
            _stride_global(mesh, sp),
        )
        es = _gather_global(es, np.int32)
        ns = _gather_global(ns, np.int32)
        live = es != (1 << 31) - 1
        nodes = ns[live].astype(np.int64)
        ends = es[live]
        if nodes.size == 0:
            return None
        bnd = np.flatnonzero(np.diff(ends)) + 1
        groups = np.concatenate(
            ([0], bnd, [nodes.shape[0]])
        ).astype(np.int64)
        from ..core.graph import led_group_selection, permute_groups

        sel2 = led_group_selection(nodes, groups, starts, n)
        if sel2 is None:
            return None  # unexpected topology; use the host walk
        _led, nodes, groups, order = sel2
        return permute_groups(nodes, groups, order)
    except Exception as e:  # noqa: BLE001
        from ..ops.backend import _note_fallback

        _note_fallback("mesh_chain_group", e)
        return None


def mesh_emit_chains(
    A: np.ndarray,
    k: int,
    succ: np.ndarray,
    starts: np.ndarray,
    oriented: bool,
    mesh=None,
    pd=None,
):
    """Distributed chain grouping AND string emission in one pass
    (mesh.sharded_emit_fn): resolves (end, dist) via distributed pointer
    doubling, routes each record — now carrying its oriented k-mer value
    — to its end's owner, and renders the grouped records straight to
    2-bit base codes on-device.  The host only concatenates per-device
    code blocks and slices group boundaries; it never gathers node ids
    back through A.

    Returns (nodes, groups, codes, str_offsets) where groups[i]:groups[i+1]
    indexes the nodes of chain i and codes[str_offsets[i]:str_offsets[i+1]]
    is its rendered string — unfiltered and in end-owner order; callers
    apply their own keep/order rules group-wise.  None when unavailable.
    """
    try:
        import jax  # noqa: F401

        from .mesh import make_mesh, sharded_emit_fn
    except Exception:  # noqa: BLE001
        return None
    try:
        n = succ.shape[0]
        if n == 0 or n >= (1 << 30) or starts.size == 0:
            return None
        if mesh is None:
            mesh = make_mesh()
        if pd is None:  # callers may pass a precomputed doubling result
            pd = mesh_pointer_double(succ, mesh=mesh)
        if pd is None:
            return None
        end, dist, is_chain, _ = pd
        sel = _led_chain_selection(end, is_chain, starts, n)

        ids = np.arange(n, dtype=np.int64)
        if oriented:
            vals = A[ids >> 1].astype(np.int64)
            flip = (ids & 1).astype(np.int64)
        else:
            vals = A[ids].astype(np.int64)
            flip = np.zeros(n, dtype=np.int64)
        vhi = (((vals >> 32) & 0x3FFFFFFF) | (flip << 30)).astype(np.int32)
        vlo = (vals & 0xFFFFFFFF).astype(np.uint32).view(np.int32)

        n_dev = int(mesh.devices.size)
        N = math.ceil(n / n_dev) * n_dev
        ep = _pad_stride(n_dev, end.astype(np.int32), 0, np.int32)
        dp = _pad_stride(n_dev, dist.astype(np.int32), 0, np.int32)
        sp = _pad_stride(n_dev, sel, False, bool)
        vhp = _pad_stride(n_dev, vhi, 0, np.int32)
        vlp = _pad_stride(n_dev, vlo, 0, np.int32)
        args = tuple(
            _stride_global(mesh, x) for x in (ep, dp, sp, vhp, vlp)
        )
        n_groups = int(starts.size)
        ocap = _mesh_env_capacity() or (
            1
            << max(
                10,
                (2 * (N // n_dev) + k * (n_groups // n_dev + 1) - 1)
                .bit_length(),
            )
        )
        ocap_max = N + (k - 1) * n_groups  # one device owning every end
        if ocap_max >= (1 << 31):
            # The emit kernel's offset arithmetic (cumsum/iota) is int32;
            # past this bound a skewed end-ownership could wrap silently.
            # Such inputs are out of single-mesh-emit range anyway (>2 GB
            # of rendered codes on one device) — use the host walk.
            return None
        for _attempt in range(32):
            fn = sharded_emit_fn(mesh, k, ocap)
            codes_d, es, ns, n_out, overflow = fn(*args)
            if int(np.asarray(jax.device_get(overflow))[0]) == 0:
                break
            if ocap >= ocap_max:  # pragma: no cover - defensive ceiling
                return None
            _log.info(
                "mesh emit overflow (ocap = %d); retrying", ocap
            )
            ocap = min(2 * ocap, ocap_max)
        else:  # pragma: no cover - unreachable with the ceiling
            return None

        es = _gather_global(es, np.int32).reshape(n_dev, N)
        ns = _gather_global(ns, np.int32).reshape(n_dev, N)
        codes_d = _gather_global(codes_d, np.int8).reshape(n_dev, ocap)
        n_out = _gather_global(n_out, np.int64).reshape(n_dev)
        isent = (1 << 31) - 1
        n_live = [int(np.searchsorted(es[d], isent)) for d in range(n_dev)]
        ends = np.concatenate([es[d, : n_live[d]] for d in range(n_dev)])
        nodes = np.concatenate(
            [ns[d, : n_live[d]] for d in range(n_dev)]
        ).astype(np.int64)
        codes = np.concatenate(
            [codes_d[d, : n_out[d]] for d in range(n_dev)]
        ).astype(np.uint8)
        if nodes.size == 0:
            return None
        bnd = np.flatnonzero(np.diff(ends)) + 1
        groups = np.concatenate(([0], bnd, [nodes.shape[0]])).astype(np.int64)
        counts = np.diff(groups)
        str_offsets = np.zeros(groups.shape[0], dtype=np.int64)
        np.cumsum(counts + k - 1, out=str_offsets[1:])
        if int(str_offsets[-1]) != codes.shape[0]:
            return None  # device/host accounting mismatch; fall back
        return nodes, groups, codes, str_offsets
    except Exception as e:  # noqa: BLE001
        from ..ops.backend import _note_fallback

        _note_fallback("mesh_emit_chains", e)
        return None


def mesh_matching(pa: np.ndarray, pb: np.ndarray, n_ports: int, mesh=None):
    """Distributed greedy matching with the host calling convention of
    core.graph.handshake_matching (self-loop-free edge list in priority
    order): returns match[port] = partner port or -1.  The greedy
    matching is unique, so the result is bit-identical to the host and
    native paths.  Multi-process aware; returns None when unavailable."""
    try:
        import jax  # noqa: F401

        from .mesh import make_mesh, sharded_matching_fn
    except Exception:  # noqa: BLE001
        return None
    try:
        n_e = int(pa.shape[0])
        if n_e == 0 or n_ports == 0 or n_ports >= (1 << 30):
            return None
        if mesh is None:
            mesh = make_mesh()
        n_dev = int(mesh.devices.size)
        ecap = math.ceil(n_e / n_dev)
        if ecap * n_dev >= (1 << 31):
            # Global edge priorities are int32 (prio = iota + my * ecap,
            # mesh.sharded_matching_fn); past 2^31 padded edges they wrap
            # and the greedy order silently diverges from the host path.
            return None
        pcap = math.ceil(n_ports / n_dev)
        pa_p = _pad_stride(n_dev, pa.astype(np.int32), -1, np.int32)
        pb_p = _pad_stride(n_dev, pb.astype(np.int32), -1, np.int32)
        m0 = np.zeros(pcap * n_dev, dtype=np.int32)
        fn = sharded_matching_fn(mesh)
        match = fn(
            _stride_global(mesh, pa_p),
            _stride_global(mesh, pb_p),
            _stride_global(mesh, m0),
        )
        return _gather_global(match)[:n_ports]
    except Exception as e:  # noqa: BLE001
        from ..ops.backend import _note_fallback

        _note_fallback("mesh_matching", e)
        return None


def mesh_overlap_edges(P: np.ndarray, S: np.ndarray, k: int, mesh=None):
    """Distributed overlap-edge discovery with the host calling
    convention of core.spss._candidate_port_edges_canonical's join
    phase: returns pre-dedup (a_ports, b_ports) in the exact host
    discovery-priority order, or None when unavailable.

    Falls back when P or S carry duplicate values (cannot happen for
    unitigs of one SPSS, where every k-mer appears exactly once, but the
    device probe answers at most one partner per query)."""
    try:
        import jax  # noqa: F401

        from .mesh import make_mesh, sharded_overlap_edges_fn
    except Exception:  # noqa: BLE001
        return None
    try:
        n = int(P.shape[0])
        if n == 0 or n >= (1 << 29):
            return None
        if k > 30:
            # The exchange key is (value << 1) | table_bit — 2k+1 bits —
            # and the device sentinel is 2^62 (mesh.sharded_overlap_
            # edges_fn); k = 31 keys would reach/pass the sentinel and
            # silently drop edges.  Host join handles k = 31.
            return None
        if mesh is None:
            mesh = make_mesh()
        n_dev = int(mesh.devices.size)
        ucap = math.ceil(n / n_dev)
        pp = _pad_stride(n_dev, P.astype(np.int64), -1, np.int64)
        ss = _pad_stride(n_dev, S.astype(np.int64), -1, np.int64)
        qcap = _mesh_env_capacity() or (
            1 << (max(1024, 2 * 16 * ucap // n_dev) - 1).bit_length()
        )
        qcap_max = 16 * ucap  # a source sends at most this many queries
        ppg = _stride_global(mesh, pp)
        ssg = _stride_global(mesh, ss)
        for _attempt in range(32):
            fn = sharded_overlap_edges_fn(mesh, k, qcap)
            ans, dropped, dup = fn(ppg, ssg)
            if int(np.asarray(jax.device_get(dup))[0]) > 0:
                # Duplicate prefix/suffix keys: the one-partner-per-key
                # table would silently drop edges — host join handles.
                return None
            if int(np.asarray(jax.device_get(dropped))[0]) == 0:
                break
            if qcap >= qcap_max:  # pragma: no cover - defensive ceiling
                return None
            _log.info(
                "mesh overlap-edge exchange overflow (qcap = %d); retrying",
                qcap,
            )
            qcap = min(2 * qcap, qcap_max)
        else:  # pragma: no cover - unreachable with the ceiling
            return None
        ans = _gather_global(ans, np.int32).reshape(n_dev, 16, ucap)
        cnts = [min(max(n - d * ucap, 0), ucap) for d in range(n_dev)]
        ans16 = np.concatenate(
            [ans[d][:, : cnts[d]] for d in range(n_dev)], axis=1
        )
        found = (ans16 & (1 << 30)) != 0
        j16 = (ans16 & ((1 << 30) - 1)).astype(np.int64)
        ar = np.arange(n, dtype=np.int64)
        a_out, b_out = [], []
        for jt in range(16):
            grp = jt // 8  # 0: probes from S (right port); 1: from P (left)
            src = 2 * ar + grp
            if grp == 0:
                dst = 2 * j16[jt] + (1 - (jt % 2))
            else:
                dst = 2 * j16[jt] + (jt % 2)
            ok = found[jt] & ((src >> 1) != j16[jt])
            a_out.append(src[ok])
            b_out.append(dst[ok])
        return np.concatenate(a_out), np.concatenate(b_out)
    except Exception as e:  # noqa: BLE001
        from ..ops.backend import _note_fallback

        _note_fallback("mesh_overlap_edges", e)
        return None
