"""kmerset_tpu — a JAX k-mer set engine for the GPU.

A from-scratch JAX/XLA re-design of the capabilities of
kkty/kmer-sets-compression (reference layout: lib/core/*.h, src/*.cc):

- 2-bit packed k-mer codec (reference: lib/core/kmer.h)
- k-mer sets as sorted packed-integer arrays instead of bucketed hash sets
  (reference: lib/core/kmer_set.h)
- sort-based k-mer counting from FASTA (reference: lib/core/kmer_counter.h)
- SPSS (spectrum-preserving string set) construction via vectorized unitig
  compaction + greedy path cover with pointer-doubling path walks
  (reference: lib/core/spss.h)
- compact storage + text dump format compatible with the reference
  (reference: lib/core/kmer_set_compact.h)
- joint compression of many related k-mer sets (reference:
  lib/core/kmer_set_set.h)

The universal data decomposition carried over from the reference: a k-mer is
2K bits; the top N bits select a bucket and the low 2K-N bits are a key
(reference: lib/core/kmer_set.h:20-43).  In this package a k-mer set is a
*sorted* int64 array, so buckets are contiguous slices for free and the bucket
axis is the shard axis for multi-device meshes.
"""

__version__ = "0.1.0"


def _install_pool_allocator() -> None:
    """Installs the pooling NumPy data allocator (native/pool_alloc.c),
    the host-runtime counterpart of the reference's mimalloc link
    (reference: CMakeLists.txt:36-38).  Large NumPy temporaries recycle
    warm pages instead of paying OS first-touch provisioning per
    allocation.  Opt out with KMERSET_TPU_POOL=0; best-effort (silently
    skipped when the extension is unbuilt: `make -C native`)."""
    import os

    if os.environ.get("KMERSET_TPU_POOL", "1") == "0":
        return
    try:
        import importlib.util
        import sysconfig

        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
        from kmerset_tpu._nativebuild import ensure_built

        ensure_built("kmerset_pool" + suffix, ["pool_alloc.c"])
        path = os.path.join(here, "native", "kmerset_pool" + suffix)
        if not os.path.exists(path):
            return
        spec = importlib.util.spec_from_file_location("kmerset_pool", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.install()
        import sys

        sys.modules.setdefault("kmerset_pool", mod)
    except Exception:  # noqa: BLE001 - allocator is an optional accelerator
        pass


_install_pool_allocator()
