/* kmerio: native host-side data loader for kmerset_tpu.
 *
 * The reference is a header-only C++ codebase whose IO + encode inner loops
 * run on the CPU (reference: lib/core/io.h, lib/core/kmer_counter.h:161-209
 * FASTA validation, lib/core/kmer_set_compact.h:230-336 2-bit pack/unpack).
 * This is the equivalent native layer for the JAX build: one pass over the
 * raw FASTA bytes producing the flat 2-bit-code array + fragment offsets
 * that feed the device pipeline, plus 2-bit pack/unpack for the compact
 * in-memory form.  Exposed via ctypes (no pybind11 in this image).
 *
 * Build: make -C native   (produces libkmerio.so)
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <stdlib.h>
#ifdef _OPENMP
#include <omp.h>
#endif

/* The reference parallelizes its host loops with a thread pool
 * (boost::asio, reference: lib/core/kmer_counter.h:64-133 and every
 * parallel region); the equivalents here use OpenMP on the loops whose
 * iterations are independent.  Single-core builds/degenerate thread
 * counts run the identical code path. */

/* Ties the OpenMP pool to the CLI --workers flag (the reference sizes
 * its boost::asio thread pools from the same flag, lib/flags.h:25-53;
 * default 1 = single-threaded, matching the reference default). */
void kmerio_set_threads(int n) {
#ifdef _OPENMP
    if (n > 0) omp_set_num_threads(n);
#else
    (void)n;
#endif
}

#define CODE_SEP 254
#define CODE_BAD 255

static uint8_t LUT[256];
static int lut_ready = 0;

static void init_lut(void) {
    if (lut_ready) return;
    memset(LUT, CODE_BAD, 256);
    LUT['A'] = 0; LUT['C'] = 1; LUT['G'] = 2; LUT['T'] = 3;
    LUT['N'] = CODE_SEP;
    lut_ready = 1;
}

/* Parses FASTA text in buf[0..n): alternating '>' header lines and sequence
 * lines of A/C/G/T/N.  Writes base codes (0..3) of the sequence characters
 * to out_codes (caller-allocated, size >= n) and fragment end offsets
 * (cut at every 'N' and at every line end) to out_offsets (size >= n + 2).
 *
 * Returns the number of fragments written (offsets used = n_frag + 1,
 * out_offsets[0] == 0), or:
 *   -1  odd number of lines / header without sequence
 *   -2  line 2i is not a '>' header
 *   -3  invalid character in a sequence line
 */
long kmerio_parse_fasta(const char *buf, long n,
                        uint8_t *out_codes, int64_t *out_offsets) {
    init_lut();
    long pos = 0, n_codes = 0, n_frag = 0, line = 0;
    out_offsets[0] = 0;
    while (pos < n) {
        long eol = pos;
        while (eol < n && buf[eol] != '\n') eol++;
        if (line % 2 == 0) {
            if (eol == pos || buf[pos] != '>') return -2;
        } else {
            long frag_len = 0;
            for (long i = pos; i < eol; i++) {
                uint8_t c = LUT[(uint8_t)buf[i]];
                if (c == CODE_BAD) return -3;
                if (c == CODE_SEP) {
                    if (frag_len > 0) {
                        out_offsets[++n_frag] = n_codes;
                        frag_len = 0;
                    }
                } else {
                    out_codes[n_codes++] = c;
                    frag_len++;
                }
            }
            if (frag_len > 0) out_offsets[++n_frag] = n_codes;
        }
        line++;
        pos = eol + 1;
    }
    if (line % 2 != 0) return -1;
    return n_frag;
}

/* ABI version, bumped on any signature change of an existing export.
 * The Python binding refuses a mismatched lib outright: its per-symbol
 * presence checks can spot missing functions in a stale build, but not
 * a changed return type or argument list. */
long kmerio_abi_version(void) { return 3; }

/* 2-bit pack: 4 codes per byte, first code in the low bits
 * (density parity with the reference's vector<bool> form,
 * reference: kmer_set_compact.h:230-255). */
void kmerio_pack2(const uint8_t *codes, long n, uint8_t *out) {
    long nb = (n + 3) / 4;
    memset(out, 0, nb);
    for (long i = 0; i < n; i++)
        out[i >> 2] |= (uint8_t)(codes[i] << ((i & 3) * 2));
}

void kmerio_unpack2(const uint8_t *packed, long n, uint8_t *out) {
    for (long i = 0; i < n; i++)
        out[i] = (packed[i >> 2] >> ((i & 3) * 2)) & 3;
}

/* Walks chains of a functional successor graph (succ[u] in [0,n) or -1)
 * from each start, concatenating node sequences.  This is the native
 * sequential path walk the reference performs under its thread pool
 * (reference: lib/core/spss.h:394-423,1159-1183); a single C pointer
 * chase is O(total chain length) versus the O(n log n) fancy-gather cost
 * of host-side pointer doubling.
 *
 * out_nodes: size >= n; group_starts: size >= n_starts + 1;
 * visited: size n, zeroed by caller; set for every emitted node.
 * Returns total nodes emitted, or -1 when succ violates the chain
 * contract (a cycle reachable from a start, or total length > n) —
 * emitting then would overrun the caller's n-sized out_nodes.
 */
long kmerio_chain_walk(const int64_t *succ, long n,
                       const int64_t *starts, long n_starts,
                       int64_t *out_nodes, int64_t *group_starts,
                       uint8_t *visited) {
    /* Chains are node-disjoint (in-degree <= 1), so walks from distinct
     * starts never interact; interleaving W walks hides the ~100ns
     * dependent-load latency of each succ[] chase behind its siblings.
     * Pass 1 measures lengths (W-way interleaved), pass 2 emits with
     * per-chain output cursors. */
    enum { W = 64 };
    for (long base = 0; base < n_starts; base += W) {
        long m = n_starts - base < W ? n_starts - base : W;
        int64_t cur[W];
        long len[W];
        int live = (int)m;
        long steps = 0;
        for (long w = 0; w < m; w++) { cur[w] = starts[base + w]; len[w] = 0; }
        while (live > 0 && steps++ <= n) {
            live = 0;
            for (long w = 0; w < m; w++) {
                int64_t u = cur[w];
                if (u < 0) continue;
                len[w]++;
                int64_t nx = succ[u];
                if (nx >= 0) __builtin_prefetch(&succ[nx]);
                cur[w] = nx;
                if (nx >= 0) live++;
            }
        }
        if (live > 0) return -1; /* cycle reached from a start */
        for (long w = 0; w < m; w++)
            group_starts[base + w + 1] = len[w]; /* lengths for now */
    }
    group_starts[0] = 0;
    for (long s = 0; s < n_starts; s++)
        group_starts[s + 1] += group_starts[s];
    if (group_starts[n_starts] > n) return -1; /* revisits: not chains */
    for (long base = 0; base < n_starts; base += W) {
        long m = n_starts - base < W ? n_starts - base : W;
        int64_t cur[W];
        long pos[W];
        int live = (int)m;
        long steps = 0;
        for (long w = 0; w < m; w++) {
            cur[w] = starts[base + w];
            pos[w] = group_starts[base + w];
        }
        while (live > 0 && steps++ <= n) {
            live = 0;
            for (long w = 0; w < m; w++) {
                int64_t u = cur[w];
                if (u < 0) continue;
                visited[u] = 1;
                out_nodes[pos[w]++] = u;
                int64_t nx = succ[u];
                if (nx >= 0) __builtin_prefetch(&succ[nx]);
                cur[w] = nx;
                if (nx >= 0) live++;
            }
        }
    }
    return group_starts[n_starts];
}

/* Chain-walk pass 1 for the canonical (bidirected) dedup: walks every
 * start once, recording length and final node.  The caller applies the
 * reference's orientation tie-break (keep iff A[first] >= A[last],
 * reference: lib/core/spss.h:511,555) and re-walks ONLY kept chains via
 * kmerio_chain_emit — 3n total visits instead of the 4n of walking both
 * orientations through the generic two-pass kmerio_chain_walk and
 * filtering afterwards. */
void kmerio_chain_lens_ends(const int64_t *succ, long n,
                            const int64_t *starts, long n_starts,
                            int64_t *lens, int64_t *ends) {
    enum { W = 64 };
    for (long base = 0; base < n_starts; base += W) {
        long m = n_starts - base < W ? n_starts - base : W;
        int64_t cur[W], last[W];
        long len[W];
        int live = (int)m;
        long steps = 0;
        for (long w = 0; w < m; w++) {
            cur[w] = starts[base + w];
            last[w] = cur[w];
            len[w] = 0;
        }
        while (live > 0 && steps++ <= n) {
            live = 0;
            for (long w = 0; w < m; w++) {
                int64_t u = cur[w];
                if (u < 0) continue;
                len[w]++;
                last[w] = u;
                int64_t nx = succ[u];
                if (nx >= 0) __builtin_prefetch(&succ[nx]);
                cur[w] = nx;
                if (nx >= 0) live++;
            }
        }
        for (long w = 0; w < m; w++) {
            lens[base + w] = len[w];
            ends[base + w] = last[w];
        }
    }
}

/* Pass 1 with mirror dedup: a bidirected chain s -> e and its mirror
 * e^1 -> s^1 visit the same entities with the same length, so each
 * PAIR needs measuring only once — n visits instead of the 2n of
 * walking every start.  `seen` (caller-zeroed, size n) marks a chain's
 * own start at completion and its mirror's start; marked starts are
 * skipped at batch init, and mirrors racing within one interleave
 * batch are resolved deterministically at completion order (the first
 * to finish records, the second is dropped).  Walked chains are
 * emitted compacted as (start, end, len); returns the chain count.
 * The caller picks each pair's winning orientation from (start, end)
 * (reference skip rule, lib/core/spss.h:511,555) and emits winners via
 * kmerio_chain_emit — 2n total visits for the whole phase. */
long kmerio_chain_pairs(const int64_t *succ, long n,
                        const int64_t *starts, long n_starts,
                        uint8_t *seen,
                        int64_t *out_s, int64_t *out_e, int64_t *out_len) {
    enum { W = 64 };
    long cnt = 0;
    for (long base = 0; base < n_starts; base += W) {
        long m = n_starts - base < W ? n_starts - base : W;
        int64_t cur[W], st[W];
        long len[W];
        int live = 0;
        long steps = 0;
        for (long w = 0; w < m; w++) {
            int64_t s = starts[base + w];
            st[w] = s;
            len[w] = 0;
            cur[w] = seen[s] ? -1 : s;
            if (cur[w] >= 0) live++;
        }
        while (live > 0 && steps++ <= n) {
            live = 0;
            for (long w = 0; w < m; w++) {
                int64_t u = cur[w];
                if (u < 0) continue;
                len[w]++;
                int64_t nx = succ[u];
                if (nx >= 0) {
                    __builtin_prefetch(&succ[nx]);
                    cur[w] = nx;
                    live++;
                } else {
                    cur[w] = -1;
                    if (!seen[st[w]]) {
                        out_s[cnt] = st[w];
                        out_e[cnt] = u;
                        out_len[cnt] = len[w];
                        cnt++;
                        seen[st[w]] = 1;
                        seen[u ^ 1] = 1;
                    }
                }
            }
        }
        /* Chain contract (same as kmerio_chain_walk): a start leading
         * into a cycle never terminates; dropping it silently would
         * lose its k-mers from the SPSS.  Refuse so callers fall back. */
        if (live > 0) return -1;
    }
    return cnt;
}

/* Chain-walk pass 2: emits node sequences at caller-precomputed offsets
 * (group_starts = exclusive prefix sum of kept lengths; group_ends its
 * next entries — group g owns out_nodes[group_starts[g], group_ends[g])).
 * Returns 0, or -1 when a walk violates its measured length (a cycle or
 * a succ array that changed between passes) BEFORE overrunning its
 * slot, so callers can fall back instead of corrupting the buffer. */
long kmerio_chain_emit(const int64_t *succ, long n,
                       const int64_t *starts, long n_starts,
                       const int64_t *group_starts,
                       const int64_t *group_ends, int64_t *out_nodes) {
    enum { W = 64 };
    for (long base = 0; base < n_starts; base += W) {
        long m = n_starts - base < W ? n_starts - base : W;
        int64_t cur[W];
        long pos[W], end[W];
        int live = (int)m;
        long steps = 0;
        for (long w = 0; w < m; w++) {
            cur[w] = starts[base + w];
            pos[w] = group_starts[base + w];
            end[w] = group_ends[base + w];
        }
        while (live > 0 && steps++ <= n) {
            live = 0;
            for (long w = 0; w < m; w++) {
                int64_t u = cur[w];
                if (u < 0) continue;
                if (pos[w] >= end[w]) return -1; /* longer than measured */
                out_nodes[pos[w]++] = u;
                int64_t nx = succ[u];
                if (nx >= 0) __builtin_prefetch(&succ[nx]);
                cur[w] = nx;
                if (nx >= 0) live++;
            }
        }
        for (long w = 0; w < m; w++) {
            /* every walk must terminate and fill its slot exactly */
            if (cur[w] >= 0 || pos[w] != end[w]) return -1;
        }
    }
    return 0;
}

static inline uint64_t rc_one(uint64_t v, int k);

/* Walks leftover pure cycles in ascending entity order, stopping each
 * walk at the first already-visited entity (reference:
 * lib/core/spss.h:203-224,583-612).  Replaces the per-k-mer Python
 * fallback loop: one C pass, emitting k codes for a cycle's first node
 * and one code per following node.  oriented != 0 means node ids carry
 * the orientation bit (bidirected graphs) and A values are
 * reverse-complemented when it is set.
 * visited: size n_ent, updated in place.  out_codes must hold
 * (n_unvisited * k) bytes worst-case; out_offsets n_unvisited + 1.
 * Returns the number of cycles emitted (out_offsets[0] == 0). */
long kmerio_walk_cycles(const int64_t *succ, const int64_t *A, long n_ent,
                        int k, int oriented, uint8_t *visited,
                        uint8_t *out_codes, int64_t *out_offsets) {
    long n_cyc = 0, pos = 0;
    out_offsets[0] = 0;
    for (long i0 = 0; i0 < n_ent; i0++) {
        if (visited[i0]) continue;
        int64_t u = oriented ? 2 * i0 : i0;
        int first = 1;
        while (u >= 0) {
            long ent = oriented ? (u >> 1) : u;
            if (visited[ent]) break;
            visited[ent] = 1;
            uint64_t val = (uint64_t)A[ent];
            if (oriented && (u & 1)) val = rc_one(val, k);
            if (first) {
                for (int t = k - 1; t >= 0; t--)
                    out_codes[pos++] = (uint8_t)((val >> (2 * t)) & 3);
                first = 0;
            } else {
                out_codes[pos++] = (uint8_t)(val & 3);
            }
            u = succ[u];
        }
        if (!first) out_offsets[++n_cyc] = pos;
    }
    return n_cyc;
}

/* Reverse complement of 2-bit packed k-mers: complement every lane and
 * reverse lane order (reference per-base loop: lib/core/kmer.h:103-129;
 * here the 5-round lane shuffle, one pass over the array). */
void kmerio_revcomp(const int64_t *in, long n, int k, int64_t *out) {
    const uint64_t M2 = 0x3333333333333333ULL, M4 = 0x0F0F0F0F0F0F0F0FULL,
                   M8 = 0x00FF00FF00FF00FFULL, M16 = 0x0000FFFF0000FFFFULL,
                   M32 = 0x00000000FFFFFFFFULL;
    const int sh = 64 - 2 * k;
    const uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    #pragma omp parallel for schedule(static)
    for (long i = 0; i < n; i++) {
        uint64_t x = ~(uint64_t)in[i];
        x = ((x >> 2) & M2) | ((x & M2) << 2);
        x = ((x >> 4) & M4) | ((x & M4) << 4);
        x = ((x >> 8) & M8) | ((x & M8) << 8);
        x = ((x >> 16) & M16) | ((x & M16) << 16);
        x = ((x >> 32) & M32) | ((x & M32) << 32);
        out[i] = (int64_t)((x >> sh) & mask);
    }
}

/* All length-k windows of a base-code sequence, packed rolling-hash style:
 * one pass instead of k shifted passes (reference window loop:
 * lib/core/kmer_counter.h:80-96). */
void kmerio_window_pack(const uint8_t *codes, long n, int k, int64_t *out) {
    if (n < k) return;
    const uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    uint64_t w = 0;
    for (long i = 0; i < k - 1; i++) w = (w << 2) | codes[i];
    for (long i = k - 1; i < n; i++) {
        w = ((w << 2) | codes[i]) & mask;
        out[i - k + 1] = (int64_t)w;
    }
}

static inline uint64_t rc_one(uint64_t v, int k) {
    const uint64_t M2 = 0x3333333333333333ULL, M4 = 0x0F0F0F0F0F0F0F0FULL,
                   M8 = 0x00FF00FF00FF00FFULL, M16 = 0x0000FFFF0000FFFFULL,
                   M32 = 0x00000000FFFFFFFFULL;
    uint64_t x = ~v;
    x = ((x >> 2) & M2) | ((x & M2) << 2);
    x = ((x >> 4) & M4) | ((x & M4) << 4);
    x = ((x >> 8) & M8) | ((x & M8) << 8);
    x = ((x >> 16) & M16) | ((x & M16) << 16);
    x = ((x >> 32) & M32) | ((x & M32) << 32);
    return (x >> (64 - 2 * k)) & ((1ULL << (2 * k)) - 1);
}

/* Emits unitig base codes from chain-grouped oriented nodes in one pass
 * (reference ConcatenateKmers, lib/core/spss.h:25-41): the first node of a
 * chain contributes k bases, every following node one base.  If oriented,
 * node ids encode (entity << 1) | flip with flip meaning read the
 * reverse complement.  offsets must have n_groups + 1 slots; out_codes
 * must fit sum(count_g + k - 1). */
void kmerio_emit_kmer_chains(const int64_t *A, int k,
                             const int64_t *nodes,
                             const int64_t *groups, long n_groups,
                             int oriented, int64_t *offsets,
                             uint8_t *out_codes) {
    long pos = 0;
    offsets[0] = 0;
    const long total = groups[n_groups];
    for (long g = 0; g < n_groups; g++) {
        for (long i = groups[g]; i < groups[g + 1]; i++) {
            if (i + 32 < total) {
                int64_t un = nodes[i + 32];
                __builtin_prefetch(&A[oriented ? (un >> 1) : un]);
            }
            int64_t u = nodes[i];
            uint64_t v;
            if (oriented) {
                v = (uint64_t)A[u >> 1];
                if (u & 1) v = rc_one(v, k);
            } else {
                v = (uint64_t)A[u];
            }
            if (i == groups[g]) {
                for (int t = k - 1; t >= 0; t--)
                    out_codes[pos++] = (uint8_t)((v >> (2 * t)) & 3);
            } else {
                out_codes[pos++] = (uint8_t)(v & 3);
            }
        }
        offsets[g + 1] = pos;
    }
}

/* --- de Bruijn side tables via open-addressing hash ---------------------
 *
 * The reference computes per-side degree / unique-neighbor / same-side
 * tables with 8 hash Contains() per k-mer (reference:
 * lib/core/spss.h:238-313 canonical, 76-146 directed).  This is the
 * native equivalent: one linear-probing table over the sorted k-mer
 * array (values = array indices), then 8 probes per k-mer.
 */

static inline uint64_t mix64(uint64_t x) {
    x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33; return x;
}

/* KMERIO_TIMING=1 prints per-section wall times of the probe-heavy
 * functions to stderr — the roofline instrumentation behind
 * docs/DESIGN.md's host-phase numbers. */
#include <stdio.h>
#include <time.h>
static int timing_on(void) {
    static int v = -1;
    if (v < 0) { const char *e = getenv("KMERIO_TIMING"); v = (e && *e && *e != '0') ? 1 : 0; }
    return v;
}
static double now_s(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}
#define TLOG(...) do { if (timing_on()) fprintf(stderr, __VA_ARGS__); } while (0)

/* table: 2^logcap slots of int32 indices into A, -1 = empty. */
static void hash_build(const int64_t *A, long n, int32_t *table, int logcap) {
    const uint64_t mask = (1ULL << logcap) - 1;
    for (long i = 0; i < n; i++) {
        uint64_t h = mix64((uint64_t)A[i]) & mask;
        while (table[h] != -1) h = (h + 1) & mask;
        table[h] = (int32_t)i;
    }
}

static inline int32_t hash_find(const int64_t *A, const int32_t *table,
                                int logcap, int64_t key) {
    const uint64_t mask = (1ULL << logcap) - 1;
    uint64_t h = mix64((uint64_t)key) & mask;
    for (;;) {
        int32_t v = table[h];
        if (v == -1) return -1;
        if (A[v] == key) return v;
        h = (h + 1) & mask;
    }
}

/* Fills right(deg,nbr,same) and left(deg,nbr,same) for every A[i].
 * canonical != 0: candidates are canonicalized before lookup and `same`
 * records whether the raw candidate differed from its canonical form.
 * table: caller-allocated int32[1 << logcap] filled with -1.
 * deg/nbr are int32; same is uint8.
 * Returns 0, or -1 on allocation failure (outputs then unusable — the
 * caller must fall back rather than read the zeroed tables). */
long kmerio_side_tables(const int64_t *A, long n, int k, int canonical,
                        int32_t *table, int logcap,
                        int32_t *rdeg, int32_t *rnbr, uint8_t *rsame,
                        int32_t *ldeg, int32_t *lnbr, uint8_t *lsame) {
    if (n <= 0) return 0;
    hash_build(A, n, table, logcap);
    const uint64_t kmask = (1ULL << (2 * k)) - 1;
    const uint64_t tmask = (1ULL << logcap) - 1;
    memset(rdeg, 0, (size_t)n * 4); memset(ldeg, 0, (size_t)n * 4);
    memset(rnbr, 0, (size_t)n * 4); memset(lnbr, 0, (size_t)n * 4);
    memset(rsame, 0, (size_t)n);    memset(lsame, 0, (size_t)n);
    /* Per-(side, base) passes with software prefetching: the probe loop
     * is memory-latency bound (the table exceeds L3), so queries are
     * precomputed per pass and the slot PD iterations ahead is
     * prefetched. */
    enum { PD = 32 };
    int64_t *q = (int64_t *)malloc((size_t)(n > 0 ? n : 1) * sizeof(int64_t));
    uint8_t *diff = (uint8_t *)malloc((size_t)(n > 0 ? n : 1));
    if (!q || !diff) { free(q); free(diff); return -1; }
    for (int side = 0; side < 2; side++) {
        int32_t *deg = side ? ldeg : rdeg;
        int32_t *nbr = side ? lnbr : rnbr;
        uint8_t *same = side ? lsame : rsame;
        for (int c = 0; c < 4; c++) {
            #pragma omp parallel for schedule(static)
            for (long i = 0; i < n; i++) {
                uint64_t cand =
                    side ? (((uint64_t)A[i] >> 2) |
                            ((uint64_t)c << (2 * (k - 1))))
                         : ((((uint64_t)A[i] << 2) | (uint64_t)c) & kmask);
                uint64_t qq = cand;
                if (canonical) {
                    uint64_t rc = rc_one(cand, k);
                    if (rc < qq) qq = rc;
                }
                q[i] = (int64_t)qq;
                diff[i] = (uint8_t)(cand != qq);
            }
            #pragma omp parallel for schedule(static)
            for (long i = 0; i < n; i++) {
                if (i + PD < n)
                    __builtin_prefetch(
                        &table[mix64((uint64_t)q[i + PD]) & tmask]);
                if (q[i] == A[i]) continue; /* self-loop excluded */
                int32_t idx = hash_find(A, table, logcap, q[i]);
                if (idx >= 0) {
                    if (deg[i] == 0) { nbr[i] = idx; same[i] = diff[i]; }
                    deg[i]++;
                }
            }
        }
    }
    free(q);
    free(diff);
    return 0;
}

/* Greedy maximal matching over ports, edges in priority order.  One
 * sequential pass accepts an edge iff both ports are still free — the
 * lexicographically-first maximal matching, identical to the
 * handshake-rounds result with the same priorities (an edge wins a
 * handshake round iff it is the minimum live edge at both ports, which
 * accepts exactly the greedy-scan edges).  Replaces the O(rounds * E)
 * vectorized host loop (core/graph.py::handshake_matching) with O(E).
 * match: int64[n_ports], caller-filled with -1. */
void kmerio_greedy_match(const int64_t *pa, const int64_t *pb, long n_e,
                         int64_t *match) {
    for (long e = 0; e < n_e; e++) {
        int64_t a = pa[e], b = pb[e];
        if (match[a] < 0 && match[b] < 0 && a != b) {
            match[a] = b;
            match[b] = a;
        }
    }
}

static long lower_bound64(const int64_t *A, long n, int64_t key) {
    long lo = 0, hi = n;
    while (lo < hi) {
        long mid = lo + ((hi - lo) >> 1);
        if (A[mid] < key) lo = mid + 1; else hi = mid;
    }
    return lo;
}

/* Side tables, merge-join edition.  The hash version pays one
 * latency-bound probe per (k-mer, side, base).  But half of those
 * lookups query the RAW candidate (the canonical form when cand < rc —
 * always in the directed case), and raw candidates inherit A's order:
 *   prev(A, c) = (A >> 2) | c<<..   is globally non-decreasing;
 *   next(A, c) = ((A << 2) | c) & m is strictly increasing within each
 *     top-2-bit class of A, whose index ranges are contiguous slices.
 * Those lookups become sequential two-pointer merges against A (~2 ns
 * per element vs ~150 ns per probe); only rc-canonical candidates
 * (canonical mode, cand > rc) still probe the hash table.
 * Same outputs/contract (incl. the 0 / -1 return) as kmerio_side_tables. */
long kmerio_side_tables_merge(const int64_t *A, long n, int k, int canonical,
                              int32_t *table, int logcap,
                              int32_t *rdeg, int32_t *rnbr, uint8_t *rsame,
                              int32_t *ldeg, int32_t *lnbr, uint8_t *lsame) {
    if (n <= 0) return 0;
    double t0 = now_s();
    if (canonical) hash_build(A, n, table, logcap);
    TLOG("side_tables: hash_build: %.2fs\n", now_s() - t0);
    double t_cand = 0, t_probe = 0, t_merge = 0, tx;
    const uint64_t kmask = (1ULL << (2 * k)) - 1;
    const uint64_t tmask = (1ULL << logcap) - 1;
    memset(rdeg, 0, (size_t)n * 4); memset(ldeg, 0, (size_t)n * 4);
    memset(rnbr, 0, (size_t)n * 4); memset(lnbr, 0, (size_t)n * 4);
    memset(rsame, 0, (size_t)n);    memset(lsame, 0, (size_t)n);
    enum { PD = 32 };
    int64_t *q = (int64_t *)malloc((size_t)n * sizeof(int64_t));
    int64_t *qr = canonical
        ? (int64_t *)malloc((size_t)n * sizeof(int64_t)) : NULL;
    if (!q || (canonical && !qr)) { free(q); free(qr); return -1; }
    long class_lo[5];
    for (int b = 0; b < 4; b++)
        class_lo[b] = lower_bound64(A, n, (int64_t)((uint64_t)b << (2 * k - 2)));
    class_lo[4] = n;
    for (int side = 0; side < 2; side++) {
        int32_t *deg = side ? ldeg : rdeg;
        int32_t *nbr = side ? lnbr : rnbr;
        uint8_t *same = side ? lsame : rsame;
        for (int c = 0; c < 4; c++) {
            tx = now_s();
            #pragma omp parallel for schedule(static)
            for (long i = 0; i < n; i++) {
                uint64_t cand =
                    side ? (((uint64_t)A[i] >> 2) |
                            ((uint64_t)c << (2 * (k - 1))))
                         : ((((uint64_t)A[i] << 2) | (uint64_t)c) & kmask);
                q[i] = (int64_t)cand;
                if (canonical) qr[i] = (int64_t)rc_one(cand, k);
            }
            t_cand += now_s() - tx;
            tx = now_s();
            if (canonical) {
                /* rc-canonical candidates: probe (latency-bound). */
                #pragma omp parallel for schedule(static)
                for (long i = 0; i < n; i++) {
                    if (i + PD < n && qr[i + PD] < q[i + PD])
                        __builtin_prefetch(
                            &table[mix64((uint64_t)qr[i + PD]) & tmask]);
                    if (qr[i] >= q[i]) continue;
                    if (qr[i] == A[i]) continue; /* self loop */
                    int32_t idx = hash_find(A, table, logcap, qr[i]);
                    if (idx >= 0) {
                        if (deg[i] == 0) { nbr[i] = idx; same[i] = 1; }
                        deg[i]++;
                    }
                }
            }
            t_probe += now_s() - tx;
            tx = now_s();
            /* direct candidates: two-pointer merges over sorted runs. */
            if (side == 0) {
                #pragma omp parallel for schedule(static)
                for (int b = 0; b < 4; b++) {
                    long j = 0;
                    for (long i = class_lo[b]; i < class_lo[b + 1]; i++) {
                        if (canonical && qr[i] < q[i]) continue;
                        int64_t v = q[i];
                        while (j < n && A[j] < v) j++;
                        if (j >= n) break;
                        if (A[j] == v && v != A[i]) {
                            if (deg[i] == 0) { nbr[i] = (int32_t)j; }
                            deg[i]++;
                        }
                    }
                }
            } else {
                long j = 0;
                for (long i = 0; i < n; i++) {
                    if (canonical && qr[i] < q[i]) continue;
                    int64_t v = q[i];
                    while (j < n && A[j] < v) j++;
                    if (j >= n) break;
                    if (A[j] == v && v != A[i]) {
                        if (deg[i] == 0) { nbr[i] = (int32_t)j; }
                        deg[i]++;
                    }
                }
            }
            t_merge += now_s() - tx;
        }
    }
    TLOG("side_tables: candidates: %.2fs  probes: %.2fs  merges: %.2fs\n",
         t_cand, t_probe, t_merge);
    free(q);
    free(qr);
    return 0;
}

/* Dense canonical window keys, int32 edition (k <= 15: 2k <= 30 bits).
 * One rolling pass per fragment — the host-count analogue of the device
 * window pack (reference inner loop: lib/core/kmer_counter.h:80-96).
 * Emits one key per window fully inside a fragment, consecutively
 * (invalid/straddling windows are skipped, not sentineled), so the
 * caller sorts a dense int32 array half the size of the int64 path.
 * offsets: n_frag+1 fragment boundaries into codes.  Returns the number
 * of keys written. */
long kmerio_canonical_windows32(const uint8_t *codes, int k, int canonical,
                                const int64_t *offsets, long n_frag,
                                int32_t *out) {
    const uint32_t kmask = (uint32_t)((1u << (2 * k)) - 1);
    long m = 0;
    for (long f = 0; f < n_frag; f++) {
        long lo = offsets[f], hi = offsets[f + 1];
        if (hi - lo < k) continue;
        uint32_t fwd = 0, rc = 0;
        for (long i = lo; i < lo + k - 1; i++) {
            fwd = ((fwd << 2) | codes[i]) & kmask;
            rc = (rc >> 2) | ((uint32_t)(3 - codes[i]) << (2 * (k - 1)));
        }
        for (long i = lo + k - 1; i < hi; i++) {
            fwd = ((fwd << 2) | codes[i]) & kmask;
            rc = (rc >> 2) | ((uint32_t)(3 - codes[i]) << (2 * (k - 1)));
            uint32_t key = (canonical && rc < fwd) ? rc : fwd;
            out[m++] = (int32_t)key;
        }
    }
    return m;
}

/* --- packed-fingerprint open addressing ---------------------------------
 * Every probe of the int32-index tables above costs TWO dependent cache
 * misses (table slot -> key array verify).  Packing (idx+1) << 32 | fp32
 * into one int64 slot answers a probe with ONE random read: fp32 is the
 * key's low 32 bits — exact for 2k <= 32 (k <= 16, every CLI count k's
 * side tables), a 2^-32 filter above that (verified against the key
 * array only on fp match, i.e. ~only on true hits). */

static void fp_build(const int64_t *A, long n, uint64_t *tab, int logcap) {
    const uint64_t mask = (1ULL << logcap) - 1;
    for (long i = 0; i < n; i++) {
        uint64_t key = (uint64_t)A[i];
        uint64_t h = mix64(key) & mask;
        while (tab[h]) h = (h + 1) & mask;
        tab[h] = (((uint64_t)(i + 1)) << 32) | (uint32_t)key;
    }
}

static inline int32_t fp_find(const int64_t *A, const uint64_t *tab,
                              uint64_t tmask, int wide, uint64_t key) {
    uint32_t fp = (uint32_t)key;
    uint64_t h = mix64(key) & tmask;
    for (;;) {
        uint64_t e = tab[h];
        if (!e) return -1;
        if ((uint32_t)e == fp) {
            int32_t idx = (int32_t)((e >> 32) - 1);
            if (!wide || A[idx] == (int64_t)key) return idx;
        }
        h = (h + 1) & tmask;
    }
}

/* Side tables, fp edition: same contract as kmerio_side_tables_merge but
 * the hash table is uint64[1 << logcap] ZEROED by the caller, probes are
 * single-read, and the candidate arrays are fused into the loops (the
 * q/qr temporaries cost ~2 GB of traffic per call at 29M k-mers). */
long kmerio_side_tables_fp(const int64_t *A, long n, int k, int canonical,
                           uint64_t *tab, int logcap,
                           int32_t *rdeg, int32_t *rnbr, uint8_t *rsame,
                           int32_t *ldeg, int32_t *lnbr, uint8_t *lsame) {
    if (n <= 0) return 0;
    double t0 = now_s();
    if (canonical) fp_build(A, n, tab, logcap);
    TLOG("side_tables_fp: build: %.2fs\n", now_s() - t0);
    double t_probe = 0, t_merge = 0, tx;
    const uint64_t kmask = (1ULL << (2 * k)) - 1;
    const uint64_t tmask = (1ULL << logcap) - 1;
    const int wide = (2 * k) > 32;
    memset(rdeg, 0, (size_t)n * 4); memset(ldeg, 0, (size_t)n * 4);
    memset(rnbr, 0, (size_t)n * 4); memset(lnbr, 0, (size_t)n * 4);
    memset(rsame, 0, (size_t)n);    memset(lsame, 0, (size_t)n);
    enum { PD = 32 };
    long class_lo[5];
    for (int b = 0; b < 4; b++)
        class_lo[b] = lower_bound64(A, n, (int64_t)((uint64_t)b << (2 * k - 2)));
    class_lo[4] = n;
    for (int side = 0; side < 2; side++) {
        int32_t *deg = side ? ldeg : rdeg;
        int32_t *nbr = side ? lnbr : rnbr;
        uint8_t *same = side ? lsame : rsame;
        for (int c = 0; c < 4; c++) {
            #define CAND(i)                                                  \
                (side ? (((uint64_t)A[i] >> 2) |                             \
                         ((uint64_t)c << (2 * (k - 1))))                     \
                      : ((((uint64_t)A[i] << 2) | (uint64_t)c) & kmask))
            tx = now_s();
            if (canonical) {
                /* rc-canonical candidates: fp probes (latency-bound). */
                #pragma omp parallel for schedule(static)
                for (long i = 0; i < n; i++) {
                    if (i + PD < n) {
                        uint64_t cp = CAND(i + PD);
                        uint64_t qp = rc_one(cp, k);
                        if (qp < cp)
                            __builtin_prefetch(&tab[mix64(qp) & tmask]);
                    }
                    uint64_t cand = CAND(i);
                    uint64_t qr = rc_one(cand, k);
                    if (qr >= cand) continue;
                    if ((int64_t)qr == A[i]) continue; /* self loop */
                    int32_t idx = fp_find(A, tab, tmask, wide, qr);
                    if (idx >= 0) {
                        if (deg[i] == 0) { nbr[i] = idx; same[i] = 1; }
                        deg[i]++;
                    }
                }
            }
            t_probe += now_s() - tx;
            tx = now_s();
            /* direct candidates: two-pointer merges over sorted runs. */
            if (side == 0) {
                #pragma omp parallel for schedule(static)
                for (int b = 0; b < 4; b++) {
                    long j = 0;
                    for (long i = class_lo[b]; i < class_lo[b + 1]; i++) {
                        uint64_t cand = CAND(i);
                        if (canonical && rc_one(cand, k) < cand) continue;
                        int64_t v = (int64_t)cand;
                        while (j < n && A[j] < v) j++;
                        if (j >= n) break;
                        if (A[j] == v && v != A[i]) {
                            if (deg[i] == 0) { nbr[i] = (int32_t)j; }
                            deg[i]++;
                        }
                    }
                }
            } else {
                long j = 0;
                for (long i = 0; i < n; i++) {
                    uint64_t cand = CAND(i);
                    if (canonical && rc_one(cand, k) < cand) continue;
                    int64_t v = (int64_t)cand;
                    while (j < n && A[j] < v) j++;
                    if (j >= n) break;
                    if (A[j] == v && v != A[i]) {
                        if (deg[i] == 0) { nbr[i] = (int32_t)j; }
                        deg[i]++;
                    }
                }
            }
            t_merge += now_s() - tx;
            #undef CAND
        }
    }
    TLOG("side_tables_fp: probes: %.2fs  merges: %.2fs\n", t_probe, t_merge);
    return 0;
}

/* Oriented successor array from device-shipped per-entity side codes —
 * the slow-link wire format of the count->graph fusion (1 byte/k-mer
 * instead of the 8-byte succ + 3 mask bytes; ops/unitigs.py
 * device_unitig_sides).  Byte layout: bit0 term_r, bits1-2 base_r,
 * bit3 same_r, bit4 term_l, bits5-6 base_l, bit7 same_l.  For each
 * non-terminal side the canonical neighbor VALUE is recomputed from
 * (base, same) and resolved to its sorted-array index with one fp
 * probe (reference successor semantics: lib/core/spss.h:276-313,
 * 394-423):
 *   right: cand = ((A[i] << 2) | base_r) & mask(2k)
 *          succ[2i]   = 2*idx(same_r ? rc(cand) : cand) + same_r
 *   left:  cand = (A[i] >> 2) | base_l << (2k-2)
 *          succ[2i+1] = 2*idx(same_l ? rc(cand) : cand) + !same_l
 * tab: uint64[1 << logcap], ZEROED by the caller.  Returns 0, or -1
 * when any probe misses (stale/corrupt sides): callers fall back to
 * the full host side tables instead of walking a wrong graph. */
long kmerio_succ_from_sides(const int64_t *A, long n, int k,
                            const uint8_t *sides, uint64_t *tab, int logcap,
                            int64_t *succ) {
    if (n <= 0) return 0;
    fp_build(A, n, tab, logcap);
    const uint64_t kmask = (1ULL << (2 * k)) - 1;
    const uint64_t tmask = (1ULL << logcap) - 1;
    const int wide = (2 * k) > 32;
    enum { PD = 24 };
    long bad = 0;
    #pragma omp parallel for schedule(static) reduction(+:bad)
    for (long i = 0; i < n; i++) {
        if (i + PD < n) {
            uint8_t sp = sides[i + PD];
            uint64_t ap = (uint64_t)A[i + PD];
            if (!(sp & 1)) {
                uint64_t cp = ((ap << 2) | (uint64_t)((sp >> 1) & 3)) & kmask;
                uint64_t vp = (sp & 8) ? rc_one(cp, k) : cp;
                __builtin_prefetch(&tab[mix64(vp) & tmask]);
            }
            if (!(sp & 16)) {
                uint64_t cp = (ap >> 2) |
                              ((uint64_t)((sp >> 5) & 3) << (2 * (k - 1)));
                uint64_t vp = (sp & 128) ? rc_one(cp, k) : cp;
                __builtin_prefetch(&tab[mix64(vp) & tmask]);
            }
        }
        uint8_t s = sides[i];
        uint64_t a = (uint64_t)A[i];
        if (s & 1) {
            succ[2 * i] = -1;
        } else {
            uint64_t cand = ((a << 2) | (uint64_t)((s >> 1) & 3)) & kmask;
            int same = (s >> 3) & 1;
            uint64_t v = same ? rc_one(cand, k) : cand;
            int32_t idx = fp_find(A, tab, tmask, wide, v);
            if (idx < 0) { bad++; succ[2 * i] = -1; }
            else succ[2 * i] = 2 * (int64_t)idx + same;
        }
        if (s & 16) {
            succ[2 * i + 1] = -1;
        } else {
            uint64_t cand = (a >> 2) |
                            ((uint64_t)((s >> 5) & 3) << (2 * (k - 1)));
            int same = (s >> 7) & 1;
            uint64_t v = same ? rc_one(cand, k) : cand;
            int32_t idx = fp_find(A, tab, tmask, wide, v);
            if (idx < 0) { bad++; succ[2 * i + 1] = -1; }
            else succ[2 * i + 1] = 2 * (int64_t)idx + (same ^ 1);
        }
    }
    return bad ? -1 : 0;
}


/* First-occurrence dedup of undirected port edges in discovery order —
 * the native replacement of core/spss._dedup_port_edges' numpy
 * unique-with-index (a full sort + stable argsort over ~4 entries per
 * undirected edge; measured 1.8-3.9 s at 6M edges on the eval host vs
 * one hash pass here).  Each edge's key is (min << 32) | max of its two
 * port ids (caller guarantees ports < 2^32 and a != b, so key != 0 and
 * the zero slot can mark empties).  out_idx receives the indices of
 * first occurrences, ascending (= the discovery-priority order the
 * greedy matching consumes).  tab: uint64[1 << logcap] zeroed by the
 * caller, logcap sized for < 50% load.  Returns the kept count. */
long kmerio_dedup_edges(const int64_t *a, const int64_t *b, long m,
                        uint64_t *tab, int logcap, int64_t *out_idx) {
    const uint64_t tmask = (1ULL << logcap) - 1;
    enum { PD = 16 };
    long cnt = 0;
    for (long i = 0; i < m; i++) {
        if (i + PD < m) {
            uint64_t la = (uint64_t)a[i + PD], lb = (uint64_t)b[i + PD];
            uint64_t kp = la < lb ? (la << 32) | lb : (lb << 32) | la;
            __builtin_prefetch(&tab[mix64(kp) & tmask]);
        }
        uint64_t la = (uint64_t)a[i], lb = (uint64_t)b[i];
        uint64_t key = la < lb ? (la << 32) | lb : (lb << 32) | la;
        /* key == 0 (the edge (0,0)) would alias the empty-slot marker
         * and be emitted once per occurrence.  Current callers filter
         * self-edges so it cannot happen, but that precondition lives
         * at the call sites — refuse instead of deduping wrongly. */
        if (key == 0) return -1;
        uint64_t h = mix64(key) & tmask;
        for (;;) {
            uint64_t e = tab[h];
            if (!e) {
                tab[h] = key;
                out_idx[cnt++] = i;
                break;
            }
            if (e == key) break; /* seen: keep the first occurrence */
            h = (h + 1) & tmask;
        }
    }
    return cnt;
}


/* --- cache-blocked (radix-partitioned) probe edition ---------------------
 *
 * The fp edition above is latency-bound: every probe is one random read
 * into a table far larger than cache, and the prefetch distance only
 * buys a few overlapping misses.  This edition makes the probe stream
 * CACHE-RESIDENT instead (the classic partitioned hash join): all
 * rc-probe candidates are radix-partitioned by the high bits of their
 * SLOT index into per-region blocks (one streaming pass into strided
 * per-bucket areas — no separate counting pass), then each table region
 * is probed by its whole block while it sits in L2.  Hits carry their
 * origin and are re-partitioned by origin block before application, so
 * the write-back is cache-resident too.  The table build is partitioned
 * the same way.
 *
 * Candidate generation is algebraic, not per-candidate bit-reversal:
 * with r = rc(a),  rc(next(a, c)) = ((3-c) << (2k-2)) | (r >> 2)  and
 * rc(prev(a, c)) = ((r << 2) & kmask) | (3-c), so one rc per k-mer
 * (precomputed once) replaces the 8 per-candidate reversals, and the
 * right-side direct merges of all four extensions collapse into one
 * scan (the four candidates are consecutive integers).
 *
 * Outputs are bit-identical to kmerio_side_tables_fp: within one (i, c)
 * at most one of {rc-probe, direct-merge} can find a neighbor, so
 * "first found in c order" is reproduced exactly by a per-(i, side)
 * best-c register, which is application-order-independent.
 * (Reference semantics being reproduced: lib/core/spss.h:238-313.)
 */

#define PART_ALIGN8(x) (((x) + 7) & ~(long)7)

/* Sizing shared by the wrapper and the function: per-side probe
 * capacity with slack (expected rc-canonical fraction is ~1/2 of the 4n
 * per-side candidates; overflow returns -4 and the caller falls back),
 * bucket stride, and build stride. */
static void part_layout(long n, int logcap, long *nb_out, long *pcb_out,
                        long *bcb_out) {
    int nb_bits = logcap - 16;  /* 512 KB table regions */
    if (nb_bits < 0) nb_bits = 0;
    if (nb_bits > 12) nb_bits = 12;
    long NB = 1L << nb_bits;
    *nb_out = NB;
    *pcb_out = (2 * n + n / 4) / NB + 1024;  /* probe cap per bucket */
    *bcb_out = n / NB + n / (8 * NB) + 1024; /* build cap per bucket */
}

long kmerio_side_part_scratch(long n, int logcap) {
    long NB, pcb, bcb;
    part_layout(n, logcap, &NB, &pcb, &bcb);
    long pcap = NB * pcb, bcap = NB * bcb;
    /* rca + (qr,org,sc,hidx) + (happ org/idx/sc) + build (key,idx)
     * + bestc + counters */
    /* trailing counters: cur[4096] + hcnt[4096] + blkoff[257] */
    return 8 * n + (8 + 4 + 1 + 4) * pcap
           + (8 + 4) * bcap + 2 * n + (4096 + 4096 + 257) * 8 + 128;
}

long kmerio_side_tables_part(const int64_t *A, long n, int k, int canonical,
                             uint64_t *tab, int logcap,
                             uint8_t *scratch, int64_t scratch_bytes,
                             int32_t *rdeg, int32_t *rnbr, uint8_t *rsame,
                             int32_t *ldeg, int32_t *lnbr, uint8_t *lsame) {
    if (n <= 0) return 0;
    if (!canonical) return -2;  /* directed case never probes: use _fp */
    if (scratch_bytes < kmerio_side_part_scratch(n, logcap)) return -3;
    const uint64_t kmask = (1ULL << (2 * k)) - 1;
    const uint64_t tmask = (1ULL << logcap) - 1;
    const int wide = (2 * k) > 32;
    long NB, pcb, bcb;
    part_layout(n, logcap, &NB, &pcb, &bcb);
    const int bshift = (logcap - __builtin_ctzl(NB) > 0)
                           ? (logcap - __builtin_ctzl(NB)) : 0;
    const long pcap = NB * pcb, bcap = NB * bcb;

    long off = 0;
    int64_t *rca = (int64_t *)(scratch + off); off += 8 * n;
    int64_t *qr = (int64_t *)(scratch + off); off += 8 * pcap;
    int32_t *org = (int32_t *)(scratch + off); off += 4 * pcap;
    int32_t *hidx = (int32_t *)(scratch + off); off += 4 * pcap;
    uint8_t *sc = scratch + off; off = PART_ALIGN8(off + pcap);
    /* The origin-block re-partition reuses qr (free after the probes):
     * one packed (org << 33 | c << 31 | idx) entry per hit. */
    int64_t *happ = qr;
    int64_t *bkey = (int64_t *)(scratch + off); off += 8 * bcap;
    int32_t *bidx = (int32_t *)(scratch + off); off = PART_ALIGN8(off + 4 * bcap);
    uint8_t *bestc = scratch + off; off = PART_ALIGN8(off + 2 * n);
    int64_t *cur = (int64_t *)(scratch + off); off += 4096 * 8;
    int64_t *hcnt = (int64_t *)(scratch + off); off += 4096 * 8;
    int64_t *blkoff = (int64_t *)(scratch + off); off += 257 * 8;

    double t0 = now_s();
    /* rc of every k-mer, once. */
    #pragma omp parallel for schedule(static)
    for (long i = 0; i < n; i++) rca[i] = (int64_t)rc_one((uint64_t)A[i], k);

    /* --- partitioned table build (strided, single pass) --- */
    for (long b = 0; b < NB; b++) cur[b] = b * bcb;
    for (long i = 0; i < n; i++) {
        long b = (long)((mix64((uint64_t)A[i]) & tmask) >> bshift);
        long w = cur[b]++;
        if (w >= (b + 1) * bcb) return -4;
        bkey[w] = A[i]; bidx[w] = (int32_t)i;
    }
    for (long b = 0; b < NB; b++) {
        for (long e = b * bcb; e < cur[b]; e++) {
            uint64_t key = (uint64_t)bkey[e];
            uint64_t h = mix64(key) & tmask;
            while (tab[h]) h = (h + 1) & tmask;
            tab[h] = (((uint64_t)(bidx[e] + 1)) << 32) | (uint32_t)key;
        }
    }
    TLOG("side_tables_part: rc+build: %.2fs\n", now_s() - t0);

    memset(rdeg, 0, (size_t)n * 4); memset(ldeg, 0, (size_t)n * 4);
    memset(rnbr, 0, (size_t)n * 4); memset(lnbr, 0, (size_t)n * 4);
    memset(rsame, 0, (size_t)n);    memset(lsame, 0, (size_t)n);
    memset(bestc, 0xFF, (size_t)n * 2);

    long class_lo[5];
    for (int b = 0; b < 4; b++)
        class_lo[b] = lower_bound64(A, n, (int64_t)((uint64_t)b << (2 * k - 2)));
    class_lo[4] = n;

    for (int side = 0; side < 2; side++) {
        int32_t *deg = side ? ldeg : rdeg;
        int32_t *nbr = side ? lnbr : rnbr;
        uint8_t *same = side ? lsame : rsame;
        uint8_t *bc = bestc + (size_t)side * n;

        /* --- rc-candidate partition: one strided streaming pass --- */
        t0 = now_s();
        for (long b = 0; b < NB; b++) cur[b] = b * pcb;
        for (long i = 0; i < n; i++) {
            uint64_t a = (uint64_t)A[i], r = (uint64_t)rca[i];
            for (int c = 0; c < 4; c++) {
                uint64_t cand, v;
                if (side) {
                    cand = (a >> 2) | ((uint64_t)c << (2 * (k - 1)));
                    v = ((r << 2) & kmask) | (uint64_t)(3 - c);
                } else {
                    cand = ((a << 2) | (uint64_t)c) & kmask;
                    v = ((uint64_t)(3 - c) << (2 * (k - 1))) | (r >> 2);
                }
                if (v < cand && v != a) {
                    long b = (long)((mix64(v) & tmask) >> bshift);
                    long w = cur[b]++;
                    if (w >= (b + 1) * pcb) return -4;
                    qr[w] = (int64_t)v; org[w] = (int32_t)i;
                    sc[w] = (uint8_t)c;
                }
            }
        }
        TLOG("side_tables_part: partition[%d]: %.2fs\n", side, now_s() - t0);

        /* --- cache-resident probes; hits compact in place per bucket --- */
        t0 = now_s();
        #pragma omp parallel for schedule(dynamic, 1)
        for (long b = 0; b < NB; b++) {
            long w = b * pcb;
            for (long e = b * pcb; e < cur[b]; e++) {
                int32_t idx = fp_find(A, tab, tmask, wide, (uint64_t)qr[e]);
                if (idx >= 0) {
                    org[w] = org[e]; sc[w] = sc[e]; hidx[w] = idx; w++;
                }
            }
            hcnt[b] = w - b * pcb;
        }
        TLOG("side_tables_part: probes[%d]: %.2fs\n", side, now_s() - t0);

        /* --- re-partition hits by origin block, then apply --- */
        t0 = now_s();
        int blk_shift = 0;
        while ((((n - 1) >> blk_shift) + 1) > 256) blk_shift++;
        const long NBLK = ((n - 1) >> blk_shift) + 1;  /* <= 256 */
        memset(blkoff, 0, (NBLK + 1) * 8);
        for (long b = 0; b < NB; b++)
            for (long e = b * pcb; e < b * pcb + hcnt[b]; e++)
                blkoff[1 + (org[e] >> blk_shift)]++;
        for (long t = 0; t < NBLK; t++) blkoff[t + 1] += blkoff[t];
        for (long b = 0; b < NB; b++)
            for (long e = b * pcb; e < b * pcb + hcnt[b]; e++) {
                long w = blkoff[org[e] >> blk_shift]++;
                happ[w] = (int64_t)(((uint64_t)(uint32_t)org[e] << 33)
                          | ((uint64_t)sc[e] << 31)
                          | (uint64_t)(uint32_t)hidx[e]);
            }
        for (long t = NBLK; t > 0; t--) blkoff[t] = blkoff[t - 1];
        blkoff[0] = 0;
        #pragma omp parallel for schedule(dynamic, 1)
        for (long t = 0; t < NBLK; t++) {
            for (long e = blkoff[t]; e < blkoff[t + 1]; e++) {
                uint64_t h = (uint64_t)happ[e];
                long i = (long)(h >> 33);
                int c = (int)((h >> 31) & 3);
                deg[i]++;
                if ((uint8_t)c < bc[i]) {
                    bc[i] = (uint8_t)c;
                    nbr[i] = (int32_t)(h & 0x7FFFFFFF); same[i] = 1;
                }
            }
        }
        TLOG("side_tables_part: apply[%d]: %.2fs\n", side, now_s() - t0);

        /* --- direct candidates: two-pointer merges --- */
        t0 = now_s();
        if (side == 0) {
            /* The four right extensions of A[i] are the consecutive
             * values 4*A[i]..4*A[i]+3 (mod class), so one scan covers
             * all c at once. */
            #pragma omp parallel for schedule(static)
            for (int b = 0; b < 4; b++) {
                long j = 0;
                for (long i = class_lo[b]; i < class_lo[b + 1]; i++) {
                    uint64_t a = (uint64_t)A[i], r = (uint64_t)rca[i];
                    uint64_t base = (a << 2) & kmask;
                    while (j < n && A[j] < (int64_t)base) j++;
                    /* base is non-decreasing within a class (fixed top
                     * bits), so once the merge pointer exhausts A no
                     * later i in the class can match either. */
                    if (j >= n) break;
                    for (long jj = j; jj < n && (uint64_t)A[jj] <= base + 3;
                         jj++) {
                        int c = (int)((uint64_t)A[jj] - base);
                        uint64_t v = ((uint64_t)(3 - c) << (2 * (k - 1)))
                                     | (r >> 2);
                        uint64_t cand = base | (uint64_t)c;
                        if (v < cand) continue;   /* probe side handled it */
                        if (cand == a) continue;  /* self loop */
                        if ((uint8_t)c < bc[i]) {
                            bc[i] = (uint8_t)c;
                            nbr[i] = (int32_t)jj; same[i] = 0;
                        }
                        deg[i]++;
                    }
                }
            }
        } else {
            for (int c = 0; c < 4; c++) {
                long j = 0;
                for (long i = 0; i < n; i++) {
                    uint64_t a = (uint64_t)A[i], r = (uint64_t)rca[i];
                    uint64_t cand = (a >> 2)
                                    | ((uint64_t)c << (2 * (k - 1)));
                    uint64_t v = ((r << 2) & kmask) | (uint64_t)(3 - c);
                    if (v < cand) continue;
                    int64_t vv = (int64_t)cand;
                    while (j < n && A[j] < vv) j++;
                    if (j >= n) break;
                    if (A[j] == vv && vv != (int64_t)a) {
                        if ((uint8_t)c < bc[i]) {
                            bc[i] = (uint8_t)c;
                            nbr[i] = (int32_t)j; same[i] = 0;
                        }
                        deg[i]++;
                    }
                }
            }
        }
        TLOG("side_tables_part: merges[%d]: %.2fs\n", side, now_s() - t0);
    }
    return 0;
}

/* Cache-blocked edition of kmerio_succ_from_sides: same contract and
 * bit-identical output, but the ~2n fp probes stream through L2-resident
 * table regions instead of random DRAM reads (the same partitioned-join
 * trick as kmerio_side_tables_part; the fp edition above measures
 * ~1.0-1.2 s at 16.5M k-mers on the 1-vCPU eval host, almost all of it
 * probe latency).  Candidates are radix-partitioned by the high bits of
 * their hash slot in one strided streaming pass, each region is probed
 * while it sits in cache, and hits are re-partitioned by origin block so
 * the succ write-back is cache-resident too.  Returns 0, -1 on any probe
 * miss (caller falls back to the full host side tables), -3 when scratch
 * is too small. */
long kmerio_succ_part_scratch(long n, int logcap) {
    long NB, pcb, bcb;
    part_layout(n, logcap, &NB, &pcb, &bcb);
    long pcap = NB * pcb, bcap = NB * bcb;
    /* (qr 8 + org 4 + sc 1 + hidx 4) per probe slot, (bkey 8 + bidx 4)
     * per build slot, counters, alignment slack */
    return (8 + 4 + 1 + 4) * pcap + (8 + 4) * bcap
           + (4096 + 4096 + 257) * 8 + 128;
}

long kmerio_succ_from_sides_part(const int64_t *A, long n, int k,
                                 const uint8_t *sides,
                                 uint64_t *tab, int logcap,
                                 uint8_t *scratch, int64_t scratch_bytes,
                                 int64_t *succ) {
    if (n <= 0) return 0;
    if (scratch_bytes < kmerio_succ_part_scratch(n, logcap)) return -3;
    const uint64_t kmask = (1ULL << (2 * k)) - 1;
    const uint64_t tmask = (1ULL << logcap) - 1;
    const int wide = (2 * k) > 32;
    long NB, pcb, bcb;
    part_layout(n, logcap, &NB, &pcb, &bcb);
    const int bshift = (logcap - __builtin_ctzl(NB) > 0)
                           ? (logcap - __builtin_ctzl(NB)) : 0;
    const long pcap = NB * pcb, bcap = NB * bcb;

    long off = 0;
    int64_t *qr = (int64_t *)(scratch + off); off += 8 * pcap;
    int32_t *org = (int32_t *)(scratch + off); off += 4 * pcap;
    int32_t *hidx = (int32_t *)(scratch + off); off += 4 * pcap;
    uint8_t *sc = scratch + off; off = PART_ALIGN8(off + pcap);
    /* origin re-partition reuses qr (free after the probes) */
    int64_t *happ = qr;
    int64_t *bkey = (int64_t *)(scratch + off); off += 8 * bcap;
    int32_t *bidx = (int32_t *)(scratch + off); off = PART_ALIGN8(off + 4 * bcap);
    int64_t *cur = (int64_t *)(scratch + off); off += 4096 * 8;
    int64_t *hcnt = (int64_t *)(scratch + off); off += 4096 * 8;
    int64_t *blkoff = (int64_t *)(scratch + off); off += 257 * 8;

    double t0 = now_s();
    /* --- partitioned table build (strided, single pass) --- */
    for (long b = 0; b < NB; b++) cur[b] = b * bcb;
    for (long i = 0; i < n; i++) {
        long b = (long)((mix64((uint64_t)A[i]) & tmask) >> bshift);
        long w = cur[b]++;
        if (w >= (b + 1) * bcb) return -4;
        bkey[w] = A[i]; bidx[w] = (int32_t)i;
    }
    for (long b = 0; b < NB; b++) {
        for (long e = b * bcb; e < cur[b]; e++) {
            uint64_t key = (uint64_t)bkey[e];
            uint64_t h = mix64(key) & tmask;
            while (tab[h]) h = (h + 1) & tmask;
            tab[h] = (((uint64_t)(bidx[e] + 1)) << 32) | (uint32_t)key;
        }
    }
    TLOG("succ_part: build: %.2fs\n", now_s() - t0);

    memset(succ, 0xFF, (size_t)n * 2 * sizeof(int64_t)); /* all -1 */

    /* --- candidate partition: one strided streaming pass, both sides.
     * rc is algebraic off one per-k-mer reverse complement, computed
     * lazily (only same-side candidates need it):
     *   rc(next(a, c)) = ((3-c) << (2k-2)) | (rc(a) >> 2)
     *   rc(prev(a, c)) = ((rc(a) << 2) & kmask) | (3-c)            --- */
    t0 = now_s();
    for (long b = 0; b < NB; b++) cur[b] = b * pcb;
    for (long i = 0; i < n; i++) {
        uint8_t s = sides[i];
        if ((s & 1) && (s & 16)) continue;  /* both sides terminal */
        uint64_t a = (uint64_t)A[i];
        uint64_t r = ((s & 8) && !(s & 1)) || ((s & 128) && !(s & 16))
                         ? rc_one(a, k) : 0;
        if (!(s & 1)) {
            int c = (s >> 1) & 3;
            int same = (s >> 3) & 1;
            uint64_t v = same
                ? (((uint64_t)(3 - c) << (2 * (k - 1))) | (r >> 2))
                : (((a << 2) | (uint64_t)c) & kmask);
            long b = (long)((mix64(v) & tmask) >> bshift);
            long w = cur[b]++;
            if (w >= (b + 1) * pcb) return -4;
            qr[w] = (int64_t)v; org[w] = (int32_t)i;
            sc[w] = (uint8_t)same;  /* side 0: bit1 clear */
        }
        if (!(s & 16)) {
            int c = (s >> 5) & 3;
            int same = (s >> 7) & 1;
            uint64_t v = same
                ? (((r << 2) & kmask) | (uint64_t)(3 - c))
                : ((a >> 2) | ((uint64_t)c << (2 * (k - 1))));
            long b = (long)((mix64(v) & tmask) >> bshift);
            long w = cur[b]++;
            if (w >= (b + 1) * pcb) return -4;
            qr[w] = (int64_t)v; org[w] = (int32_t)i;
            sc[w] = (uint8_t)(2 | same);  /* side 1: bit1 set */
        }
    }
    TLOG("succ_part: partition: %.2fs\n", now_s() - t0);

    /* --- cache-resident probes; hits compact in place per bucket --- */
    t0 = now_s();
    long bad = 0;
    #pragma omp parallel for schedule(dynamic, 1) reduction(+:bad)
    for (long b = 0; b < NB; b++) {
        long w = b * pcb;
        for (long e = b * pcb; e < cur[b]; e++) {
            int32_t idx = fp_find(A, tab, tmask, wide, (uint64_t)qr[e]);
            if (idx < 0) { bad++; continue; }
            org[w] = org[e]; sc[w] = sc[e]; hidx[w] = idx; w++;
        }
        hcnt[b] = w - b * pcb;
    }
    TLOG("succ_part: probes: %.2fs\n", now_s() - t0);
    if (bad) return -1;  /* stale/corrupt sides: never walk a wrong graph */

    /* --- re-partition hits by origin block, then write succ ---
     * packed entry: (slot << 32) | succ_val with slot = 2i+side < 2^32
     * and succ_val = 2*idx + (side ? !same : same) < 2^32. */
    t0 = now_s();
    int blk_shift = 0;
    while ((((2 * n - 1) >> blk_shift) + 1) > 256) blk_shift++;
    const long NBLK = ((2 * n - 1) >> blk_shift) + 1; /* <= 256 */
    memset(blkoff, 0, (NBLK + 1) * 8);
    for (long b = 0; b < NB; b++)
        for (long e = b * pcb; e < b * pcb + hcnt[b]; e++) {
            long slot = 2 * (long)org[e] + ((sc[e] >> 1) & 1);
            blkoff[1 + (slot >> blk_shift)]++;
        }
    for (long t = 0; t < NBLK; t++) blkoff[t + 1] += blkoff[t];
    for (long b = 0; b < NB; b++)
        for (long e = b * pcb; e < b * pcb + hcnt[b]; e++) {
            int side = (sc[e] >> 1) & 1;
            int same = sc[e] & 1;
            long slot = 2 * (long)org[e] + side;
            uint64_t sval = 2 * (uint64_t)(uint32_t)hidx[e]
                            + (uint64_t)(side ? (same ^ 1) : same);
            long w = blkoff[slot >> blk_shift]++;
            happ[w] = (int64_t)(((uint64_t)slot << 32) | sval);
        }
    for (long t = NBLK; t > 0; t--) blkoff[t] = blkoff[t - 1];
    blkoff[0] = 0;
    #pragma omp parallel for schedule(dynamic, 1)
    for (long t = 0; t < NBLK; t++) {
        for (long e = blkoff[t]; e < blkoff[t + 1]; e++) {
            uint64_t h = (uint64_t)happ[e];
            succ[h >> 32] = (int64_t)(h & 0xFFFFFFFFULL);
        }
    }
    TLOG("succ_part: apply: %.2fs\n", now_s() - t0);
    return 0;
}

/* Reference-style canonical k-mer counter: rolling window + rolling
 * reverse complement + open-addressing hash count.  This reproduces the
 * reference's counting hot loop (lib/core/kmer_counter.h:80-133: per
 * window canonicalize, hash-bucket insert) single-threaded, as the
 * honest CPU baseline for bench.py.  table holds packed
 * (count << 48 | key) entries, 0 = empty (key 0 offset by +1).
 * Returns the number of distinct canonical k-mers.
 */
long kmerio_count_hash(const uint8_t *codes, long n, int k,
                       uint64_t *table, int logcap) {
    if (n < k) return 0;
    const uint64_t kmask = (1ULL << (2 * k)) - 1;
    const uint64_t tmask = (1ULL << logcap) - 1;
    const uint64_t KEYMASK = (1ULL << 48) - 1;
    uint64_t fwd = 0, rc = 0;
    long uniq = 0;
    for (long i = 0; i < k - 1; i++) {
        fwd = ((fwd << 2) | codes[i]) & kmask;
        rc = (rc >> 2) | ((uint64_t)(3 - codes[i]) << (2 * (k - 1)));
    }
    for (long i = k - 1; i < n; i++) {
        fwd = ((fwd << 2) | codes[i]) & kmask;
        rc = (rc >> 2) | ((uint64_t)(3 - codes[i]) << (2 * (k - 1)));
        uint64_t can = fwd < rc ? fwd : rc;
        uint64_t stored = can + 1; /* reserve 0 for empty */
        uint64_t h = mix64(can) & tmask;
        for (;;) {
            uint64_t e = table[h];
            if (e == 0) {
                table[h] = (1ULL << 48) | stored;
                uniq++;
                break;
            }
            if ((e & KEYMASK) == stored) {
                if ((e >> 48) != 0xFFFFULL) table[h] = e + (1ULL << 48);
                break;
            }
            h = (h + 1) & tmask;
        }
    }
    return uniq;
}

/* --- unitig (k-1)-overlap port edges ------------------------------------
 *
 * The reference finds unitig gluing candidates through hash multimaps of
 * unitig prefixes/suffixes (reference: lib/core/spss.h:619-695,
 * 1057-1145).  This is that design in C for the canonical (bidirected)
 * graph: probe next(suffix)/prev(prefix) and their reverse complements
 * against multimaps of first/last k-mers, emitting (port_a, port_b)
 * pairs in the same discovery-priority order as the vectorized host
 * join (core/spss.py::_candidate_port_edges_canonical).
 *
 * Multimap = open addressing, duplicates allowed; probing continues past
 * matches until an empty slot so every duplicate is found, in insertion
 * (= ascending id) order.
 *
 * Two-phase API: call with out == NULL to count, then with the buffer.
 */

static void mm_build(const int64_t *keys, long n, int64_t *table, int logcap) {
    const uint64_t mask = (1ULL << logcap) - 1;
    for (long i = 0; i < n; i++) {
        uint64_t h = mix64((uint64_t)keys[i]) & mask;
        while (table[h] != -1) h = (h + 1) & mask;
        table[h] = i;
    }
}

static long mm_probe_emit(const int64_t *keys, const int64_t *table,
                          int logcap, int64_t q, int64_t a_port,
                          int dst_side_bit, long skip_id,
                          int64_t *out, long pos) {
    const uint64_t mask = (1ULL << logcap) - 1;
    uint64_t h = mix64((uint64_t)q) & mask;
    for (;;) {
        int64_t j = table[h];
        if (j == -1) return pos;
        if (keys[j] == q && j != skip_id) {
            if (out) {
                out[2 * pos] = a_port;
                out[2 * pos + 1] = 2 * j + dst_side_bit;
            }
            pos++;
        }
        h = (h + 1) & mask;
    }
}

/* P/S: first/last k-mers of the n unitigs.  ptab/stab: int64[1<<logcap]
 * filled with -1 on first call (count pass builds them; fill pass reuses).
 * out: NULL to count, else int64[2 * count].  Returns the edge count. */
long kmerio_overlap_edges(const int64_t *P, const int64_t *S, long n, int k,
                          int64_t *ptab, int64_t *stab, int logcap,
                          int build, int64_t *out) {
    const uint64_t kmask = (1ULL << (2 * k)) - 1;
    if (build) {
        mm_build(P, n, ptab, logcap);
        mm_build(S, n, stab, logcap);
    }
    long pos = 0;
    /* Discovery order matches the vectorized host join exactly (all rows
     * of one join type per base, core/spss.py): (c: nextP*, nextS*),
     * then (c: prevS*, prevP*) — matching priority, and therefore the
     * greedy result, is identical with or without the native lib. */
    for (int c = 0; c < 4; c++) {
        for (long i = 0; i < n; i++) {
            uint64_t q = (((uint64_t)S[i] << 2) | (uint64_t)c) & kmask;
            /* right(i) -- left(j): suffix_next == prefix(j) */
            pos = mm_probe_emit(P, ptab, logcap, (int64_t)q, 2 * i, 1, i, out, pos);
        }
        for (long i = 0; i < n; i++) {
            uint64_t q = (((uint64_t)S[i] << 2) | (uint64_t)c) & kmask;
            /* right(i) -- right(j): rc(suffix_next) == suffix(j) */
            pos = mm_probe_emit(S, stab, logcap, (int64_t)rc_one(q, k), 2 * i, 0,
                                i, out, pos);
        }
    }
    for (int c = 0; c < 4; c++) {
        for (long i = 0; i < n; i++) {
            uint64_t r = ((uint64_t)P[i] >> 2) |
                         ((uint64_t)c << (2 * (k - 1)));
            /* left(i) -- right(j): prefix_prev == suffix(j) */
            pos = mm_probe_emit(S, stab, logcap, (int64_t)r, 2 * i + 1, 0, i,
                                out, pos);
        }
        for (long i = 0; i < n; i++) {
            uint64_t r = ((uint64_t)P[i] >> 2) |
                         ((uint64_t)c << (2 * (k - 1)));
            /* left(i) -- left(j): rc(prefix_prev) == prefix(j) */
            pos = mm_probe_emit(P, ptab, logcap, (int64_t)rc_one(r, k),
                                2 * i + 1, 1, i, out, pos);
        }
    }
    return pos;
}

static long mm_probe_emit_cap(const int64_t *keys, const int64_t *table,
                              int logcap, int64_t q, int64_t a_port,
                              int dst_side_bit, long skip_id,
                              int64_t *out, long pos, long cap) {
    const uint64_t mask = (1ULL << logcap) - 1;
    uint64_t h = mix64((uint64_t)q) & mask;
    for (;;) {
        int64_t j = table[h];
        if (j == -1) return pos;
        if (keys[j] == q && j != skip_id) {
            if (pos >= cap) return -1;
            out[2 * pos] = a_port;
            out[2 * pos + 1] = 2 * j + dst_side_bit;
            pos++;
        }
        h = (h + 1) & mask;
    }
}

/* Single-pass edition: emits into a caller-sized buffer and returns -1
 * on overflow (the caller then falls back to the two-pass count+fill
 * API above) — the count pass re-ran every probe, doubling the
 * latency-bound work of the phase.  Table arrays must be fresh (-1). */
long kmerio_overlap_edges_cap(const int64_t *P, const int64_t *S, long n,
                              int k, int64_t *ptab, int64_t *stab,
                              int logcap, long cap, int64_t *out) {
    const uint64_t kmask = (1ULL << (2 * k)) - 1;
    double t0 = now_s();
    mm_build(P, n, ptab, logcap);
    mm_build(S, n, stab, logcap);
    TLOG("overlap_edges: mm_build: %.2fs\n", now_s() - t0);
    t0 = now_s();
    long pos = 0;
    #define EMIT(keys, tab, q, a_port, bit, skip)                          \
        do {                                                               \
            pos = mm_probe_emit_cap(keys, tab, logcap, (int64_t)(q),       \
                                    a_port, bit, skip, out, pos, cap);     \
            if (pos < 0) return -1;                                        \
        } while (0)
    enum { OPD = 32 };
    const uint64_t tmask = (1ULL << logcap) - 1;
    #define PF(tab, qexpr)                                                 \
        do {                                                               \
            if (i + OPD < n)                                               \
                __builtin_prefetch(&(tab)[mix64((uint64_t)(qexpr)) & tmask]); \
        } while (0)
    for (int c = 0; c < 4; c++) {
        for (long i = 0; i < n; i++) {
            PF(ptab, ((((uint64_t)S[i + OPD] << 2) | (uint64_t)c) & kmask));
            uint64_t q = (((uint64_t)S[i] << 2) | (uint64_t)c) & kmask;
            EMIT(P, ptab, q, 2 * i, 1, i);
        }
        for (long i = 0; i < n; i++) {
            PF(stab, rc_one((((uint64_t)S[i + OPD] << 2) | (uint64_t)c) & kmask, k));
            uint64_t q = (((uint64_t)S[i] << 2) | (uint64_t)c) & kmask;
            EMIT(S, stab, rc_one(q, k), 2 * i, 0, i);
        }
    }
    for (int c = 0; c < 4; c++) {
        for (long i = 0; i < n; i++) {
            PF(stab, (((uint64_t)P[i + OPD] >> 2) |
                      ((uint64_t)c << (2 * (k - 1)))));
            uint64_t r = ((uint64_t)P[i] >> 2) |
                         ((uint64_t)c << (2 * (k - 1)));
            EMIT(S, stab, r, 2 * i + 1, 0, i);
        }
        for (long i = 0; i < n; i++) {
            PF(ptab, rc_one(((uint64_t)P[i + OPD] >> 2) |
                            ((uint64_t)c << (2 * (k - 1))), k));
            uint64_t r = ((uint64_t)P[i] >> 2) |
                         ((uint64_t)c << (2 * (k - 1)));
            EMIT(P, ptab, rc_one(r, k), 2 * i + 1, 1, i);
        }
    }
    #undef PF
    #undef EMIT
    TLOG("overlap_edges: probes: %.2fs\n", now_s() - t0);
    return pos;
}

/* Sequential greedy path-extension matching — the reference's
 * higher-quality single-threaded mode (lib/core/spss.h:1208-1356),
 * exactly mirroring the Python fallback in core/spss.py
 * (_sequential_matching): scan nodes in id order; from a free node,
 * extend a path port-to-port, always taking the first eligible
 * candidate in edge-discovery order; never close a loop with the path's
 * starting node.  CSR adjacency built in edge order so per-port
 * candidate order equals the Python list-append order.
 * match: int64[2 * n_nodes], filled with the partner port or -1.
 * Returns 0, or -1 on allocation failure (caller falls back). */
long kmerio_seq_match(const int64_t *pa, const int64_t *pb, long n_e,
                      long n_nodes, int64_t *match) {
    long n_ports = 2 * n_nodes;
    /* The CSR arrays (off/cur/dst and the port casts below) are int32;
     * past these bounds the prefix sums would wrap and write outside
     * dst — return the alloc-failure code so the caller falls back to
     * the Python path instead. */
    if (2 * n_e > (long)INT32_MAX || n_ports >= (long)INT32_MAX) return -1;
    int32_t *off = (int32_t *)malloc(((size_t)n_ports + 1) * 4);
    int32_t *cur = (int32_t *)malloc((size_t)n_ports * 4);
    int32_t *dst = (int32_t *)malloc((size_t)2 * (size_t)(n_e ? n_e : 1) * 4);
    if (!off || !cur || !dst) { free(off); free(cur); free(dst); return -1; }
    memset(off, 0, ((size_t)n_ports + 1) * 4);
    for (long e = 0; e < n_e; e++) { off[pa[e] + 1]++; off[pb[e] + 1]++; }
    for (long p = 0; p < n_ports; p++) off[p + 1] += off[p];
    memcpy(cur, off, (size_t)n_ports * 4);
    for (long e = 0; e < n_e; e++) {
        dst[cur[pa[e]]++] = (int32_t)pb[e];
        dst[cur[pb[e]]++] = (int32_t)pa[e];
    }
    for (long p = 0; p < n_ports; p++) match[p] = -1;
    for (long i = 0; i < n_nodes; i++) {
        if (match[2 * i] >= 0 || match[2 * i + 1] >= 0) continue;
        long port;
        if (off[2 * i + 1] > off[2 * i]) port = 2 * i;
        else if (off[2 * i + 2] > off[2 * i + 1]) port = 2 * i + 1;
        else continue;
        for (;;) {
            if (match[port] >= 0) break;
            long nxt = -1;
            for (long j = off[port]; j < off[port + 1]; j++) {
                long q = dst[j];
                if ((q >> 1) == i) continue; /* would loop to path start */
                if (match[q] >= 0) continue;
                nxt = q;
                break;
            }
            if (nxt < 0) break;
            match[port] = nxt;
            match[nxt] = port;
            port = nxt ^ 1;
        }
    }
    free(off); free(cur); free(dst);
    return 0;
}

/* fp-packed multimap probe: same walk/emission order as mm_probe_emit
 * (insertion = ascending id order) with one random read per slot. */
static long fpmm_probe_emit(const int64_t *keys, const uint64_t *tab,
                            uint64_t tmask, int wide, int64_t q,
                            int64_t a_port, int dst_side_bit, long skip_id,
                            int64_t *out, long pos, long cap) {
    uint32_t fp = (uint32_t)q;
    uint64_t h = mix64((uint64_t)q) & tmask;
    for (;;) {
        uint64_t e = tab[h];
        if (!e) return pos;
        if ((uint32_t)e == fp) {
            long j = (long)(e >> 32) - 1;
            if (j != skip_id && (!wide || keys[j] == q)) {
                if (pos >= cap) return -1;
                out[2 * pos] = a_port;
                out[2 * pos + 1] = 2 * j + dst_side_bit;
                pos++;
            }
        }
        h = (h + 1) & tmask;
    }
}

/* Overlap edges, fp edition: contract of kmerio_overlap_edges_cap with
 * uint64 tables ZEROED by the caller and single-read probes. */
long kmerio_overlap_edges_fp(const int64_t *P, const int64_t *S, long n,
                             int k, uint64_t *ptab, uint64_t *stab,
                             int logcap, long cap, int64_t *out) {
    const uint64_t kmask = (1ULL << (2 * k)) - 1;
    const uint64_t tmask = (1ULL << logcap) - 1;
    const int wide = (2 * k) > 32;
    double t0 = now_s();
    fp_build(P, n, ptab, logcap);
    fp_build(S, n, stab, logcap);
    TLOG("overlap_edges_fp: build: %.2fs\n", now_s() - t0);
    t0 = now_s();
    long pos = 0;
    enum { OPD = 32 };
    #define EMIT(keys, tab, q, a_port, bit, skip)                          \
        do {                                                               \
            pos = fpmm_probe_emit(keys, tab, tmask, wide, (int64_t)(q),    \
                                  a_port, bit, skip, out, pos, cap);       \
            if (pos < 0) return -1;                                        \
        } while (0)
    #define PF(tab, qexpr)                                                 \
        do {                                                               \
            if (i + OPD < n)                                               \
                __builtin_prefetch(&(tab)[mix64((uint64_t)(qexpr)) & tmask]); \
        } while (0)
    for (int c = 0; c < 4; c++) {
        for (long i = 0; i < n; i++) {
            PF(ptab, ((((uint64_t)S[i + OPD] << 2) | (uint64_t)c) & kmask));
            uint64_t q = (((uint64_t)S[i] << 2) | (uint64_t)c) & kmask;
            EMIT(P, ptab, q, 2 * i, 1, i);
        }
        for (long i = 0; i < n; i++) {
            PF(stab, rc_one((((uint64_t)S[i + OPD] << 2) | (uint64_t)c) & kmask, k));
            uint64_t q = (((uint64_t)S[i] << 2) | (uint64_t)c) & kmask;
            EMIT(S, stab, rc_one(q, k), 2 * i, 0, i);
        }
    }
    for (int c = 0; c < 4; c++) {
        for (long i = 0; i < n; i++) {
            PF(stab, (((uint64_t)P[i + OPD] >> 2) |
                      ((uint64_t)c << (2 * (k - 1)))));
            uint64_t r = ((uint64_t)P[i] >> 2) |
                         ((uint64_t)c << (2 * (k - 1)));
            EMIT(S, stab, r, 2 * i + 1, 0, i);
        }
        for (long i = 0; i < n; i++) {
            PF(ptab, rc_one(((uint64_t)P[i + OPD] >> 2) |
                            ((uint64_t)c << (2 * (k - 1))), k));
            uint64_t r = ((uint64_t)P[i] >> 2) |
                         ((uint64_t)c << (2 * (k - 1)));
            EMIT(P, ptab, rc_one(r, k), 2 * i + 1, 1, i);
        }
    }
    #undef PF
    #undef EMIT
    TLOG("overlap_edges_fp: probes: %.2fs\n", now_s() - t0);
    return pos;
}

/* Overlap edges, cache-blocked partitioned edition.  The fp edition's
 * 16n probes are random reads over two tables far larger than cache
 * (measured 1.4-1.6 s at 1.65M unitigs on the eval host); here the
 * probes are radix-partitioned by hash slot and each table region is
 * probed while cache-resident (same trick as kmerio_side_tables_part).
 * Emission order is restored by the CALLER: each hit is packed as
 * (pass << 60) | (i << 28+32-28...) — concretely ((pass << 28 | i)
 * << 32) | j — so an UNSIGNED ascending sort of the packed hits
 * reproduces the fp edition's discovery order exactly (pass-major,
 * i-minor, j-last: multimap hits of one probe walk the fp table in
 * ascending-j insertion order because fp_build inserts ascending), and
 * the caller unpacks pass/i/j with shifts alone (no division by n).
 * Returns the hit count, -1 on cap overflow, -3 when the scratch is
 * too small, -5 when i would overflow its 28-bit field. */
long kmerio_overlap_part_scratch(long n, int logcap) {
    long NB, pcb_u, bcb_u;
    part_layout(n, logcap, &NB, &pcb_u, &bcb_u);
    long pcb = 16 * n / NB + (16 * n / NB) / 8 + 1024;
    long pcap = NB * pcb;
    return (8 + 4 + 4 + 1) * pcap + 4096 * 8 + 128;
}

long kmerio_overlap_edges_part(const int64_t *P, const int64_t *S, long n,
                               int k, uint64_t *ptab, uint64_t *stab,
                               int logcap, uint8_t *scratch,
                               int64_t scratch_bytes, long cap,
                               int64_t *hits) {
    if (n <= 0) return 0;
    if (16 * n >= (1L << 31)) return -5;
    if (scratch_bytes < kmerio_overlap_part_scratch(n, logcap)) return -3;
    const uint64_t kmask = (1ULL << (2 * k)) - 1;
    const uint64_t tmask = (1ULL << logcap) - 1;
    const int wide = (2 * k) > 32;
    long NB, pcb_unused, bcb_unused;
    part_layout(n, logcap, &NB, &pcb_unused, &bcb_unused);
    const int bshift = (logcap - __builtin_ctzl(NB) > 0)
                           ? (logcap - __builtin_ctzl(NB)) : 0;
    const long pcb = 16 * n / NB + (16 * n / NB) / 8 + 1024;
    const long pcap = NB * pcb;
    if (scratch_bytes < (8 + 4 + 4 + 1) * pcap + 4096 * 8 + 128) return -3;

    long off = 0;
    int64_t *qr = (int64_t *)(scratch + off); off += 8 * pcap;
    int32_t *rank = (int32_t *)(scratch + off); off += 4 * pcap;
    int32_t *org = (int32_t *)(scratch + off); off += 4 * pcap;
    uint8_t *sc = scratch + off; off = PART_ALIGN8(off + pcap);
    int64_t *cur = (int64_t *)(scratch + off); off += 4096 * 8;

    double t0 = now_s();
    fp_build(P, n, ptab, logcap);
    fp_build(S, n, stab, logcap);
    TLOG("overlap_part: build: %.2fs\n", now_s() - t0);

    /* --- candidate partition: i-major (P[i]/S[i] loaded once), rank
     * encodes the fp edition's pass-major order --- */
    t0 = now_s();
    for (long b = 0; b < NB; b++) cur[b] = b * pcb;
    for (long i = 0; i < n; i++) {
        uint64_t s = (uint64_t)S[i], p = (uint64_t)P[i];
        for (int c = 0; c < 4; c++) {
            /* pass 2c: right(i) -> prefix table, bit 1 */
            uint64_t q0 = ((s << 2) | (uint64_t)c) & kmask;
            /* pass 2c+1: right(i) -> suffix table via rc, bit 0 */
            uint64_t q1 = rc_one(q0, k);
            /* pass 8+2c: left(i) -> suffix table, bit 0 */
            uint64_t q2 = (p >> 2) | ((uint64_t)c << (2 * (k - 1)));
            /* pass 8+2c+1: left(i) -> prefix table via rc, bit 1 */
            uint64_t q3 = rc_one(q2, k);
            const uint64_t qs[4] = {q0, q1, q2, q3};
            /* sc: bit0 = table (0 ptab / 1 stab) */
            static const uint8_t tsel[4] = {0, 1, 1, 0};
            const int pass[4] = {2 * c, 2 * c + 1, 8 + 2 * c, 9 + 2 * c};
            for (int v = 0; v < 4; v++) {
                long b = (long)((mix64(qs[v]) & tmask) >> bshift);
                long w = cur[b]++;
                if (w >= (b + 1) * pcb) return -4;
                qr[w] = (int64_t)qs[v];
                rank[w] = (int32_t)(((uint32_t)pass[v] << 28)
                                    | (uint32_t)i);
                org[w] = (int32_t)i;
                sc[w] = tsel[v];
            }
        }
    }
    TLOG("overlap_part: partition: %.2fs\n", now_s() - t0);

    /* --- cache-resident multimap probes; hits append atomically (order
     * restored by the caller's sort) --- */
    t0 = now_s();
    long pos = 0;
    int overflow = 0;
    #pragma omp parallel for schedule(dynamic, 1)
    for (long b = 0; b < NB; b++) {
        int ov_seen;
        #pragma omp atomic read
        ov_seen = overflow;
        if (ov_seen) continue;
        for (long e = b * pcb; e < cur[b]; e++) {
            const uint64_t q = (uint64_t)qr[e];
            const uint64_t *tab = (sc[e] & 1) ? stab : ptab;
            const int64_t *keys = (sc[e] & 1) ? S : P;
            const long skip_id = org[e];
            uint32_t fp = (uint32_t)q;
            uint64_t h = mix64(q) & tmask;
            for (;;) {
                uint64_t t = tab[h];
                if (!t) break;
                if ((uint32_t)t == fp) {
                    long j = (long)(t >> 32) - 1;
                    if (j != skip_id && (!wide || keys[j] == (int64_t)q)) {
                        long w;
                        #pragma omp atomic capture
                        w = pos++;
                        if (w >= cap) {
                            #pragma omp atomic write
                            overflow = 1;
                            break;
                        }
                        hits[w] = (int64_t)(((uint64_t)(uint32_t)rank[e]
                                             << 32) | (uint32_t)j);
                    }
                }
                h = (h + 1) & tmask;
            }
            #pragma omp atomic read
            ov_seen = overflow;
            if (ov_seen) break;
        }
    }
    TLOG("overlap_part: probes: %.2fs\n", now_s() - t0);
    return overflow ? -1 : pos;
}

/* Sorts partitioned-overlap hits into discovery order and unpacks them
 * to (a_port, b_port) — replacing the wrapper's np.sort + shift passes
 * (measured ~0.5 s at 6M hits on the eval host).  hits are the packed
 * (pass << 60 | i << 32 | j) uint64 keys of kmerio_overlap_edges_part;
 * an unsigned LSD radix (8 byte passes, scratch: m uint64) gives the
 * exact discovery order, then one pass derives
 *   right passes (pass < 8):  a = 2i,   bit = 1 - (pass & 1)
 *   left passes  (pass >= 8): a = 2i+1, bit = (pass - 8) & 1
 *   b = 2j + bit
 * Scratch must hold m uint64. */
void kmerio_overlap_sort_unpack(uint64_t *hits, long m, uint64_t *scratch,
                                int64_t *out_a, int64_t *out_b) {
    uint64_t *src = hits, *dst = scratch;
    long cnt[256], off[256];
    for (int byte = 0; byte < 8; byte++) {
        int sh = 8 * byte;
        memset(cnt, 0, sizeof(cnt));
        for (long i = 0; i < m; i++) cnt[(src[i] >> sh) & 255]++;
        if (cnt[(src[0] >> sh) & 255] == m) continue; /* all equal: skip */
        long acc = 0;
        for (int b = 0; b < 256; b++) { off[b] = acc; acc += cnt[b]; }
        for (long i = 0; i < m; i++) dst[off[(src[i] >> sh) & 255]++] = src[i];
        uint64_t *t = src; src = dst; dst = t;
    }
    for (long i = 0; i < m; i++) {
        uint64_t h = src[i];
        long pass = (long)(h >> 60);
        long ii = (long)((h >> 32) & 0x0FFFFFFF);
        long j = (long)(h & 0xFFFFFFFF);
        int rightp = pass < 8;
        long q = rightp ? pass : pass - 8;
        long bit = rightp ? 1 - (q & 1) : (q & 1);
        out_a[i] = 2 * ii + (rightp ? 0 : 1);
        out_b[i] = 2 * j + bit;
    }
}

/* One-pass set algebra over sorted-unique arrays: fills intersection,
 * a-only, and b-only in a single merge (the reference's bucket-local
 * Add/Sub/Intersection, lib/core/kmer_set.h:164-219,286-305; numpy's
 * intersect1d/setdiff1d re-sort the concatenation instead).  Output
 * buffers must hold min(na,nb) / na / nb elements; counts are written to
 * out_counts[0..2].  Any output pointer may be NULL to skip it. */
void kmerio_sorted_algebra(const int64_t *a, long na,
                           const int64_t *b, long nb,
                           int64_t *inter, int64_t *a_only, int64_t *b_only,
                           long *out_counts) {
    long i = 0, j = 0, ni = 0, nao = 0, nbo = 0;
    while (i < na && j < nb) {
        int64_t x = a[i], y = b[j];
        if (x == y) {
            if (inter) inter[ni] = x;
            ni++; i++; j++;
        } else if (x < y) {
            if (a_only) a_only[nao] = x;
            nao++; i++;
        } else {
            if (b_only) b_only[nbo] = y;
            nbo++; j++;
        }
    }
    for (; i < na; i++) { if (a_only) a_only[nao] = a[i]; nao++; }
    for (; j < nb; j++) { if (b_only) b_only[nbo] = b[j]; nbo++; }
    out_counts[0] = ni; out_counts[1] = nao; out_counts[2] = nbo;
}

/* Merges two sorted-unique (key, count) runs, summing counts of equal
 * keys — the combiner of the out-of-core chunked counting path (the
 * sorted-array equivalent of the reference's thread-buffer bucket merge,
 * lib/core/kmer_counter.h:105-126).  Output buffers must hold na + nb
 * elements; returns the merged length.  Pass oc == NULL (ac/bc then
 * unread) for a keys-only sorted union — the decode-direction merge. */
long kmerio_merge_counts(const int64_t *ak, const int64_t *ac, long na,
                         const int64_t *bk, const int64_t *bc, long nb,
                         int64_t *ok, int64_t *oc) {
    long i = 0, j = 0, m = 0;
    while (i < na && j < nb) {
        int64_t x = ak[i], y = bk[j];
        if (x < y) {
            ok[m] = x;
            if (oc) oc[m] = ac[i];
            m++; i++;
        } else if (y < x) {
            ok[m] = y;
            if (oc) oc[m] = bc[j];
            m++; j++;
        } else {
            ok[m] = x;
            if (oc) oc[m] = ac[i] + bc[j];
            m++; i++; j++;
        }
    }
    for (; i < na; i++) { ok[m] = ak[i]; if (oc) oc[m] = ac[i]; m++; }
    for (; j < nb; j++) { ok[m] = bk[j]; if (oc) oc[m] = bc[j]; m++; }
    return m;
}

/* Concatenates [lo[i], hi[i]) ranges of src into out (the gather behind
 * string/group selection; replaces numpy repeat/cumsum index fabrication). */
void kmerio_gather_ranges_u8(const uint8_t *src, const int64_t *lo,
                             const int64_t *hi, long n, uint8_t *out) {
    long pos = 0;
    for (long i = 0; i < n; i++) {
        long len = hi[i] - lo[i];
        memcpy(out + pos, src + lo[i], (size_t)len);
        pos += len;
    }
}

void kmerio_gather_ranges_i64(const int64_t *src, const int64_t *lo,
                              const int64_t *hi, long n, int64_t *out) {
    long pos = 0;
    for (long i = 0; i < n; i++) {
        long len = hi[i] - lo[i];
        memcpy(out + pos, src + lo[i], (size_t)len * sizeof(int64_t));
        pos += len;
    }
}

/* Terminal tests + oriented successor from the side tables (reference:
 * lib/core/spss.h:276-313 terminals, 394-423 orientation flips).  succ
 * has 2n entries: 2i exits right, 2i+1 exits left; -1 at terminals. */
void kmerio_unitig_succ(const int32_t *rdeg, const int32_t *rnbr,
                        const uint8_t *rsame, const int32_t *ldeg,
                        const int32_t *lnbr, const uint8_t *lsame, long n,
                        int64_t *succ, uint8_t *term_l, uint8_t *term_r,
                        uint8_t *both) {
    #pragma omp parallel for schedule(static)
    for (long i = 0; i < n; i++) {
        int32_t mate_r = rsame[i] ? rdeg[rnbr[i]] : ldeg[rnbr[i]];
        int tr = (rdeg[i] != 1) || (mate_r != 1);
        int32_t mate_l = lsame[i] ? ldeg[lnbr[i]] : rdeg[lnbr[i]];
        int tl = (ldeg[i] != 1) || (mate_l != 1);
        term_r[i] = (uint8_t)tr;
        term_l[i] = (uint8_t)tl;
        both[i] = (uint8_t)(tr && tl);
        succ[2 * i] = tr ? -1 : 2 * (int64_t)rnbr[i] + rsame[i];
        succ[2 * i + 1] = tl ? -1 : 2 * (int64_t)lnbr[i] + (lsame[i] ? 0 : 1);
    }
}

/* Packed k-prefix (from_end=0) or k-suffix (from_end=1) of every string
 * (reference prefix/suffix extraction feeding the overlap multimaps,
 * lib/core/spss.h:619-695). */
void kmerio_pack_rows(const uint8_t *codes, const int64_t *offsets, long n,
                      int k, int from_end, int64_t *out) {
    #pragma omp parallel for schedule(static)
    for (long i = 0; i < n; i++) {
        long start = from_end ? offsets[i + 1] - k : offsets[i];
        uint64_t v = 0;
        for (int t = 0; t < k; t++) v = (v << 2) | codes[start + t];
        out[i] = (int64_t)v;
    }
}

/* Emits SPSS strings by concatenating oriented unitigs along each chain
 * with (k-1)-overlap elision (reference GetStringFromPath,
 * lib/core/spss.h:1186-1206).  nodes encode (unitig << 1) | flip when
 * oriented; the first node contributes its whole string, later nodes
 * skip the first k-1 bases.  offsets: n_groups + 1 slots. */
void kmerio_emit_string_chains(const uint8_t *codes, const int64_t *uoffsets,
                               int k, const int64_t *nodes,
                               const int64_t *groups, long n_groups,
                               int oriented, int64_t *offsets,
                               uint8_t *out_codes) {
    long pos = 0;
    offsets[0] = 0;
    for (long g = 0; g < n_groups; g++) {
        for (long i = groups[g]; i < groups[g + 1]; i++) {
            int64_t u = nodes[i];
            long ent = oriented ? (u >> 1) : u;
            int flip = oriented ? (int)(u & 1) : 0;
            long lo = uoffsets[ent], hi = uoffsets[ent + 1];
            long skip = (i == groups[g]) ? 0 : k - 1;
            if (!flip) {
                long len = hi - lo - skip;
                memcpy(out_codes + pos, codes + lo + skip, (size_t)len);
                pos += len;
            } else {
                /* reverse complement read: emit 3 - codes[hi-1-t] */
                for (long t = skip; t < hi - lo; t++)
                    out_codes[pos++] = (uint8_t)(3 - codes[hi - 1 - t]);
            }
        }
        offsets[g + 1] = pos;
    }
}

/* Cycle leader election on a functional successor graph whose components
 * are simple chains or simple cycles (unique predecessor — the matched
 * port graph of the SPSS greedy cover).  For every cycle, emits the
 * minimum label (entity id when oriented) — the edge-cut leader
 * (replacing union-find loop removal, reference:
 * lib/core/spss.h:877-933,1541-1647).  Returns the number of leaders.
 * A node u is on a cycle iff walking from an unvisited u returns to u. */
long kmerio_cycle_leaders(const int64_t *succ, long n, int oriented,
                          int64_t *leaders_out) {
    uint8_t *vis = (uint8_t *)calloc((size_t)n, 1);
    if (!vis) return -1;
    long cnt = 0;
    for (long u = 0; u < n; u++) {
        if (vis[u]) continue;
        int64_t v = u;
        while (1) {
            vis[v] = 1;
            int64_t w = succ[v];
            if (w < 0) break; /* chain end */
            if (w == u) {     /* closed a cycle through u */
                int64_t best = oriented ? (u >> 1) : u;
                for (int64_t x = succ[u]; x != u; x = succ[x]) {
                    int64_t lab = oriented ? (x >> 1) : x;
                    if (lab < best) best = lab;
                }
                leaders_out[cnt++] = best;
                break;
            }
            if (vis[w]) break; /* joined an earlier chain */
            v = w;
        }
    }
    free(vis);
    return cnt;
}

/* Gap-decode a sorted key array from the device's delta wire format
 * (ops/deltas.py): small-width deltas (uint8 when width==1, uint16 when
 * width==2) with escaped positions patched from an ascending (position,
 * true delta) exception table.  out[i] = sum of patched deltas 0..i
 * (d[0] carries the absolute first key, so the cumsum needs no base).
 * Validates strict monotonicity as it goes: every patched delta past
 * position 0 must be positive (sorted unique keys), and the first key
 * non-negative — which catches positional transfer corruption the
 * final-key integrity check alone would miss (a corrupt delta pair
 * whose sum cancels).  Returns 0 when every exception was consumed at
 * its position and the sequence is strictly increasing, -1 otherwise
 * (caller falls back to the raw transfer). */
long kmerio_delta_decode(const void *d, int width, long n,
                         const int64_t *exc, long n_exc, int64_t *out) {
    int64_t acc = 0;
    long e = 0;
    if (width == 1) {
        const uint8_t *p = (const uint8_t *)d;
        for (long i = 0; i < n; i++) {
            int64_t dv = p[i];
            if (e < n_exc && exc[2 * e] == i) { dv = exc[2 * e + 1]; e++; }
            if (i ? (dv <= 0) : (dv < 0)) return -1;
            acc += dv;
            out[i] = acc;
        }
    } else {
        const uint16_t *p = (const uint16_t *)d;
        for (long i = 0; i < n; i++) {
            int64_t dv = p[i];
            if (e < n_exc && exc[2 * e] == i) { dv = exc[2 * e + 1]; e++; }
            if (i ? (dv <= 0) : (dv < 0)) return -1;
            acc += dv;
            out[i] = acc;
        }
    }
    return e == n_exc ? 0 : -1;
}
