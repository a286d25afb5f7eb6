// The row scatter-add of the train step for Hopper (sm_90a), bound through
// ctypes: out[V,C] = 0; out[idx[r]] += rows[r], float32 or float64, int64
// indices, 1 <= C <= 16 (the step sends C = 9 and C = 3; the h1 evidence
// C = 1).
//
// Replaces the scatter-adds the JAX package writes as `.at[].add`,
// `segment_sum` and the transpose of a gather: drt_tpu/render/trace.py:
// 164-171 (`_gather_tri9_bwd`, both routes), drt_tpu/geometry/normals.py:31
// (`segment_sum`), and the AD transposes of the vertex gathers at
// drt_tpu/render/silhouette.py:158 and drt_tpu/geometry/metrics.py:56. In
// torch these ran as `index_put_(accumulate=True)` behind IndexBackward0 (a
// sort, then one warp a run of equal indices, serially) and `index_add_`
// (float atomics). Its plain version is `scatter_rows_plain` in
// drt_tpu_torch/geometry/scatter.py: `index_add_`, which on the CPU sums as
// JAX's `.at[].add` does there.
//
// Contract: the output equals the plain version run on the CPU bit for bit.
// Each destination's rows are summed in ascending row order, from +0, each
// add rounded on its own (__fadd_rn / __dadd_rn; a NaN sum carries the NaN
// the CPU gives, `add_nan`). No float atomic touches the output, so one
// input gives the same bits on every run. A row whose
// every entry is +-0 is skipped: an accumulator that starts at +0 is never
// -0, and x + (+-0) = x, so the bits do not change. That takes out the rows
// of dead lanes and of padding, which the step sends by the hundred
// thousand to a handful of destinations (safe_id 0, edge 0, face 0). An
// index outside [0, V), negative ones included, sets a flag in the last int
// of the scratch (its row is dropped), and the wrapper raises on it, as the
// plain version does.
//
// Design: a stable LSD radix sort of the live rows by destination, 8 bits a
// pass (2 passes up to 65,536 destinations), then a fold of each
// destination's run in row order. Both routes rank the same way (the
// pieces are in cluster_sort.cuh, which csrc/order.cu shares): a warp
// owns a contiguous range of a pass's input, counts its digits into its own
// 256 counters (`__match_any_sync`, the lowest lane of each digit adds), and
// after the prefix is known walks its range again in order, 32 items a
// round, placing each at its warp's base for its digit plus its rank among
// the round's lanes of that digit: a stable pass that drops the dead rows
// on the way. The fold (`fold_warp`): a warp walks its share of the sorted
// pairs 32 at a time, a lane a pair, finds where each run (one key) starts
// by the keys' adjacent difference (no search), and the run's first lane
// sums the run's rows in order from a window of shared memory, carrying a
// run that goes on into the next window; column blocks go to separate
// warps. The output is zeroed beforehand, so every element is written, the
// destinations without rows as +0. Integer atomics only (digit counts, the
// tile counter), never on the output.
//
// Route A, `scatter_cluster_kernel`, for the step's small calls (up to
// 65,536 rows, the wrapper's `scatter_route`: the silhouette views): one
// launch of one thread-block cluster (16 CTAs of 1,024 threads where the
// card schedules it, from cudaOccupancyMaxActiveClusters). CTA k takes the
// k-th contiguous share of each pass's input. It keys its rows and counts
// their low digits, and pushes its 256 counts into every CTA's shared
// memory (cluster.map_shared_rank); after cluster.sync() each CTA forms
// its own exclusive prefix from that local table: all lower digits of the
// cluster, then this digit in lower-ranked CTAs. It places its pairs into
// the pass's output, syncs the cluster, counts the next digit of its share
// of that output, and so on; then it folds. The (key, row) pairs live in
// the per-call scratch (in L2 at these sizes); reads of what another CTA
// wrote go through L2 (__ldcg). The flag is written last, by CTA 0, with no
// memset before the launch. Device operations a call: the kernel and the
// wrapper's 4-byte flag read. One cluster holds 16 of the card's 132
// multiprocessors, which is why larger calls take the grid route.
//
// Route B, the grid route, above the cap (a bounce's 1,228,800-row soup
// scatter, the normals, the dihedral term): a single-sweep radix sort (Adinets
// and Merrill, "Onesweep", 2022). One memset clears the digit table, the
// tile counters and the look-back status words in the scratch; then
// `scatter_upfront_kernel` keys every row, sets the flag, counts the global
// digits of every pass at once into a [passes, 256] table (the digit counts
// of a set do not depend on its order) and zeroes the output;
// `scatter_pass_kernel` runs once a pass: each block takes the next tile of
// 4,096 items from an atomic counter (so a tile waits only on tiles handed
// out before it, which are running or done), ranks them as above, publishes
// its per-digit counts and gets its per-digit prefix by decoupled look-back
// over the tiles before it, then scatters; `scatter_reduce_kernel` folds.
// Device operations a call: 1 + 1 + passes + 1 and the flag read, 6 up to
// 65,536 destinations.
//
// What bounds it: bytes. The rows and the indices are read once, the output
// written once; on a bounce's soup scatter on dog_mid45k (1,228,800 rows
// of 9 floats into 65,536 faces) about 56 MB, 17 us at 3.35 TB/s. The sort
// moves 16 B a live row a pass on top, in L2 at the step's sizes. The
// step's other calls (32,768-393,216 rows) move 0.4-8 MB, a few
// microseconds: they are bound by launches and by the latency of the
// passes' dependent steps, which route A brings to one launch and a few
// cluster barriers and route B to 4 kernels and a clear.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no --use_fast_math).

#include "cluster_sort.cuh"

namespace cg = cooperative_groups;

// A dead row's digit is NO_DIGIT: neither counted nor placed.
#define MAX_PASSES 4
#define MAX_COLS 16

#define ROUTE_CLUSTER 0
#define ROUTE_GRID 1

// route A: the cluster of cluster_sort.cuh

// route B
#define GRID_BLOCK 512
#define GRID_WARPS (GRID_BLOCK / 32)
#define GRID_ITEMS 8                // a warp owns 32 * GRID_ITEMS items
#define GRID_TILE (GRID_BLOCK * GRID_ITEMS)
#define FOLD_BLOCK 256
#define FOLD_MAX_BLOCKS 2112        // 16 a multiprocessor of 132
#define FOLD_SPAN 64                // rows a fold warp (fewer pairs live)
#define FOLD_BUF_BYTES (4 * 32 * 4) // a fold warp's window: 4 floats or 2
                                    // doubles a lane
#define ZERO_ITEMS 16               // output elements an upfront thread

// look-back status words: flag in the top two bits, a count below
#define STATUS_AGGREGATE (1u << 30) // the tile's own counts
#define STATUS_INCLUSIVE (2u << 30) // its counts and all before it
#define STATUS_COUNT ((1u << 30) - 1u)

// -DSCATTER_TRACE=1 (scripts/tune_torch_oracle.py --what scatter-trace)
// builds a library whose cluster route stamps clock64() at each phase
// boundary of CTA 0's thread 0; scatter_trace_read copies the stamps out.
#ifdef SCATTER_TRACE
#define TRACE_SLOTS 64
__device__ long long scatter_trace[TRACE_SLOTS];
#define TRACE(slot)                                                       \
    do {                                                                  \
        if (rank == 0 && tid == 0 && (slot) < TRACE_SLOTS)                \
            scatter_trace[slot] = clock64();                              \
    } while (0)
// the fold's first windows in block 0's thread 0: slots 32 + 4 w + i
#define TRACE_FOLD(w, i)                                                  \
    do {                                                                  \
        if (blockIdx.x == 0 && threadIdx.x == 0 && (w) < 8)               \
            scatter_trace[32 + 4 * (w) + (i)] = clock64();                \
    } while (0)
#else
#define TRACE(slot) do {} while (0)
#define TRACE_FOLD(w, i) do {} while (0)
#endif

static_assert(RADIX <= GRID_BLOCK, "the digit steps take a digit a thread");

// acc + x rounded on its own, as the CPU rounds it: the fold's chains.
template <typename T> __device__ __forceinline__ T add_rn(T acc, T x);
template <> __device__ __forceinline__ float add_rn<float>(float acc,
                                                           float x) {
    return __fadd_rn(acc, x);
}
template <> __device__ __forceinline__ double add_rn<double>(double acc,
                                                             double x) {
    return __dadd_rn(acc, x);
}

// The same add where the sum is NaN, with the NaN the CPU plain version
// gives (x86's rule: the accumulator's NaN, else x's, made quiet, else the
// default NaN of inf - inf) where the card's add gives its one canonical
// NaN. A NaN, once in a sum, stays there, so the fold sums with add_rn
// and sums a run again with add_nan only where its sum came out NaN: the
// bits then match the CPU's, payload included.
template <typename T> __device__ T add_nan(T acc, T x);
template <> __device__ float add_nan<float>(float acc, float x) {
    const float r = __fadd_rn(acc, x);
    if (!isnan(r)) return r;
    const unsigned q = 0x00400000u;
    return __uint_as_float(isnan(acc) ? __float_as_uint(acc) | q
                           : isnan(x) ? __float_as_uint(x) | q
                                      : 0xffc00000u);
}
template <> __device__ double add_nan<double>(double acc, double x) {
    const double r = __dadd_rn(acc, x);
    if (!isnan(r)) return r;
    const unsigned long long q = 0x0008000000000000ull;
    return __longlong_as_double((long long)(
        isnan(acc) ? (unsigned long long)__double_as_longlong(acc) | q
        : isnan(x) ? (unsigned long long)__double_as_longlong(x) | q
                   : 0xfff8000000000000ull));
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
    unsigned v;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned v) {
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

// Row e's key: its index if the index lies in [0, n_out) and an entry is
// not +-0 (NaN is live), -1 otherwise; *bad is set on an index outside.
// The index and the row are loaded side by side.
template <typename T>
__device__ __forceinline__ int row_key(const T* __restrict__ rows,
                                       const long long* __restrict__ idx,
                                       int e, int n_cols, int n_out,
                                       bool* bad) {
    const long long d = idx[e];
    const T* row = rows + (long long)e * n_cols;
    bool live = false;
    for (int c = 0; c < n_cols; ++c) live |= row[c] != T(0);
    if (d < 0 || d >= n_out) {
        *bad = true;
        return -1;
    }
    return live ? (int)d : -1;
}

template <typename T>
__device__ __forceinline__ T row_at(const T* __restrict__ rows, int2 p,
                                    int n_cols, int c) {
    return rows[(long long)p.y * n_cols + c];
}

// Column c of the run of key d that starts at sorted position q, summed
// one pair at a time with add_nan: the fold's path for a NaN sum.
template <typename T>
__device__ __noinline__ T fold_run_nan(const T* __restrict__ rows,
                                       const int2* P, int n, int n_cols,
                                       int q, int c, int d) {
    T acc = T(0);
    for (int j = q; j < n; ++j) {
        const int2 p = __ldcg(P + j);
        if (p.x != d) break;
        acc = add_nan(acc, row_at(rows, p, n_cols, c));
    }
    return acc;
}

// Columns a fold warp sums at once (from registers): 4 floats, 2 doubles.
template <typename T> struct FoldCols {
    static constexpr int value = sizeof(T) == 4 ? 4 : 2;
};

// One window of the fold: the pairs P[w0, w0 + 32), a lane a position,
// and their rows' columns c0 .. c0 + CB - 1 (key -2 beyond the pairs).
template <typename T, int CB>
struct FoldWindow {
    int key;
    T v[CB];

    __device__ __forceinline__ void load(const T* __restrict__ rows,
                                         const int2* P, int n, int n_cols,
                                         int c0, int w0) {
        const int q = w0 + (threadIdx.x & 31);
        key = -2;
#pragma unroll
        for (int j = 0; j < CB; ++j) v[j] = T(0);
        if (q < n) {
            const int2 p = __ldcg(P + q);
            key = p.x;
#pragma unroll
            for (int j = 0; j < CB; ++j)
                if (c0 + j < n_cols) v[j] = row_at(rows, p, n_cols, c0 + j);
        }
    }
};

// The fold of the sorted (key, row) pairs P[0, n) that falls to one warp:
// columns c0 .. c0 + CB - 1 of every run (the pairs of one key, in
// ascending row order) whose first position lies in [a, b), reading past b
// to the end of its last run. The warp walks 32 positions at a time, a
// lane a position, loading the next window while it sums this one: each
// run's first lane in the window sums the run's lanes in order, read from
// the warp's buffer `buf` (FoldCols * 32 values in shared memory), and a
// run still open at the window's end carries its sums into the next
// window. out[d, c] gets the run's sum. The whole warp calls it with the
// same arguments.
template <typename T>
__device__ void fold_warp(const T* __restrict__ rows, const int2* P, int n,
                          int n_cols, int c0, int a, int b, T* buf,
                          T* __restrict__ out) {
    constexpr int CB = FoldCols<T>::value;
    const int lane = threadIdx.x & 31;
    if (a >= b) return;
    T carry[CB];                  // the sums of our run open at the
    bool open = false;            // window's start, whose key is carry_key
    int carry_key = a > 0 ? __ldcg(&P[a - 1].x) : -1;
    int carry_start = 0;          // and whose first position is this
    FoldWindow<T, CB> cur, next;
    cur.load(rows, P, n, n_cols, c0, a);
    for (int w0 = a; w0 < n && (w0 < b || open); w0 += 32) {
        TRACE_FOLD((w0 - a) / 32, 0);
        if (w0 + 32 < n) next.load(rows, P, n, n_cols, c0, w0 + 32);
        TRACE_FOLD((w0 - a) / 32, 1);
        const int key = cur.key;
        // our run open at the last window's end may have ended there
        if (open && __shfl_sync(FULL_MASK, key, 0) != carry_key) {
            if (lane == 0)
#pragma unroll
                for (int j = 0; j < CB; ++j)
                    if (c0 + j < n_cols)
                        out[(long long)carry_key * n_cols + c0 + j] =
                            isnan(carry[j])
                            ? fold_run_nan(rows, P, n, n_cols, carry_start,
                                           c0 + j, carry_key)
                            : carry[j];
            open = false;
        }
        int left = __shfl_up_sync(FULL_MASK, key, 1);
        if (lane == 0) left = carry_key;
        // a run starts here: ours if it starts before b; the run open at
        // the window's start goes on in lane 0
        const bool starts = key != left && key >= 0 && w0 + lane < b;
        const bool goes_on = lane == 0 && open;
        const bool active = starts || goes_on;
        const int start = goes_on ? carry_start : w0 + lane;
        const unsigned heads = __ballot_sync(FULL_MASK, key != left);
        // this run's lanes: up to the next lane where a key starts
        const unsigned after = lane < 31 ? heads >> (lane + 1) : 0u;
        const int len = after ? __ffs(after) : 32 - lane;
        const int steps = (int)__reduce_max_sync(
            FULL_MASK, active ? (unsigned)len : 0u);
        T acc[CB];
#pragma unroll
        for (int j = 0; j < CB; ++j) acc[j] = goes_on ? carry[j] : T(0);
        // the window's values go through the warp's buffer in shared
        // memory, whose loads do not wait on the sums; a lane outside its
        // run adds -0, which leaves every sum's bits as they are (x + -0 =
        // x, NaNs included): no branch in the chain
#pragma unroll
        for (int j = 0; j < CB; ++j) buf[j * 32 + lane] = cur.v[j];
        __syncwarp();
#pragma unroll 4
        for (int k = 0; k < steps; ++k) {
            const int src = min(lane + k, 31);
            const bool take = active && k < len;
#pragma unroll
            for (int j = 0; j < CB; ++j)
                acc[j] = add_rn(acc[j], take ? buf[j * 32 + src] : T(-0.0));
        }
        __syncwarp();             // the buffer is the next window's
        TRACE_FOLD((w0 - a) / 32, 2);
        // a run reaching the window's end stays open (the last one)
        const bool ends_open = active && lane + len == 32 && w0 + 32 < n;
        const unsigned open_lanes = __ballot_sync(FULL_MASK, ends_open);
        if (active && !ends_open)
#pragma unroll
            for (int j = 0; j < CB; ++j)
                if (c0 + j < n_cols)
                    out[(long long)key * n_cols + c0 + j] =
                        isnan(acc[j]) ? fold_run_nan(rows, P, n, n_cols,
                                                     start, c0 + j, key)
                                      : acc[j];
        open = open_lanes != 0u;
        if (open) {
            const int src = 31 - __clz(open_lanes);
#pragma unroll
            for (int j = 0; j < CB; ++j)
                carry[j] = __shfl_sync(FULL_MASK, acc[j], src);
            carry_start = __shfl_sync(FULL_MASK, start, src);
        }
        carry_key = __shfl_sync(FULL_MASK, key, 31);
        cur = next;
        TRACE_FOLD((w0 - a) / 32, 3);
    }
}

// The whole fold over `warps` warps, this one `warp` with its buffer
// `buf`: the column blocks split the warps into groups, each group's warps
// split the pairs.
template <typename T>
__device__ __forceinline__ void fold_share(const T* __restrict__ rows,
                                           const int2* P, int n, int n_cols,
                                           int warps, int warp, T* buf,
                                           T* __restrict__ out) {
    constexpr int CB = FoldCols<T>::value;
    const int groups = min((n_cols + CB - 1) / CB, warps);
    const int per = warps / groups;
    const int g = warp / per;
    if (g >= groups) return;
    for (int c0 = g * CB; c0 < n_cols; c0 += groups * CB) {
        const int len = (n + per - 1) / per;
        const int a = min((warp - g * per) * len, n);
        fold_warp(rows, P, n, n_cols, c0, a, min(a + len, n), buf, out);
    }
}

// Passes of 8 bits that cover keys in [0, n_out), at least one (it drops
// the dead rows).
static int passes_of(int n_out) {
    int bits = 0;
    while (bits < 31 && (1LL << bits) < n_out) ++bits;
    return bits > RADIX_BITS ? (bits + RADIX_BITS - 1) / RADIX_BITS : 1;
}

static long long tiles_of(long long n) {
    return (n + GRID_TILE - 1) / GRID_TILE;
}

// Scratch layout (ints): two arrays of n_rows (key, row) pairs, b then a
// (pass 0 reads its n_rows keys from the first n_rows ints of b and
// writes a, pass 1 writes b, ...), then for the grid route the
// [MAX_PASSES, RADIX] digit table, the MAX_PASSES tile counters, the live
// count and the [passes, tiles, RADIX] status words, and last the
// out-of-range flag.
static long long grid_clear_ints(long long n_rows, int n_out) {
    return (long long)MAX_PASSES * RADIX + MAX_PASSES + 1
           + (long long)passes_of(n_out) * tiles_of(n_rows) * RADIX + 1;
}

// ---------------------------------------------------------------------------
// Route A: one cluster.

template <typename T>
__global__ void __launch_bounds__(CLUSTER_BLOCK, 1)
scatter_cluster_kernel(const T* __restrict__ rows,
                       const long long* __restrict__ idx, int n_rows,
                       int n_cols, int n_out, int passes,
                       T* __restrict__ out, int* __restrict__ scratch) {
    cg::cluster_group cluster = cg::this_cluster();
    const int n_cta = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    // dynamic: a warp's digit counts, then its next slots; every CTA's
    // counts of the pass, each pushed by its CTA
    extern __shared__ int dyn[];
    int (*wcnt)[RADIX] = (int (*)[RADIX])dyn;
    int (*all_cnt)[RADIX] = (int (*)[RADIX])(dyn + CLUSTER_WARPS * RADIX);
    __shared__ int base[RADIX];
    __shared__ int all_bad[CLUSTER_MAX];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int* key0 = scratch;
    int2* pairs_b = (int2*)scratch;
    int2* pairs_a = pairs_b + n_rows;
    const long long stride = (long long)n_cta * CLUSTER_BLOCK;
    const long long me = (long long)rank * CLUSTER_BLOCK + tid;

    cluster_arrive_relaxed();     // waited on before the first push
    // 1. zero the output; key this CTA's rows; count their low digits
    TRACE(0);
    const long long n_elems = (long long)n_out * n_cols;
    for (long long i = me; i < n_elems; i += stride) out[i] = T(0);
    for (int i = tid; i < CLUSTER_WARPS * RADIX; i += CLUSTER_BLOCK)
        (&wcnt[0][0])[i] = 0;
    __syncthreads();
    bool bad = false;
    {
        int ca, cb, wa, wb;
        share(0, n_rows, n_cta, rank, &ca, &cb);
        share(ca, cb, CLUSTER_WARPS, warp, &wa, &wb);
        for (int b = wa; b < wb; b += 32 * CLUSTER_UNROLL) {
            int key[CLUSTER_UNROLL];
#pragma unroll
            for (int u = 0; u < CLUSTER_UNROLL; ++u) {
                const int e = b + u * 32 + lane;
                key[u] = e < wb ? row_key(rows, idx, e, n_cols, n_out, &bad)
                                : -1;
            }
#pragma unroll
            for (int u = 0; u < CLUSTER_UNROLL; ++u) {
                const int e = b + u * 32 + lane;
                if (e < wb) key0[e] = key[u];
                warp_count(digit_of(key[u], 0), wcnt[warp]);
            }
        }
    }
    TRACE(1);
    const int cta_bad = __syncthreads_or(bad);
    cluster_wait();               // every CTA has started
    if (tid < n_cta) *cluster.map_shared_rank(&all_bad[rank], tid) = cta_bad;
    TRACE(2);

    int n = n_rows;               // the pass's items: rows, then live pairs
    int any_bad = 0;
    for (int p = 0; p < passes; ++p) {
        const int shift = p * RADIX_BITS;
        const int2* in = p % 2 ? pairs_a : pairs_b;
        int2* to = p % 2 ? pairs_b : pairs_a;
        int ca, cb, wa, wb;
        share(0, n, n_cta, rank, &ca, &cb);
        share(ca, cb, CLUSTER_WARPS, warp, &wa, &wb);
        if (p > 0) {              // 2. count this CTA's share of the digit
            for (int i = tid; i < CLUSTER_WARPS * RADIX; i += CLUSTER_BLOCK)
                (&wcnt[0][0])[i] = 0;
            __syncthreads();
            for (int b = wa; b < wb; b += 32 * CLUSTER_UNROLL) {
                int key[CLUSTER_UNROLL];
#pragma unroll
                for (int u = 0; u < CLUSTER_UNROLL; ++u) {
                    const int e = b + u * 32 + lane;
                    key[u] = e < wb ? __ldcg(&in[e].x) : -1;
                }
#pragma unroll
                for (int u = 0; u < CLUSTER_UNROLL; ++u)
                    warp_count(digit_of(key[u], shift), wcnt[warp]);
            }
            __syncthreads();
        }
        TRACE(3 + 6 * p);
        // each warp's exclusive prefix within the CTA; the CTA's counts,
        // pushed into every CTA's table (no CTA pushes the next pass's
        // before all have passed the barrier after reading this pass's)
        if (tid < RADIX) {
            int run = 0;
#pragma unroll 8
            for (int w = 0; w < CLUSTER_WARPS; ++w) {
                const int c = wcnt[w][tid];
                wcnt[w][tid] = run;
                run += c;
            }
            base[tid] = run;
        }
        __syncthreads();
        for (int i = tid; i < n_cta * RADIX; i += CLUSTER_BLOCK)
            cluster.map_shared_rank(all_cnt[rank], i / RADIX)[i % RADIX] =
                base[i % RADIX];
        // the barrier's release and acquire order the pass's pairs, in
        // global memory, and the counts, in shared memory, for the cluster
        TRACE(4 + 6 * p);
        cluster.sync();
        TRACE(5 + 6 * p);
        // 3. the cluster's prefix: lower digits, then lower-ranked CTAs
        int total = 0, below = 0;
        if (tid < RADIX) {
            for (int r = 0; r < n_cta; ++r) {
                const int c = all_cnt[r][tid];
                total += c;
                below += r < rank ? c : 0;
            }
        }
        if (p == 0 && rank == 0 && tid == 0)
            for (int r = 0; r < n_cta; ++r) any_bad |= all_bad[r];
        int live;
        const int start = block_exclusive_scan<CLUSTER_WARPS>(total, &live);
        if (tid < RADIX) base[tid] = start + below;
        __syncthreads();
        TRACE(6 + 6 * p);
        // 4. place this CTA's share, in order
        for (int b = wa; b < wb; b += 32 * CLUSTER_UNROLL) {
            int2 item[CLUSTER_UNROLL];
#pragma unroll
            for (int u = 0; u < CLUSTER_UNROLL; ++u) {
                const int e = b + u * 32 + lane;
                item[u] = make_int2(-1, e);
                if (e < wb) {
                    if (p == 0) item[u].x = key0[e];
                    else item[u] = __ldcg(in + e);
                }
            }
#pragma unroll
            for (int u = 0; u < CLUSTER_UNROLL; ++u) {
                const int pos = warp_place(digit_of(item[u].x, shift), base,
                                           wcnt[warp]);
                if (pos >= 0) to[pos] = item[u];
            }
        }
        n = live;
        TRACE(7 + 6 * p);
        cluster.sync();           // 5. the next pass reads what all placed
        TRACE(8 + 6 * p);
    }
    // 6. fold each destination's run, a warp a share of the sorted pairs
    // (its buffer in the counters' space, free now)
    static_assert(FOLD_BUF_BYTES <= RADIX * sizeof(int),
                  "a warp's fold buffer fits in its counters");
    fold_share(rows, passes % 2 ? pairs_a : pairs_b, n, n_cols,
               n_cta * CLUSTER_WARPS, rank * CLUSTER_WARPS + warp,
               (T*)wcnt[warp], out);
    TRACE(3 + 6 * passes);
    // 7. the flag, last
    if (rank == 0 && tid == 0) scratch[4LL * n_rows] = any_bad;
}

// ---------------------------------------------------------------------------
// Route B: the grid.

// Keys every row of its tile into key0, counts the live keys' digits of
// every pass into hist [MAX_PASSES, RADIX] (integer atomics), sets *bad on
// an index outside [0, n_out), and zeroes its share of the output.
template <typename T>
__global__ void __launch_bounds__(GRID_BLOCK)
scatter_upfront_kernel(const T* __restrict__ rows,
                       const long long* __restrict__ idx, int n_rows,
                       int n_cols, int n_out, int passes,
                       int* __restrict__ key0, int* __restrict__ hist,
                       int* __restrict__ bad, T* __restrict__ out) {
    __shared__ int cnt[MAX_PASSES * RADIX];
    const int tid = threadIdx.x;
    for (int i = tid; i < MAX_PASSES * RADIX; i += GRID_BLOCK) cnt[i] = 0;
    __syncthreads();
    bool b = false;
    const long long t0 = (long long)blockIdx.x * GRID_TILE;
    int key[GRID_ITEMS];
#pragma unroll
    for (int k = 0; k < GRID_ITEMS; ++k) {
        const long long e = t0 + k * GRID_BLOCK + tid;
        key[k] = e < n_rows ? row_key(rows, idx, (int)e, n_cols, n_out, &b)
                            : -1;
    }
#pragma unroll
    for (int k = 0; k < GRID_ITEMS; ++k) {
        const long long e = t0 + k * GRID_BLOCK + tid;
        if (e < n_rows) key0[e] = key[k];
        if (key[k] >= 0)
            for (int p = 0; p < passes; ++p)
                atomicAdd(&cnt[p * RADIX + ((key[k] >> (p * RADIX_BITS))
                                            & (RADIX - 1))], 1);
    }
    if (b) *bad = 1;
    __syncthreads();
    for (int i = tid; i < passes * RADIX; i += GRID_BLOCK)
        if (cnt[i]) atomicAdd(hist + i, cnt[i]);
    const long long n_elems = (long long)n_out * n_cols;
    for (long long i = (long long)blockIdx.x * GRID_BLOCK + tid; i < n_elems;
         i += (long long)gridDim.x * GRID_BLOCK)
        out[i] = T(0);
}

// One stable pass over the items: pass 0 the n_rows keys of the upfront
// kernel (key0; -1 dead; an item's row is its position), later passes the
// live (key, row) pairs of the pass before (in). status: this pass's
// [tiles, RADIX] words, zero on entry; the tile counters zero on entry.
__global__ void __launch_bounds__(GRID_BLOCK)
scatter_pass_kernel(const int* key0, const int2* in, int n_rows,
                    const int* __restrict__ hist, int pass,
                    unsigned* status, int* tile_counter, int* n_live,
                    int2* __restrict__ to) {
    __shared__ int wcnt[GRID_WARPS][RADIX];
    __shared__ int base[RADIX];
    __shared__ int s_tile;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int shift = pass * RADIX_BITS;
    if (tid == 0) s_tile = atomicAdd(tile_counter + pass, 1);
    int live;
    const int start = block_exclusive_scan<GRID_WARPS>(
        tid < RADIX ? __ldcg(hist + pass * RADIX + tid) : 0, &live);
    const int tile = s_tile;
    const int n = pass == 0 ? n_rows : live;
    if (tile == 0 && tid == 0) *n_live = live;
    if ((long long)tile * GRID_TILE >= n) return;   // the whole block
    for (int i = tid; i < GRID_WARPS * RADIX; i += GRID_BLOCK)
        (&wcnt[0][0])[i] = 0;
    __syncthreads();
    int2 item[GRID_ITEMS];
    const int w0 = tile * GRID_TILE + warp * 32 * GRID_ITEMS;
#pragma unroll
    for (int k = 0; k < GRID_ITEMS; ++k) {
        const int e = w0 + k * 32 + lane;
        item[k] = make_int2(-1, e);
        if (e < n) {
            if (pass == 0) item[k].x = __ldcg(key0 + e);
            else item[k] = __ldcg(in + e);
        }
    }
#pragma unroll
    for (int k = 0; k < GRID_ITEMS; ++k)
        warp_count(digit_of(item[k].x, shift), wcnt[warp]);
    __syncthreads();
    if (tid < RADIX) {
        int run = 0;
#pragma unroll
        for (int w = 0; w < GRID_WARPS; ++w) {
            const int c = wcnt[w][tid];
            wcnt[w][tid] = run;
            run += c;
        }
        // decoupled look-back over the tiles handed out before this one
        unsigned* mine = status + (long long)tile * RADIX + tid;
        unsigned prefix = 0;
        if (tile == 0) {
            store_relaxed(mine, STATUS_INCLUSIVE | (unsigned)run);
        } else {
            store_relaxed(mine, STATUS_AGGREGATE | (unsigned)run);
            for (int j = tile - 1; j >= 0; --j) {
                const unsigned* theirs = status + (long long)j * RADIX + tid;
                unsigned s;
                do {
                    s = load_relaxed(theirs);
                } while (s == 0u);
                prefix += s & STATUS_COUNT;
                if (s & STATUS_INCLUSIVE) break;
            }
            store_relaxed(mine, STATUS_INCLUSIVE | (prefix + (unsigned)run));
        }
        base[tid] = start + (int)prefix;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GRID_ITEMS; ++k) {
        const int pos = warp_place(digit_of(item[k].x, shift), base,
                                   wcnt[warp]);
        if (pos >= 0) to[pos] = item[k];
    }
}

// Folds the *n_live sorted pairs' runs, a warp a share of the pairs.
template <typename T>
__global__ void __launch_bounds__(FOLD_BLOCK)
scatter_reduce_kernel(const T* __restrict__ rows, const int2* P,
                      const int* n_live, int n_cols, T* __restrict__ out) {
    __shared__ __align__(8) char buf[FOLD_BLOCK / 32][FOLD_BUF_BYTES];
    fold_share(rows, P, __ldcg(n_live), n_cols, gridDim.x * (FOLD_BLOCK / 32),
               blockIdx.x * (FOLD_BLOCK / 32) + (threadIdx.x >> 5),
               (T*)buf[threadIdx.x >> 5], out);
}

// ---------------------------------------------------------------------------

static int g_cluster_size = -1;

// The largest cluster for both row types (computed at the first call).
static int cluster_size() {
    if (g_cluster_size < 0) {
        const void* fns[2] = {(const void*)scatter_cluster_kernel<float>,
                              (const void*)scatter_cluster_kernel<double>};
        const int blocks[2] = {CLUSTER_BLOCK, CLUSTER_BLOCK};
        const int smems[2] = {CLUSTER_SMEM, CLUSTER_SMEM};
        g_cluster_size = largest_cluster(fns, blocks, smems, 2);
    }
    return g_cluster_size;
}

template <typename T>
static cudaError_t launch_cluster(const T* rows, const long long* idx,
                                  int n_rows, int n_cols, int n_out,
                                  int passes, T* out, int* scratch,
                                  cudaStream_t s) {
    const int k = cluster_size();
    if (k < 1) return cudaErrorNotSupported;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(k, CLUSTER_BLOCK,
                                                  CLUSTER_SMEM, &attr, s);
    return cudaLaunchKernelEx(&cfg, scatter_cluster_kernel<T>, rows, idx,
                              n_rows, n_cols, n_out, passes, out, scratch);
}

template <typename T>
static cudaError_t launch_grid(const T* rows, const long long* idx,
                               int n_rows, int n_cols, int n_out, int passes,
                               T* out, int* scratch, cudaStream_t s) {
    const long long n_tiles = tiles_of(n_rows);
    int* key0 = scratch;
    int2* pairs_b = (int2*)scratch;
    int2* pairs_a = pairs_b + n_rows;
    int* hist = (int*)(pairs_a + n_rows);
    int* counters = hist + MAX_PASSES * RADIX;
    int* n_live = counters + MAX_PASSES;
    unsigned* status = (unsigned*)(n_live + 1);
    int* bad = (int*)(status + (long long)passes * n_tiles * RADIX);
    cudaError_t err = cudaMemsetAsync(
        hist, 0, grid_clear_ints(n_rows, n_out) * sizeof(int), s);
    if (err != cudaSuccess) return err;
    const long long n_elems = (long long)n_out * n_cols;
    const long long zero_blocks =
        (n_elems + (long long)GRID_BLOCK * ZERO_ITEMS - 1)
        / ((long long)GRID_BLOCK * ZERO_ITEMS);
    long long up = zero_blocks < FOLD_MAX_BLOCKS ? zero_blocks
                                                 : FOLD_MAX_BLOCKS;
    if (n_tiles > up) up = n_tiles;     // a tile a block, the rest zeroes
    if (up > 0)
        scatter_upfront_kernel<T><<<(unsigned)up, GRID_BLOCK, 0, s>>>(
            rows, idx, n_rows, n_cols, n_out, passes, key0, hist, bad, out);
    if (n_rows == 0) return cudaGetLastError();
    for (int p = 0; p < passes; ++p)
        scatter_pass_kernel<<<(unsigned)n_tiles, GRID_BLOCK, 0, s>>>(
            key0, p % 2 ? pairs_a : pairs_b, n_rows, hist, p,
            status + (long long)p * n_tiles * RADIX, counters, n_live,
            p % 2 ? pairs_b : pairs_a);
    // a warp a FOLD_SPAN of the rows (the live pairs are fewer)
    const long long blocks = ((long long)n_rows + FOLD_SPAN * (FOLD_BLOCK / 32)
                              - 1) / (FOLD_SPAN * (FOLD_BLOCK / 32));
    scatter_reduce_kernel<T><<<(unsigned)(blocks < FOLD_MAX_BLOCKS
                                          ? blocks : FOLD_MAX_BLOCKS),
                               FOLD_BLOCK, 0, s>>>(
        rows, passes % 2 ? pairs_a : pairs_b, n_live, n_cols, out);
    return cudaGetLastError();
}

extern "C" {

#ifdef SCATTER_TRACE
// Copies the last cluster launch's stamps (TRACE_SLOTS clock64() values,
// 0 where no stamp was taken) to host memory `to`.
int scatter_trace_read(long long* to) {
    return (int)cudaMemcpyFromSymbol(to, scatter_trace, sizeof(scatter_trace));
}

int scatter_trace_clear() {
    static const long long zeros[TRACE_SLOTS] = {};
    return (int)cudaMemcpyToSymbol(scatter_trace, zeros, sizeof(zeros));
}
#endif

int scatter_max_cols() { return MAX_COLS; }

// The cluster route's CTAs a cluster on this card (computed at the first
// call), 0 if the card schedules no cluster of its CTAs.
int scatter_cluster_size() { return cluster_size(); }

// int32 scratch scatter_launch needs for n_rows rows into n_out on route
// `route`; its last int is the out-of-range flag.
long long scatter_scratch_ints(long long n_rows, long long n_out,
                               int route) {
    if (route == ROUTE_CLUSTER) return 4 * n_rows + 1;
    return 4 * n_rows + grid_clear_ints(n_rows, (int)n_out);
}

// The arguments of scatter_launch, for the wrapper's interface check.
const char* scatter_signature() {
    return "rows rows_f64 idx n_rows n_cols n_out route out scratch stream";
}

// Launches route `route` (0 the cluster, 1 the grid) on `stream` and
// returns the first CUDA error; does not synchronise. rows [n_rows,
// n_cols] (float, or double with rows_f64), idx [n_rows] int64, out
// [n_out, n_cols] of the rows' type, scratch scatter_scratch_ints(n_rows,
// n_out, route) ints; all contiguous on one device. When the launch has
// run, the last int of scratch is 1 if an index lay outside [0, n_out) and
// 0 otherwise.
int scatter_launch(const void* rows, int rows_f64, const long long* idx,
                   int n_rows, int n_cols, int n_out, int route, void* out,
                   int* scratch, void* stream) {
    if (n_rows < 0 || n_out < 0 || n_cols < 1 || n_cols > MAX_COLS
        || (route != ROUTE_CLUSTER && route != ROUTE_GRID))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int passes = passes_of(n_out);
    cudaError_t err;
    if (route == ROUTE_CLUSTER)
        err = rows_f64
            ? launch_cluster((const double*)rows, idx, n_rows, n_cols, n_out,
                             passes, (double*)out, scratch, s)
            : launch_cluster((const float*)rows, idx, n_rows, n_cols, n_out,
                             passes, (float*)out, scratch, s);
    else
        err = rows_f64
            ? launch_grid((const double*)rows, idx, n_rows, n_cols, n_out,
                          passes, (double*)out, scratch, s)
            : launch_grid((const float*)rows, idx, n_rows, n_cols, n_out,
                          passes, (float*)out, scratch, s);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
