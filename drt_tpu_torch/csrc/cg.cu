// The conjugate-gradient solve of the Sobolev preconditioner for Hopper
// (sm_90a), bound through ctypes: x = A^{-1} b with
//   A x = x + lam * (deg * x - sum over valid neighbours n of x[n]),
// b [Vp,C] float32 or float64, a [Vp,D] int64 neighbour table masked by a
// [Vp,D] bool table (padded vertices have degree 0, so A = I on them), from
// x0 (zeros if null), stopping once r.r <= tol^2 b.b or after maxiter trips.
// One launch a solve; the trips it ran come back on the device.
//
// Replaces the CG loop that the JAX package's jitted step compiles:
// `jax.scipy.sparse.linalg.cg` in `sobolev_solve`
// (drt_tpu/optimize/precondition.py:61-66), a `lax.while_loop` that XLA
// fuses into a few loops a trip. In torch it ran as 64 Python trips of
// about 20 launches each. Its plain version is `cg_plain` in
// drt_tpu_torch/optimize/precondition.py (the torch `cg` with the same
// operator), which follows jax.scipy.sparse.linalg.cg trip for trip.
//
// Contract: the result and the trip count equal the plain version run on
// the card bit for bit. Every product, sum and quotient is rounded on its
// own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn and their double
// forms), in the order the plain version's torch operations take:
//   A x:   s = +0; s += x[n] for each valid n in table order;
//          Ax = x + lam * (deg * x - s)       (lam rounded to T first)
//   trip:  alpha = gamma / (p.Ap); x += alpha * p; r -= alpha * Ap;
//          gamma' = r.r; p = r + (gamma' / gamma) * p
// and every dot product is summed in one fixed order (`cluster_sum`): the
// flat [Vp*C] vectors are split over the CG_THREADS threads of the
// cluster, element e to thread e % CG_THREADS; each thread sums its
// products in ascending e from +0; then a halving tree over the 32 lanes
// of a warp (lane i takes lane i + h, h = 16, 8, 4, 2, 1), the same tree
// over the 32 warps of a CTA and over the 16 CTAs of the cluster. Every
// CTA forms that last tree itself from the 16 CTA partials, so all hold
// the same alpha and beta and stop on the same trip, and two launches on
// one input give the same bits. A trip starts only while gamma > tol^2
// b.b (the plain version's `go`); once false the loop ends, which leaves
// every value as the plain version's masked trips leave it.
//
// Two routes, one launch of one thread-block cluster of CG_CTAS CTAs of
// CG_BLOCK threads each (cudaLaunchKernelEx with a cluster dimension, which
// a CUDA graph captures), with the same summation order and so the same
// bits. The host picks one from the sizes (`cg_route` in
// optimize/precondition.py, from cg_shared_bytes and the card's budget).
//
// The global route (`cg_kernel`, every size): the CTAs first write the
// neighbour table once a solve as int32 (-1 where invalid, rows padded to
// a multiple of CG_BATCH so that a thread reads them as int4) and the
// degrees as T into the scratch; then each trip is three phases separated
// by the hardware cluster barrier: (1) Ap and p.Ap; (2) alpha, the x and r
// updates and r.r; (3) beta and p. A dot product's CTA partials cross
// distributed shared memory (cluster.map_shared_rank) into a slot of every
// CTA before the barrier that ends the phase; the two reductions of a trip
// use different slots, so a CTA that runs ahead never overwrites a partial
// another has not yet read. The vectors r, p and Ap live in the scratch
// and x in the output, all in L2 at the step's sizes (Vp = 32,768, C = 3:
// 0.39 MB each in float32). Each element is updated only by its own
// thread. The matvec gathers p (written by other CTAs in the trip before)
// with plain loads: the barrier's wait has acquire and its arrive release
// semantics at cluster scope, so by the PTX memory model those loads see
// the writes made before it, and may hit L1 within a phase (on an H100
// they beat loads through L2 alone, __ldcg, by 6-12%, with the same bits:
// reports/torch_cg_gathers.json). A row's neighbours are gathered a batch
// at a time, every load issued before the first add. No host
// synchronisation and no allocation: the wrapper allocates the output, the
// trip count and the scratch.
//
// The shared route (`cg_shared_kernel`, up to Vp = 65,536, d <= 8, C <= 4
// and what fits the card's shared memory): the solve's state leaves the
// scratch. Element e belongs, as in the order above, to thread e %
// CG_THREADS, so CTA k owns the 1,024-element chunks [j CG_THREADS + k
// CG_BLOCK, + CG_BLOCK) for j = 0, 1, ...: r and Ap live at its slot
// ((e >> 14) << 10) | (e & 1023) of CTA (e >> 10) & 15 (`owner_cta`,
// `owner_slot`), r in its owner's registers, Ap in that CTA's shared
// memory; x stays in the output. p lives in shared memory by vertex, four
// elements a vertex, in the CTA that owns the vertex's first element (a
// vertex that straddles two chunks keeps the elements the next chunk owns
// in that chunk's tail slot), and in a copy by vertex in the scratch. Each
// CTA holds a row for every vertex with an element it owns: the valid
// neighbours in table order as uint16 and a word with the vertex, the
// count gathered, the degree and the columns it owns; the rows are built
// once a solve from the int64 table and mask. The matvec runs over the
// rows, a thread a row: a neighbour's four elements come in one 16-byte
// load, from this CTA's shared memory where it holds them, else from p's
// copy in L2 (the barrier's release and acquire order both). Gathering
// those through distributed shared memory instead (ld.shared::cluster)
// measured slower on an H100, where most neighbours lie in another CTA
// (reports/torch_cg_designs.json). Ap goes to the
// owner's slot, in the same CTA; one __syncthreads, then the per-element
// phases read and write shared memory and registers only, besides x and
// p's copy. The two dot products of a trip need no cluster barrier: each
// CTA's partial goes to every CTA with st.async, counted on that CTA's
// mbarrier, which its threads wait on (`cluster_sum_async`); only the end
// of a trip, after p is written, is a cluster barrier (sending a word to
// every CTA in its place measured no faster).
//
// What bounds it: the trips, one after another. Each trip reads the table,
// the degrees and the vectors and writes x, r and p, about 3.5 MB a trip on
// dog_mid45k in the global route (1.0 us at the HBM rate of 3.35 TB/s,
// less from L2, where they stay), against some 20 floating-point
// operations an element (0.03 us at the FP32 rate). A trip depends on the
// whole of the one before, so the trips run one after another on 16 of the
// card's 132 multiprocessors, and each pays its barriers and reductions
// whatever the size: the floor a solve is judged by is that
// fixed cost, which scripts/tune_torch_cg.py measures on a ring too small
// to keep a thread busy. Above it, the global route pays a chain of L2
// round trips an element (table, gathers, streams) and gathers each
// element on its own; the shared route gathers a vertex's elements at
// once, from its own shared memory where it can, and streams nothing but x
// and p's copy (PERF.md, section 6, gives both routes' times).
// -DCG_TRACE=1 builds a library whose kernels stamp clock64() at each
// phase of each trip (CTA 0's thread 0); cg_trace_read copies the stamps
// out (scripts/tune_torch_cg.py prints them).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no --use_fast_math).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace coop = cooperative_groups;

#define CG_BLOCK 1024
#define CG_WARPS (CG_BLOCK / 32)
#define CG_CTAS 16
#define CG_THREADS (CG_BLOCK * CG_CTAS)
#define CG_BATCH 8                  // the table's rows padded to a multiple

#define CG_LOG_BLOCK 10
#define CG_LOG_THREADS 14
#define FULL_MASK 0xffffffffu

static_assert(CG_WARPS == 32, "a CTA's warp partials take one warp's tree");
static_assert(CG_CTAS <= 32 && (CG_CTAS & (CG_CTAS - 1)) == 0,
              "the cluster's tree is a power of two within a warp");
static_assert((1 << CG_LOG_BLOCK) == CG_BLOCK
              && (1 << CG_LOG_THREADS) == CG_THREADS,
              "the ownership map shifts by the block and the cluster");

// -DCG_TRACE=1: CTA 0's thread 0 stamps clock64() at each phase of the
// first CG_TRACE_TRIPS trips, CG_TRACE_STRIDE slots a trip after the
// solve's own CG_TRACE_STRIDE (the layout is scripts/tune_torch_cg.py's).
#ifdef CG_TRACE
#define CG_TRACE_STRIDE 16
#define CG_TRACE_TRIPS 64
#define CG_TRACE_SLOTS (CG_TRACE_STRIDE * (CG_TRACE_TRIPS + 1))
__device__ long long cg_trace[CG_TRACE_SLOTS];
#define CG_STAMP(rank, slot)                                              \
    do {                                                                  \
        if ((rank) == 0 && threadIdx.x == 0 && (slot) >= 0                \
            && (slot) < CG_TRACE_SLOTS)                                   \
            cg_trace[slot] = clock64();                                   \
    } while (0)
#define CG_TRIP_SLOT(trip, i) (CG_TRACE_STRIDE * ((trip) + 1) + (i))
#else
#define CG_STAMP(rank, slot) do {} while (0)
#define CG_TRIP_SLOT(trip, i) (-1)
#endif

// Each operation rounded on its own: no contraction into an fma.
template <typename T> struct Rn;
template <> struct Rn<float> {
    static __device__ __forceinline__ float add(float a, float b) {
        return __fadd_rn(a, b);
    }
    static __device__ __forceinline__ float sub(float a, float b) {
        return __fsub_rn(a, b);
    }
    static __device__ __forceinline__ float mul(float a, float b) {
        return __fmul_rn(a, b);
    }
    static __device__ __forceinline__ float div(float a, float b) {
        return __fdiv_rn(a, b);
    }
};
template <> struct Rn<double> {
    static __device__ __forceinline__ double add(double a, double b) {
        return __dadd_rn(a, b);
    }
    static __device__ __forceinline__ double sub(double a, double b) {
        return __dsub_rn(a, b);
    }
    static __device__ __forceinline__ double mul(double a, double b) {
        return __dmul_rn(a, b);
    }
    static __device__ __forceinline__ double div(double a, double b) {
        return __ddiv_rn(a, b);
    }
};

template <typename T>
struct CgArgs {
    const T* b;
    const T* x0;                 // null: x0 = 0
    const long long* nbr;        // [vp, d]
    const unsigned char* valid;  // [vp, d] bool
    int vp, c, d, dp, maxiter;   // dp: d rounded up to CG_BATCH
    T lam, tol2;
    T* x;                        // [vp, c], the result
    long long* trips;            // [1]
    T* r;                        // scratch: [n] each
    T* p;
    T* ap;
    T* deg;                      // [vp]
    int* table;                  // [vp, dp], -1 where invalid
};

// The halving tree over the first W lanes of a warp: lane 0 ends with the
// sum (lane i takes lane i + h for h = W/2, ..., 1). Every lane must call.
template <typename T, int W>
__device__ __forceinline__ T lane_tree(T v) {
#pragma unroll
    for (int h = W / 2; h > 0; h >>= 1)
        v = Rn<T>::add(v, __shfl_down_sync(FULL_MASK, v, h));
    return v;
}

// K sums of one value a thread over the cluster, in the fixed order of the
// header; every thread of every CTA gets the same K totals in s. slots:
// [K * CG_CTAS] in shared memory, written by every CTA; red: [K *
// CG_WARPS]. Ends with the cluster barrier's wait; every thread must call.
// `stamp`: the trace slot stamped just before the barrier.
template <typename T, int K>
__device__ __forceinline__ void cluster_sum(T (&s)[K], T* slots, T* red,
                                            coop::cluster_group& cluster,
                                            int rank, int stamp = -1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const T w = lane_tree<T, 32>(s[k]);
        if (lane == 0) red[k * CG_WARPS + warp] = w;
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            T v = lane_tree<T, CG_WARPS>(red[k * CG_WARPS + lane]);
            v = __shfl_sync(FULL_MASK, v, 0);
            if (lane < CG_CTAS)
                *cluster.map_shared_rank(&slots[k * CG_CTAS + rank], lane) = v;
        }
    }
    CG_STAMP(rank, stamp);
    cluster.sync();
#pragma unroll
    for (int k = 0; k < K; ++k) {
        T v = lane < CG_CTAS ? slots[k * CG_CTAS + lane] : T(0);
        v = lane_tree<T, CG_CTAS>(v);
        s[k] = __shfl_sync(FULL_MASK, v, 0);
    }
}

// Per type: the neighbours a thread gathers at once (4 or 8: one or two
// int4 of the table) and the elements it loads at once in phases (2) and
// (3); fewer in double, whose registers are twice as many (a CTA of 1,024
// threads has 64 a thread).
template <typename T> struct Tune;
template <> struct Tune<float> {
    static constexpr int batch = 8, unroll = 4;
};
template <> struct Tune<double> {
    static constexpr int batch = 4, unroll = 1;
};

// (A v)[e] for the flat element e of v [vp, c]. A row's neighbours are
// gathered Tune<T>::batch at a time, every load of a batch issued before
// its first add, and added in table order.
template <typename T>
__device__ __forceinline__ T apply_a(const CgArgs<T>& a, const T* v, int e) {
    constexpr int B = Tune<T>::batch;
    const int vtx = e / a.c;
    const int col = e - vtx * a.c;
    const int* row = a.table + (long long)vtx * a.dp;
    const T ve = v[e];
    const T dg = a.deg[vtx];
    T s = T(0);
    for (int j = 0; j < a.dp; j += B) {
        int nb[B];
#pragma unroll
        for (int q = 0; q < B / 4; ++q) {
            const int4 w = *(const int4*)(row + j + 4 * q);
            nb[4 * q] = w.x;
            nb[4 * q + 1] = w.y;
            nb[4 * q + 2] = w.z;
            nb[4 * q + 3] = w.w;
        }
        T val[B];
#pragma unroll
        for (int i = 0; i < B; ++i)
            val[i] = nb[i] >= 0 ? v[(long long)nb[i] * a.c + col] : T(0);
#pragma unroll
        for (int i = 0; i < B; ++i)
            if (nb[i] >= 0) s = Rn<T>::add(s, val[i]);
    }
    const T lx = Rn<T>::sub(Rn<T>::mul(dg, ve), s);
    return Rn<T>::add(ve, Rn<T>::mul(a.lam, lx));
}

template <typename T>
__global__ void __launch_bounds__(CG_BLOCK, 1) cg_kernel(CgArgs<T> a) {
    coop::cluster_group cluster = coop::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int t = rank * CG_BLOCK + (int)threadIdx.x;
    const int n = a.vp * a.c;
    __shared__ T red[2 * CG_WARPS];
    __shared__ T slot_a[CG_CTAS];          // p.Ap
    __shared__ T slot_b[2 * CG_CTAS];      // b.b and r.r, then r.r

    CG_STAMP(rank, 0);
    // the int32 table, -1 where invalid or padded to dp, and the degrees,
    // once a solve; a valid entry in [-vp, 0) is taken from the end, as
    // torch's indexing takes it, and one outside [-vp, vp), on which the
    // plain version raises, is dropped from the sum but counted in the
    // degree (the table must not hold one)
    const long long n_table = (long long)a.vp * a.dp;
    for (long long k = t; k < n_table; k += CG_THREADS) {
        const long long v = k / a.dp;
        const int j = (int)(k - v * a.dp);
        int nb = -1;
        if (j < a.d) {
            const long long src = v * a.d + j;
            long long m = a.nbr[src];
            if (m < 0) m += a.vp;
            if (a.valid[src] && m >= 0 && m < a.vp) nb = (int)m;
        }
        a.table[k] = nb;
    }
    for (int v = t; v < a.vp; v += CG_THREADS) {
        int cnt = 0;
        for (int j = 0; j < a.d; ++j) cnt += a.valid[(long long)v * a.d + j];
        a.deg[v] = T(cnt);
    }
    CG_STAMP(rank, 1);
    cluster.sync();                        // every CTA has started, too
    CG_STAMP(rank, 2);

    // x = x0, r = p = b - A x0; b.b and r.r
    T s0[2] = {T(0), T(0)};
    for (int e = t; e < n; e += CG_THREADS) {
        const T be = a.b[e];
        T xe = T(0), re = be;
        if (a.x0 != nullptr) {
            xe = a.x0[e];
            re = Rn<T>::sub(be, apply_a(a, a.x0, e));
        }
        a.x[e] = xe;
        a.r[e] = re;
        a.p[e] = re;
        s0[0] = Rn<T>::add(s0[0], Rn<T>::mul(be, be));
        s0[1] = Rn<T>::add(s0[1], Rn<T>::mul(re, re));
    }
    CG_STAMP(rank, 3);
    cluster_sum(s0, slot_b, red, cluster, rank, 4);
    CG_STAMP(rank, 5);
    const T atol2 = Rn<T>::mul(a.tol2, s0[0]);
    T gamma = s0[1];

    constexpr int U = Tune<T>::unroll;
    int trips = 0;
    for (; trips < a.maxiter && gamma > atol2; ++trips) {
        CG_STAMP(rank, CG_TRIP_SLOT(trips, 0));
        // (1) Ap and p.Ap, each thread's elements in ascending order
        T s1[1] = {T(0)};
        for (int e = t; e < n; e += CG_THREADS) {
            const T ape = apply_a(a, a.p, e);
            a.ap[e] = ape;
            s1[0] = Rn<T>::add(s1[0], Rn<T>::mul(a.p[e], ape));
        }
        CG_STAMP(rank, CG_TRIP_SLOT(trips, 2));
        cluster_sum(s1, slot_a, red, cluster, rank, CG_TRIP_SLOT(trips, 3));
        CG_STAMP(rank, CG_TRIP_SLOT(trips, 4));
        const T alpha = Rn<T>::div(gamma, s1[0]);
        // (2) x and r, and r.r: U elements loaded, then updated
        T s2[1] = {T(0)};
        for (int e0 = t; e0 < n; e0 += U * CG_THREADS) {
            T xe[U], re[U], pe[U], ae[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int e = e0 + u * CG_THREADS;
                if (e < n) {
                    xe[u] = a.x[e];
                    re[u] = a.r[e];
                    pe[u] = a.p[e];
                    ae[u] = a.ap[e];
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int e = e0 + u * CG_THREADS;
                if (e < n) {
                    a.x[e] = Rn<T>::add(xe[u], Rn<T>::mul(alpha, pe[u]));
                    const T r = Rn<T>::sub(re[u], Rn<T>::mul(alpha, ae[u]));
                    a.r[e] = r;
                    s2[0] = Rn<T>::add(s2[0], Rn<T>::mul(r, r));
                }
            }
        }
        CG_STAMP(rank, CG_TRIP_SLOT(trips, 5));
        cluster_sum(s2, slot_b, red, cluster, rank, CG_TRIP_SLOT(trips, 6));
        CG_STAMP(rank, CG_TRIP_SLOT(trips, 7));
        const T beta = Rn<T>::div(s2[0], gamma);
        // (3) p, then the barrier before the next trip gathers it
        for (int e0 = t; e0 < n; e0 += U * CG_THREADS) {
            T re[U], pe[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int e = e0 + u * CG_THREADS;
                if (e < n) {
                    re[u] = a.r[e];
                    pe[u] = a.p[e];
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int e = e0 + u * CG_THREADS;
                if (e < n) a.p[e] = Rn<T>::add(re[u], Rn<T>::mul(beta, pe[u]));
            }
        }
        gamma = s2[0];
        CG_STAMP(rank, CG_TRIP_SLOT(trips, 8));
        cluster.sync();
        CG_STAMP(rank, CG_TRIP_SLOT(trips, 9));
    }
    if (t == 0) *a.trips = trips;
    CG_STAMP(rank, 6);
}

// ---------------------------------------------------------------------------
// The shared route.

#define CG_SHARED_MAX_D 8         // a row's neighbours: one 16-byte load
#define CG_SHARED_MAX_VP 65536    // a neighbour is a uint16 vertex
#define CG_SHARED_MAX_C 4         // p holds 4 elements a vertex
#define CG_SHARED_HEAD 1024       // the reductions' partials, slots and
                                  // barriers
#define CG_SHARED_ROW 20          // bytes a row: 8 uint16 and its word

static_assert(2 * CG_WARPS * 8 + 3 * CG_CTAS * 8 + 16 <= CG_SHARED_HEAD,
              "the reductions' partials, slots and barriers fit the head");

// Per type: the most chunks a thread owns (its r held in registers: 12 in
// float, Vp = 65,536 at C = 3; 4 in double, Vp = 21,845, where six spill)
// and the neighbours whose four elements the matvec loads at once.
template <typename T> struct SharedTune;
template <> struct SharedTune<float> {
    static constexpr int chunks = 12, batch = 2;
};
template <> struct SharedTune<double> {
    static constexpr int chunks = 4, batch = 1;
};

// The owner of flat element e, as the fixed order assigns it: its CTA and
// its slot there (optimize/precondition.py `cg_owner` states the same).
__host__ __device__ __forceinline__ int owner_cta(int e) {
    return (e >> CG_LOG_BLOCK) & (CG_CTAS - 1);
}
__host__ __device__ __forceinline__ int owner_slot(int e) {
    return ((e >> CG_LOG_THREADS) << CG_LOG_BLOCK) | (e & (CG_BLOCK - 1));
}

// p's layout in shared memory, four elements a vertex: a chunk of CTA k
// (1,024 elements) keeps the vertices whose first element e0 it owns, at
// vertex slot (e0 >> 14) (spc + 1) + (e0 & 1023) / c (spc = 1023 / c + 1),
// and in its slot spc the elements it owns of the vertex that began in the
// chunk before. The quotient is ((e0 & 1023) * magic) >> 20 with magic =
// ceil(2^20 / c), exact for c <= 4. Returns the vertex's first element's
// index in p.
__host__ __device__ __forceinline__ int home_index(int e0, int spc,
                                                   unsigned magic) {
    return ((e0 >> CG_LOG_THREADS) * (spc + 1)
            + (int)(((unsigned)(e0 & (CG_BLOCK - 1)) * magic) >> 20)) * 4;
}
// The index of the elements a chunk holds of the vertex that began in the
// chunk before (e: any element of the chunk).
__host__ __device__ __forceinline__ int tail_index(int e, int spc) {
    return ((e >> CG_LOG_THREADS) * (spc + 1) + spc) * 4;
}

// The vertices with an element in chunk j of CTA k (n elements of c
// columns): their count, 0 past the end, and the first in *first.
__host__ __device__ __forceinline__ int chunk_rows(int k, int j, int n,
                                                   int c, int* first) {
    const int s = j * CG_THREADS + k * CG_BLOCK;
    *first = s / c;
    if (s >= n) return 0;
    const int end = s + CG_BLOCK < n ? s + CG_BLOCK : n;
    return (end - 1) / c - s / c + 1;
}

template <typename T>
struct SharedArgs {
    const T* b;
    const T* x0;                 // null: x0 = 0
    const long long* nbr;        // [vp, d]
    const unsigned char* valid;  // [vp, d] bool
    int vp, c, d, maxiter;
    int chunks;                  // chunks a thread owns at most
    int rows;                    // rows of the CTA that holds the most
    int spc;                     // vertex slots a chunk, less the tail's
    unsigned magic;              // ceil(2^20 / c)
    T lam, tol2;
    T* x;                        // [vp, c], the result
    long long* trips;            // [1]
    T* pg;                       // scratch [vp, 4]: p by vertex, in global
};

// A vertex's four elements of p.
template <typename T> struct Quad {
    T v[4];
};
__device__ __forceinline__ Quad<float> quad_at(const float* at) {
    const float4 q = *(const float4*)at;
    return {{q.x, q.y, q.z, q.w}};
}
__device__ __forceinline__ Quad<double> quad_at(const double* at) {
    const double2 a = *(const double2*)at, b = *(const double2*)(at + 2);
    return {{a.x, a.y, b.x, b.y}};
}

// The shared memory of a CTA of the shared route, laid out by the launch.
template <typename T>
struct SharedMem {
    T* red;              // [2 CG_WARPS]
    T* slot_a;           // [CG_CTAS]: p.Ap
    T* slot_b;           // [2 CG_CTAS]: b.b and r.r, then r.r
    T* p;                // [(chunks (spc + 1) + 1) 4]: p by vertex, then
                         // a quad of zeros for the elements past n
    T* ap;               // [chunks CG_BLOCK]: Ap at the owners' slots
    unsigned short* own; // [chunks CG_BLOCK]: p's index of each own element
    uint4* ent;          // [rows]: the valid neighbours, uint16
    unsigned* word;      // [rows]
};

// dst = A p over this CTA's rows, a thread a row, into dst at the owners'
// slots of the row's columns, which this CTA owns. A neighbour's four
// elements come in one load: from this CTA's shared memory where it holds
// them all, else from p's copy in global memory (L2). A batch's loads are
// issued before its first add, and each column adds its neighbours in
// table order from +0.
template <typename T>
__device__ __forceinline__ void shared_matvec(const SharedMem<T>& m,
                                              const SharedArgs<T>& a,
                                              int rows, int rank) {
    constexpr int B = SharedTune<T>::batch;
    const int lane = threadIdx.x & 31, c = a.c;
    for (int first = threadIdx.x & ~31; first < rows; first += CG_BLOCK) {
        const int row = first + lane;
        unsigned w = 0x0f000000u;          // past the rows: no column
        uint4 nb = make_uint4(0, 0, 0, 0);
        if (row < rows) {
            w = m.word[row];
            nb = m.ent[row];
        }
        const int ng = (w >> 16) & 15, lo = (w >> 24) & 15, hi = w >> 28;
        const T dg = T((int)((w >> 20) & 15));
        const int most = (int)__reduce_max_sync(FULL_MASK, (unsigned)ng);
        const unsigned packed[4] = {nb.x, nb.y, nb.z, nb.w};
        const int e0 = (int)(w & 0xffffu) * c;
        Quad<T> ve = {};
        if (row < rows)
            ve = quad_at(m.p + (lo > 0 ? tail_index(e0 + lo, a.spc)
                                       : home_index(e0, a.spc, a.magic)));
        T s[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
        for (int i0 = 0; i0 < CG_SHARED_MAX_D; i0 += B) {
            if (i0 < most) {
                Quad<T> val[B];
#pragma unroll
                for (int i = 0; i < B; ++i) {
                    const int k = i0 + i;
                    if (k < ng) {
                        const int mv =
                            (int)((packed[k >> 1] >> (16 * (k & 1))) & 0xffffu);
                        const int q = mv * c;
                        const bool whole =
                            (q & (CG_BLOCK - 1)) + c <= CG_BLOCK;
                        const int hq = home_index(q, a.spc, a.magic);
                        if (whole && owner_cta(q) == rank)
                            val[i] = quad_at(m.p + hq);
                        else
                            val[i] = quad_at(a.pg + 4 * mv);
                    }
                }
#pragma unroll
                for (int i = 0; i < B; ++i)
                    if (i0 + i < ng) {
#pragma unroll
                        for (int col = 0; col < CG_SHARED_MAX_C; ++col)
                            s[col] = Rn<T>::add(s[col], val[i].v[col]);
                    }
            }
        }
#pragma unroll
        for (int col = 0; col < CG_SHARED_MAX_C; ++col) {
            if (col >= lo && col <= hi) {
                const T lx = Rn<T>::sub(Rn<T>::mul(dg, ve.v[col]), s[col]);
                m.ap[owner_slot(e0 + col)] =
                    Rn<T>::add(ve.v[col], Rn<T>::mul(a.lam, lx));
            }
        }
    }
}

// t, hidden from the compiler: a phase recomputes its addresses from it
// rather than keep twelve 64-bit addresses live across the trips.
__device__ __forceinline__ int fresh(int t) {
    asm volatile("" : "+r"(t));
    return t;
}

// v into shared::cluster address `at`, counted (its bytes) on the
// mbarrier at shared::cluster address `bar`.
template <typename T> __device__ __forceinline__ void st_async(unsigned at,
                                                              T v,
                                                              unsigned bar);
template <> __device__ __forceinline__ void st_async<float>(unsigned at,
                                                            float v,
                                                            unsigned bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
                 " [%0], %1, [%2];"
                 :: "r"(at), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
template <> __device__ __forceinline__ void st_async<double>(unsigned at,
                                                             double v,
                                                             unsigned bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64"
                 " [%0], %1, [%2];"
                 :: "r"(at), "l"(__double_as_longlong(v)), "r"(bar)
                 : "memory");
}

// The address in the cluster's shared window of `local` (an address in
// this CTA's shared memory) in CTA `rank`.
__device__ __forceinline__ unsigned cluster_addr(unsigned local, int rank) {
    unsigned out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(out) : "r"(local), "r"(rank));
    return out;
}

// A sum of one value a thread over the cluster, in the fixed order of the
// header, without a cluster barrier: warp 0 of each CTA sends its CTA's
// partial into slot `rank` of every CTA with st.async, which counts its
// bytes on that CTA's mbarrier `bar`; each thread waits for its own CTA's
// barrier to complete phase `parity` (all CG_CTAS partials in) and forms
// the last tree itself. A CTA cannot send a partial of the next use of a
// barrier before every CTA has finished reading this use's slots: that
// needs every CTA's partial of the reduction in between, which each sends
// only after it has read. Every thread must call.
template <typename T>
__device__ __forceinline__ T cluster_sum_async(T s, T* slots, T* red,
                                               unsigned long long* bar,
                                               unsigned parity, int rank,
                                               int stamp = -1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
    const T w = lane_tree<T, 32>(s);
    if (lane == 0) red[warp] = w;
    __syncthreads();
    if (warp == 0) {
        T v = lane_tree<T, CG_WARPS>(red[lane]);
        v = __shfl_sync(FULL_MASK, v, 0);
        if (lane == 0) {
            unsigned long long state;
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1],"
                         " %2;"
                         : "=l"(state) : "r"(b), "r"(CG_CTAS * (int)sizeof(T))
                         : "memory");
        }
        if (lane < CG_CTAS)
            st_async<T>(cluster_addr((unsigned)__cvta_generic_to_shared(
                                         &slots[rank]), lane),
                        v, cluster_addr(b, lane));
    }
    CG_STAMP(rank, stamp);
    unsigned done = 0;
    while (!done)
        asm volatile("{\n .reg .pred q;\n"
                     " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64"
                     " q, [%1], %2;\n selp.u32 %0, 1, 0, q;\n}"
                     : "=r"(done) : "r"(b), "r"(parity) : "memory");
    T v = lane < CG_CTAS ? slots[lane] : T(0);
    v = lane_tree<T, CG_CTAS>(v);
    return __shfl_sync(FULL_MASK, v, 0);
}

// The vertex of element e (< 2^30) of c columns: e / c by a multiply.
__device__ __forceinline__ int vertex_of(int e, int c, unsigned magic32) {
    return c == 1 ? e : (int)__umulhi((unsigned)e, magic32);
}

template <typename T, int CHUNKS>
__global__ void __launch_bounds__(CG_BLOCK, 1)
    cg_shared_kernel(SharedArgs<T> a) {
    extern __shared__ __align__(16) unsigned char smem[];
    coop::cluster_group cluster = coop::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int tid = (int)threadIdx.x;
    const int t = rank * CG_BLOCK + tid;
    const int c = a.c, n = a.vp * a.c, chunks = a.chunks;
    const unsigned magic32 = c == 1 ? 0u : 0xffffffffu / (unsigned)c + 1u;
    SharedMem<T> m;
    m.red = (T*)smem;
    m.slot_a = m.red + 2 * CG_WARPS;
    m.slot_b = m.slot_a + CG_CTAS;
    // the reductions' barriers, one for p.Ap and one for r.r
    unsigned long long* bars =
        (unsigned long long*)(smem + CG_SHARED_HEAD) - 2;
    m.p = (T*)(smem + CG_SHARED_HEAD);
    const int zeros = chunks * (a.spc + 1) * 4;   // the quad past n
    m.ap = m.p + zeros + 4;
    m.own = (unsigned short*)(m.ap + chunks * CG_BLOCK);
    m.ent = (uint4*)(m.own + chunks * CG_BLOCK);
    m.word = (unsigned*)(m.ent + a.rows);
    CG_STAMP(rank, 0);

    // once a solve: this CTA's rows, chunk by chunk: the valid neighbours
    // in table order (an entry in [-vp, 0) taken from the end, as torch's
    // indexing takes it; one outside [-vp, vp) dropped from the sum but
    // counted in the degree, as the global route does), and the word:
    // vertex | gathered << 16 | degree << 20 | first column << 24 | last
    // column << 28, the columns this CTA owns; and p's index of each own
    // element (the zeros past n)
    int rows = 0;
    for (int j = 0; j < chunks; ++j) {
        int first;
        rows += chunk_rows(rank, j, n, c, &first);
    }
    for (int row = tid; row < rows; row += CG_BLOCK) {
        int j = 0, base = 0, first = 0;
        for (; j < chunks; ++j) {
            const int cnt = chunk_rows(rank, j, n, c, &first);
            if (row < base + cnt) break;
            base += cnt;
        }
        const int v = first + row - base;
        const int s = j * CG_THREADS + rank * CG_BLOCK;
        const int end = s + CG_BLOCK < n ? s + CG_BLOCK : n;
        const int lo = max(s - v * c, 0), hi = min(end - 1 - v * c, c - 1);
        const long long at = (long long)v * a.d;
        long long nv[CG_SHARED_MAX_D];
        bool ok[CG_SHARED_MAX_D];
#pragma unroll
        for (int q = 0; q < CG_SHARED_MAX_D; ++q) {   // every load first
            ok[q] = q < a.d && a.valid[at + q];
            nv[q] = q < a.d ? a.nbr[at + q] : 0;
        }
        unsigned short* out = (unsigned short*)(m.ent + row);
        int deg = 0, ng = 0;
#pragma unroll
        for (int q = 0; q < CG_SHARED_MAX_D; ++q) {
            if (!ok[q]) continue;
            ++deg;
            const long long u = nv[q] < 0 ? nv[q] + a.vp : nv[q];
            if (u >= 0 && u < a.vp) out[ng++] = (unsigned short)u;
        }
        m.word[row] = (unsigned)v | ((unsigned)ng << 16)
                      | ((unsigned)deg << 20) | ((unsigned)lo << 24)
                      | ((unsigned)hi << 28);
    }
    for (int j = 0; j < chunks; ++j) {
        const int e = j * CG_THREADS + t;
        const int e0 = vertex_of(e, c, magic32) * c;
        m.own[j * CG_BLOCK + tid] = (unsigned short)(
            e >= n ? zeros
            : (e0 >> CG_LOG_BLOCK) == (e >> CG_LOG_BLOCK)
                ? home_index(e0, a.spc, a.magic) + e - e0
                : tail_index(e, a.spc) + e - e0);
    }
    if (tid < 4) m.p[zeros + tid] = T(0);
    if (tid < 2) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"((unsigned)__cvta_generic_to_shared(bars + tid))
                     : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    CG_STAMP(rank, 1);
    cluster.sync();            // every CTA has started, with its rows
    CG_STAMP(rank, 2);

    // x = x0 (in the output), r = b - A x0 (b if no x0, in registers), p =
    // r; b.b and r.r. Elements past n hold zeros and add +0 to the sums.
    if (a.x0 != nullptr) {     // A x0, from x0 in p's place
        const int tx = fresh(t);
#pragma unroll
        for (int j = 0; j < CHUNKS; ++j) {
            const int e = j * CG_THREADS + tx;
            if (j < chunks && e < n) {
                const T xe = a.x0[e];
                m.p[m.own[j * CG_BLOCK + tid]] = xe;
                const int v = vertex_of(e, c, magic32);
                a.pg[4 * v + e - v * c] = xe;
            }
        }
        cluster.sync();
        shared_matvec(m, a, rows, rank);
        __syncthreads();
    }
    T r[CHUNKS];
    T s0[2] = {T(0), T(0)};
    const int tb = fresh(t);
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
        const int e = j * CG_THREADS + tb;
        r[j] = T(0);
        if (j < chunks) {
            const bool in = e < n;
            T be = T(0);
            if (in) be = a.b[e];
            const T re = a.x0 != nullptr
                ? Rn<T>::sub(be, m.ap[j * CG_BLOCK + tid]) : be;
            r[j] = in ? re : T(0);
            if (in) a.x[e] = a.x0 != nullptr ? a.x0[e] : T(0);
            s0[0] = Rn<T>::add(s0[0], Rn<T>::mul(be, be));
            s0[1] = Rn<T>::add(s0[1], Rn<T>::mul(r[j], r[j]));
        }
    }
    if (a.x0 != nullptr) cluster.sync();   // every gather of x0 is done
    const int tp = fresh(t);
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
        const int e = j * CG_THREADS + tp;
        if (j < chunks && e < n) {
            m.p[m.own[j * CG_BLOCK + tid]] = r[j];
            const int v = vertex_of(e, c, magic32);
            a.pg[4 * v + e - v * c] = r[j];
        }
    }
    CG_STAMP(rank, 3);
    cluster_sum(s0, m.slot_b, m.red, cluster, rank, 4);  // orders p's writes
    CG_STAMP(rank, 5);
    const T atol2 = Rn<T>::mul(a.tol2, s0[0]);
    T gamma = s0[1];

    int trips = 0;
    for (; trips < a.maxiter && gamma > atol2; ++trips) {
        CG_STAMP(rank, CG_TRIP_SLOT(trips, 0));
        // (1) Ap over the rows, then p.Ap over the own elements in
        // ascending order; x's loads issued here, used in (2)
        shared_matvec(m, a, rows, rank);
        __syncthreads();
        CG_STAMP(rank, CG_TRIP_SLOT(trips, 1));
        T xe[CHUNKS];
        T s1[1] = {T(0)};
        const int t1 = fresh(t);
#pragma unroll
        for (int j = 0; j < CHUNKS; ++j) {
            const int e = j * CG_THREADS + t1;
            xe[j] = T(0);
            if (j < chunks) {
                if (e < n) xe[j] = a.x[e];
                const int o = j * CG_BLOCK + tid;
                const T pa = Rn<T>::mul(m.p[m.own[o]], m.ap[o]);
                s1[0] = Rn<T>::add(s1[0], e < n ? pa : T(0));
            }
        }
        CG_STAMP(rank, CG_TRIP_SLOT(trips, 2));
        s1[0] = cluster_sum_async(s1[0], m.slot_a, m.red, bars,
                                  (unsigned)trips & 1u, rank,
                                  CG_TRIP_SLOT(trips, 3));
        CG_STAMP(rank, CG_TRIP_SLOT(trips, 4));
        const T alpha = Rn<T>::div(gamma, s1[0]);
        // (2) x and r, and r.r
        T s2[1] = {T(0)};
        const int t2 = fresh(t);
#pragma unroll
        for (int j = 0; j < CHUNKS; ++j) {
            const int e = j * CG_THREADS + t2;
            if (j < chunks) {
                const int o = j * CG_BLOCK + tid;
                const T xn = Rn<T>::add(xe[j],
                                        Rn<T>::mul(alpha, m.p[m.own[o]]));
                if (e < n) a.x[e] = xn;
                const T rn = Rn<T>::sub(r[j], Rn<T>::mul(alpha, m.ap[o]));
                r[j] = e < n ? rn : T(0);
                s2[0] = Rn<T>::add(s2[0], Rn<T>::mul(r[j], r[j]));
            }
        }
        CG_STAMP(rank, CG_TRIP_SLOT(trips, 5));
        s2[0] = cluster_sum_async(s2[0], m.slot_b, m.red, bars + 1,
                                  (unsigned)trips & 1u, rank,
                                  CG_TRIP_SLOT(trips, 6));
        CG_STAMP(rank, CG_TRIP_SLOT(trips, 7));
        const T beta = Rn<T>::div(s2[0], gamma);
        // (3) p, in shared memory and in its global copy, then the
        // barrier before the next trip gathers it
        const int t3 = fresh(t);
#pragma unroll
        for (int j = 0; j < CHUNKS; ++j) {
            const int e = j * CG_THREADS + t3;
            if (j < chunks && e < n) {
                const int i = m.own[j * CG_BLOCK + tid];
                const T pn = Rn<T>::add(r[j], Rn<T>::mul(beta, m.p[i]));
                m.p[i] = pn;
                const int v = vertex_of(e, c, magic32);
                a.pg[4 * v + e - v * c] = pn;
            }
        }
        gamma = s2[0];
        CG_STAMP(rank, CG_TRIP_SLOT(trips, 8));
        cluster.sync();
        CG_STAMP(rank, CG_TRIP_SLOT(trips, 9));
    }
    if (t == 0) *a.trips = trips;
    CG_STAMP(rank, 6);
}

// ---------------------------------------------------------------------------

static int g_ready = -1;

static cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr,
                                         cudaStream_t s) {
    cudaLaunchConfig_t cfg = {};
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = CG_CTAS;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.gridDim = dim3(CG_CTAS);
    cfg.blockDim = dim3(CG_BLOCK);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// 1 if the card can hold one cluster of CG_CTAS CTAs of the kernel for both
// types (computed at the first call, outside any capture), else 0.
static int cluster_ready() {
    if (g_ready >= 0) return g_ready;
    const void* fns[2] = {(const void*)cg_kernel<float>,
                          (const void*)cg_kernel<double>};
    int ok = 1;
    for (const void* fn : fns) {
        if (cudaFuncSetAttribute(
                fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)
            != cudaSuccess) {
            cudaGetLastError();
            ok = 0;
            continue;
        }
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg = cluster_config(&attr, 0);
        int n = 0;
        if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess
            || n < 1) {
            cudaGetLastError();
            ok = 0;
        }
    }
    g_ready = ok;
    return ok;
}

static long long align_up(long long bytes) { return (bytes + 255) / 256 * 256; }

static int dp_of(int d) { return (d + CG_BATCH - 1) / CG_BATCH * CG_BATCH; }

template <typename T>
static cudaError_t launch(const void* b, const void* x0, const long long* nbr,
                          const unsigned char* valid, int vp, int c, int d,
                          double lam, double tol2, int maxiter, void* x,
                          long long* trips, void* scratch, cudaStream_t s) {
    const long long n = (long long)vp * c;
    char* base = (char*)scratch;
    const long long vec = align_up(n * (long long)sizeof(T));
    CgArgs<T> a;
    a.b = (const T*)b;
    a.x0 = (const T*)x0;
    a.nbr = nbr;
    a.valid = valid;
    a.vp = vp;
    a.c = c;
    a.d = d;
    a.dp = dp_of(d);
    a.maxiter = maxiter;
    a.lam = (T)lam;                 // as torch rounds a Python number
    a.tol2 = (T)tol2;
    a.x = (T*)x;
    a.trips = trips;
    a.r = (T*)base;
    a.p = (T*)(base + vec);
    a.ap = (T*)(base + 2 * vec);
    a.deg = (T*)(base + 3 * vec);
    a.table = (int*)(base + 3 * vec + align_up(vp * (long long)sizeof(T)));
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(&attr, s);
    return cudaLaunchKernelEx(&cfg, cg_kernel<T>, a);
}

static int g_shared_budget = -1;

template <typename T>
using SharedKernel = void (*)(SharedArgs<T>);

// The shared route's kernel for `chunks` chunks a thread: the least of
// SharedTune<T>::chunks / 4, / 2 and itself that holds them (fewer
// chunks, fewer unrolled guards in every per-element phase).
template <typename T>
static SharedKernel<T> shared_kernel(int chunks) {
    constexpr int most = SharedTune<T>::chunks;
    if (chunks <= most / 4) return cg_shared_kernel<T, most / 4>;
    if (chunks <= most / 2) return cg_shared_kernel<T, most / 2>;
    return cg_shared_kernel<T, most>;
}

// The dynamic shared memory a CTA of the shared route may take on this
// card (its opt-in maximum less the kernel's static shared memory), if the
// card schedules one cluster of CG_CTAS such CTAs of every one of its
// kernels, else 0 (computed at the first call, outside any capture).
static int shared_budget() {
    if (g_shared_budget >= 0) return g_shared_budget;
    int dev = 0, optin = 0, budget = 0;
    if (cudaGetDevice(&dev) == cudaSuccess
        && cudaDeviceGetAttribute(&optin,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev) == cudaSuccess) {
        budget = optin;
        const void* fns[6] = {
            (const void*)shared_kernel<float>(1),
            (const void*)shared_kernel<float>(SharedTune<float>::chunks / 2),
            (const void*)shared_kernel<float>(SharedTune<float>::chunks),
            (const void*)shared_kernel<double>(1),
            (const void*)shared_kernel<double>(SharedTune<double>::chunks / 2),
            (const void*)shared_kernel<double>(SharedTune<double>::chunks)};
        for (const void* fn : fns) {
            cudaFuncAttributes fa;
            int clusters = 0;
            cudaLaunchAttribute attr;
            cudaLaunchConfig_t cfg = cluster_config(&attr, 0);
            if (cudaFuncGetAttributes(&fa, fn) != cudaSuccess) {
                budget = 0;
                break;
            }
            const int mine = optin - (int)fa.sharedSizeBytes;
            cfg.dynamicSmemBytes = mine;
            if (cudaFuncSetAttribute(
                    fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)
                    != cudaSuccess
                || cudaFuncSetAttribute(
                       fn, cudaFuncAttributeMaxDynamicSharedMemorySize, mine)
                       != cudaSuccess
                || cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg)
                       != cudaSuccess
                || clusters < 1) {
                budget = 0;
                break;
            }
            budget = mine < budget ? mine : budget;
        }
    }
    cudaGetLastError();
    g_shared_budget = budget;
    return budget;
}

static int shared_chunks(long long n) {
    return (int)((n + CG_THREADS - 1) / CG_THREADS);
}

// The rows of the CTA that holds the most, for vp vertices of c columns.
static int shared_rows(int vp, int c) {
    const int n = vp * c, chunks = shared_chunks(n);
    int most = 0;
    for (int k = 0; k < CG_CTAS; ++k) {
        int rows = 0, first;
        for (int j = 0; j < chunks; ++j)
            rows += chunk_rows(k, j, n, c, &first);
        most = rows > most ? rows : most;
    }
    return most;
}

static int shared_spc(int c) { return (CG_BLOCK - 1) / c + 1; }

static long long shared_bytes(long long vp, int c, int d, int f64) {
    if (vp < 0 || vp > CG_SHARED_MAX_VP || c < 1 || c > CG_SHARED_MAX_C
        || d < 0 || d > CG_SHARED_MAX_D)
        return -1;
    const long long size = f64 ? 8 : 4;
    const long long chunks = shared_chunks(vp * c);
    if (chunks > (f64 ? SharedTune<double>::chunks
                      : SharedTune<float>::chunks))
        return -1;
    return CG_SHARED_HEAD + (chunks * (shared_spc(c) + 1) + 1) * 4 * size
           + chunks * CG_BLOCK * (size + 2)
           + (long long)shared_rows((int)vp, c) * CG_SHARED_ROW;
}

template <typename T>
static cudaError_t launch_shared(const void* b, const void* x0,
                                 const long long* nbr,
                                 const unsigned char* valid, int vp, int c,
                                 int d, double lam, double tol2, int maxiter,
                                 void* x, long long* trips, void* scratch,
                                 long long bytes, cudaStream_t s) {
    SharedArgs<T> a;
    a.b = (const T*)b;
    a.x0 = (const T*)x0;
    a.nbr = nbr;
    a.valid = valid;
    a.vp = vp;
    a.c = c;
    a.d = d;
    a.maxiter = maxiter;
    a.chunks = shared_chunks((long long)vp * c);
    a.rows = shared_rows(vp, c);
    a.spc = shared_spc(c);
    a.magic = ((1u << 20) + c - 1) / c;
    a.lam = (T)lam;                 // as torch rounds a Python number
    a.tol2 = (T)tol2;
    a.x = (T*)x;
    a.trips = trips;
    a.pg = (T*)scratch;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(&attr, s);
    cfg.dynamicSmemBytes = (size_t)bytes;
    return cudaLaunchKernelEx(&cfg, shared_kernel<T>(a.chunks), a);
}

extern "C" {

// The threads of the fixed summation order, for the plain version.
int cg_ctas() { return CG_CTAS; }
int cg_block() { return CG_BLOCK; }

// 1 if the card schedules the kernel's cluster (computed at the first
// call), else 0.
int cg_cluster_ready() { return cluster_ready(); }

// Bytes of scratch cg_launch needs for b [vp, c] of T (double with f64)
// and a [vp, d] table.
long long cg_scratch_bytes(long long vp, int c, int d, int f64) {
    const long long size = f64 ? 8 : 4;
    return 3 * align_up(vp * c * size) + align_up(vp * size)
           + vp * dp_of(d) * 4;
}

// The arguments of cg_launch, for the wrapper's interface check.
const char* cg_signature() {
    return "b x0 f64 nbr valid vp c d lam tol2 maxiter x trips scratch "
           "stream";
}

// Launches the solve on `stream` and returns the first CUDA error; does not
// synchronise. b and x [vp, c] float (double with f64), x0 the same or
// null, nbr [vp, d] int64, valid [vp, d] bool, trips one int64, scratch
// cg_scratch_bytes(vp, c, d, f64) bytes; all contiguous on one device, vp *
// c and vp * d below 2^31. tol2 is tol * tol.
int cg_launch(const void* b, const void* x0, int f64, const long long* nbr,
              const unsigned char* valid, int vp, int c, int d, double lam,
              double tol2, int maxiter, void* x, long long* trips,
              void* scratch, void* stream) {
    if (vp < 0 || c < 1 || d < 0 || maxiter < 0)
        return (int)cudaErrorInvalidValue;
    if (!cluster_ready()) return (int)cudaErrorNotSupported;
    cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t err =
        f64 ? launch<double>(b, x0, nbr, valid, vp, c, d, lam, tol2, maxiter,
                             x, trips, scratch, s)
            : launch<float>(b, x0, nbr, valid, vp, c, d, lam, tol2, maxiter,
                            x, trips, scratch, s);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Bytes of dynamic shared memory a CTA of the shared route takes for b
// [vp, c] of T (double with f64) and a [vp, d] table, -1 where the route
// does not take the solve (vp above 65,536, d above 8, c above 4, or more
// chunks a thread than it holds in registers).
long long cg_shared_bytes(long long vp, int c, int d, int f64) {
    return shared_bytes(vp, c, d, f64);
}

// The shared memory a CTA of the shared route may take on this card, 0 if
// the card schedules none of its clusters (computed at the first call).
int cg_shared_budget() { return shared_budget(); }

// Bytes of scratch cg_shared_launch needs for b [vp, c] of T (double with
// f64): p by vertex, four elements each.
long long cg_shared_scratch_bytes(long long vp, int f64) {
    return vp * 4 * (f64 ? 8 : 4);
}

// The arguments of cg_shared_launch, for the wrapper's interface check.
const char* cg_shared_signature() {
    return "b x0 f64 nbr valid vp c d lam tol2 maxiter x trips scratch "
           "stream";
}

// Launches the solve through the shared route on `stream` and returns the
// first CUDA error; does not synchronise. The arguments are cg_launch's,
// with cg_shared_scratch_bytes(vp, f64) bytes of scratch (16-byte
// aligned); cg_shared_bytes(vp, c, d, f64) must be at least 0 and at most
// cg_shared_budget().
int cg_shared_launch(const void* b, const void* x0, int f64,
                     const long long* nbr, const unsigned char* valid, int vp,
                     int c, int d, double lam, double tol2, int maxiter,
                     void* x, long long* trips, void* scratch, void* stream) {
    if (vp < 0 || c < 1 || d < 0 || maxiter < 0)
        return (int)cudaErrorInvalidValue;
    const int budget = shared_budget();
    if (budget < 1) return (int)cudaErrorNotSupported;
    const long long bytes = shared_bytes(vp, c, d, f64);
    if (bytes < 0 || bytes > budget) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t err =
        f64 ? launch_shared<double>(b, x0, nbr, valid, vp, c, d, lam, tol2,
                                    maxiter, x, trips, scratch, bytes, s)
            : launch_shared<float>(b, x0, nbr, valid, vp, c, d, lam, tol2,
                                   maxiter, x, trips, scratch, bytes, s);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

#ifdef CG_TRACE
// The trace's slots, and its stamps copied to host memory `to` (0 where no
// stamp was taken) or cleared.
int cg_trace_slots() { return CG_TRACE_SLOTS; }

int cg_trace_read(long long* to) {
    return (int)cudaMemcpyFromSymbol(to, cg_trace, sizeof(cg_trace));
}

int cg_trace_clear() {
    static const long long zeros[CG_TRACE_SLOTS] = {};
    return (int)cudaMemcpyToSymbol(cg_trace, zeros, sizeof(zeros));
}
#endif

}  // extern "C"
