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
// Design: one launch of one thread-block cluster of CG_CTAS CTAs of
// CG_BLOCK threads (cudaLaunchKernelEx with a cluster dimension, which a
// CUDA graph captures). The CTAs first write the neighbour table once a
// solve as int32 (-1 where invalid, rows padded to a multiple of CG_BATCH
// so that a thread reads them as int4) and the degrees as T into the
// scratch; then each trip is three phases separated by the hardware
// cluster barrier: (1) Ap and p.Ap; (2) alpha, the x and r updates and
// r.r; (3) beta and p. A dot product's CTA partials cross distributed
// shared memory (cluster.map_shared_rank) into a slot of every CTA before
// the barrier that ends the phase; the two reductions of a trip use
// different slots, so a CTA that runs ahead never overwrites a partial
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
// What bounds it: the trips, one after another. Each trip reads the table,
// the degrees and the vectors and writes x, r and p: about 3.5 MB a trip on
// dog_mid45k (1.0 us at the HBM rate of 3.35 TB/s, less from L2, where they
// stay), against some 20 floating-point operations an element (0.03 us at
// the FP32 rate). A trip depends on the whole of the one before, so the
// trips run one after another on 16 of the card's 132 multiprocessors, and
// each pays the three cluster barriers and the reductions whatever the
// size. scripts/tune_torch_cg.py times a trip at three mesh sizes and on a
// ring too small to keep a thread busy, which leaves that fixed cost alone
// (PERF.md, section 6, gives the times). What a trip adds for each vertex
// is reckoned, not measured by counters, to be the L1 of 16
// multiprocessors serving the matvec's scattered gathers a cache line at a
// time; a grid over the whole card would spread them (not tried).
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
#define FULL_MASK 0xffffffffu

static_assert(CG_WARPS == 32, "a CTA's warp partials take one warp's tree");
static_assert(CG_CTAS <= 32 && (CG_CTAS & (CG_CTAS - 1)) == 0,
              "the cluster's tree is a power of two within a warp");

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
template <typename T, int K>
__device__ __forceinline__ void cluster_sum(T (&s)[K], T* slots, T* red,
                                            coop::cluster_group& cluster,
                                            int rank) {
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
    cluster.sync();                        // every CTA has started, too

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
    cluster_sum(s0, slot_b, red, cluster, rank);
    const T atol2 = Rn<T>::mul(a.tol2, s0[0]);
    T gamma = s0[1];

    constexpr int U = Tune<T>::unroll;
    int trips = 0;
    for (; trips < a.maxiter && gamma > atol2; ++trips) {
        // (1) Ap and p.Ap, each thread's elements in ascending order
        T s1[1] = {T(0)};
        for (int e = t; e < n; e += CG_THREADS) {
            const T ape = apply_a(a, a.p, e);
            a.ap[e] = ape;
            s1[0] = Rn<T>::add(s1[0], Rn<T>::mul(a.p[e], ape));
        }
        cluster_sum(s1, slot_a, red, cluster, rank);
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
        cluster_sum(s2, slot_b, red, cluster, rank);
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
        cluster.sync();
    }
    if (t == 0) *a.trips = trips;
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

}  // extern "C"
