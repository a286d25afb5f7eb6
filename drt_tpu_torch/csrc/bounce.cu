// The per-lane chain of a refraction bounce and the ray loss's per-lane
// tail for Hopper (sm_90a), forward and backward, bound through ctypes.
// Four kernels, each templated on float and double:
//
//   bounce_fwd_kernel    a lane's ray (origin, direction) and the nine
//                        coordinates of the triangle the oracle matched it
//                        to -> the Moller-Trumbore re-intersection (t, n),
//                        the Snell refraction, the nudged new origin, the
//                        lane's new active flag and face id, and the parked
//                        ray on a lane that died;
//   bounce_bwd_kernel    its vector-Jacobian product into the origin, the
//                        direction and the nine coordinates;
//   ray_tail_fwd_kernel  the ray loss's tail: the target direction from the
//                        exit origin to the matted screen point, the
//                        squared difference, the mask, the optional Huber
//                        branch and the sum over lanes, in one fixed tree;
//   ray_tail_bwd_kernel  its gradient into the exit directions.
//
// Replaces what XLA fuses of the JAX package's trace
// (drt_tpu/render/trace.py:207-260 `_bounce` after its oracle query, with
// `refract_ray` :73-122, `moller_trumbore_verts` drt_tpu/geometry/mt.py:37,
// `safe_normalize` and `refract` drt_tpu/geometry/vec.py:22,34) and of its
// ray loss (drt_tpu/optimize/losses.py:77-105 with
// drt_tpu/render/trace.py:317-322). In torch the chain ran as about 200
// operations forward and 183 in autograd's backward on [N] and [N,3]
// tensors. The plain versions are `bounce_plain`,
// `bounce_plain_backward`, `ray_tail_plain` and `ray_tail_plain_backward`
// in drt_tpu_torch/render/bounce.py, torch operations in this file's order
// on the lanes' components.
//
// Contract: every output equals the plain version run on the card bit for
// bit. Every product, quotient, sum and square root is rounded on its own
// (__fmul_rn, __fdiv_rn, __fadd_rn, __fsqrt_rn and their double forms), in
// the order the plain version's torch operations take: a dot product is
// (a0 b0 + a1 b1) + a2 b2, a cross product's component a1 b2 - a2 b1, a
// clamp torch.maximum then torch.minimum (NaN kept as torch keeps it), and
// a clamp's backward splits the cotangent at a tie (x == bound) in halves,
// as torch.maximum's backward and JAX's clip do. A number of the host
// (an index of refraction, an epsilon) is rounded to the lanes' type
// first, as a 0-d tensor of that type holds it.
//
// Bounds: every kernel reads each input once and writes each output once,
// and does about 107 rounded operations a live lane forward (183
// backward, 273 with the origin's cotangent; the tail 21 and 24): on an
// H100 the bytes bound it (a bounce forward moves at most 24 + 36 + 10 +
// 24 + 9 bytes a float32 lane, about 0.04 ms at 1,228,800 lanes and 3.35
// TB/s; chip_smoke.py `bounce_bound` counts what a run's masks need). One
// thread a lane; the backward recomputes the lane's forward in registers
// rather than reading stored intermediates. A lane that is dead (or not
// counted by the loss) skips the arithmetic and writes its parked ray or
// its zeros. No host synchronisation, no allocation: the wrapper allocates
// every output and the tail's scratch.
//
// The tail's sum: RAY_TAIL_BLOCKS blocks of RAY_TAIL_BLOCK threads; thread
// j of the grid adds the values of lanes j, j + G, j + 2G, ... (G the
// grid's threads) in that order to +0; then a halving tree over the block's
// threads in shared memory (thread i takes thread i + h, h = BLOCK/2, ...,
// 1), each block's partial to the scratch, and the last block to finish
// (an integer counter, zeroed by the wrapper) forms the same halving tree
// over the RAY_TAIL_BLOCKS partials in block order. The order depends on
// the lane count alone, never on which block ends last.

#include <cuda_runtime.h>

#define BOUNCE_BLOCK 256
#define RAY_TAIL_BLOCK 256
#define RAY_TAIL_BLOCKS 1024

// -- arithmetic, each operation rounded on its own -------------------------

#define DEVICE static __device__ __forceinline__

DEVICE float add(float a, float b) { return __fadd_rn(a, b); }
DEVICE double add(double a, double b) { return __dadd_rn(a, b); }
DEVICE float mul(float a, float b) { return __fmul_rn(a, b); }
DEVICE double mul(double a, double b) { return __dmul_rn(a, b); }
DEVICE float dvd(float a, float b) { return __fdiv_rn(a, b); }
DEVICE double dvd(double a, double b) { return __ddiv_rn(a, b); }
DEVICE float root(float a) { return __fsqrt_rn(a); }
DEVICE double root(double a) { return __dsqrt_rn(a); }

// a - b is a + (-b), bit for bit
template <typename T>
DEVICE T sub(T a, T b) { return add(a, -b); }

template <typename T>
DEVICE T absv(T a) {
    return a < T(0) ? -a : (a == T(0) ? T(0) : a);
}

// torch.maximum / torch.minimum: a NaN operand is the result
template <typename T>
DEVICE T maxv(T a, T b) {
    return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename T>
DEVICE T minv(T a, T b) {
    return a != a ? a : (b != b ? b : (a < b ? a : b));
}

// The cotangent of x through maximum(x, c) / minimum(x, c) for a constant
// c: all of it, half at a tie, none where the other side was taken (as
// torch.maximum's backward: where(x == c, g / 2, g), 0 where x < c).
template <typename T>
DEVICE T gate_max(T x, T c, T g) {
    return x < c ? T(0) : (x == c ? mul(g, T(0.5)) : g);
}
template <typename T>
DEVICE T gate_min(T x, T c, T g) {
    return x > c ? T(0) : (x == c ? mul(g, T(0.5)) : g);
}

template <typename T>
DEVICE T dot(const T a[3], const T b[3]) {
    return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
}

template <typename T>
DEVICE void cross(const T a[3], const T b[3], T out[3]) {
    out[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
    out[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
    out[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

// -- the bounce --------------------------------------------------------------

template <typename T>
struct Params {
    T inn, ext, offset_eps, offset_rel, det_eps, eps20, eps12;
    int compat;
};

template <typename T>
static Params<T> params_of(double int_ior, double ext_ior,
                           double offset_eps, int compat) {
    Params<T> p;
    p.inn = (T)int_ior;
    p.ext = (T)ext_ior;
    p.offset_eps = (T)offset_eps;
    p.offset_rel = (T)1e-4;
    p.det_eps = (T)1e-12;
    p.eps20 = (T)1e-20;
    p.eps12 = (T)1e-12;
    p.compat = compat;
    return p;
}

// A lane's forward, every value its backward reads.
template <typename T>
struct Lane {
    T e1[3], e2[3], p[3], tv[3], q[3], nc[3], n[3], nf[3], w[3], wt[3];
    T inv, tq, t, nn2, nl, eta, cc, u, rad, radm, ct, k, ww, wl, off;
    bool ok, entering, tir;
};

template <typename T>
DEVICE void lane_forward(const T o[3], const T d[3], const T v[9],
                         const Params<T>& P, Lane<T>& L) {
    // moller_trumbore_verts
    for (int j = 0; j < 3; ++j) {
        L.e1[j] = sub(v[3 + j], v[j]);
        L.e2[j] = sub(v[6 + j], v[j]);
        L.tv[j] = sub(o[j], v[j]);
    }
    cross(d, L.e2, L.p);
    const T det = dot(L.e1, L.p);
    L.ok = absv(det) > P.det_eps;
    L.inv = dvd(T(1), L.ok ? det : P.det_eps);
    cross(L.tv, L.e1, L.q);
    L.tq = dot(L.e2, L.q);
    L.t = mul(L.tq, L.inv);
    cross(L.e1, L.e2, L.nc);
    L.nn2 = dot(L.nc, L.nc);
    L.nl = root(maxv(L.nn2, P.eps20));
    for (int j = 0; j < 3; ++j) L.n[j] = dvd(L.nc[j], L.nl);
    // refract_ray: wo = -d, cos_i clipped to [-1, 1] picks the side
    const T wo[3] = {-d[0], -d[1], -d[2]};
    const T cos_i = minv(maxv(dot(wo, L.n), T(-1)), T(1));
    L.entering = cos_i > T(0);
    const T eta_i = L.entering ? P.ext : P.inn;
    const T eta_t = L.entering ? P.inn : P.ext;
    for (int j = 0; j < 3; ++j) L.nf[j] = L.entering ? L.n[j] : -L.n[j];
    L.eta = dvd(eta_i, eta_t);
    // refract(wo, nf, eta)
    L.cc = dot(L.nf, wo);
    L.u = sub(T(1), mul(L.cc, L.cc));
    const T s2i = maxv(L.u, T(0));
    const T s2t = mul(mul(L.eta, L.eta), s2i);
    L.tir = s2t >= T(1);
    L.rad = sub(T(1), P.compat ? s2i : s2t);
    L.radm = maxv(L.rad, P.eps12);
    L.ct = root(minv(L.radm, T(1)));
    L.k = sub(mul(L.eta, L.cc), L.ct);
    for (int j = 0; j < 3; ++j)          // eta * -wo is eta * d
        L.w[j] = add(mul(L.eta, d[j]), mul(L.k, L.nf[j]));
    L.ww = dot(L.w, L.w);
    L.wl = root(maxv(L.ww, P.eps20));
    for (int j = 0; j < 3; ++j) L.wt[j] = dvd(L.w[j], L.wl);
    L.off = P.compat ? P.offset_eps
                     : maxv(mul(P.offset_rel, absv(L.t)), P.offset_eps);
}

template <typename T>
DEVICE void load3(const T* a, long long i, T out[3]) {
    for (int j = 0; j < 3; ++j) out[j] = a[3 * i + j];
}

template <typename T>
__global__ void __launch_bounds__(BOUNCE_BLOCK)
bounce_fwd_kernel(const T* __restrict__ org, const T* __restrict__ dir,
                  const T* __restrict__ g9,
                  const unsigned char* __restrict__ hit,
                  const unsigned char* __restrict__ active,
                  const long long* __restrict__ safe_id,
                  const T* __restrict__ park_o, long long n, Params<T> P,
                  T* __restrict__ o_out, T* __restrict__ d_out,
                  unsigned char* __restrict__ act_out,
                  long long* __restrict__ tri_out) {
    const long long i = (long long)blockIdx.x * BOUNCE_BLOCK + threadIdx.x;
    if (i >= n) return;
    bool alive = active[i] && hit[i];
    T no[3], nd[3];
    if (alive) {
        T o[3], d[3], v[9];
        load3(org, i, o);
        load3(dir, i, d);
        for (int j = 0; j < 9; ++j) v[j] = g9[9 * i + j];
        Lane<T> L;
        lane_forward(o, d, v, P, L);
        alive = !L.tir;
        for (int j = 0; j < 3; ++j) {
            no[j] = add(add(o[j], mul(L.t, d[j])), mul(L.off, L.wt[j]));
            nd[j] = L.wt[j];
        }
    }
    if (!alive) {
        for (int j = 0; j < 3; ++j) {
            no[j] = park_o[j];
            nd[j] = (T)-0.57735027;
        }
    }
    for (int j = 0; j < 3; ++j) {
        o_out[3 * i + j] = no[j];
        d_out[3 * i + j] = nd[j];
    }
    act_out[i] = alive;
    tri_out[i] = alive ? safe_id[i] : 0;
}

// go (the cotangent of the new origin) or gd (of the new direction) may be
// null: that path is skipped. d_org and d_dir may be null: not written.
template <typename T>
__global__ void __launch_bounds__(BOUNCE_BLOCK)
bounce_bwd_kernel(const T* __restrict__ org, const T* __restrict__ dir,
                  const T* __restrict__ g9,
                  const unsigned char* __restrict__ alive,
                  const T* __restrict__ go, const T* __restrict__ gd,
                  long long n, Params<T> P, T* __restrict__ d_org,
                  T* __restrict__ d_dir, T* __restrict__ dg9) {
    const long long i = (long long)blockIdx.x * BOUNCE_BLOCK + threadIdx.x;
    if (i >= n) return;
    T gorg[3] = {T(0), T(0), T(0)}, gdir[3] = {T(0), T(0), T(0)}, gv[9];
    for (int j = 0; j < 9; ++j) gv[j] = T(0);
    if (alive[i]) {
        T o[3], d[3], v[9];
        load3(org, i, o);
        load3(dir, i, d);
        for (int j = 0; j < 9; ++j) v[j] = g9[9 * i + j];
        Lane<T> L;
        lane_forward(o, d, v, P, L);
        T g_o[3], g_d[3];
        if (go) load3(go, i, g_o);
        if (gd) load3(gd, i, g_d);
        // new origin = (o + t d) + off wt, new direction = wt
        T gwt[3];
        for (int j = 0; j < 3; ++j)
            gwt[j] = gd ? (go ? add(g_d[j], mul(L.off, g_o[j])) : g_d[j])
                        : mul(L.off, g_o[j]);
        // wt = w / sqrt(max(w.w, 1e-20))
        const T gwl = -dvd(dot(gwt, L.wt), L.wl);
        const T gww = gate_max(L.ww, P.eps20, dvd(gwl, add(L.wl, L.wl)));
        const T gww2 = add(gww, gww);
        T gw[3];
        for (int j = 0; j < 3; ++j)
            gw[j] = add(dvd(gwt[j], L.wl), mul(gww2, L.w[j]));
        // w = eta d + k nf
        for (int j = 0; j < 3; ++j)
            gdir[j] = go ? add(mul(L.t, g_o[j]), mul(L.eta, gw[j]))
                         : mul(L.eta, gw[j]);
        const T gk = dot(gw, L.nf);
        T gnf[3];
        for (int j = 0; j < 3; ++j) gnf[j] = mul(L.k, gw[j]);
        // k = eta cc - ct, ct = sqrt(min(max(rad, 1e-12), 1))
        T gcc = mul(L.eta, gk);
        const T gr = gate_max(L.rad, P.eps12,
                              gate_min(L.radm, T(1),
                                       dvd(-gk, add(L.ct, L.ct))));
        // rad = 1 - s2i (compat) or 1 - (eta eta) s2i; s2i = max(u, 0)
        const T gs2i = P.compat ? -gr : mul(mul(L.eta, L.eta), -gr);
        const T gu = gate_max(L.u, T(0), gs2i);
        gcc = sub(gcc, mul(add(gu, gu), L.cc));      // u = 1 - cc cc
        // cc = nf . wo, wo = -d
        for (int j = 0; j < 3; ++j) {
            gnf[j] = sub(gnf[j], mul(gcc, d[j]));
            gdir[j] = sub(gdir[j], mul(gcc, L.nf[j]));
        }
        // nf = +-n, n = nc / sqrt(max(nc.nc, 1e-20))
        T gn[3];
        for (int j = 0; j < 3; ++j) gn[j] = L.entering ? gnf[j] : -gnf[j];
        const T gnl = -dvd(dot(gn, L.n), L.nl);
        const T gnn = gate_max(L.nn2, P.eps20, dvd(gnl, add(L.nl, L.nl)));
        const T gnn2 = add(gnn, gnn);
        T gnc[3];
        for (int j = 0; j < 3; ++j)
            gnc[j] = add(dvd(gn[j], L.nl), mul(gnn2, L.nc[j]));
        // nc = e1 x e2
        T ge1[3], ge2[3], gtv[3] = {T(0), T(0), T(0)};
        cross(L.e2, gnc, ge1);
        cross(gnc, L.e1, ge2);
        if (go) {
            // the t path: t = (e2 . q) inv, q = tv x e1, inv = 1 / det,
            // det = e1 . p, p = d x e2
            const T gt = dot(g_o, d);
            const T gtq = mul(gt, L.inv);
            const T ginv = mul(gt, L.tq);
            T gq[3], c[3];
            for (int j = 0; j < 3; ++j) {
                ge2[j] = add(ge2[j], mul(gtq, L.q[j]));
                gq[j] = mul(gtq, L.e2[j]);
            }
            cross(L.e1, gq, gtv);
            cross(gq, L.tv, c);
            for (int j = 0; j < 3; ++j) ge1[j] = add(ge1[j], c[j]);
            const T gds = -mul(ginv, mul(L.inv, L.inv));
            const T gdet = L.ok ? gds : T(0);
            T gp[3];
            for (int j = 0; j < 3; ++j) {
                ge1[j] = add(ge1[j], mul(gdet, L.p[j]));
                gp[j] = mul(gdet, L.e1[j]);
            }
            cross(L.e2, gp, c);
            for (int j = 0; j < 3; ++j) gdir[j] = add(gdir[j], c[j]);
            cross(gp, d, c);
            for (int j = 0; j < 3; ++j) {
                ge2[j] = add(ge2[j], c[j]);
                gorg[j] = add(g_o[j], gtv[j]);
            }
        }
        // e1 = v1 - v0, e2 = v2 - v0, tv = o - v0
        for (int j = 0; j < 3; ++j) {
            T s = add(ge1[j], ge2[j]);
            if (go) s = add(s, gtv[j]);
            gv[j] = -s;
            gv[3 + j] = ge1[j];
            gv[6 + j] = ge2[j];
        }
    }
    for (int j = 0; j < 3; ++j) {
        if (d_org) d_org[3 * i + j] = gorg[j];
        if (d_dir) d_dir[3 * i + j] = gdir[j];
    }
    for (int j = 0; j < 9; ++j) dg9[9 * i + j] = gv[j];
}

// -- the ray loss's tail -----------------------------------------------------

template <typename T>
struct Tail {
    T df[3], s, r;
};

// A counted lane's squared difference s between its exit direction and the
// target, and r = sqrt(max(s, 1e-24)) when huber != 0.
template <typename T>
DEVICE void tail_forward(const T* org, const T* dir, const T* sp,
                         long long i, T huber, Tail<T>& L) {
    T tx[3], d[3];
    for (int j = 0; j < 3; ++j) {
        tx[j] = sub(sp[3 * i + j], org[3 * i + j]);
        d[j] = dir[3 * i + j];
    }
    const T l = root(maxv(dot(tx, tx), (T)1e-20));
    for (int j = 0; j < 3; ++j) L.df[j] = sub(d[j], dvd(tx[j], l));
    L.s = dot(L.df, L.df);
    L.r = huber != T(0) ? root(maxv(L.s, (T)1e-24)) : T(0);
}

DEVICE bool counted(const unsigned char* lane_valid,
                    const unsigned char* active,
                    const unsigned char* exit_hit, long long i) {
    return lane_valid[i] && active[i] && !exit_hit[i];
}

// The halving tree over n (a power of two) values in shared memory, by
// the block's threads; the sum ends in s[0].
template <typename T>
DEVICE void halve(T* s, int n) {
    for (int h = n / 2; h > 0; h /= 2) {
        for (int k = threadIdx.x; k < h; k += RAY_TAIL_BLOCK)
            s[k] = add(s[k], s[k + h]);
        __syncthreads();
    }
}

template <typename T>
__global__ void __launch_bounds__(RAY_TAIL_BLOCK)
ray_tail_fwd_kernel(const T* __restrict__ org, const T* __restrict__ dir,
                    const T* __restrict__ sp,
                    const unsigned char* __restrict__ lane_valid,
                    const unsigned char* __restrict__ active,
                    const unsigned char* __restrict__ exit_hit, long long n,
                    T huber, T h2, T hh, T* __restrict__ loss,
                    T* __restrict__ partials, unsigned int* counter) {
    __shared__ T s[RAY_TAIL_BLOCKS];
    __shared__ bool last;
    const long long grid = (long long)RAY_TAIL_BLOCKS * RAY_TAIL_BLOCK;
    T acc = T(0);
    for (long long i = (long long)blockIdx.x * RAY_TAIL_BLOCK + threadIdx.x;
         i < n; i += grid) {
        T value = T(0);
        if (counted(lane_valid, active, exit_hit, i)) {
            Tail<T> L;
            tail_forward(org, dir, sp, i, huber, L);
            value = (huber == T(0) || L.r <= huber) ? L.s
                                                    : sub(mul(h2, L.r), hh);
        }
        acc = add(acc, value);
    }
    s[threadIdx.x] = acc;
    __syncthreads();
    halve(s, RAY_TAIL_BLOCK);
    if (threadIdx.x == 0) {
        partials[blockIdx.x] = s[0];
        __threadfence();
        last = atomicAdd(counter, 1u) == RAY_TAIL_BLOCKS - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int k = threadIdx.x; k < RAY_TAIL_BLOCKS; k += RAY_TAIL_BLOCK)
        s[k] = __ldcg(partials + k);
    __syncthreads();
    halve(s, RAY_TAIL_BLOCKS);
    if (threadIdx.x == 0) *loss = s[0];
}

template <typename T>
__global__ void __launch_bounds__(RAY_TAIL_BLOCK)
ray_tail_bwd_kernel(const T* __restrict__ org, const T* __restrict__ dir,
                    const T* __restrict__ sp,
                    const unsigned char* __restrict__ lane_valid,
                    const unsigned char* __restrict__ active,
                    const unsigned char* __restrict__ exit_hit, long long n,
                    T huber, T h2, const T* __restrict__ g,
                    T* __restrict__ d_dir) {
    const long long i = (long long)blockIdx.x * RAY_TAIL_BLOCK + threadIdx.x;
    if (i >= n) return;
    T out[3] = {T(0), T(0), T(0)};
    if (counted(lane_valid, active, exit_hit, i)) {
        Tail<T> L;
        tail_forward(org, dir, sp, i, huber, L);
        const T gl = *g;
        // where(r <= huber, s, 2 huber r - huber^2), r = sqrt(max(s, 1e-24))
        const T gs = (huber == T(0) || L.r <= huber)
            ? gl
            : gate_max(L.s, (T)1e-24, dvd(mul(h2, gl), add(L.r, L.r)));
        const T g2 = add(gs, gs);                  // s = df . df
        for (int j = 0; j < 3; ++j) out[j] = mul(g2, L.df[j]);
    }
    for (int j = 0; j < 3; ++j) d_dir[3 * i + j] = out[j];
}

static unsigned int blocks_of(long long n, int block) {
    return (unsigned int)((n + block - 1) / block);
}

template <typename T>
static cudaError_t launch_bounce(
        const void* org, const void* dir, const void* g9,
        const unsigned char* hit, const unsigned char* active,
        const long long* safe_id, const void* park_o, long long n,
        double int_ior, double ext_ior, double offset_eps, int compat,
        void* o_out, void* d_out, unsigned char* act_out, long long* tri_out,
        cudaStream_t s) {
    bounce_fwd_kernel<T><<<blocks_of(n, BOUNCE_BLOCK), BOUNCE_BLOCK, 0, s>>>(
        (const T*)org, (const T*)dir, (const T*)g9, hit, active, safe_id,
        (const T*)park_o, n,
        params_of<T>(int_ior, ext_ior, offset_eps, compat), (T*)o_out,
        (T*)d_out, act_out, tri_out);
    return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_bounce_bwd(
        const void* org, const void* dir, const void* g9,
        const unsigned char* alive, const void* go, const void* gd,
        long long n, double int_ior, double ext_ior, double offset_eps,
        int compat, void* d_org, void* d_dir, void* dg9, cudaStream_t s) {
    bounce_bwd_kernel<T><<<blocks_of(n, BOUNCE_BLOCK), BOUNCE_BLOCK, 0, s>>>(
        (const T*)org, (const T*)dir, (const T*)g9, alive, (const T*)go,
        (const T*)gd, n, params_of<T>(int_ior, ext_ior, offset_eps, compat),
        (T*)d_org, (T*)d_dir, (T*)dg9);
    return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_tail(
        const void* org, const void* dir, const void* sp,
        const unsigned char* lane_valid, const unsigned char* active,
        const unsigned char* exit_hit, long long n, double huber, void* loss,
        void* partials, unsigned int* counter, cudaStream_t s) {
    ray_tail_fwd_kernel<T><<<RAY_TAIL_BLOCKS, RAY_TAIL_BLOCK, 0, s>>>(
        (const T*)org, (const T*)dir, (const T*)sp, lane_valid, active,
        exit_hit, n, (T)huber, (T)(2.0 * huber), (T)(huber * huber),
        (T*)loss, (T*)partials, counter);
    return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_tail_bwd(
        const void* org, const void* dir, const void* sp,
        const unsigned char* lane_valid, const unsigned char* active,
        const unsigned char* exit_hit, long long n, double huber,
        const void* g, void* d_dir, cudaStream_t s) {
    ray_tail_bwd_kernel<T>
        <<<blocks_of(n, RAY_TAIL_BLOCK), RAY_TAIL_BLOCK, 0, s>>>(
            (const T*)org, (const T*)dir, (const T*)sp, lane_valid, active,
            exit_hit, n, (T)huber, (T)(2.0 * huber), (const T*)g, (T*)d_dir);
    return cudaGetLastError();
}

extern "C" {

int bounce_block() { return BOUNCE_BLOCK; }
int ray_tail_block() { return RAY_TAIL_BLOCK; }
int ray_tail_blocks() { return RAY_TAIL_BLOCKS; }

// The arguments of bounce_launch, for the wrapper's interface check.
const char* bounce_signature() {
    return "org dir g9 hit active safe_id park_o n f64 int_ior ext_ior "
           "offset_eps compat o_out d_out act_out tri_out stream";
}

// The bounce's forward on `stream`; returns the first CUDA error and does
// not synchronise. org, dir [n,3], g9 [n,9], park_o [3], o_out, d_out [n,3]
// (float, or double with f64); hit, active, act_out [n] bool; safe_id,
// tri_out [n] int64; all contiguous on one device. n = 0 launches nothing.
int bounce_launch(const void* org, const void* dir, const void* g9,
                  const unsigned char* hit, const unsigned char* active,
                  const long long* safe_id, const void* park_o, long long n,
                  int f64, double int_ior, double ext_ior, double offset_eps,
                  int compat, void* o_out, void* d_out,
                  unsigned char* act_out, long long* tri_out, void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(f64 ? launch_bounce<double>(org, dir, g9, hit, active,
                                             safe_id, park_o, n, int_ior,
                                             ext_ior, offset_eps, compat,
                                             o_out, d_out, act_out, tri_out, s)
                     : launch_bounce<float>(org, dir, g9, hit, active,
                                            safe_id, park_o, n, int_ior,
                                            ext_ior, offset_eps, compat,
                                            o_out, d_out, act_out, tri_out,
                                            s));
}

const char* bounce_backward_signature() {
    return "org dir g9 alive go gd n f64 int_ior ext_ior offset_eps compat "
           "d_org d_dir dg9 stream";
}

// The bounce's backward: alive [n] bool is the forward's act_out; go, gd
// [n,3] the cotangents of o_out and d_out (either may be null: skipped);
// d_org, d_dir [n,3] (either may be null: not written) and dg9 [n,9].
int bounce_backward_launch(const void* org, const void* dir, const void* g9,
                           const unsigned char* alive, const void* go,
                           const void* gd, long long n, int f64,
                           double int_ior, double ext_ior, double offset_eps,
                           int compat, void* d_org, void* d_dir, void* dg9,
                           void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    if (!go && !gd) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(f64 ? launch_bounce_bwd<double>(org, dir, g9, alive, go, gd,
                                                 n, int_ior, ext_ior,
                                                 offset_eps, compat, d_org,
                                                 d_dir, dg9, s)
                     : launch_bounce_bwd<float>(org, dir, g9, alive, go, gd,
                                                n, int_ior, ext_ior,
                                                offset_eps, compat, d_org,
                                                d_dir, dg9, s));
}

const char* ray_tail_signature() {
    return "org dir sp lane_valid active exit_hit n f64 huber loss partials "
           "counter stream";
}

// The tail's forward: loss (0-d) = the sum over counted lanes (lane_valid
// and active and not exit_hit) of the squared difference between dir and
// the unit direction from org to sp (the Huber branch above huber != 0).
// partials holds ray_tail_blocks() values; counter one unsigned int,
// zeroed before the launch. n = 0 still launches and writes +0.
int ray_tail_launch(const void* org, const void* dir, const void* sp,
                    const unsigned char* lane_valid,
                    const unsigned char* active,
                    const unsigned char* exit_hit, long long n, int f64,
                    double huber, void* loss, void* partials,
                    unsigned int* counter, void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(f64 ? launch_tail<double>(org, dir, sp, lane_valid, active,
                                           exit_hit, n, huber, loss,
                                           partials, counter, s)
                     : launch_tail<float>(org, dir, sp, lane_valid, active,
                                          exit_hit, n, huber, loss, partials,
                                          counter, s));
}

const char* ray_tail_backward_signature() {
    return "org dir sp lane_valid active exit_hit n f64 huber g d_dir stream";
}

// The tail's backward: d_dir [n,3] = the loss's gradient in dir, for the
// cotangent g (0-d, on the device).
int ray_tail_backward_launch(const void* org, const void* dir, const void* sp,
                             const unsigned char* lane_valid,
                             const unsigned char* active,
                             const unsigned char* exit_hit, long long n,
                             int f64, double huber, const void* g,
                             void* d_dir, void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(f64 ? launch_tail_bwd<double>(org, dir, sp, lane_valid,
                                               active, exit_hit, n, huber, g,
                                               d_dir, s)
                     : launch_tail_bwd<float>(org, dir, sp, lane_valid,
                                              active, exit_hit, n, huber, g,
                                              d_dir, s));
}

}  // extern "C"
