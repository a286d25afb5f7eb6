// A silhouette view's chain around its oracle query for Hopper (sm_90a),
// bound through ctypes: three kernels, each templated on float and double.
//
//   silhouette_pre_kernel   before the query: each face's side of the
//                           camera, the silhouette edges (the two faces'
//                           sides differ, the edge is valid), the first
//                           `budget` of them in edge order (edge 0 past the
//                           count) and the count, each selected edge's
//                           endpoints projected (R, then K, then the
//                           divide), its screen midpoint and normal, and
//                           the two offset sample points back-projected
//                           through K_inv and R_inv into the query's ray
//                           directions;
//   silhouette_post_kernel  after it: the occupancy difference of each
//                           edge's two rays (tri_id >= 0), the sampled pixel, the
//                           edge's validity (selected, crossing the
//                           boundary, in view), the mask read (truncated
//                           or bilinear) and |mask - 0.5| summed over the
//                           valid edges in one fixed tree, and each edge's
//                           coefficient sign(mask - 0.5) * f for the
//                           backward (0 where not valid);
//   silhouette_bwd_kernel   the loss's cotangent into the 2K endpoint
//                           rows: dE = -N f g_output for both endpoints
//                           (the sampler's backward), then the projection's
//                           backward with the camera depth detached.
//
// Replaces the torch chain of drt_tpu_torch/render/silhouette.py
// (`primary_visibility`: `silhouette_edge_mask`, `select_edges`, the
// endpoint gather, `project_vertices`, `_edge_sample_fwd_math` and
// `_EdgeSampler`) and of `optimize/losses.py` `silhouette_loss`, about 90
// operations forward and 34 backward a view, the counterparts of
// drt_tpu/render/silhouette.py:29-55 and :143-173,
// drt_tpu/render/camera.py:68 and drt_tpu/optimize/losses.py:109-146. The
// vertex gradient's scatter stays with csrc/scatter.cu. The plain versions
// are `silhouette_pre_plain`, `silhouette_post_plain` and
// `silhouette_backward_plain` in drt_tpu_torch/render/silhouette_kernels.py,
// torch operations in this file's order.
//
// Contract: every output equals the plain version run on the card bit for
// bit. Every product, quotient, sum and square root is rounded on its own
// (__fmul_rn, __fdiv_rn, __fadd_rn, __fsqrt_rn and their double forms, no
// contraction), in the plain version's order: a dot product is (a0 b0 +
// a1 b1) + a2 b2, a cross product's component a1 b2 - a2 b1, a row of a
// matrix product sums its terms in column order, the homogeneous 1's term
// last. The products stay FP32 (or FP64) on the CUDA cores: TF32 rounds
// pixel coordinates by whole pixels.
//
// The camera, its origin and the mask are read from the stacked views at
// the device view index `view` (one int64 on the card), so the step takes
// no copy of a view.
//
// Design. The pre kernel is one cluster of CTAs of 1024 threads (512 in
// float64; 16 CTAs where the card schedules them). CTA r takes the r-th
// contiguous share of the faces and keeps one bit a face (its normal faces
// the camera: the three edges of a face share it) in its shared memory; after a cluster barrier it takes the r-th share of the
// edges, reads each edge's two face bits from the owners' shared memory,
// keeps one bit an edge and counts them; each CTA then reads every CTA's
// count, so it knows where its share's silhouette edges start in the
// selection, and writes their ids in edge order (the rest of the budget
// gets edge 0); after a second barrier every thread takes slots of the
// budget and projects its edge. The post kernel is one cluster as well,
// for its sum: the sum of slot s's value runs in virtual thread s mod
// SIL_SUM_THREADS (SIL_SUM_BLOCKS blocks of SIL_BLOCK, in ascending s),
// then halving trees over each block's threads and over the blocks'
// partials; a CTA of a smaller cluster takes several virtual blocks, so
// the order depends on the slot count alone. The backward is a plain grid,
// a thread an endpoint row; a slot whose coefficient is 0 writes +0.
//
// Bounds: the pre kernel reads the faces and edges once (24 + 36 bytes a
// face's indices and corners, 17 an edge's faces and validity) and writes
// about 130 bytes a float32 slot; the post kernel reads 8 + 8 + 4 (or 16)
// bytes a slot and writes 4; the backward reads 8 + 4 + 12 and writes 12
// bytes a row. A silhouette view of dog_mid90k (124k edges, 82k faces, a
// budget of 32,768) moves about 12 MB: a few microseconds at 3.35 TB/s.
// The cluster's barriers and the faces' gathers from 16 SMs bound it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no --use_fast_math).

#include "cluster_sort.cuh"

namespace cg = cooperative_groups;

#define SIL_BLOCK 1024
#define SIL_SUM_BLOCKS 16
#define SIL_SUM_THREADS (SIL_SUM_BLOCKS * SIL_BLOCK)
#define SIL_BWD_BLOCK 256
// Dynamic shared memory a pre CTA may take for its face and edge bits:
// (faces + edges) / CTAs / 8 bytes, so 16 CTAs hold the bits of about 20
// million faces and edges together.
#define SIL_SMEM_CAP (160 * 1024)

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
DEVICE float floorv(float a) { return floorf(a); }
DEVICE double floorv(double a) { return floor(a); }

template <typename T>
DEVICE T sub(T a, T b) { return add(a, -b); }

// torch.maximum / torch.minimum: a NaN operand is the result
template <typename T>
DEVICE T maxv(T a, T b) {
    return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename T>
DEVICE T minv(T a, T b) {
    return a != a ? a : (b != b ? b : (a < b ? a : b));
}

template <typename T>
DEVICE T absv(T a) {
    return a < T(0) ? -a : (a == T(0) ? T(0) : a);
}

// torch.sign: (a > 0) - (a < 0), so +0 for a zero and for NaN
template <typename T>
DEVICE T signv(T a) {
    return a > T(0) ? T(1) : (a < T(0) ? T(-1) : T(0));
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

template <typename T>
DEVICE void load3(const T* a, long long i, T out[3]) {
    for (int j = 0; j < 3; ++j) out[j] = a[3 * i + j];
}

// The bit words of a pre CTA's share of n faces or edges: whole tiles of
// `block`, one word a warp.
static int words_of(long long n, int k, int block) {
    return (int)(((n + k - 1) / k + block - 1) / block * (block / 32));
}

// -- before the query ---------------------------------------------------------

// The pre kernel's threads a CTA: 1024 in float32, 512 in float64, whose
// slot needs more than 64 registers.
template <typename T>
struct Pre {
    static constexpr int block = sizeof(T) == 4 ? 1024 : 512;
    static constexpr int warps = block / 32;
};

// Whether face f's normal (v1 - v0) x (v2 - v0) points to the camera's
// origin o: n . (o - v0) > 0 (silhouette_edge_mask's d).
template <typename T>
DEVICE bool faces_camera(const T* verts, const long long* faces,
                         long long f, const T o[3]) {
    T v0[3], v1[3], v2[3], e1[3], e2[3], n[3], tc[3];
    load3(verts, faces[3 * f], v0);
    load3(verts, faces[3 * f + 1], v1);
    load3(verts, faces[3 * f + 2], v2);
    for (int j = 0; j < 3; ++j) {
        e1[j] = sub(v1[j], v0[j]);
        e2[j] = sub(v2[j], v0[j]);
        tc[j] = sub(o[j], v0[j]);
    }
    cross(e1, e2, n);
    return dot(n, tc) > T(0);
}

// project_vertices with the depth detached: V -> (x, y, p2), p = K (R [V,
// 1])[:3], x = p0 / p2, y = p1 / p2.
template <typename T>
DEVICE void project(const T* R, const T* Km, const T V[3], T out[3]) {
    T c[3], p[3];
    for (int j = 0; j < 3; ++j)
        c[j] = add(add(add(mul(R[4 * j], V[0]), mul(R[4 * j + 1], V[1])),
                       mul(R[4 * j + 2], V[2])),
                   R[4 * j + 3]);
    for (int i = 0; i < 3; ++i)
        p[i] = add(add(mul(Km[3 * i], c[0]), mul(Km[3 * i + 1], c[1])),
                   mul(Km[3 * i + 2], c[2]));
    out[0] = dvd(p[0], p[2]);
    out[1] = dvd(p[1], p[2]);
    out[2] = p[2];
}

// The world direction from the origin o through screen point (fx, fy):
// K_inv [f, 1], then R_inv [c, 1], less o.
template <typename T>
DEVICE void back_project(const T* Ki, const T* Ri, const T o[3], T fx, T fy,
                         T* out) {
    T c[3];
    for (int i = 0; i < 3; ++i)
        c[i] = add(add(mul(Ki[3 * i], fx), mul(Ki[3 * i + 1], fy)),
                   Ki[3 * i + 2]);
    for (int i = 0; i < 3; ++i)
        out[i] = sub(add(add(add(mul(Ri[4 * i], c[0]), mul(Ri[4 * i + 1], c[1])),
                             mul(Ri[4 * i + 2], c[2])),
                         Ri[4 * i + 3]),
                     o[i]);
}

template <typename T>
struct PreOut {
    long long* edge_idx;   // [K] the selected edges, 0 past the count
    long long* count;      // [1] the silhouette edges (may exceed K)
    T* org;                // [3] the view's origin
    T* ray_dir;            // [2K,3] upper sample points, then lower
    T* sample;             // [K,2] screen midpoint
    T* normal;             // [K,2] screen normal N = (ay - by, bx - ax)
    T* pix;                // [2K,3] each endpoint's (x, y, p2)
    long long* vidx;       // [2K] each endpoint's vertex
};

template <typename T>
__global__ void __launch_bounds__(Pre<T>::block)
silhouette_pre_kernel(const T* __restrict__ verts,
                      const long long* __restrict__ faces, int n_faces,
                      const long long* __restrict__ edge_faces,
                      const unsigned char* __restrict__ edge_valid,
                      const long long* __restrict__ edges, int n_edges,
                      const T* __restrict__ R_all, const T* __restrict__ K_all,
                      const T* __restrict__ Ri_all,
                      const T* __restrict__ Ki_all,
                      const T* __restrict__ org_all, long long org_stride,
                      const long long* __restrict__ view, int budget,
                      int face_words, PreOut<T> out) {
    constexpr int BLOCK = Pre<T>::block, WARPS = Pre<T>::warps;
    extern __shared__ unsigned int sil_bits[];    // face words, edge words
    __shared__ int cta_count;
    __shared__ int warp_counts[WARPS];
    cg::cluster_group cluster = cg::this_cluster();
    const int n_cta = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long v = *view;
    const T* R = R_all + 16 * v;
    const T* Km = K_all + 9 * v;
    const T* Ri = Ri_all + 16 * v;
    const T* Ki = Ki_all + 9 * v;
    T o[3];
    for (int j = 0; j < 3; ++j) o[j] = org_all[org_stride * v + j];
    unsigned int* face_bits = sil_bits;
    unsigned int* edge_bits = sil_bits + face_words;

    // 1. a bit a face of this CTA's share
    int flo, fhi;
    share(0, n_faces, n_cta, rank, &flo, &fhi);
    const int flen = max((n_faces + n_cta - 1) / n_cta, 1);
    for (int base = flo; base < fhi; base += BLOCK) {
        const int f = base + tid;
        const bool up = f < fhi && faces_camera(verts, faces, f, o);
        const unsigned w = __ballot_sync(FULL_MASK, up);
        if (lane == 0) face_bits[(base - flo) / 32 + warp] = w;
    }
    cluster.sync();

    // 2. a bit an edge of this CTA's share, and their count
    int elo, ehi;
    share(0, n_edges, n_cta, rank, &elo, &ehi);
    int mine = 0;
    for (int base = elo; base < ehi; base += BLOCK) {
        const int e = base + tid;
        bool silh = false;
        if (e < ehi && edge_valid[e]) {
            bool side[2];
            for (int k = 0; k < 2; ++k) {
                const int f = (int)edge_faces[2 * e + k];
                const int owner = f / flen, local = f - owner * flen;
                const unsigned w = *cluster.map_shared_rank(
                    face_bits + local / 32, owner);
                side[k] = (w >> (local % 32)) & 1u;
            }
            silh = side[0] != side[1];
        }
        const unsigned w = __ballot_sync(FULL_MASK, silh);
        if (lane == 0) edge_bits[(base - elo) / 32 + warp] = w;
        mine += __popc(w);
    }
    if (lane == 0) warp_counts[warp] = mine;
    __syncthreads();
    if (tid == 0) {
        int c = 0;
        for (int k = 0; k < WARPS; ++k) c += warp_counts[k];
        cta_count = c;
    }
    cluster.sync();

    // 3. where this CTA's edges start in the selection; their ids
    int start = 0, total = 0;
    for (int r = 0; r < n_cta; ++r) {
        const int c = *cluster.map_shared_rank(&cta_count, r);
        if (r < rank) start += c;
        total += c;
    }
    if (rank == 0 && tid == 0) {
        *out.count = total;
        for (int j = 0; j < 3; ++j) out.org[j] = o[j];
    }
    const int n_words = (ehi - elo + 31) / 32;
    for (int w0 = 0; w0 < n_words; w0 += BLOCK) {
        const unsigned w = w0 + tid < n_words ? edge_bits[w0 + tid] : 0u;
        int round_total;
        int at = start + block_exclusive_scan<WARPS>(__popc(w),
                                                     &round_total);
        for (unsigned rest = w; rest && at < budget; rest &= rest - 1) {
            out.edge_idx[at++] = elo + 32 * (w0 + tid) + __ffs(rest) - 1;
        }
        start += round_total;
    }
    const int threads = n_cta * BLOCK;
    const int me = rank * BLOCK + tid;
    for (int s = min(total, budget) + me; s < budget; s += threads)
        out.edge_idx[s] = 0;
    __threadfence();
    cluster.sync();

    // 4. each slot's edge: endpoints, projection, midpoint, normal, rays
    for (int s = me; s < budget; s += threads) {
        const long long e = __ldcg(out.edge_idx + s);
        T ab[2][3];
        for (int k = 0; k < 2; ++k) {
            const long long vi = edges[2 * e + k];
            out.vidx[2 * s + k] = vi;
            T V[3];
            load3(verts, vi, V);
            project(R, Km, V, ab[k]);
            for (int j = 0; j < 3; ++j) out.pix[3 * (2 * s + k) + j] = ab[k][j];
        }
        const T sx = mul(add(ab[0][0], ab[1][0]), T(0.5));
        const T sy = mul(add(ab[0][1], ab[1][1]), T(0.5));
        const T nx = sub(ab[0][1], ab[1][1]);
        const T ny = sub(ab[1][0], ab[0][0]);
        const T den = maxv(root(add(mul(nx, nx), mul(ny, ny))), (T)1e-12);
        const T ux = dvd(nx, den), uy = dvd(ny, den);
        out.sample[2 * s] = sx;
        out.sample[2 * s + 1] = sy;
        out.normal[2 * s] = nx;
        out.normal[2 * s + 1] = ny;
        back_project(Ki, Ri, o, add(sx, ux), add(sy, uy), out.ray_dir + 3 * s);
        back_project(Ki, Ri, o, sub(sx, ux), sub(sy, uy),
                     out.ray_dir + 3 * ((long long)budget + s));
    }
}

// -- after the query ----------------------------------------------------------

// Slot s's value |mask - 0.5| (0 where not valid) and its coefficient.
template <typename T>
DEVICE T slot_value(const int* tri_id, const T* sample, long long count,
                    const T* mask, long long row, int resy, int resx,
                    int bilinear, int budget, int s, T* coef) {
    const T f = sub(T(tri_id[s] >= 0), T(tri_id[budget + s] >= 0));
    const T sx = sample[2 * s], sy = sample[2 * s + 1];
    const int px = (int)sx, py = (int)sy;
    const bool valid = s < count && absv(f) > (T)1e-5 && px >= 0
        && px < resx - 1 && py >= 0 && py < resy - 1;
    T picked;
    if (bilinear) {
        const long long x0 = min(max((long long)floorv(sx), 0LL),
                                 (long long)resx - 2);
        const long long y0 = min(max((long long)floorv(sy), 0LL),
                                 (long long)resy - 2);
        const T wx = minv(maxv(sub(sx, (T)x0), T(0)), T(1));
        const T wy = minv(maxv(sub(sy, (T)y0), T(0)), T(1));
        const T* m0 = mask + y0 * row + x0;
        const T* m1 = m0 + row;
        const T r0 = add(mul(sub(T(1), wx), m0[0]), mul(wx, m0[1]));
        const T r1 = add(mul(sub(T(1), wx), m1[0]), mul(wx, m1[1]));
        picked = add(mul(sub(T(1), wy), r0), mul(wy, r1));
    } else {
        const int cx = min(max(px, 0), resx - 1);
        const int cy = min(max(py, 0), resy - 1);
        picked = mask[cy * row + cx];
    }
    const T diff = sub(picked, T(0.5));
    const T sg = signv(diff);
    *coef = valid ? mul(sg, f) : T(0);
    return valid ? mul(sg, diff) : T(0);
}

// The halving tree over n (a power of two) values in shared memory, by
// the block's threads; the sum ends in s[0].
template <typename T>
DEVICE void halve(T* s, int n) {
    for (int h = n / 2; h > 0; h /= 2) {
        for (int k = threadIdx.x; k < h; k += SIL_BLOCK)
            s[k] = add(s[k], s[k + h]);
        __syncthreads();
    }
}

template <typename T>
__global__ void __launch_bounds__(SIL_BLOCK)
silhouette_post_kernel(const int* __restrict__ tri_id,
                       const T* __restrict__ sample,
                       const long long* __restrict__ count,
                       const T* __restrict__ mask_all, long long mask_stride,
                       long long mask_row,
                       const long long* __restrict__ view, int resy, int resx,
                       int bilinear, int budget, T* __restrict__ loss,
                       T* __restrict__ coef) {
    __shared__ T s[SIL_BLOCK];
    __shared__ T partials[SIL_SUM_BLOCKS];
    cg::cluster_group cluster = cg::this_cluster();
    const int n_cta = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int tid = threadIdx.x;
    const T* mask = mask_all + mask_stride * *view;
    const long long n = *count;
    for (int b = rank; b < SIL_SUM_BLOCKS; b += n_cta) {
        T acc = T(0);
        for (int i = b * SIL_BLOCK + tid; i < budget; i += SIL_SUM_THREADS) {
            T c;
            acc = add(acc, slot_value(tri_id, sample, n, mask, mask_row,
                                      resy, resx,
                                      bilinear, budget, i, &c));
            coef[i] = c;
        }
        s[tid] = acc;
        __syncthreads();
        halve(s, SIL_BLOCK);
        if (tid == 0) partials[b] = s[0];
        __syncthreads();
    }
    cluster.sync();
    if (rank == 0) {
        if (tid < SIL_SUM_BLOCKS)
            s[tid] = *cluster.map_shared_rank(partials + tid, tid % n_cta);
        __syncthreads();
        halve(s, SIL_SUM_BLOCKS);
        if (tid == 0) *loss = s[0];
    }
    cluster.sync();               // the partials are read before any CTA ends
}

// -- the backward -------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(SIL_BWD_BLOCK)
silhouette_bwd_kernel(const T* __restrict__ normal, const T* __restrict__ coef,
                      const T* __restrict__ pix, const T* __restrict__ R_all,
                      const T* __restrict__ K_all,
                      const long long* __restrict__ view,
                      const T* __restrict__ g, int budget,
                      T* __restrict__ dV) {
    const int r = blockIdx.x * SIL_BWD_BLOCK + threadIdx.x;
    if (r >= 2 * budget) return;
    const int e = r >> 1;
    T out[3] = {T(0), T(0), T(0)};
    const T c = coef[e];
    if (c != T(0)) {
        const long long v = *view;
        const T* R = R_all + 16 * v;
        const T* Km = K_all + 9 * v;
        // dE = -N f g_output, g_output = -sign(diff) g: N (c g)
        const T t = mul(c, *g);
        const T dx = mul(normal[2 * e], t), dy = mul(normal[2 * e + 1], t);
        T P[3];
        load3(pix, r, P);
        // x = p0 / p2, y = p1 / p2; the depth's own path detached
        const T g0 = dvd(dx, P[2]), g1 = dvd(dy, P[2]);
        const T g2 = -dvd(add(mul(dx, P[0]), mul(dy, P[1])), P[2]);
        T gc[2];
        for (int j = 0; j < 2; ++j)
            gc[j] = add(add(mul(Km[j], g0), mul(Km[3 + j], g1)),
                        mul(Km[6 + j], g2));
        for (int k = 0; k < 3; ++k)
            out[k] = add(mul(R[k], gc[0]), mul(R[4 + k], gc[1]));
    }
    for (int k = 0; k < 3; ++k) dV[3 * r + k] = out[k];
}

// -- launches -----------------------------------------------------------------

static int g_sil_cluster = -1;

// The largest cluster of which the card holds one for every kernel (the
// pre kernel at SIL_SMEM_CAP); 0 if none.
static int sil_cluster_size() {
    if (g_sil_cluster < 0) {
        const void* fns[] = {(const void*)silhouette_pre_kernel<float>,
                             (const void*)silhouette_pre_kernel<double>,
                             (const void*)silhouette_post_kernel<float>,
                             (const void*)silhouette_post_kernel<double>};
        const int blocks[] = {Pre<float>::block, Pre<double>::block,
                              SIL_BLOCK, SIL_BLOCK};
        const int smems[] = {SIL_SMEM_CAP, SIL_SMEM_CAP, 0, 0};
        g_sil_cluster = largest_cluster(fns, blocks, smems, 4);
    }
    return g_sil_cluster;
}

template <typename T>
static cudaError_t launch_pre(int k, int smem, const void* verts,
                              const long long* faces, int n_faces,
                              const long long* edge_faces,
                              const unsigned char* edge_valid,
                              const long long* edges, int n_edges,
                              const void* R, const void* Km, const void* Ri,
                              const void* Ki, const void* org,
                              long long org_stride, const long long* view,
                              int budget, PreOut<T> out, cudaStream_t s) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(k, Pre<T>::block, smem,
                                                  &attr, s);
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, silhouette_pre_kernel<T>, (const T*)verts, faces, n_faces,
        edge_faces, edge_valid, edges, n_edges, (const T*)R, (const T*)Km,
        (const T*)Ri, (const T*)Ki, (const T*)org, org_stride, view, budget,
        words_of(n_faces, k, Pre<T>::block), out);
    return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
static cudaError_t launch_post(int k, const int* tri_id,
                               const void* sample, const long long* count,
                               const void* mask, long long mask_stride,
                               long long mask_row, const long long* view,
                               int resy, int resx,
                               int bilinear, int budget, void* loss,
                               void* coef, cudaStream_t s) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(k, SIL_BLOCK, 0, &attr, s);
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, silhouette_post_kernel<T>, tri_id, (const T*)sample, count,
        (const T*)mask, mask_stride, mask_row, view, resy, resx, bilinear,
        budget, (T*)loss, (T*)coef);
    return err != cudaSuccess ? err : cudaGetLastError();
}

extern "C" {

int silhouette_block() { return SIL_BLOCK; }
int silhouette_sum_blocks() { return SIL_SUM_BLOCKS; }
int silhouette_bwd_block() { return SIL_BWD_BLOCK; }

// The CTAs of the pre and post kernels' one cluster on this card (16 where
// it schedules them); 0 if it schedules none.
int silhouette_cluster_size() { return sil_cluster_size(); }

// The dynamic shared bytes the pre kernel takes for n_faces faces and
// n_edges edges (in float64 with f64), and the most it may take.
long long silhouette_pre_smem(long long n_faces, long long n_edges,
                              int f64) {
    const int k = sil_cluster_size();
    if (k < 1) return -1;
    const int block = f64 ? Pre<double>::block : Pre<float>::block;
    return 4LL * (words_of(n_faces, k, block) + words_of(n_edges, k, block));
}
long long silhouette_pre_smem_cap() { return SIL_SMEM_CAP; }

const char* silhouette_pre_signature() {
    return "verts f64 faces n_faces edge_faces edge_valid edges n_edges R K "
           "R_inv K_inv org org_stride view budget edge_idx count org_out "
           "ray_dir sample normal pix vidx stream";
}

// The pre kernel on `stream`; returns the first CUDA error and does not
// synchronise. verts [Vp,3] (float, or double with f64), faces [n_faces,3],
// edge_faces and edges [n_edges,2] int64, edge_valid [n_edges] bool; R,
// R_inv [V,4,4], K, K_inv [V,3,3] and org (view v's origin at org +
// org_stride v) of verts' type, view v one int64 on the device; outputs:
// edge_idx [budget] and count [1] int64, org_out [3], ray_dir [2 budget,3],
// sample, normal [budget,2], pix [2 budget,3] of verts' type, vidx
// [2 budget] int64. All contiguous on one device.
int silhouette_pre_launch(const void* verts, int f64, const long long* faces,
                          int n_faces, const long long* edge_faces,
                          const unsigned char* edge_valid,
                          const long long* edges, int n_edges, const void* R,
                          const void* Km, const void* Ri, const void* Ki,
                          const void* org, long long org_stride,
                          const long long* view, int budget,
                          long long* edge_idx, long long* count,
                          void* org_out, void* ray_dir, void* sample,
                          void* normal, void* pix, long long* vidx,
                          void* stream) {
    if (n_faces < 0 || n_edges < 0 || budget < 1 || !view)
        return (int)cudaErrorInvalidValue;
    const int k = sil_cluster_size();
    if (k < 1) return (int)cudaErrorNotSupported;
    const long long smem = silhouette_pre_smem(n_faces, n_edges, f64);
    if (smem > SIL_SMEM_CAP) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (f64) {
        PreOut<double> o = {edge_idx, count, (double*)org_out,
                            (double*)ray_dir, (double*)sample,
                            (double*)normal, (double*)pix, vidx};
        return (int)launch_pre<double>(k, (int)smem, verts, faces, n_faces,
                                       edge_faces, edge_valid, edges, n_edges,
                                       R, Km, Ri, Ki, org, org_stride, view,
                                       budget, o, s);
    }
    PreOut<float> o = {edge_idx, count, (float*)org_out, (float*)ray_dir,
                       (float*)sample, (float*)normal, (float*)pix, vidx};
    return (int)launch_pre<float>(k, (int)smem, verts, faces, n_faces,
                                  edge_faces, edge_valid, edges, n_edges, R,
                                  Km, Ri, Ki, org, org_stride, view, budget,
                                  o, s);
}

const char* silhouette_post_signature() {
    return "tri_id sample count mask f64 mask_stride mask_row view resy "
           "resx bilinear budget loss coef stream";
}

// The post kernel: tri_id [2 budget] int32 (the query's hit faces, -1 on
// a miss), sample [budget,2] and count [1] from the pre kernel, mask view
// v at mask + mask_stride v (rows mask_row apart, at least resy rows of
// resx), view v one int64 on the device; loss (0-d) and coef [budget] of
// sample's type.
int silhouette_post_launch(const int* tri_id, const void* sample,
                           const long long* count, const void* mask, int f64,
                           long long mask_stride, long long mask_row,
                           const long long* view, int resy, int resx,
                           int bilinear, int budget,
                           void* loss, void* coef, void* stream) {
    if (budget < 1 || resy < 2 || resx < 2 || !view)
        return (int)cudaErrorInvalidValue;
    const int k = sil_cluster_size();
    if (k < 1) return (int)cudaErrorNotSupported;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(f64 ? launch_post<double>(k, tri_id, sample, count, mask,
                                           mask_stride, mask_row, view, resy,
                                           resx,
                                           bilinear, budget, loss, coef, s)
                     : launch_post<float>(k, tri_id, sample, count, mask,
                                          mask_stride, mask_row, view, resy,
                                          resx,
                                          bilinear, budget, loss, coef, s));
}

const char* silhouette_backward_signature() {
    return "normal coef pix R K f64 view g budget dV stream";
}

// The backward: normal [budget,2] and pix [2 budget,3] from the pre
// kernel, coef [budget] from the post kernel, R [V,4,4] and K [V,3,3] as
// the pre kernel read them, g the loss's cotangent (0-d, on the device);
// dV [2 budget,3].
int silhouette_backward_launch(const void* normal, const void* coef,
                               const void* pix, const void* R,
                               const void* Km, int f64,
                               const long long* view, const void* g,
                               int budget, void* dV, void* stream) {
    if (budget < 1 || !view) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned blocks = (2u * budget + SIL_BWD_BLOCK - 1) / SIL_BWD_BLOCK;
    if (f64)
        silhouette_bwd_kernel<double><<<blocks, SIL_BWD_BLOCK, 0, s>>>(
            (const double*)normal, (const double*)coef, (const double*)pix,
            (const double*)R, (const double*)Km, view, (const double*)g,
            budget, (double*)dV);
    else
        silhouette_bwd_kernel<float><<<blocks, SIL_BWD_BLOCK, 0, s>>>(
            (const float*)normal, (const float*)coef, (const float*)pix,
            (const float*)R, (const float*)Km, view, (const float*)g, budget,
            (float*)dV);
    return (int)cudaGetLastError();
}

}  // extern "C"
