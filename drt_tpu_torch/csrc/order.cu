// The order of a one-origin oracle query's rays along the screen, for
// Hopper (sm_90a), bound through ctypes: one launch writes order [np], the
// query's ray indices sorted by a Morton code of their directions. The
// packing kernel (pack.cu) reads its rays through it and the closest-hit
// kernel (closest_hit.cu) writes its hits through it, so the permutation
// costs no gather and no scatter of its own.
//
// Why. The closest-hit kernel's time is the walk of a ray tile's candidate
// list, one step a listed box, and the list is the union of the boxes the
// tile's rays enter. The silhouette sampler's rays come in the mesh order
// of their edges, so a tile's rays lie all over the silhouette and its list
// reaches most of the mesh's boxes, though no ray enters more than a few
// dozen. All of that query's rays leave the camera's origin, so their
// directions are where they meet the screen: sorted by direction, a tile's
// rays are neighbours and its list is about their own boxes.
//
// The key of ray i, from d = dirs[i] as float32 (float64 converted as the
// packing kernel converts it):
//   box     lo, hi = the min and max of each component over the rays, NaN
//           ignored (fminf / fmaxf: exact, so in any order);
//   scale   2^(b - e) per axis, b = ORDER_AXIS_BITS (5), where span =
//           hi - lo = m * 2^e with m in [0.5, 1) (frexpf; span 0 gives
//           e = 0), +inf for b - e >= 128, 0 where span is not finite: a
//           power of two, so the cells are a power-of-two grid and the
//           code below is a true Morton order;
//   q       (int) min(max((d - lo) * scale, 0), 2^b - 1) per axis, each
//           operation rounded on its own; a NaN gives 0;
//   key     the 3b-bit Morton code of (q0, q1, q2), q0's bits lowest.
// 32 cells an axis of the direction box: finer keys (8 bits an axis, three
// passes) gave the closest-hit kernel no shorter walks on the silhouette
// queries of the three dog meshes and cost a pass
// (reports/torch_silhouette_order.json).
// Its plain version is `ray_order_keys` in intersect/cuda_kernel.py, and
// `ray_order_plain` the whole order: a stable argsort of the keys. The
// kernel gives the same order, bit for bit, since a stable sort of
// integer keys has one answer. order[i] = i for i in [n, np): the lanes
// that pad the rays to whole tiles stay where they are.
//
// Design: one cluster of CLUSTER_BLOCK-thread CTAs (cluster_sort.cuh; 16
// where the card schedules them). CTA k takes the k-th contiguous share of
// the rays: it reduces its share's box and pushes it into every CTA's
// shared memory; after a cluster barrier each CTA has the whole box, keys
// its share into the scratch and counts the low digit; then stable 8-bit
// passes (two for 15 bits) as scatter.cu's cluster route runs them, (key, ray) pairs
// in the scratch, the last pass writing only the ray into `order`. One
// device operation a query.
//
// What bounds it: the passes' dependent steps (a cluster barrier and a
// block scan each), not bytes: a query of 65,536 rays reads 0.8 MB of
// directions and moves 0.5 MB of pairs a pass, in L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no --use_fast_math).

#include <math_constants.h>

#include "cluster_sort.cuh"

namespace cg = cooperative_groups;

// Bits of a key an axis (-DORDER_AXIS_BITS=n builds a variant for
// scripts/tune_torch_oracle.py); the passes cover the key's 3n bits.
#ifndef ORDER_AXIS_BITS
#define ORDER_AXIS_BITS 5
#endif
#define ORDER_PASSES ((3 * ORDER_AXIS_BITS + RADIX_BITS - 1) / RADIX_BITS)
#define ORDER_CELLS_MAX ((float)((1 << ORDER_AXIS_BITS) - 1))

static_assert(ORDER_AXIS_BITS >= 1 && ORDER_AXIS_BITS <= 10,
              "spread3 takes 10 bits an axis");

__device__ __forceinline__ float load_dir(const void* p, size_t i, int f64) {
    return f64 ? __double2float_rn(static_cast<const double*>(p)[i])
               : static_cast<const float*>(p)[i];
}

// The low 10 bits of x, spread 3 apart (resort.py `_spread3`).
__device__ __forceinline__ unsigned spread3(unsigned x) {
    x &= 0x3FFu;
    x = (x | (x << 16)) & 0x030000FFu;
    x = (x | (x << 8)) & 0x0300F00Fu;
    x = (x | (x << 4)) & 0x030C30C3u;
    x = (x | (x << 2)) & 0x09249249u;
    return x;
}

// 2^(ORDER_AXIS_BITS - e) for a span of exponent e (frexpf), +inf from
// 2^128 up, 0 for a span that is not finite.
__device__ __forceinline__ float axis_scale(float span) {
    if (!isfinite(span)) return 0.f;
    int e;
    frexpf(span, &e);
    const int k = min(ORDER_AXIS_BITS - e, 128);
    return __int_as_float((k + 127) << 23);
}

__device__ __forceinline__ int ray_key(const void* dirs, int f64, int e,
                                       const float* lo, const float* scale) {
    unsigned key = 0u;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float d = load_dir(dirs, 3 * (size_t)e + a, f64);
        const float q = fminf(fmaxf(__fmul_rn(__fsub_rn(d, lo[a]), scale[a]),
                                    0.f),
                              ORDER_CELLS_MAX);
        key |= spread3((unsigned)q) << a;
    }
    return (int)key;
}

__global__ void __launch_bounds__(CLUSTER_BLOCK, 1)
ray_order_kernel(const void* __restrict__ dirs, int dir_f64, int n_rays,
                 int np_, int* __restrict__ order, int* __restrict__ scratch) {
    cg::cluster_group cluster = cg::this_cluster();
    const int n_cta = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    // dynamic: a warp's digit counts, then its next slots; every CTA's
    // counts of the pass, each pushed by its CTA
    extern __shared__ int dyn[];
    int (*wcnt)[RADIX] = (int (*)[RADIX])dyn;
    int (*all_cnt)[RADIX] = (int (*)[RADIX])(dyn + CLUSTER_WARPS * RADIX);
    __shared__ int base[RADIX];
    __shared__ float warp_box[CLUSTER_WARPS][6];
    __shared__ float all_box[CLUSTER_MAX][6];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int* key0 = scratch;
    int2* pairs_b = (int2*)scratch;
    int2* pairs_a = pairs_b + n_rays;
    const long long stride = (long long)n_cta * CLUSTER_BLOCK;
    const long long me = (long long)rank * CLUSTER_BLOCK + tid;

    cluster_arrive_relaxed();     // waited on before the first push
    for (long long i = n_rays + me; i < np_; i += stride) order[i] = (int)i;
    // 1. this CTA's box (lo in 0-2, hi in 3-5); the CTA's share of the
    // rays, and a warp's of that, are the same in every step below
    int ca, cb, wa, wb;
    share(0, n_rays, n_cta, rank, &ca, &cb);
    share(ca, cb, CLUSTER_WARPS, warp, &wa, &wb);
    float box[6] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                    -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    for (int e = ca + tid; e < cb; e += CLUSTER_BLOCK) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float d = load_dir(dirs, 3 * (size_t)e + a, dir_f64);
            box[a] = fminf(box[a], d);
            box[3 + a] = fmaxf(box[3 + a], d);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            box[a] = fminf(box[a], __shfl_xor_sync(FULL_MASK, box[a], off));
            box[3 + a] = fmaxf(box[3 + a],
                               __shfl_xor_sync(FULL_MASK, box[3 + a], off));
        }
    }
    if (lane == 0)
#pragma unroll
        for (int k = 0; k < 6; ++k) warp_box[warp][k] = box[k];
    __syncthreads();
    float mine = 0.f;
    if (tid < 6) {
        mine = warp_box[0][tid];
        for (int w = 1; w < CLUSTER_WARPS; ++w)
            mine = tid < 3 ? fminf(mine, warp_box[w][tid])
                           : fmaxf(mine, warp_box[w][tid]);
    }
    cluster_wait();               // every CTA has started
    if (tid < 6)
        for (int r = 0; r < n_cta; ++r)
            *cluster.map_shared_rank(&all_box[rank][tid], r) = mine;
    cluster.sync();
    float lo[3], scale[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        float l = all_box[0][a], h = all_box[0][3 + a];
        for (int r = 1; r < n_cta; ++r) {
            l = fminf(l, all_box[r][a]);
            h = fmaxf(h, all_box[r][3 + a]);
        }
        lo[a] = l;
        scale[a] = axis_scale(__fsub_rn(h, l));
    }

    // 2. key this CTA's rays, a warp its share; count their low digits
    for (int i = tid; i < CLUSTER_WARPS * RADIX; i += CLUSTER_BLOCK)
        (&wcnt[0][0])[i] = 0;
    __syncthreads();
    for (int b = wa; b < wb; b += 32 * CLUSTER_UNROLL) {
        int key[CLUSTER_UNROLL];
#pragma unroll
        for (int u = 0; u < CLUSTER_UNROLL; ++u) {
            const int e = b + u * 32 + lane;
            key[u] = e < wb ? ray_key(dirs, dir_f64, e, lo, scale) : -1;
        }
#pragma unroll
        for (int u = 0; u < CLUSTER_UNROLL; ++u) {
            const int e = b + u * 32 + lane;
            if (e < wb) key0[e] = key[u];
            warp_count(digit_of(key[u], 0), wcnt[warp]);
        }
    }
    __syncthreads();

    for (int p = 0; p < ORDER_PASSES; ++p) {
        const int shift = p * RADIX_BITS;
        const bool last = p == ORDER_PASSES - 1;
        const int2* in = p % 2 ? pairs_a : pairs_b;
        int2* to = p % 2 ? pairs_b : pairs_a;
        if (p > 0) {              // 3. count this CTA's share of the digit
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
        cluster.sync();
        // 4. the cluster's prefix: lower digits, then lower-ranked CTAs
        int total = 0, below = 0;
        if (tid < RADIX) {
            for (int r = 0; r < n_cta; ++r) {
                const int c = all_cnt[r][tid];
                total += c;
                below += r < rank ? c : 0;
            }
        }
        int all;
        const int start = block_exclusive_scan<CLUSTER_WARPS>(total, &all);
        if (tid < RADIX) base[tid] = start + below;
        __syncthreads();
        // 5. place this CTA's share, in order; the last pass writes the rays
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
                if (pos >= 0) {
                    if (last) order[pos] = item[u].y;
                    else to[pos] = item[u];
                }
            }
        }
        if (!last) cluster.sync();  // the next pass reads what all placed
    }
}

static int g_cluster_size = -1;

static int cluster_size() {
    if (g_cluster_size < 0) {
        const void* fn = (const void*)ray_order_kernel;
        const int block = CLUSTER_BLOCK, smem = CLUSTER_SMEM;
        g_cluster_size = largest_cluster(&fn, &block, &smem, 1);
    }
    return g_cluster_size;
}

extern "C" {

// The int32 scratch ray_order_launch needs for n_rays rays: two arrays of
// n_rays (key, ray) pairs.
long long ray_order_scratch_ints(long long n_rays) { return 4 * n_rays; }

// Bits of a key's axis (its quantisation), for the wrapper's check.
int ray_order_axis_bits() { return ORDER_AXIS_BITS; }

// The arguments of ray_order_launch, for the wrapper's interface check.
const char* ray_order_signature() {
    return "dirs dir_f64 n_rays np order scratch stream";
}

// Launches on `stream` and returns the first CUDA error; does not
// synchronise. dirs [n_rays, 3] (float, or double with dir_f64), order
// [np] int32 (np >= n_rays), scratch ray_order_scratch_ints(n_rays) ints;
// all contiguous on one device.
int ray_order_launch(const void* dirs, int dir_f64, int n_rays, int np_,
                     int* order, int* scratch, void* stream) {
    if (n_rays < 0 || np_ < n_rays) return (int)cudaErrorInvalidValue;
    if (np_ == 0) return (int)cudaGetLastError();
    const int k = cluster_size();
    if (k < 1) return (int)cudaErrorNotSupported;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(
        k, CLUSTER_BLOCK, CLUSTER_SMEM, &attr, (cudaStream_t)stream);
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, ray_order_kernel, dirs, dir_f64, n_rays, np_, order, scratch);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
