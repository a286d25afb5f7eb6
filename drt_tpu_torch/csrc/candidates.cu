// The oracle's whole candidate prepass for Hopper (sm_90a), bound through
// ctypes: one launch per query scores every chunk for every tile of rays,
// sorts the chunks nearest first and counts the candidates, writing the
// cand [T, NC] int32 and count [T] int32 that closest_hit.cu reads.
//
// Two modes, each equal bit for bit to its plain version in
// drt_tpu_torch/intersect/cuda_kernel.py:
// - ray  (incoherent queries): the exact per-ray slab prepass, `_candidates`
//   of drt_tpu/intersect/pallas_kernel.py:359 (plain XLA in the JAX
//   package; `candidate_scores_plain` + `_sorted_candidates` in the port).
//   Score of (tile, chunk) = min over the tile's rays that overlap the
//   chunk's AABB (t_entry <= t_exit, t_exit > t_min) of max(t_entry, 0).
// - tile (coherent queries, the resorted route): the interval-arithmetic
//   tile-frustum prepass, `_candidates_tile` (pallas_kernel.py:317): the
//   tile's rays become per-axis intervals of origin and inverse direction,
//   and one interval slab test per (tile, chunk) bounds every ray's.
// The boxes are chunks, or groups of chunks (the candidate hierarchy's second
// level): the kernel does not tell them apart.
// A chunk that no ray overlaps, or that is padding, scores +inf. The list
// is the chunks in the order of (score, chunk index), which is what a
// stable sort of the scores gives, and count is the number of finite
// scores.
//
// Design. One block per tile. One pass over the tile's rays gives its
// per-axis intervals of origin and inverse direction (min and max, exact)
// and, in ray mode, its rays a direction octant. A block prefix over the
// chunks then lists the boxes the tile scores in `vidx` (about 40% of the
// chunks are power-of-two padding, never scored):
// - tile mode: every valid box;
// - ray mode: every valid box that the tile's frustum enters (the tile
//   mode's interval slab test, below), or every valid box where the tile's
//   inverse directions straddle 0 on all three axes, since the test then
//   keeps every box but those that all rays leave by t_min. The cull is
//   exact: rounding is monotone, so each ray's rn(plane - o) lies between
//   rn(plane - o_hi) and rn(plane - o_lo), each ray's rounded slab value
//   between the interval's four rounded corner products, and min/max are
//   exact; a box the test drops is entered by no ray's own slab test, so
//   its score is +inf and it takes the same place in the tail as it would.
//   A parked lane's ray (render/trace.py `_park_rays`) leaves the mesh's
//   box, so a tile of parked lanes lists no box, and a one-origin tile
//   (a thin cone of sorted silhouette rays) lists the boxes near its cone.
// A tile that lists no box writes its list (the chunks in order) and a
// count of 0 at once.
// - ray mode: the rays are staged once into shared memory as float4 pairs,
//   and lanes sit on listed boxes, not rays. A warp takes units of two
//   columns of 32 listed boxes against a share of the tile's rays, each
//   lane holds its two boxes and running minima in registers and walks the
//   rays with broadcast shared loads: no warp reduction and no branch per
//   pair. The rays are split so that every warp gets as many units, and
//   two columns (not more) keep the registers (64) low enough for 8 blocks
//   of 128 threads on an SM; the latency-bound phases of one block (the
//   scans, the staging, the sort) hide behind the others' pairs. The rays
//   are staged grouped by direction octant, mirrored into the positive
//   octant (o' = -o and |1/d| on a negative axis), so a lane picks each
//   box's near and far planes once per octant (-hi and -lo on a mirrored
//   axis) and a pair takes one slab value per plane: 6 subtractions, 6
//   multiplies and 4 min/max instead of 10. Mirroring is exact: rn(-hi - -o) * -i equals
//   rn(hi - o) * i, the plain version's value of the near plane, which
//   is the min of the two slab values (rounding is monotone and lo <= hi).
//   max(t_entry, 0) is taken once per chunk, at the end: the minimum
//   commutes with it. The partial minima of a chunk's ray shares merge by
//   a shared 64-bit atomicMin on its key, once per (chunk, share).
// - tile mode: one thread per listed box does the eight interval products
//   and the test, and its entry is the score.
// Every subtraction and product is rounded on its own (__fsub_rn,
// __fmul_rn) as torch rounds it; min/max are exact; a score of -0 is
// written as +0. Scores are then +0 or more, or +inf, so the key
// (score bits << 32 | chunk index) orders as an unsigned integer exactly as
// (score, index) does. Only the finite keys need sorting: a block prefix
// over the keys in chunk order gives each +inf chunk its place behind the
// F finite ones (F + its index - the finite chunks before it), written out
// at once, and packs the finite keys to the front; a bitonic sort of those
// F keys in shared memory, padded to a power of two with all-ones keys,
// gives the head of the list, and count = F.
//
// No NaN can arise for a valid chunk: the inverse direction is guarded to a
// finite nonzero value and a valid chunk's box is finite, so every product
// is finite or +-inf and min/max are exact. Padding chunks (inverted
// +-3e38 boxes) are never scored.
//
// What bounds it: operations. Ray mode needs 20 a (ray, listed box) pair:
// 6 subtractions and 6 multiplies for the slab values of the three planes a
// ray meets first and the three it meets last in its direction octant, 4
// min/max for the entry and the exit, 2 compares and a select for the
// overlap test, and 1 min for the running minimum (the plain form takes 10
// min/max where this takes 4); the cull adds 12 min/max a ray and 86
// operations a (tile, valid box) where it tests. So the pairs it does not
// list are work it no longer does: in a step's bounce-2 and exit queries
// about 9 tiles in 10 hold only parked lanes and list nothing, and a
// silhouette query's tiles list a part of the mesh (PERF.md section 6 has
// the measured shares). A tile that lists nothing costs its scan of the
// chunks, one box test a valid chunk and the write of its list; one that
// lists few boxes is held by the latency-bound phases (the scans, the
// octant staging, the count and the sort, about 20 barriers). The sort
// needs about F log2 F compares a tile. The kernel reads the rays and boxes
// once and writes T x NC + T int32; the tile mode stands at about a fifth
// of its bytes bound, held by the same per-tile phases.

#include <cuda_runtime.h>

#define MAX_RAY_TILE 256
#define MAX_BLOCK 256               // __launch_bounds__: 64 registers
// Threads a tile: 128 beat 256 on the six queries of
// `scripts/tune_torch_oracle.py --what prepass-blocks`, which builds this
// source with -DPREPASS_BLOCK=256 as well (reports/torch_prepass_blocks.json).
#ifndef PREPASS_BLOCK
#define PREPASS_BLOCK 128
#endif
#define MAX_CHUNKS 16384            // keys 128 KB + chunk list 64 KB shared
#define RUN 4                       // consecutive chunks a thread scans
#define INF_BITS 0x7f800000u
#define FULL_MASK 0xffffffffu

typedef unsigned long long u64;

__device__ __forceinline__ float f_inf() { return __uint_as_float(INF_BITS); }

__device__ __forceinline__ u64 make_key(float score, int chunk) {
    // +0 for -0, whose bits would order last
    const unsigned bits = score == 0.f ? 0u : __float_as_uint(score);
    return ((u64)bits << 32) | (unsigned)chunk;
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

__device__ __forceinline__ bool finite_key(u64 key) {
    return (unsigned)(key >> 32) < INF_BITS;
}

// Block-wide exclusive prefix sum of one int a thread; the block's total
// in *total. Two __syncthreads.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int inc = v;
    #pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(FULL_MASK, inc, off);
        if (lane >= off) inc += u;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    int before = 0, sum = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
        const int c = s_warp[w];
        before += w < warp ? c : 0;
        sum += c;
    }
    __syncthreads();
    *total = sum;
    return before + inc - v;
}

// The interval slab test of a tile's frustum against box c: b holds the
// tile's per-axis olo[3], ilo[3], ohi[3], ihi[3] (origins and inverse
// directions). True where the frustum enters the box, leaving it beyond
// t_min; *entry gets the least entry, a lower bound of every ray's.
__device__ __forceinline__ bool frustum_enters(
    const float* b, const float* __restrict__ lo,
    const float* __restrict__ hi, int c, float t_min, float* entry) {
    float en = -f_inf(), ex = f_inf();
    #pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float olo = b[a], ilo = b[3 + a];
        const float ohi = b[6 + a], ihi = b[9 + a];
        float tlo[2], thi[2];
        #pragma unroll
        for (int e = 0; e < 2; ++e) {
            const float plane = e ? hi[3 * (size_t)c + a]
                                  : lo[3 * (size_t)c + a];
            const float alo = __fsub_rn(plane, ohi);
            const float ahi = __fsub_rn(plane, olo);
            const float p1 = __fmul_rn(alo, ilo);
            const float p2 = __fmul_rn(alo, ihi);
            const float p3 = __fmul_rn(ahi, ilo);
            const float p4 = __fmul_rn(ahi, ihi);
            tlo[e] = fminf(fminf(p1, p2), fminf(p3, p4));
            thi[e] = fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
        }
        en = fmaxf(en, fminf(tlo[0], tlo[1]));
        ex = fminf(ex, fmaxf(thi[0], thi[1]));
    }
    *entry = en;
    return en <= ex && ex > t_min;
}

// K columns of 32 listed boxes (from column `col0`) against share
// `split` of `nsplit` of the octant-sorted rays.
template <int K>
__device__ __forceinline__ void score_rays(
    const float4* s_org, const float4* s_inv, const int* s_oct,
    const int* vidx, u64* keys, int nv, int col0, int split, int nsplit,
    int n_rays, const float* __restrict__ lo, const float* __restrict__ hi,
    float t_min, int lane) {
    float blo[K][3], bhi[K][3], best[K];
    int chunk[K];
    #pragma unroll
    for (int k = 0; k < K; ++k) {
        const int pos = (col0 + k) * 32 + lane;
        chunk[k] = pos < nv ? vidx[pos] : -1;
        const int c = chunk[k] < 0 ? 0 : chunk[k];
        #pragma unroll
        for (int a = 0; a < 3; ++a) {
            blo[k][a] = lo[3 * (size_t)c + a];
            bhi[k][a] = hi[3 * (size_t)c + a];
        }
        best[k] = f_inf();
    }
    for (int oct = 0; oct < 8; ++oct) {
        const int r0 = max(s_oct[oct], split * n_rays / nsplit);
        const int r1 = min(s_oct[oct + 1], (split + 1) * n_rays / nsplit);
        if (r0 >= r1) continue;
        float nr[K][3], fr[K][3];      // near and far planes, mirrored
        #pragma unroll
        for (int k = 0; k < K; ++k) {
            #pragma unroll
            for (int a = 0; a < 3; ++a) {
                const bool neg = (oct >> a) & 1;
                nr[k][a] = neg ? -bhi[k][a] : blo[k][a];
                fr[k][a] = neg ? -blo[k][a] : bhi[k][a];
            }
        }
        #pragma unroll 2
        for (int r = r0; r < r1; ++r) {
            const float4 o = s_org[r], iv = s_inv[r];
            #pragma unroll
            for (int k = 0; k < K; ++k) {
                const float nx = __fmul_rn(__fsub_rn(nr[k][0], o.x), iv.x);
                const float ny = __fmul_rn(__fsub_rn(nr[k][1], o.y), iv.y);
                const float nz = __fmul_rn(__fsub_rn(nr[k][2], o.z), iv.z);
                const float fx = __fmul_rn(__fsub_rn(fr[k][0], o.x), iv.x);
                const float fy = __fmul_rn(__fsub_rn(fr[k][1], o.y), iv.y);
                const float fz = __fmul_rn(__fsub_rn(fr[k][2], o.z), iv.z);
                const float te = fmaxf(fmaxf(nx, ny), nz);
                const float tx = fminf(fminf(fx, fy), fz);
                best[k] = (te <= tx && tx > t_min) ? fminf(best[k], te)
                                                   : best[k];
            }
        }
    }
    #pragma unroll
    for (int k = 0; k < K; ++k)
        if (chunk[k] >= 0)
            atomicMin(&keys[chunk[k]],
                      make_key(fmaxf(best[k], 0.f), chunk[k]));
}

__global__ void __launch_bounds__(MAX_BLOCK) candidates_kernel(
    const float* __restrict__ org,     // [3, Np] shifted ray origins
    const float* __restrict__ inv,     // [3, Np] guarded 1 / d
    const float* __restrict__ lo,      // [NC, 3] chunk AABB
    const float* __restrict__ hi,      // [NC, 3]
    const unsigned char* __restrict__ valid,   // [NC] 0 for padding chunks
    int np_, int ray_tile, int nc, int tile_mode, float t_min,
    int* __restrict__ cand,            // [T, NC] nearest first
    int* __restrict__ count,           // [T]
    int* __restrict__ kept)            // [T] boxes listed, or null
{
    extern __shared__ float4 smem[];
    float4* s_org = smem;                          // [ray_tile]
    float4* s_inv = smem + ray_tile;               // [ray_tile]
    u64* keys = (u64*)(smem + 2 * ray_tile);       // [nc rounded up to 2^k]
    int* vidx = (int*)(keys + pow2_at_least(nc));  // [nc] listed boxes
    __shared__ int s_warp[MAX_BLOCK / 32];
    __shared__ int s_oct[9], s_cur[8], s_nfin;
    __shared__ float s_box[MAX_BLOCK / 32][12];

    const int tile = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nthreads = blockDim.x, nwarps = nthreads >> 5;
    const size_t np = (size_t)np_;
    const size_t r_base = (size_t)tile * ray_tile;
    const size_t out = (size_t)tile * nc;

    // one pass over the tile's rays: its per-axis origin and
    // inverse-direction intervals and (ray mode) its rays an octant
    if (!tile_mode) {
        if (tid < 8) s_cur[tid] = 0;
        __syncthreads();
    }
    float b[12];                       // olo[3], ilo[3], ohi[3], ihi[3]
    #pragma unroll
    for (int q = 0; q < 6; ++q) {
        b[q] = f_inf();
        b[6 + q] = -f_inf();
    }
    for (int r = tid; r < ray_tile; r += nthreads) {
        const size_t i = r_base + r;
        const float x[6] = {org[i], org[np + i], org[2 * np + i],
                            inv[i], inv[np + i], inv[2 * np + i]};
        #pragma unroll
        for (int q = 0; q < 6; ++q) {
            b[q] = fminf(b[q], x[q]);
            b[6 + q] = fmaxf(b[6 + q], x[q]);
        }
        if (!tile_mode)
            atomicAdd(&s_cur[(x[3] < 0.f) | ((x[4] < 0.f) << 1)
                             | ((x[5] < 0.f) << 2)], 1);
    }
    #pragma unroll
    for (int q = 0; q < 6; ++q) {
        #pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            b[q] = fminf(b[q], __shfl_xor_sync(FULL_MASK, b[q], off));
            b[6 + q] = fmaxf(b[6 + q],
                             __shfl_xor_sync(FULL_MASK, b[6 + q], off));
        }
    }
    if (lane == 0) {
        #pragma unroll
        for (int q = 0; q < 12; ++q) s_box[warp][q] = b[q];
    }
    __syncthreads();
    #pragma unroll
    for (int q = 0; q < 6; ++q) {
        for (int w = 0; w < nwarps; ++w) {
            b[q] = fminf(b[q], s_box[w][q]);
            b[6 + q] = fmaxf(b[6 + q], s_box[w][6 + q]);
        }
    }
    // ray mode culls by the frustum unless every axis straddles 0
    const bool cull = !tile_mode
                      && !(b[3] < 0.f && b[9] > 0.f && b[4] < 0.f
                           && b[10] > 0.f && b[5] < 0.f && b[11] > 0.f);

    // the listed boxes' indices, in order; every key starts at +inf. Each
    // thread takes a run of RUN consecutive chunks a round.
    int nv = 0;
    for (int base = 0; base < nc; base += nthreads * RUN) {
        const int j0 = base + tid * RUN;
        unsigned bits = 0;
        #pragma unroll
        for (int i = 0; i < RUN; ++i) {
            const int j = j0 + i;
            if (j < nc) {
                float entry;
                bits |= (unsigned)(valid[j] != 0
                                   && (!cull || frustum_enters(
                                       b, lo, hi, j, t_min, &entry))) << i;
                keys[j] = ((u64)INF_BITS << 32) | (unsigned)j;
            }
        }
        int total;
        int at = nv + block_scan(__popc(bits), s_warp, &total);
        #pragma unroll
        for (int i = 0; i < RUN; ++i)
            if ((bits >> i) & 1) vidx[at++] = j0 + i;
        nv += total;
    }
    __syncthreads();
    if (kept != nullptr && tid == 0) kept[tile] = nv;
    if (nv == 0) {
        // nothing to score: the chunks in order, none a candidate
        for (int j = tid; j < nc; j += nthreads) cand[out + j] = j;
        if (tid == 0) count[tile] = 0;
        return;
    }

    if (!tile_mode) {
        // stage the rays grouped by octant, mirrored into the positive one
        if (tid == 0) {
            int acc = 0;
            for (int q = 0; q < 8; ++q) {
                s_oct[q] = acc;
                acc += s_cur[q];
                s_cur[q] = s_oct[q];
            }
            s_oct[8] = acc;
        }
        __syncthreads();
        for (int r = tid; r < ray_tile; r += nthreads) {
            const size_t i = r_base + r;
            const float o[3] = {org[i], org[np + i], org[2 * np + i]};
            const float iv[3] = {inv[i], inv[np + i], inv[2 * np + i]};
            const int oct = (iv[0] < 0.f) | ((iv[1] < 0.f) << 1)
                            | ((iv[2] < 0.f) << 2);
            const int slot = atomicAdd(&s_cur[oct], 1);
            s_org[slot] = make_float4(iv[0] < 0.f ? -o[0] : o[0],
                                      iv[1] < 0.f ? -o[1] : o[1],
                                      iv[2] < 0.f ? -o[2] : o[2], 0.f);
            s_inv[slot] = make_float4(fabsf(iv[0]), fabsf(iv[1]),
                                      fabsf(iv[2]), 0.f);
        }
        __syncthreads();
        // units of K = 2 columns (1 if there is one) against a contiguous
        // share of the sorted rays; the rays are split so that the units
        // are a multiple of the warps and every warp gets as many
        const int ncols = (nv + 31) >> 5;
        const int K = ncols >= 2 ? 2 : 1;
        const int ngroups = (ncols + K - 1) / K;
        const int pow2_part = ngroups & -ngroups;
        const int nsplit = max(1, min(nwarps / max(1, min(pow2_part, nwarps)),
                                      ray_tile / 16));
        for (int u = warp; u < ngroups * nsplit; u += nwarps) {
            const int col0 = (u / nsplit) * K, split = u % nsplit;
            if (ncols - col0 >= 2)
                score_rays<2>(s_org, s_inv, s_oct, vidx, keys, nv, col0,
                              split, nsplit, ray_tile, lo, hi, t_min, lane);
            else
                score_rays<1>(s_org, s_inv, s_oct, vidx, keys, nv, col0,
                              split, nsplit, ray_tile, lo, hi, t_min, lane);
        }
    } else {
        for (int p = tid; p < nv; p += nthreads) {
            const int c = vidx[p];
            float entry;
            if (frustum_enters(b, lo, hi, c, t_min, &entry))
                keys[c] = make_key(fmaxf(entry, 0.f), c);
        }
    }
    __syncthreads();

    // F finite keys; each +inf chunk goes straight to its place behind them
    // (its index less the finite chunks before it), the finite keys pack to
    // the front of `keys` (a key moves only to a lower place, read before)
    if (tid == 0) s_nfin = 0;
    __syncthreads();
    int mine = 0;                      // only a listed box can be finite
    for (int p = tid; p < nv; p += nthreads)
        mine += finite_key(keys[vidx[p]]);
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        mine += __shfl_xor_sync(FULL_MASK, mine, off);
    if (lane == 0) atomicAdd(&s_nfin, mine);
    __syncthreads();
    const int n_fin = s_nfin;
    int f = 0;
    for (int base = 0; base < nc; base += nthreads * RUN) {
        const int j0 = base + tid * RUN;
        u64 run[RUN];
        unsigned bits = 0;
        #pragma unroll
        for (int i = 0; i < RUN; ++i) {
            run[i] = j0 + i < nc ? keys[j0 + i] : ~0ull;
            bits |= (unsigned)(j0 + i < nc && finite_key(run[i])) << i;
        }
        int total;
        int at = f + block_scan(__popc(bits), s_warp, &total);
        #pragma unroll
        for (int i = 0; i < RUN; ++i) {
            const int j = j0 + i;
            if ((bits >> i) & 1) keys[at++] = run[i];
            else if (j < nc) cand[out + n_fin + j - at] = j;
        }
        f += total;
    }
    const int n_pow2 = pow2_at_least(n_fin);
    for (int p = n_fin + tid; p < n_pow2; p += nthreads) keys[p] = ~0ull;
    __syncthreads();

    // bitonic sort of the finite keys, ascending
    for (int k = 2; k <= n_pow2; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = tid; i < (n_pow2 >> 1); i += nthreads) {
                const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1));
                const u64 x = keys[a], y = keys[a + j];
                if ((x > y) == ((a & k) == 0)) {
                    keys[a] = y;
                    keys[a + j] = x;
                }
            }
            __syncthreads();
        }
    }
    for (int p = tid; p < n_fin; p += nthreads)
        cand[out + p] = (int)(unsigned)keys[p];
    if (tid == 0) count[tile] = n_fin;
}

// Dynamic shared memory of a launch: the tile's rays staged twice, the
// sort keys and the list of the boxes it scores.
static size_t prepass_smem(int ray_tile, int nc) {
    return 2 * (size_t)ray_tile * sizeof(float4)
           + (size_t)pow2_at_least(nc) * sizeof(u64) + (size_t)nc * sizeof(int);
}

// Set once: the first launch above the default 48 KB allows the most any
// launch takes, so no later launch sets the attribute again (none inside a
// CUDA graph capture).
static bool g_smem_allowed = false;

extern "C" {

int candidates_max_ray_tile() { return MAX_RAY_TILE; }
int candidates_max_chunks() { return MAX_CHUNKS; }
int candidates_block() { return PREPASS_BLOCK; }

// The arguments of candidates_launch, for the wrapper's interface check.
const char* candidates_signature() {
    return "org inv lo hi valid n_tiles ray_tile nc tile_mode t_min cand "
           "count kept stream";
}

// Launches on `stream` and returns cudaGetLastError(); does not synchronise.
// tile_mode 0: the per-ray prepass; 1: the tile-frustum prepass. kept
// (null, or [n_tiles]): each tile's listed boxes, the valid boxes that ray
// mode's cull keeps (every valid box in tile mode).
int candidates_launch(const float* org, const float* inv, const float* lo,
                      const float* hi, const unsigned char* valid,
                      int n_tiles, int ray_tile, int nc, int tile_mode,
                      float t_min, int* cand, int* count, int* kept,
                      void* stream) {
    static_assert(PREPASS_BLOCK % 32 == 0 && PREPASS_BLOCK <= MAX_BLOCK,
                  "PREPASS_BLOCK: a multiple of 32 threads, at most 256");
    if (ray_tile < 1 || ray_tile > MAX_RAY_TILE || nc > MAX_CHUNKS)
        return (int)cudaErrorInvalidValue;
    if (n_tiles > 0 && nc > 0) {
        const size_t smem = prepass_smem(ray_tile, nc);
        if (smem > 48 * 1024 && !g_smem_allowed) {
            const cudaError_t e = cudaFuncSetAttribute(
                candidates_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)prepass_smem(MAX_RAY_TILE, MAX_CHUNKS));
            if (e != cudaSuccess) return (int)e;
            g_smem_allowed = true;
        }
        candidates_kernel<<<n_tiles, PREPASS_BLOCK, smem,
                            (cudaStream_t)stream>>>(
            org, inv, lo, hi, valid, n_tiles * ray_tile, ray_tile, nc,
            tile_mode, t_min, cand, count, kept);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
