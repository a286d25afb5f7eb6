// Closest-hit oracle for Hopper (sm_90a), bound through ctypes.
//
// Replaces both bodies of the TPU kernel in drt_tpu/intersect/pallas_kernel.py:
// `_kernel` (VMEM-resident coefficients) and `_kernel_stream` (coefficients
// streamed from HBM). The resident/streaming split was a VMEM limit; here
// every chunk's coefficients are copied into shared memory on demand, so one
// kernel serves every mesh size.
//
// What it computes: per ray the closest hit (t, tri_id) beyond t_min over
// its tile's nearest-first candidate list (built by the prepass,
// intersect/cuda_kernel.py); t = inf, tri_id = -1 on a miss. The list names
// groups of `group` consecutive chunks (the second level of the candidate
// hierarchy, `_kernel`'s `group`; 1 = chunk ids): entry i is chunk
// cand[i / group] * group + i % group, and the walk runs over count * group
// entries. Möller–Trumbore as FP32 Plücker products against the ray
// features [d, o x d, o, 1], the division-free sign-aware hit test of
// `_kernel` (eps 1e-5 on u and v, t*det beyond t_min*|det|, the product
// rounded on its own as JAX rounds it: at t_min = 0 it is +0 for every
// finite |det|, so the test is `> 0` bit for bit), lowest triangle row on
// equal t within a chunk, strict `<` across chunks.
//
// Where it departs from `_kernel`, on purpose: work is gated per ray. In
// `_kernel` a chunk updates every ray of the tile once any one ray's slab
// test enters the chunk's box; here a chunk updates a ray only if that ray's
// own slab test enters it (leaving it beyond t_min, cut at the ray's running
// best t). A ray whose own box test rounds to a miss therefore no longer
// takes a grazing hit inside that box. The tile-wide gate made 92% of a camera view's rays (those that
// miss the mesh) compute every chunk their tile lists; the per-ray gate is
// the only way to do no more than the function needs. The brute-force
// oracle is the ground truth for both, and the plain version
// (`closest_hit_plain`) gates per ray too, so kernel and plain version agree
// bit for bit.
//
// Design. Grid: one block per block_rays consecutive rays of a ray tile; a
// tile (the unit of the prepass's candidate lists) is one or more blocks.
// Small blocks put more of them in flight: only the tiles near the mesh
// have work, and theirs is a serial walk. A warp owns ray_lanes rays, its
// lanes [0, ray_lanes) (32 but on the one-origin route): fewer rays a warp
// make its loop over the rays that enter a chunk shorter, and more warps
// share a tile's work. The hits do not depend on the tile, the block or
// the rays a warp, since every gate is the ray's own.
//   * The block walks its tile's candidate list. For each listed chunk every
//     thread slab-tests its own ray (lane = ray) one chunk ahead; one
//     `__syncthreads_or` per listed chunk both votes on "does any ray enter
//     the next chunk" and closes the reads of the buffer that the next copy
//     overwrites. The vote is taken with the running best as it stands before
//     the current chunk: a superset of the rays that enter after it, since
//     best t only falls. The exact gate is re-applied when the chunk's turn
//     comes.
//   * If the vote passes, one thread starts a bulk asynchronous copy
//     (`cp.async.bulk`, completion on an `mbarrier`) of the next chunk's 19
//     coefficient rows (9,728 contiguous bytes in the [NC,19,C] layout) into
//     the other of two shared-memory buffers, so the copy runs under this
//     chunk's arithmetic. The coefficients of a chunk are shared by all the
//     rays of the block.
//   * Arithmetic: `__ballot_sync` gives a warp the rays that enter the chunk;
//     a warp with an empty ballot does no triangle work. Otherwise lanes take
//     triangles: lane l loads the coefficients of rows l, l+32, l+64, l+96
//     into registers once (conflict-free), and the warp loops over the set
//     bits of the ballot: the ray's 9 features are read as a shared-memory
//     broadcast, each lane tests its 4 triangles, and two
//     `__reduce_min_sync` take the lexicographic minimum of (t, row): t >= +0
//     or inf, so its bit pattern orders as an unsigned integer; the second
//     reduction takes the lowest row among the lanes whose t equals the
//     minimum (the tie rule). The ray's own lane then updates its best with
//     strict `<`.
//   * The candidate ids and boxes of the next 32..64 list entries are staged
//     in shared memory by a few threads, so the per-chunk loop reads no
//     global memory on its critical path.
//   * Lane r's hit goes to t_out[r], or to t_out[order[r]] where the wrapper
//     passes an order: a one-origin query's lanes hold its rays sorted
//     along the screen (order.cu, pack.cu), and its hits go back to the
//     caller's order on the way out.
//
// What bounds it: FP32 arithmetic on the CUDA cores (no tensor cores: TF32
// would round the products to ~10 mantissa bits and classify small triangles
// as misses). Each (ray, triangle) pair of a chunk the ray enters costs 19
// multiplies and 15 adds, each rounded on its own in a fixed order
// (`__fmul_rn`/`__fadd_rn`: an FMA would round differently from the plain
// version), plus the test.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no --use_fast_math:
// the hit test relies on IEEE division and rounding).

#include <cuda_runtime.h>
#include <math_constants.h>

#define TRI_CHUNK 128
#define N_COEF 19
#define CHUNK_BYTES (N_COEF * TRI_CHUNK * 4)
#define MAX_RAY_TILE 256
#define TRI_PER_LANE (TRI_CHUNK / 32)
#define LIST_SLOTS 64           // staged list entries (two halves of 32)
#define INF_BITS 0x7f800000u
#define FULL_MASK 0xffffffffu
#define SIGN_BIT 0x80000000u

// sum_k x[k] * cf[k0 + k][m], left to right, each product and each sum
// rounded on its own (`__fmul_rn`/`__fadd_rn` keep nvcc from contracting
// them into FMAs).
template <int N>
__device__ __forceinline__ float dot_rn(const float* x,
                                        const float (*cf)[TRI_PER_LANE],
                                        int k0, int m) {
    float acc = __fmul_rn(x[0], cf[k0][m]);
    #pragma unroll
    for (int k = 1; k < N; ++k)
        acc = __fadd_rn(acc, __fmul_rn(x[k], cf[k0 + k][m]));
    return acc;
}

__device__ __forceinline__ float flip_sign(float x, unsigned sign_bit) {
    return __uint_as_float(__float_as_uint(x) ^ sign_bit);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// One thread: arm `bar` for CHUNK_BYTES and start the bulk copy.
__device__ __forceinline__ void copy_chunk_async(float* dst, const float* src,
                                                 unsigned long long* bar) {
    const unsigned b = smem_addr(bar);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b), "r"(CHUNK_BYTES) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(__cvta_generic_to_global(src)),
           "r"(CHUNK_BYTES), "r"(b) : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void wait_barrier(unsigned long long* bar,
                                             unsigned parity) {
    const unsigned b = smem_addr(bar);
    unsigned done;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(b), "r"(parity) : "memory");
    } while (!done);
}

__global__ void __launch_bounds__(MAX_RAY_TILE, 2) closest_hit_kernel(
    const float* __restrict__ phi,     // [9, Np]: d (3), o x d (3), o (3)
    const float* __restrict__ inv,     // [3, Np]: 1 / d, guarded
    const float* __restrict__ coef,    // [NC, 19, TRI_CHUNK]
    const float* __restrict__ lo,      // [NC, 3] chunk AABB
    const float* __restrict__ hi,      // [NC, 3]
    const int* __restrict__ cand,      // [T, NG] nearest-first group ids
    const int* __restrict__ count,     // [T] groups listed per tile
    const int* __restrict__ order,     // [Np] lane -> output slot, or null
    int np_, int ng, int ray_tile,     // ray_tile % block_rays == 0
    int ray_lanes,                     // rays a warp: block_rays / warps
    int group,                         // chunks a group; NC = NG * group
    float t_min,
    float* __restrict__ t_out,         // [Np], inf on miss
    int* __restrict__ id_out)          // [Np], -1 on miss
{
    __shared__ __align__(128) float s_coef[2][N_COEF][TRI_CHUNK];
    __shared__ __align__(8) unsigned long long s_bar[2];
    __shared__ int s_chunk[LIST_SLOTS];
    __shared__ float s_box[LIST_SLOTS][6];
    extern __shared__ float4 s_feat[];          // [block_rays][3]

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const bool owns = lane < ray_lanes;         // the lane has a ray
    const int slot = warp * ray_lanes + lane;   // its place in the block
    const size_t base = (size_t)blockIdx.x * (blockDim.x >> 5) * ray_lanes;
    const size_t r = base + (owns ? slot : 0);
    const int tile = (int)(base / ray_tile);    // one for the whole block
    const size_t np = (size_t)np_;
    const size_t out = order ? (size_t)order[r] : r;

    const int n_cand = count[tile] * group;     // chunk entries
    if (n_cand == 0) {                 // the whole block leaves together
        if (owns) {
            t_out[out] = CUDART_INF_F;
            id_out[out] = -1;
        }
        return;
    }
    const int* tile_cand = cand + (size_t)tile * ng;

    const float o0 = phi[6 * np + r], o1 = phi[7 * np + r], o2 = phi[8 * np + r];
    const float i0 = inv[0 * np + r], i1 = inv[1 * np + r], i2 = inv[2 * np + r];
    if (owns) {
        s_feat[slot * 3 + 0] = make_float4(phi[0 * np + r], phi[1 * np + r],
                                           phi[2 * np + r], phi[3 * np + r]);
        s_feat[slot * 3 + 1] = make_float4(phi[4 * np + r], phi[5 * np + r],
                                           o0, o1);
        s_feat[slot * 3 + 2] = make_float4(o2, 0.f, 0.f, 0.f);
    }

    // Stage list entries [first, first + n) into their slots (entry & 63).
    auto stage_list = [&](int first, int n) {
        for (int j = tid; j < n; j += blockDim.x) {
            const int e = first + j;
            if (e < n_cand) {
                const int c = tile_cand[e / group] * group + e % group;
                const int s = e & (LIST_SLOTS - 1);
                s_chunk[s] = c;
                #pragma unroll
                for (int a = 0; a < 3; ++a) {
                    s_box[s][a] = lo[3 * (size_t)c + a];
                    s_box[s][3 + a] = hi[3 * (size_t)c + a];
                }
            }
        }
    };
    stage_list(0, LIST_SLOTS);
    if (tid == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(smem_addr(&s_bar[0])) : "memory");
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(smem_addr(&s_bar[1])) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    float best_t = CUDART_INF_F;
    int best_id = -1;

    // The ray's own slab test of list entry e: `ok` (enters the box at all)
    // and the entry t, which is cut against the running best when used.
    auto slab = [&](int e, bool& ok, float& t_entry) {
        const float* bx = s_box[e & (LIST_SLOTS - 1)];
        const float a1 = __fmul_rn(__fsub_rn(bx[0], o0), i0);
        const float a2 = __fmul_rn(__fsub_rn(bx[3], o0), i0);
        const float b1 = __fmul_rn(__fsub_rn(bx[1], o1), i1);
        const float b2 = __fmul_rn(__fsub_rn(bx[4], o1), i1);
        const float c1 = __fmul_rn(__fsub_rn(bx[2], o2), i2);
        const float c2 = __fmul_rn(__fsub_rn(bx[5], o2), i2);
        t_entry = fmaxf(fmaxf(fminf(a1, a2), fminf(b1, b2)), fminf(c1, c2));
        const float t_exit = fminf(fminf(fmaxf(a1, a2), fmaxf(b1, b2)),
                                   fmaxf(c1, c2));
        ok = owns && (t_entry <= t_exit) && (t_exit > t_min);
    };

    bool ok_cur, ok_nxt = false;
    float te_cur, te_nxt = 0.f;
    slab(0, ok_cur, te_cur);
    // Uniform over the block: the copy of the current entry was started.
    bool copied_cur = __syncthreads_or(ok_cur && te_cur < best_t);
    if (copied_cur && tid == 0)
        copy_chunk_async(&s_coef[0][0][0],
                         coef + (size_t)s_chunk[0] * (N_COEF * TRI_CHUNK),
                         &s_bar[0]);
    unsigned parity = 0;               // bit b: the phase buffer b waits for

    for (int i = 0; i < n_cand; ++i) {
        const int buf = i & 1;
        bool vote = false;
        if (i + 1 < n_cand) {
            slab(i + 1, ok_nxt, te_nxt);
            vote = ok_nxt && te_nxt < best_t;
        }
        // Every thread has finished entry i - 1, which read buffer buf ^ 1.
        const bool copied_nxt = __syncthreads_or(vote);
        // Entries [i + 32, i + 64) go into the slots of [i - 32, i), which
        // nobody reads after this barrier; they are first read 31 entries
        // (and as many barriers) on.
        if ((i & 31) == 0 && i > 0) stage_list(i + 32, 32);
        if (copied_nxt && tid == 0)
            copy_chunk_async(
                &s_coef[buf ^ 1][0][0],
                coef + (size_t)s_chunk[(i + 1) & (LIST_SLOTS - 1)]
                       * (N_COEF * TRI_CHUNK),
                &s_bar[buf ^ 1]);

        if (copied_cur) {
            const bool enters = ok_cur && te_cur < best_t;
            const unsigned rays = __ballot_sync(FULL_MASK, enters);
            // Warp 0 always waits: its thread 0 re-arms this barrier two
            // entries on and must have seen this phase complete.
            if (rays != 0u || warp == 0)
                wait_barrier(&s_bar[buf], (parity >> buf) & 1u);
            parity ^= 1u << buf;
            if (rays != 0u) {
                const int c = s_chunk[i & (LIST_SLOTS - 1)];
                float cf[N_COEF][TRI_PER_LANE];
                #pragma unroll
                for (int k = 0; k < N_COEF; ++k)
                    #pragma unroll
                    for (int m = 0; m < TRI_PER_LANE; ++m)
                        cf[k][m] = s_coef[buf][k][lane + 32 * m];

                unsigned todo = rays;
                while (todo) {
                    const int src = __ffs(todo) - 1;
                    todo &= todo - 1;
                    const float4* f = &s_feat[(warp * ray_lanes + src) * 3];
                    const float4 f0 = f[0], f1 = f[1];
                    const float feat[10] = {f0.x, f0.y, f0.z, f0.w, f1.x,
                                            f1.y, f1.z, f1.w, f[2].x, 1.f};
                    float lane_t = CUDART_INF_F;
                    unsigned lane_row = 0;
                    #pragma unroll
                    for (int m = 0; m < TRI_PER_LANE; ++m) {
                        // Rounded in the order of the plain version's
                        // elementwise sums: both agree bit for bit.
                        const float det = dot_rn<3>(feat, cf, 0, m);
                        const float ud = dot_rn<6>(feat, cf, 3, m);
                        const float vd = dot_rn<6>(feat, cf, 9, m);
                        const float td = dot_rn<4>(feat + 6, cf, 15, m);
                        // Division-free sign-aware test (`_kernel`):
                        // x * sign(det) is x with det's sign bit flipped
                        // in (det = 0 fails the first clause anyway).
                        const float absdet = fabsf(det);
                        const unsigned sgn = __float_as_uint(det) & SIGN_BIT;
                        const float eps = __fmul_rn(1e-5f, absdet);
                        const bool hit = (absdet > 1e-16f)
                            && (flip_sign(ud, sgn) >= -eps)
                            && (flip_sign(vd, sgn) >= -eps)
                            && (flip_sign(__fadd_rn(ud, vd), sgn)
                                <= __fadd_rn(absdet, eps))
                            && (flip_sign(td, sgn)
                                > __fmul_rn(t_min, absdet));
                        if (hit) {
                            // td and det have one sign: t >= +0, never -0.
                            const float t = __fdiv_rn(td, det);
                            if (t < lane_t) {   // rows rise with m
                                lane_t = t;
                                lane_row = lane + 32 * m;
                            }
                        }
                    }
                    // Lexicographic minimum of (t, row) over the warp.
                    const unsigned t_bits = __float_as_uint(lane_t);
                    const unsigned min_bits = __reduce_min_sync(FULL_MASK,
                                                                t_bits);
                    if (min_bits != INF_BITS) {          // warp-uniform
                        const unsigned row = __reduce_min_sync(
                            FULL_MASK,
                            t_bits == min_bits ? lane_row : FULL_MASK);
                        const float t = __uint_as_float(min_bits);
                        if (lane == src && t < best_t) {
                            best_t = t;
                            best_id = c * TRI_CHUNK + (int)row;
                        }
                    }
                }
            }
        }
        ok_cur = ok_nxt;
        te_cur = te_nxt;
        copied_cur = copied_nxt;
    }
    if (owns) {
        t_out[out] = best_t;
        id_out[out] = best_id;
    }
}

extern "C" {

int closest_hit_tri_chunk() { return TRI_CHUNK; }

int closest_hit_max_ray_tile() { return MAX_RAY_TILE; }

// The arguments of closest_hit_launch, for the wrapper's interface check.
const char* closest_hit_signature() {
    return "phi inv coef lo hi cand count order n_tiles ray_tile "
           "block_rays ray_lanes n_groups group t_min t_out id_out stream";
}

// Launches on `stream` and returns cudaGetLastError(); does not synchronise.
// cand [n_tiles, n_groups]; coef, lo, hi hold n_groups * group chunks;
// order (or null) is a permutation of the n_tiles * ray_tile lanes. A
// block takes block_rays rays, ray_lanes of them a warp.
int closest_hit_launch(const float* phi, const float* inv, const float* coef,
                       const float* lo, const float* hi, const int* cand,
                       const int* count, const int* order, int n_tiles,
                       int ray_tile, int block_rays, int ray_lanes,
                       int n_groups, int group, float t_min, float* t_out,
                       int* id_out, void* stream) {
    if (ray_lanes < 1 || ray_lanes > 32 || block_rays <= 0
            || block_rays % ray_lanes || ray_tile % block_rays || group < 1
            || block_rays / ray_lanes * 32 > MAX_RAY_TILE)
        return (int)cudaErrorInvalidValue;
    if (n_tiles > 0) {
        const int np = n_tiles * ray_tile;
        const size_t feat_bytes = (size_t)block_rays * 3 * sizeof(float4);
        closest_hit_kernel<<<np / block_rays, block_rays / ray_lanes * 32,
                             feat_bytes, (cudaStream_t)stream>>>(
            phi, inv, coef, lo, hi, cand, count, order, np, n_groups,
            ray_tile, ray_lanes, group, t_min, t_out, id_out);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
