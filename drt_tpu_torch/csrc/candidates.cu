// Exact per-ray candidate prepass for Hopper (sm_90a), bound through ctypes.
//
// Implements `_candidates` of drt_tpu/intersect/pallas_kernel.py up to its
// sort: that stage is plain XLA in the JAX package (which fuses it); in eager
// PyTorch it materialises [tiles, rays, chunks] temporaries and was half of a
// train step, so the port gives it a kernel of its own. For every (ray tile,
// chunk) it writes the score
//     min over the tile's rays of max(t_entry, 0)
// over the rays whose slab test overlaps the chunk's AABB (t_entry <= t_exit
// and t_exit > 0), or inf if no ray overlaps or the chunk is padding. The
// stable sort of the scores into nearest-first lists stays in PyTorch.
//
// Grid: one block per ray tile, one thread per ray, the ray's shifted origin
// and guarded inverse direction in registers. Chunk boxes pass through shared
// memory in batches of CHUNK_BATCH. Per chunk each thread does the slab test
// with the arithmetic of the plain version (one subtraction, one multiply,
// each rounded on its own, then min/max); scores are >= +0 or inf, so their
// bit patterns order as unsigned integers: `__reduce_min_sync` on the bits
// over the warp, then `atomicMin` into a shared [CHUNK_BATCH] array, is an
// exact minimum whatever the order.
//
// No NaN can arise for a valid chunk: the inverse direction is guarded to a
// finite nonzero value (|1/d| <= 1e20) and a valid chunk's box corners are
// finite, so every product is finite or +-inf and min/max are exact.
// Padding chunks (inverted +-3e38 boxes) are masked before any arithmetic
// reaches them.
//
// What bounds it: operations (about 30 instructions per (ray, chunk) pair on
// the CUDA cores); it reads the rays and boxes once and writes T x NC floats.

#include <cuda_runtime.h>

#define CHUNK_BATCH 512
#define MAX_RAY_TILE 256
#define INF_BITS 0x7f800000u
#define FULL_MASK 0xffffffffu

__global__ void __launch_bounds__(MAX_RAY_TILE) candidates_kernel(
    const float* __restrict__ org,     // [3, Np] shifted ray origins
    const float* __restrict__ inv,     // [3, Np] guarded 1 / d
    const float* __restrict__ lo,      // [NC, 3] chunk AABB
    const float* __restrict__ hi,      // [NC, 3]
    const unsigned char* __restrict__ valid,   // [NC] 0 for padding chunks
    int np_, int nc,
    float* __restrict__ score)         // [T, NC]
{
    __shared__ float s_lo[CHUNK_BATCH * 3];
    __shared__ float s_hi[CHUNK_BATCH * 3];
    __shared__ unsigned s_min[CHUNK_BATCH];
    __shared__ unsigned char s_valid[CHUNK_BATCH];

    const int tile = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const size_t r = (size_t)tile * blockDim.x + tid;
    const size_t np = (size_t)np_;
    const float o0 = org[0 * np + r], o1 = org[1 * np + r], o2 = org[2 * np + r];
    const float i0 = inv[0 * np + r], i1 = inv[1 * np + r], i2 = inv[2 * np + r];

    for (int base = 0; base < nc; base += CHUNK_BATCH) {
        const int n = min(CHUNK_BATCH, nc - base);
        for (int e = tid; e < 3 * n; e += blockDim.x) {
            s_lo[e] = lo[3 * (size_t)base + e];
            s_hi[e] = hi[3 * (size_t)base + e];
        }
        for (int e = tid; e < n; e += blockDim.x) {
            s_min[e] = INF_BITS;
            s_valid[e] = valid[base + e];
        }
        __syncthreads();

        #pragma unroll 4
        for (int j = 0; j < n; ++j) {
            if (!s_valid[j]) continue;            // uniform over the block
            const float a1 = __fmul_rn(__fsub_rn(s_lo[3 * j + 0], o0), i0);
            const float a2 = __fmul_rn(__fsub_rn(s_hi[3 * j + 0], o0), i0);
            const float b1 = __fmul_rn(__fsub_rn(s_lo[3 * j + 1], o1), i1);
            const float b2 = __fmul_rn(__fsub_rn(s_hi[3 * j + 1], o1), i1);
            const float c1 = __fmul_rn(__fsub_rn(s_lo[3 * j + 2], o2), i2);
            const float c2 = __fmul_rn(__fsub_rn(s_hi[3 * j + 2], o2), i2);
            const float t_entry = fmaxf(fmaxf(fminf(a1, a2), fminf(b1, b2)),
                                        fminf(c1, c2));
            const float t_exit = fminf(fminf(fmaxf(a1, a2), fmaxf(b1, b2)),
                                       fmaxf(c1, c2));
            const bool overlap = (t_entry <= t_exit) && (t_exit > 0.f);
            // max(t_entry, 0) as +0 (never -0, whose bits would order last)
            const float s = overlap ? (t_entry > 0.f ? t_entry : 0.f)
                                    : __uint_as_float(INF_BITS);
            const unsigned m = __reduce_min_sync(FULL_MASK,
                                                 __float_as_uint(s));
            if (lane == 0 && m != INF_BITS) atomicMin(&s_min[j], m);
        }
        __syncthreads();
        for (int e = tid; e < n; e += blockDim.x)
            score[(size_t)tile * nc + base + e] = __uint_as_float(s_min[e]);
        __syncthreads();
    }
}

extern "C" {

int candidates_max_ray_tile() { return MAX_RAY_TILE; }

// Launches on `stream` and returns cudaGetLastError(); does not synchronise.
int candidates_launch(const float* org, const float* inv, const float* lo,
                      const float* hi, const unsigned char* valid,
                      int n_tiles, int ray_tile, int nc, float* score,
                      void* stream) {
    if (n_tiles > 0 && nc > 0) {
        candidates_kernel<<<n_tiles, ray_tile, 0, (cudaStream_t)stream>>>(
            org, inv, lo, hi, valid, n_tiles * ray_tile, nc, score);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
