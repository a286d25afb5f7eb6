// The pieces of a stable LSD radix sort in one thread-block cluster, shared
// by csrc/scatter.cu (the row scatter-add sorts its rows by destination)
// and csrc/order.cu (a one-origin oracle query sorts its rays by
// direction).
//
// A pass ranks one 8-bit digit of the keys. A warp owns a contiguous range
// of the pass's input and counts its digits into its own RADIX counters
// (`warp_count`, `__match_any_sync`: the lowest lane of each digit adds).
// Once the prefix is known it walks its range again in order, 32 items a
// round, and places each at its warp's base for its digit plus its rank
// among the round's lanes of that digit (`warp_place`). So a pass is
// stable. An item whose digit is NO_DIGIT is neither counted nor placed.
//
// In a cluster, CTA k takes the k-th contiguous share of a pass's input
// (`share`), pushes its per-digit counts into every CTA's shared memory
// and, after a cluster barrier, forms its own exclusive prefix from that
// table: all lower digits of the cluster, then this digit in lower-ranked
// CTAs. A kernel built on these takes CLUSTER_SMEM bytes of dynamic shared
// memory: a warp's counters, then every CTA's counts of the pass.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#define RADIX_BITS 8
#define RADIX (1 << RADIX_BITS)
#define NO_DIGIT RADIX              // neither counted nor placed
#define FULL_MASK 0xffffffffu

#define CLUSTER_BLOCK 1024
#define CLUSTER_WARPS (CLUSTER_BLOCK / 32)
#define CLUSTER_MAX 16
#define CLUSTER_UNROLL 4            // rounds of 32 loaded before they rank
#define CLUSTER_SMEM ((CLUSTER_WARPS + CLUSTER_MAX) * RADIX * (int)sizeof(int))

static_assert(RADIX <= CLUSTER_BLOCK, "the digit steps take a digit a thread");

// The split cluster barrier: a CTA may touch another's shared memory only
// once that CTA has started, which the wait after an arrive at the
// kernel's start guarantees.
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Exclusive scan of one int a thread over a block of WARPS warps; *total
// gets the sum. Every thread of the block must call it.
template <int WARPS>
__device__ int block_exclusive_scan(int x, int* total) {
    __shared__ int warp_sums[WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int s = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL_MASK, s, o);
            if (lane >= o) s += y;
        }
        if (lane < WARPS) warp_sums[lane] = s;
    }
    __syncthreads();
    const int before = warp ? warp_sums[warp - 1] : 0;
    *total = warp_sums[WARPS - 1];
    __syncthreads();              // warp_sums is reused by the next call
    return before + incl - x;
}

__device__ __forceinline__ int digit_of(int key, int shift) {
    return key >= 0 ? (key >> shift) & (RADIX - 1) : NO_DIGIT;
}

// One round of a warp's count: each digit's lowest lane adds the number of
// the round's lanes with that digit to the warp's counter. The whole warp
// calls it.
__device__ __forceinline__ void warp_count(int digit, int* wcnt) {
    const unsigned peers = __match_any_sync(FULL_MASK, digit);
    if (digit != NO_DIGIT && (threadIdx.x & 31) == __ffs(peers) - 1)
        wcnt[digit] += __popc(peers);
    __syncwarp();
}

// One round of a warp's placement: the item's slot (-1 for a dead one) is
// the digit's base plus the warp's next slot of its digit (relative to it)
// plus the number of lower lanes of the round with the same digit; the
// digit's lowest lane then moves the warp's next slot past the round's
// items. The whole warp calls it.
__device__ __forceinline__ int warp_place(int digit, const int* base,
                                          int* wnext) {
    const int lane = threadIdx.x & 31;
    const unsigned peers = __match_any_sync(FULL_MASK, digit);
    const int pos = digit != NO_DIGIT
        ? base[digit] + wnext[digit] + __popc(peers & ((1u << lane) - 1u))
        : -1;
    __syncwarp();
    if (digit != NO_DIGIT && lane == __ffs(peers) - 1)
        wnext[digit] += __popc(peers);
    __syncwarp();
    return pos;
}

// The k-th of `parts` contiguous shares of [a, b).
__device__ __forceinline__ void share(int a, int b, int parts, int k,
                                      int* lo, int* hi) {
    const int len = (b - a + parts - 1) / parts;
    *lo = min(a + k * len, b);
    *hi = min(*lo + len, b);
}

// The launch of one cluster of k CTAs of CLUSTER_BLOCK threads and
// CLUSTER_SMEM dynamic shared bytes on stream s; attr holds its one
// attribute.
static cudaLaunchConfig_t cluster_config(int k, cudaLaunchAttribute* attr,
                                         cudaStream_t s) {
    cudaLaunchConfig_t cfg = {};
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = k;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.gridDim = dim3(k);
    cfg.blockDim = dim3(CLUSTER_BLOCK);
    cfg.dynamicSmemBytes = CLUSTER_SMEM;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// The largest cluster of such CTAs, CLUSTER_MAX down to 1, of which the
// card can hold one at a time for every kernel of fns; 0 if none.
static int largest_cluster(const void* const* fns, int n_fns) {
    for (int i = 0; i < n_fns; ++i) {
        if (cudaFuncSetAttribute(
                fns[i], cudaFuncAttributeNonPortableClusterSizeAllowed, 1)
            != cudaSuccess)
            cudaGetLastError();           // then only portable sizes fit
        if (cudaFuncSetAttribute(fns[i],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 CLUSTER_SMEM) != cudaSuccess) {
            cudaGetLastError();
            return 0;
        }
    }
    for (int k = CLUSTER_MAX; k >= 1; k /= 2) {
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg = cluster_config(k, &attr, 0);
        bool fits = true;
        for (int i = 0; i < n_fns; ++i) {
            int n = 0;
            if (cudaOccupancyMaxActiveClusters(&n, fns[i], &cfg)
                    != cudaSuccess || n < 1) {
                cudaGetLastError();
                fits = false;
            }
        }
        if (fits) return k;
    }
    return 0;
}
