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
// add rounded on its own (__fadd_rn / __dadd_rn). No float atomic touches
// the output, so one input gives the same bits on every run. A row whose
// every entry is +-0 is skipped: an accumulator that starts at +0 is never
// -0, and x + (+-0) = x, so the bits do not change. That takes out the rows
// of dead lanes and of padding, which the step sends by the hundred
// thousand to a handful of destinations (safe_id 0, edge 0, face 0). An
// index outside [0, V), negative ones included, sets a flag in the last int
// of the scratch (its row is dropped), and the wrapper raises on it, as the
// plain version does.
//
// Design: a stable LSD radix sort of the live rows by destination, 8 bits a
// pass, then a thread a (destination, column).
// - Pass 0, `live_hist_kernel`: a block a tile of 2,048 rows keys each row
//   (its index, -1 if it is all zeros or out of range, which also sets the
//   flag) and counts the live keys' low 8 bits in shared memory, into a
//   digit-major [256, tiles] table.
// - `scan_*`: one exclusive scan of that table gives each (digit, tile) its
//   first output slot; its total is the number M of live rows.
// - `sort_kernel`: each block walks its tile in order, 256 rows a round,
//   ranks a row among the round's rows of its digit (__match_any_sync and
//   per-warp counts in shared memory) and writes (key, row) to its slot: a
//   stable pass, which drops the dead rows on the way.
// - Passes 1.. (`hist_kernel`, the scan, `sort_kernel`) take the next 8
//   bits of the M live (key, row) pairs until every bit below V is sorted:
//   2 passes up to 65,536 destinations. Stable passes keep each
//   destination's rows in ascending row order.
// - `reduce_kernel`: thread (d, c) finds d's run in the sorted keys by
//   binary search and sums column c of its rows in that order.
// Integer atomics only, and only in shared memory (the digit counts).
//
// What bounds it: bytes. The rows and the indices are read once, the output
// written once; on a step's bounce-1 soup scatter on dog_mid45k (1,228,800
// rows of 9 floats into 65,536 faces) about 56 MB, 17 us at 3.35 TB/s. The
// sort moves 16 B a live row a pass on top, and a destination's sum is one
// thread's chain of adds: the kernel is launch- and latency-bound at the
// step's sizes, not bandwidth-bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no --use_fast_math).

#include <cuda_runtime.h>

#define SCATTER_BLOCK 256
#define SCATTER_ITEMS 8
#define SCATTER_TILE (SCATTER_BLOCK * SCATTER_ITEMS)
#define RADIX_BITS 8
#define RADIX (1 << RADIX_BITS)
#define WARPS (SCATTER_BLOCK / 32)
#define MAX_COLS 16
#define FULL_MASK 0xffffffffu

static_assert(RADIX == SCATTER_BLOCK,
              "the block-wide steps take a digit a thread");

template <typename T> __device__ __forceinline__ T add_rn(T a, T b);
template <> __device__ __forceinline__ float add_rn<float>(float a, float b) {
    return __fadd_rn(a, b);
}
template <> __device__ __forceinline__ double add_rn<double>(double a,
                                                             double b) {
    return __dadd_rn(a, b);
}

// Exclusive scan of one int a thread over the block; *total gets the sum.
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

// Pass 0: keys[e] = idx[e] for a live row (an entry not +-0, the index in
// [0, n_out)), -1 otherwise; hist[digit * n_tiles + tile] counts the live
// keys' low RADIX_BITS bits. *bad becomes 1 if any index lies outside
// [0, n_out).
template <typename T>
__global__ void __launch_bounds__(SCATTER_BLOCK)
live_hist_kernel(const T* __restrict__ rows, const long long* __restrict__ idx,
                 int n_rows, int n_cols, int n_out, int n_tiles,
                 int* __restrict__ keys, int* __restrict__ hist,
                 int* __restrict__ bad) {
    __shared__ int cnt[RADIX];
    cnt[threadIdx.x] = 0;
    __syncthreads();
    const int tile = blockIdx.x;
    for (int k = 0; k < SCATTER_ITEMS; ++k) {
        const int e = tile * SCATTER_TILE + k * SCATTER_BLOCK + threadIdx.x;
        if (e >= n_rows) break;
        const long long d = idx[e];
        bool live = false;
        if (d >= 0 && d < n_out) {
            const T* row = rows + (long long)e * n_cols;
            for (int c = 0; c < n_cols; ++c)
                live |= row[c] != T(0);          // NaN is live
        } else {
            *bad = 1;
        }
        keys[e] = live ? (int)d : -1;
        if (live) atomicAdd(&cnt[(int)d & (RADIX - 1)], 1);
    }
    __syncthreads();
    hist[threadIdx.x * n_tiles + tile] = cnt[threadIdx.x];
}

// Passes 1..: the digit (key >> shift) of the *n_live sorted pairs.
__global__ void __launch_bounds__(SCATTER_BLOCK)
hist_kernel(const int* __restrict__ keys, const int* __restrict__ n_live,
            int shift, int n_tiles, int* __restrict__ hist) {
    __shared__ int cnt[RADIX];
    cnt[threadIdx.x] = 0;
    __syncthreads();
    const int n = *n_live;
    const int tile = blockIdx.x;
    for (int k = 0; k < SCATTER_ITEMS; ++k) {
        const int e = tile * SCATTER_TILE + k * SCATTER_BLOCK + threadIdx.x;
        if (e >= n) break;
        atomicAdd(&cnt[(keys[e] >> shift) & (RADIX - 1)], 1);
    }
    __syncthreads();
    hist[threadIdx.x * n_tiles + tile] = cnt[threadIdx.x];
}

// part[b] = the sum of data[b * SCATTER_TILE ...] (SCATTER_TILE entries).
__global__ void __launch_bounds__(SCATTER_BLOCK)
scan_reduce_kernel(const int* __restrict__ data, int n,
                   int* __restrict__ part) {
    const int i0 = blockIdx.x * SCATTER_TILE + threadIdx.x * SCATTER_ITEMS;
    int s = 0;
#pragma unroll
    for (int k = 0; k < SCATTER_ITEMS; ++k)
        if (i0 + k < n) s += data[i0 + k];
    int total;
    block_exclusive_scan(s, &total);
    if (threadIdx.x == 0) part[blockIdx.x] = total;
}

// One block: part becomes its exclusive scan, *total_out its sum.
__global__ void __launch_bounds__(SCATTER_BLOCK)
scan_parts_kernel(int* __restrict__ part, int n_parts,
                  int* __restrict__ total_out) {
    int carry = 0;
    for (int s = 0; s < n_parts; s += SCATTER_BLOCK) {
        const int i = s + threadIdx.x;
        const int x = i < n_parts ? part[i] : 0;
        int total;
        const int ex = block_exclusive_scan(x, &total);
        if (i < n_parts) part[i] = carry + ex;
        carry += total;
    }
    if (threadIdx.x == 0) *total_out = carry;
}

// data becomes its exclusive scan, block b's entries offset by part[b].
__global__ void __launch_bounds__(SCATTER_BLOCK)
scan_apply_kernel(int* __restrict__ data, int n,
                  const int* __restrict__ part) {
    const int i0 = blockIdx.x * SCATTER_TILE + threadIdx.x * SCATTER_ITEMS;
    int v[SCATTER_ITEMS];
    int s = 0;
#pragma unroll
    for (int k = 0; k < SCATTER_ITEMS; ++k) {
        v[k] = i0 + k < n ? data[i0 + k] : 0;
        s += v[k];
    }
    int total;
    int run = part[blockIdx.x] + block_exclusive_scan(s, &total);
#pragma unroll
    for (int k = 0; k < SCATTER_ITEMS; ++k) {
        if (i0 + k < n) data[i0 + k] = run;
        run += v[k];
    }
}

// One stable pass: the live pairs of tile `blockIdx.x`, in order, to their
// slots. Pass 0 (vals null) reads the n_rows keys of live_hist_kernel (-1
// dead) and takes a pair's row as its position; later passes the *n_live
// pairs of the pass before. offsets: the scanned [RADIX, n_tiles] table.
__global__ void __launch_bounds__(SCATTER_BLOCK)
sort_kernel(const int* __restrict__ keys, const int* __restrict__ vals,
            int n_rows, const int* __restrict__ n_live, int shift,
            int n_tiles, const int* __restrict__ offsets,
            int* __restrict__ out_keys, int* __restrict__ out_vals) {
    __shared__ int base[RADIX];
    __shared__ int warp_cnt[WARPS][RADIX];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int tile = blockIdx.x;
    const int n = n_live ? *n_live : n_rows;
    if (tile * SCATTER_TILE >= n) return;           // the whole block
    base[tid] = offsets[tid * n_tiles + tile];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) warp_cnt[w][tid] = 0;
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
    for (int k = 0; k < SCATTER_ITEMS; ++k) {
        const int e = tile * SCATTER_TILE + k * SCATTER_BLOCK + tid;
        const int key = e < n ? keys[e] : -1;
        const int digit = key >= 0 ? (key >> shift) & (RADIX - 1) : RADIX;
        const unsigned peers = __match_any_sync(FULL_MASK, digit);
        const int rank = __popc(peers & below);     // 0: the lowest lane
        if (digit < RADIX && rank == 0) warp_cnt[warp][digit] = __popc(peers);
        __syncthreads();
        if (digit < RADIX) {
            int pos = base[digit] + rank;
            for (int w = 0; w < warp; ++w) pos += warp_cnt[w][digit];
            out_keys[pos] = key;
            out_vals[pos] = vals ? vals[e] : e;
        }
        __syncthreads();
        int sum = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            sum += warp_cnt[w][tid];
            warp_cnt[w][tid] = 0;
        }
        base[tid] += sum;
        __syncthreads();
    }
}

// The first position in keys[0, n) (ascending) whose key is not below x.
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys,
                                           int n, int x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (keys[mid] < x) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// out[d, c] = the sum of column c of d's rows, in ascending row order.
template <typename T>
__global__ void __launch_bounds__(SCATTER_BLOCK)
reduce_kernel(const T* __restrict__ rows, const int* __restrict__ keys,
              const int* __restrict__ vals, const int* __restrict__ n_live,
              int n_out, int n_cols, T* __restrict__ out) {
    const long long i = (long long)blockIdx.x * SCATTER_BLOCK + threadIdx.x;
    if (i >= (long long)n_out * n_cols) return;
    const int d = (int)(i / n_cols);
    const int c = (int)(i - (long long)d * n_cols);
    const int n = *n_live;
    const int lo = lower_bound(keys, n, d);
    const int hi = lo + lower_bound(keys + lo, n - lo, d + 1);
    T acc = T(0);
    int j = lo;
    for (; j + 4 <= hi; j += 4) {            // 4 loads in flight, adds in order
        const T r0 = rows[(long long)vals[j] * n_cols + c];
        const T r1 = rows[(long long)vals[j + 1] * n_cols + c];
        const T r2 = rows[(long long)vals[j + 2] * n_cols + c];
        const T r3 = rows[(long long)vals[j + 3] * n_cols + c];
        acc = add_rn(add_rn(add_rn(add_rn(acc, r0), r1), r2), r3);
    }
    for (; j < hi; ++j)
        acc = add_rn(acc, rows[(long long)vals[j] * n_cols + c]);
    out[i] = acc;
}

static int n_tiles_of(long long n_rows) {
    return (int)((n_rows + SCATTER_TILE - 1) / SCATTER_TILE);
}

extern "C" {

int scatter_max_cols() { return MAX_COLS; }

// int32 scratch scatter_launch needs for n_rows rows: keys and rows of two
// passes, the digit table, its block sums, the live count and, last, the
// out-of-range flag.
long long scatter_scratch_ints(long long n_rows) {
    const long long n_hist = (long long)RADIX * n_tiles_of(n_rows);
    return 4 * n_rows + n_hist + (n_hist + SCATTER_TILE - 1) / SCATTER_TILE
           + 2;
}

// The arguments of scatter_launch, for the wrapper's interface check.
const char* scatter_signature() {
    return "rows rows_f64 idx n_rows n_cols n_out out scratch stream";
}

// Launches on `stream` and returns cudaGetLastError(); does not synchronise.
// rows [n_rows, n_cols] (float, or double with rows_f64), idx [n_rows]
// int64, out [n_out, n_cols] of the rows' type, scratch
// scatter_scratch_ints(n_rows) ints; all contiguous on one device. When the
// launch has run, the last int of scratch is 1 if an index lay outside
// [0, n_out) and 0 otherwise.
int scatter_launch(const void* rows, int rows_f64, const long long* idx,
                   int n_rows, int n_cols, int n_out, void* out,
                   int* scratch, void* stream) {
    if (n_rows < 0 || n_out < 0 || n_cols < 1 || n_cols > MAX_COLS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int n_tiles = n_tiles_of(n_rows);
    const int n_hist = RADIX * n_tiles;
    const int n_parts = (n_hist + SCATTER_TILE - 1) / SCATTER_TILE;
    int* key_a = scratch;
    int* val_a = key_a + n_rows;
    int* key_b = val_a + n_rows;
    int* val_b = key_b + n_rows;
    int* hist = val_b + n_rows;
    int* part = hist + n_hist;
    int* n_live = part + n_parts;
    int* bad = n_live + 1;
    int bits = 0;                       // keys lie in [0, 2^bits)
    while (bits < 31 && (1LL << bits) < n_out) ++bits;
    const int passes = bits > RADIX_BITS
                       ? (bits + RADIX_BITS - 1) / RADIX_BITS : 1;
    int* sorted_k = key_a;
    int* sorted_v = val_a;
    cudaMemsetAsync(n_live, 0, 2 * sizeof(int), s);       // n_live, bad
    if (n_rows > 0) {
        for (int p = 0; p < passes; ++p) {
            // pass p reads a (pass 0: the keys alone) or b, writes the other
            int* in_k = p % 2 ? key_b : key_a;
            int* in_v = p % 2 ? val_b : val_a;
            int* out_k = p % 2 ? key_a : key_b;
            int* out_v = p % 2 ? val_a : val_b;
            const int shift = p * RADIX_BITS;
            if (p == 0) {
                if (rows_f64)
                    live_hist_kernel<double><<<n_tiles, SCATTER_BLOCK, 0, s>>>(
                        (const double*)rows, idx, n_rows, n_cols, n_out,
                        n_tiles, key_a, hist, bad);
                else
                    live_hist_kernel<float><<<n_tiles, SCATTER_BLOCK, 0, s>>>(
                        (const float*)rows, idx, n_rows, n_cols, n_out,
                        n_tiles, key_a, hist, bad);
            } else {
                hist_kernel<<<n_tiles, SCATTER_BLOCK, 0, s>>>(
                    in_k, n_live, shift, n_tiles, hist);
            }
            scan_reduce_kernel<<<n_parts, SCATTER_BLOCK, 0, s>>>(
                hist, n_hist, part);
            scan_parts_kernel<<<1, SCATTER_BLOCK, 0, s>>>(part, n_parts,
                                                         n_live);
            scan_apply_kernel<<<n_parts, SCATTER_BLOCK, 0, s>>>(
                hist, n_hist, part);
            sort_kernel<<<n_tiles, SCATTER_BLOCK, 0, s>>>(
                in_k, p == 0 ? nullptr : in_v, n_rows,
                p == 0 ? nullptr : n_live, shift, n_tiles, hist, out_k,
                out_v);
            sorted_k = out_k;
            sorted_v = out_v;
        }
    }
    const long long n_threads = (long long)n_out * n_cols;
    if (n_threads > 0) {
        const int grid = (int)((n_threads + SCATTER_BLOCK - 1) / SCATTER_BLOCK);
        if (rows_f64)
            reduce_kernel<double><<<grid, SCATTER_BLOCK, 0, s>>>(
                (const double*)rows, sorted_k, sorted_v, n_live, n_out,
                n_cols, (double*)out);
        else
            reduce_kernel<float><<<grid, SCATTER_BLOCK, 0, s>>>(
                (const float*)rows, sorted_k, sorted_v, n_live, n_out,
                n_cols, (float*)out);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
