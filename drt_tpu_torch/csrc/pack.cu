// The oracle's packing stages for Hopper (sm_90a), bound through ctypes: one
// launch per query writes everything the candidate prepass (candidates.cu)
// and the closest-hit kernel (closest_hit.cu) read but the lists.
//
// Replaces the plain-XLA stages around the Pallas call in
// drt_tpu/intersect/pallas_kernel.py::intersect_pallas: `_coef_packed`
// (:291) over culled.py::_triangle_coefficients (:54), culled.py::
// _chunk_aabbs (:78), the group boxes (:449-471) and the ray features
// `inv3` and `phiT` (:473-487). Its plain version is `pack_plain` in
// drt_tpu_torch/intersect/cuda_kernel.py, made of the port's torch stages
// (`_coef_packed`, `_chunk_aabbs`, `_grouped_boxes`, `_safe_inv`).
//
// Outputs, allocated by the wrapper (NC = ceil(F / 128) chunks, NCg = NC
// rounded up to a multiple of `group`, NG = NCg / group):
//   coef [NCg,19,128]  the 19 nonzero Plücker coefficients of each triangle
//                      of a chunk, in the COEF_ROWS / COEF_COLS order; zero
//                      for an invalid face, a face beyond F and a padding
//                      chunk;
//   lo, hi [NCg,3]     the chunk boxes the closest-hit gate reads: a face
//                      contributes its 3 vertices, an invalid face the
//                      inverted box (+3e38, -3e38), a face beyond F the point
//                      0 (the zero rows that pad the faces to whole chunks);
//                      above group 1 a chunk without a valid face gets +inf;
//   box_lo, box_hi [NG,3], box_valid [NG]  the boxes the prepass scores: the
//                      chunks' own at group 1 (the wrapper passes lo and hi
//                      again, and they are written once); above it the
//                      min / max over the group's valid chunks, valid where
//                      any is, (+inf, -inf, 0) where none is;
//   phi [9,Np], inv [3,Np]  a ray's d, o x d and o (o less the shift; a
//                      padding lane has o = 0 and d = 1) and its guarded 1/d.
// Lane i of phi and inv holds ray i, or ray order[i] where the wrapper
// passes an order (order.cu: a one-origin query's rays sorted along the
// screen); a one-origin query passes its one origin row with org_stride 0.
//
// Design. One grid: NG mesh blocks, one a group of chunks, then T ray blocks,
// one a tile of ray_tile rays; PACK_BLOCK threads each.
// - Mesh block: thread j takes triangle j of each chunk of its group in
//   turn. It gathers the 3 vertices (float64 converted by
//   __double2float_rn, as .float() converts), subtracts the shift and writes
//   its 19 coefficients: row k of a chunk is 128 contiguous floats, so the
//   stores of a warp coalesce. Warp shuffles and one shared-memory step give
//   the chunk's min and max, `__syncthreads_or` its validity, and threads
//   0-2 (one an axis) keep the group's running min and max.
// - Ray block: a thread a lane, reading its ray's o and d ([N,3] rows,
//   through the order where there is one) and writing the 12 floats of phi
//   and inv in [row, lane] layout, coalesced.
//
// Rounding: every output equals the torch stages' on the card bit for bit
// (chip_smoke.py compares all eight as int32 views on every query it
// checks). Subtraction, negation, min, max and the float64 conversion are
// exact or correctly rounded on both sides. The rest is written as torch's
// CUDA kernels round it, measured on an H100 with torch 2.11.0+cu128 over
// 2^20 random and adversarial inputs (no other form matched):
// - torch.linalg.cross's kernel is compiled with nvcc's default contraction:
//   component a*b - c*d is __fmaf_rn(a, b, -(c*d)), where neither the
//   separately rounded form nor __fmaf_rn(-c, d, a*b) matched;
// - torch.sum(v0 * n, 1) over 3 terms reduces as ((x0 + x2) + x1) + 0: two
//   threads split the row and the reduction starts from +0;
// - 1.0 / x is reciprocal(x) * 1, which rounds as __frcp_rn.
// Signed zeros: torch's amin and amax keep whichever zero their reduction
// order meets last, which no kernel of another shape can follow, so the
// boxes write every zero as +0, and `pack_plain` adds +0 to its chunk boxes
// likewise. No slab test can tell the two zeros apart: the hits do not
// change.
//
// What bounds it: bytes. A query reads its rays (24 B a ray at float32), the
// faces, vertices and validity once, and writes 48 B a ray, 76 B a face and
// the boxes: on a 1280x960 view of a 38,962-face mesh about 95 MB, 28 us at
// 3.35 TB/s. Its worth is the ~50 torch launches a query it stands for,
// not its device time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no --use_fast_math).

#include <cuda_runtime.h>
#include <math_constants.h>

#define TRI_CHUNK 128
#define N_COEF 19
#define PACK_BLOCK 128       // a thread a triangle of the chunk
#define FULL_MASK 0xffffffffu
#define BIG 3e38f

static_assert(PACK_BLOCK == TRI_CHUNK,
              "a mesh block's thread takes one triangle of each chunk");

__device__ __forceinline__ float load(const void* p, size_t i, int f64) {
    return f64 ? __double2float_rn(static_cast<const double*>(p)[i])
               : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ long long load_index(const void* p, size_t i,
                                                int i64) {
    return i64 ? static_cast<const long long*>(p)[i]
               : (long long)static_cast<const int*>(p)[i];
}

// a * b - c * d as torch.linalg.cross's CUDA kernel rounds it
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
    return __fmaf_rn(a, b, -__fmul_rn(c, d));
}

// torch.linalg.cross(x, y)
__device__ __forceinline__ void cross3(const float* x, const float* y,
                                       float* out) {
    out[0] = cross_term(x[1], y[2], x[2], y[1]);
    out[1] = cross_term(x[2], y[0], x[0], y[2]);
    out[2] = cross_term(x[0], y[1], x[1], y[0]);
}

// torch's amin / amax: a NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float plus_zero(float x) {
    return __fadd_rn(x, 0.0f);             // -0 -> +0, else x
}

// The 19 coefficients of one valid triangle (rows v[0..2], shifted), in
// the COEF_ROWS / COEF_COLS order of `_triangle_coefficients`.
__device__ __forceinline__ void coefficients(const float v[3][3],
                                             float* k19) {
    float e1[3], e2[3], det[3], cu[3], cv[3], n[3], p[3];
    #pragma unroll
    for (int a = 0; a < 3; ++a) {
        e1[a] = __fsub_rn(v[1][a], v[0][a]);
        e2[a] = __fsub_rn(v[2][a], v[0][a]);
    }
    cross3(e2, e1, det);                   // det:    d . (e2 x e1)
    cross3(e2, v[0], cu);                  // u*det: -d . (e2 x v0), + w . e2
    cross3(e1, v[0], cv);                  // v*det:  d . (e1 x v0), - w . e1
    cross3(e1, e2, n);                     // t*det:  o . n - v0 . n
    #pragma unroll
    for (int a = 0; a < 3; ++a) {
        k19[a] = det[a];
        k19[3 + a] = -cu[a];
        k19[6 + a] = e2[a];
        k19[9 + a] = cv[a];
        k19[12 + a] = -e1[a];
        k19[15 + a] = n[a];
        p[a] = __fmul_rn(v[0][a], n[a]);
    }
    k19[18] = -plus_zero(__fadd_rn(__fadd_rn(p[0], p[2]), p[1]));
}

__global__ void __launch_bounds__(PACK_BLOCK) pack_kernel(
    const void* __restrict__ vertices, int vert_f64,   // [V,3]
    const void* __restrict__ faces, int faces_i64,     // [F,3]
    const unsigned char* __restrict__ face_valid,      // [F], null: all
    int n_faces, const float* __restrict__ shift,      // [3]
    const void* __restrict__ origins, int org_f64,     // [N,3], or [1,3]
    int org_stride,                                    // 3, or 0: one row
    const void* __restrict__ dirs, int dir_f64,        // [N,3]
    const int* __restrict__ order,                     // [>= N], null: i
    int n_rays, int n_groups, int group, int ray_tile, int np_,
    float* __restrict__ coef, float* __restrict__ lo, float* __restrict__ hi,
    float* __restrict__ box_lo, float* __restrict__ box_hi,
    unsigned char* __restrict__ box_valid,
    float* __restrict__ phi, float* __restrict__ inv)
{
    __shared__ float s_box[PACK_BLOCK / 32][6];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float sh[3] = {shift[0], shift[1], shift[2]};

    if ((int)blockIdx.x < n_groups) {
        const int gi = blockIdx.x;
        // thread a < 3: axis a of the group box
        float g_lo = CUDART_INF_F, g_hi = -CUDART_INF_F;
        bool g_any = false;
        for (int j = 0; j < group; ++j) {
            const size_t c = (size_t)gi * group + j;
            const long long f = (long long)c * TRI_CHUNK + tid;
            const bool in_mesh = f < n_faces;
            const bool valid = in_mesh
                               && (face_valid == nullptr || face_valid[f]);
            float k19[N_COEF];
            #pragma unroll
            for (int k = 0; k < N_COEF; ++k) k19[k] = 0.f;
            float f_lo[3] = {0.f, 0.f, 0.f}, f_hi[3] = {0.f, 0.f, 0.f};
            if (valid) {
                float v[3][3];
                #pragma unroll
                for (int q = 0; q < 3; ++q) {
                    const long long idx = load_index(faces, 3 * f + q,
                                                     faces_i64);
                    #pragma unroll
                    for (int a = 0; a < 3; ++a)
                        v[q][a] = __fsub_rn(load(vertices, 3 * idx + a,
                                                 vert_f64), sh[a]);
                }
                #pragma unroll
                for (int a = 0; a < 3; ++a) {
                    f_lo[a] = min_nan(min_nan(v[0][a], v[1][a]), v[2][a]);
                    f_hi[a] = max_nan(max_nan(v[0][a], v[1][a]), v[2][a]);
                }
                coefficients(v, k19);
            } else if (in_mesh) {
                #pragma unroll
                for (int a = 0; a < 3; ++a) {
                    f_lo[a] = BIG;
                    f_hi[a] = -BIG;
                }
            }
            float* out = coef + c * N_COEF * TRI_CHUNK + tid;
            #pragma unroll
            for (int k = 0; k < N_COEF; ++k) out[k * TRI_CHUNK] = k19[k];
            // the chunk's box: a warp, then the block
            #pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                #pragma unroll
                for (int a = 0; a < 3; ++a) {
                    f_lo[a] = min_nan(f_lo[a],
                                      __shfl_xor_sync(FULL_MASK, f_lo[a], off));
                    f_hi[a] = max_nan(f_hi[a],
                                      __shfl_xor_sync(FULL_MASK, f_hi[a], off));
                }
            }
            if (lane == 0) {
                #pragma unroll
                for (int a = 0; a < 3; ++a) {
                    s_box[warp][a] = f_lo[a];
                    s_box[warp][3 + a] = f_hi[a];
                }
            }
            const bool c_valid = __syncthreads_or(valid);
            if (tid < 3) {
                float c_lo = s_box[0][tid], c_hi = s_box[0][3 + tid];
                #pragma unroll
                for (int w = 1; w < PACK_BLOCK / 32; ++w) {
                    c_lo = min_nan(c_lo, s_box[w][tid]);
                    c_hi = max_nan(c_hi, s_box[w][3 + tid]);
                }
                if (group == 1) {
                    lo[3 * c + tid] = plus_zero(c_lo);
                    hi[3 * c + tid] = plus_zero(c_hi);
                } else {
                    lo[3 * c + tid] = c_valid ? plus_zero(c_lo)
                                              : CUDART_INF_F;
                    hi[3 * c + tid] = c_valid ? plus_zero(c_hi)
                                              : CUDART_INF_F;
                    if (c_valid) {
                        g_lo = min_nan(g_lo, c_lo);
                        g_hi = max_nan(g_hi, c_hi);
                    }
                }
            }
            if (group == 1 && tid == 0) box_valid[c] = c_valid;
            g_any |= c_valid;
            __syncthreads();               // s_box is the next chunk's
        }
        if (group > 1) {
            if (tid < 3) {
                box_lo[3 * (size_t)gi + tid] = plus_zero(g_lo);
                box_hi[3 * (size_t)gi + tid] = plus_zero(g_hi);
            }
            if (tid == 0) box_valid[gi] = g_any;
        }
        return;
    }

    const size_t np = (size_t)np_;
    const size_t tile = blockIdx.x - n_groups;
    for (int r = tid; r < ray_tile; r += blockDim.x) {
        const size_t i = tile * ray_tile + r;
        float o[3] = {0.f, 0.f, 0.f}, d[3] = {1.f, 1.f, 1.f};
        if (i < (size_t)n_rays) {
            const size_t j = order ? (size_t)order[i] : i;
            #pragma unroll
            for (int a = 0; a < 3; ++a) {
                o[a] = __fsub_rn(load(origins, org_stride * j + a, org_f64),
                                 sh[a]);
                d[a] = load(dirs, 3 * j + a, dir_f64);
            }
        }
        float w[3];
        cross3(o, d, w);
        #pragma unroll
        for (int a = 0; a < 3; ++a) {
            phi[a * np + i] = d[a];
            phi[(3 + a) * np + i] = w[a];
            phi[(6 + a) * np + i] = o[a];
            // _safe_inv: |d| <= 1e-20 (or NaN) becomes +-1e-20
            const float ds = fabsf(d[a]) > 1e-20f ? d[a]
                             : (d[a] >= 0.f ? 1e-20f : -1e-20f);
            inv[a * np + i] = __frcp_rn(ds);
        }
    }
}

extern "C" {

int pack_tri_chunk() { return TRI_CHUNK; }

int pack_n_coef() { return N_COEF; }

// The arguments of pack_launch, for the wrapper's interface check.
const char* pack_signature() {
    return "vertices vert_f64 faces faces_i64 face_valid n_faces shift "
           "origins org_f64 org_stride dirs dir_f64 order n_rays n_groups "
           "group n_tiles ray_tile coef lo hi box_lo box_hi box_valid phi "
           "inv stream";
}

// Launches on `stream` and returns cudaGetLastError(); does not synchronise.
// n_groups * group chunks must hold the faces, n_tiles * ray_tile the rays;
// origins holds a row every org_stride (3, or 0 for one shared origin), and
// order (or null) a ray index for each of the first n_rays lanes.
int pack_launch(const void* vertices, int vert_f64, const void* faces,
                int faces_i64, const unsigned char* face_valid, int n_faces,
                const float* shift, const void* origins, int org_f64,
                int org_stride, const void* dirs, int dir_f64,
                const int* order, int n_rays, int n_groups,
                int group, int n_tiles, int ray_tile, float* coef, float* lo,
                float* hi, float* box_lo, float* box_hi,
                unsigned char* box_valid, float* phi, float* inv,
                void* stream) {
    if (group < 1 || ray_tile < 1 || n_groups < 0 || n_tiles < 0
            || n_faces < 0 || n_rays < 0 || (org_stride != 3 && org_stride)
            || (long long)n_groups * group * TRI_CHUNK < n_faces
            || (long long)n_tiles * ray_tile < n_rays
            || (long long)n_tiles * ray_tile > 0x7fffffffLL
            || (long long)n_groups + n_tiles > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const int grid = n_groups + n_tiles;
    if (grid > 0)
        pack_kernel<<<grid, PACK_BLOCK, 0, (cudaStream_t)stream>>>(
            vertices, vert_f64, faces, faces_i64, face_valid, n_faces, shift,
            origins, org_f64, org_stride, dirs, dir_f64, order, n_rays,
            n_groups, group,
            ray_tile, n_tiles * ray_tile, coef, lo, hi, box_lo, box_hi,
            box_valid, phi, inv);
    return (int)cudaGetLastError();
}

}  // extern "C"
