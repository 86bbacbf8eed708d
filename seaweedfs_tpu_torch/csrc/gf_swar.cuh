// The SWAR GF(2^8) Horner chain shared by K1/K2 (gf_apply.cu) and K3
// (gf_verify.cu), for NVIDIA Hopper (sm_90a).
//
// A u32 lane holds 4 stream bytes (little-endian). For output row p and
// bit j, mask[p][j] is the set of input columns whose coefficient has
// bit j set; then y[p] = Horner over j of the XOR of those columns, each
// step a branchless SWAR doubling of four packed bytes in GF(2^8) with
// polynomial 0x11D:
//   y' = ((y << 1) & 0xFEFEFEFE) ^ (((y & 0x80808080) >> 7) * 0x1D).
// The matrix is a per-launch argument struct, so one compiled kernel
// serves encode and every decode matrix.
//
// Each thread owns 4 consecutive lanes of a row (one 16-byte vector when
// the row's length and base address allow it, else 4 masked scalar
// loads), keeps the k input vectors in registers and runs every output
// row's chain on them. The loops over columns and bits are unrolled; the
// branches on the mask bits are uniform across the warp.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GF_MAX_K 16
#define GF_MAX_ROWS 16
#define GF_THREADS 256

struct GfMatrix {
    uint32_t mask[GF_MAX_ROWS][8];  // bit c of mask[p][j]: column c in set (p, j)
    int32_t maxj[GF_MAX_ROWS];      // highest j with a nonempty set (Horner start)
    int32_t rows;
    int32_t k;
};

__device__ __forceinline__ uint32_t gf_double4(uint32_t y) {
    uint32_t hb = y & 0x80808080u;
    return ((y << 1) & 0xFEFEFEFEu) ^ ((hb >> 7) * 0x1Du);
}

// 4 lanes of `row` from lane `base` on; lanes past n32 read as 0.
template <bool VEC>
__device__ __forceinline__ void gf_load4(const uint32_t* __restrict__ row,
                                         long long base, long long n32,
                                         uint32_t v[4]) {
    if (VEC) {
        uint4 q = __ldg(reinterpret_cast<const uint4*>(row + base));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
        for (int e = 0; e < 4; e++)
            v[e] = (base + e < n32) ? __ldg(row + base + e) : 0u;
    }
}

template <bool VEC>
__device__ __forceinline__ void gf_store4(uint32_t* __restrict__ row,
                                          long long base, long long n32,
                                          const uint32_t y[4]) {
    if (VEC) {
        *reinterpret_cast<uint4*>(row + base) = make_uint4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
        for (int e = 0; e < 4; e++)
            if (base + e < n32) row[base + e] = y[e];
    }
}

// Loads the k input rows of one volume (rows `n32` lanes apart).
template <bool VEC>
__device__ __forceinline__ void gf_load_cols(const uint32_t* __restrict__ in,
                                             long long base, long long n32,
                                             const GfMatrix& m,
                                             uint32_t x[GF_MAX_K][4]) {
#pragma unroll
    for (int c = 0; c < GF_MAX_K; c++)
        if (c < m.k) gf_load4<VEC>(in + (long long)c * n32, base, n32, x[c]);
}

// Output row p of the matrix applied to the loaded columns.
__device__ __forceinline__ void gf_row4(uint32_t x[GF_MAX_K][4],
                                        const GfMatrix& m, int p,
                                        uint32_t y[4]) {
    y[0] = y[1] = y[2] = y[3] = 0u;
    const int top = m.maxj[p];
#pragma unroll
    for (int j = 7; j >= 0; j--) {
        if (j > top) continue;
        const uint32_t sel = m.mask[p][j];
#pragma unroll
        for (int e = 0; e < 4; e++) y[e] = gf_double4(y[e]);
#pragma unroll
        for (int c = 0; c < GF_MAX_K; c++) {
            if (c < m.k && ((sel >> c) & 1u)) {
#pragma unroll
                for (int e = 0; e < 4; e++) y[e] ^= x[c][e];
            }
        }
    }
}

// Host: the argument struct from masks [rows * 8] uint32 and maxj [rows]
// int32 (codec_cuda.gf_masks). False when the shape is out of range.
static inline bool gf_matrix_from(const void* masks, const void* maxj,
                                  long long k, long long rows, GfMatrix* m) {
    if (k < 1 || k > GF_MAX_K || rows < 1 || rows > GF_MAX_ROWS) return false;
    const uint32_t* mk = static_cast<const uint32_t*>(masks);
    const int32_t* mj = static_cast<const int32_t*>(maxj);
    for (int p = 0; p < GF_MAX_ROWS; p++) {
        for (int j = 0; j < 8; j++) m->mask[p][j] = p < rows ? mk[p * 8 + j] : 0u;
        m->maxj[p] = p < rows ? mj[p] : 0;
    }
    m->rows = (int32_t)rows;
    m->k = (int32_t)k;
    return true;
}

// Host: whether every row start is 16-byte aligned, so the vector path
// applies (base pointers aligned, lane count and volume strides
// multiples of 4 lanes).
static inline bool gf_vec_ok(long long n32, const void* a, long long a_vstride,
                             const void* b, long long b_vstride) {
    return n32 % 4 == 0 && a_vstride % 4 == 0 && b_vstride % 4 == 0 &&
           (reinterpret_cast<uintptr_t>(a) & 15u) == 0 &&
           (reinterpret_cast<uintptr_t>(b) & 15u) == 0;
}

// Host: grid over (4-lane groups, volumes); blockIdx.y strides over
// volumes past the 65535 limit of gridDim.y.
static inline dim3 gf_grid(long long n32, long long batch) {
    const long long groups = (n32 + 3) / 4;
    const unsigned bx = (unsigned)((groups + GF_THREADS - 1) / GF_THREADS);
    const unsigned by = (unsigned)(batch < 65535 ? batch : 65535);
    return dim3(bx, by);
}
