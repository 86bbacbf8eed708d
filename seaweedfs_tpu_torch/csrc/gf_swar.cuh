// The SWAR GF(2^8) Horner chain shared by K1/K2 (gf_apply.cu) and K3
// (gf_verify.cu), for NVIDIA Hopper (sm_90a).
//
// A u32 lane holds 4 stream bytes (little-endian). Output row p is
//   y[p] = XOR over bits j of 2^j * (XOR of the columns c whose
//          coefficient M[p][c] has bit j set),
// evaluated by Horner from the row's top bit down, each step a branchless
// SWAR doubling of four packed bytes in GF(2^8) with polynomial 0x11D:
//   y' = ((y << 1) & 0xFEFEFEFE) ^ (((y & 0x80808080) >> 7) * 0x1D).
//
// The TPU kernel bakes each matrix into its program, so its chain holds
// only the nonzero terms. Here one compiled kernel serves encode and
// every decode matrix, and the matrix is the launch's argument. What
// keeps that cheap on the card:
// - Exact width: the kernels are templated on K, the number of input
//   columns (1..16, picked by a host-side switch), so the column loops
//   unroll to K and the columns take K * GF_LANES registers.
// - Branch-free terms: the matrix arrives as one 32-bit word per (row,
//   bit, column), 0 or 0xFFFFFFFF (GfTerms<K>, a __grid_constant__
//   parameter, so it is read where it lies in the constant bank and
//   never copied to local memory). A term is `y ^= x[c] & w`: one LOP3,
//   no predicate, no branch, no mask arithmetic in the vector pipe.
// - Horner start: a switch on maxj[p] enters the unrolled chain at the
//   row's top nonzero bit, so empty top bits cost nothing; that is one
//   branch per row, uniform across the warp.
// GfTerms<16> is 8,260 bytes. Kernel parameters above the classic 4 KiB
// need CUDA 12.1 or later to build and to run (up to 32,764 bytes on
// sm_70 and later); the H100 machine has nvcc 12.9 and the 12.8 runtime.
//
// Each thread owns GF_LANES consecutive lanes of a row (one 8-byte
// vector when the row's length and base address allow it, else
// masked scalar loads), keeps the K input vectors in registers and runs
// every output row's chain on them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define GF_MAX_K 16
#define GF_MAX_ROWS 16
#define GF_THREADS 256
// u32 lanes a thread (one 8-byte vector). 4 lanes (16-byte vectors) made
// K1 2-7% slower and K2 2.5% faster on the H100 (PERF.md); K1's
// launches outnumber K2's ten to one, so the kernels take 2.
#define GF_LANES 2

template <int K>
struct GfTerms {
    uint32_t w[GF_MAX_ROWS][8][K];  // ~0u where M[p][c] has bit j, else 0
    int32_t maxj[GF_MAX_ROWS];      // highest j with a nonzero word (Horner start)
    int32_t rows;
};

// Two LOP3s and a shift on the ALU pipe, a shift-by-multiply and the
// multiply on the FMA pipe. (`__umulhi(hb, 0x1D << 25)` would save the
// SHF, but on the H100 its IMAD.HI costs more: K2 ran 3% slower.)
__device__ __forceinline__ uint32_t gf_double4(uint32_t y) {
    const uint32_t hb = y & 0x80808080u;
    return ((y << 1) & 0xFEFEFEFEu) ^ ((hb >> 7) * 0x1Du);
}

// GF_LANES lanes of `row` from lane `base` on; lanes past n32 read as 0.
template <bool VEC>
__device__ __forceinline__ void gf_load(const uint32_t* __restrict__ row,
                                        long long base, long long n32,
                                        uint32_t (&v)[GF_LANES]) {
    if constexpr (VEC) {
        uint2 q = __ldg(reinterpret_cast<const uint2*>(row + base));
        v[0] = q.x; v[1] = q.y;
    } else {
#pragma unroll
        for (int e = 0; e < GF_LANES; e++)
            v[e] = (base + e < n32) ? __ldg(row + base + e) : 0u;
    }
}

template <bool VEC>
__device__ __forceinline__ void gf_store(uint32_t* __restrict__ row,
                                         long long base, long long n32,
                                         const uint32_t (&y)[GF_LANES]) {
    if constexpr (VEC) {
        *reinterpret_cast<uint2*>(row + base) = make_uint2(y[0], y[1]);
    } else {
#pragma unroll
        for (int e = 0; e < GF_LANES; e++)
            if (base + e < n32) row[base + e] = y[e];
    }
}

// Loads the K input rows of one volume (rows `n32` lanes apart).
template <int K, bool VEC>
__device__ __forceinline__ void gf_load_cols(const uint32_t* __restrict__ in,
                                             long long base, long long n32,
                                             uint32_t (&x)[K][GF_LANES]) {
#pragma unroll
    for (int c = 0; c < K; c++) gf_load<VEC>(in + (long long)c * n32, base, n32, x[c]);
}

// One Horner step at bit J: double (except at the top bit, where y is
// still 0), then add bit J's terms.
template <int K, int J>
__device__ __forceinline__ void gf_step(const uint32_t (&x)[K][GF_LANES],
                                        const uint32_t (&w)[8][K],
                                        uint32_t (&y)[GF_LANES]) {
    if constexpr (J < 7) {
#pragma unroll
        for (int e = 0; e < GF_LANES; e++) y[e] = gf_double4(y[e]);
    }
#pragma unroll
    for (int c = 0; c < K; c++) {
        const uint32_t t = w[J][c];
#pragma unroll
        for (int e = 0; e < GF_LANES; e++) y[e] ^= x[c][e] & t;
    }
}

// Output row with term words `w` and Horner start `top` applied to the
// loaded columns.
template <int K>
__device__ __forceinline__ void gf_row(const uint32_t (&x)[K][GF_LANES],
                                       const uint32_t (&w)[8][K], int top,
                                       uint32_t (&y)[GF_LANES]) {
#pragma unroll
    for (int e = 0; e < GF_LANES; e++) y[e] = 0u;
    switch (top) {
        case 7: gf_step<K, 7>(x, w, y); [[fallthrough]];
        case 6: gf_step<K, 6>(x, w, y); [[fallthrough]];
        case 5: gf_step<K, 5>(x, w, y); [[fallthrough]];
        case 4: gf_step<K, 4>(x, w, y); [[fallthrough]];
        case 3: gf_step<K, 3>(x, w, y); [[fallthrough]];
        case 2: gf_step<K, 2>(x, w, y); [[fallthrough]];
        case 1: gf_step<K, 1>(x, w, y); [[fallthrough]];
        default: gf_step<K, 0>(x, w, y);
    }
}

// Host: the argument struct from words [rows * 8 * K] uint32 and maxj
// [rows] int32 (codec_cuda.gf_terms).
template <int K>
static inline void gf_terms_from(const void* words, const void* maxj,
                                 long long rows, GfTerms<K>* m) {
    const uint32_t* w = static_cast<const uint32_t*>(words);
    const int32_t* mj = static_cast<const int32_t*>(maxj);
    for (int p = 0; p < GF_MAX_ROWS; p++) {
        for (int j = 0; j < 8; j++)
            for (int c = 0; c < K; c++)
                m->w[p][j][c] = p < rows ? w[(p * 8 + j) * K + c] : 0u;
        m->maxj[p] = p < rows ? mj[p] : 0;
    }
    m->rows = (int32_t)rows;
}

// Host: f(std::integral_constant<int, K>{}) for the runtime k in
// 1..GF_MAX_K; cudaErrorInvalidValue for any other k.
template <int K = 1, class F>
static inline int gf_with_k(long long k, F&& f) {
    if (k == K) return f(std::integral_constant<int, K>{});
    if constexpr (K < GF_MAX_K)
        return gf_with_k<K + 1>(k, f);
    else
        return (int)cudaErrorInvalidValue;
}

// Host: whether every row start is aligned to a thread's vector, so the
// vector path applies (base pointers aligned, lane count and volume
// strides multiples of GF_LANES).
static inline bool gf_vec_ok(long long n32, const void* a, long long a_vstride,
                             const void* b, long long b_vstride) {
    const uintptr_t align = 4u * GF_LANES - 1u;
    return n32 % GF_LANES == 0 && a_vstride % GF_LANES == 0 &&
           b_vstride % GF_LANES == 0 && (reinterpret_cast<uintptr_t>(a) & align) == 0 &&
           (reinterpret_cast<uintptr_t>(b) & align) == 0;
}

// Host: grid over (GF_LANES-lane groups, volumes); blockIdx.y strides
// over volumes past the 65535 limit of gridDim.y.
static inline dim3 gf_grid(long long n32, long long batch) {
    const long long groups = (n32 + GF_LANES - 1) / GF_LANES;
    const unsigned bx = (unsigned)((groups + GF_THREADS - 1) / GF_THREADS);
    const unsigned by = (unsigned)(batch < 65535 ? batch : 65535);
    return dim3(bx, by);
}
