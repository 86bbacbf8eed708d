// K5: GF(2^8) matrix apply as a GF(2) bit-matrix product, for NVIDIA
// Hopper (sm_90a).
//
// Replaces seaweedfs_tpu/ec/codec_tpu.py apply_matrix_bits (an XLA
// dot_general of the [R*8, C*8] int8 bit-matrix with the LSB-first
// bit-planes of the input, int32 sums masked & 1 and repacked), its
// vmapped batch form apply_matrix_bits_batch and the u32-lane wrappers
// apply_matrix_bits_u32 / _u32_batch. On the reference's serving path it
// takes every decode whose size bucket is under 64 KiB.
//
// Computes out[b][r] byte bit i = parity(sum over c, j of
//   A[8r + i][8c + j] * bit j of in[b][c]),
// in [B, C, n] and out [B, R, n] uint8, C, R <= 16.
//
// Bound: memory, B * (C + R) * n bytes at 3.35 TB/s, which at the
// n <= 32 KiB of the serving path is under 0.2 us: the launch itself
// (a few us) is what binds it there.
// Design: one thread owns 4 adjacent byte columns, one u32 lane per
// input row. It transposes the C lanes into, per column, the C*8-bit
// vector of that column's input bytes (byte c at bits 8c..8c+7, as
// unpack_bits orders them), NW = ceil(C / 4) words. Each output bit is
// then parity(popc(XOR over words of mask & v)), with mask the
// bit-matrix row as NW words: the parity of a sum of popcounts is the
// popcount parity of the XOR. The masks (R*8 <= 128 rows of 4 words,
// 2 KiB) are a __grid_constant__ parameter, read from the constant bank
// with every thread of a warp on the same word. The kernel is templated
// on NW so the column vectors stay in registers. blockIdx.y walks the
// batch, so one kernel serves the single and the batch forms.

#include <cuda_runtime.h>
#include <stdint.h>

#define GB_MAX_COLS 16
#define GB_MAX_ROWS 16
#define GB_WORDS 4
#define GB_THREADS 256

struct GbMasks {
    uint32_t m[GB_MAX_ROWS * 8][GB_WORDS];  // bit-matrix rows, LSB-first
};

template <int NW, bool VEC>
__global__ void __launch_bounds__(GB_THREADS) gf_bits_kernel(
    const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int cols,
    int rows, long long n, long long batch, long long in_bstride,
    long long out_bstride, const __grid_constant__ GbMasks masks) {
    const long long col0 =
        4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
    if (col0 >= n) return;
    for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
        const uint8_t* x = in + b * in_bstride + col0;
        // v[q][w]: column col0 + q's input bytes 4w..4w+3
        uint32_t v[4][NW];
#pragma unroll
        for (int w = 0; w < NW; w++) {
            uint32_t lane[4];
#pragma unroll
            for (int t = 0; t < 4; t++) {
                const int c = 4 * w + t;
                lane[t] = 0;
                if (c < cols) {
                    const uint8_t* p = x + (long long)c * n;
                    if (VEC) {
                        lane[t] = __ldg(reinterpret_cast<const uint32_t*>(p));
                    } else {
#pragma unroll
                        for (int s = 0; s < 4; s++)
                            if (col0 + s < n) lane[t] |= (uint32_t)p[s] << (8 * s);
                    }
                }
            }
            // 4x4 byte transpose: byte q of lane t -> byte t of v[q][w]
            const uint32_t lo01 = __byte_perm(lane[0], lane[1], 0x5140);
            const uint32_t lo23 = __byte_perm(lane[2], lane[3], 0x5140);
            const uint32_t hi01 = __byte_perm(lane[0], lane[1], 0x7362);
            const uint32_t hi23 = __byte_perm(lane[2], lane[3], 0x7362);
            v[0][w] = __byte_perm(lo01, lo23, 0x5410);
            v[1][w] = __byte_perm(lo01, lo23, 0x7632);
            v[2][w] = __byte_perm(hi01, hi23, 0x5410);
            v[3][w] = __byte_perm(hi01, hi23, 0x7632);
        }
        uint8_t* y = out + b * out_bstride + col0;
#pragma unroll 1
        for (int r = 0; r < rows; r++) {
            uint32_t word = 0;  // output byte of column col0 + q at byte q
#pragma unroll
            for (int i = 0; i < 8; i++) {
                const uint32_t* mrow = masks.m[8 * r + i];
#pragma unroll
                for (int q = 0; q < 4; q++) {
                    uint32_t acc = mrow[0] & v[q][0];
#pragma unroll
                    for (int w = 1; w < NW; w++) acc ^= mrow[w] & v[q][w];
                    word |= (uint32_t)(__popc(acc) & 1) << (8 * q + i);
                }
            }
            uint8_t* dst = y + (long long)r * n;
            if (VEC) {
                *reinterpret_cast<uint32_t*>(dst) = word;
            } else {
#pragma unroll
                for (int s = 0; s < 4; s++)
                    if (col0 + s < n) dst[s] = (uint8_t)(word >> (8 * s));
            }
        }
    }
}

template <int NW>
static int gb_launch(const uint8_t* in, uint8_t* out, int cols, int rows,
                     long long n, long long batch, long long in_bstride,
                     long long out_bstride, const GbMasks& m, cudaStream_t s) {
    const long long threads = (n + 3) / 4;
    const dim3 grid((unsigned)((threads + GB_THREADS - 1) / GB_THREADS),
                    (unsigned)(batch < 65535 ? batch : 65535));
    const bool vec = n % 4 == 0 && in_bstride % 4 == 0 &&
                     out_bstride % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(in) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 4 == 0;
    if (vec)
        gf_bits_kernel<NW, true><<<grid, GB_THREADS, 0, s>>>(
            in, out, cols, rows, n, batch, in_bstride, out_bstride, m);
    else
        gf_bits_kernel<NW, false><<<grid, GB_THREADS, 0, s>>>(
            in, out, cols, rows, n, batch, in_bstride, out_bstride, m);
    return (int)cudaGetLastError();
}

// in: [batch, cols, n] and out: [batch, rows, n] uint8 device pointers;
// rows of a batch item n bytes apart, items in_bstride / out_bstride
// bytes apart. masks: host [rows * 8][4] uint32, bit-matrix row 8r + i
// with column 8c + j at bit (8c + j) % 32 of word (8c + j) / 32
// (codec_cuda.bit_masks). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int gf_bits_apply(const void* in, void* out, long long batch,
                             long long cols, long long rows, long long n,
                             long long in_bstride, long long out_bstride,
                             const void* masks, void* stream) {
    if (batch < 1 || n < 1 || cols < 1 || cols > GB_MAX_COLS || rows < 1 ||
        rows > GB_MAX_ROWS)
        return (int)cudaErrorInvalidValue;
    GbMasks m;
    const uint32_t* src = static_cast<const uint32_t*>(masks);
    for (int i = 0; i < GB_MAX_ROWS * 8; i++)
        for (int w = 0; w < GB_WORDS; w++)
            m.m[i][w] = i < rows * 8 ? src[i * GB_WORDS + w] : 0u;
    const uint8_t* x = static_cast<const uint8_t*>(in);
    uint8_t* y = static_cast<uint8_t*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int c = (int)cols, r = (int)rows;
    switch ((c + 3) / 4) {
        case 1: return gb_launch<1>(x, y, c, r, n, batch, in_bstride, out_bstride, m, s);
        case 2: return gb_launch<2>(x, y, c, r, n, batch, in_bstride, out_bstride, m, s);
        case 3: return gb_launch<3>(x, y, c, r, n, batch, in_bstride, out_bstride, m, s);
        default: return gb_launch<4>(x, y, c, r, n, batch, in_bstride, out_bstride, m, s);
    }
}
