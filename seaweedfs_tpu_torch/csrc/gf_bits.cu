// K5: GF(2^8) matrix apply as a GF(2) bit-matrix product, for NVIDIA
// Hopper (sm_90a).
//
// Replaces seaweedfs_tpu/ec/codec_tpu.py apply_matrix_bits (an XLA
// dot_general of the [R*8, C*8] int8 bit-matrix with the LSB-first
// bit-planes of the input, int32 sums masked & 1 and repacked, on the
// TPU's matrix unit), its vmapped batch form apply_matrix_bits_batch and
// the u32-lane wrappers apply_matrix_bits_u32 / _u32_batch. On the
// reference's serving path it takes every decode whose size bucket is
// under 64 KiB.
//
// Computes out[b][r] byte bit i = parity(sum over c, j of
//   A[8r + i][8c + j] * bit j of in[b][c]),
// in [B, C, n] and out [B, R, n] uint8, C, R <= 16.
//
// Bound: memory, B * (C + R) * n bytes at 3.35 TB/s: at the serving
// path's largest bucket, [10, 32768] -> [1], 360 KiB, 0.11 us. A launch
// costs more than that: the harness that times K5 (chip_smoke._kernel_ms,
// a CUDA graph of launches) spends about 1 us a launch on a one-element
// fill_, so K5 is held by fixed costs: the launch, one round trip to
// device memory and the chain of dependent steps after it.
//
// What held the first design (gf_bits_alu_kernel below) back: (1) a
// thread owned 4 byte columns of a 256-thread block, so n bytes made
// n / 1024 blocks: 1 at 1 KiB, 32 at 32 KiB, on a card of 132 SMs;
// (2) each output bit was a serial popcount-parity chain on the ALU,
// about 300 operations a thread at R = 1 and R times that at R rows,
// while the reference ran the product on its matrix unit; (3) each
// thread issued C separate 4-byte loads, n bytes apart; (4) most of its
// time was the launch's fixed cost, never measured beside it.
//
// The design (gf_bits_mma_kernel):
// - The product runs on the tensor cores, as a .b1 m16n8k128 AND-popc
//   mma (ptxas emits BMMA.168128 for it on sm_90a). Byte columns are the
//   mma's M, output bits its N, and K = 128 is the C <= 16 input rows x
//   8 bits, in the order k = 32t + 8q + j <-> bit j of input row 4q + t.
//   Lane (g = lane / 4, t = lane % 4) of a warp owns columns 4g..4g+3 of
//   the warp's 32: it loads input rows t, t+4, t+8, t+12 there (one word
//   each, at most 4 loads where the first design issued C) and transposes
//   them with __byte_perm into one word a column, byte q = row 4q + t.
//   Those words are the A fragments as they stand (M rows g and g+8 are
//   columns 4g+2h and 4g+2h+1 of product h = 0, 1), and output row r's B
//   fragment is one host-packed word a lane (codec_cuda.bit_frags). Two
//   mma a row replace the ALU chain (2); each output byte comes back as 2
//   bits in each of 4 lanes, ORed into one word of 4 columns by two
//   shuffles (gb_row) and stored directly, 32 bytes a row a
//   warp (3).
// - The rows are a template (RB, the least power of two >= R), so every
//   row's products are independent and unrolled and the matrix argument
//   is RB * 128 bytes, not 2 KiB. One row's fragment is read a word a
//   lane from the constant bank alongside the input loads; several rows'
//   are staged in shared memory by the block once the loads are issued
//   (the constant cache serializes 32 lanes' different words, and at
//   RB >= 2 one staged pass costs less than RB such reads).
// - A block is 4 warps, 128 byte columns (GB_SLAB): 256 blocks at
//   32 KiB where the first design had 32 (1). On an H100, blocks of 1 or
//   2 warps, which reach more SMs at 1-4 KiB, timed no faster, and
//   staged designs (the slab's rows brought in by cp.async.bulk on an
//   mbarrier, the output staged in shared memory and written 16 bytes a
//   thread) slower at every serving shape: at these sizes each added
//   step on the chain costs more than the traffic it saves (4). The
//   batch is blockIdx.y; the wrapper launches a batch of more than
//   65535 items in parts (a loop over items in the kernel made the
//   kernel heavier: 0.0003 ms more a launch at R = 4 on an H100).
//
// Dispatch, by shape only (codec_cuda.k5_takes_mma): the tensor-core
// kernel takes a call whose input and output pointers are 4-byte aligned
// and whose n is a multiple of 4 (every row and batch item then starts on
// 4 bytes, as the word loads and stores need); every other shape runs
// the ALU kernel's scalar variant. Its vector variant is the first
// design as it ran aligned shapes, reached only by a direct call of
// gf_bits_apply (chip_smoke times it beside the tensor-core kernel).
// Nothing falls back on a failure: a refused launch is returned as an
// error, and the wrapper raises.

#include <cuda_runtime.h>
#include <stdint.h>

#define GB_MAX_COLS 16
#define GB_MAX_ROWS 16
#define GB_LANES 32

// The tensor-core kernel's matrix argument: the B fragment word of each
// (output row r < RB, lane 4g + t), bit 8q + j = A[8r + g][8(4q + t) + j]
// (codec_cuda.bit_frags). RB * 128 bytes, a __grid_constant__.
template <int RB>
struct GbFrags {
    uint32_t f[RB][GB_LANES];
};

// 4x4 byte transpose: byte q of w[t] -> byte t of v[q]
__device__ __forceinline__ void gb_transpose(const uint32_t w[4], uint32_t v[4]) {
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
    const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
    v[0] = __byte_perm(lo01, lo23, 0x5410);
    v[1] = __byte_perm(lo01, lo23, 0x7632);
    v[2] = __byte_perm(hi01, hi23, 0x5410);
    v[3] = __byte_perm(hi01, hi23, 0x7632);
}

// d = A (16 x 128 bits, rows g / g+8 in a0 / a1) AND-popc B (128 bits x 8,
// column g in b); lane (g, t) gets D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1]
__device__ __forceinline__ void gb_mma_b1(uint32_t d[4], uint32_t a0, uint32_t a1,
                                          uint32_t b) {
    asm("mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a0), "r"(a1), "r"(b), "r"(0));
}

// Output row r of the 4 columns whose transposed words are v (column q in
// v[q], byte q' = input row 4q' + t): two products (columns 0, 1 then 2,
// 3 as M rows g, g+8), each output byte's 8 bits gathered from the 2 a
// lane holds (bits 2t, 2t+1) by two shuffles. Every lane of the group
// gets the 4 output bytes as one word, byte q = column q.
__device__ __forceinline__ uint32_t gb_row(const uint32_t v[4], uint32_t f, int t) {
    uint32_t d[2][4];
    gb_mma_b1(d[0], v[0], v[1], f);
    gb_mma_b1(d[1], v[2], v[3], f);
    uint32_t x = 0;
#pragma unroll
    for (int h = 0; h < 2; h++)
        x |= ((d[h][0] & 1u) | (d[h][1] & 1u) << 1 | (d[h][2] & 1u) << 8 |
              (d[h][3] & 1u) << 9) << (16 * h);
    x <<= 2 * t;
    x |= __shfl_xor_sync(0xffffffffu, x, 1);
    x |= __shfl_xor_sync(0xffffffffu, x, 2);
    return x;
}

#define GB_WORDS 4
#define GB_THREADS 256
#define GB_SLAB 128  // threads and byte columns of a tensor-core block

struct GbMasks {
    uint32_t m[GB_MAX_ROWS * 8][GB_WORDS];  // bit-matrix rows, LSB-first
};

// --- the ALU kernel: shapes the tensor-core kernel does not take ----------
//
// One thread owns 4 adjacent byte columns, one u32 lane per input row. It
// transposes the C lanes into, per column, the C*8-bit vector of that
// column's input bytes (byte c at bits 8c..8c+7), NW = ceil(C / 4) words.
// Each output bit is then parity(popc(XOR over words of mask & v)), with
// mask the bit-matrix row as NW words. The masks (2 KiB) are a
// __grid_constant__ read with every thread of a warp on the same word.
template <int NW, bool VEC>
__global__ void __launch_bounds__(GB_THREADS) gf_bits_alu_kernel(
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
            uint32_t lane[4], col[4];
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
            gb_transpose(lane, col);
#pragma unroll
            for (int q = 0; q < 4; q++) v[q][w] = col[q];
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
static int gb_alu_launch(const uint8_t* in, uint8_t* out, int cols, int rows,
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
        gf_bits_alu_kernel<NW, true><<<grid, GB_THREADS, 0, s>>>(
            in, out, cols, rows, n, batch, in_bstride, out_bstride, m);
    else
        gf_bits_alu_kernel<NW, false><<<grid, GB_THREADS, 0, s>>>(
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
        case 1: return gb_alu_launch<1>(x, y, c, r, n, batch, in_bstride, out_bstride, m, s);
        case 2: return gb_alu_launch<2>(x, y, c, r, n, batch, in_bstride, out_bstride, m, s);
        case 3: return gb_alu_launch<3>(x, y, c, r, n, batch, in_bstride, out_bstride, m, s);
        default: return gb_alu_launch<4>(x, y, c, r, n, batch, in_bstride, out_bstride, m, s);
    }
}

// --- the tensor-core kernel -------------------------------------------------

// RB: the output rows computed, the least of 1, 2, 4, 8, 16 that holds
// `rows`; rows past `rows` have zero fragments and are not stored.
template <int RB>
__global__ void __launch_bounds__(GB_SLAB) gf_bits_mma_kernel(
    const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int cols,
    int rows, long long n, long long in_bstride, long long out_bstride,
    const __grid_constant__ GbFrags<RB> frags) {
    constexpr bool STAGE = RB > 1;
    __shared__ uint32_t staged[STAGE ? RB * GB_LANES : 1];
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    // a block's threads are its byte columns, 32 a warp
    const long long base = (long long)blockIdx.x * GB_SLAB + (threadIdx.x & ~31);
    // warp-uniform: mma needs the whole warp (a staging block leaves after
    // its barrier)
    if (!STAGE && base >= n) return;
    const long long col = base + 4 * g;
    const bool valid = col < n;  // n is a multiple of 4
    uint32_t f[RB];
    if (!STAGE) f[0] = frags.f[0][lane];
    const uint8_t* src = in + blockIdx.y * in_bstride + col;
    uint32_t w[4], v[4];
#pragma unroll
    for (int q = 0; q < 4; q++) {
        const int c = 4 * q + t;
        w[q] = c < cols && valid
            ? __ldg(reinterpret_cast<const uint32_t*>(src + (long long)c * n)) : 0u;
    }
    if (STAGE) {
        for (int i = threadIdx.x; i < RB * GB_LANES; i += GB_SLAB)
            staged[i] = frags.f[i / GB_LANES][i % GB_LANES];
        __syncthreads();
#pragma unroll
        for (int r = 0; r < RB; r++) f[r] = staged[r * GB_LANES + lane];
    }
    if (base >= n) return;
    gb_transpose(w, v);  // v[q]: column col + q, byte q' = input row 4q' + t
    uint8_t* dst = out + blockIdx.y * out_bstride + col;
#pragma unroll
    for (int r = 0; r < RB; r++) {
        const uint32_t x = gb_row(v, f[r], t);
        if (t == 0 && valid && r < rows)
            *reinterpret_cast<uint32_t*>(dst + (long long)r * n) = x;
    }
}

template <int RB>
static int gb_mma_launch(const uint8_t* in, uint8_t* out, long long batch, int cols,
                         int rows, long long n, long long in_bstride,
                         long long out_bstride, const uint32_t* frags, cudaStream_t s) {
    GbFrags<RB> f;
    for (int r = 0; r < RB; r++)
        for (int l = 0; l < GB_LANES; l++)
            f.f[r][l] = r < rows ? frags[r * GB_LANES + l] : 0u;
    const dim3 grid((unsigned)((n + GB_SLAB - 1) / GB_SLAB), (unsigned)batch);
    gf_bits_mma_kernel<RB><<<grid, GB_SLAB, 0, s>>>(in, out, cols, rows, n, in_bstride,
                                                     out_bstride, f);
    return (int)cudaGetLastError();
}

// As gf_bits_apply, on the tensor-core kernel: in, out, n, in_bstride and
// out_bstride multiples of 4, batch <= 65535 (the grid's y; the wrapper
// launches a larger batch in parts). frags: host [rows][32] uint32
// (codec_cuda.bit_frags).
extern "C" int gf_bits_apply_mma(const void* in, void* out, long long batch,
                                 long long cols, long long rows, long long n,
                                 long long in_bstride, long long out_bstride,
                                 const void* frags, void* stream) {
    if (batch < 1 || batch > 65535 || n < 1 || cols < 1 || cols > GB_MAX_COLS ||
        rows < 1 || rows > GB_MAX_ROWS || n % 4 || in_bstride % 4 || out_bstride % 4 ||
        reinterpret_cast<uintptr_t>(in) % 4 || reinterpret_cast<uintptr_t>(out) % 4)
        return (int)cudaErrorInvalidValue;
    const uint8_t* x = static_cast<const uint8_t*>(in);
    uint8_t* y = static_cast<uint8_t*>(out);
    const uint32_t* f = static_cast<const uint32_t*>(frags);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int c = (int)cols, r = (int)rows;
    if (r <= 1) return gb_mma_launch<1>(x, y, batch, c, r, n, in_bstride, out_bstride, f, s);
    if (r <= 2) return gb_mma_launch<2>(x, y, batch, c, r, n, in_bstride, out_bstride, f, s);
    if (r <= 4) return gb_mma_launch<4>(x, y, batch, c, r, n, in_bstride, out_bstride, f, s);
    if (r <= 8) return gb_mma_launch<8>(x, y, batch, c, r, n, in_bstride, out_bstride, f, s);
    return gb_mma_launch<16>(x, y, batch, c, r, n, in_bstride, out_bstride, f, s);
}
