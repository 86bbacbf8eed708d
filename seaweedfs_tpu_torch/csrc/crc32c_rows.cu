// K4: CRC-32C of each row of a [R, n32] uint32 tile, for NVIDIA Hopper.
//
// Replaces seaweedfs_tpu/ec/crc_kernel.py crc_lin_rows / crc32c_rows
// (the XLA bit-matmul program fused into encode_u32_crc and
// reconstruct_u32_crc), bit-identical to a standard CRC-32C of each
// row's 4 * n32 bytes (each word little-endian).
//
// Bound: memory, 4 * R * n32 bytes read once at 3.35 TB/s. Below that
// line what limits it is integer issue and latency: a byte costs one
// table lookup and 4 more instructions (shift, LOP3, shift, XOR) on a
// dependent chain, and a block pays a fixed cost (table copy, combine,
// ticket) of about 64 byte steps.
//
// Design. The raw CRC (zero init, no final xor) is GF(2)-linear and
// leading zero bytes leave it unchanged, so each row is treated as
// front-padded with zero words to a whole number of chunks. One launch,
// one block of 256 threads per (chunk, row):
//   - lookups without bank conflicts: one 256-entry byte table
//     (Sarwate's bytewise step) built on the host and kept on the device
//     with each entry four times; each block copies it into shared memory
//     as 32 lane-private copies, laid out tab[byte][lane] (8 coalesced
//     16-byte loads and stores a thread), so lane l always reads bank l
//     and a warp's lookup is one wavefront. A lookup's address is
//     ((c << 7) & 0x7F80) | 4 lane: one shift and one LOP3.
//   - the thread's span (16, 32 or 64 bytes, a template parameter) is
//     loaded whole, as 16-byte vectors, before the table copy, so the
//     loads land under it.
//   - occupancy: 32 KiB table + 33 B + 1 KiB the SM reserves per block =
//     33.04 KiB; 6 blocks = 198 KiB of the SM's 228 KiB (carveout set to
//     the maximum), 6 x 256 = 1536 of 2048 threads, and
//     __launch_bounds__(256, 6) holds a thread to 40 registers
//     (65536 / 1536 = 42). So CRC_BLOCKS_PER_SM = 6.
//   - geometry, chosen on the host (crc_kernel.geometry) from rows and
//     n32: a span counts only if it gives fewer blocks than the next
//     smaller one; of those whose grid reaches every SM, the one with
//     the least waves (of 6 x SMs blocks) x (span + 64 byte steps). On
//     132 SMs with 1 MiB rows: [1, n] 16 B (256 blocks), [4, n] 32 B
//     (512), [14, n] 64 B (896), [224, n] 64 B (14336).
//   - combine: the pieces combine by crc(A||B) = Z_|B|(crc(A)) ^ crc(B),
//     Z_n the transit of n zero bytes, a 32-column GF(2) operator built
//     on the host for the span. Each lane shifts its CRC by its distance
//     to the end of its warp's span (its own operator: the 32 lanes read
//     32 columns, 32 L1 wavefronts a warp, 3 integer instructions a
//     column), the warp XORs with shuffles, and warp 0 does the same
//     over the 8 warp CRCs. A shuffle tree with its operators in the
//     constant bank would read no memory, but each lane would apply five
//     operators instead of one (~400 more integer instructions a
//     thread, against ~130 for the 32 loads and their masks): the
//     lane/warp operator form costs fewer issue slots, which are what
//     binds, so it is kept.
//   - one launch a call: the block stores its chunk CRC and takes a
//     ticket on its row's counter. The row's last block combines the
//     row's chunk CRCs (front-padded with zero chunks to 256 runs of
//     `run` chunks, each run folded serially by one thread), XORs in the
//     length's final constant and sets the counter back to 0, so the
//     counters need no memset. A row of one chunk skips the tickets. The
//     counters belong to one stream (crc_kernel keeps one zeroed buffer
//     per device and stream), so launches on two streams never share
//     one; launches on one stream run in order.
//   - a fault mid-launch (a bad address) is sticky: the CUDA context is
//     lost, the counters with it. A launch the runtime refuses never ran
//     and leaves them at 0.

#include <cuda_runtime.h>
#include <stdint.h>

#define CRC_THREADS 256
#define CRC_WARPS (CRC_THREADS / 32)
#define CRC_BLOCKS_PER_SM 6

// zcols layout (device, uint32), as crc_kernel.kernel_zcols(span, run)
// builds it for a span of S bytes (chunk C = 256 S). An operator family
// [32][m] holds column b of operator j at b*m + j.
//   ZC_LANE [32][32] Z_{S * (31 - l)}             lane l within a warp
//   ZC_WARP [32][8]  Z_{32 S * (7 - w)}           warp w within a chunk
//   ZC_RUN  [32]     Z_{C}                        one step of a run
//   ZC_RLANE[32][32] Z_{C * run * (31 - l)}       lane l of the row fold
//   ZC_RWARP[32][8]  Z_{C * run * 32 * (7 - w)}   warp w of the row fold
#define ZC_LANE 0
#define ZC_WARP (ZC_LANE + 32 * 32)
#define ZC_RUN (ZC_WARP + 32 * CRC_WARPS)
#define ZC_RLANE (ZC_RUN + 32)
#define ZC_RWARP (ZC_RLANE + 32 * 32)

// Operator j of the family at `ops` (m operators) applied to x: the
// XOR of the columns x's set bits select. Bit b reaches bit 31 of u
// after b shifts, and an arithmetic shift makes it a mask: 3 integer
// instructions a column.
__device__ __forceinline__ uint32_t gf2_apply(const uint32_t* __restrict__ ops,
                                              int m, int j, uint32_t x) {
    uint32_t r = 0, u = __brev(x);
#pragma unroll
    for (int b = 0; b < 32; b++) {
        r ^= __ldg(ops + b * m + j) & (uint32_t)((int32_t)u >> 31);
        u <<= 1;
    }
    return r;
}

__device__ __forceinline__ uint32_t warp_xor(uint32_t x) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) x ^= __shfl_xor_sync(0xFFFFFFFFu, x, s);
    return x;
}

// The CRC of the block's 256 consecutive pieces (piece t from thread t)
// from their CRCs; lane and warp operator families as in the layout.
// Every thread calls it; the result is valid in thread 0.
__device__ __forceinline__ uint32_t block_combine(uint32_t c, const uint32_t* lane_ops,
                                                  const uint32_t* warp_ops,
                                                  uint32_t* wpart, int t) {
    const int lane = t & 31, w = t >> 5;
    c = warp_xor(gf2_apply(lane_ops, 32, lane, c));
    if (lane == 0) wpart[w] = c;
    __syncthreads();
    c = 0;
    if (w == 0) {
        if (lane < CRC_WARPS) c = gf2_apply(warp_ops, CRC_WARPS, lane, wpart[lane]);
        c = warp_xor(c);
    }
    return c;
}

// Four real words from virtual index v (real index v - pad, which is
// negative inside the front padding: zeros). VEC: 16-byte aligned and
// pad a multiple of 4, so a vector is all padding or all data.
template <bool VEC>
__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ src, long long r) {
    if (VEC)
        return r >= 0 ? __ldg(reinterpret_cast<const uint4*>(src + r))
                      : make_uint4(0u, 0u, 0u, 0u);
    uint4 v;
    v.x = r >= 0 ? __ldg(src + r) : 0u;
    v.y = r + 1 >= 0 ? __ldg(src + r + 1) : 0u;
    v.z = r + 2 >= 0 ? __ldg(src + r + 2) : 0u;
    v.w = r + 3 >= 0 ? __ldg(src + r + 3) : 0u;
    return v;
}

// Sarwate's step for each byte of w, low byte first. `tab` is the table
// copies as bytes, lane4 = 4 * lane: entry b of this lane's copy is at
// byte b * 128 + lane4, so the address is one shift and one LOP3.
__device__ __forceinline__ uint32_t crc_word(const char* tab, uint32_t lane4, uint32_t c,
                                             uint32_t w) {
    c ^= w;
#pragma unroll
    for (int i = 0; i < 4; i++)
        c = *reinterpret_cast<const uint32_t*>(tab + (((c << 7) & 0x7F80u) | lane4)) ^ (c >> 8);
    return c;
}

__device__ __forceinline__ uint32_t crc_vec(const char* tab, uint32_t lane4, uint32_t c,
                                            uint4 v) {
    c = crc_word(tab, lane4, c, v.x);
    c = crc_word(tab, lane4, c, v.y);
    c = crc_word(tab, lane4, c, v.z);
    return crc_word(tab, lane4, c, v.w);
}

// SW: words a thread (its span), 4, 8 or 16.
template <int SW, bool VEC>
__global__ void __launch_bounds__(CRC_THREADS, CRC_BLOCKS_PER_SM) crc_rows_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ partial,
    unsigned int* __restrict__ tickets, uint32_t* __restrict__ out,
    const uint4* __restrict__ table4, const uint32_t* __restrict__ zcols,
    long long n32, long long pad, long long nchunks, long long run, long long lead,
    uint32_t final_const) {
    __shared__ __align__(16) uint32_t tab[256 * 32];
    __shared__ uint32_t wpart[CRC_WARPS];
    __shared__ bool last;
    const int t = threadIdx.x;
    const long long chunk = blockIdx.x;
    const long long row = blockIdx.y;
    const uint32_t* src = in + row * n32;
    // this thread's span, loaded before the table copy: real words from
    // r0 (negative inside the front padding)
    const long long r0 = (chunk * CRC_THREADS + t) * SW - pad;
    uint4 v[SW / 4];
#pragma unroll
    for (int i = 0; i < SW / 4; i++) v[i] = load4<VEC>(src, r0 + 4 * i);
    // 16-byte slot q of the copies holds entry q / 8 for lanes 4 (q % 8)..+3,
    // and table4[e] is entry e four times
#pragma unroll
    for (int i = 0; i < 8; i++) {
        const int q = t + CRC_THREADS * i;
        reinterpret_cast<uint4*>(tab)[q] = __ldg(table4 + (q >> 3));
    }
    __syncthreads();

    const char* tb = reinterpret_cast<const char*>(tab);
    const uint32_t lane4 = 4u * (t & 31);
    uint32_t c = 0;
#pragma unroll
    for (int i = 0; i < SW / 4; i++) c = crc_vec(tb, lane4, c, v[i]);
    c = block_combine(c, zcols + ZC_LANE, zcols + ZC_WARP, wpart, t);
    if (nchunks == 1) {  // the chunk is the row
        if (t == 0) out[row] = c ^ final_const;
        return;
    }

    uint32_t* row_part = partial + row * nchunks;
    if (t == 0) {
        row_part[chunk] = c;
        __threadfence();  // the chunk CRC is visible before the ticket
        last = atomicAdd(tickets + row, 1u) == (unsigned int)(nchunks - 1);
    }
    __syncthreads();
    if (!last) return;

    // The row's last block: combine its chunk CRCs. The leaves are `lead`
    // zero chunks, then the nchunks chunk CRCs: CRC_THREADS * run in all,
    // run consecutive ones a thread.
    __threadfence();
    const long long v0 = (long long)t * run - lead;
    c = v0 >= 0 ? __ldcg(row_part + v0) : 0u;
    for (long long i = 1; i < run; i++)
        c = gf2_apply(zcols + ZC_RUN, 1, 0, c) ^ (v0 + i >= 0 ? __ldcg(row_part + v0 + i) : 0u);
    c = block_combine(c, zcols + ZC_RLANE, zcols + ZC_RWARP, wpart, t);
    if (t == 0) {
        out[row] = c ^ final_const;
        tickets[row] = 0u;  // every other block of the row has taken its ticket
    }
}

template <int SW, bool VEC>
static void launch(dim3 grid, cudaStream_t s, const uint32_t* in, uint32_t* part,
                   unsigned int* tk, uint32_t* out, const uint4* tb, const uint32_t* z,
                   long long n32, long long pad, long long nchunks, long long run,
                   long long lead, uint32_t final_const) {
    crc_rows_kernel<SW, VEC><<<grid, CRC_THREADS, 0, s>>>(in, part, tk, out, tb, z, n32, pad,
                                                         nchunks, run, lead, final_const);
}

template <bool VEC>
static void launch_span(int sw, dim3 grid, cudaStream_t s, const uint32_t* in,
                        uint32_t* part, unsigned int* tk, uint32_t* out, const uint4* tb,
                        const uint32_t* z, long long n32, long long pad, long long nchunks,
                        long long run, long long lead, uint32_t final_const) {
    if (sw == 4)
        launch<4, VEC>(grid, s, in, part, tk, out, tb, z, n32, pad, nchunks, run, lead,
                       final_const);
    else if (sw == 8)
        launch<8, VEC>(grid, s, in, part, tk, out, tb, z, n32, pad, nchunks, run, lead,
                       final_const);
    else
        launch<16, VEC>(grid, s, in, part, tk, out, tb, z, n32, pad, nchunks, run, lead,
                        final_const);
}

template <int SW>
static cudaError_t carve() {
    cudaError_t err = cudaFuncSetAttribute(crc_rows_kernel<SW, true>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(crc_rows_kernel<SW, false>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
}

static cudaError_t set_carveout() {
    cudaError_t err = carve<4>();
    if (err == cudaSuccess) err = carve<8>();
    if (err == cudaSuccess) err = carve<16>();
    return err;
}

// in: [rows, n32] uint32 (device, rows contiguous); out: [rows] uint32;
// partial: [rows * nchunks] uint32 scratch for the chunk CRCs, with
// nchunks = ceil(n32 / (256 * span)); tickets: [rows] counters, zero
// before the launch and zero after it; table4: the 256-entry CRC-32C
// byte table, each entry four times (16-byte aligned); zcols:
// crc_kernel.kernel_zcols(4 * span, run) (device). span: words a
// thread, 4, 8 or 16; run: the least power of two with 256 * run >=
// nchunks (crc_kernel.geometry gives both). final_const = 0 gives the
// raw CRC. Returns a cudaError_t.
extern "C" int crc32c_rows_u32(const void* in, void* out, void* partial, void* tickets,
                               const void* table4, const void* zcols, long long rows,
                               long long n32, int span, long long run,
                               unsigned int final_const, void* stream) {
    if (rows < 1 || rows > 65535 || n32 < 1 || (span != 4 && span != 8 && span != 16) ||
        (reinterpret_cast<uintptr_t>(table4) & 15u))
        return (int)cudaErrorInvalidValue;
    const long long chunk_words = (long long)CRC_THREADS * span;
    const long long nchunks = (n32 + chunk_words - 1) / chunk_words;
    if (nchunks > 0x7FFFFFFFLL || run < 1 || (run & (run - 1)) ||
        CRC_THREADS * run < nchunks || (run > 1 && CRC_THREADS * run / 2 >= nchunks))
        return (int)cudaErrorInvalidValue;
    static const cudaError_t carveout = set_carveout();
    if (carveout != cudaSuccess) return (int)carveout;
    const long long pad = nchunks * chunk_words - n32;
    const long long lead = CRC_THREADS * run - nchunks;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid((unsigned)nchunks, (unsigned)rows);
    const uint32_t* src = static_cast<const uint32_t*>(in);
    uint32_t* part = static_cast<uint32_t*>(partial);
    unsigned int* tk = static_cast<unsigned int*>(tickets);
    uint32_t* o = static_cast<uint32_t*>(out);
    const uint4* tb = static_cast<const uint4*>(table4);
    const uint32_t* z = static_cast<const uint32_t*>(zcols);
    if ((n32 % 4 == 0) && ((reinterpret_cast<uintptr_t>(in) & 15u) == 0))
        launch_span<true>(span, grid, s, src, part, tk, o, tb, z, n32, pad, nchunks, run,
                          lead, final_const);
    else
        launch_span<false>(span, grid, s, src, part, tk, o, tb, z, n32, pad, nchunks, run,
                           lead, final_const);
    return (int)cudaGetLastError();
}
