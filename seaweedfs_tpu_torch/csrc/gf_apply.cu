// K1 and K2: GF(2^8) matrix apply over u32 lanes, for NVIDIA Hopper
// (sm_90a).
//
// K1 replaces seaweedfs_tpu/ec/codec_tpu.py swar_apply_u32 (the Pallas
// SWAR Horner kernel built by _make_swar_kernel/_swar_row); K2 replaces
// swar_apply_u32_batch, the same kernel over a batch of volumes (grid =
// volumes x stream tiles), the per-device program of the batch arm.
//
// Computes out[b][p] = XOR_c M[p,c] * x[b][c] in GF(2^8), x [B, k, n32]
// and out [B, rows, n32] uint32, with the SWAR Horner chain of
// gf_swar.cuh. K1 is the B = 1 case of the same kernel.
//
// Bound: memory, B * (k + rows) * 4 * n32 bytes at 3.35 TB/s. A matrix
// given at launch still costs, per lane and output row, k LOP3s a Horner
// step and a doubling (3 ALU-pipe, 2 FMA-pipe instructions) between
// steps: ~100 ALU-pipe instructions a lane and row for RS(10,4), which
// holds K2 near 57% of the byte bound on the integer ALU pipe (PERF.md).
// gf_swar.cuh keeps that count at its floor (exact width, branch-free
// terms, Horner start at maxj).
// Design: one launch covers the whole batch (blockIdx.y is the volume),
// so a round of the batch arm costs one launch per device, not one per
// volume. Rows of a volume are n32 lanes apart; volumes are
// `in_vstride` / `out_vstride` lanes apart, so K2 can read the data rows
// of a [B, k + p, n32] tile and write its parity rows in place. Each
// thread loads one vector of GF_LANES lanes per input row with coalesced
// loads, keeps all k vectors in registers, runs every output row's chain
// and stores one vector per output row. A scalar variant serves rows
// whose length, stride or base address does not allow vectors.

#include "gf_swar.cuh"

template <int K, bool VEC>
__global__ void __launch_bounds__(GF_THREADS) gf_apply_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
    long long n32, long long batch, long long in_vstride,
    long long out_vstride, const __grid_constant__ GfTerms<K> m) {
    const long long base =
        (long long)GF_LANES * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
    if (base >= n32) return;
    for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
        uint32_t x[K][GF_LANES];
        gf_load_cols<K, VEC>(in + b * in_vstride, base, n32, x);
        uint32_t* ovol = out + b * out_vstride;
#pragma unroll 1
        for (int p = 0; p < m.rows; p++) {
            uint32_t y[GF_LANES];
            gf_row<K>(x, m.w[p], m.maxj[p], y);
            gf_store<VEC>(ovol + (long long)p * n32, base, n32, y);
        }
    }
}

static int gf_launch(const void* in, void* out, long long batch, long long k,
                     long long rows, long long n32, long long in_vstride,
                     long long out_vstride, const void* words,
                     const void* maxj, void* stream) {
    if (batch < 1 || n32 < 1 || rows < 1 || rows > GF_MAX_ROWS)
        return (int)cudaErrorInvalidValue;
    const dim3 grid = gf_grid(n32, batch);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* src = static_cast<const uint32_t*>(in);
    uint32_t* dst = static_cast<uint32_t*>(out);
    const bool vec = gf_vec_ok(n32, in, in_vstride, out, out_vstride);
    return gf_with_k(k, [&](auto kc) {
        constexpr int K = decltype(kc)::value;
        GfTerms<K> m;
        gf_terms_from<K>(words, maxj, rows, &m);
        if (vec)
            gf_apply_kernel<K, true><<<grid, GF_THREADS, 0, s>>>(
                src, dst, n32, batch, in_vstride, out_vstride, m);
        else
            gf_apply_kernel<K, false><<<grid, GF_THREADS, 0, s>>>(
                src, dst, n32, batch, in_vstride, out_vstride, m);
        return (int)cudaGetLastError();
    });
}

// K1. in: [k, n32] uint32, out: [rows, n32] uint32, both device
// pointers, rows contiguous. words: host [rows, 8, k] uint32 (0 or ~0),
// maxj: host [rows] int32 (codec_cuda.gf_terms). Launches on `stream`;
// returns cudaGetLastError().
extern "C" int gf_apply_u32(const void* in, void* out, long long k,
                            long long rows, long long n32,
                            const void* words, const void* maxj,
                            void* stream) {
    return gf_launch(in, out, 1, k, rows, n32, 0, 0, words, maxj, stream);
}

// K2. in: [batch, k, n32] and out: [batch, rows, n32] uint32 device
// pointers; rows of a volume n32 lanes apart, volumes in_vstride /
// out_vstride lanes apart. Matrix arguments and return as K1's.
extern "C" int gf_apply_u32_batch(const void* in, void* out, long long batch,
                                  long long k, long long rows, long long n32,
                                  long long in_vstride, long long out_vstride,
                                  const void* words, const void* maxj,
                                  void* stream) {
    return gf_launch(in, out, batch, k, rows, n32, in_vstride, out_vstride,
                     words, maxj, stream);
}
