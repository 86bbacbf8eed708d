// K3: fused parity verify over u32 lanes, for NVIDIA Hopper (sm_90a).
//
// Replaces seaweedfs_tpu/ec/codec_tpu.py swar_verify_u32_batch (the
// Pallas kernel built by _make_swar_verify_kernel): recompute each
// volume's parity from its data rows and count, per volume, the
// (parity row, u32 lane) pairs where the recomputed word differs from
// the given one. The recomputed parity never reaches device memory.
//
// Inputs x [B, k, n32] and parity [B, rows, n32] uint32 (rows of a
// volume n32 lanes apart, volumes x_vstride / p_vstride lanes apart);
// output counts [B] int32.
//
// Bound: memory. B * (k + rows) * 4 * n32 bytes read once, 4 * B
// written, at 3.35 TB/s; the Horner chains are K1's (gf_swar.cuh,
// templated on k like K1's).
// Design: the TPU kernel carries a lanewise accumulator across its
// sequential grid and folds it at a volume's last tile. CUDA blocks run
// in no order, so here each thread counts its own mismatches, the warp
// sums them with __reduce_add_sync, warp 0 sums the block's warps from
// shared memory, and one thread adds the block's sum into counts[b] with
// an atomicAdd, skipped when it is 0 (the common case: verified parity
// costs no atomics). Integer atomics are exact, so the result does not
// depend on block order. The entry point zeroes counts with
// cudaMemsetAsync on the same stream before the launch. An int32 count
// is exact while rows * n32 < 2^31 per volume.

#include "gf_swar.cuh"

template <int K, bool VEC>
__global__ void __launch_bounds__(GF_THREADS) gf_verify_kernel(
    const uint32_t* __restrict__ x_in, const uint32_t* __restrict__ par,
    int* __restrict__ counts, long long n32, long long batch,
    long long x_vstride, long long p_vstride, const __grid_constant__ GfTerms<K> m) {
    __shared__ int warp_sums[GF_THREADS / 32];
    const long long base =
        (long long)GF_LANES * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // no early return: every thread of the block takes part in the sums
    for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
        int mism = 0;
        if (base < n32) {
            uint32_t x[K][GF_LANES];
            gf_load_cols<K, VEC>(x_in + b * x_vstride, base, n32, x);
            const uint32_t* pvol = par + b * p_vstride;
#pragma unroll 1
            for (int p = 0; p < m.rows; p++) {
                uint32_t y[GF_LANES], g[GF_LANES];
                gf_row<K>(x, m.w[p], m.maxj[p], y);
                gf_load<VEC>(pvol + (long long)p * n32, base, n32, g);
#pragma unroll
                for (int e = 0; e < GF_LANES; e++)
                    mism += (base + e < n32 && y[e] != g[e]) ? 1 : 0;
            }
        }
        mism = __reduce_add_sync(0xffffffffu, mism);
        if (lane == 0) warp_sums[warp] = mism;
        __syncthreads();
        if (warp == 0) {
            int s = lane < GF_THREADS / 32 ? warp_sums[lane] : 0;
            s = __reduce_add_sync(0xffffffffu, s);
            if (lane == 0 && s != 0) atomicAdd(counts + b, s);
        }
        __syncthreads();  // warp_sums is rewritten by the next volume
    }
}

// x: [batch, k, n32], parity: [batch, rows, n32] uint32 device pointers;
// counts: [batch] int32 device pointer, zeroed here. words: host
// [rows, 8, k] uint32 (0 or ~0), maxj: host [rows] int32
// (codec_cuda.gf_terms). Enqueues the memset and the launch on `stream`;
// returns the first CUDA error.
extern "C" int gf_verify_u32_batch(const void* x, const void* parity,
                                   void* counts, long long batch, long long k,
                                   long long rows, long long n32,
                                   long long x_vstride, long long p_vstride,
                                   const void* words, const void* maxj,
                                   void* stream) {
    if (batch < 1 || n32 < 1 || k < 1 || k > GF_MAX_K || rows < 1 ||
        rows > GF_MAX_ROWS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(counts, 0, (size_t)batch * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid = gf_grid(n32, batch);
    const uint32_t* xs = static_cast<const uint32_t*>(x);
    const uint32_t* ps = static_cast<const uint32_t*>(parity);
    int* cs = static_cast<int*>(counts);
    const bool vec = gf_vec_ok(n32, x, x_vstride, parity, p_vstride);
    return gf_with_k(k, [&](auto kc) {
        constexpr int K = decltype(kc)::value;
        GfTerms<K> m;
        gf_terms_from<K>(words, maxj, rows, &m);
        if (vec)
            gf_verify_kernel<K, true><<<grid, GF_THREADS, 0, s>>>(
                xs, ps, cs, n32, batch, x_vstride, p_vstride, m);
        else
            gf_verify_kernel<K, false><<<grid, GF_THREADS, 0, s>>>(
                xs, ps, cs, n32, batch, x_vstride, p_vstride, m);
        return (int)cudaGetLastError();
    });
}
