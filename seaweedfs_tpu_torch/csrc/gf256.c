/* SIMD GF(2^8) coefficient-matrix apply: the RS codec's CPU hot path.
 *
 * Role match: the reference's EC hot loop is klauspost/reedsolomon's
 * vendored AVX2 assembly (the enc.Encode call at
 * weed/storage/erasure_coding/ec_encoder.go:173). This is the same
 * component as a small C library: out[r] = XOR_c gfmul(M[r][c], in[c])
 * over the 0x11D field (generator 2, matching ec/gf256.py).
 *
 * Four paths, chosen once at load time:
 *   - GFNI+AVX512: GF2P8AFFINEQB, 64 bytes/instruction. Multiplication
 *     by a constant c is GF(2)-linear — an 8x8 bit-matrix (the same
 *     B(c) the TPU bitsliced kernel uses, codec_tpu.py) — and the
 *     affine instruction applies an arbitrary bit-matrix per byte, so
 *     it handles our 0x11D field even though the ISA's fixed-poly
 *     GF2P8MULB (0x11B) would not. Matrix packing is verified against
 *     gf_mul at load; on mismatch the path disables itself.
 *   - AVX2:  PSHUFB low/high-nibble product tables, 32 bytes/step
 *   - SSSE3: same scheme at 16 bytes/step
 *   - portable: per-coefficient 256-entry product table, 1 byte/step
 *
 * The nibble-table trick: gfmul(c, x) for a byte x = lo^hi where
 * lo = gfmul(c, x & 0xF) and hi = gfmul(c, x & 0xF0); each half has
 * only 16 possible values, so both fit in one 16-lane shuffle register
 * and one PSHUFB computes 16 (AVX2: 32) products at once.
 *
 * Work is blocked over the stream so the k input rows and r output
 * rows of one block stay L2-resident across the r*k coefficient passes.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#if defined(__x86_64__)
#include <cpuid.h>
#include <immintrin.h>
#define HAVE_X86 1
#endif

static uint8_t gf_exp[512];
static uint8_t gf_log[256];
static int have_avx2 = 0;
static int have_ssse3 = 0;
static int have_gfni512 = 0;

#ifdef HAVE_X86
static int gfni_selftest(void);
#endif

/* constructor: runs once at dlopen, before any caller thread exists */
__attribute__((constructor)) static void gf_init(void) {
    int x = 1;
    for (int i = 0; i < 255; i++) {
        gf_exp[i] = (uint8_t)x;
        gf_log[x] = (uint8_t)i;
        x <<= 1;
        if (x & 0x100) x ^= 0x11D;
    }
    for (int i = 255; i < 512; i++) gf_exp[i] = gf_exp[i - 255];
#ifdef HAVE_X86
    {
        unsigned int a, b, c, d;
        int f512 = 0, bw = 0, gfni = 0, osxsave = 0;
        uint64_t xcr0 = 0;
        if (__get_cpuid(1, &a, &b, &c, &d)) {
            have_ssse3 = (c >> 9) & 1;
            osxsave = (c >> 27) & 1;
        }
        if (__get_cpuid_count(7, 0, &a, &b, &c, &d)) {
            have_avx2 = (b >> 5) & 1;
            f512 = (b >> 16) & 1;
            bw = (b >> 30) & 1;
            gfni = (c >> 8) & 1;
        }
        /* CPUID feature bits alone don't mean the OS saves the wide
         * registers: confirm via XCR0 (xgetbv) that YMM (bits 1-2) and,
         * for the 512-bit path, opmask+ZMM (bits 5-7) state is enabled —
         * else an EVEX/VEX instruction in the constructor is a SIGILL
         * that no ImportError fallback can catch. */
        if (osxsave) {
            unsigned int lo, hi;
            __asm__ volatile("xgetbv" : "=a"(lo), "=d"(hi) : "c"(0));
            xcr0 = ((uint64_t)hi << 32) | lo;
        }
        if ((xcr0 & 0x6) != 0x6) have_avx2 = 0;
        have_gfni512 =
            f512 && bw && gfni && (xcr0 & 0xE6) == 0xE6;
        if (have_gfni512 && !gfni_selftest()) have_gfni512 = 0;
    }
#endif
}

static inline uint8_t gf_mul(uint8_t a, uint8_t b) {
    if (!a || !b) return 0;
    return gf_exp[(int)gf_log[a] + (int)gf_log[b]];
}

/* 16-entry product tables for one coefficient: lo[x]=c·x, hi[x]=c·(x<<4) */
static void nibble_tables(uint8_t c, uint8_t lo[16], uint8_t hi[16]) {
    for (int x = 0; x < 16; x++) {
        lo[x] = gf_mul(c, (uint8_t)x);
        hi[x] = gf_mul(c, (uint8_t)(x << 4));
    }
}

static void row_scalar(uint8_t *out, const uint8_t *in, size_t n, uint8_t c) {
    uint8_t tbl[256];
    for (int x = 0; x < 256; x++) tbl[x] = gf_mul(c, (uint8_t)x);
    for (size_t i = 0; i < n; i++) out[i] ^= tbl[in[i]];
}

#ifdef HAVE_X86
__attribute__((target("ssse3"))) static void row_ssse3(uint8_t *out,
                                                      const uint8_t *in,
                                                      size_t n,
                                                      const uint8_t lo[16],
                                                      const uint8_t hi[16]) {
    __m128i vlo = _mm_loadu_si128((const __m128i *)lo);
    __m128i vhi = _mm_loadu_si128((const __m128i *)hi);
    __m128i mask = _mm_set1_epi8(0x0F);
    size_t i = 0;
    for (; i + 16 <= n; i += 16) {
        __m128i v = _mm_loadu_si128((const __m128i *)(in + i));
        __m128i l = _mm_and_si128(v, mask);
        __m128i h = _mm_and_si128(_mm_srli_epi64(v, 4), mask);
        __m128i p = _mm_xor_si128(_mm_shuffle_epi8(vlo, l),
                                  _mm_shuffle_epi8(vhi, h));
        __m128i o = _mm_loadu_si128((const __m128i *)(out + i));
        _mm_storeu_si128((__m128i *)(out + i), _mm_xor_si128(o, p));
    }
    for (; i < n; i++) out[i] ^= lo[in[i] & 0xF] ^ hi[in[i] >> 4];
}

__attribute__((target("avx2"))) static void row_avx2(uint8_t *out,
                                                    const uint8_t *in,
                                                    size_t n,
                                                    const uint8_t lo[16],
                                                    const uint8_t hi[16]) {
    __m256i vlo =
        _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i *)lo));
    __m256i vhi =
        _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i *)hi));
    __m256i mask = _mm256_set1_epi8(0x0F);
    size_t i = 0;
    for (; i + 32 <= n; i += 32) {
        __m256i v = _mm256_loadu_si256((const __m256i *)(in + i));
        __m256i l = _mm256_and_si256(v, mask);
        __m256i h = _mm256_and_si256(_mm256_srli_epi64(v, 4), mask);
        __m256i p = _mm256_xor_si256(_mm256_shuffle_epi8(vlo, l),
                                     _mm256_shuffle_epi8(vhi, h));
        __m256i o = _mm256_loadu_si256((const __m256i *)(out + i));
        _mm256_storeu_si256((__m256i *)(out + i), _mm256_xor_si256(o, p));
    }
    for (; i < n; i++) out[i] ^= lo[in[i] & 0xF] ^ hi[in[i] >> 4];
}
#endif

#ifdef HAVE_X86
/* Pack the multiply-by-c bit-matrix for GF2P8AFFINEQB: output bit i is
 * parity(matrix byte (7-i) & x), so qword byte (7-i) holds row i,
 * whose bit j is bit i of c·2^j. Verified against gf_mul at load. */
static uint64_t affine_matrix(uint8_t c) {
    uint64_t m = 0;
    for (int i = 0; i < 8; i++) {
        uint8_t row = 0;
        for (int j = 0; j < 8; j++)
            row |= (uint8_t)(((gf_mul(c, (uint8_t)(1 << j)) >> i) & 1) << j);
        m |= (uint64_t)row << (8 * (7 - i));
    }
    return m;
}

__attribute__((target("gfni,avx512f,avx512bw"))) static void row_gfni(
    uint8_t *out, const uint8_t *in, size_t n, uint64_t mat,
    const uint8_t lo[16], const uint8_t hi[16]) {
    __m512i A = _mm512_set1_epi64((long long)mat);
    size_t i = 0;
    for (; i + 64 <= n; i += 64) {
        __m512i v = _mm512_loadu_si512((const void *)(in + i));
        __m512i p = _mm512_gf2p8affine_epi64_epi8(v, A, 0);
        __m512i o = _mm512_loadu_si512((const void *)(out + i));
        _mm512_storeu_si512((void *)(out + i), _mm512_xor_si512(o, p));
    }
    for (; i < n; i++) out[i] ^= lo[in[i] & 0xF] ^ hi[in[i] >> 4];
}

__attribute__((target("gfni,avx512f,avx512bw"))) static int gfni_selftest(void) {
    uint8_t in[64], out[64], lo[16], hi[16];
    const uint8_t cs[3] = {0x02, 0x57, 0xE3};
    for (int t = 0; t < 3; t++) {
        for (int i = 0; i < 64; i++) {
            in[i] = (uint8_t)(i * 5 + t);
            out[i] = 0;
        }
        nibble_tables(cs[t], lo, hi);
        row_gfni(out, in, 64, affine_matrix(cs[t]), lo, hi);
        for (int i = 0; i < 64; i++)
            if (out[i] != gf_mul(cs[t], in[i])) return 0;
    }
    return 1;
}
#endif

static void row_mul_xor(uint8_t *out, const uint8_t *in, size_t n, uint8_t c) {
    uint8_t lo[16], hi[16];
#ifdef HAVE_X86
    if (have_gfni512 || have_avx2 || have_ssse3) {
        nibble_tables(c, lo, hi);
        if (have_gfni512)
            row_gfni(out, in, n, affine_matrix(c), lo, hi);
        else if (have_avx2)
            row_avx2(out, in, n, lo, hi);
        else
            row_ssse3(out, in, n, lo, hi);
        return;
    }
#endif
    (void)lo;
    (void)hi;
    row_scalar(out, in, n, c);
}

/* active SIMD tier, for diagnostics: 3=gfni512, 2=avx2, 1=ssse3, 0=scalar */
int32_t weed_gf_caps(void) {
    if (have_gfni512) return 3;
    if (have_avx2) return 2;
    if (have_ssse3) return 1;
    return 0;
}

/* out[r][i] = XOR_c gfmul(matrix[r*k+c], in[c][i]); outputs are
 * overwritten (zeroed first). Rows must not alias. */
void weed_gf_apply(const uint8_t *matrix, int32_t r, int32_t k,
                   const uint8_t *const *inputs, uint8_t *const *outputs,
                   size_t n) {
/* 256 KiB: inputs+outputs of one block span ~3.5 MiB — L2/L3-resident
 * on anything modern, long enough for the prefetcher to stream.
 * Swept 64K/256K/1M/8M on the dev Xeon: 256K best (steady-state). */
#ifndef WEED_GF_BLK
#define WEED_GF_BLK (256 * 1024)
#endif
    const size_t BLK = WEED_GF_BLK;
    for (int32_t ri = 0; ri < r; ri++) memset(outputs[ri], 0, n);
    for (size_t off = 0; off < n; off += BLK) {
        size_t len = n - off < BLK ? n - off : BLK;
        for (int32_t ri = 0; ri < r; ri++) {
            uint8_t *out = outputs[ri] + off;
            for (int32_t ci = 0; ci < k; ci++) {
                uint8_t c = matrix[(size_t)ri * (size_t)k + (size_t)ci];
                if (c) row_mul_xor(out, inputs[ci] + off, len, c);
            }
        }
    }
}
