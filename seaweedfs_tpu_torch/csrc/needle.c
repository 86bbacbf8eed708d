/* One-call needle record serialization: header + body + CRC + padding.
 *
 * Role match: the reference's prepareWriteBuffer
 * (weed/storage/needle/needle_read_write.go:31-120) builds the full
 * on-disk record in one buffer pass in Go; the Python to_bytes mirrors
 * it field-by-field but pays interpreter cost per field on the hottest
 * write path.  This shim does the same single pass in C, including the
 * Castagnoli checksum (shared implementation: crc32c.c is #included so
 * one dlopen carries both entry points).
 *
 * Layout written (big-endian, v2/v3 — needle.py module docstring):
 *   cookie u32 | id u64 | size u32
 *   [data_size u32 | data | flags u8 | optional fields...]   when data
 *   checksum u32 (masked)
 *   [append_at_ns u64]                                        v3
 *   padding 1..8 bytes to 8B alignment (reference quirk: never 0)
 */

#include <time.h>

#include "crc32c.c"

#define V3_TIMESTAMP 8
#define HEADER 16
#define CHECKSUM 4
#define PAD 8

/* Monotonic seconds for the tracing plane's stage timings. One
 * clock_gettime is ~20 ns — cheap enough to leave on unconditionally
 * in the hot loop (docs/TRACING.md budgets the whole span at <2%). */
static inline double w_monotonic(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

static inline void put_u32(uint8_t *p, uint32_t v) {
    p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}
static inline void put_u64(uint8_t *p, uint64_t v) {
    p[0] = v >> 56; p[1] = v >> 48; p[2] = v >> 40; p[3] = v >> 32;
    p[4] = v >> 24; p[5] = v >> 16; p[6] = v >> 8; p[7] = v;
}

/* CRC2.0 mask (crc.go value()): tells recovered-from-disk checksums
 * apart from in-memory ones. */
static inline uint32_t masked(uint32_t crc) {
    return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

/* Worst-case record length for buffer sizing (name/mime capped at 255,
 * pairs < 64KiB enforced by the Python caller). name_len/mime_len stay
 * in the signature for call-site symmetry with weed_needle_encode, but
 * the bound uses their 255-byte caps, not the actual lengths. */
long weed_needle_max_size(uint32_t data_len, uint32_t name_len,
                          uint32_t mime_len, uint32_t pairs_len) {
    (void)name_len;
    (void)mime_len;
    return (long)HEADER + 4 + (long)data_len + 1 + 1 + 255 + 1 + 255 + 5 + 2 +
           2 + (long)pairs_len + CHECKSUM + V3_TIMESTAMP + PAD;
}

/* Serialize one record into out; returns total length (>0) or -1 on a
 * constraint violation.  size_out gets the stored `size` field,
 * crc_out the RAW (unmasked) CRC32-C of data.  crc_seconds (nullable)
 * receives the CRC pass's wall seconds so the tracing plane can report
 * the crc stage separately from record assembly. */
long weed_needle_encode(uint8_t *out, uint32_t cookie, uint64_t id,
                        const uint8_t *data, uint32_t data_len, uint32_t flags,
                        const uint8_t *name, uint32_t name_len,
                        const uint8_t *mime, uint32_t mime_len,
                        uint64_t last_modified, const uint8_t *ttl2,
                        const uint8_t *pairs, uint32_t pairs_len, int version,
                        uint64_t append_at_ns, uint32_t *size_out,
                        uint32_t *crc_out, double *crc_seconds) {
    if (mime_len > 255 || pairs_len > 65535 || (version != 1 && version != 2 && version != 3))
        return -1;
    if (name_len > 255) name_len = 255; /* NameSize u8 cap, as to_bytes */

    double tcrc = w_monotonic();
    uint32_t crc = weed_crc32c(0, data, data_len);
    if (crc_seconds) *crc_seconds = w_monotonic() - tcrc;
    *crc_out = crc;
    uint8_t *p = out + HEADER;
    uint32_t size;

    if (version == 1) {
        size = data_len;
        __builtin_memcpy(p, data, data_len);
        p += data_len;
    } else if (data_len > 0) {
        put_u32(p, data_len);
        p += 4;
        __builtin_memcpy(p, data, data_len);
        p += data_len;
        *p++ = (uint8_t)(flags & 0xFF);
        if (flags & 0x02) { /* FLAG_HAS_NAME */
            *p++ = (uint8_t)name_len;
            __builtin_memcpy(p, name, name_len);
            p += name_len;
        }
        if (flags & 0x04) { /* FLAG_HAS_MIME */
            *p++ = (uint8_t)mime_len;
            __builtin_memcpy(p, mime, mime_len);
            p += mime_len;
        }
        if (flags & 0x08) { /* FLAG_HAS_LAST_MODIFIED_DATE: low 5 bytes BE */
            *p++ = (uint8_t)(last_modified >> 32);
            *p++ = (uint8_t)(last_modified >> 24);
            *p++ = (uint8_t)(last_modified >> 16);
            *p++ = (uint8_t)(last_modified >> 8);
            *p++ = (uint8_t)last_modified;
        }
        if (flags & 0x10) { /* FLAG_HAS_TTL */
            *p++ = ttl2 ? ttl2[0] : 0;
            *p++ = ttl2 ? ttl2[1] : 0;
        }
        if (flags & 0x20) { /* FLAG_HAS_PAIRS */
            *p++ = (uint8_t)(pairs_len >> 8);
            *p++ = (uint8_t)pairs_len;
            __builtin_memcpy(p, pairs, pairs_len);
            p += pairs_len;
        }
        size = (uint32_t)(p - out - HEADER);
    } else {
        size = 0; /* empty body: tombstones / deletes */
    }

    put_u32(out, cookie);
    put_u64(out + 4, id);
    put_u32(out + 12, size);

    put_u32(p, masked(crc));
    p += 4;
    if (version == 3) {
        put_u64(p, append_at_ns);
        p += 8;
    }
    /* padding: ALWAYS 1..8 (needle_read_write.go:287 quirk) */
    long unpadded = (long)(p - out);
    long pad = PAD - (unpadded % PAD);
    for (long i = 0; i < pad; i++) *p++ = 0;

    *size_out = size;
    return (long)(p - out);
}
