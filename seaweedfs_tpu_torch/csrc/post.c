/* One-pass volume POST hot loop: body → needle record → pwrite → reply.
 *
 * Role match: the reference's upload path is one Go pass —
 * needle.CreateNeedleFromRequest (needle.go:85 ParseUpload) feeding
 * prepareWriteBuffer (needle_read_write.go:31) — with no interpreter
 * between the socket buffer and the disk write. The Python port pays
 * ~87 us of volume-server CPU per write even after the round-4/5 fast
 * paths (OPERATIONS.md same-method A/B); this file is that whole span
 * as one C call: multipart/raw payload extraction, needle assembly
 * (via weed_needle_encode from needle.c), CRC32-C, pwrite at the
 * caller's append offset, and the 201 reply body formatting.
 *
 * Contract with the Python fallback (server/write_path.py
 * build_upload_needle + storage/volume.py write_needle): byte-identical
 * or DECLINE. Anything whose bytes depend on Python-only machinery —
 * transparent gzip compression, JPEG orientation fixing, base64/qp
 * transfer decoding, non-ASCII names (Python round-trips them
 * latin-1 → str → utf-8), overwrite/dedup of an existing id — returns
 * WEED_POST_DECLINE and the caller re-runs the pure-Python path on the
 * same buffer. The fallback also owns every error reply, so a declined
 * malformed body raises the exact MalformedUpload message it always
 * did. tests/test_native_post.py sweeps the identity.
 */

#include <errno.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#define WEED_POST_OK 0
#define WEED_POST_DECLINE (-1)
#define WEED_POST_IOERR (-2)

/* --- tiny byte-string helpers (no locale, no NUL assumptions) ------- */

static int w_lower(int c) { return (c >= 'A' && c <= 'Z') ? c + 32 : c; }

static int ci_prefix(const uint8_t *s, size_t n, const char *prefix) {
    size_t m = strlen(prefix);
    if (n < m) return 0;
    for (size_t i = 0; i < m; i++)
        if (w_lower(s[i]) != w_lower((uint8_t)prefix[i])) return 0;
    return 1;
}

static int ci_equals(const uint8_t *s, size_t n, const char *t) {
    return strlen(t) == n && ci_prefix(s, n, t);
}

static const uint8_t *w_memmem(const uint8_t *hay, size_t hn,
                               const uint8_t *needle, size_t nn) {
    if (nn == 0 || hn < nn) return NULL;
    const uint8_t *end = hay + hn - nn;
    for (const uint8_t *p = hay; p <= end; p++) {
        p = memchr(p, needle[0], (size_t)(end - p) + 1);
        if (p == NULL) return NULL;
        if (memcmp(p, needle, nn) == 0) return p;
    }
    return NULL;
}

static void w_strip(const uint8_t **s, size_t *n) {
    while (*n && (**s == ' ' || **s == '\t')) { (*s)++; (*n)--; }
    while (*n && ((*s)[*n - 1] == ' ' || (*s)[*n - 1] == '\t')) (*n)--;
}

/* Python's regex \s class over bytes: [ \t\n\r\f\v] — the boundary and
 * filename scans must terminate tokens on exactly this set or the C
 * and Python parsers frame different parts from the same body */
static int w_isspace(uint8_t c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
           c == '\v';
}

/* --- os.path.splitext + util/compression.is_gzippable ports --------- */

static void w_splitext(const uint8_t *name, size_t n, const uint8_t **ext,
                       size_t *ext_len) {
    *ext = NULL;
    *ext_len = 0;
    size_t base = 0;
    for (size_t i = 0; i < n; i++)
        if (name[i] == '/') base = i + 1;
    /* leading dots of the basename are not an extension (splitext) */
    size_t first = base;
    while (first < n && name[first] == '.') first++;
    for (size_t i = n; i > first; i--) {
        if (name[i - 1] == '.') {
            *ext = name + i - 1;
            *ext_len = n - (i - 1);
            return;
        }
    }
}

static const char *const GZ_ALWAYS[] = {
    ".svg", ".bmp", ".pdf", ".txt", ".html", ".htm", ".css", ".js",
    ".json", ".php", ".java", ".go", ".rb", ".c", ".cpp", ".h", ".hpp",
    NULL};
static const char *const GZ_NEVER[] = {
    ".zip", ".rar", ".gz", ".bz2", ".xz", ".png", ".jpg", ".jpeg", NULL};

static int ext_in(const uint8_t *ext, size_t n, const char *const *list) {
    for (int i = 0; list[i]; i++) {
        size_t m = strlen(list[i]);
        if (m != n) continue;
        int hit = 1;
        for (size_t j = 0; j < n; j++)
            if (w_lower(ext[j]) != (uint8_t)list[i][j]) { hit = 0; break; }
        if (hit) return 1;
    }
    return 0;
}

static int mime_suffix(const uint8_t *m, size_t n, const char *suf) {
    size_t s = strlen(suf);
    return n >= s && memcmp(m + n - s, suf, s) == 0;
}

/* CASE-SENSITIVE prefix: Python's str.startswith — the mime-type rules
 * in util/compression.py deliberately do not lower-case */
static int cs_prefix(const uint8_t *s, size_t n, const char *prefix) {
    size_t m = strlen(prefix);
    return n >= m && memcmp(s, prefix, m) == 0;
}

/* compression.is_gzippable: type rules first, mostly-text sniff as the
 * tiebreak — MUST match util/compression.py bit for bit, or the C and
 * Python paths store different (compressed vs raw) bytes. The mime
 * prefix/suffix compares are case-SENSITIVE, exactly like the Python
 * startswith/endswith they mirror (an 'Image/svg' body sniffs as text
 * there, so it must here too). */
static int w_is_gzippable(const uint8_t *ext, size_t ext_len,
                          const uint8_t *mime, size_t mime_len,
                          const uint8_t *data, size_t data_len) {
    if (cs_prefix(mime, mime_len, "text/")) return 1;
    if (ext_in(ext, ext_len, (const char *const[]){".svg", ".bmp", NULL}))
        return 1;
    if (cs_prefix(mime, mime_len, "image/")) return 0;
    if (ext_in(ext, ext_len, GZ_NEVER)) return 0;
    if (ext_in(ext, ext_len, GZ_ALWAYS)) return 1;
    if (cs_prefix(mime, mime_len, "application/")) {
        if (mime_suffix(mime, mime_len, "xml") ||
            mime_suffix(mime, mime_len, "json") ||
            mime_suffix(mime, mime_len, "script"))
            return 1;
    }
    /* _is_mostly_text: sample 1024, NUL disqualifies, non-text ratio */
    size_t sn = data_len < 1024 ? data_len : 1024;
    if (sn == 0) return 0;
    size_t non_text = 0;
    for (size_t i = 0; i < sn; i++) {
        uint8_t c = data[i];
        if (c == 0) return 0;
        if (!((c >= 32 && c <= 126) || c == '\t' || c == '\n' || c == '\r' ||
              c == '\f' || c == '\b' || c == 0x1b))
            non_text++;
    }
    return (double)non_text / (double)sn < 0.15;
}

/* --- multipart/form-data first-file-part scan ----------------------- */

typedef struct {
    const uint8_t *data;
    size_t data_len;
    const uint8_t *filename;
    size_t filename_len;
    const uint8_t *mime;
    size_t mime_len;
    int is_gzipped;
} weed_part;

/* boundary\s*=\s*("..."|token) out of the Content-Type value
 * (util/multipart._BOUNDARY_RE port). Returns 0 ok, -1 decline. */
static int parse_boundary(const uint8_t *ct, size_t n, const uint8_t **b,
                          size_t *bn) {
    for (size_t i = 0; i + 8 <= n; i++) {
        if (!ci_prefix(ct + i, n - i, "boundary")) continue;
        size_t j = i + 8;
        while (j < n && w_isspace(ct[j])) j++;
        if (j >= n || ct[j] != '=') continue;
        j++;
        while (j < n && w_isspace(ct[j])) j++;
        if (j < n && ct[j] == '"') {
            size_t k = j + 1;
            while (k < n && ct[k] != '"') k++;
            if (k >= n || k == j + 1) return -1; /* [^"]+ needs >=1 char */
            *b = ct + j + 1;
            *bn = k - (j + 1);
            return 0;
        }
        size_t k = j;
        while (k < n && ct[k] != ';' && ct[k] != ',' && !w_isspace(ct[k]))
            k++;
        if (k == j) return -1;
        *b = ct + j;
        *bn = k - j;
        return 0;
    }
    return -1;
}

/* util/multipart._find_delim over V (= CRLF + body, materialized by the
 * caller): next *valid* delimiter line at/after `start`.
 * Sets *line (match index), *after (just past boundary), *closing.
 * Returns 0 found, -1 not found. */
static int find_delim(const uint8_t *v, size_t vn, const uint8_t *delim,
                      size_t dn, size_t start, size_t *line, size_t *after,
                      int *closing) {
    size_t pos = start;
    while (pos + dn <= vn) {
        const uint8_t *hit = w_memmem(v + pos, vn - pos, delim, dn);
        if (hit == NULL) return -1;
        size_t idx = (size_t)(hit - v);
        size_t aft = idx + dn;
        int cl = (aft + 2 <= vn && v[aft] == '-' && v[aft + 1] == '-');
        size_t rest = cl ? aft + 2 : aft;
        /* transport padding (SP/HT) then CRLF or end-of-data only */
        size_t eol = rest;
        while (eol + 1 < vn && !(v[eol] == '\r' && v[eol + 1] == '\n')) eol++;
        size_t tail_end = (eol + 1 < vn) ? eol : vn;
        int ok = 1;
        for (size_t i = rest; i < tail_end; i++)
            if (v[i] != ' ' && v[i] != '\t') { ok = 0; break; }
        if (ok) {
            *line = idx;
            *after = aft;
            *closing = cl;
            return 0;
        }
        pos = idx + 1;
    }
    return -1;
}

/* First file part of a multipart body (util/multipart.parse_upload
 * port over V = CRLF+body). Returns WEED_POST_OK with *out filled, or
 * WEED_POST_DECLINE for anything the Python parser must rule on
 * (malformed framing, transfer encodings, escaped filenames). */
static int scan_multipart(const uint8_t *v, size_t vn, const uint8_t *boundary,
                          size_t bn, weed_part *out) {
    size_t dn = 4 + bn; /* "\r\n--" + boundary */
    uint8_t *delim = malloc(dn);
    if (delim == NULL) return WEED_POST_DECLINE;
    memcpy(delim, "\r\n--", 4);
    memcpy(delim + 4, boundary, bn);

    weed_part first;
    int have_first = 0;
    int rc = WEED_POST_DECLINE;
    size_t line, pos;
    int closing;
    if (find_delim(v, vn, delim, dn, 0, &line, &pos, &closing) != 0)
        goto done;
    while (!closing) {
        const uint8_t *eolp = w_memmem(v + pos, vn - pos, (const uint8_t *)"\r\n", 2);
        if (eolp == NULL) break;
        size_t eol = (size_t)(eolp - v);
        size_t nidx = vn, npos = (size_t)-1;
        int ncl = 0;
        if (find_delim(v, vn, delim, dn, eol, &nidx, &npos, &ncl) != 0) {
            nidx = vn;
            npos = (size_t)-1;
        }
        const uint8_t *part = v + eol + 2;
        size_t part_len = (nidx > eol + 2) ? nidx - (eol + 2) : 0;
        closing = ncl;
        int last = (npos == (size_t)-1);

        /* head/payload split on the first CRLFCRLF */
        const uint8_t *head = part;
        size_t head_len;
        const uint8_t *payload;
        size_t payload_len;
        const uint8_t *sep = w_memmem(part, part_len, (const uint8_t *)"\r\n\r\n", 4);
        if (sep != NULL) {
            head_len = (size_t)(sep - part);
            payload = sep + 4;
            payload_len = part_len - head_len - 4;
        } else if (part_len >= 2 && part[0] == '\r' && part[1] == '\n') {
            head_len = 0;
            payload = part + 2;
            payload_len = part_len - 2;
        } else {
            if (last) break;
            pos = npos;
            continue;
        }

        /* part headers: the four keys the Python parser rules on */
        const uint8_t *disp = NULL, *ptype = NULL, *penc = NULL, *pte = NULL;
        size_t disp_len = 0, ptype_len = 0, penc_len = 0, pte_len = 0;
        size_t hp = 0;
        while (hp < head_len) {
            const uint8_t *nl =
                w_memmem(head + hp, head_len - hp, (const uint8_t *)"\r\n", 2);
            size_t le = nl ? (size_t)(nl - head) : head_len;
            const uint8_t *colon = memchr(head + hp, ':', le - hp);
            if (colon != NULL) {
                const uint8_t *k = head + hp;
                size_t kn = (size_t)(colon - k);
                const uint8_t *val = colon + 1;
                size_t valn = le - hp - kn - 1;
                w_strip(&k, &kn);
                w_strip(&val, &valn);
                if (ci_equals(k, kn, "content-disposition")) {
                    disp = val; disp_len = valn;
                } else if (ci_equals(k, kn, "content-type")) {
                    ptype = val; ptype_len = valn;
                } else if (ci_equals(k, kn, "content-encoding")) {
                    penc = val; penc_len = valn;
                } else if (ci_equals(k, kn, "content-transfer-encoding")) {
                    pte = val; pte_len = valn;
                }
            }
            hp = nl ? le + 2 : head_len;
        }
        if (pte_len && !ci_equals(pte, pte_len, "binary") &&
            !ci_equals(pte, pte_len, "7bit") && !ci_equals(pte, pte_len, "8bit"))
            goto done; /* base64/quoted-printable: Python decodes */

        /* filename\s*=\s*("..."|token) in the disposition */
        const uint8_t *fname = NULL;
        size_t fname_len = 0;
        for (size_t i = 0; disp != NULL && i + 8 <= disp_len; i++) {
            if (!ci_prefix(disp + i, disp_len - i, "filename")) continue;
            size_t j = i + 8;
            while (j < disp_len && w_isspace(disp[j])) j++;
            if (j >= disp_len || disp[j] != '=') continue;
            j++;
            while (j < disp_len && w_isspace(disp[j])) j++;
            if (j < disp_len && disp[j] == '"') {
                size_t k = j + 1;
                while (k < disp_len && disp[k] != '"') {
                    if (disp[k] == '\\') goto done; /* escaped: Python */
                    k++;
                }
                if (k >= disp_len) goto done; /* unterminated quote:
                    Python's regex falls back to its token branch and
                    KEEPS the opening quote in the name — decline so
                    the fallback rules on it */
                fname = disp + j + 1;
                fname_len = k - (j + 1);
            } else {
                size_t k = j;
                while (k < disp_len && disp[k] != ';' && !w_isspace(disp[k]))
                    k++;
                if (k == j) continue;
                fname = disp + j;
                fname_len = k - j;
            }
            break;
        }

        weed_part cand = {
            .data = payload,
            .data_len = payload_len,
            .filename = fname,
            .filename_len = fname_len,
            .mime = ptype,
            .mime_len = ptype_len,
            .is_gzipped = penc_len && ci_equals(penc, penc_len, "gzip"),
        };
        if (fname_len) {
            *out = cand;
            rc = WEED_POST_OK;
            goto done;
        }
        if (!have_first) {
            first = cand;
            have_first = 1;
        }
        if (last) break;
        pos = npos;
    }
    if (have_first) {
        *out = first;
        rc = WEED_POST_OK;
    }
done:
    free(delim);
    return rc;
}

/* bytes valid for both the needle fields and the JSON reply without
 * escaping: printable ASCII minus quote and backslash. Anything else
 * declines (Python's latin-1 → str → utf-8 round-trip and json.dumps
 * escapes would diverge from raw bytes). */
static int ascii_clean(const uint8_t *s, size_t n) {
    for (size_t i = 0; i < n; i++)
        if (s[i] < 0x20 || s[i] > 0x7e || s[i] == '"' || s[i] == '\\') return 0;
    return 1;
}

static int ends_jpg(const uint8_t *s, size_t n) {
    if (n >= 4) {
        const uint8_t *e = s + n - 4;
        if (e[0] == '.' && w_lower(e[1]) == 'j' && w_lower(e[2]) == 'p' &&
            w_lower(e[3]) == 'g')
            return 1;
    }
    if (n >= 5) {
        const uint8_t *e = s + n - 5;
        if (e[0] == '.' && w_lower(e[1]) == 'j' && w_lower(e[2]) == 'p' &&
            w_lower(e[3]) == 'e' && w_lower(e[4]) == 'g')
            return 1;
    }
    return 0;
}

/* --- the one-pass POST ---------------------------------------------- */

typedef struct {
    /* in */
    const uint8_t *body;
    size_t body_len;
    const uint8_t *ctype;
    size_t ctype_len;
    int raw_gzipped;
    const uint8_t *q_name;   /* ?filename= (wins) */
    size_t q_name_len;
    const uint8_t *url_name; /* path filename (last resort) */
    size_t url_name_len;
    const uint8_t *pairs;
    size_t pairs_len;
    uint32_t base_flags;
    uint32_t cookie;
    uint64_t id;
    int version;
    uint64_t last_modified;
    uint64_t append_at_ns;
    int fd;
    int64_t offset;
    int fix_jpg;
    /* out */
    char reply[384];
    size_t reply_len;
    long total;
    uint32_t size;
    int io_errno;
    /* per-stage wall seconds for the tracing plane (docs/TRACING.md):
     * the Python fallback emits the SAME five stage names, so a bench
     * `--trace` breakdown reads identically whichever path served */
    double st_parse, st_assemble, st_crc, st_pwrite, st_reply;
} weed_post_req;

static int weed_post(weed_post_req *r) {
    if (r->version != 2 && r->version != 3) return WEED_POST_DECLINE;
    if (r->pairs_len >= 65536) return WEED_POST_DECLINE;
    r->st_parse = r->st_assemble = r->st_crc = r->st_pwrite = r->st_reply = 0.0;
    double t_stage = w_monotonic();

    const uint8_t *data = r->body;
    size_t data_len = r->body_len;
    const uint8_t *mime = r->ctype;
    size_t mime_len = r->ctype_len;
    const uint8_t *part_name = NULL;
    size_t part_name_len = 0;
    int is_gz = r->raw_gzipped;
    uint8_t *v = NULL;

    int multipart = ci_prefix(r->ctype, r->ctype_len, "multipart/form-data");
    if (multipart) {
        const uint8_t *b;
        size_t bn;
        if (parse_boundary(r->ctype, r->ctype_len, &b, &bn) != 0)
            return WEED_POST_DECLINE;
        /* V = CRLF + body: the virtual leading CRLF makes the first
         * boundary parse like every other delimiter line (same
         * materialization the Python parser performs) */
        v = malloc(r->body_len + 2);
        if (v == NULL) return WEED_POST_DECLINE;
        v[0] = '\r';
        v[1] = '\n';
        memcpy(v + 2, r->body, r->body_len);
        weed_part part;
        if (scan_multipart(v, r->body_len + 2, b, bn, &part) != WEED_POST_OK) {
            free(v);
            return WEED_POST_DECLINE;
        }
        data = part.data;
        data_len = part.data_len;
        mime = part.mime;
        mime_len = part.mime_len;
        part_name = part.filename;
        part_name_len = part.filename_len;
        is_gz = part.is_gzipped;
    }
    r->st_parse = w_monotonic() - t_stage;

    int rc = WEED_POST_DECLINE;
    if (data_len == 0) goto out; /* empty body: tombstone-shaped, Python */

    /* fname = q.filename or part.filename or url filename */
    const uint8_t *name = r->q_name;
    size_t name_len = r->q_name_len;
    if (name_len == 0) { name = part_name; name_len = part_name_len; }
    if (name_len == 0) { name = r->url_name; name_len = r->url_name_len; }
    if (name_len > 255) goto out;       /* reply carries it unescaped-long */
    if (!ascii_clean(name, name_len)) goto out;
    if (!ascii_clean(mime, mime_len)) goto out;
    if (r->fix_jpg && name_len && ends_jpg(name, name_len)) goto out;
    if (!is_gz && data_len > 128) {
        const uint8_t *ext;
        size_t ext_len;
        w_splitext(name, name_len, &ext, &ext_len);
        if (w_is_gzippable(ext, ext_len, mime, mime_len, data, data_len))
            goto out; /* Python compresses; bytes would diverge */
    }

    uint32_t flags = r->base_flags;
    if (is_gz) flags |= 0x01;                          /* FLAG_GZIP */
    if (name_len) flags |= 0x02;                       /* FLAG_HAS_NAME */
    /* Python: `if ctype and len(ctype) < 256 and ctype !=
     * "application/octet-stream"` — an exact case-sensitive compare */
    int mime_ok =
        mime_len > 0 && mime_len < 256 &&
        !(mime_len == 24 &&
          memcmp(mime, "application/octet-stream", 24) == 0);
    if (mime_ok) flags |= 0x04;                        /* FLAG_HAS_MIME */
    if (r->pairs_len) flags |= 0x20;                   /* FLAG_HAS_PAIRS */

    long cap = weed_needle_max_size((uint32_t)data_len, (uint32_t)name_len,
                                    (uint32_t)(mime_ok ? mime_len : 0),
                                    (uint32_t)r->pairs_len);
    t_stage = w_monotonic();
    uint8_t *rec = malloc((size_t)cap);
    if (rec == NULL) goto out;
    uint32_t size, crc;
    long total = weed_needle_encode(
        rec, r->cookie, r->id, data, (uint32_t)data_len, flags, name,
        (uint32_t)name_len, mime_ok ? mime : (const uint8_t *)"",
        (uint32_t)(mime_ok ? mime_len : 0), r->last_modified, NULL, r->pairs,
        (uint32_t)r->pairs_len, r->version, r->append_at_ns, &size, &crc,
        &r->st_crc);
    if (total < 0) {
        free(rec);
        goto out;
    }
    r->st_assemble = w_monotonic() - t_stage - r->st_crc;

    t_stage = w_monotonic();
    size_t done = 0;
    while (done < (size_t)total) {
        ssize_t w = pwrite(r->fd, rec + done, (size_t)total - done,
                           (off_t)(r->offset + (int64_t)done));
        if (w < 0) {
            if (errno == EINTR) continue;
            r->io_errno = errno;
            free(rec);
            rc = WEED_POST_IOERR;
            goto out;
        }
        if (w == 0) {
            r->io_errno = EIO;
            free(rec);
            rc = WEED_POST_IOERR;
            goto out;
        }
        done += (size_t)w;
    }
    free(rec);
    r->st_pwrite = w_monotonic() - t_stage;

    /* b'{"name": %s, "size": %d, "eTag": "%s"}' with %s = json.dumps
     * (trivial for the ascii_clean-gated name) and the etag the raw
     * CRC32-C as 8 lowercase hex digits (bytesutil.put_u32().hex()) */
    t_stage = w_monotonic();
    r->reply_len = (size_t)snprintf(
        r->reply, sizeof(r->reply),
        "{\"name\": \"%.*s\", \"size\": %u, \"eTag\": \"%08x\"}",
        (int)name_len, name ? (const char *)name : "", size, crc);
    r->st_reply = w_monotonic() - t_stage;
    r->total = total;
    r->size = size;
    rc = WEED_POST_OK;
out:
    free(v);
    return rc;
}
