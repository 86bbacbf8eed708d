/* serve.c — the event-driven serving core: one epoll loop that owns
 * accept/read/parse/respond for a listening socket.
 *
 * PR-5's stage traces put the serving residue in syscalls and loop
 * machinery (pwrite ~358 us of a ~500 us write; the Python mini-loop
 * and thread-per-connection dispatch are what's left around it), and
 * thread-per-connection cannot survive past a few thousand concurrent
 * connections.  This loop replaces that edge:
 *
 *   - non-blocking accept4 drain on every listen event (the kernel
 *     backlog is deep; the loop must never leave it full),
 *   - a per-connection read state machine: request heads are scanned
 *     out of one growing buffer, keep-alive and HTTP pipelining are
 *     native (the next pipelined head is parsed the moment the
 *     previous response drains — no extra epoll round trip),
 *   - a zero-copy GET fast path: the embedder's resolve() callback
 *     maps a request to (fd, offset, count) and the loop sendfile()s
 *     the bytes straight from the volume file to the socket, with
 *     short-write resumption on EAGAIN,
 *   - everything else HANDS THE CONNECTION OFF to the embedder
 *     (handoff() transfers the fd plus any unconsumed buffered bytes),
 *     so the one Python request parser keeps serving every slow path
 *     and the two paths cannot drift: this loop never formats an error
 *     response of its own.
 *
 * The loop knows no HTTP beyond what routing requires: request line,
 * the handful of headers that gate the fast path, and Connection
 * semantics.  Response bytes come from the embedder pre-formatted
 * except the Connection/Content-Length tail, which the loop appends
 * exactly like the Python fast_reply does — byte identity between the
 * C and Python serving paths is a construction, not a test hope.
 *
 * Pure C, no Python.h: serve_ext.c binds it the way needle_ext.c
 * binds post.c.  Callbacks are function pointers; the glue re-takes
 * the GIL inside them.
 */

#ifndef WEED_SERVE_C
#define WEED_SERVE_C

#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <sys/sendfile.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <time.h>
#include <unistd.h>

/* matches util/httpd._BufReader.read_head's 431 limit: a head this
 * large is handed off so the Python loop applies its own cap */
#define WEED_SERVE_HEAD_LIMIT 131072
#define WEED_SERVE_RBUF_INIT 4096
#define WEED_SERVE_SENDFILE_CHUNK (1u << 20)
#define WEED_SERVE_EVENTS 256

typedef struct {
    const char *method; size_t method_len;
    const char *path;   size_t path_len;
    const char *range;  size_t range_len;   /* NULL when absent */
    const char *trace;  size_t trace_len;   /* x-weed-trace value    */
    const char *inm;    size_t inm_len;     /* if-none-match value   */
    int has_auth;                           /* Authorization present */
    int head_only;                          /* method == HEAD        */
} weed_req;

typedef struct {
    const uint8_t *prefix; size_t prefix_len; /* status line + headers,
                                                 WITHOUT Connection /
                                                 Content-Length tail  */
    const uint8_t *body;   size_t body_len;   /* in-memory body (fd<0) */
    int fd; int64_t off; size_t count;        /* sendfile body (fd>=0) */
    int close_fd;                             /* loop closes fd after  */
    int status;
    /* conditional-GET arm: the needle's (strong) entity-tag plus the
     * pre-rendered 304 prefix the Python arm would send for it; absent
     * (len 0) on plans that have no validator (404s, legacy plans) */
    const uint8_t *etag;      size_t etag_len;
    const uint8_t *prefix304; size_t prefix304_len;
    /* plan-cache admission: the resolver's generation snapshot, and
     * whether this plan may be cached at all (single-process servers
     * only — a sibling's writes can't bump this process's counter) */
    uint64_t gen;
    int cacheable;
} weed_resp;

typedef struct weed_serve_cbs {
    void *ctx;
    /* One parsed GET/HEAD request.  Return 1 = resp filled (serve it
     * here), 0 = decline (hand the connection off), -1 = abort the
     * connection.  `token` rides to the matching complete(). */
    int (*resolve)(void *ctx, const weed_req *req, weed_resp *resp,
                   void **token);
    /* Ownership of `fd` (plus `len` unconsumed buffered bytes starting
     * at the current request head) transfers to the embedder.
     * `nreqs` = responses this loop already served on the connection,
     * so the embedder's max-requests accounting continues instead of
     * restarting. */
    void (*handoff)(void *ctx, int fd, const uint8_t *pending, size_t len,
                    const char *ip, int port, long nreqs);
    /* The fast-path response finished (ok=1: fully written; ok=0: the
     * connection died first).  Always called exactly once per
     * successful resolve() — it releases `token`. */
    void (*complete)(void *ctx, void *token, int status, size_t resp_bytes,
                     double t_parse, double t_resolve, double t_send, int ok);
} weed_serve_cbs;

typedef struct weed_conn {
    int fd;
    char ip[48];
    int port;
    uint8_t *rbuf;
    size_t rcap, rlen, rpos;  /* rpos = start of the current head */
    size_t scan;              /* head-end scan resume point        */
    uint8_t *wbuf;
    size_t wcap, wlen, wpos;
    int body_fd;
    int64_t body_off;
    size_t body_left;
    int close_body_fd;
    void *token;
    int status;
    size_t resp_bytes;
    int writing;  /* a response is in flight (interest = EPOLLOUT) */
    int closing;  /* close once the in-flight response drains      */
    int eof;      /* peer sent FIN; drain buffered pipeline, then close
                     (the Python loop serves buffered requests after
                     EOF too — byte-identity includes shutdown order) */
    long nreqs;
    double t_parse, t_resolve, t_send0;
    int64_t last_ms;
    struct weed_conn *prev, *next;  /* idle LRU; most recent at tail */
} weed_conn;

/* ---- per-loop plan cache -------------------------------------------
 * Direct-mapped, keyed by request path (the fid): a hit serves a hot
 * GET without calling into Python at all.  Entries are stamped with
 * the process-wide generation counter the storage layer bumps on any
 * volume mutation (write/delete/vacuum-swap/remount); a stale stamp
 * evicts on the next lookup, so the whole cache invalidates in O(1).
 * Sendfile entries own ONE dup of the volume fd; each response dups it
 * again so an eviction can never yank the fd from an in-flight
 * sendfile. */
#define WEED_SERVE_CACHE_SLOTS 512
#define WEED_SERVE_CACHE_KEYMAX 64
#define WEED_SERVE_CACHE_BODYMAX 16384

typedef struct {
    size_t key_len;            /* 0 = empty slot */
    char key[WEED_SERVE_CACHE_KEYMAX];
    uint64_t gen;
    int status;
    int fd;                    /* cache-owned dup for sendfile, or -1 */
    int64_t off; size_t count;
    uint8_t *buf;              /* prefix | body | etag | prefix304    */
    size_t prefix_len, body_len, etag_len, p304_len;
} weed_cache_slot;

typedef struct weed_loop {
    int epfd, listen_fd, wake_fd;
    long idle_ms, max_reqs;
    weed_serve_cbs *cbs;
    weed_conn lru;  /* sentinel */
    int stop;
    int use_adm;    /* shed via the shared-memory admission bucket */
    weed_cache_slot *cache;  /* lazily allocated on first insert */
    int64_t listen_paused_until_ms;  /* 0 = listen fd armed; else the
                                        re-arm deadline after EMFILE
                                        (a level-triggered listen event
                                        that can never accept would
                                        busy-spin the loop) */
} weed_loop;

static double weed_now_s(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

static int64_t weed_now_ms(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000 + ts.tv_nsec / 1000000;
}

static int64_t weed_now_ns(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000000ll + ts.tv_nsec;
}

/* ---- counters / generation ----------------------------------------- */

/* process-wide fast-path counters (weedload scrapes these via /status
 * to report the fast-path hit + 304 ratios); relaxed atomics because a
 * process can run several loops (public + internal listeners) */
static long weed_stat_served;        /* responses the C loop wrote    */
static long weed_stat_304;           /* ... of which were 304s        */
static long weed_stat_cache_hits;    /* served without calling Python */
static long weed_stat_cache_inserts;
static long weed_stat_shed;          /* 503s from the shared bucket   */
static long weed_stat_handoffs;      /* connections left for Python   */

/* plan-cache invalidation: the storage layer bumps this on ANY volume
 * mutation (write, delete, vacuum fd-swap, remount); resolvers stamp
 * plans with the value they observed before reading */
static uint64_t weed_serve_gen_counter;

static uint64_t weed_gen_get(void) {
    return __atomic_load_n(&weed_serve_gen_counter, __ATOMIC_RELAXED);
}

static uint64_t weed_gen_bump(void) {
    return __atomic_fetch_add(&weed_serve_gen_counter, 1, __ATOMIC_RELAXED) + 1;
}

static uint64_t weed_hash(const char *s, size_t n) {
    uint64_t h = 1469598103934665603ull;  /* FNV-1a */
    size_t i;
    for (i = 0; i < n; i++) {
        h ^= (uint8_t)s[i];
        h *= 1099511628211ull;
    }
    return h;
}

/* ---- If-None-Match --------------------------------------------------
 * RFC 9110 §13.1.2 against the resolver's entity-tag: `*` matches any,
 * otherwise a quote-aware scan of the comma-separated list with WEAK
 * comparison (W/ ignored on both sides).  This is the exact scanner
 * util/httpd.etag_matches implements — keep the two in lockstep; the
 * C-vs-Python identity matrix in tests/ diffs them. */
static int weed_etag_match(const char *hdr, size_t hn,
                           const uint8_t *etag, size_t en) {
    while (hn > 0 && (hdr[0] == ' ' || hdr[0] == '\t')) { hdr++; hn--; }
    while (hn > 0 && (hdr[hn - 1] == ' ' || hdr[hn - 1] == '\t')) hn--;
    if (hn == 0) return 0;
    if (hn == 1 && hdr[0] == '*') return 1;
    const uint8_t *target = etag;
    size_t tn = en;
    if (en >= 2 && etag[0] == 'W' && etag[1] == '/') { target += 2; tn -= 2; }
    size_t i = 0;
    while (i < hn) {
        while (i < hn && (hdr[i] == ' ' || hdr[i] == '\t' || hdr[i] == ','))
            i++;
        if (i >= hn) break;
        if (i + 1 < hn && hdr[i] == 'W' && hdr[i + 1] == '/') i += 2;
        if (i < hn && hdr[i] == '"') {
            const char *q = memchr(hdr + i + 1, '"', hn - i - 1);
            if (q == NULL) return 0;
            size_t clen = (size_t)(q - (hdr + i)) + 1;
            if (clen == tn && memcmp(hdr + i, target, tn) == 0) return 1;
            i += clen;
        } else {
            const char *cm = memchr(hdr + i, ',', hn - i);
            if (cm == NULL) return 0;
            i = (size_t)(cm - hdr) + 1;
        }
    }
    return 0;
}

/* ---- shared-memory admission ----------------------------------------
 * One token bucket per client key, shared by every `-serveProcs` /
 * `-workers` sibling through an mmap'd file, replacing the rate/N
 * per-process split (exact only under uniform connection spread).
 * Each slot is a single int64 GCRA theoretical-arrival-time in
 * CLOCK_MONOTONIC ns — the token bucket (rate r, burst b) expressed
 * as virtual time, so admit is ONE lock-free CAS: crash-safe (a
 * sibling killed mid-check holds no lock) where a shm mutex is not.
 * Key collisions merge budgets toward the conservative side
 * (documented in docs/QOS.md). */
#define WEED_SHM_MAGIC 0x5745454441444d31ull /* "WEEDADM1" */

typedef struct {
    uint64_t magic;
    uint32_t nslots;
    uint32_t pad_;
    double rate;        /* tokens/second, GLOBAL across siblings */
    double burst;       /* bucket size */
    double retry_floor; /* minimum Retry-After seconds */
} weed_shm_hdr;

static struct {
    weed_shm_hdr *hdr;
    int64_t *tat;
} weed_shm;

static int weed_shm_active(void) { return weed_shm.hdr != NULL; }

/* attach (creating + initializing when first): flock serializes the
 * header init race between siblings; first writer's parameters win */
static int weed_shm_attach(const char *path, double rate, double burst,
                           double retry_floor, uint32_t nslots) {
    if (weed_shm.hdr != NULL) return 0;  /* process-global, attach once */
    if (nslots == 0) nslots = 1024;
    int fd = open(path, O_RDWR | O_CREAT | O_CLOEXEC, 0600);
    if (fd < 0) return -errno;
    if (flock(fd, LOCK_EX) != 0) {
        int e = errno;
        close(fd);
        return -e;
    }
    struct stat st;
    weed_shm_hdr init;
    size_t need;
    if (fstat(fd, &st) != 0) goto fail_errno;
    if (st.st_size < (off_t)sizeof(weed_shm_hdr)) {
        need = sizeof(weed_shm_hdr) + (size_t)nslots * sizeof(int64_t);
        if (ftruncate(fd, (off_t)need) != 0) goto fail_errno;
        memset(&init, 0, sizeof(init));
        init.magic = WEED_SHM_MAGIC;
        init.nslots = nslots;
        init.rate = rate;
        init.burst = burst;
        init.retry_floor = retry_floor;
        if (pwrite(fd, &init, sizeof(init), 0) != (ssize_t)sizeof(init))
            goto fail_errno;
    } else {
        if (pread(fd, &init, sizeof(init), 0) != (ssize_t)sizeof(init) ||
            init.magic != WEED_SHM_MAGIC || init.nslots == 0) {
            flock(fd, LOCK_UN);
            close(fd);
            return -EINVAL;
        }
        need = sizeof(weed_shm_hdr) + (size_t)init.nslots * sizeof(int64_t);
    }
    flock(fd, LOCK_UN);
    void *m = mmap(NULL, need, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    close(fd);  /* the mapping keeps the file alive */
    if (m == MAP_FAILED) return -errno;
    weed_shm.tat = (int64_t *)((uint8_t *)m + sizeof(weed_shm_hdr));
    weed_shm.hdr = (weed_shm_hdr *)m;
    return 0;
fail_errno:
    {
        int e = errno;
        flock(fd, LOCK_UN);
        close(fd);
        return -e;
    }
}

static void weed_shm_detach(void) {
    if (weed_shm.hdr == NULL) return;
    size_t need = sizeof(weed_shm_hdr) +
                  (size_t)weed_shm.hdr->nslots * sizeof(int64_t);
    weed_shm.hdr = NULL;
    munmap((void *)((uint8_t *)weed_shm.tat - sizeof(weed_shm_hdr)), need);
    weed_shm.tat = NULL;
}

/* 0.0 = admitted (one token consumed); > 0 = shed, the Retry-After
 * seconds (same formula as the Python gate: time until one token). */
static double weed_shm_admit(const char *key, size_t klen) {
    weed_shm_hdr *h = weed_shm.hdr;
    if (h == NULL || h->rate <= 0.0) return 0.0;
    int64_t T = (int64_t)(1e9 / h->rate);
    if (T < 1) T = 1;
    double b = h->burst < 1.0 ? 1.0 : h->burst;
    int64_t tau = (int64_t)((b - 1.0) * 1e9 / h->rate);
    int64_t *slot = &weed_shm.tat[weed_hash(key, klen) % h->nslots];
    for (;;) {
        int64_t now = weed_now_ns();
        int64_t tat = __atomic_load_n(slot, __ATOMIC_RELAXED);
        if (tat - now > tau) {
            double retry = (double)(tat - now - tau) / 1e9;
            return retry < h->retry_floor ? h->retry_floor : retry;
        }
        int64_t base = tat > now ? tat : now;
        if (__atomic_compare_exchange_n(slot, &tat, base + T, 0,
                                        __ATOMIC_RELAXED, __ATOMIC_RELAXED))
            return 0.0;
    }
}

/* byte-for-byte the Python gate's shed body (qos/admission._shed) */
static const char weed_shed_body[] =
    "{\"error\": \"admission control: over per-client budget\"}";

/* ---- idle LRU ------------------------------------------------------ */

static void weed_lru_unlink(weed_conn *c) {
    c->prev->next = c->next;
    c->next->prev = c->prev;
}

static void weed_lru_touch(weed_loop *lp, weed_conn *c) {
    weed_lru_unlink(c);
    c->prev = lp->lru.prev;
    c->next = &lp->lru;
    lp->lru.prev->next = c;
    lp->lru.prev = c;
    c->last_ms = weed_now_ms();
}

/* ---- connection lifecycle ------------------------------------------ */

static void weed_conn_release_resp(weed_loop *lp, weed_conn *c, int ok) {
    if (c->close_body_fd && c->body_fd >= 0) close(c->body_fd);
    c->body_fd = -1;
    c->body_left = 0;
    c->close_body_fd = 0;
    if (c->token != NULL) {
        double t_send = weed_now_s() - c->t_send0;
        lp->cbs->complete(lp->cbs->ctx, c->token, c->status, c->resp_bytes,
                          c->t_parse, c->t_resolve, t_send, ok);
        c->token = NULL;
    }
}

static void weed_conn_destroy(weed_loop *lp, weed_conn *c, int close_fd) {
    weed_conn_release_resp(lp, c, 0);
    weed_lru_unlink(c);
    epoll_ctl(lp->epfd, EPOLL_CTL_DEL, c->fd, NULL);
    if (close_fd) close(c->fd);
    free(c->rbuf);
    free(c->wbuf);
    free(c);
}

/* the connection leaves this loop alive: the embedder now owns the fd
 * and the unconsumed bytes (the current head onward) */
static void weed_conn_handoff(weed_loop *lp, weed_conn *c) {
    int fd = c->fd;
    __atomic_fetch_add(&weed_stat_handoffs, 1, __ATOMIC_RELAXED);
    /* detach BEFORE the callback: the embedder may start reading from
     * another thread immediately */
    epoll_ctl(lp->epfd, EPOLL_CTL_DEL, fd, NULL);
    lp->cbs->handoff(lp->cbs->ctx, fd, c->rbuf + c->rpos, c->rlen - c->rpos,
                     c->ip, c->port, c->nreqs);
    weed_lru_unlink(c);
    free(c->rbuf);
    free(c->wbuf);
    free(c);
}

static int weed_conn_interest(weed_loop *lp, weed_conn *c, uint32_t events) {
    struct epoll_event ev;
    memset(&ev, 0, sizeof(ev));
    /* RDHUP only while reading: a half-closed peer that is still
     * draining its response would otherwise level-trigger RDHUP every
     * epoll round while the send buffer is full (busy spin); in the
     * writing state a dead peer surfaces as EPOLLERR/HUP or EPIPE */
    ev.events = events | ((events & EPOLLIN) ? EPOLLRDHUP : 0);
    ev.data.ptr = c;
    return epoll_ctl(lp->epfd, EPOLL_CTL_MOD, c->fd, &ev);
}

/* ---- buffers ------------------------------------------------------- */

static int weed_rbuf_reserve(weed_conn *c, size_t want) {
    if (c->rcap - c->rlen >= want) return 0;
    /* compact first: everything before rpos is consumed */
    if (c->rpos > 0) {
        memmove(c->rbuf, c->rbuf + c->rpos, c->rlen - c->rpos);
        if (c->scan >= c->rpos) c->scan -= c->rpos; else c->scan = 0;
        c->rlen -= c->rpos;
        c->rpos = 0;
        if (c->rcap - c->rlen >= want) return 0;
    }
    size_t cap = c->rcap ? c->rcap : WEED_SERVE_RBUF_INIT;
    while (cap - c->rlen < want) cap *= 2;
    uint8_t *nb = realloc(c->rbuf, cap);
    if (nb == NULL) return -1;
    c->rbuf = nb;
    c->rcap = cap;
    return 0;
}

static int weed_wbuf_append(weed_conn *c, const void *data, size_t n) {
    if (c->wcap - c->wlen < n) {
        size_t cap = c->wcap ? c->wcap : 1024;
        while (cap - c->wlen < n) cap *= 2;
        uint8_t *nb = realloc(c->wbuf, cap);
        if (nb == NULL) return -1;
        c->wbuf = nb;
        c->wcap = cap;
    }
    memcpy(c->wbuf + c->wlen, data, n);
    c->wlen += n;
    return 0;
}

/* ---- plan cache ---------------------------------------------------- */

static void weed_cache_slot_clear(weed_cache_slot *s) {
    if (s->fd >= 0) close(s->fd);
    free(s->buf);
    memset(s, 0, sizeof(*s));
    s->fd = -1;
}

static weed_cache_slot *weed_cache_get(weed_loop *lp, const char *path,
                                       size_t plen) {
    if (lp->cache == NULL || plen == 0 || plen > WEED_SERVE_CACHE_KEYMAX)
        return NULL;
    weed_cache_slot *s =
        &lp->cache[weed_hash(path, plen) % WEED_SERVE_CACHE_SLOTS];
    if (s->key_len != plen || memcmp(s->key, path, plen) != 0) return NULL;
    if (s->gen != weed_gen_get()) {
        weed_cache_slot_clear(s);  /* the storage layer bumped: stale */
        return NULL;
    }
    return s;
}

static void weed_cache_put(weed_loop *lp, const weed_req *req,
                           const weed_resp *resp) {
    if (!resp->cacheable || resp->status != 200 || req->range != NULL)
        return;
    if (req->path_len == 0 || req->path_len > WEED_SERVE_CACHE_KEYMAX)
        return;
    if (resp->fd < 0 && resp->body_len > WEED_SERVE_CACHE_BODYMAX)
        return;
    if (resp->gen != weed_gen_get())
        return;  /* raced an invalidation during the resolve */
    if (lp->cache == NULL) {
        lp->cache = calloc(WEED_SERVE_CACHE_SLOTS, sizeof(weed_cache_slot));
        if (lp->cache == NULL) return;
        for (size_t i = 0; i < WEED_SERVE_CACHE_SLOTS; i++)
            lp->cache[i].fd = -1;
    }
    weed_cache_slot *s =
        &lp->cache[weed_hash(req->path, req->path_len) %
                   WEED_SERVE_CACHE_SLOTS];
    weed_cache_slot_clear(s);
    size_t blen = resp->fd >= 0 ? 0 : resp->body_len;
    size_t total =
        resp->prefix_len + blen + resp->etag_len + resp->prefix304_len;
    uint8_t *buf = malloc(total ? total : 1);
    if (buf == NULL) return;
    uint8_t *w = buf;
    memcpy(w, resp->prefix, resp->prefix_len); w += resp->prefix_len;
    if (blen) { memcpy(w, resp->body, blen); w += blen; }
    if (resp->etag_len) { memcpy(w, resp->etag, resp->etag_len); w += resp->etag_len; }
    if (resp->prefix304_len) memcpy(w, resp->prefix304, resp->prefix304_len);
    if (resp->fd >= 0) {
        int dfd = fcntl(resp->fd, F_DUPFD_CLOEXEC, 0);
        if (dfd < 0) {
            free(buf);
            return;
        }
        s->fd = dfd;
        s->off = resp->off;
        s->count = resp->count;
    }
    memcpy(s->key, req->path, req->path_len);
    s->key_len = req->path_len;
    s->gen = resp->gen;
    s->status = resp->status;
    s->buf = buf;
    s->prefix_len = resp->prefix_len;
    s->body_len = blen;
    s->etag_len = resp->etag_len;
    s->p304_len = resp->prefix304_len;
    __atomic_fetch_add(&weed_stat_cache_inserts, 1, __ATOMIC_RELAXED);
}

static void weed_cache_free(weed_loop *lp) {
    if (lp->cache == NULL) return;
    for (size_t i = 0; i < WEED_SERVE_CACHE_SLOTS; i++)
        if (lp->cache[i].key_len) weed_cache_slot_clear(&lp->cache[i]);
    free(lp->cache);
    lp->cache = NULL;
}

/* ---- parsing ------------------------------------------------------- */

/* find "\r\n\r\n" in buf[from..len); returns offset of its first byte
 * or -1.  memchr-based so no _GNU_SOURCE memmem dependency. */
static ssize_t weed_find_head_end(const uint8_t *buf, size_t len, size_t from) {
    while (from + 4 <= len) {
        const uint8_t *p = memchr(buf + from, '\r', len - from - 3);
        if (p == NULL) return -1;
        if (p[1] == '\n' && p[2] == '\r' && p[3] == '\n')
            return (ssize_t)(p - buf);
        from = (size_t)(p - buf) + 1;
    }
    return -1;
}

static int weed_token_eq_ci(const char *p, size_t n, const char *lit) {
    size_t i;
    for (i = 0; i < n; i++) {
        char a = p[i];
        if (a >= 'A' && a <= 'Z') a += 32;
        if (a != lit[i]) return 0;
    }
    return lit[n] == '\0';
}

static void weed_trim(const char **p, size_t *n) {
    while (*n > 0 && ((*p)[0] == ' ' || (*p)[0] == '\t')) { (*p)++; (*n)--; }
    while (*n > 0 && ((*p)[*n - 1] == ' ' || (*p)[*n - 1] == '\t')) (*n)--;
}

/* Parse one request head (head_len bytes including the blank line).
 * Returns 1 = fast-path candidate (req filled, keep_alive set),
 *         0 = hand off (anything this loop does not fully model).   */
static int weed_parse_head(const uint8_t *head, size_t head_len,
                           weed_req *req, int *keep_alive) {
    const char *p = (const char *)head;
    const char *end = p + head_len - 2;  /* final CRLF of blank line */
    const char *eol = memchr(p, '\r', (size_t)(end - p));
    if (eol == NULL || eol[1] != '\n') return 0;

    /* request line: METHOD SP PATH SP HTTP/1.x */
    const char *sp1 = memchr(p, ' ', (size_t)(eol - p));
    if (sp1 == NULL) return 0;
    const char *sp2 = memchr(sp1 + 1, ' ', (size_t)(eol - sp1 - 1));
    if (sp2 == NULL) return 0;
    size_t mlen = (size_t)(sp1 - p);
    size_t vlen = (size_t)(eol - sp2 - 1);
    if (memchr(sp1 + 1, ' ', (size_t)(sp2 - sp1 - 1)) != NULL) return 0;
    int head_only;
    if (mlen == 3 && memcmp(p, "GET", 3) == 0) head_only = 0;
    else if (mlen == 4 && memcmp(p, "HEAD", 4) == 0) head_only = 1;
    else return 0;
    int http11;
    if (vlen == 8 && memcmp(sp2 + 1, "HTTP/1.1", 8) == 0) http11 = 1;
    else if (vlen == 8 && memcmp(sp2 + 1, "HTTP/1.0", 8) == 0) http11 = 0;
    else return 0;  /* 0.9 / exotic versions: the Python parser decides */

    memset(req, 0, sizeof(*req));
    req->method = p;
    req->method_len = mlen;
    req->path = sp1 + 1;
    req->path_len = (size_t)(sp2 - sp1 - 1);
    req->head_only = head_only;
    if (req->path_len == 0) return 0;

    int ka = http11;
    const char *line = eol + 2;
    while (line < end) {
        const char *le = memchr(line, '\r', (size_t)(end - line));
        if (le == NULL) le = end;
        const char *colon = memchr(line, ':', (size_t)(le - line));
        if (colon != NULL) {
            const char *k = line;
            size_t kn = (size_t)(colon - line);
            const char *v = colon + 1;
            size_t vn = (size_t)(le - colon - 1);
            weed_trim(&k, &kn);
            weed_trim(&v, &vn);
            if (weed_token_eq_ci(k, kn, "connection")) {
                if (weed_token_eq_ci(v, vn, "close")) ka = 0;
                else if (weed_token_eq_ci(v, vn, "keep-alive")) ka = 1;
            } else if (weed_token_eq_ci(k, kn, "content-length")) {
                /* a GET with a body: let Python frame and drain it */
                if (!(vn == 1 && v[0] == '0')) return 0;
            } else if (weed_token_eq_ci(k, kn, "transfer-encoding") ||
                       weed_token_eq_ci(k, kn, "expect") ||
                       weed_token_eq_ci(k, kn, "if-modified-since") ||
                       weed_token_eq_ci(k, kn, "etag-md5") ||
                       weed_token_eq_ci(k, kn, "x-weed-deadline")) {
                /* date-conditional / framing / deadline semantics live
                 * in Python (the mini loop parses the budget, 504-
                 * fast-rejects expired ones, and scopes the ambient
                 * deadline around dispatch — docs/CHAOS.md).
                 * If-None-Match stays HERE: the resolver supplies the
                 * entity-tag and the loop answers 304 itself. */
                return 0;
            } else if (weed_token_eq_ci(k, kn, "if-none-match")) {
                if (req->inm != NULL) return 0;  /* duplicate header */
                req->inm = v;
                req->inm_len = vn;
            } else if (weed_token_eq_ci(k, kn, "authorization")) {
                /* admission keys authenticated requests by access key,
                 * which only the Python gate parses */
                req->has_auth = 1;
            } else if (weed_token_eq_ci(k, kn, "range")) {
                if (req->range != NULL) return 0;  /* duplicate Range */
                req->range = v;
                req->range_len = vn;
            } else if (weed_token_eq_ci(k, kn, "x-weed-trace")) {
                req->trace = v;
                req->trace_len = vn;
            }
        }
        line = le + 2;
    }
    *keep_alive = ka;
    return 1;
}

/* ---- response writing ---------------------------------------------- */

/* 1 = fully written, 0 = would block (EPOLLOUT pending), -1 = dead */
static int weed_conn_flush(weed_conn *c) {
    while (c->wpos < c->wlen) {
        ssize_t n = send(c->fd, c->wbuf + c->wpos, c->wlen - c->wpos,
                         MSG_NOSIGNAL);
        if (n < 0) {
            if (errno == EAGAIN || errno == EWOULDBLOCK) return 0;
            if (errno == EINTR) continue;
            return -1;
        }
        c->wpos += (size_t)n;
    }
    while (c->body_left > 0) {
        off_t off = (off_t)c->body_off;
        size_t chunk = c->body_left < WEED_SERVE_SENDFILE_CHUNK
                           ? c->body_left
                           : WEED_SERVE_SENDFILE_CHUNK;
        ssize_t n = sendfile(c->fd, c->body_fd, &off, chunk);
        if (n < 0) {
            if (errno == EAGAIN || errno == EWOULDBLOCK) return 0;
            if (errno == EINTR) continue;
            return -1;
        }
        if (n == 0) return -1;  /* source truncated under us: the
                                   promised Content-Length cannot be
                                   met — kill the connection so the
                                   client sees a short read, never
                                   silent corruption */
        c->body_off = (int64_t)off;
        c->body_left -= (size_t)n;
    }
    return 1;
}

/* First flush of a staged response: ONE gathering sendmsg over the
 * head pieces + inline body (the writev reply — no memcpy into wbuf
 * unless the kernel leaves a remainder), then the shared flush for any
 * sendfile body.  The staged buffers are only borrowed for the
 * duration of this call: a blocked remainder is copied into wbuf
 * before returning, so resolver-token and cache-slot lifetimes never
 * extend into the EPOLLOUT machinery.
 * Returns 0 = fully sent (connection stays, pipeline may continue),
 *         1 = blocked (EPOLLOUT armed, caller must return),
 *        -1 = connection left the loop. */
static int weed_conn_send_staged(weed_loop *lp, weed_conn *c,
                                 const struct iovec *iov, int niov) {
    c->writing = 1;
    c->t_send0 = weed_now_s();
    size_t total = 0;
    for (int i = 0; i < niov; i++) total += iov[i].iov_len;
    struct msghdr mh;
    memset(&mh, 0, sizeof(mh));
    mh.msg_iov = (struct iovec *)iov;
    mh.msg_iovlen = (size_t)niov;
    ssize_t sent;
    do {
        sent = sendmsg(c->fd, &mh, MSG_NOSIGNAL);
    } while (sent < 0 && errno == EINTR);
    if (sent < 0) {
        if (errno != EAGAIN && errno != EWOULDBLOCK) {
            weed_conn_destroy(lp, c, 1);
            return -1;
        }
        sent = 0;
    }
    c->wlen = c->wpos = 0;
    if ((size_t)sent < total) {
        size_t skip = (size_t)sent;
        int oom = 0;
        for (int i = 0; i < niov && !oom; i++) {
            if (skip >= iov[i].iov_len) {
                skip -= iov[i].iov_len;
                continue;
            }
            oom = weed_wbuf_append(
                c, (const uint8_t *)iov[i].iov_base + skip,
                iov[i].iov_len - skip);
            skip = 0;
        }
        if (oom) {
            weed_conn_destroy(lp, c, 1);
            return -1;
        }
    }
    int wr = weed_conn_flush(c);
    if (wr < 0) {
        weed_conn_destroy(lp, c, 1);
        return -1;
    }
    if (wr == 0) {
        if (weed_conn_interest(lp, c, EPOLLOUT) < 0) {
            weed_conn_destroy(lp, c, 1);
            return -1;
        }
        return 1;
    }
    weed_conn_release_resp(lp, c, 1);
    c->writing = 0;
    c->wlen = c->wpos = 0;
    if (c->closing) {
        weed_conn_destroy(lp, c, 1);
        return -1;
    }
    return 0;
}

/* process buffered requests until blocked.  Returns 0 to keep the
 * connection in the loop, -1 when it left (destroyed or handed off). */
static int weed_conn_process(weed_loop *lp, weed_conn *c) {
    while (!c->writing) {
        size_t avail = c->rlen - c->rpos;
        if (avail < 4) break;
        if (c->scan < c->rpos) c->scan = c->rpos;
        ssize_t he = weed_find_head_end(c->rbuf, c->rlen, c->scan);
        if (he < 0) {
            c->scan = c->rlen >= 3 ? c->rlen - 3 : 0;
            if (avail > WEED_SERVE_HEAD_LIMIT) {
                weed_conn_handoff(lp, c);  /* Python replies 431 */
                return -1;
            }
            break;
        }
        size_t head_len = (size_t)he + 4 - c->rpos;
        if (head_len > WEED_SERVE_HEAD_LIMIT) {
            /* a COMPLETE head past the cap: the incomplete-head check
             * above never fires when the whole head coalesced into one
             * buffered read — hand off so Python's read_head replies
             * 431 instead of serving the oversized request as 200 */
            weed_conn_handoff(lp, c);
            return -1;
        }

        double tp0 = weed_now_s();
        weed_req req;
        int keep_alive = 1;
        if (!weed_parse_head(c->rbuf + c->rpos, head_len, &req, &keep_alive) ||
            lp->cbs->resolve == NULL) {
            weed_conn_handoff(lp, c);
            return -1;
        }
        c->t_parse = weed_now_s() - tp0;

        int use_adm = lp->use_adm && weed_shm_active();
        if (use_adm && req.has_auth) {
            /* Authorization must be keyed by access key; only the
             * Python gate parses it — the handoff re-gates there */
            weed_conn_handoff(lp, c);
            return -1;
        }

        weed_resp resp;
        memset(&resp, 0, sizeof(resp));
        resp.fd = -1;
        void *token = NULL;
        int from_cache = 0;
        double tr0 = weed_now_s();
        if (req.range == NULL) {
            weed_cache_slot *s = weed_cache_get(lp, req.path, req.path_len);
            if (s != NULL) {
                resp.status = s->status;
                resp.prefix = s->buf;
                resp.prefix_len = s->prefix_len;
                resp.body = s->buf + s->prefix_len;
                resp.body_len = s->body_len;
                resp.etag = s->buf + s->prefix_len + s->body_len;
                resp.etag_len = s->etag_len;
                resp.prefix304 =
                    s->buf + s->prefix_len + s->body_len + s->etag_len;
                resp.prefix304_len = s->p304_len;
                from_cache = 1;
                if (s->fd >= 0) {
                    /* per-response dup: an eviction must never yank
                     * the fd out of an in-flight sendfile */
                    int dfd = fcntl(s->fd, F_DUPFD_CLOEXEC, 0);
                    if (dfd < 0) {
                        from_cache = 0;  /* fall back to the resolver */
                        memset(&resp, 0, sizeof(resp));
                        resp.fd = -1;
                    } else {
                        resp.fd = dfd;
                        resp.off = s->off;
                        resp.count = s->count;
                        resp.close_fd = 1;
                    }
                }
                if (from_cache)
                    __atomic_fetch_add(&weed_stat_cache_hits, 1,
                                       __ATOMIC_RELAXED);
            }
        }
        if (!from_cache) {
            int rc = lp->cbs->resolve(lp->cbs->ctx, &req, &resp, &token);
            c->t_resolve = weed_now_s() - tr0;
            if (rc == 0) {
                weed_conn_handoff(lp, c);
                return -1;
            }
            if (rc < 0) {
                weed_conn_destroy(lp, c, 1);
                return -1;
            }
            weed_cache_put(lp, &req, &resp);
        } else {
            c->t_resolve = weed_now_s() - tr0;
        }

        c->rpos += head_len;
        c->scan = c->rpos;
        c->nreqs++;
        int close_now =
            !keep_alive || (lp->max_reqs > 0 && c->nreqs >= lp->max_reqs);
        c->closing = close_now;

        if (use_adm) {
            double retry = weed_shm_admit(c->ip, strlen(c->ip));
            if (retry > 0.0) {
                /* shared-bucket shed, entirely in C: drop the plan,
                 * reply the exact bytes the Python gate's _shed sends */
                if (resp.fd >= 0 && resp.close_fd) close(resp.fd);
                if (token != NULL) {
                    /* releases the resolver token and records the 503
                     * on the request counter like the threaded arm */
                    lp->cbs->complete(lp->cbs->ctx, token, 503, 0,
                                      c->t_parse, c->t_resolve, 0.0, 1);
                    token = NULL;
                }
                __atomic_fetch_add(&weed_stat_shed, 1, __ATOMIC_RELAXED);
                char shed_head[192];
                int sn = snprintf(
                    shed_head, sizeof(shed_head),
                    "HTTP/1.1 503 Service Unavailable\r\n"
                    "Content-Type: application/json\r\n"
                    "Retry-After: %.3f\r\n"
                    "%s"
                    "Content-Length: %zu\r\n\r\n",
                    retry, close_now ? "Connection: close\r\n" : "",
                    sizeof(weed_shed_body) - 1);
                struct iovec siov[2];
                int sniov = 0;
                siov[sniov].iov_base = shed_head;
                siov[sniov++].iov_len = (size_t)sn;
                if (!req.head_only) {
                    siov[sniov].iov_base = (void *)weed_shed_body;
                    siov[sniov++].iov_len = sizeof(weed_shed_body) - 1;
                }
                c->token = NULL;
                c->status = 503;
                c->resp_bytes = (size_t)sn +
                    (req.head_only ? 0 : sizeof(weed_shed_body) - 1);
                int sr = weed_conn_send_staged(lp, c, siov, sniov);
                if (sr < 0) return -1;
                if (sr > 0) return 0;
                if (c->rpos == c->rlen)
                    c->rpos = c->rlen = c->scan = 0;
                continue;
            }
        }

        /* assemble head exactly as fast_reply does: resolver prefix
         * (status line + headers), optional Connection: close, then
         * Content-Length last.  If-None-Match beats Range (the Python
         * arm checks it before range handling): a validator match
         * answers 304 from the pre-rendered prefix and drops the plan
         * body, whatever the plan's status was. */
        int not_modified =
            req.inm != NULL && resp.etag_len > 0 && resp.prefix304_len > 0 &&
            weed_etag_match(req.inm, req.inm_len, resp.etag, resp.etag_len);
        char tail[64];
        int tn;
        struct iovec iov[4];
        int niov = 0;
        if (not_modified) {
            if (resp.fd >= 0 && resp.close_fd) close(resp.fd);
            resp.fd = -1;
            tn = snprintf(tail, sizeof(tail), "Content-Length: 0\r\n\r\n");
            iov[niov].iov_base = (void *)resp.prefix304;
            iov[niov++].iov_len = resp.prefix304_len;
            __atomic_fetch_add(&weed_stat_304, 1, __ATOMIC_RELAXED);
        } else {
            size_t body_total = resp.fd >= 0 ? resp.count : resp.body_len;
            tn = snprintf(tail, sizeof(tail),
                          "Content-Length: %zu\r\n\r\n", body_total);
            iov[niov].iov_base = (void *)resp.prefix;
            iov[niov++].iov_len = resp.prefix_len;
        }
        if (close_now) {
            iov[niov].iov_base = (void *)"Connection: close\r\n";
            iov[niov++].iov_len = 19;
        }
        iov[niov].iov_base = tail;
        iov[niov++].iov_len = (size_t)tn;
        if (!not_modified && !req.head_only && resp.fd < 0 &&
            resp.body_len > 0) {
            iov[niov].iov_base = (void *)resp.body;
            iov[niov++].iov_len = resp.body_len;
        }
        size_t head_bytes = 0;
        for (int i = 0; i < niov; i++) head_bytes += iov[i].iov_len;
        c->token = token;
        c->status = not_modified ? 304 : resp.status;
        c->resp_bytes = head_bytes +
            ((req.head_only || not_modified) ? 0
                 : (resp.fd >= 0 ? resp.count : 0));
        if (!not_modified && !req.head_only && resp.fd >= 0 &&
            resp.count > 0) {
            c->body_fd = resp.fd;
            c->body_off = resp.off;
            c->body_left = resp.count;
            c->close_body_fd = resp.close_fd;
        } else if (resp.fd >= 0 && resp.close_fd) {
            close(resp.fd);  /* HEAD / empty body: nothing to send */
        }
        __atomic_fetch_add(&weed_stat_served, 1, __ATOMIC_RELAXED);
        int sr = weed_conn_send_staged(lp, c, iov, niov);
        if (sr < 0) return -1;
        if (sr > 0) return 0;
        if (c->rpos == c->rlen) {
            c->rpos = c->rlen = c->scan = 0;  /* cheap full reset */
        }
    }
    if (c->eof && !c->writing) {
        /* pipeline drained (or never complete) after FIN: done */
        weed_conn_destroy(lp, c, 1);
        return -1;
    }
    return 0;
}

/* One write attempt on an in-flight response, shared by the EPOLLOUT
 * handler and the idle-reaper's drain probe.  Returns -1 when the
 * connection left the loop (destroyed or handed off), else 0; partial
 * progress touches the idle LRU (a slow-but-draining client is active,
 * not idle), completion finishes the response and resumes the
 * pipeline. */
static int weed_conn_flush_step(weed_loop *lp, weed_conn *c) {
    size_t wpos0 = c->wpos, left0 = c->body_left;
    int wr = weed_conn_flush(c);
    if (wr < 0) {
        weed_conn_destroy(lp, c, 1);
        return -1;
    }
    if (wr == 0) {
        if (c->wpos != wpos0 || c->body_left != left0)
            weed_lru_touch(lp, c);
        return 0;
    }
    weed_conn_release_resp(lp, c, 1);
    c->writing = 0;
    c->wlen = c->wpos = 0;
    weed_lru_touch(lp, c);
    if (c->closing) {
        weed_conn_destroy(lp, c, 1);
        return -1;
    }
    if (weed_conn_interest(lp, c, EPOLLIN) < 0) {
        weed_conn_destroy(lp, c, 1);
        return -1;
    }
    return weed_conn_process(lp, c);
}

static int weed_conn_read(weed_loop *lp, weed_conn *c) {
    for (;;) {
        if (weed_rbuf_reserve(c, 4096) < 0) {
            weed_conn_destroy(lp, c, 1);
            return -1;
        }
        ssize_t n = recv(c->fd, c->rbuf + c->rlen, c->rcap - c->rlen, 0);
        if (n > 0) {
            c->rlen += (size_t)n;
            if (c->rlen < c->rcap) break;  /* short read: drained */
            continue;
        }
        if (n == 0) {  /* FIN: serve what is buffered, then close */
            c->eof = 1;
            break;
        }
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        if (errno == EINTR) continue;
        weed_conn_destroy(lp, c, 1);
        return -1;
    }
    weed_lru_touch(lp, c);
    return weed_conn_process(lp, c);
}

static void weed_accept_drain(weed_loop *lp) {
    for (;;) {
        struct sockaddr_storage ss;
        socklen_t slen = sizeof(ss);
        int fd = accept4(lp->listen_fd, (struct sockaddr *)&ss, &slen,
                         SOCK_NONBLOCK | SOCK_CLOEXEC);
        if (fd < 0) {
            if (errno == EINTR) continue;
            if (errno == EMFILE || errno == ENFILE) {
                /* fd exhaustion: the backlog stays non-empty, so the
                 * level-triggered listen event would re-fire every
                 * epoll round in a hot spin — park the listen fd and
                 * re-arm after a beat */
                epoll_ctl(lp->epfd, EPOLL_CTL_DEL, lp->listen_fd, NULL);
                lp->listen_paused_until_ms = weed_now_ms() + 100;
            }
            return;  /* EAGAIN / ECONNABORTED: next listen event retries */
        }
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        weed_conn *c = calloc(1, sizeof(weed_conn));
        if (c == NULL) {
            close(fd);
            continue;
        }
        c->fd = fd;
        c->body_fd = -1;
        c->ip[0] = '\0';
        if (ss.ss_family == AF_INET) {
            const struct sockaddr_in *a = (const struct sockaddr_in *)&ss;
            const uint8_t *b = (const uint8_t *)&a->sin_addr;
            snprintf(c->ip, sizeof(c->ip), "%u.%u.%u.%u", b[0], b[1], b[2],
                     b[3]);
            c->port = (int)ntohs(a->sin_port);
        } else if (ss.ss_family == AF_INET6) {
            const struct sockaddr_in6 *a6 = (const struct sockaddr_in6 *)&ss;
            const uint8_t *b = (const uint8_t *)&a6->sin6_addr;
            /* enough fidelity for logs/ACL checks on the data plane */
            snprintf(c->ip, sizeof(c->ip),
                     "%x:%x:%x:%x:%x:%x:%x:%x",
                     (b[0] << 8) | b[1], (b[2] << 8) | b[3],
                     (b[4] << 8) | b[5], (b[6] << 8) | b[7],
                     (b[8] << 8) | b[9], (b[10] << 8) | b[11],
                     (b[12] << 8) | b[13], (b[14] << 8) | b[15]);
            c->port = (int)ntohs(a6->sin6_port);
        }
        /* link into LRU tail */
        c->prev = lp->lru.prev;
        c->next = &lp->lru;
        lp->lru.prev->next = c;
        lp->lru.prev = c;
        c->last_ms = weed_now_ms();
        struct epoll_event ev;
        memset(&ev, 0, sizeof(ev));
        ev.events = EPOLLIN | EPOLLRDHUP;
        ev.data.ptr = c;
        if (epoll_ctl(lp->epfd, EPOLL_CTL_ADD, fd, &ev) < 0) {
            weed_lru_unlink(c);
            close(fd);
            free(c);
        }
    }
}

static void weed_expire_idle(weed_loop *lp) {
    if (lp->idle_ms <= 0) return;
    int64_t cutoff = weed_now_ms() - lp->idle_ms;
    while (lp->lru.next != &lp->lru && lp->lru.next->last_ms < cutoff) {
        weed_conn *c = lp->lru.next;
        if (c->writing) {
            /* EPOLLOUT cadence cannot prove drain progress: TCP only
             * reports writable once the send queue falls below HALF
             * full, so a client sipping a multi-MB buffered body sees
             * zero events for whole idle windows.  send()/sendfile()
             * have no such threshold — they accept bytes whenever ANY
             * space exists — so probe by flushing: moved bytes = a
             * live, draining client (flush_step touches the LRU);
             * zero bytes across a full idle window = a true stall.
             * A stalled writer therefore dies within two idle
             * windows, mirroring the threaded arm's stall-retry
             * sendall. */
            if (weed_conn_flush_step(lp, c) < 0)
                continue;  /* left the loop (done+closing, or dead) */
            if (c->last_ms >= cutoff)
                continue;  /* progressed (or completed): re-read next */
        }
        weed_conn_destroy(lp, c, 1);
    }
}

/* tags for the two non-connection epoll registrations */
static int weed_tag_listen;
static int weed_tag_wake;

/* Run the loop until a byte arrives on wake_fd.  Returns 0 on clean
 * shutdown, -errno when setup fails.  listen_fd and wake_fd are NOT
 * closed (the embedder owns them); every connection fd is. */
static int weed_serve_loop(int listen_fd, int wake_fd, weed_serve_cbs *cbs,
                           long idle_ms, long max_reqs, int use_adm) {
    weed_loop lp;
    memset(&lp, 0, sizeof(lp));
    lp.listen_fd = listen_fd;
    lp.wake_fd = wake_fd;
    lp.cbs = cbs;
    lp.idle_ms = idle_ms;
    lp.max_reqs = max_reqs;
    lp.use_adm = use_adm;
    lp.lru.next = lp.lru.prev = &lp.lru;
    lp.epfd = epoll_create1(EPOLL_CLOEXEC);
    if (lp.epfd < 0) return -errno;

    int fl = fcntl(listen_fd, F_GETFL, 0);
    if (fl >= 0) fcntl(listen_fd, F_SETFL, fl | O_NONBLOCK);

    struct epoll_event ev;
    memset(&ev, 0, sizeof(ev));
    ev.events = EPOLLIN;
    ev.data.ptr = &weed_tag_listen;
    if (epoll_ctl(lp.epfd, EPOLL_CTL_ADD, listen_fd, &ev) < 0) {
        int e = errno;
        close(lp.epfd);
        return -e;
    }
    memset(&ev, 0, sizeof(ev));
    ev.events = EPOLLIN;
    ev.data.ptr = &weed_tag_wake;
    if (epoll_ctl(lp.epfd, EPOLL_CTL_ADD, wake_fd, &ev) < 0) {
        int e = errno;
        close(lp.epfd);
        return -e;
    }

    struct epoll_event events[WEED_SERVE_EVENTS];
    while (!lp.stop) {
        int timeout = -1;
        if (lp.idle_ms > 0 && lp.lru.next != &lp.lru) {
            int64_t dl = lp.lru.next->last_ms + lp.idle_ms - weed_now_ms();
            timeout = dl < 0 ? 0 : (dl > 1000 ? 1000 : (int)dl);
        }
        if (lp.listen_paused_until_ms) {
            int64_t dl = lp.listen_paused_until_ms - weed_now_ms();
            if (dl <= 0) {
                memset(&ev, 0, sizeof(ev));
                ev.events = EPOLLIN;
                ev.data.ptr = &weed_tag_listen;
                epoll_ctl(lp.epfd, EPOLL_CTL_ADD, listen_fd, &ev);
                lp.listen_paused_until_ms = 0;
            } else if (timeout < 0 || dl < timeout) {
                timeout = (int)dl;
            }
        }
        int n = epoll_wait(lp.epfd, events, WEED_SERVE_EVENTS, timeout);
        if (n < 0) {
            if (errno == EINTR) continue;
            break;
        }
        for (int i = 0; i < n && !lp.stop; i++) {
            void *tag = events[i].data.ptr;
            if (tag == &weed_tag_wake) {
                char drain[64];
                while (read(wake_fd, drain, sizeof(drain)) > 0) {}
                lp.stop = 1;
                break;
            }
            if (tag == &weed_tag_listen) {
                weed_accept_drain(&lp);
                continue;
            }
            weed_conn *c = (weed_conn *)tag;
            uint32_t evs = events[i].events;
            if (evs & (EPOLLERR | EPOLLHUP)) {
                weed_conn_destroy(&lp, c, 1);
                continue;
            }
            if (c->writing) {
                if (evs & EPOLLOUT) weed_conn_flush_step(&lp, c);
                continue;
            }
            if (evs & (EPOLLIN | EPOLLRDHUP)) weed_conn_read(&lp, c);
        }
        weed_expire_idle(&lp);
    }

    while (lp.lru.next != &lp.lru) weed_conn_destroy(&lp, lp.lru.next, 1);
    weed_cache_free(&lp);
    close(lp.epfd);
    return 0;
}

#endif /* WEED_SERVE_C */
