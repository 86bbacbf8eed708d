/* CPython binding for the epoll serving core (serve.c), the way
 * needle_ext.c binds post.c.
 *
 * loop(listen_fd, wake_fd, resolver, handoff, complete,
 *      idle_ms, max_reqs) -> None
 *
 * Runs the event loop with the GIL RELEASED; each callback re-takes it
 * via PyGILState_Ensure for exactly as long as the Python call lasts:
 *
 *   resolver(path, range, head_only, trace, if_none_match)
 *       -> None                        decline: hand the connection off
 *        | (status, prefix_bytes, body_bytes|None,
 *           fd, offset, count, close_fd, ctx)
 *        | (..., etag_bytes|None, prefix304_bytes|None, gen, cacheable)
 *                                      fast path: the loop writes
 *                                      prefix + Connection/Content-
 *                                      Length tail + body (bytes, or
 *                                      sendfile of count@offset from
 *                                      fd); ctx rides to complete().
 *                                      The widened 12-tuple lets the C
 *                                      loop answer If-None-Match 304s
 *                                      against etag via prefix304 and
 *                                      cache the plan (keyed by path,
 *                                      invalidated when the generation
 *                                      counter moves past gen)
 *   handoff(fd, pending_bytes, ip, port)
 *                                      ownership of fd transfers; the
 *                                      embedder re-parses `pending`
 *                                      (the current head onward) in
 *                                      the Python mini loop
 *   complete(ctx, status, resp_bytes, t_parse, t_resolve, t_send, ok)
 *                                      response finished (ok=False:
 *                                      the connection died mid-write)
 *
 * The resolver's returned tuple is held alive (one reference) until
 * complete() runs, which is what keeps the prefix/body buffers valid
 * while the loop drains them; complete() is guaranteed exactly once
 * per fast-path response, including on connection teardown and loop
 * exit.  A resolver/complete/handoff exception is reported via
 * sys.unraisablehook and degrades to decline/continue — a Python bug
 * must never wedge the accept path.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include "serve.c"

typedef struct {
    PyObject *resolver;
    PyObject *handoff;
    PyObject *complete;
} weed_glue;

static PyObject *glue_str_or_none(const char *p, size_t n) {
    if (p == NULL) Py_RETURN_NONE;
    return PyUnicode_DecodeLatin1(p, (Py_ssize_t)n, "replace");
}

static int glue_resolve(void *vctx, const weed_req *req, weed_resp *resp,
                        void **token) {
    weed_glue *g = (weed_glue *)vctx;
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = 0;
    PyObject *path = PyUnicode_DecodeLatin1(req->path, (Py_ssize_t)req->path_len,
                                            "replace");
    PyObject *range = glue_str_or_none(req->range, req->range_len);
    PyObject *trace = glue_str_or_none(req->trace, req->trace_len);
    PyObject *inm = glue_str_or_none(req->inm, req->inm_len);
    PyObject *r = NULL;
    if (path != NULL && range != NULL && trace != NULL && inm != NULL) {
        r = PyObject_CallFunctionObjArgs(
            g->resolver, path, range, req->head_only ? Py_True : Py_False,
            trace, inm, NULL);
    }
    Py_XDECREF(path);
    Py_XDECREF(range);
    Py_XDECREF(trace);
    Py_XDECREF(inm);
    if (r == NULL) {
        PyErr_WriteUnraisable(g->resolver);
    } else if (r == Py_None) {
        Py_DECREF(r);
    } else {
        /* the plan is an 8-tuple, or a 12-tuple carrying the
         * conditional-GET / plan-cache extras; manual unpack because
         * PyArg_ParseTuple insists on an exact length */
        Py_ssize_t n = PyTuple_Check(r) ? PyTuple_GET_SIZE(r) : -1;
        int ok = (n == 8 || n == 12);
        int status = 0, fd = -1, close_fd = 0, cacheable = 0;
        long long off = 0, count = 0;
        unsigned long long gen = 0;
        PyObject *prefix = NULL, *body = NULL, *etag = NULL, *p304 = NULL;
        if (ok) {
            status = (int)PyLong_AsLong(PyTuple_GET_ITEM(r, 0));
            prefix = PyTuple_GET_ITEM(r, 1);
            body = PyTuple_GET_ITEM(r, 2);
            fd = (int)PyLong_AsLong(PyTuple_GET_ITEM(r, 3));
            off = PyLong_AsLongLong(PyTuple_GET_ITEM(r, 4));
            count = PyLong_AsLongLong(PyTuple_GET_ITEM(r, 5));
            close_fd = PyObject_IsTrue(PyTuple_GET_ITEM(r, 6));
            ok = !PyErr_Occurred() && close_fd >= 0 &&
                 PyBytes_Check(prefix) &&
                 (body == Py_None || PyBytes_Check(body));
        }
        if (ok && n == 12) {
            etag = PyTuple_GET_ITEM(r, 8);
            p304 = PyTuple_GET_ITEM(r, 9);
            gen = PyLong_AsUnsignedLongLong(PyTuple_GET_ITEM(r, 10));
            cacheable = PyObject_IsTrue(PyTuple_GET_ITEM(r, 11));
            ok = !PyErr_Occurred() && cacheable >= 0 &&
                 (etag == Py_None || PyBytes_Check(etag)) &&
                 (p304 == Py_None || PyBytes_Check(p304));
        }
        if (ok) {
            resp->status = status;
            resp->prefix = (const uint8_t *)PyBytes_AS_STRING(prefix);
            resp->prefix_len = (size_t)PyBytes_GET_SIZE(prefix);
            if (body != Py_None) {
                resp->body = (const uint8_t *)PyBytes_AS_STRING(body);
                resp->body_len = (size_t)PyBytes_GET_SIZE(body);
            }
            resp->fd = fd;
            resp->off = (int64_t)off;
            resp->count = count < 0 ? 0 : (size_t)count;
            resp->close_fd = close_fd;
            if (etag != NULL && etag != Py_None) {
                resp->etag = (const uint8_t *)PyBytes_AS_STRING(etag);
                resp->etag_len = (size_t)PyBytes_GET_SIZE(etag);
            }
            if (p304 != NULL && p304 != Py_None) {
                resp->prefix304 = (const uint8_t *)PyBytes_AS_STRING(p304);
                resp->prefix304_len = (size_t)PyBytes_GET_SIZE(p304);
            }
            resp->gen = (uint64_t)gen;
            resp->cacheable = cacheable;
            *token = r;  /* keeps prefix/body/etag alive until complete() */
            rc = 1;
        } else {
            if (!PyErr_Occurred())
                PyErr_SetString(PyExc_TypeError,
                                "resolver plan must be an 8- or 12-tuple");
            PyErr_WriteUnraisable(g->resolver);
            if (fd >= 0 && close_fd > 0) close(fd);
            Py_DECREF(r);
        }
    }
    PyGILState_Release(st);
    return rc;
}

static void glue_handoff(void *vctx, int fd, const uint8_t *pending,
                         size_t len, const char *ip, int port, long nreqs) {
    weed_glue *g = (weed_glue *)vctx;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallFunction(g->handoff, "iy#sil", fd,
                                        (const char *)pending,
                                        (Py_ssize_t)len, ip, port, nreqs);
    if (r == NULL) {
        /* the embedder never took ownership: close here or leak */
        PyErr_WriteUnraisable(g->handoff);
        close(fd);
    } else {
        Py_DECREF(r);
    }
    PyGILState_Release(st);
}

static void glue_complete(void *vctx, void *token, int status,
                          size_t resp_bytes, double t_parse, double t_resolve,
                          double t_send, int ok) {
    weed_glue *g = (weed_glue *)vctx;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *tup = (PyObject *)token;
    PyObject *ctx = PyTuple_GET_ITEM(tup, 7); /* borrowed */
    PyObject *r = PyObject_CallFunction(
        g->complete, "OindddO", ctx, status, (Py_ssize_t)resp_bytes, t_parse,
        t_resolve, t_send, ok ? Py_True : Py_False);
    if (r == NULL) PyErr_WriteUnraisable(g->complete);
    else Py_DECREF(r);
    Py_DECREF(tup);
    PyGILState_Release(st);
}

static PyObject *py_loop(PyObject *Py_UNUSED(self), PyObject *args) {
    int listen_fd, wake_fd, use_adm = 0;
    PyObject *resolver, *handoff, *complete;
    long idle_ms = 0, max_reqs = 0;
    if (!PyArg_ParseTuple(args, "iiOOO|lli:loop", &listen_fd, &wake_fd,
                          &resolver, &handoff, &complete, &idle_ms,
                          &max_reqs, &use_adm))
        return NULL;
    if (!PyCallable_Check(resolver) || !PyCallable_Check(handoff) ||
        !PyCallable_Check(complete)) {
        PyErr_SetString(PyExc_TypeError, "callbacks must be callable");
        return NULL;
    }
    weed_glue g = {resolver, handoff, complete};
    weed_serve_cbs cbs;
    memset(&cbs, 0, sizeof(cbs));
    cbs.ctx = &g;
    cbs.resolve = glue_resolve;
    cbs.handoff = glue_handoff;
    cbs.complete = glue_complete;
    int rc;
    Py_BEGIN_ALLOW_THREADS
    rc = weed_serve_loop(listen_fd, wake_fd, &cbs, idle_ms, max_reqs,
                         use_adm);
    Py_END_ALLOW_THREADS
    if (rc < 0) {
        errno = -rc;
        return PyErr_SetFromErrno(PyExc_OSError);
    }
    Py_RETURN_NONE;
}

static PyObject *py_gen_bump(PyObject *Py_UNUSED(self),
                             PyObject *Py_UNUSED(args)) {
    return PyLong_FromUnsignedLongLong(
        (unsigned long long)weed_gen_bump());
}

static PyObject *py_gen_get(PyObject *Py_UNUSED(self),
                            PyObject *Py_UNUSED(args)) {
    return PyLong_FromUnsignedLongLong((unsigned long long)weed_gen_get());
}

static PyObject *py_serve_stats(PyObject *Py_UNUSED(self),
                                PyObject *Py_UNUSED(args)) {
    return Py_BuildValue(
        "{s:K,s:K,s:K,s:K,s:K,s:K,s:K}",
        "served",
        (unsigned long long)__atomic_load_n(&weed_stat_served,
                                            __ATOMIC_RELAXED),
        "handoffs",
        (unsigned long long)__atomic_load_n(&weed_stat_handoffs,
                                            __ATOMIC_RELAXED),
        "not_modified",
        (unsigned long long)__atomic_load_n(&weed_stat_304,
                                            __ATOMIC_RELAXED),
        "cache_hits",
        (unsigned long long)__atomic_load_n(&weed_stat_cache_hits,
                                            __ATOMIC_RELAXED),
        "cache_inserts",
        (unsigned long long)__atomic_load_n(&weed_stat_cache_inserts,
                                            __ATOMIC_RELAXED),
        "shed",
        (unsigned long long)__atomic_load_n(&weed_stat_shed,
                                            __ATOMIC_RELAXED),
        "generation", (unsigned long long)weed_gen_get());
}

static PyObject *py_shm_attach(PyObject *Py_UNUSED(self), PyObject *args) {
    const char *path;
    double rate, burst, retry_floor = 0.0;
    unsigned int nslots = 1024;
    if (!PyArg_ParseTuple(args, "sdd|dI:shm_attach", &path, &rate, &burst,
                          &retry_floor, &nslots))
        return NULL;
    int rc;
    Py_BEGIN_ALLOW_THREADS
    rc = weed_shm_attach(path, rate, burst, retry_floor, nslots);
    Py_END_ALLOW_THREADS
    if (rc < 0) {
        errno = -rc;
        return PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    }
    Py_RETURN_NONE;
}

static PyObject *py_shm_admit(PyObject *Py_UNUSED(self), PyObject *args) {
    const char *key;
    Py_ssize_t klen;
    if (!PyArg_ParseTuple(args, "s#:shm_admit", &key, &klen)) return NULL;
    if (!weed_shm_active()) {
        PyErr_SetString(PyExc_RuntimeError, "admission shm not attached");
        return NULL;
    }
    return PyFloat_FromDouble(weed_shm_admit(key, (size_t)klen));
}

static PyObject *py_shm_detach(PyObject *Py_UNUSED(self),
                               PyObject *Py_UNUSED(args)) {
    weed_shm_detach();
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"loop", py_loop, METH_VARARGS,
     "run the epoll serving loop until wake_fd is written"},
    {"gen_bump", py_gen_bump, METH_NOARGS,
     "advance the plan-cache generation counter (invalidates all entries)"},
    {"gen_get", py_gen_get, METH_NOARGS,
     "read the plan-cache generation counter"},
    {"serve_stats", py_serve_stats, METH_NOARGS,
     "process-wide C fast-path counters"},
    {"shm_attach", py_shm_attach, METH_VARARGS,
     "shm_attach(path, rate, burst, retry_floor=0.0, nslots=1024): map the "
     "shared admission token-bucket file (first writer's params win)"},
    {"shm_admit", py_shm_admit, METH_VARARGS,
     "shm_admit(key) -> 0.0 if admitted else suggested Retry-After seconds"},
    {"shm_detach", py_shm_detach, METH_NOARGS,
     "unmap the shared admission bucket"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_serve_ext", NULL, -1, methods,
    NULL, NULL, NULL, NULL};

PyMODINIT_FUNC PyInit__serve_ext(void) { return PyModule_Create(&moduledef); }
