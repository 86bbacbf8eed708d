/* CPython extension binding for the one-call needle serializer.
 *
 * ctypes costs ~5us of argument conversion per call with this many
 * fields — more than the serialization itself.  A METH_FASTCALL
 * extension keeps the binding under ~1us, which is what the volume
 * write hot path needs (needle_read_write.go:31 prepareWriteBuffer is
 * a single buffer pass in the reference too; see needle.c for the
 * record layout).
 *
 * encode(cookie, id, data, flags, name, mime, last_modified,
 *        ttl2_or_None, pairs, version, append_at_ns)
 *   -> (record_bytes, size, raw_crc)
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include "needle.c"
#include "post.c"

static PyObject *py_encode(PyObject *Py_UNUSED(self), PyObject *const *args,
                           Py_ssize_t nargs) {
    if (nargs != 11) {
        PyErr_SetString(PyExc_TypeError, "encode() takes 11 arguments");
        return NULL;
    }
    uint32_t cookie = (uint32_t)PyLong_AsUnsignedLongMask(args[0]);
    uint64_t id = PyLong_AsUnsignedLongLongMask(args[1]);
    uint32_t flags = (uint32_t)PyLong_AsUnsignedLongMask(args[3]);
    uint64_t last_modified = PyLong_AsUnsignedLongLongMask(args[6]);
    long version = PyLong_AsLong(args[9]);
    uint64_t append_at_ns = PyLong_AsUnsignedLongLongMask(args[10]);
    if (PyErr_Occurred()) return NULL;

    Py_buffer data, name, mime, pairs, ttl;
    ttl.buf = NULL;
    if (PyObject_GetBuffer(args[2], &data, PyBUF_SIMPLE) < 0) return NULL;
    if (PyObject_GetBuffer(args[4], &name, PyBUF_SIMPLE) < 0) goto err_data;
    if (PyObject_GetBuffer(args[5], &mime, PyBUF_SIMPLE) < 0) goto err_name;
    if (PyObject_GetBuffer(args[8], &pairs, PyBUF_SIMPLE) < 0) goto err_mime;
    if (args[7] != Py_None) {
        if (PyObject_GetBuffer(args[7], &ttl, PyBUF_SIMPLE) < 0) goto err_pairs;
        if (ttl.len < 2) {
            PyErr_SetString(PyExc_ValueError, "ttl must be 2 bytes");
            goto err_all;
        }
    }
    if (mime.len > 255) {
        PyErr_SetString(PyExc_ValueError, "mime longer than 255 bytes");
        goto err_all;
    }
    if (pairs.len >= 65536) {
        PyErr_SetString(PyExc_ValueError, "pairs longer than 64KB");
        goto err_all;
    }

    long maxlen = weed_needle_max_size((uint32_t)data.len, (uint32_t)name.len,
                                       (uint32_t)mime.len, (uint32_t)pairs.len);
    PyObject *out = PyBytes_FromStringAndSize(NULL, maxlen);
    if (out == NULL) goto err_all;

    uint32_t size, crc;
    long total;
    if (data.len >= 65536) {
        /* big payloads: the memcpy + CRC32-C dominates — run it
         * without the GIL so concurrent handler threads (and the
         * background scrubber) aren't serialized behind it. All
         * buffers are pinned by the Py_buffer views and `out` is not
         * yet visible to any other thread. */
        Py_BEGIN_ALLOW_THREADS
        total = weed_needle_encode(
            (uint8_t *)PyBytes_AS_STRING(out), cookie, id,
            (const uint8_t *)data.buf, (uint32_t)data.len, flags,
            (const uint8_t *)name.buf, (uint32_t)name.len,
            (const uint8_t *)mime.buf, (uint32_t)mime.len, last_modified,
            (const uint8_t *)ttl.buf, (const uint8_t *)pairs.buf,
            (uint32_t)pairs.len, (int)version, append_at_ns, &size, &crc,
            NULL);
        Py_END_ALLOW_THREADS
    } else {
        total = weed_needle_encode(
            (uint8_t *)PyBytes_AS_STRING(out), cookie, id,
            (const uint8_t *)data.buf, (uint32_t)data.len, flags,
            (const uint8_t *)name.buf, (uint32_t)name.len,
            (const uint8_t *)mime.buf, (uint32_t)mime.len, last_modified,
            (const uint8_t *)ttl.buf, (const uint8_t *)pairs.buf,
            (uint32_t)pairs.len, (int)version, append_at_ns, &size, &crc,
            NULL);
    }
    if (ttl.buf) PyBuffer_Release(&ttl);
    PyBuffer_Release(&pairs);
    PyBuffer_Release(&mime);
    PyBuffer_Release(&name);
    PyBuffer_Release(&data);
    if (total < 0) {
        Py_DECREF(out);
        PyErr_SetString(PyExc_ValueError, "unsupported needle version");
        return NULL;
    }
    if (_PyBytes_Resize(&out, total) < 0) return NULL;
    return Py_BuildValue("(NIk)", out, size, (unsigned long)crc);

err_all:
    if (ttl.buf) PyBuffer_Release(&ttl);
err_pairs:
    PyBuffer_Release(&pairs);
err_mime:
    PyBuffer_Release(&mime);
err_name:
    PyBuffer_Release(&name);
err_data:
    PyBuffer_Release(&data);
    return NULL;
}

/* decode(blob, version, expected_size) -> (cookie, id, size, data,
 *     flags, name, mime, last_modified, ttl2|None, pairs, append_at_ns,
 *     raw_crc)
 * expected_size < 0 skips the index-size cross-check.  Raises
 * ValueError with the same messages Needle.from_bytes uses (the Python
 * wrapper re-raises them as CorruptNeedle). */
static PyObject *py_decode(PyObject *Py_UNUSED(self), PyObject *const *args,
                           Py_ssize_t nargs) {
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError, "decode() takes 3 arguments");
        return NULL;
    }
    Py_buffer blob;
    if (PyObject_GetBuffer(args[0], &blob, PyBUF_SIMPLE) < 0) return NULL;
    long version = PyLong_AsLong(args[1]);
    long long expected = PyLong_AsLongLong(args[2]);
    if (PyErr_Occurred()) {
        PyBuffer_Release(&blob);
        return NULL;
    }
    const uint8_t *b = (const uint8_t *)blob.buf;
    Py_ssize_t len = blob.len;
    const char *err = NULL;
    PyObject *result = NULL;

    if (len < HEADER) {
        err = "needle header truncated";
        goto out;
    }
    uint32_t cookie = (uint32_t)b[0] << 24 | b[1] << 16 | b[2] << 8 | b[3];
    uint64_t id = 0;
    for (int i = 0; i < 8; i++) id = id << 8 | b[4 + i];
    uint32_t size = (uint32_t)b[12] << 24 | b[13] << 16 | b[14] << 8 | b[15];
    if (expected >= 0 && size != (uint64_t)expected) {
        err = "entry not found: size mismatch";
        goto out;
    }
    Py_ssize_t need = HEADER + (Py_ssize_t)size + CHECKSUM;
    if (version == 3) need += V3_TIMESTAMP;
    if (len < need) {
        err = "needle record truncated";
        goto out;
    }

    const uint8_t *body = b + HEADER;
    const uint8_t *data_p = NULL, *name_p = NULL, *mime_p = NULL,
                  *pairs_p = NULL, *ttl_p = NULL;
    uint32_t data_len = 0, name_len = 0, mime_len = 0, pairs_len = 0;
    uint64_t last_modified = 0;
    uint32_t flags = 0;

    if (version == 1) {
        data_p = body;
        data_len = size;
    } else if (version == 2 || version == 3) {
        uint32_t idx = 0, end = size;
        if (idx < end) {
            if (idx + 4 > end) {
                err = "data_size out of range";
                goto out;
            }
            data_len = (uint32_t)body[idx] << 24 | body[idx + 1] << 16 |
                       body[idx + 2] << 8 | body[idx + 3];
            idx += 4;
            if ((uint64_t)data_len + idx > end) {
                err = "data_size out of range";
                goto out;
            }
            data_p = body + idx;
            idx += data_len;
            if (idx >= end) {
                err = "flags byte out of range";
                goto out;
            }
            flags = body[idx++];
        }
        if (idx < end && (flags & 0x02)) { /* name */
            name_len = body[idx++];
            if ((uint64_t)name_len + idx > end) {
                err = "name out of range";
                goto out;
            }
            name_p = body + idx;
            idx += name_len;
        }
        if (idx < end && (flags & 0x04)) { /* mime */
            mime_len = body[idx++];
            if ((uint64_t)mime_len + idx > end) {
                err = "mime out of range";
                goto out;
            }
            mime_p = body + idx;
            idx += mime_len;
        }
        if (idx < end && (flags & 0x08)) { /* last_modified, 5B BE */
            if (idx + 5 > end) {
                err = "last_modified out of range";
                goto out;
            }
            for (int i = 0; i < 5; i++)
                last_modified = last_modified << 8 | body[idx + i];
            idx += 5;
        }
        if (idx < end && (flags & 0x10)) { /* ttl 2B */
            if (idx + 2 > end) {
                err = "ttl out of range";
                goto out;
            }
            ttl_p = body + idx;
            idx += 2;
        }
        if (idx < end && (flags & 0x20)) { /* pairs */
            if (idx + 2 > end) {
                err = "pairs_size out of range";
                goto out;
            }
            pairs_len = (uint32_t)body[idx] << 8 | body[idx + 1];
            idx += 2;
            if ((uint64_t)pairs_len + idx > end) {
                err = "pairs out of range";
                goto out;
            }
            pairs_p = body + idx;
            idx += pairs_len;
        }
    } else {
        err = "unsupported needle version";
        goto out;
    }

    uint32_t crc = 0;
    if (size > 0) {
        uint32_t stored = (uint32_t)b[HEADER + size] << 24 |
                          b[HEADER + size + 1] << 16 |
                          b[HEADER + size + 2] << 8 | b[HEADER + size + 3];
        if (data_len >= 65536) {
            /* GIL released for the big-payload CRC: the verify of a
             * multi-MiB needle is milliseconds of pure C that would
             * otherwise stall every other handler thread (and inflate
             * foreground p99 whenever the scrubber is re-reading). The
             * source buffer is pinned by the caller's Py_buffer. */
            Py_BEGIN_ALLOW_THREADS
            crc = weed_crc32c(0, data_p, data_len);
            Py_END_ALLOW_THREADS
        } else {
            crc = weed_crc32c(0, data_p, data_len);
        }
        if (stored != masked(crc)) {
            err = "CRC error! Data On Disk Corrupted";
            goto out;
        }
    }
    uint64_t append_at_ns = 0;
    if (version == 3) {
        const uint8_t *ts = b + HEADER + size + CHECKSUM;
        for (int i = 0; i < 8; i++) append_at_ns = append_at_ns << 8 | ts[i];
    }

    result = Py_BuildValue(
        "(IKIy#Iy#y#KOy#KI)", (unsigned int)cookie,
        (unsigned long long)id, (unsigned int)size,
        (const char *)(data_p ? (const char *)data_p : ""),
        (Py_ssize_t)data_len, (unsigned int)flags,
        (const char *)(name_p ? (const char *)name_p : ""),
        (Py_ssize_t)name_len,
        (const char *)(mime_p ? (const char *)mime_p : ""),
        (Py_ssize_t)mime_len, (unsigned long long)last_modified, Py_None,
        (const char *)(pairs_p ? (const char *)pairs_p : ""),
        (Py_ssize_t)pairs_len, (unsigned long long)append_at_ns,
        (unsigned int)crc);
    if (result && ttl_p) {
        PyObject *ttl_bytes = PyBytes_FromStringAndSize((const char *)ttl_p, 2);
        if (ttl_bytes == NULL) {
            Py_CLEAR(result);
        } else {
            PyTuple_SetItem(result, 8, ttl_bytes); /* steals ref */
        }
    }
out:
    PyBuffer_Release(&blob);
    if (err) {
        PyErr_SetString(PyExc_ValueError, err);
        return NULL;
    }
    return result;
}

/* post(body, content_type, raw_gzipped, q_filename, url_filename,
 *      pairs, base_flags, cookie, id, version, last_modified,
 *      append_at_ns, fd, offset, fix_jpg)
 *   -> None                         needs the Python slow path
 *    | (reply_bytes, total, size, (parse_s, assemble_s, crc_s,
 *       pwrite_s, reply_s))         record pwritten at `offset`;
 *      the 5-double tuple is the tracing plane's per-stage wall time
 *   raises OSError when the pwrite itself fails (errno preserved).
 *
 * The whole hot span — multipart/raw extraction, needle assembly, CRC,
 * pwrite, reply formatting — runs with the GIL RELEASED (post.c); the
 * caller holds the volume lock, which a GIL release does not drop, so
 * the single-writer-per-volume invariant is untouched. */
static PyObject *py_post(PyObject *Py_UNUSED(self), PyObject *const *args,
                         Py_ssize_t nargs) {
    if (nargs != 15) {
        PyErr_SetString(PyExc_TypeError, "post() takes 15 arguments");
        return NULL;
    }
    weed_post_req r;
    memset(&r, 0, sizeof(r));
    r.raw_gzipped = (int)PyLong_AsLong(args[2]);
    r.base_flags = (uint32_t)PyLong_AsUnsignedLongMask(args[6]);
    r.cookie = (uint32_t)PyLong_AsUnsignedLongMask(args[7]);
    r.id = PyLong_AsUnsignedLongLongMask(args[8]);
    r.version = (int)PyLong_AsLong(args[9]);
    r.last_modified = PyLong_AsUnsignedLongLongMask(args[10]);
    r.append_at_ns = PyLong_AsUnsignedLongLongMask(args[11]);
    r.fd = (int)PyLong_AsLong(args[12]);
    r.offset = (int64_t)PyLong_AsLongLong(args[13]);
    r.fix_jpg = (int)PyLong_AsLong(args[14]);
    if (PyErr_Occurred()) return NULL;

    Py_buffer body, ctype, qname, uname, pairs;
    if (PyObject_GetBuffer(args[0], &body, PyBUF_SIMPLE) < 0) return NULL;
    if (PyObject_GetBuffer(args[1], &ctype, PyBUF_SIMPLE) < 0) goto err_body;
    if (PyObject_GetBuffer(args[3], &qname, PyBUF_SIMPLE) < 0) goto err_ctype;
    if (PyObject_GetBuffer(args[4], &uname, PyBUF_SIMPLE) < 0) goto err_qname;
    if (PyObject_GetBuffer(args[5], &pairs, PyBUF_SIMPLE) < 0) goto err_uname;

    r.body = (const uint8_t *)body.buf;
    r.body_len = (size_t)body.len;
    r.ctype = (const uint8_t *)ctype.buf;
    r.ctype_len = (size_t)ctype.len;
    r.q_name = (const uint8_t *)qname.buf;
    r.q_name_len = (size_t)qname.len;
    r.url_name = (const uint8_t *)uname.buf;
    r.url_name_len = (size_t)uname.len;
    r.pairs = (const uint8_t *)pairs.buf;
    r.pairs_len = (size_t)pairs.len;

    int rc;
    Py_BEGIN_ALLOW_THREADS
    rc = weed_post(&r);
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&pairs);
    PyBuffer_Release(&uname);
    PyBuffer_Release(&qname);
    PyBuffer_Release(&ctype);
    PyBuffer_Release(&body);

    if (rc == WEED_POST_DECLINE) Py_RETURN_NONE;
    if (rc == WEED_POST_IOERR) {
        errno = r.io_errno;
        return PyErr_SetFromErrno(PyExc_OSError);
    }
    return Py_BuildValue("(y#lI(ddddd))", r.reply, (Py_ssize_t)r.reply_len,
                         r.total, (unsigned int)r.size, r.st_parse,
                         r.st_assemble, r.st_crc, r.st_pwrite, r.st_reply);

    /* unwind: each label releases ITS OWN buffer then falls through,
     * so a GetBuffer failure on arg N releases exactly args 0..N-1 */
err_uname:
    PyBuffer_Release(&uname);
err_qname:
    PyBuffer_Release(&qname);
err_ctype:
    PyBuffer_Release(&ctype);
err_body:
    PyBuffer_Release(&body);
    return NULL;
}

/* METH_FASTCALL entries are _PyCFunctionFast, not PyCFunction; the
 * double cast through a generic function pointer is the CPython-
 * sanctioned spelling (what 3.11's _PyCFunction_CAST expands to) and
 * keeps -Wcast-function-type quiet under -Werror. */
#define FASTCALL_CAST(f) ((PyCFunction)(void (*)(void))(f))

static PyMethodDef methods[] = {
    {"encode", FASTCALL_CAST(py_encode), METH_FASTCALL,
     "serialize one needle record"},
    {"decode", FASTCALL_CAST(py_decode), METH_FASTCALL,
     "parse + CRC-verify one needle record"},
    {"post", FASTCALL_CAST(py_post), METH_FASTCALL,
     "one-pass volume POST: extract + assemble + CRC + pwrite + reply"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_needle_ext", NULL, -1, methods,
    NULL, NULL, NULL, NULL};

PyMODINIT_FUNC PyInit__needle_ext(void) { return PyModule_Create(&moduledef); }
