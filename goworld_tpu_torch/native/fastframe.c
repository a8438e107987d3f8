/* _fastframe — C hot path for the wire framing every process runs.
 *
 * The reference's runtime is a compiled binary (Go); the Python port's
 * per-packet costs (two asyncio awaits + struct packs + slicing per
 * packet) dominate gate/dispatcher CPU at fleet scale (BENCH_NOTES:
 * control-plane profile at 100 bots — framing + zlib + socket sends).
 * This module batch-parses an entire received chunk in one call and
 * builds framed send buffers without intermediate Python objects.
 *
 * Wire format (netutil/packet_conn.py, PacketConnection.go:50-186):
 *   [u32 LE length | bit31 = zlib flag | bit30 = snappy flag]
 *   [u16 LE msgtype][payload]
 * Length counts msgtype + payload (the post-decompress size must also
 * stay within max_packet — decompression-bomb guard, matching the Python
 * recv_packet's bounded inflate).
 *
 * Snappy is the reference's actual gate↔client codec (ClientProxy.go:
 * 42-45); the block-format codec below is from scratch against the
 * public Snappy format description (varint uncompressed-length preamble,
 * then literal/copy elements) — the library isn't in the image.
 *
 * API (mirrored exactly by native/pyframe.py — the parity fuzz suite in
 * tests/test_native.py drives both):
 *   split(data: bytes, max_packet: int) -> (frames, consumed, error)
 *       frames = list[(msgtype: int, payload: bytes)], consumed = int
 *       (caller keeps data[consumed:] as the remainder), error = None or
 *       a str describing the malformed frame parsing STOPPED at (bad
 *       length, bad compressed stream, bounded-decompress overflow).
 *       Frames before the malformed one are still returned so no valid
 *       packet is lost to a chunk boundary; the caller treats error as
 *       connection-fatal.
 *   pack(msgtype: int, payload: bytes, compress: int, threshold: int,
 *        max_packet: int) -> bytes
 *       One framed buffer; compress = 0 off, 1 zlib level 1, 2 snappy —
 *       applied when the body reaches threshold and the codec actually
 *       shrinks it. ValueError on msgtype outside u16 or oversize body.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>
#include <zlib.h>

#define COMPRESSED_BIT 0x80000000u /* zlib */
#define SNAPPY_BIT 0x40000000u
#define LEN_MASK 0x3fffffffu

static uint32_t rd_u32le(const unsigned char *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}

/* --- snappy block codec -------------------------------------------------- */

#define SNAPPY_BLOCK 32768 /* fragment size: offsets always fit 2 bytes */
#define SNAPPY_HASH_BITS 14

static unsigned snappy_hash(uint32_t v) {
    return (unsigned)((v * 0x1e35a7bdu) >> (32 - SNAPPY_HASH_BITS));
}

/* Every emit helper is HARD-BOUNDED by the caller's buffer end and
 * signals overflow by returning NULL: pack() only keeps compressed
 * output that is SMALLER than the input, so the encoder writes into an
 * input-sized scratch and treats hitting its end as "incompressible" —
 * no worst-case-expansion arithmetic to get wrong (code-review r5
 * reproduced a heap overrun in the previous bound-based version with a
 * crafted +1-byte-per-65 adversarial payload). */
static unsigned char *snappy_emit_literal(unsigned char *w,
                                          const unsigned char *end,
                                          const unsigned char *s,
                                          Py_ssize_t len) {
    if (w == NULL || len <= 0) return w;
    Py_ssize_t n1 = len - 1;
    if (end - w < len + 3) return NULL;
    if (n1 < 60) {
        *w++ = (unsigned char)(n1 << 2);
    } else if (n1 < 0x100) {
        *w++ = 60 << 2;
        *w++ = (unsigned char)n1;
    } else { /* blocks cap at 32768: two bytes always suffice */
        *w++ = 61 << 2;
        *w++ = (unsigned char)(n1 & 0xff);
        *w++ = (unsigned char)((n1 >> 8) & 0xff);
    }
    memcpy(w, s, (size_t)len);
    return w + len;
}

static unsigned char *snappy_emit_copy(unsigned char *w,
                                       const unsigned char *end,
                                       Py_ssize_t off, Py_ssize_t len) {
    if (w == NULL) return NULL;
    if (end - w < 3 * (len / 64 + 2)) return NULL;
    while (len >= 68) {
        *w++ = (63 << 2) | 2;
        *w++ = (unsigned char)(off & 0xff);
        *w++ = (unsigned char)((off >> 8) & 0xff);
        len -= 64;
    }
    if (len > 64) {
        *w++ = (59 << 2) | 2;
        *w++ = (unsigned char)(off & 0xff);
        *w++ = (unsigned char)((off >> 8) & 0xff);
        len -= 60;
    }
    if (len <= 11 && off < 2048) {
        *w++ = (unsigned char)(1 | ((len - 4) << 2) | ((off >> 8) << 5));
        *w++ = (unsigned char)(off & 0xff);
    } else {
        *w++ = (unsigned char)(((len - 1) << 2) | 2);
        *w++ = (unsigned char)(off & 0xff);
        *w++ = (unsigned char)((off >> 8) & 0xff);
    }
    return w;
}

/* Greedy 4-byte-hash matcher over 32 KiB fragments (same strategy as the
 * Python reference implementation — byte-identical output is NOT required
 * between the two encoders, only decode(encode(x)) == x on both; the
 * parity fuzz cross-decodes to enforce exactly that). Returns the
 * compressed size, or -1 when the output would reach dst_cap (caller
 * ships uncompressed — identical outcome to "didn't shrink"). */
static Py_ssize_t snappy_encode(const unsigned char *src, Py_ssize_t n,
                                unsigned char *dst, Py_ssize_t dst_cap) {
    unsigned char *w = dst;
    const unsigned char *end = dst + dst_cap;
    Py_ssize_t v = n;
    while (v >= 0x80) {
        if (w >= end) return -1;
        *w++ = (unsigned char)((v & 0x7f) | 0x80);
        v >>= 7;
    }
    if (w >= end) return -1;
    *w++ = (unsigned char)v;
    static _Thread_local uint16_t table[1 << SNAPPY_HASH_BITS];
    Py_ssize_t i = 0;
    while (i < n) {
        Py_ssize_t base = i;
        Py_ssize_t block_end =
            i + SNAPPY_BLOCK < n ? i + SNAPPY_BLOCK : n;
        memset(table, 0xff, sizeof(table));
        Py_ssize_t lit_start = i;
        while (i < block_end) {
            if (block_end - i < 4) {
                i = block_end;
                break;
            }
            uint32_t key = rd_u32le(src + i);
            unsigned h = snappy_hash(key);
            Py_ssize_t cand = table[h] == 0xffff
                                  ? -1
                                  : base + (Py_ssize_t)table[h];
            table[h] = (uint16_t)(i - base);
            if (cand >= base && cand < i &&
                rd_u32le(src + cand) == key) {
                w = snappy_emit_literal(w, end, src + lit_start,
                                        i - lit_start);
                Py_ssize_t m = i + 4, c = cand + 4;
                while (m < block_end && src[m] == src[c]) {
                    m++;
                    c++;
                }
                w = snappy_emit_copy(w, end, i - cand, m - i);
                if (w == NULL) return -1;
                i = m;
                lit_start = i;
            } else {
                i++;
            }
        }
        w = snappy_emit_literal(w, end, src + lit_start,
                                block_end - lit_start);
        if (w == NULL) return -1;
    }
    return w - dst;
}

/* Bounded snappy decode into a fresh bytes object; NULL + ValueError on
 * malformed input or when the declared size exceeds cap (bomb guard). */
static PyObject *snappy_decode_bounded(const unsigned char *src,
                                       Py_ssize_t n, Py_ssize_t cap) {
    Py_ssize_t i = 0;
    uint64_t ulen = 0;
    int shift = 0;
    for (;;) {
        if (i >= n || shift > 31) {
            PyErr_SetString(PyExc_ValueError, "bad snappy preamble");
            return NULL;
        }
        unsigned char b = src[i++];
        ulen |= (uint64_t)(b & 0x7f) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    if ((Py_ssize_t)ulen > cap) {
        PyErr_SetString(PyExc_ValueError,
                        "compressed packet exceeds size cap");
        return NULL;
    }
    /* Grow geometrically toward the declared size instead of trusting a
     * 5-byte frame's preamble with a cap-sized allocation up front —
     * same anti-bomb allocation profile as inflate_bounded above
     * (code-review r5). Every write is still bounded by `total`, so a
     * stream that lies about ulen fails validation, never overruns. */
    Py_ssize_t total = (Py_ssize_t)ulen;
    Py_ssize_t size = n * 4 + 64;
    if (size > total) size = total;
    PyObject *out_obj = PyBytes_FromStringAndSize(NULL, size);
    if (out_obj == NULL) return NULL;
    unsigned char *out = (unsigned char *)PyBytes_AS_STRING(out_obj);
    Py_ssize_t pos = 0;
#define SNAPPY_ENSURE(need)                                               \
    do {                                                                  \
        if (pos + (need) > total) goto bad;                               \
        if (pos + (need) > size) {                                        \
            while (size < pos + (need))                                   \
                size = size * 4 <= total ? size * 4 : total;              \
            if (_PyBytes_Resize(&out_obj, size) != 0) return NULL;        \
            out = (unsigned char *)PyBytes_AS_STRING(out_obj);            \
        }                                                                 \
    } while (0)
    while (i < n) {
        unsigned char t = src[i++];
        unsigned typ = t & 3;
        if (typ == 0) { /* literal */
            Py_ssize_t ln = t >> 2;
            if (ln >= 60) {
                Py_ssize_t nb = ln - 59;
                if (i + nb > n) goto bad;
                ln = 0;
                for (Py_ssize_t k = 0; k < nb; k++)
                    ln |= (Py_ssize_t)src[i + k] << (8 * k);
                i += nb;
            }
            ln += 1;
            if (i + ln > n || pos + ln > total) goto bad;
            SNAPPY_ENSURE(ln);
            memcpy(out + pos, src + i, (size_t)ln);
            pos += ln;
            i += ln;
            continue;
        }
        Py_ssize_t ln, off;
        if (typ == 1) {
            if (i >= n) goto bad;
            ln = ((t >> 2) & 7) + 4;
            off = ((Py_ssize_t)(t >> 5) << 8) | src[i];
            i += 1;
        } else if (typ == 2) {
            if (i + 2 > n) goto bad;
            ln = (t >> 2) + 1;
            off = (Py_ssize_t)src[i] | ((Py_ssize_t)src[i + 1] << 8);
            i += 2;
        } else {
            if (i + 4 > n) goto bad;
            ln = (t >> 2) + 1;
            off = (Py_ssize_t)rd_u32le(src + i);
            i += 4;
        }
        if (off == 0 || off > pos || pos + ln > total) goto bad;
        SNAPPY_ENSURE(ln);
        if (off >= ln) {
            memcpy(out + pos, out + pos - off, (size_t)ln);
        } else { /* overlapping copy replicates the tail pattern */
            for (Py_ssize_t k = 0; k < ln; k++)
                out[pos + k] = out[pos + k - off];
        }
        pos += ln;
    }
    if (pos != total) goto bad;
    if (size != total && _PyBytes_Resize(&out_obj, pos) != 0) return NULL;
    return out_obj;
bad:
    Py_DECREF(out_obj);
    PyErr_SetString(PyExc_ValueError, "bad snappy stream");
    return NULL;
#undef SNAPPY_ENSURE
}

/* Bounded inflate of src[0..n) into a fresh bytes object of at most cap
 * bytes. The output buffer starts small (most compressed packets are
 * small) and grows geometrically up to cap — never a cap-sized (25 MB)
 * allocation per tiny frame. Returns NULL with ValueError set on any
 * zlib error or cap overflow. */
static PyObject *inflate_bounded(const unsigned char *src, Py_ssize_t n,
                                 Py_ssize_t cap) {
    Py_ssize_t size = n * 4 + 64;
    if (size > cap) size = cap;
    for (;;) {
        PyObject *out = PyBytes_FromStringAndSize(NULL, size);
        if (out == NULL) return NULL;
        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        if (inflateInit(&zs) != Z_OK) {
            Py_DECREF(out);
            PyErr_SetString(PyExc_ValueError, "inflateInit failed");
            return NULL;
        }
        zs.next_in = (Bytef *)src;
        zs.avail_in = (uInt)n;
        zs.next_out = (Bytef *)PyBytes_AS_STRING(out);
        zs.avail_out = (uInt)size;
        int rc = inflate(&zs, Z_FINISH);
        Py_ssize_t produced = size - (Py_ssize_t)zs.avail_out;
        inflateEnd(&zs);
        if (rc == Z_STREAM_END) {
            if (_PyBytes_Resize(&out, produced) != 0) return NULL;
            return out;
        }
        Py_DECREF(out);
        int ran_out = (rc == Z_BUF_ERROR || rc == Z_OK) && zs.avail_out == 0;
        if (ran_out && size < cap) {
            size = size * 4 <= cap ? size * 4 : cap; /* grow, retry */
            continue;
        }
        PyErr_SetString(PyExc_ValueError,
                        ran_out ? "compressed packet exceeds size cap"
                                : "bad compressed packet");
        return NULL;
    }
}

static PyObject *fastframe_split(PyObject *self, PyObject *args) {
    Py_buffer view;
    Py_ssize_t max_packet;
    if (!PyArg_ParseTuple(args, "y*n", &view, &max_packet)) return NULL;
    const unsigned char *buf = (const unsigned char *)view.buf;
    Py_ssize_t len = view.len;
    Py_ssize_t off = 0;
    const char *err = NULL; /* static message: stop-and-report, not raise */
    PyObject *err_obj = NULL; /* owned message from a raising helper */

    PyObject *frames = PyList_New(0);
    if (frames == NULL) {
        PyBuffer_Release(&view);
        return NULL;
    }
    while (len - off >= 4) {
        uint32_t raw = rd_u32le(buf + off);
        int is_zlib = (raw & COMPRESSED_BIT) != 0;
        int is_snappy = (raw & SNAPPY_BIT) != 0;
        Py_ssize_t body_len = (Py_ssize_t)(raw & LEN_MASK);
        if (is_zlib && is_snappy) {
            err = "bad packet flags";
            break;
        }
        if (body_len < 2 || body_len > max_packet) {
            err_obj = PyUnicode_FromFormat("bad packet length %zd", body_len);
            if (err_obj == NULL) goto fail;
            break;
        }
        if (len - off - 4 < body_len) break; /* incomplete frame */
        const unsigned char *body = buf + off + 4;
        PyObject *payload;
        unsigned int msgtype;
        if (is_zlib || is_snappy) {
            PyObject *inflated =
                is_zlib ? inflate_bounded(body, body_len, max_packet)
                        : snappy_decode_bounded(body, body_len, max_packet);
            if (inflated == NULL) {
                /* Convert the helper's ValueError into the stop-and-
                 * report contract (frames so far still delivered). */
                PyObject *tp, *val, *tb;
                PyErr_Fetch(&tp, &val, &tb);
                err_obj = val ? PyObject_Str(val) : NULL;
                Py_XDECREF(tp);
                Py_XDECREF(val);
                Py_XDECREF(tb);
                if (err_obj == NULL) err = "bad compressed packet";
                break;
            }
            Py_ssize_t ilen = PyBytes_GET_SIZE(inflated);
            if (ilen < 2) {
                Py_DECREF(inflated);
                err = "bad decompressed length";
                break;
            }
            const unsigned char *ib =
                (const unsigned char *)PyBytes_AS_STRING(inflated);
            msgtype = (unsigned int)ib[0] | ((unsigned int)ib[1] << 8);
            payload = PyBytes_FromStringAndSize((const char *)ib + 2,
                                                ilen - 2);
            Py_DECREF(inflated);
        } else {
            msgtype = (unsigned int)body[0] | ((unsigned int)body[1] << 8);
            payload = PyBytes_FromStringAndSize((const char *)body + 2,
                                                body_len - 2);
        }
        if (payload == NULL) goto fail;
        PyObject *tup = Py_BuildValue("(IN)", msgtype, payload);
        if (tup == NULL) goto fail;
        int rc = PyList_Append(frames, tup);
        Py_DECREF(tup);
        if (rc != 0) goto fail;
        off += 4 + body_len;
    }
    PyBuffer_Release(&view);
    if (err_obj != NULL) return Py_BuildValue("(NnN)", frames, off, err_obj);
    if (err != NULL) return Py_BuildValue("(Nns)", frames, off, err);
    return Py_BuildValue("(NnO)", frames, off, Py_None);
fail:
    Py_XDECREF(err_obj);
    Py_DECREF(frames);
    PyBuffer_Release(&view);
    return NULL;
}

static PyObject *fastframe_pack(PyObject *self, PyObject *args) {
    unsigned int msgtype;
    Py_buffer view;
    int compress; /* 0 off, 1 zlib, 2 snappy ("i": True coerces to 1) */
    Py_ssize_t threshold, max_packet;
    if (!PyArg_ParseTuple(args, "Iy*inn", &msgtype, &view, &compress,
                          &threshold, &max_packet))
        return NULL;
    if (msgtype > 0xFFFF) {
        PyBuffer_Release(&view);
        PyErr_Format(PyExc_ValueError, "msgtype %u out of u16 range",
                     msgtype);
        return NULL;
    }
    Py_ssize_t plen = view.len;
    Py_ssize_t body_len = 2 + plen;
    if (body_len > max_packet) {
        PyBuffer_Release(&view);
        PyErr_Format(PyExc_ValueError, "packet too large: %zd", body_len);
        return NULL;
    }
    uint32_t flag = 0;

    if (compress == 2 && body_len >= threshold) {
        /* Snappy (reference gate codec): encode [msgtype][payload] into an
         * input-sized scratch; the encoder hard-bounds itself against it
         * and returns -1 on reaching the end (≥ input size would be
         * discarded anyway — only keep output that SHRINKS). */
        unsigned char *tmp = (unsigned char *)PyMem_Malloc(
            (size_t)body_len);
        if (tmp == NULL) {
            PyBuffer_Release(&view);
            return PyErr_NoMemory();
        }
        unsigned char *cbody = (unsigned char *)PyMem_Malloc(
            (size_t)body_len);
        if (cbody == NULL) {
            PyMem_Free(tmp);
            PyBuffer_Release(&view);
            return PyErr_NoMemory();
        }
        cbody[0] = (unsigned char)(msgtype & 0xff);
        cbody[1] = (unsigned char)((msgtype >> 8) & 0xff);
        memcpy(cbody + 2, view.buf, (size_t)plen);
        Py_ssize_t clen = snappy_encode(cbody, body_len, tmp, body_len);
        PyMem_Free(cbody);
        if (clen >= 0 && clen < body_len) {
            PyObject *out = PyBytes_FromStringAndSize(NULL, 4 + clen);
            if (out == NULL) {
                PyMem_Free(tmp);
                PyBuffer_Release(&view);
                return NULL;
            }
            unsigned char *w = (unsigned char *)PyBytes_AS_STRING(out);
            uint32_t raw = (uint32_t)clen | SNAPPY_BIT;
            w[0] = raw & 0xff;
            w[1] = (raw >> 8) & 0xff;
            w[2] = (raw >> 16) & 0xff;
            w[3] = (raw >> 24) & 0xff;
            memcpy(w + 4, tmp, (size_t)clen);
            PyMem_Free(tmp);
            PyBuffer_Release(&view);
            return out;
        }
        PyMem_Free(tmp);
    } else if (compress && body_len >= threshold) {
        /* Deflate [msgtype][payload] at level 1 (KCP/zlib parity with the
         * Python path); keep only if it actually shrinks. */
        uLong bound = compressBound((uLong)body_len);
        PyObject *tmp = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)bound);
        if (tmp == NULL) {
            PyBuffer_Release(&view);
            return NULL;
        }
        unsigned char hdr[2] = {(unsigned char)(msgtype & 0xff),
                                (unsigned char)((msgtype >> 8) & 0xff)};
        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        int ok = deflateInit(&zs, 1) == Z_OK;
        Py_ssize_t clen = 0;
        if (ok) {
            zs.next_out = (Bytef *)PyBytes_AS_STRING(tmp);
            zs.avail_out = (uInt)bound;
            zs.next_in = hdr;
            zs.avail_in = 2;
            ok = deflate(&zs, Z_NO_FLUSH) == Z_OK;
            if (ok) {
                zs.next_in = (Bytef *)view.buf;
                zs.avail_in = (uInt)plen;
                ok = deflate(&zs, Z_FINISH) == Z_STREAM_END;
            }
            clen = (Py_ssize_t)zs.total_out;
            deflateEnd(&zs);
        }
        if (ok && clen < body_len) {
            PyObject *out = PyBytes_FromStringAndSize(NULL, 4 + clen);
            if (out == NULL) {
                Py_DECREF(tmp);
                PyBuffer_Release(&view);
                return NULL;
            }
            unsigned char *w = (unsigned char *)PyBytes_AS_STRING(out);
            uint32_t raw = (uint32_t)clen | COMPRESSED_BIT;
            w[0] = raw & 0xff;
            w[1] = (raw >> 8) & 0xff;
            w[2] = (raw >> 16) & 0xff;
            w[3] = (raw >> 24) & 0xff;
            memcpy(w + 4, PyBytes_AS_STRING(tmp), clen);
            Py_DECREF(tmp);
            PyBuffer_Release(&view);
            return out;
        }
        Py_DECREF(tmp);
        (void)flag;
    }

    PyObject *out = PyBytes_FromStringAndSize(NULL, 4 + body_len);
    if (out == NULL) {
        PyBuffer_Release(&view);
        return NULL;
    }
    unsigned char *w = (unsigned char *)PyBytes_AS_STRING(out);
    uint32_t raw = (uint32_t)body_len;
    w[0] = raw & 0xff;
    w[1] = (raw >> 8) & 0xff;
    w[2] = (raw >> 16) & 0xff;
    w[3] = (raw >> 24) & 0xff;
    w[4] = msgtype & 0xff;
    w[5] = (msgtype >> 8) & 0xff;
    memcpy(w + 6, view.buf, plen);
    PyBuffer_Release(&view);
    return out;
}

static PyMethodDef methods[] = {
    {"split", fastframe_split, METH_VARARGS,
     "split(data, max_packet) -> (frames, consumed, error)"},
    {"pack", fastframe_pack, METH_VARARGS,
     "pack(msgtype, payload, compress, threshold, max_packet) -> bytes"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastframe",
    "C hot path for goworld wire framing", -1, methods,
};

PyMODINIT_FUNC PyInit__fastframe(void) { return PyModule_Create(&moduledef); }
