/* _kcpcore — the KCP control block in C (the transport's per-datagram
 * hot loop; the reference runs kcp-go compiled, and the pure-Python
 * control block walls a single-core bot fleet at ~10 MB/s/session
 * during restore bursts — BENCH_NOTES round 5).
 *
 * Semantics mirror netutil/kcp.py's class KCP EXACTLY — that Python
 * implementation is the pinned reference (wire vectors in
 * tests/test_kcp.py); the parity suite drives both over random
 * lossy transfers and asserts identical delivered streams. Segment
 * layout and protocol constants per the public KCP spec:
 *   [u32 conv][u8 cmd][u8 frg][u16 wnd][u32 ts][u32 sn][u32 una]
 *   [u32 len] + data, little-endian; cmds 81..84.
 *
 * Exposed type: KCPCore(conv, output_callable)
 *   .send(bytes) -> int         .recv() -> bytes | None
 *   .input(bytes) -> int        .update(ms) / .check(ms) -> ms
 *   .flush()                    .set_nodelay(nd, interval, resend, nc)
 *   .set_wndsize(snd, rcv)      .set_mtu(mtu)
 *   .waiting_send() -> int      .idle() -> bool
 *   attrs: conv, state, stream (rw), updated, current (rw), mss,
 *          interval, rmt_wnd, rx_rto, snd_una, snd_nxt, rcv_nxt,
 *          probe_wait, has_acks, snd_buf_len, snd_queue_len
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#define K_RTO_NDL 30
#define K_RTO_MIN 100
#define K_RTO_DEF 200
#define K_RTO_MAX 60000
#define K_CMD_PUSH 81
#define K_CMD_ACK 82
#define K_CMD_WASK 83
#define K_CMD_WINS 84
#define K_ASK_SEND 1
#define K_ASK_TELL 2
#define K_WND_SND 32
#define K_WND_RCV 128
#define K_MTU_DEF 1400
#define K_INTERVAL 100
#define K_OVERHEAD 24
#define K_DEADLINK 20
#define K_THRESH_INIT 2
#define K_THRESH_MIN 2
#define K_PROBE_INIT 7000
#define K_PROBE_LIMIT 120000

static int32_t itimediff(uint32_t later, uint32_t earlier) {
    return (int32_t)(later - earlier);
}

typedef struct kseg {
    struct kseg *next;
    uint32_t frg, wnd, ts, sn, una;
    uint32_t resendts, rto, fastack, xmit;
    Py_ssize_t len, cap; /* cap > len on stream-mode tails: coalesce is an
                            in-place memcpy, never a realloc+relink */
    unsigned char data[];
} kseg;

typedef struct {
    kseg *head, *tail;
    Py_ssize_t n;
} klist;

static void klist_push(klist *l, kseg *s) {
    s->next = NULL;
    if (l->tail) l->tail->next = s;
    else l->head = s;
    l->tail = s;
    l->n++;
}

static kseg *klist_pop(klist *l) {
    kseg *s = l->head;
    if (s == NULL) return NULL;
    l->head = s->next;
    if (l->head == NULL) l->tail = NULL;
    l->n--;
    return s;
}

static void klist_clear(klist *l) {
    kseg *s;
    while ((s = klist_pop(l)) != NULL) PyMem_Free(s);
}

static kseg *kseg_new(const unsigned char *data, Py_ssize_t len,
                      Py_ssize_t cap) {
    if (cap < len) cap = len;
    kseg *s = (kseg *)PyMem_Malloc(sizeof(kseg) + (size_t)cap);
    if (s == NULL) return NULL;
    memset(s, 0, sizeof(kseg));
    s->len = len;
    s->cap = cap;
    if (len) memcpy(s->data, data, (size_t)len);
    return s;
}

typedef struct {
    PyObject_HEAD
    PyObject *output; /* callable(bytes) */
    uint32_t conv, snd_una, snd_nxt, rcv_nxt;
    uint32_t ssthresh;
    int32_t rx_rttval, rx_srtt;
    uint32_t rx_rto, rx_minrto;
    uint32_t snd_wnd, rcv_wnd, rmt_wnd, cwnd, probe;
    uint32_t mtu, mss;
    int stream;
    uint32_t interval_, ts_flush;
    int nodelay_, updated;
    uint32_t ts_probe, probe_wait;
    uint32_t dead_link, incr;
    int state;
    uint32_t current;
    int nocwnd, fastresend;
    klist snd_queue, rcv_queue, snd_buf, rcv_buf; /* rcv_buf sn-sorted */
    uint32_t *acklist; /* pairs (sn, ts) */
    Py_ssize_t ackcount, ackcap;
    uint32_t xmit;
    unsigned char *obuf; /* datagram assembly buffer (grow-only) */
    size_t obuf_cap;
    Py_ssize_t olen;
} KCPCore;

/* --- output assembly ----------------------------------------------------- */

static void wr_u32(unsigned char *p, uint32_t v) {
    p[0] = v & 0xff; p[1] = (v >> 8) & 0xff;
    p[2] = (v >> 16) & 0xff; p[3] = (v >> 24) & 0xff;
}

static void wr_u16(unsigned char *p, uint32_t v) {
    p[0] = v & 0xff; p[1] = (v >> 8) & 0xff;
}

static uint32_t rd_u32(const unsigned char *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
           ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

static uint32_t rd_u16(const unsigned char *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8);
}

static int kcp_outflush(KCPCore *k) {
    if (k->olen == 0) return 0;
    if (k->output == NULL) { /* cleared by the gc mid-collection */
        k->olen = 0;
        return 0;
    }
    PyObject *b = PyBytes_FromStringAndSize((const char *)k->obuf, k->olen);
    k->olen = 0;
    if (b == NULL) return -1;
    PyObject *r = PyObject_CallOneArg(k->output, b);
    Py_DECREF(b);
    if (r == NULL) return -1;
    Py_DECREF(r);
    return 0;
}

/* Append one encoded segment header (+payload) to the datagram buffer,
 * flushing first if it would overflow the mtu. */
static int kcp_emit(KCPCore *k, uint32_t cmd, uint32_t frg, uint32_t wnd,
                    uint32_t ts, uint32_t sn, uint32_t una,
                    const unsigned char *data, Py_ssize_t len) {
    if (k->olen + K_OVERHEAD + len > (Py_ssize_t)k->mtu && k->olen > 0) {
        if (kcp_outflush(k) != 0) return -1;
    }
    unsigned char *w = k->obuf + k->olen;
    wr_u32(w, k->conv);
    w[4] = (unsigned char)cmd;
    w[5] = (unsigned char)frg;
    wr_u16(w + 6, wnd);
    wr_u32(w + 8, ts);
    wr_u32(w + 12, sn);
    wr_u32(w + 16, una);
    wr_u32(w + 20, (uint32_t)len);
    if (len) memcpy(w + K_OVERHEAD, data, (size_t)len);
    k->olen += K_OVERHEAD + len;
    return 0;
}

/* --- core helpers (mirror kcp.py exactly) -------------------------------- */

static uint32_t wnd_unused(KCPCore *k) {
    if ((Py_ssize_t)k->rcv_wnd > k->rcv_queue.n)
        return k->rcv_wnd - (uint32_t)k->rcv_queue.n;
    return 0;
}

static void update_ack(KCPCore *k, int32_t rtt) {
    if (k->rx_srtt == 0) {
        k->rx_srtt = rtt;
        k->rx_rttval = rtt / 2;
    } else {
        int32_t delta = rtt - k->rx_srtt;
        if (delta < 0) delta = -delta;
        k->rx_rttval = (3 * k->rx_rttval + delta) / 4;
        k->rx_srtt = (7 * k->rx_srtt + rtt) / 8;
        if (k->rx_srtt < 1) k->rx_srtt = 1;
    }
    uint32_t rto = (uint32_t)k->rx_srtt +
        (k->interval_ > (uint32_t)(4 * k->rx_rttval)
             ? k->interval_ : (uint32_t)(4 * k->rx_rttval));
    if (rto < k->rx_minrto) rto = k->rx_minrto;
    if (rto > K_RTO_MAX) rto = K_RTO_MAX;
    k->rx_rto = rto;
}

static void shrink_buf(KCPCore *k) {
    k->snd_una = k->snd_buf.head ? k->snd_buf.head->sn : k->snd_nxt;
}

static void parse_ack(KCPCore *k, uint32_t sn) {
    if (itimediff(sn, k->snd_una) < 0 || itimediff(sn, k->snd_nxt) >= 0)
        return;
    kseg **pp = &k->snd_buf.head;
    kseg *prev = NULL;
    for (kseg *s = k->snd_buf.head; s; prev = s, s = s->next) {
        if (s->sn == sn) {
            *pp = s->next;
            if (k->snd_buf.tail == s) k->snd_buf.tail = prev;
            k->snd_buf.n--;
            PyMem_Free(s);
            return;
        }
        if (itimediff(sn, s->sn) < 0) return;
        pp = &s->next;
    }
}

static void parse_una(KCPCore *k, uint32_t una) {
    while (k->snd_buf.head && itimediff(k->snd_buf.head->sn, una) < 0) {
        kseg *s = klist_pop(&k->snd_buf);
        PyMem_Free(s);
    }
}

static void parse_fastack(KCPCore *k, uint32_t sn) {
    if (itimediff(sn, k->snd_una) < 0 || itimediff(sn, k->snd_nxt) >= 0)
        return;
    for (kseg *s = k->snd_buf.head; s; s = s->next) {
        if (itimediff(sn, s->sn) < 0) break;
        if (sn != s->sn) s->fastack++;
    }
}

static void move_rcv_buf(KCPCore *k) {
    while (k->rcv_buf.head && k->rcv_buf.head->sn == k->rcv_nxt &&
           k->rcv_queue.n < (Py_ssize_t)k->rcv_wnd) {
        kseg *s = klist_pop(&k->rcv_buf);
        klist_push(&k->rcv_queue, s);
        k->rcv_nxt++;
    }
}

static void parse_data(KCPCore *k, uint32_t sn, uint32_t frg,
                       const unsigned char *data, Py_ssize_t len) {
    if (itimediff(sn, k->rcv_nxt + k->rcv_wnd) >= 0 ||
        itimediff(sn, k->rcv_nxt) < 0)
        return;
    /* ordered insert (dedup) — bursts arrive in order, so scan from the
     * tail via a prev-pointer walk (list is short: <= rcv_wnd) */
    kseg **pp = &k->rcv_buf.head;
    kseg *ins_after = NULL;
    for (kseg *s = k->rcv_buf.head; s; s = s->next) {
        if (s->sn == sn) return; /* duplicate */
        if (itimediff(sn, s->sn) < 0) break;
        ins_after = s;
        pp = &s->next;
    }
    kseg *ns = kseg_new(data, len, len);
    if (ns == NULL) return; /* OOM: drop (ARQ retransmits) */
    ns->sn = sn;
    ns->frg = frg;
    ns->next = *pp;
    *pp = ns;
    if (ins_after == k->rcv_buf.tail) k->rcv_buf.tail = ns;
    k->rcv_buf.n++;
    move_rcv_buf(k);
}

static int ack_push(KCPCore *k, uint32_t sn, uint32_t ts) {
    if (k->ackcount + 1 > k->ackcap) {
        Py_ssize_t ncap = k->ackcap ? k->ackcap * 2 : 16;
        uint32_t *na = (uint32_t *)PyMem_Realloc(
            k->acklist, (size_t)ncap * 2 * sizeof(uint32_t));
        if (na == NULL) return -1;
        k->acklist = na;
        k->ackcap = ncap;
    }
    k->acklist[k->ackcount * 2] = sn;
    k->acklist[k->ackcount * 2 + 1] = ts;
    k->ackcount++;
    return 0;
}

static Py_ssize_t peeksize(KCPCore *k) {
    kseg *s = k->rcv_queue.head;
    if (s == NULL) return -1;
    if (s->frg == 0) return s->len;
    if (k->rcv_queue.n < (Py_ssize_t)s->frg + 1) return -1;
    Py_ssize_t length = 0;
    for (; s; s = s->next) {
        length += s->len;
        if (s->frg == 0) break;
    }
    return length;
}

/* --- methods ------------------------------------------------------------- */

static PyObject *K_send(KCPCore *k, PyObject *arg) {
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) != 0) return NULL;
    const unsigned char *buf = (const unsigned char *)view.buf;
    Py_ssize_t len = view.len;
    if (len == 0 && !k->stream) {
        PyBuffer_Release(&view);
        return PyLong_FromLong(-1);
    }
    if (k->stream && k->snd_queue.tail) {
        kseg *tail = k->snd_queue.tail;
        /* Stream-mode tails are allocated with mss capacity, so the
         * coalesce is an O(1) in-place memcpy (a realloc here would need
         * an O(n) predecessor relink when the block moves — quadratic
         * under small-send bursts, code-review r5). Capacity is bounded
         * by the coalesce target itself: min(cap, mss). */
        Py_ssize_t limit = tail->cap < (Py_ssize_t)k->mss
                               ? tail->cap : (Py_ssize_t)k->mss;
        if (tail->len < limit) {
            Py_ssize_t take = limit - tail->len;
            if (take > len) take = len;
            memcpy(tail->data + tail->len, buf, (size_t)take);
            tail->len += take;
            tail->frg = 0;
            buf += take;
            len -= take;
        }
    }
    if (len == 0) {
        PyBuffer_Release(&view);
        return PyLong_FromLong(0);
    }
    Py_ssize_t count = (len + k->mss - 1) / (Py_ssize_t)k->mss;
    if (count == 0) count = 1;
    if (count >= K_WND_RCV) {
        PyBuffer_Release(&view);
        return PyLong_FromLong(-2);
    }
    for (Py_ssize_t i = 0; i < count; i++) {
        Py_ssize_t off = i * (Py_ssize_t)k->mss;
        Py_ssize_t n = len - off < (Py_ssize_t)k->mss
                           ? len - off : (Py_ssize_t)k->mss;
        /* In stream mode the LAST fragment becomes the coalescible tail:
         * give it full mss capacity up front (O(1) later coalesce). */
        Py_ssize_t cap =
            (k->stream && i == count - 1) ? (Py_ssize_t)k->mss : n;
        kseg *s = kseg_new(buf + off, n, cap);
        if (s == NULL) {
            PyBuffer_Release(&view);
            return PyErr_NoMemory();
        }
        s->frg = k->stream ? 0 : (uint32_t)(count - i - 1);
        klist_push(&k->snd_queue, s);
    }
    PyBuffer_Release(&view);
    return PyLong_FromLong(0);
}

static PyObject *K_recv(KCPCore *k, PyObject *noarg) {
    Py_ssize_t size = peeksize(k);
    if (size < 0) Py_RETURN_NONE;
    int recover = k->rcv_queue.n >= (Py_ssize_t)k->rcv_wnd;
    PyObject *out = PyBytes_FromStringAndSize(NULL, size);
    if (out == NULL) return NULL;
    unsigned char *w = (unsigned char *)PyBytes_AS_STRING(out);
    while (k->rcv_queue.head) {
        kseg *s = klist_pop(&k->rcv_queue);
        memcpy(w, s->data, (size_t)s->len);
        w += s->len;
        uint32_t frg = s->frg;
        PyMem_Free(s);
        if (frg == 0) break;
    }
    move_rcv_buf(k);
    if (k->rcv_queue.n < (Py_ssize_t)k->rcv_wnd && recover)
        k->probe |= K_ASK_TELL;
    return out;
}

static PyObject *K_input(KCPCore *k, PyObject *arg) {
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) != 0) return NULL;
    const unsigned char *data = (const unsigned char *)view.buf;
    Py_ssize_t n = view.len;
    if (n < K_OVERHEAD) {
        PyBuffer_Release(&view);
        return PyLong_FromLong(-1);
    }
    uint32_t prev_una = k->snd_una;
    int flag = 0;
    uint32_t maxack = 0;
    Py_ssize_t off = 0;
    int rc = 0;
    while (n - off >= K_OVERHEAD) {
        uint32_t conv = rd_u32(data + off);
        uint32_t cmd = data[off + 4];
        uint32_t frg = data[off + 5];
        uint32_t wnd = rd_u16(data + off + 6);
        uint32_t ts = rd_u32(data + off + 8);
        uint32_t sn = rd_u32(data + off + 12);
        uint32_t una = rd_u32(data + off + 16);
        uint32_t length = rd_u32(data + off + 20);
        off += K_OVERHEAD;
        if (conv != k->conv) { rc = -1; goto out; }
        if ((Py_ssize_t)length > n - off) { rc = -2; goto out; }
        if (cmd != K_CMD_PUSH && cmd != K_CMD_ACK &&
            cmd != K_CMD_WASK && cmd != K_CMD_WINS) { rc = -3; goto out; }
        k->rmt_wnd = wnd;
        parse_una(k, una);
        shrink_buf(k);
        if (cmd == K_CMD_ACK) {
            int32_t rtt = itimediff(k->current, ts);
            if (rtt >= 0) update_ack(k, rtt);
            parse_ack(k, sn);
            shrink_buf(k);
            if (!flag) {
                flag = 1;
                maxack = sn;
            } else if (itimediff(sn, maxack) > 0) {
                maxack = sn;
            }
        } else if (cmd == K_CMD_PUSH) {
            if (itimediff(sn, k->rcv_nxt + k->rcv_wnd) < 0) {
                if (ack_push(k, sn, ts) != 0) {
                    PyBuffer_Release(&view);
                    return PyErr_NoMemory();
                }
                if (itimediff(sn, k->rcv_nxt) >= 0)
                    parse_data(k, sn, frg, data + off, (Py_ssize_t)length);
            }
        } else if (cmd == K_CMD_WASK) {
            k->probe |= K_ASK_TELL;
        }
        off += length;
    }
    if (flag) parse_fastack(k, maxack);
    if (itimediff(k->snd_una, prev_una) > 0 && k->cwnd < k->rmt_wnd) {
        if (k->cwnd < k->ssthresh) {
            k->cwnd++;
            k->incr += k->mss;
        } else {
            if (k->incr < k->mss) k->incr = k->mss;
            k->incr += (k->mss * k->mss) / k->incr + (k->mss / 16);
            if ((k->cwnd + 1) * k->mss <= k->incr)
                k->cwnd = (k->incr + k->mss - 1) / (k->mss ? k->mss : 1);
        }
        if (k->cwnd > k->rmt_wnd) {
            k->cwnd = k->rmt_wnd;
            k->incr = k->rmt_wnd * k->mss;
        }
    }
out:
    PyBuffer_Release(&view);
    return PyLong_FromLong(rc);
}

static PyObject *K_flush(KCPCore *k, PyObject *noarg) {
    if (!k->updated) Py_RETURN_NONE;
    uint32_t current = k->current;
    uint32_t wnd = wnd_unused(k);
    /* 1) pending acks */
    for (Py_ssize_t i = 0; i < k->ackcount; i++) {
        if (kcp_emit(k, K_CMD_ACK, 0, wnd, k->acklist[i * 2 + 1],
                     k->acklist[i * 2], k->rcv_nxt, NULL, 0) != 0)
            return NULL;
    }
    k->ackcount = 0;
    /* 2) zero-window probing */
    if (k->rmt_wnd == 0) {
        if (k->probe_wait == 0) {
            k->probe_wait = K_PROBE_INIT;
            k->ts_probe = current + k->probe_wait;
        } else if (itimediff(current, k->ts_probe) >= 0) {
            if (k->probe_wait < K_PROBE_INIT) k->probe_wait = K_PROBE_INIT;
            k->probe_wait += k->probe_wait / 2;
            if (k->probe_wait > K_PROBE_LIMIT)
                k->probe_wait = K_PROBE_LIMIT;
            k->ts_probe = current + k->probe_wait;
            k->probe |= K_ASK_SEND;
        }
    } else {
        k->ts_probe = 0;
        k->probe_wait = 0;
    }
    if (k->probe & K_ASK_SEND) {
        if (kcp_emit(k, K_CMD_WASK, 0, wnd, 0, 0, k->rcv_nxt, NULL, 0))
            return NULL;
    }
    if (k->probe & K_ASK_TELL) {
        if (kcp_emit(k, K_CMD_WINS, 0, wnd, 0, 0, k->rcv_nxt, NULL, 0))
            return NULL;
    }
    k->probe = 0;
    /* 3) move snd_queue -> snd_buf within the window */
    uint32_t cwnd = k->snd_wnd < k->rmt_wnd ? k->snd_wnd : k->rmt_wnd;
    if (!k->nocwnd && k->cwnd < cwnd) cwnd = k->cwnd;
    while (itimediff(k->snd_nxt, k->snd_una + cwnd) < 0 &&
           k->snd_queue.head) {
        kseg *s = klist_pop(&k->snd_queue);
        s->wnd = wnd;
        s->ts = current;
        s->sn = k->snd_nxt++;
        s->una = k->rcv_nxt;
        s->resendts = current;
        s->rto = k->rx_rto;
        s->fastack = 0;
        s->xmit = 0;
        klist_push(&k->snd_buf, s);
    }
    /* 4) (re)transmit */
    uint32_t resent = k->fastresend > 0 ? (uint32_t)k->fastresend
                                        : 0x7fffffff;
    uint32_t rtomin = k->nodelay_ ? 0 : (k->rx_rto >> 3);
    int lost = 0, change = 0;
    for (kseg *s = k->snd_buf.head; s; s = s->next) {
        int needsend = 0;
        if (s->xmit == 0) {
            needsend = 1;
            s->xmit++;
            s->rto = k->rx_rto;
            s->resendts = current + s->rto + rtomin;
        } else if (itimediff(current, s->resendts) >= 0) {
            needsend = 1;
            s->xmit++;
            k->xmit++;
            if (!k->nodelay_)
                s->rto += s->rto > k->rx_rto ? s->rto : k->rx_rto;
            else
                s->rto += k->rx_rto / 2;
            s->resendts = current + s->rto;
            lost = 1;
        } else if (s->fastack >= resent) {
            needsend = 1;
            s->xmit++;
            s->fastack = 0;
            s->resendts = current + s->rto;
            change = 1;
        }
        if (needsend) {
            s->ts = current;
            s->wnd = wnd;
            s->una = k->rcv_nxt;
            if (kcp_emit(k, K_CMD_PUSH, s->frg, wnd, s->ts, s->sn,
                         s->una, s->data, s->len) != 0)
                return NULL;
            if (s->xmit >= k->dead_link) k->state = -1;
        }
    }
    if (kcp_outflush(k) != 0) return NULL;
    /* 5) congestion state */
    if (change) {
        uint32_t inflight = k->snd_nxt - k->snd_una;
        k->ssthresh = inflight / 2;
        if (k->ssthresh < K_THRESH_MIN) k->ssthresh = K_THRESH_MIN;
        k->cwnd = k->ssthresh + resent;
        k->incr = k->cwnd * k->mss;
    }
    if (lost) {
        k->ssthresh = cwnd / 2;
        if (k->ssthresh < K_THRESH_MIN) k->ssthresh = K_THRESH_MIN;
        k->cwnd = 1;
        k->incr = k->mss;
    }
    if (k->cwnd < 1) {
        k->cwnd = 1;
        k->incr = k->mss;
    }
    Py_RETURN_NONE;
}

static PyObject *K_update(KCPCore *k, PyObject *arg) {
    unsigned long cur = PyLong_AsUnsignedLongMask(arg);
    if (PyErr_Occurred()) return NULL;
    k->current = (uint32_t)cur;
    if (!k->updated) {
        k->updated = 1;
        k->ts_flush = k->current;
    }
    int32_t slap = itimediff(k->current, k->ts_flush);
    if (slap >= 10000 || slap < -10000) {
        k->ts_flush = k->current;
        slap = 0;
    }
    if (slap >= 0) {
        k->ts_flush += k->interval_;
        if (itimediff(k->current, k->ts_flush) >= 0)
            k->ts_flush = k->current + k->interval_;
        return K_flush(k, NULL);
    }
    Py_RETURN_NONE;
}

static PyObject *K_check(KCPCore *k, PyObject *arg) {
    unsigned long cur = PyLong_AsUnsignedLongMask(arg);
    if (PyErr_Occurred()) return NULL;
    uint32_t current = (uint32_t)cur;
    if (!k->updated) return PyLong_FromUnsignedLong(current);
    uint32_t ts_flush = k->ts_flush;
    int32_t slap = itimediff(current, ts_flush);
    if (slap >= 10000 || slap < -10000) ts_flush = current;
    if (itimediff(current, ts_flush) >= 0)
        return PyLong_FromUnsignedLong(current);
    int32_t tm_packet = 0x7fffffff;
    for (kseg *s = k->snd_buf.head; s; s = s->next) {
        int32_t diff = itimediff(s->resendts, current);
        if (diff <= 0) return PyLong_FromUnsignedLong(current);
        if (diff < tm_packet) tm_packet = diff;
    }
    int32_t minimal = itimediff(ts_flush, current);
    if (tm_packet < minimal) minimal = tm_packet;
    if ((int32_t)k->interval_ < minimal) minimal = (int32_t)k->interval_;
    return PyLong_FromUnsignedLong(current + (uint32_t)minimal);
}

static PyObject *K_set_nodelay(KCPCore *k, PyObject *args) {
    int nd, interval, resend, nc;
    if (!PyArg_ParseTuple(args, "iiii", &nd, &interval, &resend, &nc))
        return NULL;
    if (nd >= 0) {
        k->nodelay_ = nd;
        k->rx_minrto = nd ? K_RTO_NDL : K_RTO_MIN;
    }
    if (interval >= 0) {
        if (interval < 10) interval = 10;
        if (interval > 5000) interval = 5000;
        k->interval_ = (uint32_t)interval;
    }
    if (resend >= 0) k->fastresend = resend;
    if (nc >= 0) k->nocwnd = nc;
    Py_RETURN_NONE;
}

static PyObject *K_set_wndsize(KCPCore *k, PyObject *args) {
    int snd, rcv;
    if (!PyArg_ParseTuple(args, "ii", &snd, &rcv)) return NULL;
    if (snd > 0) k->snd_wnd = (uint32_t)snd;
    if (rcv > 0)
        k->rcv_wnd = (uint32_t)(rcv > K_WND_RCV ? rcv : K_WND_RCV);
    Py_RETURN_NONE;
}

static PyObject *K_set_mtu(KCPCore *k, PyObject *arg) {
    long mtu = PyLong_AsLong(arg);
    if (PyErr_Occurred()) return NULL;
    if (mtu < 50 || mtu < K_OVERHEAD) {
        PyErr_SetString(PyExc_ValueError, "mtu too small");
        return NULL;
    }
    /* GROW-only assembly buffer: segments queued before an mtu SHRINK
     * keep their old (larger) length, and kcp_emit's overflow-flush
     * check is against the new mtu — emitting such a segment into a
     * shrunken buffer would be a heap overflow (code-review r5). */
    if ((size_t)mtu + K_OVERHEAD > k->obuf_cap) {
        unsigned char *nb = (unsigned char *)PyMem_Realloc(
            k->obuf, (size_t)mtu + K_OVERHEAD);
        if (nb == NULL) return PyErr_NoMemory();
        k->obuf = nb;
        k->obuf_cap = (size_t)mtu + K_OVERHEAD;
    }
    k->mtu = (uint32_t)mtu;
    k->mss = k->mtu - K_OVERHEAD;
    Py_RETURN_NONE;
}

static PyObject *K_waiting_send(KCPCore *k, PyObject *noarg) {
    return PyLong_FromSsize_t(k->snd_buf.n + k->snd_queue.n);
}

static PyObject *K_idle(KCPCore *k, PyObject *noarg) {
    if (k->snd_buf.n == 0 && k->snd_queue.n == 0 && k->ackcount == 0 &&
        k->probe == 0 && k->rmt_wnd > 0)
        Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

/* --- type plumbing ------------------------------------------------------- */

static int K_init(KCPCore *k, PyObject *args, PyObject *kwds) {
    unsigned long conv;
    PyObject *output;
    static char *kwlist[] = {"conv", "output", NULL};
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "kO", kwlist, &conv,
                                     &output))
        return -1;
    if (!PyCallable_Check(output)) {
        PyErr_SetString(PyExc_TypeError, "output must be callable");
        return -1;
    }
    Py_INCREF(output);
    Py_XSETREF(k->output, output);
    k->conv = (uint32_t)conv;
    k->ssthresh = K_THRESH_INIT;
    k->rx_rto = K_RTO_DEF;
    k->rx_minrto = K_RTO_MIN;
    k->snd_wnd = K_WND_SND;
    k->rcv_wnd = K_WND_RCV;
    k->rmt_wnd = K_WND_RCV;
    k->mtu = K_MTU_DEF;
    k->mss = K_MTU_DEF - K_OVERHEAD;
    k->interval_ = K_INTERVAL;
    k->ts_flush = K_INTERVAL;
    k->dead_link = K_DEADLINK;
    k->obuf = (unsigned char *)PyMem_Malloc(K_MTU_DEF + K_OVERHEAD);
    if (k->obuf == NULL) {
        PyErr_NoMemory();
        return -1;
    }
    k->obuf_cap = K_MTU_DEF + K_OVERHEAD;
    return 0;
}

/* Cyclic-GC support (code-review r5): the session layer passes a BOUND
 * METHOD as output, creating the cycle connection -> KCPCore -> output
 * -> connection; without traverse/clear every closed session would leak
 * its whole object graph — the exact churn workload this port serves. */
static int K_traverse(KCPCore *k, visitproc visit, void *arg) {
    Py_VISIT(k->output);
    return 0;
}

static int K_clear(KCPCore *k) {
    Py_CLEAR(k->output);
    return 0;
}

static void K_dealloc(KCPCore *k) {
    PyObject_GC_UnTrack(k);
    Py_XDECREF(k->output);
    klist_clear(&k->snd_queue);
    klist_clear(&k->rcv_queue);
    klist_clear(&k->snd_buf);
    klist_clear(&k->rcv_buf);
    PyMem_Free(k->acklist);
    PyMem_Free(k->obuf);
    Py_TYPE(k)->tp_free((PyObject *)k);
}

static PyMethodDef K_methods[] = {
    {"send", (PyCFunction)K_send, METH_O, "queue user bytes"},
    {"recv", (PyCFunction)K_recv, METH_NOARGS, "one message or None"},
    {"input", (PyCFunction)K_input, METH_O, "feed a received datagram"},
    {"update", (PyCFunction)K_update, METH_O, "clock the protocol (ms)"},
    {"check", (PyCFunction)K_check, METH_O, "next work deadline (ms)"},
    {"flush", (PyCFunction)K_flush, METH_NOARGS, "emit pending output"},
    {"set_nodelay", (PyCFunction)K_set_nodelay, METH_VARARGS, ""},
    {"set_wndsize", (PyCFunction)K_set_wndsize, METH_VARARGS, ""},
    {"set_mtu", (PyCFunction)K_set_mtu, METH_O, ""},
    {"waiting_send", (PyCFunction)K_waiting_send, METH_NOARGS, ""},
    {"idle", (PyCFunction)K_idle, METH_NOARGS, ""},
    {NULL, NULL, 0, NULL},
};

#define K_GETSET_U32(name, field)                                        \
    static PyObject *K_get_##name(KCPCore *k, void *c) {                 \
        return PyLong_FromUnsignedLong(k->field);                        \
    }

K_GETSET_U32(conv, conv)
K_GETSET_U32(rmt_wnd, rmt_wnd)
K_GETSET_U32(rx_rto, rx_rto)
K_GETSET_U32(snd_una, snd_una)
K_GETSET_U32(snd_nxt, snd_nxt)
K_GETSET_U32(rcv_nxt, rcv_nxt)
K_GETSET_U32(probe_wait, probe_wait)
K_GETSET_U32(mss, mss)
K_GETSET_U32(interval, interval_)

static PyObject *K_get_state(KCPCore *k, void *c) {
    return PyLong_FromLong(k->state);
}

static PyObject *K_get_updated(KCPCore *k, void *c) {
    return PyBool_FromLong(k->updated);
}

static PyObject *K_get_stream(KCPCore *k, void *c) {
    return PyBool_FromLong(k->stream);
}

static int K_set_stream(KCPCore *k, PyObject *v, void *c) {
    int b = PyObject_IsTrue(v);
    if (b < 0) return -1;
    k->stream = b;
    return 0;
}

static PyObject *K_get_current(KCPCore *k, void *c) {
    return PyLong_FromUnsignedLong(k->current);
}

static int K_set_current(KCPCore *k, PyObject *v, void *c) {
    unsigned long cur = PyLong_AsUnsignedLongMask(v);
    if (PyErr_Occurred()) return -1;
    k->current = (uint32_t)cur;
    return 0;
}

static PyObject *K_get_has_acks(KCPCore *k, void *c) {
    return PyBool_FromLong(k->ackcount > 0);
}

static PyObject *K_get_snd_buf_len(KCPCore *k, void *c) {
    return PyLong_FromSsize_t(k->snd_buf.n);
}

static PyObject *K_get_snd_queue_len(KCPCore *k, void *c) {
    return PyLong_FromSsize_t(k->snd_queue.n);
}

static PyGetSetDef K_getset[] = {
    {"conv", (getter)K_get_conv, NULL, NULL, NULL},
    {"rmt_wnd", (getter)K_get_rmt_wnd, NULL, NULL, NULL},
    {"rx_rto", (getter)K_get_rx_rto, NULL, NULL, NULL},
    {"snd_una", (getter)K_get_snd_una, NULL, NULL, NULL},
    {"snd_nxt", (getter)K_get_snd_nxt, NULL, NULL, NULL},
    {"rcv_nxt", (getter)K_get_rcv_nxt, NULL, NULL, NULL},
    {"probe_wait", (getter)K_get_probe_wait, NULL, NULL, NULL},
    {"mss", (getter)K_get_mss, NULL, NULL, NULL},
    {"interval", (getter)K_get_interval, NULL, NULL, NULL},
    {"state", (getter)K_get_state, NULL, NULL, NULL},
    {"updated", (getter)K_get_updated, NULL, NULL, NULL},
    {"stream", (getter)K_get_stream, (setter)K_set_stream, NULL, NULL},
    {"current", (getter)K_get_current, (setter)K_set_current, NULL, NULL},
    {"has_acks", (getter)K_get_has_acks, NULL, NULL, NULL},
    {"snd_buf_len", (getter)K_get_snd_buf_len, NULL, NULL, NULL},
    {"snd_queue_len", (getter)K_get_snd_queue_len, NULL, NULL, NULL},
    {NULL, NULL, NULL, NULL, NULL},
};

static PyTypeObject KCPCoreType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_kcpcore.KCPCore",
    .tp_basicsize = sizeof(KCPCore),
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC,
    .tp_new = PyType_GenericNew,
    .tp_init = (initproc)K_init,
    .tp_traverse = (traverseproc)K_traverse,
    .tp_clear = (inquiry)K_clear,
    .tp_dealloc = (destructor)K_dealloc,
    .tp_methods = K_methods,
    .tp_getset = K_getset,
    .tp_doc = "KCP control block (C hot path; parity with kcp.py's KCP)",
};

/* --- GF(256) Reed-Solomon row mat-mul (FEC hot loop, netutil/fec.py) ----- */

static unsigned char GF_MUL[256][256];

static void gf_init(void) {
    unsigned short exp[512];
    unsigned char log[256];
    unsigned x = 1;
    memset(log, 0, sizeof(log));
    for (int i = 0; i < 255; i++) {
        exp[i] = (unsigned short)x;
        log[x] = (unsigned char)i;
        x <<= 1;
        if (x & 0x100) x ^= 0x11d;
    }
    for (int i = 255; i < 512; i++) exp[i] = exp[i - 255];
    for (int a = 1; a < 256; a++)
        for (int b = 1; b < 256; b++)
            GF_MUL[a][b] = (unsigned char)exp[log[a] + log[b]];
}

/* rs_matmul(rows, shards, length) -> list[bytes]
 *   rows: sequence of sequences of GF coefficients (one per shard)
 *   shards: sequence of bytes objects, each >= length (extra ignored;
 *           shorter shards are zero-padded implicitly)
 * Returns one length-sized bytes per row: XOR_i coeff[i] * shard[i]. */
static PyObject *rs_matmul(PyObject *self, PyObject *args) {
    PyObject *rows, *shards;
    Py_ssize_t length;
    if (!PyArg_ParseTuple(args, "OOn", &rows, &shards, &length))
        return NULL;
    PyObject *rows_f = PySequence_Fast(rows, "rows must be a sequence");
    if (rows_f == NULL) return NULL;
    PyObject *shards_f =
        PySequence_Fast(shards, "shards must be a sequence");
    if (shards_f == NULL) {
        Py_DECREF(rows_f);
        return NULL;
    }
    Py_ssize_t nrows = PySequence_Fast_GET_SIZE(rows_f);
    Py_ssize_t nsh = PySequence_Fast_GET_SIZE(shards_f);
    PyObject *out = PyList_New(nrows);
    if (out == NULL) goto fail;
    for (Py_ssize_t r = 0; r < nrows; r++) {
        PyObject *row_f = PySequence_Fast(
            PySequence_Fast_GET_ITEM(rows_f, r), "row must be a sequence");
        if (row_f == NULL) goto fail;
        if (PySequence_Fast_GET_SIZE(row_f) < nsh) {
            Py_DECREF(row_f);
            PyErr_SetString(PyExc_ValueError, "row shorter than shards");
            goto fail;
        }
        PyObject *acc_obj = PyBytes_FromStringAndSize(NULL, length);
        if (acc_obj == NULL) {
            Py_DECREF(row_f);
            goto fail;
        }
        unsigned char *acc = (unsigned char *)PyBytes_AS_STRING(acc_obj);
        memset(acc, 0, (size_t)length);
        for (Py_ssize_t i = 0; i < nsh; i++) {
            long c = PyLong_AsLong(PySequence_Fast_GET_ITEM(row_f, i));
            if (c == -1 && PyErr_Occurred()) {
                Py_DECREF(row_f);
                Py_DECREF(acc_obj);
                goto fail;
            }
            if (c == 0) continue;
            if (c < 0 || c > 255) {
                Py_DECREF(row_f);
                Py_DECREF(acc_obj);
                PyErr_SetString(PyExc_ValueError, "coeff out of GF(256)");
                goto fail;
            }
            char *sb;
            Py_ssize_t sl;
            if (PyBytes_AsStringAndSize(
                    PySequence_Fast_GET_ITEM(shards_f, i), &sb, &sl) != 0) {
                Py_DECREF(row_f);
                Py_DECREF(acc_obj);
                goto fail;
            }
            Py_ssize_t n = sl < length ? sl : length;
            const unsigned char *tbl = GF_MUL[c];
            const unsigned char *s = (const unsigned char *)sb;
            if (c == 1) {
                for (Py_ssize_t j = 0; j < n; j++) acc[j] ^= s[j];
            } else {
                for (Py_ssize_t j = 0; j < n; j++) acc[j] ^= tbl[s[j]];
            }
        }
        Py_DECREF(row_f);
        PyList_SET_ITEM(out, r, acc_obj);
    }
    Py_DECREF(rows_f);
    Py_DECREF(shards_f);
    return out;
fail:
    Py_DECREF(rows_f);
    Py_DECREF(shards_f);
    Py_XDECREF(out);
    return NULL;
}

static PyMethodDef module_methods[] = {
    {"rs_matmul", rs_matmul, METH_VARARGS,
     "rs_matmul(rows, shards, length) -> list[bytes] (GF(256) XOR-dot)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_kcpcore",
    "C KCP control block", -1, module_methods,
};

PyMODINIT_FUNC PyInit__kcpcore(void) {
    gf_init();
    if (PyType_Ready(&KCPCoreType) < 0) return NULL;
    PyObject *m = PyModule_Create(&moduledef);
    if (m == NULL) return NULL;
    Py_INCREF(&KCPCoreType);
    if (PyModule_AddObject(m, "KCPCore", (PyObject *)&KCPCoreType) < 0) {
        Py_DECREF(&KCPCoreType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
