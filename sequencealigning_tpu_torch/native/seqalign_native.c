/* Native host runtime of the PyTorch port: FASTA byte-scan, the threaded
 * fast4 first-path walker, the decoder of the device walks' packed op
 * codes, the banded (row layout) fast4 walker and the weighted-A* search.  The port's copy of the entry points it calls from
 * sequencealigning_tpu/native/seqalign_native.c (same code, same results).
 *
 * Built on first use by sequencealigning_tpu_torch.native into
 * build/sequencealigning_tpu_torch/ (cc -O3 -shared -fPIC -pthread) and
 * loaded through ctypes.
 */

#include <stdint.h>
#include <limits.h>
#include <stdlib.h>
#include <string.h>

/* ---------------------------------------------------------------- FASTA */

/* Byte-level FASTA scan with the reference's exact semantics:
 * '>' starts a record and is kept as the first name byte; name runs to the
 * first newline; newlines skipped; bytes outside {A,G,C,T,N} are dropped
 * from the sequence and collected as error chars; content before the first
 * '>' goes to a throwaway record.
 *
 * Outputs (caller-allocated):
 *   seq_buf   - cleaned sequence bytes of all records, concatenated
 *   seq_off   - (max_recs+1) offsets into seq_buf (record i = [off[i], off[i+1]))
 *   name_buf  - name bytes of all records, concatenated
 *   name_off  - (max_recs+1) offsets into name_buf
 *   err_buf   - invalid bytes in encounter order (capacity n)
 *   n_err_out - number of invalid bytes
 * Returns the number of records, or -1 if max_recs exceeded.
 */
long fasta_scan(const uint8_t *data, long n,
                uint8_t *seq_buf, long *seq_off,
                uint8_t *name_buf, long *name_off,
                uint8_t *err_buf, long *n_err_out,
                long max_recs) {
    static const uint8_t allowed[256] = {
        ['A'] = 1, ['G'] = 1, ['C'] = 1, ['T'] = 1, ['N'] = 1,
    };
    long n_rec = 0;       /* completed records, incl. the throwaway one */
    long sp = 0, np = 0;  /* write cursors */
    long n_err = 0;
    int in_name = 0;
    int have_current = 1; /* the throwaway record is implicitly open */
    long cur_seq_start = 0, cur_name_start = 0;

    for (long i = 0; i < n; i++) {
        uint8_t c = data[i];
        if (c == '>') {
            if (n_rec >= max_recs) return -1;
            seq_off[n_rec] = cur_seq_start;
            name_off[n_rec] = cur_name_start;
            n_rec++;
            cur_seq_start = sp;
            cur_name_start = np;
            name_buf[np++] = c;
            in_name = 1;
            continue;
        }
        if (in_name) {
            if (c == '\n') { in_name = 0; continue; }
            name_buf[np++] = c;
        } else if (c == '\n') {
            continue;
        } else if (!allowed[c]) {
            err_buf[n_err++] = c;
        } else {
            seq_buf[sp++] = c;
        }
    }
    if (n_rec >= max_recs) return -1;
    seq_off[n_rec] = cur_seq_start;
    name_off[n_rec] = cur_name_start;
    n_rec++;
    seq_off[n_rec] = sp;   /* sentinel end */
    name_off[n_rec] = np;
    *n_err_out = n_err;
    /* Record 0 is the throwaway (parse.rs:90-91); the caller drops it. */
    return n_rec;
}

/* ------------------------------------------------------------ traceback */

#define PLANE_M 0
#define PLANE_I 1
#define PLANE_D 2

/* ------------------------------------------------- fast4 traceback ----
 * First-path walker for the 4-bit dirs layout (8 cells per u32 word;
 * bits[0:2] = H-argmax plane code with M>I>D priority, bit2 = I-extend,
 * bit3 = D-extend).  Must mirror ops/traceback.py::fast4_traceback_pair
 * exactly (tests fuzz the two).  dirs is the full (T8, R, P) tensor; the
 * pair's bytes live in row `row` at diagonal offset d_off.
 */

#include <pthread.h>

static inline int f4_nibble(const uint32_t *dirs, long rp, long row, long p,
                            long d, long x) {
    return (int)((dirs[(d >> 3) * rp + row * p + x] >> (4 * (d & 7))) & 0xF);
}

long fast4_first_path(const uint32_t *dirs, long rows, long p, long row,
                      long d_off, long n1, long n2,
                      int sm, int si, int sd,
                      char *out, long cap) {
    long rp = rows * p;
    int score = sm > si ? (sm > sd ? sm : sd) : (si > sd ? si : sd);
    int plane = (sm == score) ? PLANE_M : (si == score ? PLANE_I : PLANE_D);
    long x = n2, y = n1;
    long n_ops = 0;
    long guard = n1 + n2 + 4;
    if (cap < guard) return -2;
    while (x > 0 || y > 0) {
        if (--guard < 0) return -1;
        if (x == 0) { out[n_ops++] = 'I'; y -= 1; continue; }
        if (y == 0) { out[n_ops++] = 'D'; x -= 1; continue; }
        int b = f4_nibble(dirs, rp, row, p, x + y + d_off, x);
        if (plane == PLANE_M) {
            out[n_ops++] = 'M';
            x -= 1; y -= 1;
            if (x == 0 && y == 0) break;
            plane = f4_nibble(dirs, rp, row, p, x + y + d_off, x) & 3;
            if (plane > PLANE_D) plane = PLANE_D;
        } else if (plane == PLANE_I) {
            out[n_ops++] = 'I';
            plane = (b & 4) ? PLANE_I : PLANE_M;
            y -= 1;
        } else {
            out[n_ops++] = 'D';
            plane = (b & 8) ? PLANE_D : PLANE_M;
            x -= 1;
        }
    }
    /* reverse to forward order */
    for (long i = 0; i < n_ops / 2; i++) {
        char t = out[i]; out[i] = out[n_ops - 1 - i]; out[n_ops - 1 - i] = t;
    }
    return n_ops;
}

typedef struct {
    const uint32_t *dirs;
    long rows, p;
    const long *row_idx, *d_offs, *n1s, *n2s;
    const int *finals; /* (B, 3) */
    char *outs;
    long out_cap;
    long *lens;
    long b_lo, b_hi;
} F4Task;

static void *f4_worker(void *arg) {
    F4Task *t = (F4Task *)arg;
    for (long b = t->b_lo; b < t->b_hi; b++) {
        t->lens[b] = fast4_first_path(
            t->dirs, t->rows, t->p, t->row_idx[b], t->d_offs[b],
            t->n1s[b], t->n2s[b],
            t->finals[b * 3 + 0], t->finals[b * 3 + 1], t->finals[b * 3 + 2],
            t->outs + b * t->out_cap, t->out_cap);
    }
    return NULL;
}

/* Batched, threaded fast4 walker.  outs: (B, out_cap) char matrix; lens[b]
 * = op count or negative error. */
void fast4_first_path_batch(const uint32_t *dirs, long rows, long p,
                            const long *row_idx, const long *d_offs,
                            const long *n1s, const long *n2s,
                            const int *finals, long b_total,
                            char *outs, long out_cap, long *lens,
                            int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    if (n_threads > b_total) n_threads = (int)(b_total > 0 ? b_total : 1);
    pthread_t tids[64];
    /* pthread_t is opaque (may be a struct off-glibc); track thread-started
     * state in a separate flag array instead of overloading tids values. */
    int running[64] = {0};
    F4Task tasks[64];
    long per = (b_total + n_threads - 1) / n_threads;
    int started = 0;
    for (int k = 0; k < n_threads; k++) {
        long lo = k * per, hi = lo + per;
        if (lo >= b_total) break;
        if (hi > b_total) hi = b_total;
        tasks[k] = (F4Task){dirs, rows, p, row_idx, d_offs, n1s, n2s,
                            finals, outs, out_cap, lens, lo, hi};
        if (pthread_create(&tids[k], NULL, f4_worker, &tasks[k]) != 0) {
            /* fall back to inline execution for this span */
            f4_worker(&tasks[k]);
            started = k + 1;
            continue;
        }
        running[k] = 1;
        started = k + 1;
    }
    for (int k = 0; k < started; k++)
        if (running[k]) pthread_join(tids[k], NULL);
}

/* ------------------------------------- packed walk-code decode ------------
 * Decode the on-device traceback walker's output (ops/traceback_device.py):
 * 2-bit op codes (0 stop, 1 M, 2 I, 3 D), 16 per u32 word little-endian in
 * step, emitted in walk order (alignment end -> start).  Builds the two
 * aligned strings in forward order.  Returns the aligned length, or -1 when
 * the code stream is inconsistent (codes after the stop, or it does not
 * consume exactly n1/n2 characters) -- the caller falls back to a host
 * walk for that pair. */
static long walk_decode_one(const uint32_t *pk, long t16,
                            const uint8_t *s1, long n1,
                            const uint8_t *s2, long n2,
                            char *o1, char *o2, long cap) {
    long T = t16 * 16;
    long n = T;
    for (long w = 0; w < t16; w++) {
        uint32_t v = pk[w];
        for (int j = 0; j < 16; j++) {
            if (((v >> (2 * j)) & 3u) == 0) { n = w * 16 + j; goto found; }
        }
    }
found:
    /* a zero-op walk is valid exactly when there is nothing to consume
     * (modes walks over empty stop..end substrings) */
    if (n == 0) return (n1 == 0 && n2 == 0) ? 0 : -1;
    if (n > cap) return -1;
    /* everything after the stop must be zero */
    {
        long w0 = n >> 4;
        uint32_t mask_hi = ~((n & 15) ? ((1u << (2 * (n & 15))) - 1u) : 0u);
        if ((n & 15) && (pk[w0] & mask_hi)) return -1;
        for (long w = w0 + ((n & 15) ? 1 : 0); w < t16; w++)
            if (pk[w]) return -1;
    }
    long i1 = n1, i2 = n2;
    for (long t = 0; t < n; t++) {
        int c = (int)((pk[t >> 4] >> (2 * (t & 15))) & 3u);
        char a1, a2;
        if (c == 1) {
            if (i1 <= 0 || i2 <= 0) return -1;
            a1 = (char)s1[--i1];
            a2 = (char)s2[--i2];
        } else if (c == 2) {
            if (i1 <= 0) return -1;
            a1 = (char)s1[--i1];
            a2 = '-';
        } else {
            if (i2 <= 0) return -1;
            a1 = '-';
            a2 = (char)s2[--i2];
        }
        o1[n - 1 - t] = a1;
        o2[n - 1 - t] = a2;
    }
    if (i1 != 0 || i2 != 0) return -1;
    return n;
}

typedef struct {
    const uint32_t *packed;
    long t16;
    const uint8_t *s1p, *s2p;
    long l1, l2;
    const long *n1s, *n2s;
    char *out1, *out2;
    long cap;
    long *lens;
    long b_lo, b_hi;
} WDTask;

static void *wd_worker(void *arg) {
    WDTask *t = (WDTask *)arg;
    for (long b = t->b_lo; b < t->b_hi; b++) {
        t->lens[b] = walk_decode_one(
            t->packed + b * t->t16, t->t16,
            t->s1p + b * t->l1, t->n1s[b],
            t->s2p + b * t->l2, t->n2s[b],
            t->out1 + b * t->cap, t->out2 + b * t->cap, t->cap);
    }
    return NULL;
}

/* packed: (B, t16) u32; s1p/s2p: (B, l1)/(B, l2) padded sequence bytes;
 * out1/out2: (B, cap) char matrices (forward aligned strings); lens[b] =
 * aligned length or -1. */
void walk_decode_batch(const uint32_t *packed, long t16,
                       const uint8_t *s1p, long l1,
                       const uint8_t *s2p, long l2,
                       const long *n1s, const long *n2s, long b_total,
                       char *out1, char *out2, long cap,
                       long *lens, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    if (n_threads > b_total) n_threads = (int)(b_total > 0 ? b_total : 1);
    pthread_t tids[64];
    int running[64] = {0};
    WDTask tasks[64];
    long per = (b_total + n_threads - 1) / n_threads;
    int started = 0;
    for (int k = 0; k < n_threads; k++) {
        long lo = k * per, hi = lo + per;
        if (lo >= b_total) break;
        if (hi > b_total) hi = b_total;
        tasks[k] = (WDTask){packed, t16, s1p, s2p, l1, l2, n1s, n2s,
                            out1, out2, cap, lens, lo, hi};
        if (pthread_create(&tids[k], NULL, wd_worker, &tasks[k]) != 0) {
            wd_worker(&tasks[k]);
            started = k + 1;
            continue;
        }
        running[k] = 1;
        started = k + 1;
    }
    for (int k = 0; k < started; k++)
        if (running[k]) pthread_join(tids[k], NULL);
}

/* Banded fast4 walker for ops/nw_banded's row-packed layout: word
 * dirs[x/8, b, (y-x)-k_lo], shift 4*(x%8); k_dim = K lanes.  Must mirror
 * ops/traceback.py::_banded_fast4_walk exactly (the JAX package's walker
 * with its wavefront layout left out). */
typedef struct {
    const uint32_t *dirs;
    long b_dim, k_dim; /* tensor dims (batch, lanes) */
    long b, k_lo;
} BF4Ctx;

static inline int bf4_nibble(const BF4Ctx *c, long x, long y) {
    long lane = (y - x) - c->k_lo;
    if (lane < 0 || lane >= c->k_dim) return 0;
    return (int)((c->dirs[((x >> 3) * c->b_dim + c->b) * c->k_dim + lane]
                  >> (4 * (x & 7))) & 0xF);
}

static long bf4_walk(const BF4Ctx *ctx, long n1, long n2,
                     int sm, int si, int sd, char *out, long cap) {
    int score = sm > si ? (sm > sd ? sm : sd) : (si > sd ? si : sd);
    int plane = (sm == score) ? PLANE_M : (si == score ? PLANE_I : PLANE_D);
    long x = n2, y = n1;
    long n_ops = 0;
    long guard = n1 + n2 + 4;
    if (cap < guard) return -2;
    while (x > 0 || y > 0) {
        if (--guard < 0) return -1;
        if (x == 0) { out[n_ops++] = 'I'; y -= 1; continue; }
        if (y == 0) { out[n_ops++] = 'D'; x -= 1; continue; }
        int bb = bf4_nibble(ctx, x, y);
        if (plane == PLANE_M) {
            out[n_ops++] = 'M';
            x -= 1; y -= 1;
            if (x == 0 && y == 0) break;
            plane = bf4_nibble(ctx, x, y) & 3;
            if (plane > PLANE_D) plane = PLANE_D;
        } else if (plane == PLANE_I) {
            out[n_ops++] = 'I';
            plane = (bb & 4) ? PLANE_I : PLANE_M;
            y -= 1;
        } else {
            out[n_ops++] = 'D';
            plane = (bb & 8) ? PLANE_D : PLANE_M;
            x -= 1;
        }
    }
    for (long i = 0; i < n_ops / 2; i++) {
        char t = out[i]; out[i] = out[n_ops - 1 - i]; out[n_ops - 1 - i] = t;
    }
    return n_ops;
}

long banded_fast4_first_path(const uint32_t *dirs, long b_dim, long k_dim,
                             long b, long k_lo, long n1, long n2,
                             int sm, int si, int sd,
                             char *out, long cap) {
    /* callers guarantee x/8 < the word dim; no bound needed */
    BF4Ctx ctx = {dirs, b_dim, k_dim, b, k_lo};
    return bf4_walk(&ctx, n1, n2, sm, si, sd, out, cap);
}

/* --------------------------------------------- weighted-A* (compat) -------
 * Native port of ops/oracle_astar.py: best-first search over the edit
 * graph with the reference's exact semantics (src/align.rs:19-304) --
 * dynamically-decaying epsilon-weighted heuristic evaluated at the
 * PARENT's position, gap-state-aware affine costs, NO closed set, and
 * bit-identical Rust std BinaryHeap pop order (State Ord = f, then (x,y),
 * then the parent chain recursively, None < Some; sift_up with
 * strict-greater promotion, pop = swap-last + sift_down_to_bottom
 * preferring the right child on ties, then sift back up).  Fuzz-pinned
 * byte-identical to the Python oracle (ops/oracle_astar.py). */

typedef struct {
    int32_t f, reach, x, y;
    int64_t parent; /* arena index, -1 = None */
    uint8_t in_q_gap, in_db_gap;
} AState;

typedef struct {
    AState *arena;
    int64_t n, cap, hard_cap;
    int64_t *heap;
    int64_t hn, hcap;
} AstarCtx;

static int a_cmp(const AState *arena, int64_t ia, int64_t ib) {
    for (;;) {
        if (ia == ib) return 0;
        const AState *a = &arena[ia], *b = &arena[ib];
        if (a->f != b->f) return a->f < b->f ? -1 : 1;
        if (a->x != b->x) return a->x < b->x ? -1 : 1;
        if (a->y != b->y) return a->y < b->y ? -1 : 1;
        if (a->parent < 0 && b->parent < 0) return 0;
        if (a->parent < 0) return -1;
        if (b->parent < 0) return 1;
        ia = a->parent;
        ib = b->parent;
    }
}

static void a_sift_up(AstarCtx *c, int64_t start, int64_t pos) {
    int64_t *d = c->heap;
    int64_t element = d[pos];
    while (pos > start) {
        int64_t parent = (pos - 1) >> 1;
        if (a_cmp(c->arena, element, d[parent]) <= 0) break;
        d[pos] = d[parent];
        pos = parent;
    }
    d[pos] = element;
}

static void a_sift_down_to_bottom(AstarCtx *c, int64_t pos) {
    int64_t *d = c->heap;
    int64_t end = c->hn;
    int64_t start = pos;
    int64_t element = d[pos];
    int64_t child = 2 * pos + 1;
    while (child + 1 < end) {
        if (a_cmp(c->arena, d[child], d[child + 1]) <= 0) child++;
        d[pos] = d[child];
        pos = child;
        child = 2 * pos + 1;
    }
    if (child == end - 1) {
        d[pos] = d[child];
        pos = child;
    }
    d[pos] = element;
    a_sift_up(c, start, pos);
}

/* returns arena index or -1 on allocation/cap failure */
static int64_t a_push(AstarCtx *c, int32_t cost, int32_t reach, int32_t x,
                      int32_t y, int64_t parent, uint8_t qg, uint8_t dg) {
    if (c->n >= c->cap) {
        int64_t nc = c->cap * 2;
        if (nc > c->hard_cap) nc = c->hard_cap;
        if (c->n >= nc) return -1;
        AState *na = (AState *)realloc(c->arena, (size_t)nc * sizeof(AState));
        if (!na) return -1;
        c->arena = na;
        c->cap = nc;
    }
    int64_t idx = c->n++;
    AState *s = &c->arena[idx];
    s->f = cost + reach;
    s->reach = reach;
    s->x = x;
    s->y = y;
    s->parent = parent;
    s->in_q_gap = qg;
    s->in_db_gap = dg;
    if (c->hn >= c->hcap) {
        int64_t nc = c->hcap * 2;
        int64_t *nh = (int64_t *)realloc(c->heap, (size_t)nc * sizeof(int64_t));
        if (!nh) return -1;
        c->heap = nh;
        c->hcap = nc;
    }
    c->heap[c->hn++] = idx;
    a_sift_up(c, 0, c->hn - 1);
    return idx;
}

static int64_t a_pop(AstarCtx *c) { /* -1 = empty */
    if (c->hn == 0) return -1;
    int64_t last = c->heap[--c->hn];
    if (c->hn == 0) return last;
    int64_t item = c->heap[0];
    c->heap[0] = last;
    a_sift_down_to_bottom(c, 0);
    return item;
}

/* get_h + dynamic_weight + heuristic_d (align.rs:196-214); trunc toward
 * zero matches Rust `as i32` and Python int(). */
static int32_t a_get_h(long len1, long len2, long x, long y,
                       long target_len, double eps) {
    long mx = x > y ? x : y;
    double w = mx <= target_len ? 1.0 - (double)mx / (double)target_len : 0.0;
    double h = (1.0 + eps * w) * (-(double)((len1 - y) + (len2 - x)));
    return (int32_t)h;
}

/* rc: >=0 converged (value = score); -1 never-converges (heap empty);
 * -2 max_expansions exceeded; -3 allocation failure / node cap.
 * out1/out2 (cap bytes each) receive the aligned query / db lines
 * (forward order); *out_len = aligned length. */
long astar_align_native(const uint8_t *seq1, long len1,
                        const uint8_t *seq2, long len2,
                        int match, int mismatch, int open_, int ext,
                        double eps, int semi_global, long max_expansions,
                        char *out1, char *out2, long cap, long *out_len,
                        int32_t *out_score) {
    if (len1 == 0 || len2 == 0) return -4; /* caller raises the empty msg */
    long target_len = len1 > len2 ? len1 : len2;
    AstarCtx c;
    c.cap = 4096;
    c.hard_cap = max_expansions * 3 + 8;
    c.arena = (AState *)malloc((size_t)c.cap * sizeof(AState));
    c.n = 0;
    c.hcap = 4096;
    c.heap = (int64_t *)malloc((size_t)c.hcap * sizeof(int64_t));
    c.hn = 0;
    if (!c.arena || !c.heap) {
        free(c.arena);
        free(c.heap);
        return -3;
    }
    long rc = -1;
    int64_t goal = -1;
    if (a_push(&c, a_get_h(len1, len2, 0, 0, target_len, eps), 0, 0, 0, -1,
               0, 0) < 0) {
        rc = -3;
        goto done;
    }
    long expansions = 0;
    for (;;) {
        int64_t si = a_pop(&c);
        if (si < 0) {
            rc = -1;
            goto done;
        }
        AState s = c.arena[si]; /* copy: arena may realloc on push */
        if (s.x == len2 && s.y == len1) {
            goal = si;
            rc = 0;
            break;
        }
        if (++expansions > max_expansions) {
            rc = -2;
            goto done;
        }
        long x = s.x, y = s.y;
        int32_t h = a_get_h(len1, len2, x, y, target_len, eps);
        if (x < len2) {
            int step = (semi_global && (y == 0 || y == len1)) ? 0
                       : s.in_q_gap ? ext
                                    : open_ + ext;
            if (a_push(&c, h, s.reach + step, (int32_t)(x + 1), (int32_t)y,
                       si, 1, s.in_db_gap) < 0) {
                rc = -3;
                goto done;
            }
        }
        if (y < len1) {
            int step = (semi_global && (x == 0 || x == len2)) ? 0
                       : s.in_db_gap ? ext
                                     : open_ + ext;
            if (a_push(&c, h, s.reach + step, (int32_t)x, (int32_t)(y + 1),
                       si, s.in_q_gap, 1) < 0) {
                rc = -3;
                goto done;
            }
        }
        if (x < len2 && y < len1) {
            uint8_t c1 = seq1[y], c2 = seq2[x];
            int cost = (c1 == c2 || c1 == 'N' || c2 == 'N') ? match : mismatch;
            if (a_push(&c, h, s.reach + cost, (int32_t)(x + 1),
                       (int32_t)(y + 1), si, 0, 0) < 0) {
                rc = -3;
                goto done;
            }
        }
    }
    /* reconstruct (pprint's parent-chain walk, align.rs:231-265) */
    {
        AState *g = &c.arena[goal];
        *out_score = g->reach;
        long n = 0;
        long x = g->x, y = g->y;
        int64_t cur = g->parent;
        while (cur >= 0) { /* emit reversed, flip below */
            AState *p = &c.arena[cur];
            if (n >= cap) {
                rc = -3;
                goto done;
            }
            if (p->x == x) {
                y -= 1;
                out2[n] = '-';
                out1[n] = (char)seq1[y];
            } else if (p->y == y) {
                x -= 1;
                out2[n] = (char)seq2[x];
                out1[n] = '-';
            } else {
                x -= 1;
                y -= 1;
                out2[n] = (char)seq2[x];
                out1[n] = (char)seq1[y];
            }
            n++;
            cur = p->parent;
        }
        for (long i = 0; i < n / 2; i++) {
            char t = out1[i];
            out1[i] = out1[n - 1 - i];
            out1[n - 1 - i] = t;
            t = out2[i];
            out2[i] = out2[n - 1 - i];
            out2[n - 1 - i] = t;
        }
        *out_len = n;
    }
done:
    free(c.arena);
    free(c.heap);
    return rc;
}

/* Threaded batch wrapper over astar_align_native: the reference driver's
 * db x query pair loop is embarrassingly parallel (per-pair isolation,
 * src/main.rs:61-78).  lens[b] = aligned length, or the per-pair rc
 * (-1 no-converge, -2 max_expansions, -3 alloc, -4 empty input). */
typedef struct {
    const uint8_t *buf1;
    const long *off1;
    const uint8_t *buf2;
    const long *off2;
    int match, mismatch, open_, ext;
    double eps;
    int semi;
    long max_exp;
    char *out1, *out2;
    long cap;
    long *lens;
    int32_t *scores;
    long b_lo, b_hi;
} ATask;

static void *astar_worker(void *arg) {
    ATask *t = (ATask *)arg;
    for (long b = t->b_lo; b < t->b_hi; b++) {
        long n1 = t->off1[b + 1] - t->off1[b];
        long n2 = t->off2[b + 1] - t->off2[b];
        long out_len = 0;
        long rc = astar_align_native(
            t->buf1 + t->off1[b], n1, t->buf2 + t->off2[b], n2,
            t->match, t->mismatch, t->open_, t->ext, t->eps, t->semi,
            t->max_exp, t->out1 + b * t->cap, t->out2 + b * t->cap,
            t->cap, &out_len, &t->scores[b]);
        t->lens[b] = rc == 0 ? out_len : rc;
    }
    return NULL;
}

void astar_align_batch(const uint8_t *buf1, const long *off1,
                       const uint8_t *buf2, const long *off2, long b_total,
                       int match, int mismatch, int open_, int ext,
                       double eps, int semi, long max_exp,
                       char *out1, char *out2, long cap,
                       long *lens, int32_t *scores, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    if (n_threads > b_total) n_threads = (int)(b_total > 0 ? b_total : 1);
    pthread_t tids[64];
    int running[64] = {0};
    ATask tasks[64];
    long per = (b_total + n_threads - 1) / n_threads;
    int started = 0;
    for (int k = 0; k < n_threads; k++) {
        long lo = k * per, hi = lo + per;
        if (lo >= b_total) break;
        if (hi > b_total) hi = b_total;
        tasks[k] = (ATask){buf1, off1, buf2, off2, match, mismatch, open_,
                           ext, eps, semi, max_exp, out1, out2, cap,
                           lens, scores, lo, hi};
        if (pthread_create(&tids[k], NULL, astar_worker, &tasks[k]) != 0) {
            astar_worker(&tasks[k]);
            started = k + 1;
            continue;
        }
        running[k] = 1;
        started = k + 1;
    }
    for (int k = 0; k < started; k++)
        if (running[k]) pthread_join(tids[k], NULL);
}
