/* Native host runtime of the PyTorch port: FASTA byte-scan, the co-optimal
 * first-path walker of the full 7-bit dirs, the threaded fast4 first-path
 * walker, the decoder of the device walks' packed op codes, the banded
 * fast4 walkers (row and wavefront layouts), the weighted-A* search and
 * the WFA engines (compat fill and walk, the textbook offset-log walker,
 * the exact textbook host engine).  The port's copy of every entry point
 * of sequencealigning_tpu/native/seqalign_native.c (same code, same
 * results), and the seqpar column relay's ordered count stores and loads
 * (its own).
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

/* Direction-bit layout (must match sequencealigning_tpu_torch.ops.dirbits). */
#define HM 1
#define HI 2
#define HD 4
#define IEXT 8
#define IOPEN 16
#define DEXT 32
#define DOPEN 64

static inline int byte_at(const uint32_t *dirs, long p, long d, long x) {
    return (int)((dirs[(d >> 2) * p + x] >> (8 * (d & 3))) & 0xFF);
}

/* First co-optimal global alignment from packed anti-diagonal dirs,
 * replicating the Python walker's LIFO order exactly (which replicates the
 * reference's, needleman_wunsch_affine.rs:242-334).
 *
 * out: per-column ops, 'M'/'I'/'D', written FORWARD (start of alignment
 * first).  Returns the number of columns, -1 if the walk hits a
 * reference-panic boundary, -2 if out_cap is too small, -3 internal.
 */
long gotoh_first_path(const uint32_t *dirs, long d4, long p, long d_off,
                      long n1, long n2, int compat,
                      int sm, int si, int sd,
                      char *out, long out_cap) {
    long max_depth = n1 + n2 + 2;
    if (out_cap < max_depth) return -2;
    /* Explicit DFS stack; each cell pushes <= 3 parents. */
    long cap = 3 * max_depth + 8;
    typedef struct { int plane; long x, y; long depth; char op; } Ent;
    Ent *stack = (Ent *)malloc(sizeof(Ent) * cap);
    if (!stack) return -3;
    long top = 0;

    int score = sm > si ? (sm > sd ? sm : sd) : (si > sd ? si : sd);
    /* Seed push order I, M, D (so D pops first). */
    if (si == score) stack[top++] = (Ent){PLANE_I, n2, n1, 0, 0};
    if (sm == score) stack[top++] = (Ent){PLANE_M, n2, n1, 0, 0};
    if (sd == score) stack[top++] = (Ent){PLANE_D, n2, n1, 0, 0};

    char *ops_rev = (char *)malloc(max_depth);
    if (!ops_rev) { free(stack); return -3; }
    long result = -3;

    while (top > 0) {
        Ent e = stack[--top];
        if (e.depth > 0) ops_rev[e.depth - 1] = e.op;
        if (e.x == 0 && e.y == 0) {
            /* Emit: ops_rev holds columns back-to-front. */
            for (long i = 0; i < e.depth; i++)
                out[i] = ops_rev[e.depth - 1 - i];
            result = e.depth;
            break;
        }
        /* Parent set of (x, y, plane). */
        int parents[3];
        int n_par = 0;
        if (e.x == 0 || e.y == 0) {
            if (compat) {
                if (e.x == 0 && e.y > 0 && e.plane == PLANE_D)
                    parents[n_par++] = PLANE_D;
                else if (e.y == 0 && e.x > 0 && e.plane == PLANE_I)
                    parents[n_par++] = PLANE_I;
            } else {
                if (e.x == 0 && e.y > 0 && e.plane == PLANE_I)
                    parents[n_par++] = PLANE_I;
                else if (e.y == 0 && e.x > 0 && e.plane == PLANE_D)
                    parents[n_par++] = PLANE_D;
            }
        } else if (e.plane == PLANE_M) {
            int b = byte_at(dirs, p, e.x + e.y - 2 + d_off, e.x - 1);
            if (b & HM) parents[n_par++] = PLANE_M;
            if (b & HI) parents[n_par++] = PLANE_I;
            if (b & HD) parents[n_par++] = PLANE_D;
        } else if (e.plane == PLANE_I) {
            int b = byte_at(dirs, p, e.x + e.y + d_off, e.x);
            if (b & IEXT) parents[n_par++] = PLANE_I;
            if (b & IOPEN) parents[n_par++] = PLANE_M;
        } else {
            int b = byte_at(dirs, p, e.x + e.y + d_off, e.x);
            if (b & DEXT) parents[n_par++] = PLANE_D;
            if (b & DOPEN) parents[n_par++] = PLANE_M;
        }
        for (int i = 0; i < n_par; i++) {
            long nx, ny; char op;
            if (e.plane == PLANE_M) {
                if (e.x == 0 || e.y == 0) { result = -1; goto done; }
                nx = e.x - 1; ny = e.y - 1; op = 'M';
            } else if (e.plane == PLANE_D) {
                if (e.x == 0) { result = -1; goto done; }
                nx = e.x - 1; ny = e.y; op = 'D';
            } else {
                if (e.y == 0) { result = -1; goto done; }
                nx = e.x; ny = e.y - 1; op = 'I';
            }
            if (top >= cap) { result = -3; goto done; }
            stack[top++] = (Ent){parents[i], nx, ny, e.depth + 1, op};
        }
    }
done:
    free(ops_rev);
    free(stack);
    return result;
}

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

/* Banded fast4 walkers.  Two dirs layouts share ONE walk (same 4-bit code
 * semantics; must mirror ops/traceback.py::_banded_fast4_walk exactly --
 * tests fuzz C vs Python):
 *   layout 0 (ops/nw_banded, row-packed):  word dirs[x/8, b, (y-x)-k_lo],
 *     shift 4*(x%8); k_dim = K lanes.
 *   layout 1 (ops/nw_banded_diag, wavefront-packed):  word
 *     dirs[(x+y-1)/8, b, ((y-x)-k_lo_even)/2], shift 4*((x+y-1)%8);
 *     k_dim = L lanes, k_lo = k_lo_even. */
typedef struct {
    const uint32_t *dirs;
    long w_dim, b_dim, k_dim; /* tensor dims (words, batch, lanes) */
    long b, k_lo;
    int layout;
} BF4Ctx;

static inline int bf4_nibble(const BF4Ctx *c, long x, long y) {
    long w, lane, slot;
    if (c->layout == 0) {
        lane = (y - x) - c->k_lo;
        w = x >> 3;
        slot = x & 7;
    } else {
        lane = ((y - x) - c->k_lo) >> 1;
        long aidx = x + y - 1;
        if (aidx < 0) return 0;
        w = aidx >> 3;
        slot = aidx & 7;
    }
    if (lane < 0 || lane >= c->k_dim || w >= c->w_dim) return 0;
    return (int)((c->dirs[(w * c->b_dim + c->b) * c->k_dim + lane]
                  >> (4 * slot)) & 0xF);
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
    /* layout 0 callers guarantee x/8 < the word dim; no bound needed */
    BF4Ctx ctx = {dirs, LONG_MAX, b_dim, k_dim, b, k_lo, 0};
    return bf4_walk(&ctx, n1, n2, sm, si, sd, out, cap);
}

long banded_diag_fast4_first_path(const uint32_t *dirs, long w_dim,
                                  long b_dim, long k_dim,
                                  long b, long k_lo_even, long n1, long n2,
                                  int sm, int si, int sd,
                                  char *out, long cap) {
    BF4Ctx ctx = {dirs, w_dim, b_dim, k_dim, b, k_lo_even, 1};
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

/* The WFA entry points below are copied from
 * sequencealigning_tpu/native/seqalign_native.c: the compat fill and
 * walk (wfa_compat_align), the textbook offset-log walker
 * (wfa_textbook_traceback) and the exact textbook host engine
 * (wfa_textbook_align_batch). */

/* ------------------------------------------------------- compat WFA ----
 * Native port of ops/oracle_wfa.py (itself a bit-faithful emulation of the
 * reference's src/wfa.rs, quirks included).  Semantics must match the
 * Python oracle EXACTLY -- tests fuzz the two against each other.
 *
 * States: 0 = M, 1 = I, 2 = D (parents stored as a bitmask; only
 * membership is ever tested).  Error codes (mapped to the Python oracle's
 * AlignmentError messages by the ctypes glue):
 *   -1 not converged within max_steps
 *   -2 provably never converges
 *   -3 empty sequence
 *   -4 allocation / capacity failure
 *   -5 traceback: slice start > end  ("reference would panic")
 *   -6 traceback: slice out of range
 *   -7 traceback did not terminate
 */

#define WM 0
#define WI 1
#define WD 2

typedef struct {
    int32_t offset;
    uint8_t present;
    uint8_t state;
    uint8_t parents; /* bitmask 1<<state */
} WElem;

typedef struct {
    int32_t lo, hi;
    int32_t n;       /* element count (may disagree with hi-lo+1, faithful) */
    WElem *el;
    uint8_t present;
} WWf;

typedef struct {
    WWf i, d, m;
    uint8_t present;
} WTensor;

static WElem *wf_get(WWf *w, long idx) {
    if (!w->present) return NULL;
    long pos = idx - w->lo;
    if (pos < 0 || pos >= w->n) return NULL;
    WElem *e = &w->el[pos];
    return e->present ? e : NULL;
}

static long welem_x(const WElem *e, long diag) {
    return e->offset - (diag < 0 ? diag : 0);
}
static long welem_y(const WElem *e, long diag) {
    return e->offset + (diag > 0 ? diag : 0);
}
static long welem_dist(const WElem *e, long len1, long len2, long diag) {
    long a = len1 - e->offset - diag;
    long b = len2 - e->offset;
    return a > b ? a : b;
}

static void wf_free(WWf *w) { free(w->el); w->el = NULL; }

/* tensor_new (wfa.rs:225-420 / oracle_wfa.tensor_new), verbatim. */
static int wfa_tensor_new(WTensor *open_t, WTensor *ext_t, WTensor *mis_t,
                          WTensor *out) {
    memset(out, 0, sizeof(*out));
    WWf *open_m = (open_t && open_t->present && open_t->m.present) ? &open_t->m : NULL;
    WWf *ext_i = (ext_t && ext_t->present && ext_t->i.present) ? &ext_t->i : NULL;
    WWf *ext_d = (ext_t && ext_t->present && ext_t->d.present) ? &ext_t->d : NULL;
    WWf *mis_m = (mis_t && mis_t->present && mis_t->m.present) ? &mis_t->m : NULL;

    long hi = 0, lo = 0;
    int has_hi = 0, has_lo = 0;
    WWf *srcs_hi[4] = {open_m, mis_m, ext_i, ext_d};
    for (int k = 0; k < 4; k++) {
        if (srcs_hi[k]) {
            if (!has_hi || srcs_hi[k]->hi > hi) hi = srcs_hi[k]->hi;
            has_hi = 1;
            if (!has_lo || srcs_hi[k]->lo < lo) lo = srcs_hi[k]->lo;
            has_lo = 1;
        }
    }
    if (!has_hi || !has_lo) return 0; /* tensor absent */
    hi += 1;
    lo -= 1;

    long width = hi - lo + 1;
    WElem *ti = calloc(width, sizeof(WElem));
    WElem *td = calloc(width, sizeof(WElem));
    WElem *tm = calloc(width, sizeof(WElem));
    if (!ti || !td || !tm) { free(ti); free(td); free(tm); return -4; }

    long lo_i = 0, hi_i = 0, lo_d = 0, hi_d = 0, lo_m = 0, hi_m = 0;
    int set_i = 0, set_d = 0, set_m = 0;

    for (long idx = lo; idx <= hi; idx++) {
        long j = idx - lo;
        /* D: same offset from open.m[idx+1] / ext.d[idx+1]. */
        WElem *c1 = open_m ? wf_get(open_m, idx + 1) : NULL;
        WElem *c2 = ext_d ? wf_get(ext_d, idx + 1) : NULL;
        if (c1 || c2) {
            int32_t off = c1 ? c1->offset : c2->offset;
            if (c2 && c2->offset > off) off = c2->offset;
            uint8_t par = 0;
            if (c1 && c1->offset == off) par |= 1 << c1->state;
            if (c2 && c2->offset == off) par |= 1 << c2->state;
            td[j] = (WElem){off, 1, WD, par};
            hi_d = idx;
            if (!set_d) { lo_d = idx; set_d = 1; }
        }
        /* I: offset+1 from open.m[idx-1] / ext.i[idx-1]; parents tested
         * against the PRE-increment offset. */
        c1 = open_m ? wf_get(open_m, idx - 1) : NULL;
        c2 = ext_i ? wf_get(ext_i, idx - 1) : NULL;
        if (c1 || c2) {
            int32_t off = c1 ? c1->offset : c2->offset;
            if (c2 && c2->offset > off) off = c2->offset;
            uint8_t par = 0;
            if (c1 && c1->offset == off) par |= 1 << c1->state;
            if (c2 && c2->offset == off) par |= 1 << c2->state;
            ti[j] = (WElem){(int32_t)(off + 1), 1, WI, par};
            hi_i = idx;
            if (!set_i) { lo_i = idx; set_i = 1; }
        }
        /* M: max of mis.m[idx]+1 and the new i/d at idx. */
        WElem *mm = mis_m ? wf_get(mis_m, idx) : NULL;
        WElem *ni = ti[j].present ? &ti[j] : NULL;
        WElem *nd = td[j].present ? &td[j] : NULL;
        if (mm || ni || nd) {
            long off = LONG_MIN;
            if (mm && mm->offset + 1 > off) off = mm->offset + 1;
            if (ni && ni->offset > off) off = ni->offset;
            if (nd && nd->offset > off) off = nd->offset;
            uint8_t par = 0;
            if (mm && mm->offset + 1 == off) par |= 1 << WM;
            if (ni && ni->offset == off) par |= 1 << WI;
            if (nd && nd->offset == off) par |= 1 << WD;
            tm[j] = (WElem){(int32_t)off, 1, WM, par};
            hi_m = idx;
            if (!set_m) { lo_m = idx; set_m = 1; }
        }
    }

    /* Slice each plane to its tracked span (equivalent to the Rust
     * rotate_left + truncate, see oracle_wfa.tensor_new). */
    out->present = 1;
    struct { WWf *w; WElem *tmp; long l, h; int set; } planes[3] = {
        {&out->i, ti, lo_i, hi_i, set_i},
        {&out->d, td, lo_d, hi_d, set_d},
        {&out->m, tm, lo_m, hi_m, set_m},
    };
    for (int k = 0; k < 3; k++) {
        WWf *w = planes[k].w;
        if (!planes[k].set) {
            w->present = 0;
            /* faithful: python sets lo/hi to the untracked init (hi, lo of
             * the full range) but the wavefront is None -- never read. */
            continue;
        }
        long span = planes[k].h - planes[k].l + 1;
        w->el = malloc(span * sizeof(WElem));
        if (!w->el) {
            free(ti); free(td); free(tm);
            for (int q = 0; q < k; q++) {
                free(planes[q].w->el);
                planes[q].w->el = NULL;
                planes[q].w->present = 0;
            }
            return -4;
        }
        memcpy(w->el, planes[k].tmp + (planes[k].l - lo), span * sizeof(WElem));
        w->lo = planes[k].l;
        w->hi = planes[k].h;
        w->n = span;
        w->present = 1;
    }
    free(ti); free(td); free(tm);
    return 0;
}

/* Greedy match extension of the M wavefront (wfa.rs:127-139). */
static void wfa_expand_m(WWf *m, const uint8_t *s1, long n1,
                         const uint8_t *s2, long n2) {
    if (!m->present) return;
    for (long i = 0; i < m->n; i++) {
        WElem *e = &m->el[i];
        if (!e->present) continue;
        long diag = m->lo + i;
        while (welem_y(e, diag) < n1 && welem_x(e, diag) < n2 &&
               s1[welem_y(e, diag)] == s2[welem_x(e, diag)])
            e->offset += 1;
    }
}

/* Adaptive trim (wfa.rs:490-623 / oracle_wfa.Ocean.trim), verbatim incl.
 * the min_d=0 quirk and the wrapping-truncate I/D clamp. */
static void wfa_trim(WTensor *t, long n1, long n2, int minlen, int maxdiff) {
    if (!t->present || !t->m.present) return;
    WWf *m = &t->m;
    long span = m->lo - m->hi; if (span < 0) span = -span;
    if (span <= minlen) return;

    long min_d = 0;
    for (long diag = m->lo; diag <= m->hi; diag++) {
        WElem *e = wf_get(m, diag);
        if (e) {
            long d = welem_dist(e, n1, n2, diag);
            if (d < min_d) min_d = d;
        }
    }
    /* drop leading diagonals */
    long next_d = welem_dist(&m->el[0], n1, n2, m->lo);
    while (m->lo < m->hi && labs(next_d - min_d) > maxdiff) {
        m->lo += 1;
        memmove(m->el, m->el + 1, (m->n - 1) * sizeof(WElem));
        m->n -= 1;
        while (wf_get(m, m->lo) == NULL) {
            if (m->lo == m->hi) break;
            m->lo += 1;
            memmove(m->el, m->el + 1, (m->n - 1) * sizeof(WElem));
            m->n -= 1;
        }
        next_d = welem_dist(&m->el[0], n1, n2, m->lo);
    }
    /* drop trailing diagonals */
    next_d = welem_dist(&m->el[m->n - 1], n1, n2, m->hi);
    while (m->hi > m->lo && labs(next_d - min_d) > maxdiff) {
        m->hi -= 1; m->n -= 1;
        while (wf_get(m, m->hi) == NULL) {
            if (m->lo == m->hi) break;
            m->hi -= 1; m->n -= 1;
        }
        next_d = welem_dist(&m->el[m->n - 1], n1, n2, m->hi);
    }

    /* Clamp I/D to M's span. */
    WWf *planes[2] = {&t->i, &t->d};
    for (int k = 0; k < 2; k++) {
        WWf *w = planes[k];
        if (!w->present) continue;
        long tr;
        if (w->lo < m->lo) {
            long rot = m->lo - w->lo;
            if (rot > w->n) rot = w->n; /* rotate by more is identity mod n;
                faithful enough: python rotates by k%len implicitly via
                slicing -- python k can exceed len: elements[k:]+[:k] with
                k > len gives [] + all = unchanged?  No: python slicing
                clamps, giving elements unchanged; replicate by clamping. */
            if (rot > 0 && rot < w->n) {
                WElem *tmp = malloc(w->n * sizeof(WElem));
                if (tmp) {
                    memcpy(tmp, w->el + rot, (w->n - rot) * sizeof(WElem));
                    memcpy(tmp + (w->n - rot), w->el, rot * sizeof(WElem));
                    memcpy(w->el, tmp, w->n * sizeof(WElem));
                    free(tmp);
                }
            }
            long extra = (w->hi > m->hi) ? (w->hi - m->hi) : 0;
            tr = (m->lo - w->lo) + extra;
        } else if (w->hi > m->hi) {
            tr = w->hi - m->hi;
        } else {
            tr = 0;
        }
        long new_len = w->n - tr;
        if (new_len >= 0) w->n = new_len;
        if (w->hi > m->hi) w->hi = m->hi;
        if (w->lo < m->lo) w->lo = m->lo;
    }
}

static WElem *wfa_converged(WTensor *t, long n1, long n2, long *out_diag) {
    if (!t || !t->present) return NULL;
    WWf *order[3] = {&t->i, &t->d, &t->m};
    for (int k = 0; k < 3; k++) {
        WWf *w = order[k];
        if (!w->present) continue;
        for (long i = 0; i < w->n; i++) {
            WElem *e = &w->el[i];
            if (!e->present) continue;
            long diag = w->lo + i;
            if (welem_x(e, diag) == n2 - 1 && welem_y(e, diag) == n1 - 1) {
                if (out_diag) *out_diag = diag;
                return e;
            }
        }
    }
    return NULL;
}

/* Full compat WFA: fill + rec_tr traceback.  Writes the gapped alignment
 * strings (latin-1 bytes) to a1/a2 (forward order, NUL-free, lengths via
 * out_lens).  Returns the reported score (len(wfs)) or a negative error
 * code.  Capacity: a1/a2 must hold n1+n2+16 bytes. */
long wfa_compat_align(const uint8_t *s1, long n1, const uint8_t *s2, long n2,
                      int x_pen, int o_pen, int e_pen,
                      int minlen, int maxdiff, long max_steps,
                      char *a1_out, char *a2_out, long *out_lens) {
    if (n1 == 0 || n2 == 0) return -3;
    long provable = (n1 + n2) * (x_pen + o_pen + e_pen) + 4;
    long cap_steps = max_steps < provable ? max_steps : provable;

    long cap = cap_steps + 8;
    WTensor *wfs = calloc(cap, sizeof(WTensor));
    if (!wfs) return -4;
    long n_wfs = 0;
    /* seed */
    wfs[0].present = 1;
    wfs[0].m.present = 1;
    wfs[0].m.lo = 0; wfs[0].m.hi = 0; wfs[0].m.n = 1;
    wfs[0].m.el = malloc(sizeof(WElem));
    if (!wfs[0].m.el) { free(wfs); return -4; }
    wfs[0].m.el[0] = (WElem){0, 1, WM, 0};
    n_wfs = 1;

    long result = 0;
    long steps = 0;
    while (wfa_converged(&wfs[n_wfs - 1], n1, n2, NULL) == NULL) {
        if (steps >= cap_steps) {
            result = (cap_steps == max_steps) ? -1 : -2;
            goto done;
        }
        long s = n_wfs;
        long k_open = s - o_pen - e_pen, k_ext = s - e_pen, k_mis = s - x_pen;
        WTensor *t_open = (k_open >= 0 && k_open < n_wfs) ? &wfs[k_open] : NULL;
        WTensor *t_ext = (k_ext >= 0 && k_ext < n_wfs) ? &wfs[k_ext] : NULL;
        WTensor *t_mis = (k_mis >= 0 && k_mis < n_wfs) ? &wfs[k_mis] : NULL;
        int rc = wfa_tensor_new(t_open, t_ext, t_mis, &wfs[n_wfs]);
        if (rc < 0) { n_wfs += wfs[n_wfs].present ? 1 : 0; result = rc; goto done; }
        if (wfs[n_wfs].present)
            wfa_expand_m(&wfs[n_wfs].m, s1, n1, s2, n2);
        n_wfs += 1;
        wfa_trim(&wfs[n_wfs - 1], n1, n2, minlen, maxdiff);
        steps += 1;
    }
    result = n_wfs; /* score = len(wfs), the reference's off-by-one report */

    /* ---- rec_tr traceback (oracle_wfa.wfa_traceback, verbatim) ---- */
    {
        long diag = n1 - n2;
        WElem *ce = wfa_converged(&wfs[n_wfs - 1], n1, n2, NULL);
        long a1n = 0, a2n = 0; /* build REVERSED, flip at the end */
        if (ce != NULL) {
            WElem cur = *ce;
            long current_score = n_wfs;
            long guard = 0, guard_max = n1 + n2 + 16 + n_wfs;
            long acap = n1 + n2 + 16;
            #define EXT_REV(dst, dn, seq, start, stop) do { \
                if ((start) > (stop)) { result = -5; goto done; } \
                if ((start) < 0 || (stop) > (seq##_len)) { result = -6; goto done; } \
                for (long _q = (stop) - 1; _q >= (start); _q--) { \
                    if (dn >= acap) { result = -4; goto done; } \
                    dst[dn++] = (char)seq[_q]; } \
            } while (0)
            long s1_len = n1, s2_len = n2;
            while (!(diag == 0 && cur.offset == 0)) {
                if (++guard > guard_max) { result = -7; goto done; }
                int moved = 0;
                int pens[3] = {x_pen, e_pen, o_pen + e_pen};
                for (int pi = 0; pi < 3 && !moved; pi++) {
                    long d_pen = pens[pi];
                    if (d_pen > current_score) continue;
                    long next_score = current_score - d_pen;
                    WTensor *t = (next_score >= 0 && next_score < n_wfs)
                                     ? &wfs[next_score] : NULL;
                    if (!t || !t->present) continue;
                    /* Dispatch by penalty VALUE, exactly like the Python
                     * oracle's if/elif chain: with colliding penalties
                     * (e.g. x == e) the mismatch branch shadows the others
                     * on later iterations too. */
                    if (d_pen == x_pen) { /* mismatch */
                        if (cur.state != WM && (cur.parents & (1 << WM))) {
                            WElem *w = t->m.present ? wf_get(&t->m, diag) : NULL;
                            if (w) {
                                EXT_REV(a1_out, a1n, s1, welem_y(w, diag), welem_y(&cur, diag));
                                EXT_REV(a2_out, a2n, s2, welem_x(w, diag), welem_x(&cur, diag));
                                cur = *w; current_score = next_score; moved = 1;
                            }
                        }
                    } else if (d_pen == e_pen) { /* gap extend */
                        if (cur.parents & (1 << WD)) {
                            WElem *w = t->d.present ? wf_get(&t->d, diag - 1) : NULL;
                            if (w) {
                                EXT_REV(a1_out, a1n, s1, welem_y(w, diag), welem_y(&cur, diag));
                                if (a2n >= acap) { result = -4; goto done; }
                                a2_out[a2n++] = '-';
                                EXT_REV(a2_out, a2n, s2, welem_x(w, diag), welem_x(&cur, diag));
                                diag -= 1;
                                cur = *w; current_score = next_score; moved = 1;
                                continue;
                            }
                        }
                        WElem *w = t->i.present ? wf_get(&t->i, diag + 1) : NULL;
                        if (w) {
                            if (a1n >= acap) { result = -4; goto done; }
                            a1_out[a1n++] = '-';
                            EXT_REV(a1_out, a1n, s1, welem_y(w, diag), welem_y(&cur, diag));
                            EXT_REV(a2_out, a2n, s2, welem_x(w, diag), welem_x(&cur, diag));
                            diag += 1;
                            cur = *w; current_score = next_score; moved = 1;
                        }
                    } else if (cur.parents & (1 << WM)) { /* gap open */
                        if (cur.state == WD) {
                            WElem *w = t->d.present ? wf_get(&t->d, diag - 1) : NULL;
                            if (w) {
                                EXT_REV(a1_out, a1n, s1, welem_y(w, diag), welem_y(&cur, diag));
                                if (a2n >= acap) { result = -4; goto done; }
                                a2_out[a2n++] = '-';
                                EXT_REV(a2_out, a2n, s2, welem_x(w, diag), welem_x(&cur, diag));
                                diag -= 1;
                                cur = *w; current_score = next_score; moved = 1;
                            }
                        } else if (cur.state == WI) {
                            WElem *w = t->i.present ? wf_get(&t->i, diag + 1) : NULL;
                            if (w) {
                                if (a1n >= acap) { result = -4; goto done; }
                                a1_out[a1n++] = '-';
                                EXT_REV(a1_out, a1n, s1, welem_y(w, diag), welem_y(&cur, diag));
                                EXT_REV(a2_out, a2n, s2, welem_x(w, diag), welem_x(&cur, diag));
                                diag += 1;
                                cur = *w; current_score = next_score; moved = 1;
                            }
                        } else { /* state M: try I then D (wfa.rs:801-842) */
                            WElem *w = t->i.present ? wf_get(&t->i, diag + 1) : NULL;
                            if (w) {
                                if (a1n >= acap) { result = -4; goto done; }
                                a1_out[a1n++] = '-';
                                EXT_REV(a1_out, a1n, s1, welem_y(w, diag), welem_y(&cur, diag));
                                EXT_REV(a2_out, a2n, s2, welem_x(w, diag), welem_x(&cur, diag));
                                diag += 1;
                                cur = *w; current_score = next_score; moved = 1;
                            } else {
                                w = t->d.present ? wf_get(&t->d, diag - 1) : NULL;
                                if (w) {
                                    EXT_REV(a1_out, a1n, s1, welem_y(w, diag), welem_y(&cur, diag));
                                    /* sic: the reference pushes the gap onto
                                     * seq1 here (wfa.rs:829), bug preserved */
                                    if (a1n >= acap) { result = -4; goto done; }
                                    a1_out[a1n++] = '-';
                                    EXT_REV(a2_out, a2n, s2, welem_x(w, diag), welem_x(&cur, diag));
                                    diag -= 1;
                                    cur = *w; current_score = next_score; moved = 1;
                                }
                            }
                        }
                    }
                }
                if (!moved) break; /* "huh": partial alignment returned */
            }
            #undef EXT_REV
        }
        /* reverse in place */
        for (long i = 0; i < a1n / 2; i++) {
            char tmp = a1_out[i]; a1_out[i] = a1_out[a1n - 1 - i]; a1_out[a1n - 1 - i] = tmp;
        }
        for (long i = 0; i < a2n / 2; i++) {
            char tmp = a2_out[i]; a2_out[i] = a2_out[a2n - 1 - i]; a2_out[a2n - 1 - i] = tmp;
        }
        out_lens[0] = a1n;
        out_lens[1] = a2n;
    }

done:
    for (long i = 0; i < n_wfs; i++) {
        if (wfs[i].present) {
            wf_free(&wfs[i].i); wf_free(&wfs[i].d);
            /* m.el may have been advanced by trim pops?  No: pops memmove
             * within the same allocation, pointer unchanged. */
            wf_free(&wfs[i].m);
        }
    }
    free(wfs);
    return result;
}

/* ------------------------------------------------ WFA traceback -------
 * Textbook-WFA alignment reconstruction from the int16 offset-history log
 * ((S, 3, B, K) M/I/D furthest-reaching offsets; NEG = absent).  Must
 * mirror ops/wfa.py::wfa_traceback_host exactly (tests fuzz the two):
 * tie priority mismatch > I > D.  Emits backward then reverses.  Returns
 * the alignment length, or -1 (no terminate) / -2 (cap too small). */

#define WFA_NEG (-(1 << 14))

/* Accessor abstraction over "furthest-reaching offset of plane p at
 * penalty s, diagonal k": the walk below is shared by the banded int16
 * offset-log layout (TPU engine) and the exact level-array layout (native
 * engine) so the tie order (mismatch > I > D) has exactly one
 * implementation. */
typedef int32_t (*TWfAt)(const void *ctx, int plane, long s, long k);

typedef struct {
    const int16_t *hist;
    long S, B, K, b, k_lo;
    long stride; /* hist row j holds score j * stride (score lattice) */
} WfaHistCtx;

static int32_t wfa_hist_at(const void *vctx, int plane, long s, long k) {
    const WfaHistCtx *c = (const WfaHistCtx *)vctx;
    long lane = k - c->k_lo;
    if (s < 0 || s % c->stride || lane < 0 || lane >= c->K) return WFA_NEG;
    long row = s / c->stride;
    if (row >= c->S) return WFA_NEG;
    return (int32_t)c->hist[((row * 3 + plane) * c->B + c->b) * c->K + lane];
}

static long wfa_tb_walk(TWfAt at, const void *ctx, long score,
                        const uint8_t *seq1, long n1,
                        const uint8_t *seq2, long n2,
                        int x_pen, int o_pen, int e_pen,
                        char *a1, char *a2, long cap) {
    long oe = o_pen + e_pen;
    long s = score;
    long k = n1 - n2;
    long t = n2;
    int state = 0; /* 0=M 1=I 2=D */
    long n = 0;
    long guard = 4 * (n1 + n2) + s + 16;
    if (cap < n1 + n2 + 4) return -2;
    for (;;) {
        if (--guard < 0) return -1;
        if (state == 0) {
            if (s == 0) {
                /* initial seed: t leading matches on diag 0 */
                for (long tt = t - 1; tt >= 0; tt--) {
                    if (n >= cap) return -2;
                    a1[n] = (char)seq1[tt + k];
                    a2[n] = (char)seq2[tt];
                    n++;
                }
                break;
            }
            int mx = at(ctx, 0, s - x_pen, k);
            int iv = at(ctx, 1, s, k);
            int dv = at(ctx, 2, s, k);
            long mx1 = (mx > WFA_NEG) ? mx + 1 : WFA_NEG;
            long t_pre = mx1 > iv ? mx1 : iv;
            if (dv > t_pre) t_pre = dv;
            for (long tt = t - 1; tt >= t_pre; tt--) {
                if (n >= cap) return -2;
                a1[n] = (char)seq1[tt + k];
                a2[n] = (char)seq2[tt];
                n++;
            }
            t = t_pre;
            if (mx > WFA_NEG && t_pre == mx1) {
                if (n >= cap) return -2;
                a1[n] = (char)seq1[t - 1 + k];
                a2[n] = (char)seq2[t - 1];
                n++;
                s -= x_pen;
                t -= 1;
            } else if (t_pre == iv) {
                state = 1;
            } else {
                state = 2;
            }
        } else if (state == 1) {
            if (n >= cap) return -2;
            a1[n] = (char)seq1[t + k - 1];
            a2[n] = '-';
            n++;
            int m_src = at(ctx, 0, s - oe, k - 1);
            if (m_src == t) { s -= oe; k -= 1; state = 0; }
            else { s -= e_pen; k -= 1; }
        } else {
            if (n >= cap) return -2;
            a1[n] = '-';
            a2[n] = (char)seq2[t - 1];
            n++;
            int m_src = at(ctx, 0, s - oe, k + 1);
            if (m_src == t - 1) { s -= oe; k += 1; t -= 1; state = 0; }
            else { s -= e_pen; k += 1; t -= 1; }
        }
    }
    for (long i = 0; i < n / 2; i++) {
        char c;
        c = a1[i]; a1[i] = a1[n - 1 - i]; a1[n - 1 - i] = c;
        c = a2[i]; a2[i] = a2[n - 1 - i]; a2[n - 1 - i] = c;
    }
    return n;
}

long wfa_textbook_traceback(const int16_t *hist, long S, long B, long K,
                            long b, long k_lo, long score, long stride,
                            const uint8_t *seq1, long n1,
                            const uint8_t *seq2, long n2,
                            int x_pen, int o_pen, int e_pen,
                            char *a1, char *a2, long cap) {
    WfaHistCtx ctx = {hist, S, B, K, b, k_lo, stride > 0 ? stride : 1};
    return wfa_tb_walk(wfa_hist_at, &ctx, score, seq1, n1, seq2, n2,
                       x_pen, o_pen, e_pen, a1, a2, cap);
}

/* ------------------------------------------- exact textbook WFA (host) ----
 * Full-precision gap-affine WFA (Marco-Sola et al. 2021, public
 * algorithm), the native analog of ops/wfa.py's wavefront engine but with
 * dynamic per-level spans instead of a static band -- exact for every
 * scheme, no band certificate needed.  Same clean convention as ops/wfa
 * (diag k = y - x, offset t = x = db chars consumed) and the same
 * recurrence/masking, so stored offsets -- and therefore the shared
 * wfa_tb_walk tie order -- agree with the TPU engine wherever its band
 * covers the span (tests fuzz byte-equality at saturating bands).
 *
 * Rationale (PERF.md): the per-step extension needs one random access per
 * live diagonal; XLA lowers that to a ~14 ns/element gather, which is
 * ~90% of the TPU engine's step time, while here it is an L1-resident
 * u64-chunked compare.  WFA is output-sensitive (work ~ penalty *
 * span), so the scalar engine wins exactly where WFA itself wins.
 */

typedef struct { long lo, hi; int32_t *off; } TWf; /* absent: off == NULL */
typedef struct { TWf m, i, d; } TLev;

static int32_t twf_at(const TWf *w, long k) {
    if (!w->off || k < w->lo || k > w->hi) return WFA_NEG;
    return w->off[k - w->lo];
}

typedef struct { const TLev *lev; long n_lev; } TLevCtx;

static int32_t wfa_lev_at(const void *vctx, int plane, long s, long k) {
    const TLevCtx *c = (const TLevCtx *)vctx;
    if (s < 0 || s >= c->n_lev) return WFA_NEG;
    const TLev *l = &c->lev[s];
    const TWf *w = plane == 0 ? &l->m : (plane == 1 ? &l->i : &l->d);
    return twf_at(w, k);
}

/* Greedy match extension from offset t on diagonal k, 8 chars per probe
 * (little-endian ctz picks the first differing byte). */
static long twfa_extend(const uint8_t *s1, long n1, const uint8_t *s2,
                        long n2, long k, long t) {
    long y = t + k;
    while (n2 - t >= 8 && n1 - y >= 8) {
        uint64_t a, b;
        memcpy(&a, s1 + y, 8);
        memcpy(&b, s2 + t, 8);
        uint64_t d = a ^ b;
        if (d) return t + (__builtin_ctzll(d) >> 3);
        t += 8;
        y += 8;
    }
    while (t < n2 && y < n1 && s1[y] == s2[t]) { t++; y++; }
    return t;
}

static inline int twfa_ok(long t, long k, long n1, long n2) {
    long y = t + k;
    return t >= 0 && t <= n2 && y >= 0 && y <= n1;
}

/* dst[k - lo] = twf_at(src, k + shift) for k in [lo, hi]: the in-range
 * middle is one memcpy, the flanks are WFA_NEG fills.  Staging the shifted
 * source spans into dense scratch rows turns the per-diagonal recurrences
 * into branchless max/select loops the compiler auto-vectorizes. */
static void twf_gather(int32_t *dst, long lo, long hi, const TWf *src,
                       long shift) {
    long n = hi - lo + 1;
    if (!src || !src->off) {
        for (long i = 0; i < n; i++) dst[i] = WFA_NEG;
        return;
    }
    long a = src->lo - shift; /* k range where k + shift is in-span */
    long b = src->hi - shift;
    if (a < lo) a = lo;
    if (b > hi) b = hi;
    for (long k = lo; k < a; k++) dst[k - lo] = WFA_NEG;
    if (a <= b)
        memcpy(dst + (a - lo), src->off + (a + shift - src->lo),
               (size_t)(b - a + 1) * sizeof(int32_t));
    for (long k = (a <= b ? b + 1 : a); k <= hi; k++) dst[k - lo] = WFA_NEG;
}

static void twfa_free_levels(TLev *lev, long n) {
    for (long i = 0; i < n; i++) {
        free(lev[i].m.off);
        free(lev[i].i.off);
        free(lev[i].d.off);
    }
    free(lev);
}

/* Multi-version the wavefront fill for the host ISA: the recurrence loops
 * are plain int32 max/compare/select streams that vectorize 8-16 wide on
 * AVX2/AVX-512, and the library must stay portable when a prebuilt .so
 * ships in a wheel -- target_clones picks the widest supported variant at
 * load time via the glibc ifunc resolver. */
#if defined(__x86_64__) && defined(__gnu_linux__) && defined(__GNUC__) && \
    __GNUC__ >= 11 && !defined(__clang__)
#define WFA_ISA_CLONES \
    __attribute__((target_clones("arch=x86-64-v4,arch=x86-64-v3,default")))
#else
#define WFA_ISA_CLONES
#endif

/* Exact fill + traceback for one pair.  Returns the penalty (>= 0) or:
 *   -1 no convergence within s_max,  -4 allocation / memory budget. */
WFA_ISA_CLONES
long wfa_textbook_align(const uint8_t *s1, long n1, const uint8_t *s2,
                        long n2, int x_pen, int o_pen, int e_pen,
                        long s_max, long mem_budget,
                        char *a1_out, char *a2_out, long *out_lens) {
    if (n1 == 0 || n2 == 0) {
        /* closed-form pure-gap chains (match the engine's I/D recurrence) */
        long pen = (n1 == 0 && n2 == 0) ? 0
                   : o_pen + e_pen * (n1 > n2 ? n1 : n2);
        for (long q = 0; q < n1; q++) { a1_out[q] = (char)s1[q]; a2_out[q] = '-'; }
        for (long q = 0; q < n2; q++) { a1_out[q] = '-'; a2_out[q] = (char)s2[q]; }
        out_lens[0] = out_lens[1] = n1 > n2 ? n1 : n2;
        return pen;
    }
    long oe = o_pen + e_pen;
    long k_target = n1 - n2;
    long k_min = -n2, k_max = n1;
    long provable = (n1 + n2) * (x_pen + oe) + 4;
    long cap_s = s_max < provable ? s_max : provable;

    long lev_cap = 256;
    TLev *lev = calloc(lev_cap, sizeof(TLev));
    if (!lev) return -4;
    long used = lev_cap * (long)sizeof(TLev);

    /* scratch rows for the staged (shifted) source spans */
    long max_w = n1 + n2 + 3;
    int32_t *scr = malloc((size_t)(3 * max_w) * sizeof(int32_t));
    if (!scr) { free(lev); return -4; }
    used += 3 * max_w * (long)sizeof(int32_t);
    int32_t *tmp_a = scr, *tmp_b = scr + max_w, *tmp_c = scr + 2 * max_w;
    /* int32 copies for the vector loops (offsets are stored int32 already,
     * so n1/n2 and every t/y fit int32 by construction) */
    const int32_t vn1 = (int32_t)n1, vn2 = (int32_t)n2;

    /* seed */
    lev[0].m.lo = lev[0].m.hi = 0;
    lev[0].m.off = malloc(sizeof(int32_t));
    if (!lev[0].m.off) { free(scr); free(lev); return -4; }
    lev[0].m.off[0] = (int32_t)twfa_extend(s1, n1, s2, n2, 0, 0);
    long n_lev = 1;
    long final_s = -1;
    if (k_target == 0 && lev[0].m.off[0] >= n2) final_s = 0;

    while (final_s < 0) {
        long s = n_lev;
        if (s > cap_s) { free(scr); twfa_free_levels(lev, n_lev); return -1; }
        if (s >= lev_cap) {
            long nc = lev_cap * 2;
            TLev *nl = realloc(lev, nc * sizeof(TLev));
            if (!nl) { free(scr); twfa_free_levels(lev, n_lev); return -4; }
            memset(nl + lev_cap, 0, (nc - lev_cap) * sizeof(TLev));
            used += (nc - lev_cap) * (long)sizeof(TLev);
            lev = nl;
            lev_cap = nc;
        }
        const TWf *m_oe = (s - oe >= 0) ? &lev[s - oe].m : NULL;
        const TWf *m_x = (s - x_pen >= 0) ? &lev[s - x_pen].m : NULL;
        const TWf *i_e = (s - e_pen >= 0) ? &lev[s - e_pen].i : NULL;
        const TWf *d_e = (s - e_pen >= 0) ? &lev[s - e_pen].d : NULL;
        TLev *L = &lev[s];

        /* I[k] <- max(M[s-oe][k-1], I[s-e][k-1]) */
        long lo = k_max + 1, hi = k_min - 1;
        if (m_oe && m_oe->off) {
            if (m_oe->lo + 1 < lo) lo = m_oe->lo + 1;
            if (m_oe->hi + 1 > hi) hi = m_oe->hi + 1;
        }
        if (i_e && i_e->off) {
            if (i_e->lo + 1 < lo) lo = i_e->lo + 1;
            if (i_e->hi + 1 > hi) hi = i_e->hi + 1;
        }
        if (lo < k_min) lo = k_min;
        if (hi > k_max) hi = k_max;
        if (lo <= hi) {
            long w = hi - lo + 1;
            L->i.off = malloc(w * sizeof(int32_t));
            if (!L->i.off) { free(scr); twfa_free_levels(lev, n_lev); return -4; }
            used += w * 4;
            L->i.lo = lo; L->i.hi = hi;
            twf_gather(tmp_a, lo, hi, m_oe, -1);
            twf_gather(tmp_b, lo, hi, i_e, -1);
            int32_t *restrict io = L->i.off;
            for (long i = 0; i < w; i++) {
                int32_t v = tmp_a[i] > tmp_b[i] ? tmp_a[i] : tmp_b[i];
                int32_t y = v + (int32_t)(lo + i);
                int ok = (v > WFA_NEG) & (v >= 0) & (v <= vn2) &
                         (y >= 0) & (y <= vn1);
                io[i] = ok ? v : WFA_NEG;
            }
        }
        /* D[k] <- max(M[s-oe][k+1], D[s-e][k+1]) + 1 */
        lo = k_max + 1; hi = k_min - 1;
        if (m_oe && m_oe->off) {
            if (m_oe->lo - 1 < lo) lo = m_oe->lo - 1;
            if (m_oe->hi - 1 > hi) hi = m_oe->hi - 1;
        }
        if (d_e && d_e->off) {
            if (d_e->lo - 1 < lo) lo = d_e->lo - 1;
            if (d_e->hi - 1 > hi) hi = d_e->hi - 1;
        }
        if (lo < k_min) lo = k_min;
        if (hi > k_max) hi = k_max;
        if (lo <= hi) {
            long w = hi - lo + 1;
            L->d.off = malloc(w * sizeof(int32_t));
            if (!L->d.off) { free(scr); twfa_free_levels(lev, n_lev); return -4; }
            used += w * 4;
            L->d.lo = lo; L->d.hi = hi;
            twf_gather(tmp_a, lo, hi, m_oe, +1);
            twf_gather(tmp_b, lo, hi, d_e, +1);
            int32_t *restrict dout = L->d.off;
            for (long i = 0; i < w; i++) {
                int32_t v = tmp_a[i] > tmp_b[i] ? tmp_a[i] : tmp_b[i];
                v = (v > WFA_NEG) ? v + 1 : WFA_NEG;
                int32_t y = v + (int32_t)(lo + i);
                int ok = (v > WFA_NEG) & (v >= 0) & (v <= vn2) &
                         (y >= 0) & (y <= vn1);
                dout[i] = ok ? v : WFA_NEG;
            }
        }
        /* M[k] <- extend(max(M[s-x][k]+1, I[s][k], D[s][k])) */
        lo = k_max + 1; hi = k_min - 1;
        if (m_x && m_x->off) {
            if (m_x->lo < lo) lo = m_x->lo;
            if (m_x->hi > hi) hi = m_x->hi;
        }
        if (L->i.off) {
            if (L->i.lo < lo) lo = L->i.lo;
            if (L->i.hi > hi) hi = L->i.hi;
        }
        if (L->d.off) {
            if (L->d.lo < lo) lo = L->d.lo;
            if (L->d.hi > hi) hi = L->d.hi;
        }
        if (lo < k_min) lo = k_min;
        if (hi > k_max) hi = k_max;
        if (lo <= hi) {
            long w = hi - lo + 1;
            L->m.off = malloc(w * sizeof(int32_t));
            if (!L->m.off) { free(scr); twfa_free_levels(lev, n_lev); return -4; }
            used += w * 4;
            L->m.lo = lo; L->m.hi = hi;
            twf_gather(tmp_a, lo, hi, m_x, 0);
            twf_gather(tmp_b, lo, hi, &L->i, 0);
            twf_gather(tmp_c, lo, hi, &L->d, 0);
            int32_t *restrict mo = L->m.off;
            for (long i = 0; i < w; i++) {
                int32_t a = tmp_a[i];
                a = (a > WFA_NEG) ? a + 1 : WFA_NEG;
                int32_t v = a > tmp_b[i] ? a : tmp_b[i];
                if (tmp_c[i] > v) v = tmp_c[i];
                int32_t y = v + (int32_t)(lo + i);
                int ok = (v > WFA_NEG) & (v >= 0) & (v <= vn2) &
                         (y >= 0) & (y <= vn1);
                mo[i] = ok ? v : WFA_NEG;
            }
            /* scalar extension pass: first-char gate inline so zero-length
             * extensions (the common case on divergent pairs) skip the call */
            for (long i = 0; i < w; i++) {
                int32_t v = mo[i];
                if (v <= WFA_NEG) continue;
                long k = lo + i, y = v + k;
                if (v < n2 && y < n1 && s1[y] == s2[v])
                    mo[i] = (int32_t)twfa_extend(s1, n1, s2, n2, k, v);
            }
            if (k_target >= lo && k_target <= hi &&
                L->m.off[k_target - lo] >= n2 &&
                L->m.off[k_target - lo] > WFA_NEG)
                final_s = s;
        }
        n_lev += 1;
        if (used > mem_budget) { free(scr); twfa_free_levels(lev, n_lev); return -4; }
    }

    free(scr);
    TLevCtx ctx = {lev, n_lev};
    long n = wfa_tb_walk(wfa_lev_at, &ctx, final_s, s1, n1, s2, n2,
                         x_pen, o_pen, e_pen, a1_out, a2_out,
                         n1 + n2 + 8);
    twfa_free_levels(lev, n_lev);
    if (n < 0) return -7;
    out_lens[0] = out_lens[1] = n;
    return final_s;
}

typedef struct {
    const uint8_t *buf1;
    const long *off1; /* prefix offsets, length B+1 */
    const uint8_t *buf2;
    const long *off2;
    int x_pen, o_pen, e_pen;
    long s_max, budget;
    char *a1s, *a2s;
    long cap;
    long *pens, *lens;
    long b_lo, b_hi;
} TWTask;

static void *twfa_worker(void *arg) {
    TWTask *t = (TWTask *)arg;
    for (long b = t->b_lo; b < t->b_hi; b++) {
        long out_lens[2] = {0, 0};
        t->pens[b] = wfa_textbook_align(
            t->buf1 + t->off1[b], t->off1[b + 1] - t->off1[b],
            t->buf2 + t->off2[b], t->off2[b + 1] - t->off2[b],
            t->x_pen, t->o_pen, t->e_pen, t->s_max, t->budget,
            t->a1s + b * t->cap, t->a2s + b * t->cap, out_lens);
        t->lens[b] = out_lens[0];
    }
    return NULL;
}

/* Threaded batch: pair b's sequences are buf1[off1[b]:off1[b+1]] /
 * buf2[off2[b]:off2[b+1]]; alignments land in a1s/a2s[b*cap : ...] with
 * lens[b] columns; pens[b] = penalty or negative error. */
void wfa_textbook_align_batch(const uint8_t *buf1, const long *off1,
                              const uint8_t *buf2, const long *off2,
                              long b_total,
                              int x_pen, int o_pen, int e_pen,
                              long s_max, long budget,
                              char *a1s, char *a2s, long cap,
                              long *pens, long *lens, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    if (n_threads > b_total) n_threads = (int)(b_total > 0 ? b_total : 1);
    pthread_t tids[64];
    int running[64] = {0};
    TWTask tasks[64];
    long per = (b_total + n_threads - 1) / n_threads;
    int started = 0;
    for (int k = 0; k < n_threads; k++) {
        long lo = k * per, hi = lo + per;
        if (lo >= b_total) break;
        if (hi > b_total) hi = b_total;
        tasks[k] = (TWTask){buf1, off1, buf2, off2, x_pen, o_pen, e_pen,
                            s_max, budget, a1s, a2s, cap, pens, lens, lo, hi};
        if (pthread_create(&tids[k], NULL, twfa_worker, &tasks[k]) != 0) {
            twfa_worker(&tasks[k]);
            started = k + 1;
            continue;
        }
        running[k] = 1;
        started = k + 1;
    }
    for (int k = 0; k < started; k++)
        if (running[k]) pthread_join(tids[k], NULL);
}

/* ------------------------------------------------------- column relay */

/* The seqpar column relay (parallel/relay.py) hands a boundary column to a
 * fill running on another thread or on a card: the rows are copied first,
 * then the count of rows in place is stored with release order, so an
 * acquire load that reads the count also sees the rows (on any host CPU,
 * not only under x86's store order).  A reader loads the count with
 * acquire order before it copies the rows the count covers. */
void relay_store_release(int32_t *count, int32_t v) {
    __atomic_store_n(count, v, __ATOMIC_RELEASE);
}

int32_t relay_load_acquire(const int32_t *count) {
    return __atomic_load_n(count, __ATOMIC_ACQUIRE);
}
