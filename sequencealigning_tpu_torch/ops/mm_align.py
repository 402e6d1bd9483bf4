"""Myers-Miller divide-and-conquer alignment: exact affine-gap ops strings in
O(n1 + n2) memory for pairs of any length (the port of ops/mm_align.py).

The long-pair path's fallback when the optimum escapes every band
(models.gotoh._long_batch): the classic Myers-Miller (1988) recursion over
the split row.  Each node of the recursion needs two linear-memory score
rows: the forward rows of its top half and the reverse rows of its bottom
half.  The recursion goes a level at a time (``_levels``): on CUDA the
rows of every node of a level come from one launch of the row kernel
(csrc/mm_rows.cu, ``mm_rows_cuda``; it replaces the JAX package's
``_rows_fn``) and one copy to the host; on the CPU from the plain version
node by node, ``rows_torch``, a row sweep in torch ops (the in-row D chain
linearised to a prefix maximum, ``torch.cummax``).  Subproblems address
the whole forward and reversed sequences on the device by offset.
Subproblems below ``_DIRECT_CELLS`` cells are solved directly on the host
(numpy, the JAX package's code).

Conventions (ops.traceback._apply_ops): ops over {'M': consume query+db,
'I': consume query (gap in db), 'D': consume db (gap in query)}.  The state
that crosses a horizontal split row is an 'I' run; ``tb``/``te`` are the
gap-open costs at a subproblem's top/bottom boundary (0 when a crossing run
is already open -- the Myers-Miller boundary subsidy).

Scoring model: the standard affine-gap model (a gap of length L costs
o + L*e, gaps open from any state), a relaxation of the reference's M-only
opens; models.gotoh rescores the result and keeps it only when it reaches
the engine-exact score.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sequencealigning_tpu_torch import csrc
from sequencealigning_tpu_torch.config import NEG_INF, ScoringScheme
from sequencealigning_tpu_torch.io.encode import encode_seq

NEG = NEG_INF


def _pow2(x: int, lo: int = 128) -> int:
    n = lo
    while n < x:
        n *= 2
    return n


def rows_torch(q_ext: torch.Tensor, d_ext: torch.Tensor, q_off: int, m: int,
               d_off: int, n_pad: int, tb: int,
               scheme: ScoringScheme):
    """Forward score rows over a subproblem given by offsets (the torch twin
    of ops/mm_align.py::_rows_fn): (CC, DD), each (n_pad + 1,) int32, the H
    and I values after m query rows (column j = db codes consumed).
    q_ext/d_ext: the whole padded sequences, 1-D int32 on the rows' device
    (d_ext left-padded by one, so the window lands on d[d_off + j - 1])."""
    o, e = scheme.gap_open, scheme.gap_extend
    W = n_pad + 1
    dev = q_ext.device
    jv = torch.arange(W, dtype=torch.int32, device=dev)
    lane0 = jv == 0
    je = jv * e
    dsh = d_ext[d_off: d_off + W]
    mat, mis = (torch.tensor(v, dtype=torch.int32, device=dev)
                for v in (scheme.match_, scheme.mismatch))
    CC = torch.where(lane0, 0, o + je).to(torch.int32)
    DD = torch.full((W,), NEG, dtype=torch.int32, device=dev)
    for i in range(1, m + 1):
        qc = q_ext[q_off + i - 1]
        sub = torch.where(dsh == qc, mat, mis)
        # I (the crossing state): same column, previous row; gaps open from
        # H (the standard model).
        DDn = torch.maximum(CC + o, DD) + e
        chain = tb + i * e
        DDn[0] = chain
        # M from the previous row's H, shifted.
        Mrow = F.pad(CC[:-1], (1, 0), value=NEG) + sub
        Mrow[0] = NEG
        Bv = torch.maximum(Mrow, DDn)
        Bv[0] = chain
        # In-row D chain: E[j] = max(c[j], E[j-1] + e) with
        # c[j] = B[j-1] + o + e, linearised by a prefix maximum.
        c = F.pad(Bv[:-1] + (o + e), (1, 0), value=NEG)
        E = torch.cummax(c - je, dim=0).values + je
        CC = torch.maximum(Bv, E)
        CC[0] = chain
        DD = DDn
    return CC, DD


def node_rows_torch(qf, qr, df, dr, fwd, rev, n: int,
                    scheme: ScoringScheme) -> torch.Tensor:
    """Both sweeps of a Myers-Miller node as the plain version: (4, n + 1)
    int32 on the sequences' device, rows_torch's CC and DD of the forward
    sweep fwd = (q_off, m, d_off, tb) over qf/df, then those of the reverse
    sweep rev over qr/dr (the row width bucketed to a power of two, as in
    the JAX package)."""
    n_pad = _pow2(n + 1)
    out = []
    for q, d, (q_off, m, d_off, tb) in ((qf, df, fwd), (qr, dr, rev)):
        out.extend(r[: n + 1] for r in rows_torch(q, d, q_off, m, d_off,
                                                  n_pad, tb, scheme))
    return torch.stack(out)


class LevelPlan(NamedTuple):
    """A recursion level planned for the row kernel: the node table
    (int64, a row a node), the lanes a thread, the int32 words of ctr, bnd
    and out and the tickets, and each node's first ticket and first output
    word."""
    table: np.ndarray
    lanes: int
    words: tuple
    first_tickets: list
    out_offsets: list


def plan_level(nodes, lib, lpt=None) -> LevelPlan:
    """The node table of a level, planned by csrc/mm_rows.cuh's
    mm_plan_level: nodes a list of (fwd, rev, n), each sweep (q_off, m,
    d_off, tb).  lib: the kernels' library (sa_mm_rows_plan, the kernel's
    lanes a thread), or with lpt the host build (hc_mm_rows_plan at lpt
    lanes a thread, 0 the kernel's).  The table's columns come from the
    library (sa_mm_table_cols / hc_mm_table_cols).  Raises ValueError when
    the planner refuses the level."""
    host = lpt is not None
    cols = np.zeros(6, np.int64)
    (lib.hc_mm_table_cols if host else lib.sa_mm_table_cols)(
        cols.ctypes.data)
    width, fwd_at, rev_at, n_at, ticket_at, out_at = (int(c) for c in cols)
    table = np.zeros((len(nodes), width), np.int64)
    for k, (fwd, rev, n) in enumerate(nodes):
        table[k, fwd_at: fwd_at + 4] = fwd
        table[k, rev_at: rev_at + 4] = rev
        table[k, n_at] = n
    words = np.zeros(4, np.int64)
    if host:
        lanes = lib.hc_mm_rows_plan(table.ctypes.data, len(nodes), lpt,
                                    words.ctypes.data)
    else:
        lanes = lib.sa_mm_rows_plan(table.ctypes.data, len(nodes),
                                    words.ctypes.data)
    if lanes < 0:
        raise ValueError(f"the row kernel's planner refused a level of "
                         f"{len(nodes)} nodes (lanes a thread {lpt})")
    return LevelPlan(table, lanes, tuple(int(w) for w in words),
                     table[:, ticket_at].tolist(), table[:, out_at].tolist())


def mm_rows_cuda(qf, qr, df, dr, nodes, scheme: ScoringScheme):
    """The Myers-Miller row kernel (csrc/mm_rows.cu) on CUDA tensors: both
    sweeps of every node of a recursion level in one launch, the integers
    of node_rows_torch, brought to the host in one copy.  nodes: a list of
    (fwd, rev, n), each sweep (q_off, m, d_off, tb).  Returns a list of
    (4, n + 1) int32 CPU tensors, a node each.  Raises ValueError on a CPU
    tensor, no node or a sweep outside its sequences, RuntimeError on a
    failed launch or a stalled hand-over."""
    seqs = (qf, qr, df, dr)
    if not all(t.is_cuda for t in seqs):
        raise ValueError("mm_rows_cuda needs CUDA tensors")
    if not all(t.dtype == torch.int32 and t.dim() == 1 and t.is_contiguous()
               and t.device == qf.device for t in seqs):
        raise ValueError("mm_rows_cuda takes contiguous 1-D int32 sequences "
                         "on one device")
    if not nodes:
        raise ValueError("mm_rows_cuda needs at least one node")
    for fwd, rev, n in nodes:
        for q, d, (q_off, m, d_off, _tb) in ((qf, df, fwd), (qr, dr, rev)):
            if (n < 0 or m < 0 or q_off < 0 or d_off < 0
                    or q_off + m > q.numel() or d_off + n >= d.numel()):
                raise ValueError(f"sweep {(q_off, m, d_off)} x {n + 1} "
                                 "columns lies outside its sequences")
    lib = csrc.kernels()
    dev = qf.device
    plan = plan_level(nodes, lib)
    head, n_bnd, n_out, tickets = plan.words
    with torch.cuda.device(dev):
        # ctr, then the rows: one copy brings the status word (ctr[1]) and
        # every node's rows.  The hand-over columns start zeroed: a word is
        # taken only once it holds its row's tag.
        buf = torch.zeros(head + n_out, dtype=torch.int32, device=dev)
        bnd = torch.zeros(n_bnd, dtype=torch.int32, device=dev)
        tab = torch.from_numpy(plan.table).to(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sa_mm_rows(
            *(t.data_ptr() for t in seqs), tab.data_ptr(), len(nodes),
            plan.lanes, tickets, buf[head:].data_ptr(), bnd.data_ptr(),
            buf.data_ptr(), scheme.match_, scheme.mismatch, scheme.gap_open,
            scheme.gap_extend, stream)
    if rc != 0:
        raise csrc.launch_error("sa_mm_rows", rc)
    mm_rows_cuda.launches += 1
    mm_rows_cuda.last_launch = dict(
        lanes_per_thread=plan.lanes, nodes=len(nodes), warps=tickets,
        rows=[(f[1], r[1]) for f, r, _n in nodes],
        columns=[n + 1 for _f, _r, n in nodes])
    host = buf.cpu()
    if int(host[1]):
        raise RuntimeError("sa_mm_rows: a strip's hand-over stalled")
    rows = host[head:]
    return [rows[o: o + 4 * (n + 1)].view(4, n + 1)
            for o, (_f, _r, n) in zip(plan.out_offsets, nodes)]


mm_rows_cuda.launches = 0
mm_rows_cuda.last_launch = {}


def level_rows(qf, qr, df, dr, nodes, scheme: ScoringScheme) -> list:
    """Every node's rows of a recursion level: one kernel launch for CUDA
    tensors, the plain version node by node for CPU tensors; a list of
    (4, n + 1) int32 tensors (on the host from the kernel)."""
    if qf.is_cuda:
        return mm_rows_cuda(qf, qr, df, dr, nodes, scheme)
    if qf.device.type != "cpu":
        raise ValueError(f"unsupported device {qf.device}")
    return [node_rows_torch(qf, qr, df, dr, fwd, rev, n, scheme)
            for fwd, rev, n in nodes]


def node_rows(qf, qr, df, dr, fwd, rev, n: int,
              scheme: ScoringScheme) -> torch.Tensor:
    """One node's (4, n + 1) int32 rows: a level of one node."""
    return level_rows(qf, qr, df, dr, [(fwd, rev, n)], scheme)[0]


class _Seqs:
    """The forward and reversed sequence arrays of one mm_align problem on
    one device (one upload; subproblems address them by offset)."""

    def __init__(self, q_codes: np.ndarray, d_codes: np.ndarray,
                 scheme: ScoringScheme, device):
        self.scheme = scheme
        self.m0 = len(q_codes)
        self.n0 = len(d_codes)
        self.n_pad_max = _pow2(self.n0 + 1)
        lq = self.m0 + 8
        ld = self.n0 + self.n_pad_max + 2
        qf = np.full(lq, -2, np.int32)
        qf[: self.m0] = q_codes
        qr = np.full(lq, -2, np.int32)
        qr[: self.m0] = q_codes[::-1]
        df = np.full(ld, -3, np.int32)
        df[1: 1 + self.n0] = d_codes  # left pad of one for the window
        dr = np.full(ld, -3, np.int32)
        dr[1: 1 + self.n0] = d_codes[::-1]
        self.qf, self.qr, self.df, self.dr = (
            torch.from_numpy(a).to(device) for a in (qf, qr, df, dr))

    def node(self, qa: int, qb: int, da: int, db_: int, tb: int, te: int):
        """The two sweeps of the node q[qa:qb] x d[da:db_], (fwd, rev, n):
        forward over q[qa:qa+mid] from tb; backward from te on reversed-
        array offsets (q[qa+mid:qb] reversed starts at m0 - qb, d[da:db_]
        at n0 - db_)."""
        m = qb - qa
        mid = m // 2
        return ((qa, mid, da, tb),
                (self.m0 - qb, m - mid, self.n0 - db_, te), db_ - da)

    def level_rows(self, nodes):
        """Each node's four numpy rows (n+1,): CC, DD of the forward sweep
        fwd = (q_off, m, d_off, tb) and RR, SS of the reverse sweep rev,
        whose offsets index the reversed arrays (the caller maps
        coordinates); nodes a list of (fwd, rev, n)."""
        return [tuple(r.cpu().numpy().astype(np.int64))
                for r in level_rows(self.qf, self.qr, self.df, self.dr,
                                    nodes, self.scheme)]


# Subproblems below this cell count solve directly (vectorized numpy DP +
# traceback): the recursion is launch-bound otherwise (one row launch and
# one copy a level, O(log m) levels, but many small nodes a level).
_DIRECT_CELLS = 1 << 20


def _direct_ops(q, d, tb: int, te: int, scheme: ScoringScheme) -> str:
    """Full-DP solve of a small subproblem under the standard affine model
    with boundary-subsidized pure-I prefix (tb) / suffix (te) runs.
    Returns the forward ops string."""
    m, n = len(q), len(d)
    o, e = scheme.gap_open, scheme.gap_extend
    mat, mis = scheme.match_, scheme.mismatch
    jv = np.arange(n + 1)
    CC = np.where(jv == 0, 0, o + jv * e).astype(np.int64)
    DD = np.full(n + 1, NEG, np.int64)
    # Per-cell walk info, row-major (m+1, n+1): bits 0-1 H-plane code
    # (0=M, 1=I, 2=E), bit 2 I-extend, bit 3 E-extend.
    dirs = np.zeros((m + 1, n + 1), np.uint8)
    last_col = np.empty(m + 1, np.int64)
    last_col[0] = CC[n]
    sub_eq = np.not_equal.outer(q, d)  # (m, n) True where mismatch
    for i in range(1, m + 1):
        iopen = CC + o
        DDn = np.maximum(iopen, DD) + e
        iext = (DD >= iopen).astype(np.uint8) << 2
        chain = tb + i * e
        DDn[0] = chain
        sub = np.where(sub_eq[i - 1], mis, mat)
        Mrow = np.concatenate(([NEG], CC[:-1] + sub))
        B = np.maximum(Mrow, DDn)
        B[0] = chain
        # E[j] = max(B[j-1] + o + e, E[j-1] + e), linearized by prefix max.
        c = np.concatenate(([NEG], B[:-1] + o + e))
        E = np.maximum.accumulate(c - jv * e) + jv * e
        CCn = np.maximum(B, E)
        CCn[0] = chain
        b = np.where(Mrow >= CCn, 0, np.where(DDn >= CCn, 1, 2)).astype(
            np.uint8
        )
        b |= iext
        # E-extend: the prefix max did NOT restart at j (E != c).
        b |= ((E != c).astype(np.uint8)) << 3
        dirs[i] = b
        CC, DD = CCn, DDn
        last_col[i] = CCn[n]
    # Trailing pure-I run (te-subsidized): ends the alignment at column n.
    trail_i = -1
    best = CC[n]
    for i in range(m):
        s = last_col[i] + te + (m - i) * e
        if s > best:
            best = s
            trail_i = i
    ops: List[str] = []
    i, j = (trail_i, n) if trail_i >= 0 else (m, n)
    if trail_i >= 0:
        ops.append("I" * (m - trail_i))
    state = "H"
    while i > 0 or j > 0:
        if i == 0:
            ops.append("D" * j)
            break
        if j == 0:
            ops.append("I" * i)
            break
        b = int(dirs[i][j])
        if state == "H":
            state = ("M", "I", "E")[b & 3]
        elif state == "M":
            ops.append("M")
            i -= 1
            j -= 1
            state = "H"
        elif state == "I":
            ops.append("I")
            state = "I" if (b & 4) else "H"
            i -= 1
        else:  # E
            ops.append("D")
            state = "E" if (b & 8) else "H"
            j -= 1
    return "".join(reversed("".join(ops)))


def _levels(sq: _Seqs, q_codes, d_codes, tb: int, te: int) -> str:
    """Myers-Miller recursion on the whole of q_codes x d_codes, a level at
    a time: every node of a level gets its rows from one level_rows call
    (a kernel launch on CUDA), each split chosen as in the JAX package's
    depth-first _diff; the leaves and the joins are assembled in the
    recursion's order, so the ops string is the JAX package's."""
    scheme = sq.scheme
    o = scheme.gap_open
    # parts[k]: subproblem k's ops, or the parts (indices and "II" joins)
    # its node splits into.
    parts: list = [None]
    level = [(0, (0, len(q_codes), 0, len(d_codes), tb, te))]
    while level:
        todo = []
        for k, (qa, qb, da, db_, tb_, te_) in level:
            m, n = qb - qa, db_ - da
            if m == 0:
                parts[k] = "D" * n
            elif n == 0:
                parts[k] = "I" * m
            elif m == 1 or m * n <= _DIRECT_CELLS:
                parts[k] = _direct_ops(q_codes[qa:qb], d_codes[da:db_], tb_,
                                       te_, scheme)
            else:
                todo.append((k, (qa, qb, da, db_, tb_, te_)))
        rows = sq.level_rows([sq.node(*sub) for _k, sub in todo]) \
            if todo else []
        level = []
        for (k, (qa, qb, da, db_, tb_, te_)), (CC, DD, RR, SS) in zip(todo,
                                                                      rows):
            mid = (qb - qa) // 2
            type1 = CC + RR[::-1]
            type2 = DD + SS[::-1] - o
            j1 = int(np.argmax(type1))
            j2 = int(np.argmax(type2))
            a, b = len(parts), len(parts) + 1
            parts += [None, None]
            if type1[j1] >= type2[j2]:
                parts[k] = [a, b]
                level += [(a, (qa, qa + mid, da, da + j1, tb_, o)),
                          (b, (qa + mid, qb, da + j1, db_, o, te_))]
            else:
                parts[k] = [a, "II", b]
                level += [(a, (qa, qa + mid - 1, da, da + j2, tb_, 0)),
                          (b, (qa + mid + 1, qb, da + j2, db_, 0, te_))]

    def join(k) -> str:
        p = parts[k]
        if isinstance(p, str):
            return p
        return "".join(x if isinstance(x, str) else join(x) for x in p)

    return join(0)


def mm_align(
    query: bytes,
    db: bytes,
    scheme: ScoringScheme = ScoringScheme(),
    device="cuda",
) -> str:
    """Exact textbook affine-gap global alignment of one pair, any length,
    O(n1 + n2) memory, its score rows on ``device``.  Returns the forward
    ops string."""
    q = np.asarray(encode_seq(query), np.int32)
    d = np.asarray(encode_seq(db), np.int32)
    if len(q) == 0:
        return "D" * len(d)
    if len(d) == 0:
        return "I" * len(q)
    sq = _Seqs(q, d, scheme, device)
    return _levels(sq, q, d, scheme.gap_open, scheme.gap_open)


def mm_score_ops(ops: str, query: bytes, db: bytes,
                 scheme: ScoringScheme) -> int:
    """Textbook rescore of an ops string (validation helper)."""
    s = 0
    qi = di = 0
    prev = None
    for c in ops:
        if c == "M":
            s += scheme.match_ if query[qi] == db[di] else scheme.mismatch
            qi += 1
            di += 1
        elif c == "I":
            s += scheme.gap_extend + (scheme.gap_open if prev != "I" else 0)
            qi += 1
        else:
            s += scheme.gap_extend + (scheme.gap_open if prev != "D" else 0)
            di += 1
        prev = c
    assert qi == len(query) and di == len(db), (qi, di)
    return s
