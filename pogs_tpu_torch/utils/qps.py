"""QPS / MPS reader and writer for quadratic programs.

A copy of ``pogs_tpu/utils/qps.py`` (numpy only), kept here so that the
port imports nothing of the JAX package.

The Maros–Mészáros repository (the standard convex-QP benchmark, 138
problems) ships as QPS files — the classic fixed/free-format MPS layout
plus a ``QUADOBJ`` section for the Hessian.  The reference's benchmark
runner (python/benchmarks/maros_benchmark.py:22-40) needs an external
`cvxbench` checkout plus cvxpy to load them; this module is a
dependency-free loader/writer so the real set runs directly against
:func:`pogs_tpu_torch.api.qp.solve_qp`.

Parsed form (minimization)::

    minimize    1/2 x'Qx + c'x + c0
    subject to  row_i:  a_i'x  {=, <=, >=}  rhs_i     (RANGES resolved)
                lb <= x <= ub

Conventions implemented (documented where dialects disagree):

* Objective constant: an RHS entry on the objective row stores ``-c0``
  (the CUTEst / qpsolvers convention used by the Maros–Mészáros files).
* ``QUADOBJ`` lists one triangle of Q; entries are mirrored
  (``Q[i,j] = Q[j,i] = v``).  ``QMATRIX`` lists every nonzero of Q
  explicitly and is taken verbatim (no mirroring).  Both define the
  quadratic term as ``1/2 x'Qx``.
* RANGES on a row with rhs ``r`` and range ``R``:
  type L → ``r-|R| <= a'x <= r``; type G → ``r <= a'x <= r+|R|``;
  type E → ``r <= a'x <= r+R`` if ``R >= 0`` else ``r+R <= a'x <= r``.
* Default variable bounds are ``0 <= x < +inf``.  ``UP`` with a
  negative value on a column whose lower bound was never set lowers it
  to ``-inf`` (the GLPK/classic rule; flagged in the result so callers
  can audit).
* ``OBJSENSE MAXIMIZE`` is folded into the data (Q, c, c0 negated) so
  the returned problem is always a minimization; the flag is recorded.

Integer markers (``INTORG``/``INTEND``) and integer/binary bound types
(``BV``/``LI``/``UI``) raise ``ValueError`` — POGS solves convex
continuous programs only.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_qps", "loads_qps", "save_qps", "qps_to_solve_qp_kwargs"]

_INF = float("inf")

# Bound types that carry a value field.
_BOUND_VALUE_TYPES = {"UP", "LO", "FX", "UI", "LI"}
_BOUND_FLAG_TYPES = {"FR", "MI", "PL", "BV"}
_INTEGER_BOUND_TYPES = {"BV", "UI", "LI"}


def load_qps(path, sparse=False):
    """Parse a QPS/MPS file from ``path``.  See :func:`loads_qps`."""
    with open(path, "r") as fh:
        return loads_qps(fh.read(), sparse=sparse)


def _pairs(tokens):
    """Yield (name, value) pairs from a COLUMNS/RHS/RANGES data line
    whose leading set/column name has already been stripped."""
    if len(tokens) % 2:
        raise ValueError(f"odd field count in data line: {tokens}")
    for i in range(0, len(tokens), 2):
        yield tokens[i], float(tokens[i + 1])


def loads_qps(text, sparse=False):
    """Parse QPS/MPS ``text`` (free-format: fields are whitespace-split,
    which also reads the fixed-format Maros–Mészáros files since their
    names contain no spaces).

    Returns a dict with keys ``name, Q, c, c0, A, sense, rhs, lb, ub``
    (the `benchmarks/maros_meszaros.py` problem schema, minus the known
    optimum), plus ``objsense`` ("MIN"/"MAX" as written),
    ``col_names``, ``row_names``, and ``lowered_lb`` (columns whose
    lower bound the negative-``UP`` rule dropped to −inf).

    ``sparse=True`` returns ``Q`` and ``A`` as ``scipy.sparse``
    matrices (CSR) instead of dense arrays — use it for the large
    Maros–Mészáros instances (e.g. BOYD1/2 at n ≈ 10^5, where dense
    storage is infeasible).
    """
    name = ""
    objsense = "MIN"
    obj_row = None
    row_sense = {}          # row name -> 'E' | 'L' | 'G'
    row_order = []
    col_order = []
    col_index = {}
    a_entries = []          # (row_name, col_idx, val) accumulated
    c_entries = {}          # col_idx -> obj coefficient
    rhs = {}                # row name -> value
    obj_rhs = 0.0
    ranges = {}             # row name -> range value
    q_entries = []          # (i, j, val)
    q_mirror = True         # QUADOBJ mirrors; QMATRIX does not
    bounds = {}             # col idx -> [lb, ub]
    lb_explicit = set()
    lowered_lb = []

    section = None
    lines = text.splitlines()
    li = 0
    n_lines = len(lines)
    while li < n_lines:
        raw = lines[li]
        li += 1
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        # Section headers start in column 1; data lines are indented.
        if raw[0] not in (" ", "\t"):
            tokens = raw.split()
            section = tokens[0].upper()
            if section == "NAME":
                name = tokens[1] if len(tokens) > 1 else ""
            elif section == "OBJSENSE" and len(tokens) > 1:
                objsense = tokens[1].upper()
            elif section == "ENDATA":
                break
            continue

        tokens = raw.split()
        if section == "OBJSENSE":
            objsense = tokens[0].upper()
        elif section == "ROWS":
            sense, rname = tokens[0].upper(), tokens[1]
            if sense == "N":
                if obj_row is None:
                    obj_row = rname
                # Subsequent N rows are free rows: their coefficients
                # are dropped (standard MPS behavior).
            elif sense in ("E", "L", "G"):
                row_sense[rname] = sense
                row_order.append(rname)
            else:
                raise ValueError(f"unknown row sense {sense!r}")
        elif section == "COLUMNS":
            if "'MARKER'" in tokens or "MARKER" in tokens:
                if any("INTORG" in t for t in tokens):
                    raise ValueError(
                        "integer variables (INTORG marker) are not "
                        "supported: POGS solves continuous convex QPs")
                continue  # INTEND after a rejected INTORG is unreachable
            cname = tokens[0]
            if cname not in col_index:
                col_index[cname] = len(col_order)
                col_order.append(cname)
            j = col_index[cname]
            for rname, val in _pairs(tokens[1:]):
                if rname == obj_row:
                    c_entries[j] = c_entries.get(j, 0.0) + val
                elif rname in row_sense:
                    a_entries.append((rname, j, val))
                # else: coefficient on a free N row — dropped.
        elif section in ("RHS", "RANGES"):
            # The set name is optional in the wild; a data line has an
            # odd token count exactly when the set name is present.
            data = tokens[1:] if len(tokens) % 2 else tokens
            for rname, val in _pairs(data):
                if section == "RHS":
                    if rname == obj_row:
                        obj_rhs = val
                    else:
                        rhs[rname] = val
                else:
                    ranges[rname] = val
        elif section == "BOUNDS":
            btype = tokens[0].upper()
            if btype in _INTEGER_BOUND_TYPES:
                raise ValueError(
                    f"integer/binary bound type {btype} is not supported")
            if btype in _BOUND_VALUE_TYPES:
                # (type, set, col, val) or (type, col, val) without set.
                if len(tokens) >= 4:
                    cname, val = tokens[2], float(tokens[3])
                else:
                    cname, val = tokens[1], float(tokens[2])
            elif btype in _BOUND_FLAG_TYPES:
                cname = tokens[2] if len(tokens) >= 3 else tokens[1]
                val = None
            else:
                raise ValueError(f"unknown bound type {btype!r}")
            if cname not in col_index:
                # Bound on a column that never appeared in COLUMNS:
                # create it (it exists with all-zero coefficients).
                col_index[cname] = len(col_order)
                col_order.append(cname)
            j = col_index[cname]
            lo, hi = bounds.get(j, (0.0, _INF))
            if btype == "UP":
                hi = val
                if val < 0.0 and j not in lb_explicit:
                    lo = -_INF
                    lowered_lb.append(cname)
            elif btype == "LO":
                lo = val
                lb_explicit.add(j)
            elif btype == "FX":
                lo = hi = val
                lb_explicit.add(j)
            elif btype == "FR":
                lo, hi = -_INF, _INF
                lb_explicit.add(j)
            elif btype == "MI":
                lo = -_INF
                lb_explicit.add(j)
            elif btype == "PL":
                hi = _INF
            bounds[j] = (lo, hi)
        elif section in ("QUADOBJ", "QSECTION", "QMATRIX"):
            if section == "QMATRIX":
                q_mirror = False
            c1, c2, val = tokens[0], tokens[1], float(tokens[2])
            for cname in (c1, c2):
                if cname not in col_index:
                    col_index[cname] = len(col_order)
                    col_order.append(cname)
            q_entries.append((col_index[c1], col_index[c2], val))
        elif section == "NAME":
            continue
        else:
            raise ValueError(f"data line outside a known section: {raw!r}")

    if obj_row is None:
        raise ValueError("no objective (type-N) row found")
    n = len(col_order)

    c = np.zeros(n)
    for j, v in c_entries.items():
        c[j] = v
    c0 = -obj_rhs  # RHS on the objective row stores -c0.

    # Resolve RANGES into per-row [rl, ru] intervals, then emit sense
    # rows: one row per finite side (an interval with both sides finite
    # and distinct becomes a <= and a >= row over the same coefficients).
    sense_out, rhs_out, row_src = [], [], []
    row_names_out = []
    for rname in row_order:
        s = row_sense[rname]
        r = rhs.get(rname, 0.0)
        if rname in ranges:
            R = ranges[rname]
            if s == "L":
                rl, ru = r - abs(R), r
            elif s == "G":
                rl, ru = r, r + abs(R)
            else:  # E
                rl, ru = (r, r + R) if R >= 0 else (r + R, r)
        elif s == "E":
            rl = ru = r
        elif s == "L":
            rl, ru = -_INF, r
        else:
            rl, ru = r, _INF
        if rl == ru:
            sense_out.append("=")
            rhs_out.append(rl)
            row_src.append(rname)
            row_names_out.append(rname)
            continue
        if np.isfinite(ru):
            sense_out.append("<=")
            rhs_out.append(ru)
            row_src.append(rname)
            row_names_out.append(rname)
        if np.isfinite(rl):
            sense_out.append(">=")
            rhs_out.append(rl)
            row_src.append(rname)
            row_names_out.append(rname + ":lo" if np.isfinite(ru) else rname)

    m = len(sense_out)
    src_index = {}
    for i, rname in enumerate(row_src):
        src_index.setdefault(rname, []).append(i)

    lb = np.zeros(n)
    ub = np.full(n, _INF)
    for j, (lo, hi) in bounds.items():
        lb[j], ub[j] = lo, hi

    # Assemble A (and Q) — every output row sourced from constraint
    # row `rname` receives its coefficients (ranged rows appear twice).
    if sparse:
        from scipy import sparse as sp

        ai, aj, av = [], [], []
        for rname, j, v in a_entries:
            for i in src_index.get(rname, ()):
                ai.append(i)
                aj.append(j)
                av.append(v)
        A = sp.csr_matrix((av, (ai, aj)), shape=(m, n))
        qi, qj, qv = [], [], []
        for i, j, v in q_entries:
            qi.append(i)
            qj.append(j)
            qv.append(v)
            if q_mirror and i != j:
                qi.append(j)
                qj.append(i)
                qv.append(v)
        Q = sp.csr_matrix((qv, (qi, qj)), shape=(n, n))
    else:
        A = np.zeros((m, n))
        for rname, j, v in a_entries:
            for i in src_index.get(rname, ()):
                A[i, j] += v
        Q = np.zeros((n, n))
        for i, j, v in q_entries:
            Q[i, j] += v
            if q_mirror and i != j:
                Q[j, i] += v

    if objsense in ("MAX", "MAXIMIZE"):
        Q, c, c0 = -Q, -c, -c0

    return {
        "name": name,
        "Q": Q,
        "c": c,
        "c0": c0,
        "A": A,
        "sense": sense_out,
        "rhs": np.asarray(rhs_out, np.float64),
        "lb": lb,
        "ub": ub,
        "objsense": objsense,
        "col_names": col_order,
        "row_names": row_names_out,
        "lowered_lb": lowered_lb,
    }


def qps_to_solve_qp_kwargs(p):
    """Lower a :func:`load_qps` dict to :func:`pogs_tpu_torch.api.qp.solve_qp`
    keyword arguments ``(P, q, G, h, A, b, lb, ub)``.  The objective
    constant ``p['c0']`` is NOT representable there — add it to the
    returned ``optval`` (``solve_qp`` reports ``1/2 x'Px + q'x``).
    """
    try:
        from scipy import sparse as sp
        is_sp = sp.issparse(p["A"])
    except ImportError:  # pragma: no cover - scipy is baked in
        sp, is_sp = None, False
    sense = np.asarray(p["sense"], dtype=object)
    eq = sense == "="
    le = sense == "<="
    ge = sense == ">="
    A_all, r = p["A"], p["rhs"]
    if is_sp:
        A_eq = A_all[np.flatnonzero(eq)]
        G = sp.vstack([A_all[np.flatnonzero(le)],
                       -A_all[np.flatnonzero(ge)]]).tocsr()
    else:
        A_eq = A_all[eq]
        G = np.vstack([A_all[le], -A_all[ge]])
    h = np.concatenate([r[le], -r[ge]])
    b_eq = r[eq]
    kw = {
        # Sparse Q passes through verbatim: solve_qp detects diagonal
        # sparse Hessians (its factorization-free path) and densifies
        # anything else itself.
        "P": p["Q"],
        "q": p["c"],
        "lb": p["lb"],
        "ub": p["ub"],
    }
    if h.size:
        kw["G"], kw["h"] = G, h
    if b_eq.size:
        kw["A"], kw["b"] = A_eq, b_eq
    return kw


def _fmt(v):
    """Full-precision, compact float field."""
    return repr(float(v))


def save_qps(path, name, Q, c, c0, A, sense, rhs, lb, ub):
    """Write a free-format QPS file for
    ``min 1/2 x'Qx + c'x + c0  s.t.  A x {sense} rhs,  lb <= x <= ub``
    readable by :func:`load_qps` and by standard MPS/QPS tools.

    ``sense`` entries are ``'='``, ``'<='``, ``'>='``.  Only structural
    nonzeros are emitted; default bounds (0, +inf) are omitted.
    """
    Q = np.asarray(Q, np.float64)
    c = np.asarray(c, np.float64).ravel()
    A = np.asarray(A, np.float64).reshape(-1, c.shape[0])
    rhs = np.asarray(rhs, np.float64).ravel()
    lb = np.asarray(lb, np.float64).ravel()
    ub = np.asarray(ub, np.float64).ravel()
    m, n = A.shape
    cols = [f"X{j}" for j in range(n)]
    rows = [f"R{i}" for i in range(m)]
    smap = {"=": "E", "<=": "L", ">=": "G"}

    out = [f"NAME          {name}", "ROWS", " N  OBJ"]
    for i, s in enumerate(sense):
        out.append(f" {smap[s]}  {rows[i]}")
    out.append("COLUMNS")
    for j in range(n):
        entries = []
        if c[j] != 0.0:
            entries.append(("OBJ", c[j]))
        entries.extend((rows[i], A[i, j]) for i in range(m) if A[i, j] != 0.0)
        if not entries:  # keep the column alive for the parser
            entries.append(("OBJ", 0.0))
        for k in range(0, len(entries), 2):
            chunk = entries[k:k + 2]
            fields = " ".join(f"{rn} {_fmt(v)}" for rn, v in chunk)
            out.append(f"    {cols[j]}  {fields}")
    out.append("RHS")
    if c0 != 0.0:
        out.append(f"    RHS1  OBJ {_fmt(-c0)}")
    for i in range(m):
        if rhs[i] != 0.0:
            out.append(f"    RHS1  {rows[i]} {_fmt(rhs[i])}")
    out.append("BOUNDS")
    for j in range(n):
        lo, hi = lb[j], ub[j]
        if lo == hi:
            out.append(f" FX BND1  {cols[j]} {_fmt(lo)}")
            continue
        if lo == -_INF and hi == _INF:
            out.append(f" FR BND1  {cols[j]}")
            continue
        if lo == -_INF:
            out.append(f" MI BND1  {cols[j]}")
        elif lo != 0.0:
            out.append(f" LO BND1  {cols[j]} {_fmt(lo)}")
        if hi != _INF:
            out.append(f" UP BND1  {cols[j]} {_fmt(hi)}")
    q_lines = []
    for i in range(n):
        for j in range(i, n):  # upper triangle, mirrored on read
            if Q[i, j] != 0.0:
                q_lines.append(f"    {cols[i]}  {cols[j]} {_fmt(Q[i, j])}")
    if q_lines:
        out.append("QUADOBJ")
        out.extend(q_lines)
    out.append("ENDATA")
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")
