"""The port's binding of the native host runtime (``pogs_tpu_torch.native``),
mirroring tests/test_native.py.

The fixture builds the library through the port's own builder into
``build/pogs_tpu_torch/`` (the host C++ compiler on src/native/capi.cpp; no
cmake, and nothing in the ``build/`` tree that tests/test_native.py and
tests/test_fuzz.py build into).  Where the JAX package's test holds the
native library against the JAX solver, the twin here holds the port's
binding against the port's CPU path (``device="cpu"``) at the same
tolerance, and where the problem is a dense graph-form one also against the
JAX package's GraphFormSolver.  The binding's struct layout and the enum
values are held against src/include/pogs_tpu_native.h, compiled.
"""

import ctypes as ct
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import pogs_tpu.api.graph as Japi
import pogs_tpu_torch.api.graph as Papi
from pogs_tpu_torch.types import (
    Cone, ConeConstraint, Function, FunctionVector, SolverSettings, Status,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(ROOT, "src", "include", "pogs_tpu_native.h")
CPU = dict(device="cpu", dtype=np.float64)


@pytest.fixture(scope="session")
def native():
    from pogs_tpu_torch import native as nat

    nat.load()  # builds on first use; a failed build raises
    return nat


def _lasso_problem(m, n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    x_true = rng.standard_normal(n)
    x_true[rng.random(n) < 0.8] = 0.0
    b = A @ x_true + 0.1 * rng.standard_normal(m)
    lam = 0.2 * np.max(np.abs(A.T @ b))
    return A, b, lam


def _both(name, *args, **kw):
    """The port's CPU solve and the JAX package's of the same builder."""
    return (getattr(Papi, name)(*args, **CPU, **kw),
            getattr(Japi, name)(*args, dtype=np.float64, **kw))


# ---- the library and its ABI ---------------------------------------------------

def test_version(native):
    assert native.version() >= 10000


def test_builds_into_the_ports_build_dir(native):
    path = native.build()
    assert path == native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.parts[-3:-1] == ("build", "pogs_tpu_torch")
    assert path.name.startswith("libpogs_tpu_native_") and path.is_file()
    # The library of these sources is there: a second build compiles nothing.
    before = path.stat().st_mtime_ns
    assert native.build() == path and path.stat().st_mtime_ns == before
    flags = native.flags()
    assert flags[:4] == ["-std=c++20", "-O3", "-fPIC", "-shared"]


def test_struct_layout_matches_the_header(native, tmp_path):
    """Every field's offset and size, and each struct's size, as the host
    compiler lays them out from the header, against the ctypes structs."""
    structs = {"PogsNativeSettings": native.PogsNativeSettings,
               "PogsNativeInfo": native.PogsNativeInfo,
               "PogsNativeCone": native.PogsNativeCone}
    lines = ['#include <cstddef>', '#include <cstdio>', '#include "pogs_tpu_native.h"',
             "int main() {"]
    for name, cls in structs.items():
        lines.append(f'  std::printf("{name} - 0 %zu\\n", sizeof({name}));')
        for field, _ in cls._fields_:
            lines.append(f'  std::printf("{name} {field} %zu %zu\\n", offsetof({name}, {field}), '
                         f'sizeof((({name}*)0)->{field}));')
    lines.append("  return 0;\n}")
    src = tmp_path / "layout.cpp"
    src.write_text("\n".join(lines))
    exe = tmp_path / "layout"
    subprocess.run([native.compiler(), "-std=c++20", "-I", os.path.dirname(HEADER),
                    str(src), "-o", str(exe)], check=True, capture_output=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    seen = 0
    for line in out.splitlines():
        name, field, a, b = line.split()
        cls = structs[name]
        if field == "-":
            assert ct.sizeof(cls) == int(b), name
        else:
            desc = getattr(cls, field)
            assert (desc.offset, desc.size) == (int(a), int(b)), (name, field)
            seen += 1
    assert seen == sum(len(c._fields_) for c in structs.values())


def _header_enum(name):
    text = open(HEADER).read()
    body = re.search(r"enum %s \{(.*?)\};" % name, text, re.S).group(1)
    return {k: int(v) for k, v in re.findall(r"POGS_NATIVE_(\w+)\s*=\s*(\d+)", body)}


def test_enum_values_match_the_header():
    functions = _header_enum("PogsNativeFunction")
    assert functions == {f.name: int(f) for f in Function}
    statuses = _header_enum("PogsNativeStatus")
    assert statuses == {s.name: int(s) for s in Status}
    cones = dict(re.findall(r"(\w+)=(\d+)", re.search(
        r"Cones: (.*?)\(values match", open(HEADER).read(), re.S).group(1)))
    assert {k: int(v) for k, v in cones.items()} == {c.name: int(c) for c in Cone}


def test_enum_abi_stability():
    """Enum integer values are part of the C ABI (test_c_interface.cpp:149-162)."""
    assert int(Function.ABS) == 0
    assert int(Function.LOGISTIC) == 8
    assert int(Function.SQUARE) == 14
    assert int(Function.ZERO) == 15
    assert int(Status.SUCCESS) == 0
    assert int(Status.MAX_ITER) == 3
    assert int(Status.NAN_FOUND) == 4


def test_binding_imports_no_jax():
    code = ("import sys; import pogs_tpu_torch.native as n; n.load(); "
            "assert 'jax' not in sys.modules and 'pogs_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


# ---- graph form ------------------------------------------------------------------

def test_identity_lasso_soft_threshold(native):
    # A = I: x* = soft_threshold(b, lam) (tests/test_solver.cpp:43-114).
    n = 10
    b = np.array([3.0, -2.0, 0.5, -0.25, 1.5, 0.0, -4.0, 2.0, 0.9, -1.1])
    lam = 1.0
    f = FunctionVector(Function.SQUARE, n, b=b)
    g = FunctionVector(Function.ABS, n, c=lam)
    out = native.solve_graph_native(np.eye(n), f, g, abs_tol=1e-6, rel_tol=1e-6)
    assert out["status"] == Status.SUCCESS
    expect = np.sign(b) * np.maximum(np.abs(b) - lam, 0.0)
    np.testing.assert_allclose(out["x"], expect, atol=5e-4)


def test_native_matches_the_port_lasso(native):
    A, b, lam = _lasso_problem(80, 40, seed=3)
    f = FunctionVector(Function.SQUARE, 80, b=b)
    g = FunctionVector(Function.ABS, 40, c=lam)
    out_native = native.solve_graph_native(A, f, g, abs_tol=1e-6, rel_tol=1e-6)
    assert out_native["status"] == Status.SUCCESS
    for ref in _both("solve_lasso", A, b, lam, abs_tol=1e-5, rel_tol=1e-5, gap_stop=False):
        assert ref["status"] == int(Status.SUCCESS)
        assert out_native["optval"] == pytest.approx(ref["optval"], rel=1e-3)
        np.testing.assert_allclose(out_native["x"], ref["x"], atol=2e-3)


def test_warm_start_lambda_path(native):
    A, b, lam_max = _lasso_problem(60, 30, seed=5)
    solver = native.NativeDenseSolver(A)
    st = SolverSettings(abs_tol=1e-5, rel_tol=1e-5)
    f = FunctionVector(Function.SQUARE, 60, b=b)
    iters = []
    for frac in (1.0, 0.8, 0.6, 0.4):
        g = FunctionVector(Function.ABS, 30, c=frac * lam_max)
        out = solver.solve(f, g, st, warm_start=True)
        assert out["status"] == Status.SUCCESS
        iters.append(out["iterations"])
    solver.free()
    # Warm-started continuation should not be slower than the cold solve.
    assert min(iters[1:]) <= iters[0]


def test_sparse_native(native):
    sp = pytest.importorskip("scipy.sparse")
    rng = np.random.default_rng(11)
    A = sp.random(50, 25, density=0.3, random_state=7, format="csr")
    b = rng.standard_normal(50)
    f = FunctionVector(Function.SQUARE, 50, b=b)
    g = FunctionVector(Function.ABS, 25, c=0.05)
    out = native.solve_graph_native(A, f, g, abs_tol=1e-5, rel_tol=1e-5)
    assert out["status"] == Status.SUCCESS
    dense_out = native.solve_graph_native(np.asarray(A.todense()), f, g,
                                          abs_tol=1e-5, rel_tol=1e-5)
    assert out["optval"] == pytest.approx(dense_out["optval"], rel=1e-3)
    # A sparse tensor takes the same CSR route.
    C = A.tocoo()
    T = torch.sparse_coo_tensor(np.vstack([C.row, C.col]), C.data, C.shape,
                                check_invariants=True)
    out_t = native.solve_graph_native(T, f, g, abs_tol=1e-5, rel_tol=1e-5)
    assert out_t["optval"] == pytest.approx(out["optval"], rel=1e-12)


def test_nonneg_ls_native(native):
    rng = np.random.default_rng(21)
    A = rng.standard_normal((40, 20))
    b = rng.standard_normal(40)
    f = FunctionVector(Function.SQUARE, 40, b=b)
    g = FunctionVector(Function.INDGE0, 20)
    out = native.solve_graph_native(A, f, g, abs_tol=1e-6, rel_tol=1e-6)
    assert out["status"] == Status.SUCCESS
    assert np.all(out["x"] >= -1e-4)


def test_native_takes_tensors(native):
    """Tensor inputs (A, and the f and g parameters in float32) go to the host
    as float64: the same solve as the numpy one."""
    A, b, lam = _lasso_problem(50, 30, seed=2)
    # A linear term d keeps the ADMM runtime (no specialised path).
    f = FunctionVector(Function.HUBER, 50, b=b, d=0.05)
    g = FunctionVector(Function.ABS, 30, c=lam)
    ref = native.solve_graph_native(A, f, g)
    f32 = FunctionVector(Function.HUBER, 50, b=b, d=0.05, dtype=np.float32)
    g32 = FunctionVector(Function.ABS, 30, c=lam, dtype=np.float32)
    out = native.solve_graph_native(torch.as_tensor(A), f32, g32)
    assert "algorithm" not in out and out["status"] == ref["status"]
    assert out["optval"] == pytest.approx(ref["optval"], rel=1e-5)
    np.testing.assert_allclose(out["x"], ref["x"], atol=1e-4)


# ---- cone form -------------------------------------------------------------------

def test_cone_lp_native(native):
    """LP with known solution: min x1 + 2 x2 s.t. x1+x2 = 1, x >= 0."""
    A = np.array([[1.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    b = np.array([1.0, 0.0, 0.0])
    c = np.array([1.0, 2.0])
    Ky = [ConeConstraint(Cone.ZERO, [0]), ConeConstraint(Cone.NON_NEG, [1, 2])]
    out = native.solve_cone_native(A, b, c, Ky=Ky, abs_tol=1e-6, rel_tol=1e-6)
    assert out["status"] == Status.SUCCESS
    assert out["optval"] == pytest.approx(1.0, abs=1e-3)
    np.testing.assert_allclose(out["x"], [1.0, 0.0], atol=2e-3)


def test_cone_socp_native_matches_the_port(native):
    """SOCP with closed form: min c'x s.t. ||x − x0|| ≤ r
    → x* = x0 − r c/||c||, optval = c'x0 − r||c||."""
    from pogs_tpu_torch.api.cone import solve_cone

    rng = np.random.default_rng(3)
    n = 5
    x0 = rng.standard_normal(n)
    c = rng.standard_normal(n)
    r = 1.5
    # b − Ax = (r, x − x0) ∈ SOC.
    A = np.vstack([np.zeros((1, n)), -np.eye(n)])
    b = np.concatenate([[r], -x0])
    Ky = [ConeConstraint(Cone.SOC, range(n + 1))]
    expect = float(c @ x0 - r * np.linalg.norm(c))

    out_n = native.solve_cone_native(A, b, c, Ky=Ky, abs_tol=1e-7, rel_tol=1e-7,
                                     max_iter=20000)
    assert out_n["status"] == Status.SUCCESS
    assert out_n["optval"] == pytest.approx(expect, rel=1e-3, abs=1e-3)

    out_p = solve_cone(A, b, c, Ky=Ky, abs_tol=1e-6, rel_tol=1e-6, max_iter=10000, **CPU)
    assert out_p["status"] == int(Status.SUCCESS)
    assert out_n["optval"] == pytest.approx(out_p["optval"], rel=1e-3, abs=1e-3)


def test_cone_native_rejects_bad_sdp_length(native):
    """SDP blocks must be svec-packed: num_indices a triangular number."""
    A = np.eye(4)
    Ky = [ConeConstraint(Cone.SDP, [0, 1, 2, 3])]  # 4 is not d(d+1)/2
    with pytest.raises(RuntimeError):
        native.NativeConeSolver(A, Ky=Ky)


def _svec_pack(S):
    """Column-major lower-tri svec packing (√2-scaled off-diagonals)."""
    d = S.shape[0]
    out = []
    for col in range(d):
        for row in range(col, d):
            out.append(S[row, col] * (1.0 if row == col else np.sqrt(2.0)))
    return np.asarray(out)


def test_cone_native_sdp_min_eig(native):
    """min ⟨C,X⟩ s.t. tr X = 1, X ⪰ 0 → λ_min(C), by the native Jacobi
    eigensolver's SDP projection."""
    rng = np.random.default_rng(31)
    d = 5
    L = d * (d + 1) // 2
    C = rng.standard_normal((d, d))
    C = (C + C.T) / 2
    c = _svec_pack(C)
    A = _svec_pack(np.eye(d))[None, :]
    b = np.array([1.0])
    Kx = [ConeConstraint(Cone.SDP, range(L))]
    Ky = [ConeConstraint(Cone.ZERO, [0])]
    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=20000)
    res = native.NativeConeSolver(A, Kx=Kx, Ky=Ky).solve(b, c, settings=st)
    assert res["status"] == Status.SUCCESS
    expect = float(np.linalg.eigvalsh(C).min())
    assert res["optval"] == pytest.approx(expect, abs=1e-3, rel=1e-3)


def test_native_sdp_solve_matches_the_port(native):
    """The native SDP cone solve against the port's ConeSolver
    (assume_svec=True) on a random linear SDP with trace normalization."""
    from pogs_tpu_torch.api.cone import solve_cone

    rng = np.random.default_rng(57)
    d = 4
    L = d * (d + 1) // 2
    C = rng.standard_normal((d, d))
    C = (C + C.T) / 2
    c = _svec_pack(C)
    # Two linear constraints: tr X = 1 and <B, X> = 0.3 (random symmetric B).
    B = rng.standard_normal((d, d))
    B = (B + B.T) / 2
    A = np.vstack([_svec_pack(np.eye(d)), _svec_pack(B)])
    b = np.array([1.0, 0.3])
    Kx = [ConeConstraint(Cone.SDP, range(L))]
    Ky = [ConeConstraint(Cone.ZERO, [0, 1])]
    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=40000)
    res_nat = native.NativeConeSolver(A, Kx=Kx, Ky=Ky).solve(b, c, settings=st)
    res_py = solve_cone(A, b, c, Kx=Kx, Ky=Ky, abs_tol=1e-6, rel_tol=1e-6,
                        max_iter=40000, assume_svec=True, **CPU)
    assert res_nat["status"] == Status.SUCCESS
    assert res_py["status"] == 0
    assert res_nat["optval"] == pytest.approx(res_py["optval"], rel=1e-3, abs=1e-3)
    np.testing.assert_allclose(res_nat["x"], res_py["x"], atol=5e-3)


def _qp_problem(rng, m, n, A=None):
    """A QP with a KKT-constructed optimum: (A, P, b, c, optval)."""
    if A is None:
        A = rng.standard_normal((m, n))
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + 0.5 * np.eye(n)
    xstar = rng.standard_normal(n)
    act = rng.permutation(m)[: n // 2]
    mask = np.zeros(m, dtype=bool)
    mask[act] = True
    ystar = np.where(mask, np.abs(rng.standard_normal(m)) + 0.5, 0.0)
    sstar = np.where(mask, 0.0, np.abs(rng.standard_normal(m)) + 0.5)
    return A, P, xstar, ystar, sstar


def test_native_qp_known_optimum(native):
    """Native QP entries (the reference's PogsConeQD/PogsConeDirectQD,
    pogs_c.h:167-243): dense and sparse-A QPs against KKT-constructed
    optima, and agreement with the port's QP path."""
    from pogs_tpu_torch.api.cone import solve_cone

    rng = np.random.default_rng(83)
    m, n = 40, 20
    A, P, xstar, ystar, sstar = _qp_problem(rng, m, n)
    b = A @ xstar + sstar
    c = -(P @ xstar) - A.T @ ystar
    opt = float(0.5 * xstar @ P @ xstar + c @ xstar)
    Ky = [ConeConstraint(Cone.NON_NEG, np.arange(m))]
    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=20000)

    res = native.NativeConeSolver(A, Ky=Ky, P=P).solve(b, c, settings=st)
    assert res["status"] == Status.SUCCESS
    assert res["optval"] == pytest.approx(opt, rel=1e-3, abs=1e-3)

    res_py = solve_cone(A, b, c, Kx=(), Ky=Ky, P=P, abs_tol=1e-6, rel_tol=1e-6,
                        max_iter=20000, **CPU)
    assert res_py["status"] == 0
    assert res["optval"] == pytest.approx(res_py["optval"], rel=1e-3, abs=1e-3)

    scipy_sparse = pytest.importorskip("scipy.sparse")
    As = scipy_sparse.csr_matrix(A * (np.abs(A) > 0.3))
    b2 = As @ xstar + sstar
    c2 = -(P @ xstar) - As.T @ ystar
    opt2 = float(0.5 * xstar @ P @ xstar + c2 @ xstar)
    res2 = native.NativeConeSolver(As, Ky=Ky, P=P).solve(b2, c2, settings=st)
    assert res2["status"] == Status.SUCCESS
    assert res2["optval"] == pytest.approx(opt2, rel=1e-3, abs=1e-3)


def test_native_qp_rejects_kx(native):
    A = np.eye(3)
    P = np.eye(3)
    Kx = [ConeConstraint(Cone.NON_NEG, [0, 1, 2])]
    with pytest.raises(ValueError, match="not supported"):
        native.NativeConeSolver(A, Kx=Kx, P=P)


def test_port_sparse_qp_known_optimum():
    """A sparse-A QP through the port's own QP path (no native runtime)."""
    scipy_sparse = pytest.importorskip("scipy.sparse")
    from pogs_tpu_torch.api.cone import solve_cone

    rng = np.random.default_rng(91)
    m, n = 40, 20
    A = rng.standard_normal((m, n)) * (np.abs(rng.standard_normal((m, n))) > 0.5)
    A, P, xstar, ystar, sstar = _qp_problem(rng, m, n, A=A)
    b = A @ xstar + sstar
    c = -(P @ xstar) - A.T @ ystar
    opt = float(0.5 * xstar @ P @ xstar + c @ xstar)
    Ky = [ConeConstraint(Cone.NON_NEG, np.arange(m))]
    r = solve_cone(scipy_sparse.csr_matrix(A), b, c, Kx=(), Ky=Ky, P=P,
                   abs_tol=1e-5, rel_tol=1e-5, max_iter=20000, **CPU)
    assert r["status"] == 0
    assert r["optval"] == pytest.approx(opt, rel=1e-3, abs=1e-3)


def test_cone_exp_native(native):
    """Exponential-cone feasibility: min t s.t. (1, 1, t) in K_exp → t = e."""
    # variables x = (t,); rows: b - Ax = (1, 1, t) in EXP_PRIMAL
    A = np.array([[0.0], [0.0], [-1.0]])
    b = np.array([1.0, 1.0, 0.0])
    c = np.array([1.0])
    Ky = [ConeConstraint(Cone.EXP_PRIMAL, [0, 1, 2])]
    out = native.solve_cone_native(A, b, c, Ky=Ky, abs_tol=1e-7, rel_tol=1e-7,
                                   max_iter=10000)
    assert out["status"] == Status.SUCCESS
    assert out["x"][0] == pytest.approx(np.e, rel=1e-2)


def test_cone_sparse_native_lp(native):
    """Sparse CSR cone solve (CGLS projector) matches the dense path."""
    sp = pytest.importorskip("scipy.sparse")
    A = np.array([[1.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    b = np.array([1.0, 0.0, 0.0])
    c = np.array([1.0, 2.0])
    Ky = [ConeConstraint(Cone.ZERO, [0]), ConeConstraint(Cone.NON_NEG, [1, 2])]
    solver = native.NativeConeSolver(sp.csr_matrix(A), Ky=Ky)
    out = solver.solve(b, c, SolverSettings(abs_tol=1e-6, rel_tol=1e-6))
    solver.free()
    assert out["status"] == Status.SUCCESS
    assert out["optval"] == pytest.approx(1.0, abs=1e-2)
    np.testing.assert_allclose(out["x"], [1.0, 0.0], atol=1e-2)


def test_native_qp_rejects_bad_P(native):
    """A NaN or asymmetric P is rejected at construction, and a symmetric but
    indefinite P (whose P+rhoI Cholesky fails) never comes back as SUCCESS."""
    rng = np.random.default_rng(17)
    m, n = 12, 6
    A = rng.standard_normal((m, n))
    Ky = [ConeConstraint(Cone.NON_NEG, np.arange(m))]

    P_nan = np.eye(n)
    P_nan[0, 0] = np.nan
    with pytest.raises(RuntimeError):
        native.NativeConeSolver(A, Ky=Ky, P=P_nan)

    P_asym = np.eye(n)
    P_asym[0, 1] = 1.0  # [1,0] stays 0
    with pytest.raises(RuntimeError):
        native.NativeConeSolver(A, Ky=Ky, P=P_asym)

    P_indef = -10.0 * np.eye(n)
    b = A @ rng.standard_normal(n) + 1.0
    c = rng.standard_normal(n)
    res = native.NativeConeSolver(A, Ky=Ky, P=P_indef).solve(
        b, c, settings=SolverSettings(max_iter=200))
    assert res["status"] == Status.NAN_FOUND


def test_native_qp_polish_machine_precision(native):
    """The native PDAS polish (qp_polish.hpp) lifts cone-QP solves to about
    machine precision when the ADMM seed identifies the active set.  HS35:
    published optimum 1/9 (Hock–Schittkowski 1981)."""
    sys.path.insert(0, ROOT)
    from benchmarks import maros_meszaros as mm

    p = [q for q in mm.problems() if q["name"] == "HS35"][0]
    P, c, A_bar, b_bar, n_eq = mm.to_cone_form(p)
    m = A_bar.shape[0]
    Ky = []
    if n_eq:
        Ky.append(ConeConstraint(Cone.ZERO, range(n_eq)))
    if m > n_eq:
        Ky.append(ConeConstraint(Cone.NON_NEG, range(n_eq, m)))
    s = native.NativeConeSolver(A_bar, Ky=Ky, P=P)
    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=2000)
    r = s.solve(b_bar, c, settings=st)
    obj = float(r["optval"]) + p["c0"]
    assert int(r["status"]) == 0
    assert abs(obj - p["optval"]) <= 1e-9
    # polish off: plain ADMM accuracy only (documents the knob works)
    r2 = s.solve(b_bar, c, settings=st.replace(polish=False))
    obj2 = float(r2["optval"]) + p["c0"]
    assert abs(obj2 - p["optval"]) <= 1e-3


# ---- backend= on solve_graph_form ----------------------------------------------

def test_backend_native_forced_matches_the_port(native, rng):
    A = rng.normal(size=(60, 30))
    b = rng.normal(size=60)
    lam = 0.2 * np.max(np.abs(A.T @ b))
    r_native = Papi.solve_lasso(A, b, lam, backend="native", gap_stop=False)
    assert r_native["backend"] == "native"
    assert r_native["status"] == 0 and isinstance(r_native["status"], int)
    assert r_native["solve_time"] > 0
    for ref in _both("solve_lasso", A, b, lam, gap_stop=False):
        assert r_native["optval"] == pytest.approx(ref["optval"], rel=1e-3)


def test_backend_native_takes_a_tensor_and_a_sparse_A(native, rng):
    sp = pytest.importorskip("scipy.sparse")
    A = rng.normal(size=(40, 20))
    b = rng.normal(size=40)
    r_np = Papi.solve_huber(A, b, backend="native")
    r_t = Papi.solve_huber(torch.as_tensor(A), b, backend="native")
    assert r_t["optval"] == pytest.approx(r_np["optval"], rel=1e-12)
    As = sp.csr_matrix(A * (np.abs(A) > 0.5))
    r_s = Papi.solve_lasso(As, b, 0.1, backend="native", abs_tol=1e-5, rel_tol=1e-5)
    r_d = Papi.solve_lasso(As, b, 0.1, sparse_policy="keep", abs_tol=1e-5, rel_tol=1e-5,
                           **CPU)
    assert r_s["backend"] == "native" and r_s["status"] == 0
    assert r_s["optval"] == pytest.approx(r_d["optval"], rel=1e-3)


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_backend_auto_and_torch_stay_on_the_device(native, rng, monkeypatch, backend):
    """"auto" is the device path even for a tiny one-shot problem: the JAX
    package's native threshold is a TPU transport workaround."""
    def refuse(*a, **k):
        raise AssertionError("routed to the native runtime")

    monkeypatch.setattr(native, "solve_graph_native", refuse)
    A = rng.normal(size=(20, 10))
    b = rng.normal(size=20)
    r = Papi.solve_lasso(A, b, 0.5, gap_stop=False, backend=backend, device="cpu")
    assert "backend" not in r and r["status"] == 0


@pytest.mark.parametrize("backend", ["cuda", "jax", "NATIVE"])
def test_unknown_backend_raises(backend):
    with pytest.raises(ValueError, match="backend"):
        Papi.solve_lasso(np.ones((4, 2)), np.ones(4), 0.1, backend=backend)


# ---- coordinate-descent fast path (src/native/cd.hpp) ----------------------------

def test_cd_lasso_matches_the_port(native):
    A, b, lam = _lasso_problem(120, 60, seed=9)
    out = native.lasso_cd(A, b, lam, settings=SolverSettings(abs_tol=1e-7))
    assert out["status"] == Status.SUCCESS
    assert out["algorithm"] == "cd"
    for ref in _both("solve_lasso", A, b, lam, abs_tol=1e-8, rel_tol=1e-8, max_iter=20000):
        assert abs(out["optval"] - float(ref["optval"])) <= 1e-6 * (
            1.0 + abs(float(ref["optval"])))
    # exact subgradient optimality at the returned point
    r = b - A @ out["x"]
    g = -A.T @ r
    kkt = np.max(np.where(np.abs(out["x"]) > 0,
                          np.abs(g + lam * np.sign(out["x"])),
                          np.maximum(np.abs(g) - lam, 0.0)))
    assert kkt <= 1e-7 * (1.0 + lam)
    # duals: mu = A'r must sit in lam * subgradient(|x|)
    np.testing.assert_allclose(out["mu"], A.T @ r, atol=1e-12)
    np.testing.assert_allclose(out["y"], A @ out["x"], atol=1e-12)


def test_cd_routed_from_solve_graph_native(native):
    """solve_graph_native routes lasso/elastic-net shapes to CD and keeps the
    ADMM runtime for everything else."""
    A, b, lam = _lasso_problem(90, 50, seed=11)
    f = FunctionVector(Function.SQUARE, 90, b=b)
    g = FunctionVector(Function.ABS, 50, c=lam, e=0.7)
    out = native.solve_graph_native(A, f, g, abs_tol=1e-7, rel_tol=1e-7)
    assert out.get("algorithm") == "cd"
    for ref in _both("solve_elastic_net", A, b, lam, 0.7, abs_tol=1e-8, rel_tol=1e-8,
                     max_iter=20000):
        assert abs(out["optval"] - float(ref["optval"])) <= 1e-6 * (
            1.0 + abs(float(ref["optval"])))
    # huber f is NOT the CD shape: must fall back to the ADMM runtime
    f2 = FunctionVector(Function.HUBER, 90, b=b)
    out2 = native.solve_graph_native(A, f2, g, abs_tol=1e-5, rel_tol=1e-5)
    assert "algorithm" not in out2


def test_cd_per_coordinate_weights_and_warm_start(native):
    A, b, lam = _lasso_problem(100, 40, seed=13)
    rng = np.random.default_rng(13)
    l1 = lam * rng.uniform(0.5, 1.5, 40)
    out = native.lasso_cd(A, b, l1, settings=SolverSettings(abs_tol=1e-7))
    assert out["status"] == Status.SUCCESS
    r = b - A @ out["x"]
    g = -A.T @ r
    kkt = np.max(np.where(np.abs(out["x"]) > 0,
                          np.abs(g + l1 * np.sign(out["x"])),
                          np.maximum(np.abs(g) - l1, 0.0)))
    assert kkt <= 1e-7 * (1.0 + l1.max())
    # warm start from the solution: one confirmation sweep-batch only
    out2 = native.lasso_cd(A, b, l1, settings=SolverSettings(abs_tol=1e-7), x0=out["x"])
    assert out2["iterations"] <= 2
    np.testing.assert_allclose(out2["x"], out["x"], atol=1e-10)


def test_cd_zero_lambda_is_least_squares(native):
    rng = np.random.default_rng(17)
    A = rng.standard_normal((60, 20))
    b = rng.standard_normal(60)
    out = native.lasso_cd(A, b, 0.0, settings=SolverSettings(abs_tol=1e-9, max_iter=20000))
    x_ls, *_ = np.linalg.lstsq(A, b, rcond=None)
    np.testing.assert_allclose(out["x"], x_ls, atol=1e-6)


# ---- GLM fast paths (src/native/glm.hpp) -----------------------------------------

def test_ridge_direct_closed_form(native):
    rng = np.random.default_rng(21)
    A = rng.standard_normal((80, 50))
    b = rng.standard_normal(80)
    lam = 0.7
    f = FunctionVector(Function.SQUARE, 80, b=b)
    g = FunctionVector(Function.SQUARE, 50, c=lam)
    out = native.solve_graph_native(A, f, g)
    assert out["algorithm"] == "ridge_direct"
    x_exact = np.linalg.solve(A.T @ A + lam * np.eye(50), A.T @ b)
    np.testing.assert_allclose(out["x"], x_exact, atol=1e-9)
    # wide case goes through the m x m dual system
    Aw = rng.standard_normal((30, 90))
    bw = rng.standard_normal(30)
    fw = FunctionVector(Function.SQUARE, 30, b=bw)
    gw = FunctionVector(Function.SQUARE, 90, c=lam)
    ow = native.solve_graph_native(Aw, fw, gw)
    xw = np.linalg.solve(Aw.T @ Aw + lam * np.eye(90), Aw.T @ bw)
    np.testing.assert_allclose(ow["x"], xw, atol=1e-9)
    # per-coordinate l2 via c + e
    l2 = rng.uniform(0.2, 2.0, 50)
    g2 = FunctionVector(Function.SQUARE, 50, c=l2 * 0.25, e=l2 * 0.75)
    o2 = native.solve_graph_native(A, f, g2)
    x2 = np.linalg.solve(A.T @ A + np.diag(l2), A.T @ b)
    np.testing.assert_allclose(o2["x"], x2, atol=1e-9)


def test_svm_dual_cd_vs_admm(native):
    rng = np.random.default_rng(23)
    m, n = 120, 40
    A = rng.standard_normal((m, n))
    y = np.sign(A @ rng.standard_normal(n) + 0.1 * rng.standard_normal(m))
    lam = 1.0
    f = FunctionVector(Function.MAXPOS0, m, a=-y, b=-1.0)
    g = FunctionVector(Function.SQUARE, n, c=lam)
    out = native.solve_graph_native(A, f, g, abs_tol=1e-6, max_iter=20000)
    assert out["algorithm"] == "svm_dual_cd"

    def obj(x):
        return np.maximum(0.0, 1.0 - y * (A @ x)).sum() + 0.5 * lam * x @ x

    for ref in _both("solve_svm", A, y, lam, abs_tol=1e-7, rel_tol=1e-7, max_iter=40000):
        ref_obj = obj(np.asarray(ref["x"]))
        assert obj(out["x"]) <= ref_obj + 1e-4 * (1.0 + abs(ref_obj))


def test_logistic_pn_vs_admm(native):
    rng = np.random.default_rng(27)
    m, n = 150, 40
    A = rng.standard_normal((m, n))
    y = np.sign(A @ rng.standard_normal(n) + 0.5 * rng.standard_normal(m))
    lam = 0.01 * np.max(np.abs(A.T @ y))
    f = FunctionVector(Function.LOGISTIC, m, a=-y)
    g = FunctionVector(Function.ABS, n, c=lam)
    out = native.solve_graph_native(A, f, g, abs_tol=1e-7, max_iter=200)
    assert out["algorithm"] == "logistic_pn"
    assert out["status"] == Status.SUCCESS

    def obj(x):
        return np.logaddexp(0.0, -y * (A @ x)).sum() + lam * np.abs(x).sum()

    for ref in _both("solve_logistic", A, y, lam, abs_tol=1e-7, rel_tol=1e-7,
                     max_iter=40000):
        ref_obj = obj(np.asarray(ref["x"]))
        assert obj(out["x"]) <= ref_obj + 1e-5 * (1.0 + abs(ref_obj))
    # true-problem subgradient KKT at the returned point
    mu_s = 1.0 / (1.0 + np.exp(y * (A @ out["x"])))
    grad = -A.T @ (y * mu_s)
    kkt = np.max(np.where(np.abs(out["x"]) > 0,
                          np.abs(grad + lam * np.sign(out["x"])),
                          np.maximum(np.abs(grad) - lam, 0.0)))
    assert kkt <= 1e-6 * (1.0 + lam)


def test_glm_shapes_not_misrouted(native):
    """Objectives NEAR but not exactly the GLM shapes must keep ADMM."""
    rng = np.random.default_rng(29)
    A = rng.standard_normal((40, 20))
    b = rng.standard_normal(40)
    # ridge-like but with an f offset d: not the ridge shape
    f = FunctionVector(Function.SQUARE, 40, b=b, d=0.1)
    g = FunctionVector(Function.SQUARE, 20, c=1.0)
    out = native.solve_graph_native(A, f, g, abs_tol=1e-5, rel_tol=1e-5)
    assert "algorithm" not in out
    # logistic with non-unit labels: not the fast-path shape
    f2 = FunctionVector(Function.LOGISTIC, 40, a=-2.0 * np.ones(40))
    g2 = FunctionVector(Function.ABS, 20, c=0.5)
    out2 = native.solve_graph_native(A, f2, g2, abs_tol=1e-4, rel_tol=1e-4)
    assert "algorithm" not in out2


def test_huber_irls_vs_admm(native):
    rng = np.random.default_rng(31)
    m, n = 140, 40
    A = rng.standard_normal((m, n))
    x_true = rng.standard_normal(n)
    b = A @ x_true + 0.1 * rng.standard_normal(m)
    b[rng.random(m) < 0.05] += 8.0  # outliers: where huber earns its keep
    delta = 1.0
    lam = 0.3
    f = FunctionVector(Function.HUBER, m, a=1.0 / delta, b=b / delta, c=delta * delta)
    g = FunctionVector(Function.ABS, n, c=lam)
    out = native.solve_graph_native(A, f, g, abs_tol=1e-7, max_iter=2000)
    assert out["algorithm"] == "huber_irls"
    assert out["status"] == Status.SUCCESS

    def obj(x):
        r = A @ x - b
        h = np.where(np.abs(r) <= delta, 0.5 * r * r, delta * np.abs(r) - 0.5 * delta * delta)
        return h.sum() + lam * np.abs(x).sum()

    for ref in _both("solve_huber", A, b, delta=delta, lambd=lam, abs_tol=1e-7,
                     rel_tol=1e-7, max_iter=40000):
        ref_obj = obj(np.asarray(ref["x"]))
        assert obj(out["x"]) <= ref_obj + 1e-5 * (1.0 + abs(ref_obj))
    # plain huber fit (no l1, ZERO g) also routes and converges
    g0 = FunctionVector(Function.ZERO, n)
    out0 = native.solve_graph_native(A, f, g0, abs_tol=1e-7, max_iter=2000)
    assert out0["algorithm"] == "huber_irls"
    assert out0["status"] == Status.SUCCESS
    # non-default delta consistency: delta=0.4 against scipy's minimizer
    from scipy.optimize import minimize as _mini

    d2 = 0.4
    f2 = FunctionVector(Function.HUBER, m, a=1.0 / d2, b=b / d2, c=d2 * d2)
    out2 = native.solve_graph_native(A, f2, g0, abs_tol=1e-8, max_iter=2000)

    def obj2(x):
        r = A @ x - b
        return np.where(np.abs(r) <= d2, 0.5 * r * r, d2 * np.abs(r) - 0.5 * d2 * d2).sum()

    sci = _mini(obj2, np.zeros(n), method="L-BFGS-B", options={"maxiter": 2000, "ftol": 1e-14})
    assert obj2(out2["x"]) <= sci.fun + 1e-5 * (1.0 + abs(sci.fun))


def test_nnls_pdas_vs_scipy(native):
    from scipy.optimize import nnls as scipy_nnls

    rng = np.random.default_rng(33)
    # Tall: the active-set fast path must handle it outright.  Wide: the
    # Gram is singular, so the PDAS may be rejected — the ADMM fallback
    # must still deliver the optimum (looser tolerance).
    for m, n, want_fast, rtol in ((60, 30, True, 1e-8), (40, 70, False, 1e-4)):
        A = rng.standard_normal((m, n))
        b = rng.standard_normal(m)
        f = FunctionVector(Function.SQUARE, m, b=b)
        g = FunctionVector(Function.INDGE0, n)
        out = native.solve_graph_native(A, f, g, abs_tol=1e-8, rel_tol=1e-6)
        if want_fast:
            assert out["algorithm"] == "nnls_pdas"
            assert out["status"] == Status.SUCCESS
        assert np.all(np.asarray(out["x"]) >= -1e-6)
        x_ref = scipy_nnls(A, b)[0]
        obj = 0.5 * np.sum((A @ np.maximum(out["x"], 0.0) - b) ** 2)
        obj_ref = 0.5 * np.sum((A @ x_ref - b) ** 2)
        assert obj <= obj_ref + rtol * (1.0 + obj_ref)


def test_cd_lasso_path_warm(native):
    """Warm-started λ-path: interior grid points must cost only a few
    confirmation sweeps, and every point must match a cold solve."""
    A, b, lam = _lasso_problem(150, 60, seed=37)
    lambdas = np.geomspace(1.0, 0.1, 12) * lam
    path = native.lasso_path_cd(A, b, lambdas, settings=SolverSettings(abs_tol=1e-7))
    assert path["x"].shape == (12, 60)
    # warm interior steps are much cheaper than the cold first step
    assert path["sweeps"][1:].mean() <= path["sweeps"][0]
    for k in (0, 5, 11):
        cold = native.lasso_cd(A, b, lambdas[k], settings=SolverSettings(abs_tol=1e-7))
        assert abs(path["optval"][k] - cold["optval"]) <= 1e-6 * (1.0 + abs(cold["optval"]))
