"""The lasso family: min ½‖Ax − b‖² + λ‖x‖₁ with f = SQUARE, g = ABS.

Data as the POGS comparison protocol makes it (``benchmarks/problems.py``
``lasso``): A ~ N(0, 1); x_true ~ N(0, 1) with each entry zeroed with
probability ``sparsity``; b = A x_true + ``noise``·N(0, 1); λ =
``lambda_ratio``·‖Aᵀb‖∞.  Everything is made on the device from the run's
seed streams (``perfbench/data.py``), in the configuration's dtype.

Three entries, one per way users call the solver:

* ``refit``: one ``GraphFormSolver`` built and initialised in set-up; each
  request a fresh b and λ, solved from a cold start;
* ``oneshot``: each request a fresh A, b and λ through ``solve_lasso``;
* ``path``: each request a fresh b and a λ-path through
  ``solve_lasso_path``, independent lanes.
"""

from __future__ import annotations

import torch

from perfbench import data
from perfbench.reference import lasso as ref
from perfbench.reference.admm import exact_products


def make_matrix(cfg, gen, device):
    return torch.randn(cfg["m"], cfg["n"], generator=gen, device=device,
                       dtype=getattr(torch, cfg["dtype"]))


def make_response(cfg, A, gen):
    """(b, λ_max = ‖Aᵀb‖∞) of one request on A, from ``gen``."""
    m, n = A.shape
    opts = dict(generator=gen, device=A.device, dtype=A.dtype)
    x_true = torch.randn(n, **opts)
    x_true = x_true * (torch.rand(n, **opts) >= cfg["sparsity"])
    noise = torch.randn(m, **opts)
    with exact_products():
        b = A @ x_true + cfg["noise"] * noise
        lam_max = (A.T @ b).abs().max()
    return b, lam_max


def settings(P, cfg):
    return P.SolverSettings(abs_tol=cfg["abs_tol"], rel_tol=cfg["rel_tol"],
                            max_iter=cfg["max_iter"], gap_stop=cfg["gap_stop"],
                            adaptive_rho=cfg["adaptive_rho"], rho=cfg["rho"])


class _Lasso:
    """What the three entries share: the config, the seed, the problems and
    the judge."""

    fresh_matrix = False          # True: each request makes its own A
    # The precision of ``control``: the reference one step below float32.
    precision = "tf32"

    def __init__(self, P, cfg, traffic, seed, device):
        self.P, self.cfg, self.traffic, self.seed, self.device = P, cfg, traffic, seed, device
        self.m, self.n = cfg["m"], cfg["n"]
        self.dtype = getattr(torch, cfg["dtype"])
        self.dtype_name = cfg["dtype"]
        self.itemsize = self.dtype.itemsize
        self.settings = settings(P, cfg)
        self.A = None

    def setup(self):
        if not self.fresh_matrix:
            self.A = self.matrix()

    def release(self):
        """Let go of the program's state before the reference runs."""
        self.solver = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def matrix(self):
        return make_matrix(self.cfg, data.generator(self.device, self.seed, data.MATRIX),
                           self.device)

    def lambdas(self, lam_max):
        """The request's λ values from its ‖Aᵀb‖∞ (one, in float64)."""
        return torch.tensor([float(lam_max) * self.cfg["lambda_ratio"]], dtype=torch.float64,
                            device=self.device)

    def problem(self, i, A=None):
        """Request i's (A, b, λs) from the seed (i = None: the warm-up's);
        ``A`` is the fixed matrix where the cell has one."""
        key = (data.WARMUP,) if i is None else (data.REQUEST, i)
        gen = data.generator(self.device, self.seed, *key)
        if A is None:
            A = make_matrix(self.cfg, gen, self.device)
        b, lam_max = make_response(self.cfg, A, gen)
        return A, b, self.lambdas(lam_max)

    def request(self, i):
        A, b, lams = self.problem(i, self.A)
        return {"i": i, "A": A, "b": b, "lams": lams, "lam": float(lams[0])}

    def keep_answers(self, req, status, iters, x):
        # Answers wait on the host: kept on the card they would grow its
        # memory pool, and cudaMalloc would stall the window.
        return {"i": req["i"], "status": status, "iters": iters, "x": x.detach().cpu()}

    def control(self, req):
        cfg = self.cfg
        K = req["lams"].shape[0]
        res = ref.solve(req["A"], req["b"][:, None].expand(-1, K), req["lams"],
                        cfg["abs_tol"], cfg["rel_tol"], cfg["max_iter"], self.precision)
        return self.keep_answers(req, res.status.tolist(), res.iterations.tolist(), res.x)

    def judge(self, kept):
        """The sampled answers against the float64 optima of their problems,
        each made again from the seed: the reference reads nothing the
        program was handed or made but its answers.  Problems on one A are
        judged together."""
        A = None if self.fresh_matrix else self.matrix()
        batches = [[k] for k in kept] if self.fresh_matrix else [kept]
        parts = []
        for batch in batches:
            cols, lams, xs = [], [], []
            for k in batch:
                A_k, b, lam = self.problem(k["i"], A)
                cols.append(b[:, None].expand(-1, lam.shape[0]))
                lams.append(lam.to(torch.float64))
                xs.append(k["x"])
            normal = ref.Normal(A_k)
            del A_k
            parts.append(self.judge_columns(normal, torch.cat(cols, dim=1), torch.cat(lams),
                                            torch.cat(xs, dim=1).to(self.device)))
            del normal
        return _max_numbers(parts)

    def judge_columns(self, normal, B, lams, X):
        """The reference's numbers for K answers X (n, K) to (B, lams) on
        one A: each answer's objective gap and distance to the float64
        optimum, its optimality violation, and the optimum's own."""
        X_ref, ref_kkt = normal.optimum(B, lams)
        X = X.to(torch.float64)
        f_ref = normal.objective(B, lams, X_ref)
        gap = (normal.objective(B, lams, X) - f_ref) / f_ref.abs()
        err = (X - X_ref).norm(dim=0) / X_ref.norm(dim=0).clamp(min=1.0)
        kkt = normal.kkt(normal.atb(B), lams, X)
        return {"kkt": kkt, "obj_gap": gap, "x_err": err, "ref_kkt": ref_kkt}


def _max_numbers(parts):
    """The worst of each number over the judged answers."""
    return {key: float(torch.cat([p[key].reshape(-1) for p in parts]).max())
            for key in ("kkt", "obj_gap", "x_err", "ref_kkt")}


class Refit(_Lasso):
    """One solver on one A; each request re-solves it for a fresh b and λ."""

    route = {"fused_admm_loop": 1}
    kernel = "fused_admm_kernel"

    def setup(self):
        super().setup()
        self.solver = self.P.GraphFormSolver(self.A, settings=self.settings,
                                             device=self.device).init()

    def call(self, req):
        P = self.P
        f = P.FunctionVector(P.Function.SQUARE, self.m, b=req["b"])
        g = P.FunctionVector(P.Function.ABS, self.n, c=req["lam"])
        self.solver.reset_warm_start()
        return self.solver.solve(f, g, rho=self.settings.rho)

    def keep(self, req, res):
        return self.keep_answers(req, [int(res.status)], [int(res.final_iter) + 1],
                                 res.x.reshape(-1, 1))


class OneShot(_Lasso):
    """Each request a fresh problem, A included, through ``solve_lasso``."""

    route = {"fused_admm_loop": 1}
    kernel = "fused_admm_kernel"
    fresh_matrix = True

    def call(self, req):
        st = self.settings
        return self.P.solve_lasso(req["A"], req["b"], req["lam"], abs_tol=st.abs_tol,
                                  rel_tol=st.rel_tol, max_iter=st.max_iter,
                                  gap_stop=st.gap_stop, adaptive_rho=st.adaptive_rho,
                                  rho=st.rho)

    def keep(self, req, out):
        return self.keep_answers(req, [int(out["status"])], [int(out["iterations"]) + 1],
                                 torch.as_tensor(out["x"]).reshape(-1, 1))


class Path(_Lasso):
    """One A; each request a fresh b and a λ-path of independent lanes."""

    route = {"fused_batched_lasso_sweep.stream": 1}
    kernel = "sweep_kernel"

    def setup(self):
        super().setup()
        K = self.traffic["nlambda"]
        k = torch.arange(K, dtype=torch.float64, device=self.device)
        self.ladder = (self.traffic["lambda_min_ratio"] ** (k / (K - 1))).to(self.dtype)

    def lambdas(self, lam_max):
        """glmnet's path: λ_max·ratio^(k/(K−1)), k = 0..K−1, in A's dtype."""
        return lam_max * self.ladder

    def call(self, req):
        from pogs_tpu_torch.parallel import solve_lasso_path

        return solve_lasso_path(self.A, req["b"], req["lams"], settings=self.settings)

    def keep(self, req, out):
        return self.keep_answers(req, out["status"].tolist(),
                                 (out["iterations"].long() + 1).tolist(), out["x"].T)


ENTRIES = {"refit": Refit, "oneshot": OneShot, "path": Path}
