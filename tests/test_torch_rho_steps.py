"""The premise of K1's one-pass route (csrc/fused_admm.cu), on the CPU.

The one pass computes the next iteration's y-side update under the three ρ
steps the balancing can take before it knows which is taken: keep ρ
(z̃ scale 1), ρδ (1/δ) and ρ/δ (δ), with δ known before the pass.  Only a
spectral step that changes ρ falls outside them; the kernel then makes a
plain Aᵀ pass.  Here the eager loop's ``rho_schedule`` (solver/admm.py, the
kernel's plain version) is recorded on lasso and logistic problems and on
one whose ρ reaches its maximum: every applied step outside a spectral
change is one of the three, bit for bit, and the spectral changes (the
kernel's fallbacks on the same problem) are counted.
"""

import numpy as np
import pytest
import torch

import pogs_tpu_torch as P
from pogs_tpu_torch.solver import admm

torch.set_num_threads(1)


def _steps(monkeypatch, A, f, g, dtype, rho0=1.0, max_iter=2500):
    """Solve with the eager loop; return (result, [(k, ρ, δ, ρ', z̃ scale)])
    for the iterations whose step was applied (k < final_iter)."""
    calls = {}
    schedule = admm.rho_schedule

    def recorded(k, rho, delta, *args, **kw):
        out = schedule(k, rho, delta, *args, **kw)
        calls.setdefault(int(k), (rho.clone(), delta.clone(), out[0].clone(), out[1].clone()))
        return out

    monkeypatch.setattr(admm, "rho_schedule", recorded)
    st = P.SolverSettings(max_iter=max_iter, use_fused=False)
    res = P.GraphFormSolver(A, dtype=dtype, device="cpu", settings=st).solve(f, g, rho=rho0)
    final = int(res.final_iter)
    return res, [(k, *calls[k]) for k in sorted(calls) if k < final]


def _classify(steps):
    """The applied steps split into the three candidates and the spectral
    changes; anything else fails."""
    counts = {"keep": 0, "up": 0, "down": 0, "spectral": 0}
    for k, rho, delta, rho_new, scale in steps:
        one = torch.ones_like(delta)
        cands = {"keep": (rho, one), "up": (rho * delta, one / delta),
                 "down": (rho / delta, delta)}
        hit = [name for name, (r, s) in cands.items()
               if torch.equal(rho_new, r) and torch.equal(scale, s)]
        if hit:
            counts[hit[0]] += 1
            continue
        assert k > 0 and k % admm.K_SPEC_FREQ == 0, f"iteration {k}: a step outside the three"
        assert not torch.equal(rho_new, rho) and torch.equal(scale, rho / rho_new)
        counts["spectral"] += 1
    return counts


def _lasso(rng, m, n, dtype):
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    f = P.FunctionVector(P.Function.SQUARE, m, b=b, dtype=dtype)
    g = P.FunctionVector(P.Function.ABS, n, c=0.1 * float(np.max(np.abs(A.T @ b))), dtype=dtype)
    return A, f, g


@pytest.mark.parametrize("case", ["lasso_f32", "lasso_f64", "lasso_rho0_small_f32",
                                  "logistic_f32", "rho_max_f32"])
def test_rho_steps_are_the_one_pass_candidates(case, monkeypatch):
    rng = np.random.default_rng(19)
    dtype, rho0, max_iter = torch.float32, 1.0, 2500
    if case.startswith("lasso"):
        if case == "lasso_f64":
            dtype = torch.float64
        if case == "lasso_rho0_small_f32":
            rho0 = 0.02
        A, f, g = _lasso(rng, 300, 200, dtype)
    elif case == "logistic_f32":
        A = rng.standard_normal((400, 150))
        f = P.FunctionVector(P.Function.LOGISTIC, 400, a=-np.sign(rng.standard_normal(400)))
        g = P.FunctionVector(P.Function.ABS, 150, c=0.2)
    else:
        # An equality-constrained tall system with no exact solution: the
        # primal residual stays large and ρ climbs to its maximum.
        A, b = rng.standard_normal((150, 100)), rng.standard_normal(150)
        f = P.FunctionVector(P.Function.INDEQ0, 150, b=b, dtype=dtype)
        g = P.FunctionVector(P.Function.SQUARE, 100, dtype=dtype)
        max_iter = 600
    res, steps = _steps(monkeypatch, A, f, g, dtype, rho0, max_iter)
    counts = _classify(steps)
    slots = sum(1 for k, *_ in steps if k > 0 and k % admm.K_SPEC_FREQ == 0)
    assert len(steps) == int(res.final_iter) and sum(counts.values()) == len(steps)
    assert counts["spectral"] <= slots
    assert counts["up"] + counts["down"] > 0  # the balancing moved ρ
    if case == "rho_max_f32":
        rho_max = admm.K_RHO_MAX_F32
        assert max(float(s[3]) for s in steps) >= rho_max
        # At its maximum ρ is kept: the up candidate is not taken again.
        top = [s for s in steps if float(s[1]) >= rho_max]
        assert top and all(not torch.equal(s[3], s[1] * s[2]) for s in top)
    else:
        assert int(res.status) == int(P.Status.SUCCESS)
    print(f"{case}: {len(steps)} iterations, ρ steps {counts}, "
          f"the kernel's spectral fallbacks: {counts['spectral']}")
