"""Conjugate-Gradient Least Squares with shift, as an eager torch loop.

Solves   minimize ‖A x − b‖² + shift ‖x‖²   from a warm start x0.

Counterpart of ``pogs_tpu/linalg/cgls.py``, with the same recurrences
(convergence when ‖s‖ ≤ tol·‖s₀‖ or tol·‖x‖ ≥ 1, s = Aᵀr − shift·x) and the
same safeguards for the float32 noise floor: the best iterate by gradient
norm is tracked and returned, and the loop exits on divergence (‖s‖ grows
4x past the best seen) or on a stall (no improvement for 50 iterations).

No host sync per iteration: the state freezes once ``done`` is set
(``torch.where``), and the host reads ``done`` (with the count) every
``CHECK_EVERY`` iterations, so the result is that of a loop that stopped the
moment ``done`` was set.  ``cgls_solve.iterations`` counts the iterations
the solves needed, ``cgls_solve.steps`` those they ran, frozen ones
included, and ``cgls_solve.exits`` how many solves ended on each guard
(``EXITS``).
"""

from __future__ import annotations

from typing import Callable

import torch

from pogs_tpu_torch.linalg.matrix import side_sums

# How often the host reads the device-side done flag.
CHECK_EVERY = 2
STALL_WINDOW = 50
DIV_FACTOR = 4.0
# Why a solve ended, by the code its state carries in "why".
EXITS = ("max_iter", "converged", "diverged", "stalled")


def run_frozen(body, state: dict, max_iter: int, check_every: int, counter) -> dict:
    """Run ``body`` on ``state`` up to ``max_iter`` times, freezing every
    field (a tensor or a tuple of them) once ``state["done"]`` is set, and
    reading done and the count ``k`` on the host every ``check_every``
    iterations and at the end.  Adds the count to ``counter.iterations``,
    the iterations run to ``counter.steps`` and, where the state carries an
    exit code ``why``, one to ``counter.exits[EXITS[why]]``."""
    def keep(done, old, new):
        if isinstance(new, tuple):
            return tuple(torch.where(done, o, v) for o, v in zip(old, new))
        return torch.where(done, old, new)

    for it in range(max_iter):
        new = body(state)
        done = state["done"]
        state = {key: keep(done, state[key], val) for key, val in new.items()}
        if (it + 1) % check_every == 0 or it == max_iter - 1:
            keys = ("done", "k", "why") if "why" in state else ("done", "k")
            flag, k, *why = torch.stack([state[key].to(torch.int64) for key in keys]).tolist()
            if flag or it == max_iter - 1:
                counter.iterations += k
                counter.steps += it + 1
                if why:
                    counter.exits[EXITS[why[0]]] += 1
                break
    return state


def cgls_solve(matvec: Callable, rmatvec: Callable, b, x0, shift, tol, max_iter: int = 500,
               A=None):
    """Returns (x, iterations); ``iterations`` is a device tensor.

    ``A``, a sharded operator whose products ``matvec`` / ``rmatvec`` are,
    sums the dots and norms of its split side through its ``reduce``: b and
    the residual are y-side, x and the gradient x-side."""
    dt, dev = b.dtype, b.device
    shift = torch.as_tensor(shift, dtype=dt, device=dev)
    tol = torch.as_tensor(tol, dtype=dt, device=dev)
    eps = torch.finfo(dt).eps

    r = b - matvec(x0)
    s = rmatvec(r) - shift * x0
    norms0, = side_sums(A, "n", [("norm", s)])
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def body(st):
        x, r, p, gamma, k = st["x"], st["r"], st["p"], st["gamma"], st["k"]
        q = matvec(p)
        qq, = side_sums(A, "m", [("dot", q, q)])
        pp, = side_sums(A, "n", [("dot", p, p)])
        delta = qq + shift * pp
        delta = torch.where(delta <= 0, torch.full_like(delta, eps), delta)
        alpha = gamma / delta
        x = x + alpha * p
        r = r - alpha * q
        s = rmatvec(r) - shift * x
        gamma_new, x_norm = side_sums(A, "n", [("dot", s, s), ("norm", x)])
        p = s + (gamma_new / gamma) * p
        norms = torch.sqrt(gamma_new)
        improved = norms < st["norms_best"]
        x_best = torch.where(improved, x, st["x_best"])
        k_best = torch.where(improved, k, st["k_best"])
        norms_best = torch.minimum(norms, st["norms_best"])
        converged = (norms <= norms0 * tol) | (x_norm * tol >= 1.0)
        diverged = norms > DIV_FACTOR * norms_best
        stalled = (k - k_best) >= STALL_WINDOW
        why = torch.where(converged, 1, torch.where(diverged, 2, torch.where(stalled, 3, 0)))
        return {"x": x, "r": r, "p": p, "gamma": gamma_new, "k": k + 1,
                "done": converged | diverged | stalled, "why": why.to(torch.int32),
                "x_best": x_best, "norms_best": norms_best, "k_best": k_best}

    st = {"x": x0, "r": r, "p": s, "gamma": norms0 * norms0, "k": zero,
          "done": norms0 < eps, "why": (norms0 < eps).to(torch.int32),
          "x_best": x0, "norms_best": norms0, "k_best": zero}
    if max_iter > 0:
        st = run_frozen(body, st, max_iter, CHECK_EVERY, cgls_solve)
    return st["x_best"], st["k"]


cgls_solve.iterations = 0
cgls_solve.steps = 0
cgls_solve.exits = dict.fromkeys(EXITS, 0)
