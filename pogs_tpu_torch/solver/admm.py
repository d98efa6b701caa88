"""Graph-form ADMM core loop as an eager torch loop.

Counterpart of ``pogs_tpu/solver/admm.py``; the same algorithm and
constants (the reference's pogs.cpp):

  * over-relaxation α = 1.7 (1.0 in exact-tol mode);
  * approximate residuals ‖A‖‖Δx‖+‖Δy‖, replaced by the exact residuals
    (two more matvecs) when within 10× of tolerance;
  * adaptive ρ: spectral update every 50 iterations with a clamped
    √imbalance ratio, residual balancing otherwise; ρ changes rescale z̃;
  * the residual-tied projection tolerance ladder;
  * exact-tol mode: residuals in the original (unscaled) space;
  * optional Anderson acceleration of the (z, z̃) pair (``use_anderson``),
    its history reset on every ρ rescale;
  * the monotone done latch, and converged / NaN latched at the firing
    iteration.

No host sync per iteration: the done flag stays on the device and is read
every ``DONE_CHECK_EVERY`` iterations.  Once ``done`` is set, every field of
the state freezes (``torch.where(done, old, new)``), so iterations run past
``done`` change nothing and the result equals that of a loop that stopped
the moment ``done`` was set.  For the same reason both residual branches
are evaluated and the right one is selected, instead of branching on the
device flag.

This loop is also the plain version of the fused solve kernel
(``ops/fused_admm.py``).

On a sharded operator (``parallel/mesh.py``) the state stays split as x and
y, each rank holding its part of the split side, and every norm and dot of
an iteration on that side is one stacked partial sum through the operator's
``reduce``: the prox point's (‖ym‖², ‖y12‖², ym·y12) are taken at the end of
the iteration with the residuals', so an iteration makes one small
all-reduce beside the two vector ones of its products (the projection's and
the exact dual residual's).  Every branch the host takes (``done``) is read
from values already reduced, so all ranks stop at the same iteration.
"""

from __future__ import annotations

from typing import Callable

import torch

from pogs_tpu_torch.types import SolverSettings, Status
from pogs_tpu_torch.linalg.matrix import local_shape, matvecs, side_sums
from pogs_tpu_torch.solver.anderson import anderson_init, anderson_step

# Adaptive-rho / over-relaxation constants (pogs.cpp:94-110).  The CUDA solve
# kernel (csrc/fused_admm.cu) carries the same numbers; keep them in sync.
K_DELTA_MIN = 1.05
K_GAMMA = 1.01
K_TAU = 0.8
K_RHO_MIN = 1e-4
K_RHO_MAX = 1e4
# f32 needs tighter rho bounds (see the JAX package's admm.py).
K_RHO_MIN_F32 = 1e-2
K_RHO_MAX_F32 = 1e2
K_KAPPA = 0.9
K_SPEC_FREQ = 50
K_SPEC_CHANGE_MIN = 0.67
K_SPEC_CHANGE_MAX = 1.5
K_SPEC_IMB_THRESH = 10.0
K_SPEC_MIN_DELTA = 0.05

# How often the host reads the device-side done flag.
DONE_CHECK_EVERY = 10


def _keep(done, old, new):
    """``torch.where(done, old, new)`` over a tensor or a tuple of them."""
    if isinstance(new, tuple):
        return type(new)(*(_keep(done, o, v) for o, v in zip(old, new)))
    return torch.where(done, old, new)


def rho_schedule_constants(dt, dev, exact_mode: bool = False) -> dict:
    """The constants of :func:`rho_schedule` for a dtype and mode, made once:
    a tensor made from a Python number inside the loop is a host-to-device
    copy per iteration."""
    f32 = dt == torch.float32
    return {
        "rho_min": K_RHO_MIN_F32 if f32 else K_RHO_MIN,
        "rho_max": K_RHO_MAX_F32 if f32 else K_RHO_MAX,
        "freq": 10 if exact_mode else K_SPEC_FREQ,
        "change_min": 0.5 if exact_mode else K_SPEC_CHANGE_MIN,
        "change_max": 2.0 if exact_mode else K_SPEC_CHANGE_MAX,
        "imb_thresh": torch.as_tensor(5.0 if exact_mode else K_SPEC_IMB_THRESH,
                                      dtype=dt, device=dev),
        "one": torch.ones((), dtype=dt, device=dev),
        "delta_min": torch.as_tensor(K_DELTA_MIN, dtype=dt, device=dev),
    }


def rho_schedule(k, rho, delta, xi, kd, ku, nrm_r, nrm_s, eps_pri, eps_dua, *,
                 rho_min, rho_max, freq, change_min, change_max, imb_thresh, one,
                 delta_min):
    """One step of the adaptive-ρ schedule (pogs.cpp:401-466): a spectral
    update every ``freq`` iterations when the residuals are out of balance,
    residual balancing otherwise.  Elementwise, so it serves one solve or a
    batch of lanes ((K, 1) tensors) alike.  Returns the new
    (ρ, z̃ scale, δ, ξ, kd, ku)."""
    pri_n = nrm_r / eps_pri
    dua_n = nrm_s / eps_dua
    spec_slot = (k > 0) & (k % freq == 0) & (eps_pri > 0) & (eps_dua > 0)
    safe_dua = torch.where(dua_n == 0, torch.ones_like(dua_n), dua_n)
    imb = pri_n / safe_dua
    spec_cond = ((pri_n > 0) & (dua_n > 0)
                 & ((imb > imb_thresh) | (imb < one / imb_thresh)))
    rho_ratio = torch.clamp(torch.sqrt(imb), change_min, change_max)
    rho_spec = torch.clamp(rho * rho_ratio, rho_min, rho_max)
    spec_apply = (spec_slot & spec_cond
                  & (torch.abs(rho_spec - rho) / rho > K_SPEC_MIN_DELTA))

    kf = k.to(rho.dtype)
    bal_slot = ~spec_slot
    s_small = nrm_s < xi * eps_dua
    r_small = nrm_r < xi * eps_pri
    bal_up = bal_slot & s_small & ~r_small & (K_TAU * kf > kd)
    bal_dn = bal_slot & ~s_small & r_small & (K_TAU * kf > ku) & ~bal_up
    bal_both = bal_slot & s_small & r_small & ~bal_up & ~bal_dn
    bal_else = bal_slot & ~bal_up & ~bal_dn & ~bal_both
    up_apply = bal_up & (rho < rho_max)
    dn_apply = bal_dn & (rho > rho_min)

    rho_new = torch.where(
        spec_apply, rho_spec,
        torch.where(up_apply, rho * delta,
                    torch.where(dn_apply, rho / delta, rho)))
    zt_scale = torch.where(
        spec_apply, rho / rho_spec,
        torch.where(up_apply, one / delta,
                    torch.where(dn_apply, delta, one)))
    delta_new = torch.where(
        up_apply | dn_apply, K_GAMMA * delta,
        torch.where(bal_else, delta_min, delta))
    xi_new = torch.where(bal_both, xi * K_KAPPA, xi)
    ku_new = torch.where(up_apply, kf, ku)
    kd_new = torch.where(dn_apply, kf, kd)
    return rho_new, zt_scale, delta_new, xi_new, kd_new, ku_new


def admm_loop(
    A,
    norm_A,
    d,
    e,
    prox_fn: Callable,      # (x_in, y_in, rho) -> (x12, y12)   [scaled objective]
    eval_fn: Callable,      # (x12, y12) -> optval              [scaled objective]
    project_fn: Callable,   # (x0, y0, tol, x_warm) -> (x, y)
    settings: SolverSettings,
    z0,
    zt0,
    rho0,
):
    """Run the scaled-space ADMM iteration.

    ``z0``/``zt0`` use the packed [x; y] warm-start convention (this rank's
    parts on a sharded operator).  Returns a dict of scaled-space results
    plus diagnostics, as the JAX ``admm_loop``.
    """
    m, n = A.shape
    m_loc, n_loc = local_shape(A)
    dt, dev = A.dtype, A.device
    amv, armv = matvecs(A)
    exact_mode = settings.use_exact_tol

    def T(v):
        return torch.as_tensor(v, dtype=dt, device=dev)

    alpha = T(1.0 if exact_mode else 1.7)
    one = T(1.0)
    abs_tol = T(settings.abs_tol)
    rel_tol = T(settings.rel_tol)
    sqrtn_atol = torch.sqrt(T(n)) * abs_tol
    sqrtm_atol = torch.sqrt(T(m)) * abs_tol
    sqrtmn_atol = torch.sqrt(T(m + n)) * abs_tol
    proj_tol_max = T(1e-10 if exact_mode else 1e-8)
    proj_tol_min = T(1e-3 if exact_mode else 1e-2)
    proj_pow = T(1.0 if exact_mode else 0.5)
    max_iter = settings.max_iter
    norm_A = T(norm_A)
    sched = rho_schedule_constants(dt, dev, exact_mode)
    # Anderson's packed state [x; y; x̃; ỹ]: which entries lie on the split
    # side, for the sums of its Gram.
    aa_split = None
    side = getattr(A, "sharded_side", None)
    if settings.use_anderson and side is not None:
        on_m = torch.zeros(n_loc + m_loc, dtype=torch.bool, device=dev)
        on_m[n_loc:] = True
        mask = torch.cat([on_m, on_m]) if side == "m" else ~torch.cat([on_m, on_m])
        aa_split = (mask, A.reduce)

    def body(st):
        xprev, yprev = st["x"], st["y"]
        rho = st["rho"]

        xin = st["x"] - st["xt"]
        yin = st["y"] - st["yt"]
        x12, y12 = prox_fn(xin, yin, rho)

        xm = xin - x12
        ym = yin - y12

        x_or = st["xt"] + alpha * x12 + (one - alpha) * xprev
        y_or = st["yt"] + alpha * y12 + (one - alpha) * yprev

        proj_tol = proj_tol_min * torch.pow(torch.minimum(st["prev_nrm_r"], one), proj_pow)
        proj_tol = torch.maximum(torch.minimum(proj_tol, abs_tol), proj_tol_max)
        x_new, y_new = project_fn(x_or, y_or, proj_tol, xprev)

        # Exact residuals (pogs.cpp:310-336), selected when near tolerance.
        r_vec = amv(x12) - y12
        s_vec = armv(y12 + st["yt"] - yprev) + (x12 + st["xt"] - xprev)
        # Every sum of the iteration, one stacked partial sum per side (one
        # reduce where the side is split).
        x_terms = [("sum2", xm), ("sum2", x12), ("dot", xm, x12), ("norm", xm),
                   ("norm", xprev - x_new), ("norm", x12 - x_new), ("sum", x_new)]
        y_terms = [("sum2", ym), ("sum2", y12), ("dot", ym, y12),
                   ("norm", yprev - y_new), ("norm", y12 - y_new), ("sum", y_new)]
        if exact_mode:
            dm = torch.where(d == 0, torch.ones_like(d), d)
            r_o = torch.where(d == 0, torch.zeros_like(r_vec), r_vec / dm)
            y_o = torch.where(d == 0, torch.zeros_like(y12), y12 / dm)
            ax_o = torch.where(d == 0, torch.zeros_like(r_vec), (r_vec + y12) / dm)
            em = torch.where(e == 0, torch.ones_like(e), e)
            s_o = torch.where(e == 0, torch.zeros_like(s_vec), s_vec / em)
            x_terms += [("norm", s_o), ("norm", x12 * e)]
            y_terms += [("norm", r_o), ("norm", ax_o), ("norm", y_o)]
        else:
            x_terms += [("norm", s_vec)]
            y_terms += [("norm", r_vec)]
        xs = side_sums(A, "n", x_terms)
        ys = side_sums(A, "m", y_terms)
        xm2, x12_2, xm_x12, nrm_xm, dx_prev, dx_12, sum_x = xs[:7]
        ym2, y12_2, ym_y12, dy_prev, dy_12, sum_y = ys[:6]

        gap = torch.abs(xm_x12 + ym_y12)
        eps_gap = sqrtmn_atol + rel_tol * (
            torch.sqrt(xm2 + ym2) * torch.sqrt(x12_2 + y12_2))
        eps_pri = sqrtm_atol + rel_tol * torch.sqrt(y12_2)
        eps_dua = rho * (sqrtn_atol + rel_tol * nrm_xm)

        # Approximate residuals (pogs.cpp:299-308).
        nrm_s_a = rho * (norm_A * dy_prev + dx_prev)
        nrm_r_a = norm_A * dx_12 + dy_12

        if exact_mode:
            near = torch.ones((), dtype=torch.bool, device=dev)
            nrm_s_o, nrm_xe = xs[7:]
            nrm_r_o, nrm_ax_o, nrm_y_o = ys[6:]
            nrm_r = nrm_r_o
            nrm_s = rho * nrm_s_o
            eps_pri = sqrtm_atol + rel_tol * torch.maximum(nrm_ax_o, nrm_y_o)
            eps_dua = rho * (sqrtn_atol + rel_tol * nrm_xe)
        else:
            near = (nrm_r_a < 10 * eps_pri) & (nrm_s_a < 10 * eps_dua)
            nrm_r = torch.where(near, ys[6], nrm_r_a)
            nrm_s = torch.where(near, rho * xs[7], nrm_s_a)

        converged = near & (nrm_r < eps_pri) & (nrm_s < eps_dua)
        if settings.gap_stop:
            converged = converged & (gap < eps_gap)
        nan_found = ~(torch.isfinite(nrm_r) & torch.isfinite(sum_x)
                      & torch.isfinite(sum_y))
        done = st["done"] | converged | nan_found | (st["k"] >= max_iter - 1)

        if settings.verbose > 1:
            stride = 10 if settings.verbose > 2 else 100
            if int(st["k"]) % stride == 0 or bool(converged):
                print(f"{int(st['k']):5d} : {float(nrm_r):.2e}  {float(eps_pri):.2e}  "
                      f"{float(nrm_s):.2e}  {float(eps_dua):.2e}  {float(gap):.2e}  "
                      f"{float(eps_gap):.2e}  {float(eval_fn(x12, y12)):.2e}")

        # Dual update (pogs.cpp:396-399).
        xt_new = st["xt"] + alpha * x12 + (one - alpha) * xprev - x_new
        yt_new = st["yt"] + alpha * y12 + (one - alpha) * yprev - y_new

        rho_new, delta_new, xi_new, kd_new, ku_new = (
            rho, st["delta"], st["xi"], st["kd"], st["ku"])
        rho_rescaled = None
        if settings.adaptive_rho:
            rho_new, zt_scale, delta_new, xi_new, kd_new, ku_new = rho_schedule(
                st["k"], rho, st["delta"], st["xi"], st["kd"], st["ku"],
                nrm_r, nrm_s, eps_pri, eps_dua, **sched)
            xt_new = xt_new * zt_scale
            yt_new = yt_new * zt_scale
            rho_rescaled = zt_scale != one

        # Anderson acceleration on the (z, z̃) pair; its history is dropped
        # whenever ρ rescales z̃.
        if settings.use_anderson:
            s_prev = torch.cat([xprev, yprev, st["xt"], st["yt"]])
            s_vec = torch.cat([x_new, y_new, xt_new, yt_new])
            s_acc, aa = anderson_step(st["aa"], s_prev, s_vec, split=aa_split)
            if rho_rescaled is not None:
                aa = aa._replace(k=torch.where(rho_rescaled, torch.zeros_like(aa.k), aa.k))
            use_aa = (st["k"] >= settings.anderson_start) & ~done
            n1, m1 = n_loc, m_loc
            x_new = torch.where(use_aa, s_acc[:n1], x_new)
            y_new = torch.where(use_aa, s_acc[n1:n1 + m1], y_new)
            xt_new = torch.where(use_aa, s_acc[n1 + m1:2 * n1 + m1], xt_new)
            yt_new = torch.where(use_aa, s_acc[2 * n1 + m1:], yt_new)

        # Freeze post-convergence state (the reference breaks before the
        # dual/rho updates, pogs.cpp:391-394).
        def sel(new, old):
            return torch.where(done, old, new)

        new = {
            "x": x_new, "y": y_new,
            "xt": sel(xt_new, st["xt"]), "yt": sel(yt_new, st["yt"]),
            "x12": x12, "y12": y12, "xprev": xprev, "yprev": yprev,
            "rho": sel(rho_new, rho),
            "delta": sel(delta_new, st["delta"]), "xi": sel(xi_new, st["xi"]),
            "kd": sel(kd_new, st["kd"]), "ku": sel(ku_new, st["ku"]),
            "k": torch.where(done, st["k"], st["k"] + 1),
            "done": done,
            "converged": torch.where(st["done"], st["converged"], converged),
            "nan_found": torch.where(st["done"], st["nan_found"], nan_found),
            "nrm_r": nrm_r, "nrm_s": nrm_s, "gap": gap,
            "eps_pri": eps_pri, "eps_dua": eps_dua, "eps_gap": eps_gap,
            "prev_nrm_r": sel(nrm_r, st["prev_nrm_r"]),
        }
        if settings.use_anderson:
            new["aa"] = aa
        return new

    z0 = T(z0)
    zt0 = T(zt0)
    zero = T(0.0)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    st = {
        "x": z0[:n_loc], "y": z0[n_loc:], "xt": zt0[:n_loc], "yt": zt0[n_loc:],
        "x12": torch.zeros(n_loc, dtype=dt, device=dev),
        "y12": torch.zeros(m_loc, dtype=dt, device=dev),
        "xprev": torch.zeros(n_loc, dtype=dt, device=dev),
        "yprev": torch.zeros(m_loc, dtype=dt, device=dev),
        "rho": T(rho0), "delta": T(K_DELTA_MIN), "xi": T(1.0),
        "kd": zero, "ku": zero,
        "k": torch.zeros((), dtype=torch.int32, device=dev),
        "done": false, "converged": false, "nan_found": false,
        "nrm_r": zero, "nrm_s": zero, "gap": zero,
        "eps_pri": zero, "eps_dua": zero, "eps_gap": zero,
        "prev_nrm_r": T(torch.finfo(dt).max),
    }
    if settings.use_anderson:
        st["aa"] = anderson_init(2 * (m_loc + n_loc), settings.anderson_mem, dt, dev)

    for it in range(max_iter):
        new = body(st)
        was_done = st["done"]
        st = {key: _keep(was_done, st[key], val) for key, val in new.items()}
        if (it + 1) % DONE_CHECK_EVERY == 0 and bool(st["done"]):
            break

    # Outputs (scaled space), pogs.cpp:472-518.
    optval = eval_fn(st["x12"], st["y12"])
    mu_scaled = -st["rho"] * (st["xt"] - st["xprev"] + st["x12"])
    nu_scaled = -st["rho"] * (st["yt"] - st["yprev"] + st["y12"])
    status = torch.where(
        st["converged"], Status.SUCCESS.value,
        torch.where(st["nan_found"], Status.NAN_FOUND.value, Status.MAX_ITER.value),
    ).to(torch.int32)

    return {
        "x12": st["x12"],
        "y12": st["y12"],
        "mu_scaled": mu_scaled,
        "nu_scaled": nu_scaled,
        "optval": optval,
        "final_iter": st["k"],
        "status": status,
        "rho": st["rho"],
        "nrm_r": st["nrm_r"],
        "nrm_s": st["nrm_s"],
        "gap": st["gap"],
        "eps_pri": st["eps_pri"],
        "eps_dua": st["eps_dua"],
        # The last complete iterate, for implicit warm starts (pogs.cpp:573).
        "z": torch.cat([st["xprev"], st["yprev"]]),
        "zt": torch.cat([st["xt"], st["yt"]]),
    }


def postsolve_verify(A, d, e, x12, y12, status, abs_tol, rel_tol):
    """Exact-tol post-solve verification (pogs.cpp:520-564): recompute the
    primal residual in the original space and downgrade SUCCESS → MAX_ITER
    if it misses tolerance. x12/y12 are *scaled*."""
    m = A.shape[0]
    dt = A.dtype
    sqrtm_atol = torch.sqrt(torch.tensor(float(m), dtype=dt)) * abs_tol
    dm = torch.where(d == 0, torch.ones_like(d), d)
    ax_orig = matvecs(A)[0](x12) / dm
    y_orig = y12 / dm
    res, nrm_ax, nrm_y = side_sums(A, "m", [("norm", ax_orig - y_orig), ("norm", ax_orig),
                                           ("norm", y_orig)])
    eps = sqrtm_atol.to(A.device) + rel_tol * torch.maximum(nrm_ax, nrm_y)
    bad = (status == Status.SUCCESS.value) & (res > eps)
    return torch.where(bad, Status.MAX_ITER.value, status).to(torch.int32)
