"""The check catches a broken program: a run driven on the CPU (the look
for a card skipped) with the timed path broken underneath comes out not
correct, once for each fault its cell can have.  The program's loops are
wrapped where their answer is produced:

* ``state_unchanged``: every step hands back the state it was given, so
  the loop runs to max_iter and ends where it started (x = 0);
* ``half_batch``: a λ-path solves the first half of its lanes and leaves
  the rest at zero, reported solved (the only batch among these cells);
* ``answer_altered``: the largest entry of the answer moved by ``ALTER``
  times the answer's norm, reported solved.

No cell runs on more than one chip, so none can leave out an exchange
between chips."""

import pytest
import torch

from perfbench import harness

# Sizes at which sound runs pass the cells' own limits on the CPU.
SMALL = {"lasso-10000x5000.refit": dict(m=1000, n=500),
         "lasso-10000x5000.oneshot": dict(m=1000, n=500),
         "lasso-10000x5000.path100": dict(m=600, n=300)}
TRAFFIC = {"lasso-10000x5000.path100": {"nlambda": 8}}
SEED = 2 ** 33 + 5
ALTER = 0.25
MAX_ITER = 3        # pogs_tpu_torch.Status.MAX_ITER


def _alter(v):
    v = v.clone()
    j = int(v.abs().argmax())
    v[j] = v[j] + ALTER * v.norm() * torch.sign(v[j])
    return v


def _graph_loop(orig, fault):
    def loop(*args, **kw):
        out = orig(*args, **kw)
        if fault == "state_unchanged":
            out["x12"] = torch.zeros_like(out["x12"])
            out["y12"] = torch.zeros_like(out["y12"])
            out["status"] = torch.full_like(out["status"], MAX_ITER)
        else:
            out["x12"] = _alter(out["x12"])
        return out
    return loop


def _half_batch(orig):
    def solve(A, f, g, g_c_batch=None, *args, **kw):
        K = len(g_c_batch)
        out = orig(A, f, g, g_c_batch[:K // 2], *args, **kw)
        full = {}
        for key, v in out.items():
            pad = torch.zeros((K - K // 2,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
            full[key] = torch.cat([v, pad])
        return full
    return solve


def _break(monkeypatch, cell, fault):
    import pogs_tpu_torch.parallel.batch as batch
    import pogs_tpu_torch.solver.graph as graph

    if fault == "half_batch":
        monkeypatch.setattr(batch, "batched_graph_solve", _half_batch(batch.batched_graph_solve))
    elif cell.endswith("path100"):
        monkeypatch.setattr(batch, "admm_loop", _graph_loop(batch.admm_loop, fault))
    else:
        monkeypatch.setattr(graph, "admm_loop", _graph_loop(graph.admm_loop, fault))


def _run(cell):
    return harness.run_cell(cell, SEED, 0.2, False, device="cpu", overrides=SMALL[cell],
                            traffic_overrides=TRAFFIC.get(cell))["result"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]


CASES = [(c, f) for c in sorted(SMALL) for f in ("state_unchanged", "answer_altered")]
CASES.append(("lasso-10000x5000.path100", "half_batch"))


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_run_is_not_correct(monkeypatch, cell, fault):
    _break(monkeypatch, cell, fault)
    res = _run(cell)
    assert not res["correct"], res["checks"]
    over = {k for k, v in res["checks"].items() if v["value"] > v["limit"]}
    if fault == "state_unchanged":
        assert "unsolved" in over
    else:
        # The program still says SUCCESS: the reference's numbers catch it.
        assert over - {"unsolved", "route"}, res["checks"]
