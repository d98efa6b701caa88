"""The harness driven end to end on the CPU at small sizes (the look for a
card skipped): the result line's keys and metrics, and the modules a run
holds."""

import subprocess
import sys

import pytest

from perfbench import harness

SMALL = {"lasso-10000x5000.refit": dict(m=400, n=200),
         "lasso-10000x5000.oneshot": dict(m=400, n=200),
         "lasso-10000x5000.path100": dict(m=300, n=150)}
# The CPU's eager loops are slow under the profiler: a shorter path.
TRAFFIC = {"lasso-10000x5000.path100": {"nlambda": 8}}
SEED = 2 ** 32 + 99


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cpu_dry_run(cell, traced):
    out = harness.run_cell(cell, SEED, 0.2, traced, device="cpu", overrides=SMALL[cell],
                           traffic_overrides=TRAFFIC.get(cell))
    res = out["result"]
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["attempted"] >= 1 and res["failed"] == 0
    c = harness.load_cell(cell)
    if traced:
        assert set(res["metrics"]) <= {m["name"] for m in c.per_layer}
        assert any(k.split(".")[0] == "iters_per_solve" for k in res["metrics"])
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert len(res["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
    for m in res["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]
    assert out["lines"][-1].startswith("check ")
    assert res["checks"]["unsolved"] == {"value": 0, "limit": 0}


def test_no_card_no_result():
    """run.py on a machine without a card exits non-zero and prints no result."""
    p = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                        "lasso-10000x5000.refit", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=120,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert p.returncode != 0 and not p.stdout.strip()


def test_a_run_holds_no_jax():
    """After a dry run of every cell's imports and calls in a fresh process,
    no module's top-level name is jax, jaxlib, flax or pogs_tpu."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench import harness, control\n"
            "for cell, ov in %r.items():\n"
            "    harness.run_cell(cell, 5, 0.05, True, device='cpu', overrides=ov,\n"
            "                     traffic_overrides=%r.get(cell))\n"
            "print(','.join(sorted({k.split('.')[0] for k in sys.modules})))\n"
            % (str(harness.ROOT), SMALL, TRAFFIC))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=str(harness.ROOT))
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(p.stdout.strip().splitlines()[-1].split(","))
    assert "pogs_tpu_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "pogs_tpu"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_card_run_takes_its_route(card, cell):
    """On the card each cell's calls go through the kernel its route names
    (a path only streams beyond L2, so it runs at its own size)."""
    ov = {"lasso-10000x5000.path100": {}}.get(cell, dict(m=1000, n=500))
    res = harness.run_cell(cell, SEED, 2.0, False, device=card, overrides=ov)["result"]
    assert res["checks"]["route"] == {"value": 0, "limit": 0}
    assert res["correct"], res["checks"]
