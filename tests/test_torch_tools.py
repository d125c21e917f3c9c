"""The port's measurement scripts, at a tiny size on the CPU."""

import math

import pytest
import torch

from katib_tpu_torch.tools import route_divergence as rd

TINY = dict(vocab_size=64, embed_dim=32, num_layers=1, num_heads=2, seq_len=16, batch_size=2)


def test_one_ulp_up_moves_the_bf16_value_by_one_unit():
    w = torch.tensor([[0.0123, 1.0], [-3.7, 2.0]])
    for row in range(2):
        before = w[row, 0].to(torch.bfloat16)
        rd._one_ulp_up(torch, w, row)
        after = w[row, 0].to(torch.bfloat16)
        assert float(after) == float(w[row, 0])  # lands on a bf16 value
        assert float(after) - float(before) == 2.0 ** (math.floor(math.log2(abs(float(before)))) - 7)
    assert float(w[0, 1]) == 1.0 and float(w[1, 1]) == 2.0


def test_route_divergence_on_the_cpu():
    """On the CPU both designs take the plain versions, so their curves are
    identical; each perturbation moves the curve; the summary has a line per
    learning rate and one over every cell."""
    lrs = [1e-2]
    rows = rd.run_seed(torch, TINY, 0, lrs, 10, device="cpu")
    assert [r["lr"] for r in rows] == lrs
    for r in rows:
        assert set(r["curves"]) == set(rd.RUNS)
        assert all(len(c) == 10 and all(math.isfinite(x) for x in c) for c in r["curves"].values())
        assert r["curves"]["sm90"] == r["curves"]["mma"] and r["routes"] == 0.0
        assert all(r[run] > 0 for run in rd.RUNS[2:])
        assert r["gate"]["sm90"] == (r["curves"]["sm90"][9] < r["curves"]["sm90"][4])
        assert "seed 0" in rd.row_line(r)
    lines = rd.summary(rows, lrs)
    assert len(lines) == len(lrs) + 1 and lines[-1].startswith("all 1 cells")


def test_route_divergence_needs_the_last_report():
    with pytest.raises(SystemExit):
        rd.main(["--steps", "9"])
