"""The port's synthetic-convergence tool (``sfmnext_tpu_torch/tools/
synthetic_convergence.py``) runs end to end on the CPU: 2 steps at 64x96
(narrowed through ``SFMNEXT_OPT_OVERRIDES``: num_features 64, model_dim
16, patch 4, 16 queries, 16 bins, float32), without ``--assert``, in the
outdoor and the indoor mode. It evaluates the held-out batch at steps 0
and 2 and reports finite losses and depth metrics. The gate itself (3000
steps, three seeds) runs on the card.
"""

import json

import numpy as np
import pytest

from sfmnext_tpu_torch.tools import synthetic_convergence
from test_torch_models import _one_thread  # noqa: F401

SMALL = {"num_features": 64, "model_dim": 16, "patch_size": 4, "query_nums": 16,
         "dim_out": 16, "compute_dtype": "float32"}


@pytest.mark.parametrize("mode", ["outdoor", "indoor"])
def test_convergence_tool_runs(mode, monkeypatch, capsys):
    monkeypatch.setenv("SFMNEXT_OPT_OVERRIDES", json.dumps(SMALL))
    synthetic_convergence.main(["2", "--height", "64", "--width", "96", "--mode", mode,
                                "--no_cuda"])
    out = capsys.readouterr().out
    recs = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert [r["step"] for r in recs] == [0, 2]
    assert all(np.isfinite([r["loss"], r["abs_rel"], r["rmse"], r["a1"]]).all() for r in recs)
    assert f"[{mode} seed 0] abs_rel" in out
