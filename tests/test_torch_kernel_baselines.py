"""results/kernel_baselines.json, sklearn's metrics for the kernel
baselines on the tabular CLI's six tables (chip_smoke.py phase 14 holds the
card's run to it), re-derived here from the JAX package's wrappers so that
it cannot go stale; and the port's CPU run held to it on the small tables
(the full tables run on the card).

The re-derived metrics must equal the committed ones to REDERIVE_RTOL:
sklearn's libsvm is deterministic, and the GP fits run on one BLAS thread,
as the study writes the file. The GP regression on synthetic interpolates
a noiseless polynomial: its rmse (~2.3e-5) is the rounding of an
ill-conditioned solve, which another CPU's BLAS kernels would move by
~4e-4 of itself, so it is held to the card's tolerance,
kernel_baselines.RMSE_RTOL["gp"].
"""
import copy
import json
import os
import sys

import pytest

pytest.importorskip("sklearn")
pytest.importorskip("threadpoolctl")

from tensornetworksfork_tpu_torch.experiments import kernel_baselines as kb  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REDERIVE_RTOL = 1e-9
SMALL = ("iris", "wine", "breast_cancer", "diabetes")


def _committed():
    with open(os.path.join(ROOT, kb.REFERENCE)) as f:
        return json.load(f)


def test_reference_file_is_current():
    sys.path.insert(0, os.path.join(ROOT, "studies"))
    try:
        import kernel_baselines_ref
    finally:
        sys.path.pop(0)
    fresh = kernel_baselines_ref.reference()
    want = _committed()
    assert fresh["rows"] == want["rows"]
    assert set(fresh["svm"]) == set(kb.TABLES) and set(fresh["gp"]) == set(kb.GP_TABLES)
    for fam in ("svm", "gp"):
        for name, metrics in fresh[fam].items():
            assert metrics.keys() == want[fam][name].keys()
            rtol = (kb.RMSE_RTOL["gp"] if (fam, name) == ("gp", "synthetic")
                    else REDERIVE_RTOL)
            for k, v in metrics.items():
                assert v == pytest.approx(want[fam][name][k], rel=rtol), (fam, name, k)


def test_port_matches_reference_on_small_tables():
    got = {"svm": {t: kb.svm_scores(t, "cpu") for t in SMALL},
           "gp": {t: kb.gp_scores(t, "cpu") for t in SMALL}}
    assert kb.compare(got, _committed()) == []


def test_compare_flags_what_parts():
    want = _committed()
    got = copy.deepcopy({f: {t: want[f][t] for t in SMALL} for f in ("svm", "gp")})
    assert kb.compare(got, want) == []
    n = want["rows"]["iris"]["test"]
    got["svm"]["iris"]["test_accuracy"] -= 1.0 / n       # one row: allowed
    got["svm"]["wine"]["val_accuracy"] -= 2.0 / want["rows"]["wine"]["val"]
    got["gp"]["diabetes"]["test_rmse"] *= 1 + 2 * kb.RMSE_RTOL["gp"]
    bad = {(f, t, k) for f, t, k, _, _ in kb.compare(got, want)}
    assert bad == {("svm", "wine", "val_accuracy"), ("gp", "diabetes", "test_rmse")}
