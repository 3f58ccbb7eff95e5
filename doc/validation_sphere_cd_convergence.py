"""Sphere-drag grid-convergence artifact (VERDICT r04 next #8).

Runs the 64^3 Re=100 flow-past-sphere case to t* = 5 on the current
backend and merges it
with the committed 128^3 / 256^3 validation runs
(doc/validation_sphere_re100_drag_128.csv, ..._256_t5.csv - the SAME
fused case at the same coupling constants) into
doc/validation_sphere_cd_convergence.json: Cd at the common times
t* = 2 and t* = 5 per grid.

The pinned convergence test
(tests/test_examples/test_example_smoke.py::
test_sphere_drag_grid_convergence_pinned) asserts on the artifact +
the committed CSVs: monotone decrease with SHRINKING increments toward
the fine-grid value, the 3D analogue of the Lamb-Oseen order sweep
(reference examples-as-convergence-tests posture,
lamb_oseen_vortex.py:136-182).

Run:  python doc/validation_sphere_cd_convergence.py
"""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "examples", "3d"))


def cd_at(times, cds, tq):
    times, cds = np.asarray(times), np.asarray(cds)
    assert times.max() >= tq, (times.max(), tq)
    return float(np.interp(tq, times, cds))


def main():
    from flow_past_sphere import flow_past_sphere_fused_case

    t64, cd64 = flow_past_sphere_fused_case(
        nondim_time=5.05, grid_size=(64, 64, 64), window=100
    )
    np.savetxt(
        os.path.join(REPO, "doc", "validation_sphere_re100_drag_64.csv"),
        np.c_[np.asarray(t64), np.asarray(cd64)],
        delimiter=",",
        header="nondim time, drag coeff (64^3 fused case)",
    )
    out = {"grids": {}, "common_times": [2.0, 5.0]}
    out["grids"]["64"] = {
        "cd_t2": cd_at(t64, cd64, 2.0),
        "cd_t5": cd_at(t64, cd64, 5.0),
    }
    for n, fname in (
        (128, "validation_sphere_re100_drag_128.csv"),
        (256, "validation_sphere_re100_drag_256_t5.csv"),
    ):
        d = np.loadtxt(
            os.path.join(REPO, "doc", fname), delimiter=",", comments="#"
        )
        out["grids"][str(n)] = {
            "cd_t2": cd_at(d[:, 0], d[:, 1], 2.0),
            "cd_t5": cd_at(d[:, 0], d[:, 1], 5.0),
            "source_csv": fname,
        }
    out["note"] = (
        "Cd(t*) of the impulsively-started Re=100 sphere (fused case, "
        "reference constants); long-time steady literature value ~1.09 "
        "(Johnson & Patel 1999 JFM 378: Cd = 1.08-1.10 at Re=100) - the "
        "t*=5 transient sits above it and decays toward it "
        "(the 128^3 run reaches Cd = 1.2238 by t*=10)."
    )
    path = os.path.join(REPO, "doc", "validation_sphere_cd_convergence.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
