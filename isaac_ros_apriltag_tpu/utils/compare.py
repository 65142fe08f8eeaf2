"""Detection comparisons at the reference's tolerances (BASELINE.md)."""

from __future__ import annotations

import jax
import numpy as np

# (corner px, translation m, quaternion): backends-compare, ref
# backends_compare_test.py:165-167 with the tighter 0.1 px corner bound
# held between this repo's own backends.
BACKENDS_COMPARE = (0.1, 0.01, 0.01)


def frame(det, b: int):
    """Frame `b` of a batched Detections, as host arrays."""
    return jax.tree.map(lambda x: np.asarray(x)[b], det)


def rows(det) -> dict:
    """{id: (corners, center, translation, quaternion)} of the valid rows of
    one frame."""
    valid, ids = np.asarray(det.valid), np.asarray(det.id)
    corners, center = np.asarray(det.corners), np.asarray(det.center)
    t, q = np.asarray(det.translation), np.asarray(det.quaternion)
    return {int(ids[i]): (corners[i], center[i], t[i], q[i])
            for i in np.flatnonzero(valid)}


def q_err(qa, qb) -> float:
    """Quaternion difference up to sign (q and -q are one rotation)."""
    return float(min(np.abs(qa - qb).max(), np.abs(qa + qb).max()))


def detection_errors(a, b):
    """Match two frames' detections by id: (same ids, max corner px,
    max translation m, max quaternion error). Errors are inf when the ids
    differ."""
    ra, rb = rows(a), rows(b)
    if sorted(ra) != sorted(rb):
        return False, float("inf"), float("inf"), float("inf")
    ec = max([float(np.abs(ra[i][0] - rb[i][0]).max()) for i in ra] or [0.0])
    et = max([float(np.abs(ra[i][2] - rb[i][2]).max()) for i in ra] or [0.0])
    eq = max([q_err(ra[i][3], rb[i][3]) for i in ra] or [0.0])
    return True, ec, et, eq


def within(errors, tol=BACKENDS_COMPARE) -> bool:
    same, ec, et, eq = errors
    return same and ec <= tol[0] and et <= tol[1] and eq <= tol[2]
