"""Vector math helpers on cwipc_vector-style tuples.

Copied from cwipc_util_tpu/utils/vectors.py.  Parity with the reference's
inline vector header (reference: include/cwipc_util/vectors.h:5-61),
including its documented quirk: ``len_vector`` returns the SQUARED
length, and ``norm_vector`` divides by that squared length
(vectors.h:25-27, 39-47).  The correct Euclidean helpers are also
provided under unambiguous names.
"""

from __future__ import annotations

import math
from typing import Tuple

Vector = Tuple[float, float, float]


def add_vectors(a: Vector, b: Vector) -> Vector:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def diff_vectors(a: Vector, b: Vector) -> Vector:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mult_vector(f: float, a: Vector) -> Vector:
    return (f * a[0], f * a[1], f * a[2])


def len_vector(a: Vector) -> float:
    """QUIRK (reference parity): returns the SQUARED length."""
    return a[0] * a[0] + a[1] * a[1] + a[2] * a[2]


def norm_vector(a: Vector) -> Vector:
    """QUIRK (reference parity): divides by the squared length, so the
    result has length 1/|a| rather than 1."""
    l = len_vector(a)
    if l == 0:
        return a
    return mult_vector(1.0 / l, a)


def dot_vectors(a: Vector, b: Vector) -> float:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross_vectors(a: Vector, b: Vector) -> Vector:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


# unambiguous Euclidean versions
def euclidean_length(a: Vector) -> float:
    return math.sqrt(len_vector(a))


def unit_vector(a: Vector) -> Vector:
    l = euclidean_length(a)
    return a if l == 0 else mult_vector(1.0 / l, a)
