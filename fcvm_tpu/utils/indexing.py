"""Dof-vector padding for gather/scatter alignment.

Every dof vector in the solver is padded to a multiple of 384 = 3 * 128, so
``nn_pad = ndof/3`` stays integral and node vectors have a length that is a
multiple of 128 (``ndof = 3 * nn`` is generically odd).  The value was
chosen for an accelerator whose dynamic gathers and scatter-adds slowed
sharply on unaligned vector lengths; whether 384 still pays on the H100 is
an open measurement.  Padding dofs carry ``fixmask = 0`` and zero loads, so
they behave as decoupled identity rows of ``K_hat`` on any device.
"""

from __future__ import annotations

import numpy as np

DOF_ALIGN = 384


def pad_ndof(ndof: int) -> int:
    return -(-ndof // DOF_ALIGN) * DOF_ALIGN


def pad_vector(v: np.ndarray, ndof_pad: int, fill=0.0) -> np.ndarray:
    out = np.full(ndof_pad, fill, dtype=v.dtype)
    out[: len(v)] = v
    return out
