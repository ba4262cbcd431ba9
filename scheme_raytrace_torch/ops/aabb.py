"""Axis-aligned bounding boxes: batched slab test + host-side box algebra.

The port of scheme_raytrace_tpu/ops/aabb.py.  The device-side test
(geometry.scm:82-104) is a masked sweep over [N rays, B boxes] tensors;
the host side (geometry.scm:120-136, used by the BVH builders in
scene/bvh.py) is plain numpy, the JAX module's line for line.
"""

from __future__ import annotations

import numpy as np
import torch


def slab_hit(o, d, pmin, pmax, t_min, t_max):
    """Batched slab test (geometry.scm:82-104).

    o, d: [..., 3] rays;  pmin, pmax: [..., 3] boxes (broadcastable).
    Returns the bool mask of boxes whose [entry, exit] overlaps
    (t_min, t_max): max(entry, t_min) < min(exit, t_max).
    """
    inv = 1.0 / d
    ta = (pmin - o) * inv
    tb = (pmax - o) * inv
    lo = torch.minimum(ta, tb)
    hi = torch.maximum(ta, tb)
    entry = torch.clamp(torch.amax(lo, dim=-1), min=t_min)
    exit_ = torch.clamp(torch.amin(hi, dim=-1), max=t_max)
    return entry < exit_


def slab_interval(o, d, pmin, pmax):
    """Line entry/exit t of a box (for constant-medium boundaries).

    Returns (entry, exit) over the full line (may be negative); the
    interval is valid iff entry < exit.
    """
    inv = 1.0 / d
    ta = (pmin - o) * inv
    tb = (pmax - o) * inv
    entry = torch.amax(torch.minimum(ta, tb), dim=-1)
    exit_ = torch.amin(torch.maximum(ta, tb), dim=-1)
    return entry, exit_


# ---------------------------------------------------------------------------
# Host-side (numpy) box algebra for BVH construction
# ---------------------------------------------------------------------------

def surrounding_box(pmin_a, pmax_a, pmin_b, pmax_b):
    """geometry.scm:120-127 — union of two boxes."""
    return np.minimum(pmin_a, pmin_b), np.maximum(pmax_a, pmax_b)


def union_all(pmins, pmaxs):
    """geometry.scm:129-136 — union of a list of boxes (SAH prefix form)."""
    return pmins.min(axis=0), pmaxs.max(axis=0)


def surface_area(pmin, pmax):
    """SAH area term (geometry.scm:316-343 `get-sa`): 2(xy+yz+zx)."""
    d = np.maximum(pmax - pmin, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])
