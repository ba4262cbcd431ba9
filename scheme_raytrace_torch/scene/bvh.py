"""Bounding-volume hierarchies: host-side builders + flat threaded layout.

The port of scheme_raytrace_tpu/scene/bvh.py, in numpy line for line (the
flat arrays equal the JAX package's for the same objects).  The reference
builds closure-tree BVHs at scene load: a random-axis median split
(`make-bvh-node`, geometry.scm:217-260) and a full-sweep surface-area
-heuristic split (`make-bvh-with-sah`, geometry.scm:282-374, cost =
2*T_aabb + (A1*n1 + A2*n2)*T_tri/A_root per geometry.scm:329-333).  Both
builders here emit the same flat threaded array layout: every node
carries a `hit_link` (next node if its AABB is hit) and a `miss_link`
(next node if not), so the device traversal is a stackless loop over an
integer cursor (ops/traverse.py).

Leaves hold up to MAX_LEAF primitive slots (padded with -1) so the leaf
intersection is one fixed-shape vectorized sweep.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..ops.aabb import surface_area
from .. import config as cfg

MAX_LEAF = 4          # primitive slots per leaf node
SENTINEL = -1         # traversal-done cursor


@dataclasses.dataclass
class FlatBVH:
    """Threaded flat BVH over one primitive group (numpy, host-side)."""
    pmin: np.ndarray      # [M,3]
    pmax: np.ndarray      # [M,3]
    hit_link: np.ndarray  # [M] next node when AABB hit (first child / skip)
    miss_link: np.ndarray # [M] next node when AABB missed (subtree skip)
    prims: np.ndarray     # [M,MAX_LEAF] prim ids, -1 padded (-1 row: inner)

    @property
    def n_nodes(self) -> int:
        return self.pmin.shape[0]


class _Node:
    __slots__ = ("pmin", "pmax", "left", "right", "prim_ids",
                 "_idx", "_hit", "_miss")

    def __init__(self, pmin, pmax, left=None, right=None, prim_ids=None):
        self.pmin, self.pmax = pmin, pmax
        self.left, self.right = left, right
        self.prim_ids = prim_ids


def _leaf(ids, pmins, pmaxs) -> _Node:
    return _Node(pmins[ids].min(0), pmaxs[ids].max(0), prim_ids=list(ids))


def build_median(pmins: np.ndarray, pmaxs: np.ndarray,
                 seed: int = 0) -> FlatBVH:
    """Random-axis median-split BVH (geometry.scm:217-260).

    The reference sorts by box-min on a random axis (geometry.scm:227-230,
    box-compare :262-270) and recurses on the median; n=1 duplicates the
    leaf into both children (B10) — here n<=MAX_LEAF simply becomes a leaf,
    which is the same tree without the duplicate test.
    """
    rng = np.random.default_rng(seed)

    def rec(ids: np.ndarray) -> _Node:
        if len(ids) <= MAX_LEAF:
            return _leaf(ids, pmins, pmaxs)
        axis = rng.integers(0, 3)                    # geometry.scm:227
        order = ids[np.argsort(pmins[ids, axis], kind="stable")]
        mid = len(order) // 2
        left, right = rec(order[:mid]), rec(order[mid:])
        return _Node(np.minimum(left.pmin, right.pmin),
                     np.maximum(left.pmax, right.pmax), left, right)

    return _flatten(rec(np.arange(len(pmins))))


def build_sah(pmins: np.ndarray, pmaxs: np.ndarray) -> FlatBVH:
    """Full-sweep SAH BVH (geometry.scm:282-374).

    For each axis: sort by box center (box-center-compare :272-280), build
    prefix/suffix surface-area arrays (s1sa/s2sa :313-343), pick the split
    minimizing 2*T_aabb + (A1*n1 + A2*n2)*T_tri/A_root (:329-333); if no
    split beats the leaf cost n*T_tri, make a leaf (:344-351).
    """
    t_tri, t_aabb = cfg.SAH_T_TRI, cfg.SAH_T_AABB
    centers = 0.5 * (pmins + pmaxs)

    def rec(ids: np.ndarray) -> _Node:
        n = len(ids)
        if n <= 1:
            return _leaf(ids, pmins, pmaxs)
        root_sa = max(surface_area(pmins[ids].min(0), pmaxs[ids].max(0)),
                      1e-30)
        best = (n * t_tri, None, None)               # leaf cost baseline
        for axis in range(3):
            order = ids[np.argsort(centers[ids, axis], kind="stable")]
            # prefix/suffix box unions -> surface areas
            pre_min = np.minimum.accumulate(pmins[order], 0)
            pre_max = np.maximum.accumulate(pmaxs[order], 0)
            suf_min = np.minimum.accumulate(pmins[order][::-1], 0)[::-1]
            suf_max = np.maximum.accumulate(pmaxs[order][::-1], 0)[::-1]
            k = np.arange(1, n)
            cost = (2.0 * t_aabb
                    + (surface_area(pre_min[:-1], pre_max[:-1]) * k
                       + surface_area(suf_min[1:], suf_max[1:]) * (n - k))
                    * t_tri / root_sa)
            i = int(np.argmin(cost))
            if cost[i] < best[0]:
                best = (cost[i], order[:i + 1], order[i + 1:])
        if best[1] is None and n > MAX_LEAF:
            # SAH says leaf-is-cheapest but the flat layout caps leaves at
            # MAX_LEAF slots (the reference's closure leaf holds the whole
            # list, geometry.scm:344-351) — median-split on the widest axis.
            ext = pmaxs[ids].max(0) - pmins[ids].min(0)
            order = ids[np.argsort(centers[ids, int(np.argmax(ext))],
                                   kind="stable")]
            best = (0.0, order[:n // 2], order[n // 2:])
        if best[1] is None or len(ids) <= MAX_LEAF:
            return _leaf(ids, pmins, pmaxs)
        left, right = rec(best[1]), rec(best[2])
        return _Node(np.minimum(left.pmin, right.pmin),
                     np.maximum(left.pmax, right.pmax), left, right)

    return _flatten(rec(np.arange(len(pmins))))


def _flatten(root: _Node) -> FlatBVH:
    """Depth-first preorder layout with hit/miss threading.

    hit_link[i]: node to visit after i when i's AABB is hit — the first
    child for inner nodes, the miss_link for leaves (prims are tested in
    place).  miss_link[i]: node after skipping i's subtree — preorder makes
    this the next right-sibling-or-ancestor's-sibling.
    """
    nodes: List[_Node] = []

    def assign(node: _Node, next_after: int) -> int:
        """Returns this node's index; next_after = miss target."""
        idx = len(nodes)
        nodes.append(node)
        node._idx = idx          # type: ignore[attr-defined]
        node._miss = next_after  # type: ignore[attr-defined]
        if node.prim_ids is None:
            # left child's miss target is the right child; right child's is
            # next_after.  Recurse left first (preorder).
            left_idx = assign(node.left, SENTINEL)   # patch after right known
            right_idx = assign(node.right, next_after)
            # patch the whole left subtree's escapes that pointed at SENTINEL
            _patch(node.left, SENTINEL, right_idx)
            node._hit = left_idx  # type: ignore[attr-defined]
        else:
            node._hit = next_after  # type: ignore[attr-defined]
        return idx

    def _patch(node: _Node, old: int, new: int):
        if node._miss == old:                       # type: ignore
            node._miss = new                        # type: ignore
        if node.prim_ids is not None:
            if node._hit == old:                    # type: ignore
                node._hit = new                     # type: ignore
            return
        _patch(node.left, old, new)
        _patch(node.right, old, new)

    assign(root, SENTINEL)

    m = len(nodes)
    pmin = np.stack([n.pmin for n in nodes])
    pmax = np.stack([n.pmax for n in nodes])
    hit_link = np.array([n._hit for n in nodes], np.int32)   # type: ignore
    miss_link = np.array([n._miss for n in nodes], np.int32) # type: ignore
    prims = np.full((m, MAX_LEAF), -1, np.int32)
    for i, n in enumerate(nodes):
        if n.prim_ids is not None:
            assert len(n.prim_ids) <= MAX_LEAF
            prims[i, :len(n.prim_ids)] = n.prim_ids
    return FlatBVH(pmin, pmax, hit_link, miss_link, prims)


def sphere_bounds(c0: np.ndarray, c1: np.ndarray,
                  r: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """AABBs of (possibly moving) spheres over the full time range
    (geometry.scm:172-174, :195-214: union of t0/t1 boxes)."""
    ra = np.abs(r)[:, None]
    pmin = np.minimum(c0 - ra, c1 - ra)
    pmax = np.maximum(c0 + ra, c1 + ra)
    return pmin, pmax


def rect_bounds(axis, k, a0, a1, b0, b1, rot, trans
                ) -> Tuple[np.ndarray, np.ndarray]:
    """World AABBs of (possibly rotated/translated) axis rects.

    The reference pads the plane axis by RECT_PAD (geometry.scm:391,410,429)
    and computes the rotated box's world bounds over the corners
    (geometry.scm:499-522, with bug B2 fixed).  Corners of the object-space
    rect map through rot/trans; padding is applied on all axes after the
    transform (conservative and simpler than transforming the pad)."""
    nrect = len(axis)
    pmin = np.zeros((nrect, 3))
    pmax = np.zeros((nrect, 3))
    for i in range(nrect):
        ax = int(axis[i])
        ia, ib = (1, 2) if ax == 0 else ((0, 2) if ax == 1 else (0, 1))
        corners = []
        for pa in (a0[i], a1[i]):
            for pb in (b0[i], b1[i]):
                c = np.zeros(3)
                c[ax] = k[i]
                c[ia] = pa
                c[ib] = pb
                corners.append(rot[i] @ c + trans[i])
        corners = np.asarray(corners)
        pmin[i] = corners.min(0) - cfg.RECT_PAD
        pmax[i] = corners.max(0) + cfg.RECT_PAD
    return pmin, pmax
