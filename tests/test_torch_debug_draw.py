"""PyTorch port: the debug rasterizers (utils/debug_draw.py; main.scm:575-608)
against the JAX package's (CPU).

Both draws give the JAX draw's image.  The curve's points go through the
port's ops/bezier in float32 as JAX's go through its own.  A point that
floors to another pixel in the two packages must lie within 1e-6 (relative)
of a pixel edge; such points' pixels are left out of the comparison and
counted (none, on these curves: the points are bitwise JAX's).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheme_raytrace_tpu.ops import bezier as j_bz
from scheme_raytrace_tpu.utils import debug_draw as j_draw
from scheme_raytrace_torch.ops import bezier as t_bz
from scheme_raytrace_torch.utils import debug_draw

# the reference's *bez* test curve (main.scm:575-581), frame-scale coords
CP = np.array([[10, 10, 0], [30, 100, 0], [160, 180, 0], [180, 100, 0]],
              float)
EDGE = 1e-6


def _same_image(got, want, pt, pj):
    """got == want but at the pixels of points (x, y) that floor apart in
    the two packages, which must sit at a pixel edge; returns their count."""
    ft, fj = np.floor(pt).astype(int), np.floor(pj).astype(int)
    apart = (ft != fj).any(axis=1)
    edge = np.abs(pt - np.round(pt)) <= EDGE * np.maximum(1.0, np.abs(pt))
    assert edge[apart].any(axis=1).all()
    mask = np.ones(got.shape[:2], bool)
    for x, y in np.concatenate([ft[apart], fj[apart]]):
        if 0 <= y < mask.shape[0] and 0 <= x < mask.shape[1]:
            mask[y, x] = False
    np.testing.assert_array_equal(got[mask], want[mask])
    return int(apart.sum())


@pytest.mark.parametrize("size", [200, 32])
def test_draw_bezier_equals_jax(size):
    t = np.arange(0.0, 1.0, 0.01)
    pt, pj = debug_draw._eval_np(CP, t), j_draw._eval_np(CP, t)
    got = debug_draw.draw_bezier(np.zeros((size, size, 3), np.uint8), CP)
    want = j_draw.draw_bezier(np.zeros((size, size, 3), np.uint8), CP)
    assert want.max() == 255
    assert _same_image(got, want, size / 2 + pt[:, :2],
                       size / 2 + pj[:, :2]) == 0


@pytest.mark.parametrize("t", [0.0, 0.3, 0.75])
def test_draw_tan_vec_equals_jax(t):
    got = debug_draw.draw_tan_vec(np.zeros((200, 200, 3), np.uint8), CP, t,
                                  length=30.0)
    want = j_draw.draw_tan_vec(np.zeros((200, 200, 3), np.uint8), CP, t,
                               length=30.0)
    assert want[..., 1].max() == 255
    s = np.arange(0.0, 30.0, 0.1)[:, None]
    tt = torch.tensor(CP, dtype=torch.float32)[None]
    ts = torch.tensor([[t]], dtype=torch.float32)
    pt = (t_bz.eval_bezier(tt, ts)[0, 0].numpy()
          + s * t_bz.tangent(tt, ts)[0, 0].numpy())
    jc, js = jnp.asarray(CP, jnp.float32)[None], jnp.asarray([[t]],
                                                            jnp.float32)
    pj = (np.asarray(j_bz.eval_bezier(jc, js))[0, 0]
          + s * np.asarray(j_bz.tangent(jc, js))[0, 0])
    assert _same_image(got, want, pt[:, :2], pj[:, :2]) == 0
