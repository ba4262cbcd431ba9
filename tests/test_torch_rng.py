"""PyTorch port: the PCG4D counter hash is bit-exact with the JAX package.

Items are random int32 work ids, negative (wrapped) values included; depths
cover scalars, CAMERA_DEPTH and per-lane arrays; column groups cover the
shade group and GROUP_MEDIUM.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheme_raytrace_tpu.core import rng as j_rng
from scheme_raytrace_torch.core import rng as t_rng

N = 4096


def _items(seed=0):
    r = np.random.default_rng(seed)
    items = r.integers(-2 ** 31, 2 ** 31, N, dtype=np.int64).astype(np.int32)
    items[:4] = [0, -1, 2 ** 31 - 1, -2 ** 31]
    return items


def test_stream_constants_equal():
    for name in ("CAMERA_DEPTH", "GROUP_SHADE", "GROUP_MEDIUM", "GROUP_RR"):
        assert getattr(t_rng, name) == getattr(j_rng, name), name


def test_pcg4d_matches_numpy_uint32():
    r = np.random.default_rng(1)
    cols = [r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
            for _ in range(4)]
    got = t_rng._pcg4d(*(torch.from_numpy(c.astype(np.int64)) for c in cols))
    want = j_rng._pcg4d(*(jnp.asarray(c) for c in cols))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


DEPTHS = {
    "zero": lambda: 0,
    "three": lambda: 3,
    "camera": lambda: j_rng.CAMERA_DEPTH,
    "lanes": lambda: np.random.default_rng(2).integers(0, 101, N).astype(np.int32),
}


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("depth", sorted(DEPTHS))
@pytest.mark.parametrize("group_base,ncols", [(0, 12), (0, 5),
                                              (j_rng.GROUP_MEDIUM, 3)])
def test_hash_uniforms_bit_exact(dtype, depth, group_base, ncols):
    items = _items()
    dp = DEPTHS[depth]()
    seed = 0xDEADBEEF if ncols == 5 else 7
    t_dt = torch.float64 if dtype == "f64" else torch.float32
    t_depth = torch.from_numpy(dp) if isinstance(dp, np.ndarray) else dp
    t_tuple = t_rng.hash_uniforms_tuple(seed, torch.from_numpy(items), t_depth,
                                        ncols, t_dt, group_base=group_base)
    t_stack = t_rng.hash_uniforms(seed, torch.from_numpy(items), t_depth,
                                  ncols, t_dt, group_base=group_base)
    if dtype == "f64":
        jax.config.update("jax_enable_x64", True)
    try:
        j_dt = jnp.float64 if dtype == "f64" else jnp.float32
        j_depth = jnp.asarray(dp) if isinstance(dp, np.ndarray) else dp
        j_tuple = j_rng.hash_uniforms_tuple(seed, jnp.asarray(items), j_depth,
                                            ncols, j_dt, group_base=group_base)
        j_stack = j_rng.hash_uniforms(seed, jnp.asarray(items), j_depth,
                                      ncols, j_dt, group_base=group_base)
        j_tuple = [np.asarray(c) for c in j_tuple]
        j_stack = np.asarray(j_stack)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert len(t_tuple) == ncols
    for g, w in zip(t_tuple, j_tuple):
        assert g.dtype == t_dt and w.dtype == g.numpy().dtype
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(t_stack.numpy(), j_stack)
    assert float(t_stack.min()) >= 0.0 and float(t_stack.max()) < 1.0
