"""PyTorch port: the strided pools' framebuffer flush (CPU).

`pool_strided.Framebuffer` adds a block of staged rows in (iteration, lane)
order with one writer per float add.  Where m divides n_pix that is one
`index_add_` a row.  Elsewhere, g = gcd(m, n_pix) < m and up to m / g lanes
of a row finish the same pixel: the flush ranks each pixel's paths over the
block and adds them in min(spp, T m / g) rounds.  Its yardstick is the
group-wise add it replaced, kept here as `GroupFramebuffer`: one
`index_add_` a row and lane group [q g, (q + 1) g), whose lanes never share
a pixel.

  * On blocks staged as the strided queue stages them (lane L holds items
    L, L + m, ...; a path ends with probability 0.3 an iteration; pixel
    item % n_pix), at 20 x 20 with m = 1,664 (g = 16), at 200 x 200 (the
    default frame) with spp 1, 2 and 16 (the pool sizes of the default
    pool_rays: m = 40,064, 65,536, 65,536; g = 64; spp 16 in f32 only, the
    persistent pool's dtype), at 8 x 8 with m = 128 (g = 64) and at
    16 x 16 with m = 128 (g = m), in f32 and f64, the
    image is bitwise the group-wise add's: in place, out of place, and
    with int32 pixels (the persistent pool's flush rows).
  * Out of place under autograd, the radiance rows' gradient is bitwise the
    group-wise add's.
  * The adds a block issues, counted by a dispatch mode: T `index_add`
    and no sort where g = m; otherwise `rounds(T)` = min(spp, T m / g)
    masked adds, at most min(spp, m / g) a row, no `index_add`, and no
    host sync.
  * The pools: at 20 x 20 spp4 with m = 1,664 (g = 16) on Cornell, f32,
    the strided (drain and static form), packed and persistent images are
    bitwise the same pools' with the group-wise add, bitwise each other,
    and the FIFO pool's within rtol = atol = 1e-5 (tests/test_torch_pools.py's
    rule: only the grouping of the adds differs).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from scheme_raytrace_torch import scenes as t_scenes
from scheme_raytrace_torch.config import RenderConfig
from scheme_raytrace_torch.integrator import persist, pool_fused, \
    pool_packed, pool_strided
from scheme_raytrace_torch.scene import build

T = pool_strided.FLUSH_EVERY


class GroupFramebuffer:
    """The group-wise flush: one index_add a row and lane group."""

    def __init__(self, raw0, m, spp=None):
        self.n_pix = n_pix = raw0.shape[0]
        self.raw3 = torch.cat([raw0.T, raw0.new_zeros(3, m)], dim=1)
        self.spill = n_pix + torch.arange(m, device=raw0.device)
        g = math.gcd(m, n_pix)
        self.groups = [slice(s, s + g) for s in range(0, m, g)]

    def add(self, pix, vals, inplace=True):
        for p, v in zip(pix, vals):
            dest = torch.where(p >= 0, p.to(torch.int64), self.spill)
            for g in self.groups:
                if inplace:
                    self.raw3.index_add_(1, dest[g], v[:, g])
                else:
                    self.raw3 = self.raw3.index_add(1, dest[g], v[:, g])

    def image(self):
        return self.raw3[:, :self.n_pix].T.contiguous()


def _blocks(n_pix, spp, m, seed, dtype, rows=T):
    """Blocks (pix [rows, m], vals [rows, 3, m]) of the staged rows of a
    drained strided queue."""
    gen = torch.Generator().manual_seed(seed)
    n_work = n_pix * spp
    item = torch.arange(m)
    out = []
    while bool((item < n_work).any()):
        pix, vals = [], []
        for _ in range(rows):
            done = (item < n_work) & (torch.rand(m, generator=gen) < 0.3)
            pix.append(torch.where(done, item % n_pix, -1))
            vals.append(torch.rand(3, m, generator=gen, dtype=dtype))
            item = torch.where(done, item + m, item)
        out.append((torch.stack(pix), torch.stack(vals)))
    return out


# (n_pix, spp, m): g = gcd(m, n_pix)
CASES = {"20x20-g16": (400, 4, 1664),
         "200x200-spp1-g64": (40_000, 1, 40_064),
         "200x200-spp2-g64": (40_000, 2, 65_536),
         "200x200-spp16-g64": (40_000, 16, 65_536),
         "8x8-g64": (64, 2, 128),
         "16x16-g=m": (256, 2, 128)}


def test_cases_cover_the_pools():
    for name in ("20x20-g16", "200x200-spp1-g64", "200x200-spp2-g64",
                 "200x200-spp16-g64"):
        n_pix, spp, m = CASES[name]
        cfg = RenderConfig(nx=int(n_pix ** 0.5), ny=int(n_pix ** 0.5),
                           spp=spp)
        assert pool_strided.pool_size(cfg, n_pix * spp) == m, name
    assert math.gcd(65_536, 40_000) == 64


@pytest.mark.parametrize("case,dtype", [
    (c, d) for c in sorted(CASES) for d in ("f32", "f64")
    if (c, d) != ("200x200-spp16-g64", "f64")])   # the pools' dtype alone
def test_flush_bitwise_group_add(case, dtype):
    n_pix, spp, m = CASES[case]
    dtype = torch.float64 if dtype == "f64" else torch.float32
    raw0 = torch.rand(n_pix, 3, generator=torch.Generator().manual_seed(1),
                      dtype=dtype)
    blocks = _blocks(n_pix, spp, m, 0, dtype)
    want = GroupFramebuffer(raw0, m)
    for pix, vals in blocks:
        want.add(pix, vals)
    want = want.image()
    fbs = [pool_strided.Framebuffer(raw0, m, spp) for _ in range(3)]
    for pix, vals in blocks:
        fbs[0].add(pix, vals)
        fbs[1].add(pix, vals, inplace=False)
        fbs[2].add(pix.to(torch.int32), vals)
    for fb in fbs:
        assert torch.equal(fb.image(), want)
    assert not torch.equal(want, raw0)


def test_flush_grad_bitwise_group_add():
    n_pix, spp, m = CASES["20x20-g16"]
    raw0 = torch.rand(n_pix, 3, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(2))
    weight = torch.rand(n_pix, 3, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(3))
    grads = []
    for cls in (GroupFramebuffer, pool_strided.Framebuffer):
        blocks = _blocks(n_pix, spp, m, 0, torch.float64)
        leaves = [v.requires_grad_() for _, v in blocks]
        fb = cls(raw0, m, spp)
        for pix, vals in blocks:
            fb.add(pix, vals, inplace=False)
        grads.append(torch.autograd.grad((fb.image() * weight).sum(), leaves))
    for g, w in zip(*grads):
        assert torch.equal(g, w)


class _Ops(TorchDispatchMode):
    """Counts the aten ops run under it, by name."""

    def __init__(self):
        super().__init__()
        self.count = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.count[name] = self.count.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", sorted(CASES))
def test_flush_adds_per_block(case):
    n_pix, spp, m = CASES[case]
    share = m // math.gcd(m, n_pix)
    raw0 = torch.zeros(n_pix, 3)
    for rows in (T, persist.CHUNK_T):
        pix, vals = _blocks(n_pix, spp, m, 0, torch.float32, rows)[0]
        fb = pool_strided.Framebuffer(raw0, m, spp)
        with _Ops() as ops:
            fb.add(pix, vals)
        c = ops.count
        if share == 1:
            assert fb.rounds(rows) == rows
            assert c.get("index_add", 0) + c.get("index_add_", 0) == rows
            assert "sort" not in c
        else:
            assert fb.rounds(rows) == min(spp, rows * share)
            assert fb.rounds(rows) <= rows * min(spp, share)
            assert c["where"] == 1 + fb.rounds(rows)   # the keys, the rounds
            assert "sort" in c
            assert c.get("index_add", 0) + c.get("index_add_", 0) == 0
        # no host sync: nothing is read back
        assert not {"item", "_local_scalar_dense", "nonzero"} & set(c)


@pytest.fixture(scope="module")
def cornell():
    spec = t_scenes.cornell_box()
    return (build.compile_scene(spec.objects, sky=spec.sky, device="cpu"),
            spec.camera(aspect=1.0, device="cpu"))


POOLS = {"strided": pool_strided.render_pool_strided,
         "packed": pool_packed.render_pool_packed,
         "persistent": persist.render_pool_persistent}


def test_pools_bitwise_group_add(cornell, monkeypatch):
    scene, cam = cornell
    cfg = RenderConfig(nx=20, ny=20, spp=4, max_depth=6, light_sampling=True)
    assert pool_strided.pool_size(cfg, 1600) == 1664
    raw0 = torch.rand(cfg.n_pixels, 3,
                      generator=torch.Generator().manual_seed(0))
    got = {k: fn(scene, cam, cfg, raw0, 2) for k, fn in POOLS.items()}
    raw, segs, iters = got["strided"]
    got["static"] = pool_strided.render_pool_strided(
        scene, cam, cfg, raw0, 2, static_iters=iters)
    for mod in (pool_strided, pool_packed, persist):
        monkeypatch.setattr(mod, "Framebuffer", GroupFramebuffer)
    want = {k: fn(scene, cam, cfg, raw0, 2) for k, fn in POOLS.items()}
    want["static"] = pool_strided.render_pool_strided(
        scene, cam, cfg, raw0, 2, static_iters=iters)
    for k in got:
        assert torch.equal(got[k][0], want[k][0]), k
        assert int(got[k][1]) == int(want[k][1]) == int(segs), k
        assert torch.equal(got[k][0], raw), k
    assert int(got["static"][2]) == 0
    fifo, f_segs, _ = pool_fused.render_pool_fused(scene, cam, cfg, raw0, 2)
    assert int(f_segs) == int(segs)
    np.testing.assert_allclose(raw.numpy(), fifo.numpy(), rtol=1e-5,
                               atol=1e-5)
