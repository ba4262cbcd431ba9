"""Op-support probe: the port of tools/probe_pallas_ops.py (K5).

The body of the JAX probe (`kernel`, probe_pallas_ops.py:23-47) on a
(1, 16) float32 pack and an (8, 128) int32 item array, giving (8, 128)
float32: int32 div/mod by constants, a uint32 PCG round, the top 24 bits as
a float32 uniform, a scalar read of the pack, sin/cos/sqrt/pow, and a
select.  Beside it, in the same launch, the operations the textures and the
media added to the bounce kernels, which the JAX probe does not have
(`EXT_ROWS`): floor of a negative float and its int32 conversion, that int32
read as uint32 and hashed (a negative Perlin lattice coordinate), log,
atan2 and rsqrt.  `probe_plain` is the plain PyTorch version (CPU tensors,
and the oracle on the card); `probe_cuda` launches csrc/probe_ops.cu.  Both
return (out, ext): the JAX probe's (8, 128) output, case for case, and the
(5, 8, 128) extension.  On the card:

    python -c "from scheme_raytrace_torch.tools import probe_ops; \\
               print(probe_ops.main())"
"""

from __future__ import annotations

import ctypes

import torch

from ..config import resolve_device
from ..core import rng

NPX = 200 * 200
NX = 200

# The extension's rows.  The first two come from the int path and are exact;
# the others are the card's logf, atan2f and rsqrtf against PyTorch's.
EXT_ROWS = ("floor", "hash_of_negative", "log", "atan2", "rsqrt")

# Launches of the probe_ops kernel in this process.
LAUNCHES = 0


def inputs(device=None):
    """The JAX probe's inputs: pack = arange(16), items = arange(1024), on
    `device` (None: the card, config.resolve_device)."""
    device = resolve_device(device)
    pack = torch.arange(16, dtype=torch.float32, device=device).reshape(1, 16)
    item = torch.arange(8 * 128, dtype=torch.int32,
                        device=device).reshape(8, 128)
    return pack, item


def probe_plain(pack, item):
    """The probe body in plain PyTorch; uint32 values are kept in int64
    masked to 32 bits (core/rng.py)."""
    pix = item % NPX                          # floor rules, as jnp's
    ys = pix // NX
    xs = pix - ys * NX
    m32 = 0xFFFFFFFF
    a = item.to(torch.int64) & m32
    b = (ys + 1).to(torch.int64) & m32
    a = (a * rng._PCG_MULT + rng._PCG_ADD) & m32
    b = (b * rng._PCG_MULT + rng._PCG_ADD) & m32
    a = (a + rng._mul32(b, a)) & m32
    a = a ^ (a >> 16)
    u = (a >> 8).to(torch.float32) * (1.0 / (1 << 24))
    k = pack[0, 3]
    s = torch.sin(u * 6.28) + torch.cos(u) + torch.sqrt(u + 1.0)
    c = torch.pow(u + 0.5, 1.0 / 3.0)
    out = torch.where(u < 0.5, s * k + c, xs.to(torch.float32))
    # the extension: x in [-18.75, 18.75)
    x = (u - 0.5) * 37.5
    fl = torch.floor(x)
    h = fl.to(torch.int32).to(torch.int64) & m32      # int32 bits as uint32
    h = (h * rng._PCG_MULT + rng._PCG_ADD) & m32
    h = h ^ (h >> 16)
    v = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    tiny = torch.finfo(torch.float32).tiny
    ext = torch.stack([
        fl, v, torch.log(torch.maximum(u, u.new_tensor(tiny))),
        torch.atan2(x, u - 0.25), torch.rsqrt(u + 0.25)])
    return out, ext


def _kernel():
    from ..utils import cuda_build
    fn = cuda_build.load("probe_ops").srt_probe_ops
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def probe_cuda(pack, item):
    """`probe_plain` through csrc/probe_ops.cu: pack a contiguous (1, 16)
    float32 and item a contiguous int32 tensor, on one CUDA device.
    Returns (out, ext), new float32 tensors of item's shape and of
    (len(EXT_ROWS), *item's shape); raises if the launch is refused."""
    global LAUNCHES
    dev = item.device
    if dev.type != "cuda" or pack.device != dev:
        raise ValueError(f"probe_cuda takes CUDA tensors, got {dev}")
    if (pack.dtype != torch.float32 or pack.shape != (1, 16)
            or item.dtype != torch.int32 or not pack.is_contiguous()
            or not item.is_contiguous()):
        raise ValueError("probe_cuda: a contiguous (1, 16) float32 pack and "
                         "a contiguous int32 item array")
    out = torch.empty(item.shape, dtype=torch.float32, device=dev)
    ext = torch.empty((len(EXT_ROWS), *item.shape), dtype=torch.float32,
                      device=dev)
    ptrs = (ctypes.c_void_p * 4)(pack.data_ptr(), item.data_ptr(),
                                 out.data_ptr(), ext.data_ptr())
    fn = _kernel()
    with torch.cuda.device(dev):
        err = fn(ptrs, item.numel(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"probe_ops kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, ext


def probe(pack, item):
    """The probe on the tensors' device: the kernel on a card, the plain
    version on the CPU."""
    return (probe_cuda if item.device.type == "cuda" else probe_plain)(
        pack, item)


def main(device=None):
    out, ext = probe(*inputs(device))
    ok = bool(torch.isfinite(out).all() and torch.isfinite(ext).all())
    return f"ok: {ok} {out.flatten()[:4].tolist()}"
