"""The BASELINE parity goldens, computed by the port's f64 CPU oracle.

The port of tools/make_goldens.py, through the port's parity.py: for each
of the six BASELINE configs, the f64 CPU image of its forward render
(`render_parity_image`) and its probe gradients by f64 central finite
differences and f64 autodiff (`probe_gradients`) on the small workload,
and by f64 autodiff on the big one.  It asserts FD == AD in f64 (relative
difference under 0.02) before it writes anything, as the JAX tool does,
and records the achieved FD-against-AD error in each npz, whose keys are
the JAX tool's.  It writes `<name>.npz` into the directory `--out` names
(required; the committed tests/goldens/ are the JAX package's and are not
rewritten here).  `--grads-only` refreshes the gradient fields of the npz
files already in that directory.

    python -m scheme_raytrace_torch.tools.make_goldens --out DIR \
        [--only NAME] [--grads-only]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .. import parity

F64 = torch.float64


def make(pc, out_dir, grads_only=False):
    """One config's golden into out_dir; returns the failure's text, or
    None once written."""
    print(f"[{pc.name}] probing {len(pc.probes)} gradients "
          "(f64 FD+AD small, AD big)...", flush=True)
    fd = parity.probe_gradients(pc, F64, "fd", device="cpu")
    ad = parity.probe_gradients(pc, F64, "ad", device="cpu")
    err = np.abs(fd - ad) / np.maximum(np.maximum(np.abs(fd), np.abs(ad)),
                                       1e-6)
    print(f"[{pc.name}] fd={fd} ad={ad} rel_err={err}", flush=True)
    if not (err < 0.02).all():
        return (f"{pc.name}: f64 FD vs AD disagree (rel {err}) — probe "
                "crosses a discrete event; pick a different probe/eps")
    ad_big = parity.probe_gradients(pc, F64, "ad", big=True, device="cpu")
    print(f"[{pc.name}] ad_big={ad_big}", flush=True)
    path = os.path.join(out_dir, f"{pc.name}.npz")
    if grads_only:
        if not os.path.exists(path):
            return f"{pc.name}: --grads-only but {path} missing"
        old = dict(np.load(path, allow_pickle=False))
        old.update(grad_fd=fd, grad_ad=ad, fd_ad_rel_err=err,
                   grad_ad_big=ad_big)
        np.savez_compressed(path, **old)
        print(f"[{pc.name}] refreshed gradient fields in {path}", flush=True)
        return None

    print(f"[{pc.name}] rendering f64 oracle image "
          f"({pc.config.nx}x{pc.config.ny}, {pc.config.spp} spp)...",
          flush=True)
    img = parity.render_parity_image(pc, F64, device="cpu")
    assert np.isfinite(img).all(), f"{pc.name}: non-finite oracle image"
    np.savez_compressed(
        path, image=img, grad_fd=fd, grad_ad=ad, fd_ad_rel_err=err,
        grad_ad_big=ad_big,
        probes=np.array([f"{p.leaf}{list(p.index)}" for p in pc.probes]),
        nominal=np.array(pc.nominal))
    print(f"[{pc.name}] wrote {path}", flush=True)
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="directory the npz files are written into")
    ap.add_argument("--only", default=None, help="one config's name")
    ap.add_argument("--grads-only", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for pc in parity.PARITY_CONFIGS:
        if args.only is not None and pc.name != args.only:
            continue
        failure = make(pc, args.out, args.grads_only)
        if failure:
            failures.append(failure)
    if failures:
        sys.exit("FAILED:\n" + "\n".join(failures))


if __name__ == "__main__":
    main()
