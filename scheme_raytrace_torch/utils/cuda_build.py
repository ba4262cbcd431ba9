"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each kernel source is compiled by nvcc into a shared library with a plain C
interface and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v [-DSRT_<FEATURE>=1 ...]
         -o <lib>.so csrc/<name>.cu

No --use_fast_math: the kernels keep IEEE division and square root and the
full-accuracy sin/cos, so the tolerances against the plain PyTorch versions
stay at rounding level.

A kernel is built per feature set: the groups a plan may lack (FEATURES) are
compile-time flags of csrc/bounce_common.cuh, one -D macro each, so a
variant holds the code, registers and shared memory of the groups its plan
has and of no other.  `load(name, features)` builds the variant at first
use from the sources in csrc/ and nothing else.  Libraries go to
<repo>/build/kernels/ (listed in .gitignore), named
<name>-<features>-<hash>.so: the hash covers every csrc/ source, the flags
(the feature macros among them) and the nvcc version, so an edit rebuilds
and an unchanged tree reuses its libraries.  nvcc's output (with ptxas's
register and spill counts) and the build's seconds are kept beside each
library as <lib>.log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# The compile-time feature flags of the bounce kernels, in the order a
# variant's name lists them: flag -> the macro csrc/bounce_common.cuh reads.
# "klein" is reserved for the klein group's slice; no source reads it yet.
FEATURES = {"spheres": "SRT_SPHERES", "moving": "SRT_MOVING",
            "perlin": "SRT_PERLIN", "image": "SRT_IMAGE",
            "media": "SRT_MEDIA", "bezier": "SRT_BEZIER",
            "klein": "SRT_KLEIN"}

# variant name -> {"lib": CDLL, "path": str, "built": bool, "log": str,
# "seconds": float}; filled by load()
LOADED: dict = {}


def normalise(features) -> tuple:
    """A feature set as a tuple in FEATURES' order, each flag once."""
    features = set(features)
    unknown = features - set(FEATURES)
    if unknown:
        raise ValueError(f"unknown kernel features {sorted(unknown)}; "
                         f"known: {', '.join(FEATURES)}")
    return tuple(f for f in FEATURES if f in features)


def variant_name(name: str, features=()) -> str:
    """The name of one kernel's variant for one feature set, which is the
    library's file name before its hash: equal feature sets, in any order,
    give one name, and the empty set gives <name>-base."""
    features = normalise(features)
    return f"{name}-{'+'.join(features) if features else 'base'}"


def feature_flags(features=()) -> list:
    """nvcc's -D flags of a feature set."""
    return [f"-D{FEATURES[f]}=1" for f in normalise(features)]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME): nvcc is "
                           "needed to build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def resources(log: str) -> list:
    """ptxas's resource lines of a build log, one dict a compiled kernel
    entry: its mangled name, registers, spilled bytes (stores, loads),
    stack and static shared memory."""
    out = []
    entry, first_frame = None, False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = dict(entry=m.group(1), registers=None, spill_stores=0,
                         spill_loads=0, stack=0, smem=0)
            out.append(entry)
            first_frame = True
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and first_frame:          # the entry's own, not a callee's
            entry["stack"], entry["spill_stores"], entry["spill_loads"] = (
                int(x) for x in m.groups())
            first_frame = False
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            entry["smem"] = int(s.group(1)) if s else 0
            entry = None
    return out


def load(name: str, features=()) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu for one feature set, compiling
    it if needed.  A failed build raises; there is no other variant to fall
    back on."""
    features = normalise(features)
    key = variant_name(name, features)
    if key in LOADED:
        return LOADED[key]["lib"]
    nvcc = _nvcc()
    version = subprocess.run([nvcc, "--version"], check=True,
                             capture_output=True, text=True).stdout
    flags = NVCC_FLAGS + feature_flags(features)
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(version.encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"{key}-{h.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".log")
    built = not lib_path.exists()
    seconds = 0.0
    if built:
        # compile to a private name, then rename: concurrent builders of
        # the same source never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc, *flags, "-o", tmp, str(CSRC / f"{name}.cu")],
                capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log_path.write_text(
                f"{' '.join(flags)}\nbuilt in {seconds:.1f} s\n"
                + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                                   f"[{'+'.join(features) or 'base'}] "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    LOADED[key] = dict(
        lib=lib, path=str(lib_path), built=built, seconds=seconds,
        log=log_path.read_text() if log_path.exists() else "")
    return lib
