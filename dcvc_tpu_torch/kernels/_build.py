"""Build a CUDA source of `csrc/` into a shared library with nvcc at first
use and load it with ctypes.

The library lands in `dcvc_tpu_torch/_build/` (listed in .gitignore),
named after the content hash of the source and the csrc/ headers it
includes, so an edited source or header rebuilds and an unchanged one is
built once per checkout.  Target: sm_90a (Hopper).  A build with
preprocessor defines (`defines=("K2_CLOCKS",)`) is a separate library,
named after its defines as well.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def sources(source):
    """csrc/<source> and the csrc/ headers it includes ("..." includes,
    followed through the headers), in the order first met."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        with open(os.path.join(CSRC, name)) as f:
            todo += re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(),
                               re.MULTILINE)
    return seen


def library_path(source, defines=()):
    """Path of the built library for csrc/<source> at the current content
    of it and of every header it includes, compiled with `defines`."""
    digest = hashlib.sha256()
    for name in sources(source):
        digest.update(name.encode() + b"\0")
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f.read())
    stem = "-".join([os.path.splitext(source)[0]]
                    + [d.lower() for d in defines])
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def load_library(source, defines=()):
    """Build csrc/<source> (with `-D` for each of `defines`) if needed and
    return the loaded ctypes.CDLL.  The compiler's resource report
    (-Xptxas -v) is kept beside the library as <name>.log."""
    lib = library_path(source, defines)
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", *(f"-D{d}" for d in defines), "-o", tmp,
               os.path.join(CSRC, source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{res.stderr}")
        with open(os.path.splitext(lib)[0] + ".log", "w") as f:
            f.write(res.stderr)
        os.replace(tmp, lib)
    return ctypes.CDLL(lib)
