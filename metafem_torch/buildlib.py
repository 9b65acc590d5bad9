"""Build a C/C++/CUDA source into a plain-C shared library, once per
source content.

The library lands in ``metafem_torch/_build/`` (listed in ``.gitignore``)
under a name that carries a hash of the source and the compile command,
so an edited source is rebuilt at its next use and an unchanged one is
loaded as it is.  The compiler writes to a temporary name first and the
result is renamed into place, so concurrent processes never load a
half-written library.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Sequence

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
#: the port's CUDA sources live here
CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
#: nvcc flags of every hand-written kernel: Hopper (sm_90a), plain-C
#: shared library
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def build_shared(src: str, name: str, command: Sequence[str]) -> str:
    """Compile ``src`` with ``command + [src, "-o", out]`` unless a library
    built from the same source and command exists; return its path.
    Raises ``subprocess.CalledProcessError`` (with the compiler's output)
    when the build fails."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(command).encode())
    so_path = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(list(command) + [src, "-o", tmp], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so_path


def nvcc() -> str:
    """Path of nvcc (PATH, then the toolkit's default place)."""
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built")
    return path


def build_cuda(name: str) -> str:
    """Build ``csrc/<name>.cu`` for sm_90a (once per source content) and
    return the library's path."""
    return build_shared(os.path.join(CSRC_DIR, name + ".cu"), name,
                        [nvcc(), *NVCC_FLAGS])
