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
import subprocess
import tempfile
from typing import Sequence

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")


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
