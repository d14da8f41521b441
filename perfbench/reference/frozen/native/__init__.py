"""Host-side C++ components (the record store's reader, the image codec),
built with g++ on first use and bound with ctypes.

`lib_path(name)` compiles `native/<name>.cpp` into
`build/perfbench/host/lib<name>-<digest>.so` at the repository root and returns
the path. The digest is of the source and the flags, so an edit rebuilds;
the object is written under a temporary name and renamed, so processes that
build at the same time never load a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "perfbench" / "host"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def lib_path(name: str) -> str:
    src = SRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *FLAGS, str(src), "-o", tmp], check=True,
                           capture_output=True, text=True)
            os.replace(tmp, out)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"g++ failed to build {src}:\n{e.stderr}") from e
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return str(out)
