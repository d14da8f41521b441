"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source is compiled by its own `nvcc` process, all started together,
for `sm_90a` with a plain C interface; the objects are linked into one
shared library that `ctypes` loads. The library's name carries a hash of
the sources and flags, so an edit rebuilds. The build happens on first
use, never at import, into `build/torch_kernels/` at the repository root,
under a file lock, so ranks that start together compile it once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("blend.cu", "blend_bwd.cu", "facegather.cu", "facegather_bwd.cu", "meshraster.cu",
           "blend_bf16.cu", "blend_resident.cu", "blend_stream.cu", "gather_rows.cu",
           "blend_probe.cu", "dma_bench.cu", "stream_sum.cu", "copy_probe.cu", "resize.cu")
# included by the sources; part of the build's digest
HEADERS = ("blend_common.cuh", "blend_subtile.cuh", "blend_subtile_fwd.cuh", "blend_bf16_rows.cuh",
           "async_copy.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# per-source additions: the z-buffer must round as its plain version does
# (no fused multiply-add), or a shared edge changes owner
SOURCE_FLAGS = {"meshraster.cu": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: (argtypes); each returns the launch's cudaError_t
SIGNATURES = {
    # rows, order, ranges, bg, color, invdepth, final_T, height, width, tile, stream
    "guava_blend_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # table, ids, out, n, stream
    "guava_face_gather": (_P, _P, _P, _I, _P),
    # &ctas, &smem_bytes: resident CTAs an SM of K2
    "guava_face_gather_occupancy": (_P, _P),
    # rows, order, ranges, bg, color, invdepth, final_T, g_color, g_invdepth, d_rows,
    # height, width, tile, stream
    "guava_blend_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # tile, &ctas, &smem_bytes: resident CTAs an SM of K1, K3, K7, K6 and K8,
    # and the dynamic shared memory of a CTA; K1p's with its stage's rows
    # (tile, stage_rows, &ctas, &smem_bytes)
    "guava_blend_fwd_occupancy": (_I, _P, _P),
    "guava_blend_bwd_occupancy": (_I, _P, _P),
    "guava_blend_resident_occupancy": (_I, _P, _P),
    "guava_blend_bf16_occupancy": (_I, _P, _P),
    "guava_blend_stream_occupancy": (_I, _P, _P),
    "guava_blend_probe_occupancy": (_I, _I, _P, _P),
    # drows, ids, seg, carry, d_table, n, n_faces, stream
    "guava_face_gather_bwd": (_P, _P, _P, _P, _P, _I, _I, _P),
    # tris, inst_fid, ranges, best, depth, first, cont, n_inst, height, width, tile, stream
    "guava_mesh_zbuffer": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # tile, &ctas, &smem_bytes: resident CTAs an SM of K5's segment kernel
    "guava_mesh_zbuffer_occupancy": (_I, _P, _P),
    # packed, order, ranges, bg, color, invdepth, final_T, height, width, tile, stream
    "guava_blend_bf16_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # rows, ltable, P, L, order, ranges, bg, color, invdepth, final_T, height, width, tile,
    # stream
    "guava_blend_resident_fwd": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # stream rows, ranges, bg, color, invdepth, final_T, height, width, tile, stream
    "guava_blend_stream_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # rows, ids, out, n, stream
    "guava_gather_rows": (_P, _P, _P, _I, _P),
    # rows, keys, id_bits, out, lids, n, stream
    "guava_gather_resident": (_P, _P, _I, _P, _P, _I, _P),
    # &ctas, &smem_bytes: resident CTAs an SM of K9
    "guava_gather_rows_occupancy": (_P, _P),
    # rows, order, ranges, bg, color, invdepth, final_T, counts, height, width, tile, chunk,
    # exit_every, stage_rows, stream
    "guava_blend_probe": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # table, idx, row_bytes, source, pipelined, banks, n_chunks, n_ctas, vals, staged (or
    # null), out (or null: the copies alone), stream
    "guava_row_copy": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # pipelined, &ctas, &smem_bytes: resident CTAs an SM of T2's kernel
    "guava_row_copy_occupancy": (_I, _P, _P),
    # table, partials, out, n_rows, n_ctas, stream
    "guava_stream_sum": (_P, _P, _P, _I, _I, _P),
    # src, idx (or null), n_seg, base, elem_bytes, seg_bytes, out_off, out_bytes, out, route,
    # stream
    "guava_copy_probe": (_P, _P, _I, _L, _I, _I, _I, _I, _P, _I, _P),
    # x, dtype, B, C, sb, sc, sh, sw, ys, ty, h_out, ky, xs, tx, w_out, kx, out, rows, tw, cc,
    # wsp, yspan, smem, chan_fast, vec, stream
    "guava_resize": (_P, _I, _I, _I, _L, _L, _L, _L, _P, _P, _I, _I, _P, _P, _I, _I, _P, _I, _I,
                     _I, _I, _I, _I, _I, _I, _P),
    # smem_bytes, &ctas: resident CTAs an SM of R1's float32 kernel
    "guava_resize_occupancy": (_I, _P),
}

_lib: ctypes.CDLL | None = None
build_log = ""                       # nvcc/ptxas output (registers, spills per kernel)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update(" ".join(SOURCE_FLAGS.get(name, ())).encode())
        h.update((CSRC / name).read_bytes())
    for name in HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
            raise RuntimeError(f"{' '.join(cmd)} failed ({p.returncode}):\n{out}")
    return "".join(logs)


def build() -> Path:
    """Compile the kernels unless this exact build exists; return the .so path.
    One process compiles at a time; the others wait and load its build."""
    lib_path = BUILD_DIR / f"libguava_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            _compile(lib_path)
    return lib_path


def _compile(lib_path: Path) -> None:
    global build_log
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{Path(s).stem}_{os.getpid()}.o" for s in SOURCES]
    build_log = _run_all([
        [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(s, ()), "-c", str(CSRC / s), "-o", str(o)]
        for s, o in zip(SOURCES, objs)
    ])
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
    build_log += _run_all([[nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, lib_path)
    for o in objs:
        o.unlink()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
