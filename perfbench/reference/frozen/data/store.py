"""RecordStore — single-file mmap KV store (counterpart of
`guava_renderer_tpu/data/store.py`, the same file format).

The reference stores JPEG frames in LMDB (ref: utils/lmdb.py:14-171,
dataset/data_loader.py:106-107); this is a simpler immutable format: write
once (Python), read forever (zero-copy C++ mmap via ctypes, with a
pure-Python reader for a machine without g++). `backend` says which one
a store reads with.

Format documented in native/recordstore.cpp.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

_MAGIC = 0x31524F5453565247  # "GRVSTOR1"


def _fnv1a(data: bytes) -> int:
    h = 1469598103934665603
    for b in data:
        h ^= b
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


class RecordStoreWriter:
    """Write path (covers the reference LMDBEngine write/dump role)."""

    def __init__(self, path: str):
        self._path = path
        self._f = open(path, "wb")
        self._f.write(struct.pack("<QQQ", _MAGIC, 0, 0))
        self._entries: list[tuple[int, int, int, int, int]] = []

    def put(self, key: str, value: bytes) -> None:
        kb = key.encode()
        key_off = self._f.tell()
        self._f.write(kb)
        val_off = self._f.tell()
        self._f.write(value)
        self._entries.append((_fnv1a(kb), key_off, len(kb), val_off, len(value)))

    def close(self) -> None:
        index_offset = self._f.tell()
        self._entries.sort(key=lambda e: (e[0],))
        for h, koff, klen, voff, vlen in self._entries:
            self._f.write(struct.pack("<QQIIQQ", h, koff, klen, 0, voff, vlen))
        self._f.seek(0)
        self._f.write(struct.pack("<QQQ", _MAGIC, len(self._entries), index_offset))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordStore:
    """Read path: native C++ mmap reader when buildable, Python otherwise."""

    def __init__(self, path: str, native: bool = True):
        self._path = path
        self._lib = None
        self._handle = None
        if native:
            try:
                from ..native import lib_path

                lib = ctypes.CDLL(lib_path("recordstore"))
                lib.rs_open.restype = ctypes.c_void_p
                lib.rs_open.argtypes = [ctypes.c_char_p]
                lib.rs_get.restype = ctypes.POINTER(ctypes.c_uint8)
                lib.rs_get.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                    ctypes.POINTER(ctypes.c_uint64),
                ]
                lib.rs_count.restype = ctypes.c_uint64
                lib.rs_count.argtypes = [ctypes.c_void_p]
                lib.rs_key_at.restype = ctypes.c_uint64
                lib.rs_key_at.argtypes = [
                    ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
                ]
                lib.rs_close.argtypes = [ctypes.c_void_p]
                lib.rs_close.restype = None
                handle = lib.rs_open(path.encode())
                if handle:
                    self._lib = lib
                    self._handle = handle
            except Exception:
                self._lib = None
        if self._lib is None:
            self._load_python()

    # -- python fallback ----------------------------------------------------
    def _load_python(self):
        with open(self._path, "rb") as f:
            data = f.read()
        magic, count, index_offset = struct.unpack_from("<QQQ", data, 0)
        assert magic == _MAGIC, f"bad store file {self._path}"
        self._data = data
        self._index = {}
        off = index_offset
        for _ in range(count):
            h, koff, klen, _pad, voff, vlen = struct.unpack_from("<QQIIQQ", data, off)
            key = data[koff : koff + klen].decode()
            self._index[key] = (voff, vlen)
            off += 40

    # -- api ------------------------------------------------------------
    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def get(self, key: str) -> bytes | None:
        if self._lib is not None:
            n = ctypes.c_uint64()
            ptr = self._lib.rs_get(
                self._handle, key.encode(), len(key.encode()), ctypes.byref(n)
            )
            if not ptr:
                return None
            return ctypes.string_at(ptr, n.value)
        entry = self._index.get(key)
        if entry is None:
            return None
        voff, vlen = entry
        return self._data[voff : voff + vlen]

    def get_array(self, key: str, dtype=np.uint8) -> np.ndarray | None:
        raw = self.get(key)
        return None if raw is None else np.frombuffer(raw, dtype=dtype)

    def keys(self) -> list[str]:
        if self._lib is not None:
            n = int(self._lib.rs_count(self._handle))
            out = []
            buf = ctypes.create_string_buffer(4096)
            for i in range(n):
                k = self._lib.rs_key_at(self._handle, i, buf, 4096)
                out.append(buf.raw[: int(k)].decode())
            return out
        return list(self._index.keys())

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.rs_count(self._handle))
        return len(self._index)

    def close(self):
        if self._lib is not None and self._handle:
            self._lib.rs_close(self._handle)
            self._handle = None

    @property
    def backend(self) -> str:
        return "native" if self._lib is not None else "python"
