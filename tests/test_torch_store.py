"""The port's record store (`data/store.py`, `native/recordstore.cpp`)
against the JAX package's: one file format both ways, both readers."""

import numpy as np
import pytest

from guava_renderer_tpu.data import store as jstore
from guava_renderer_tpu_torch.data import store as pstore

WRITERS = {"jax": jstore.RecordStoreWriter, "port": pstore.RecordStoreWriter}
READERS = {"jax": jstore.RecordStore, "port": pstore.RecordStore}


def _records(seed=0):
    rng = np.random.default_rng(seed)
    recs = {f"vid{v:03d}/{f:06d}/{kind}": rng.integers(0, 256, int(rng.integers(0, 300)),
                                                       dtype=np.uint8).tobytes()
            for v in range(3) for f in range(5) for kind in ("body_image", "body_mask")}
    recs["empty"] = b""
    recs["ünïcode/键"] = b"\x00\xff" * 7
    recs["big"] = rng.integers(0, 256, (1 << 20) + 12345, dtype=np.uint8).tobytes()   # > 1 MB
    return recs


def _write(kind, path, recs):
    with WRITERS[kind](str(path)) as w:
        for k, v in recs.items():
            w.put(k, v)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"), ("port", "port")])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_store_round_trip_across_packages(tmp_path, writer, reader, native):
    recs = _records()
    path = tmp_path / "img_store.grv"
    _write(writer, path, recs)
    st = READERS[reader](str(path), native=native)
    assert st.backend == ("native" if native else "python")
    assert len(st) == len(recs) and sorted(st.keys()) == sorted(recs)
    for k, v in recs.items():
        assert st.get(k) == v, k
        assert k in st
    assert st.get("vid000/000000/missing") is None and "nope" not in st
    assert np.array_equal(st.get_array("vid001/000002/body_mask"),
                          np.frombuffer(recs["vid001/000002/body_mask"], np.uint8))
    assert st.get_array("absent") is None
    st.close()


def test_port_writer_file_equals_jax_writer_file(tmp_path):
    recs = _records(1)
    _write("jax", tmp_path / "j.grv", recs)
    _write("port", tmp_path / "p.grv", recs)
    assert (tmp_path / "j.grv").read_bytes() == (tmp_path / "p.grv").read_bytes()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_empty_store(tmp_path, native):
    path = tmp_path / "empty.grv"
    pstore.RecordStoreWriter(str(path)).close()
    st = pstore.RecordStore(str(path), native=native)
    assert len(st) == 0 and st.keys() == [] and st.get("any") is None
    assert st.backend == ("native" if native else "python")
    jst = jstore.RecordStore(str(path), native=native)
    assert len(jst) == 0 and jst.keys() == []


def test_native_library_is_built_under_build_torch_host():
    from pathlib import Path

    from guava_renderer_tpu_torch.native import lib_path

    p = Path(lib_path("recordstore"))
    assert p.parent.name == "torch_host" and p.parent.parent.name == "build" and p.exists()
    assert lib_path("recordstore") == str(p)          # built once, then reused
