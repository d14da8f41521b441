"""The port's SMPL-X / FLAME loaders against the JAX package's, on asset
files written in the published schema at the published counts
(`testing.write_schema_assets`: SMPL-X 2020 neutral 10,475 vertices, 20,908
faces; FLAME 2020 5,023 vertices, 9,976 faces; 400 shape components).

`load_smplx` and `load_flame` are held equal field by field (dtypes
included), the UV tables among them; the FLAME pickle is also read in its
chumpy-typed form with no chumpy module present, and a pickled class the
loaders do not know is refused by its module and name.
"""

import dataclasses
import os
import pickle
import shutil
import sys

import numpy as np
import pytest

from guava_renderer_tpu.bodymodel import data as jdata
from guava_renderer_tpu_torch.bodymodel import data as tdata
from guava_renderer_tpu_torch.testing import (SCHEMA_COUNTS, write_flame_pickle,
                                              write_schema_assets)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return write_schema_assets(str(tmp_path_factory.mktemp("schema")), seed=3)


def _assert_same_fields(a, b):
    assert type(a).__name__ == type(b).__name__
    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(vb, np.ndarray) or isinstance(va, np.ndarray):
            assert va is not None and vb is not None, f.name
            assert va.dtype == vb.dtype and va.shape == vb.shape, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


def test_schema_counts(assets):
    ss = np.load(os.path.join(assets["smplx_dir"], "SMPLX_NEUTRAL_2020.npz"))
    c = SCHEMA_COUNTS
    assert ss["v_template"].shape == (c["smplx_vertices"], 3)
    assert ss["f"].shape == (c["smplx_faces"], 3)
    assert ss["shapedirs"].shape == (c["smplx_vertices"], 3, 400)
    assert ss["posedirs"].shape == (c["smplx_vertices"], 3, 486)
    assert ss["J_regressor"].shape == (55, c["smplx_vertices"])
    assert ss["weights"].shape == (c["smplx_vertices"], 55)
    fl = assets["flame_model"]
    assert fl["v_template"].shape == (c["flame_vertices"], 3)
    assert fl["f"].shape == (c["flame_faces"], 3)
    assert fl["shapedirs"].shape == (c["flame_vertices"], 3, 400)
    assert fl["posedirs"].shape == (c["flame_vertices"], 3, 36)
    assert type(fl["J_regressor"]).__module__.startswith("scipy.sparse")
    ids = np.load(os.path.join(assets["smplx_dir"], "SMPL-X__FLAME_vertex_ids.npy"))
    assert ids.shape == (c["flame_vertices"],) and len(np.unique(ids)) == len(ids)
    mano = tdata.load_asset_pickle(os.path.join(assets["smplx_dir"],
                                                "MANO_SMPLX_vertex_ids.pkl"))
    assert {k: v.shape for k, v in mano.items()} == {"left_hand": (778,), "right_hand": (778,)}
    _, tex, fv, _ = tdata.parse_obj_uv(os.path.join(assets["smplx_dir"], "smplx_uv.obj"))
    assert tex.shape[0] > c["smplx_vertices"], "the chart has seams"
    # the SMPL-X head region is the FLAME mesh through the id map
    np.testing.assert_allclose(ss["v_template"][ids] - fl["v_template"],
                               np.broadcast_to([0.0, 1.0, 0.0], (len(ids), 3)), atol=1e-6)
    head = np.isin(fv, ids).all(1)
    assert head.sum() == c["flame_faces"]


@pytest.mark.parametrize("uv_size,add_teeth", [(512, True), (64, True), (128, False)])
def test_load_smplx_equals_jax(assets, uv_size, add_teeth):
    kw = dict(uv_size=uv_size, add_teeth=add_teeth, flame_assets_dir=assets["flame_dir"])
    got = tdata.load_smplx(assets["smplx_dir"], **kw)
    want = jdata.load_smplx(assets["smplx_dir"], **kw)
    for a, b in zip(got, want):
        _assert_same_fields(a, b)
    assert got[1].uvmap_mask.sum() > 0


def test_load_flame_equals_jax(assets):
    _assert_same_fields(tdata.load_flame(assets["flame_dir"]),
                        jdata.load_flame(assets["flame_dir"]))


@pytest.mark.parametrize("n_shape,n_exp", [(300, 50), (100, 20)])
def test_load_flame_components(assets, n_shape, n_exp):
    got = tdata.load_flame(assets["flame_dir"], n_shape=n_shape, n_exp=n_exp)
    _assert_same_fields(got, jdata.load_flame(assets["flame_dir"], n_shape=n_shape, n_exp=n_exp))
    sd = assets["flame_model"]["shapedirs"]
    np.testing.assert_array_equal(got.shapedirs[:, :, n_shape:],
                                  sd[:, :, 300:300 + n_exp].astype(np.float32))


def test_chumpy_pickle_without_chumpy(assets, tmp_path):
    with pytest.raises(ImportError):
        __import__("chumpy")
    d = tmp_path / "FLAME"
    d.mkdir()
    write_flame_pickle(str(d / "generic_model.pkl"), assets["flame_model"], chumpy=True)
    for name in ("l_eyelid.npy", "r_eyelid.npy"):
        shutil.copy(os.path.join(assets["flame_dir"], name), d / name)
    assert "chumpy" not in sys.modules
    raw = (d / "generic_model.pkl").read_bytes()
    assert b"chumpy.ch" in raw and b"Ch" in raw
    with pytest.raises(ModuleNotFoundError, match="chumpy"):
        pickle.loads(raw, encoding="latin1")        # a bare load needs chumpy
    _assert_same_fields(tdata.load_flame(str(d)), tdata.load_flame(assets["flame_dir"]))


class Unknown:
    pass


def test_unknown_class_refused_by_name(tmp_path):
    path = tmp_path / "generic_model.pkl"
    with open(path, "wb") as f:
        pickle.dump({"v_template": Unknown()}, f, protocol=2)
    with pytest.raises(pickle.UnpicklingError, match=f"refused pickled class {__name__}.Unknown"):
        tdata.load_flame(str(tmp_path))
    with open(path, "wb") as f:
        pickle.dump({"f": os.system}, f, protocol=2)
    with pytest.raises(pickle.UnpicklingError, match=r"refused pickled class (posix|nt)\.system"):
        tdata.load_asset_pickle(str(path))


def test_missing_files_are_named(assets, tmp_path):
    with pytest.raises(FileNotFoundError, match="SMPLX_NEUTRAL_2020.npz"):
        tdata.load_smplx(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="generic_model.pkl"):
        tdata.load_flame(str(tmp_path))
    d = tmp_path / "SMPLX"
    shutil.copytree(assets["smplx_dir"], d)
    os.remove(d / "smplx_uv.obj")
    with pytest.raises(FileNotFoundError, match="smplx_uv.obj"):
        tdata.load_smplx(str(d), add_teeth=False)


def test_parse_obj_uv_equals_jax(assets):
    path = os.path.join(assets["smplx_dir"], "smplx_uv.obj")
    for a, b in zip(tdata.parse_obj_uv(path), jdata.parse_obj_uv(path)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("uv_size", [64, 256])
def test_template_position_map_equals_jax(assets, uv_size):
    data, ex = tdata.load_smplx(assets["smplx_dir"], uv_size=uv_size,
                                flame_assets_dir=assets["flame_dir"])
    got = tdata.template_position_map(data.v_template, data.faces, ex.uvmap_f_idx, ex.uvmap_mask)
    want = jdata.template_position_map(data.v_template, data.faces, ex.uvmap_f_idx,
                                       ex.uvmap_mask)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).sum() > 0
