"""The body-model modules of the real-asset path against the JAX package,
on seeded numpy inputs: the rotation suite, `look_at_camera` and the Camera
layouts, `vertices2landmarks`, `core/mesh.py`, the standalone SMPL-X and
FLAME forwards and `pose_rel2abs`, the landmark tables, functions and file
loaders, `FlameMask`, the FLAME texture space and teeth graft, and the two
EHM helpers. The forwards run on the full-count schema files
(`testing.write_schema_assets`). Forwards are held to atol 1e-5, index
tables exactly.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.bodymodel import data as jdata
from guava_renderer_tpu.bodymodel import ehm as jehm
from guava_renderer_tpu.bodymodel import flame as jflame
from guava_renderer_tpu.bodymodel import flame_mask as jmask
from guava_renderer_tpu.bodymodel import landmarks as jlmk
from guava_renderer_tpu.bodymodel import smplx as jsmplx
from guava_renderer_tpu.core import cameras as jcam
from guava_renderer_tpu.core import lbs as jlbs
from guava_renderer_tpu.core import mesh as jmesh
from guava_renderer_tpu.core import rotations as jrot
from guava_renderer_tpu_torch.bodymodel import data as tdata
from guava_renderer_tpu_torch.bodymodel import ehm as tehm
from guava_renderer_tpu_torch.bodymodel import flame as tflame
from guava_renderer_tpu_torch.bodymodel import flame_mask as tmask
from guava_renderer_tpu_torch.bodymodel import landmarks as tlmk
from guava_renderer_tpu_torch.bodymodel import smplx as tsmplx
from guava_renderer_tpu_torch.core import cameras as tcam
from guava_renderer_tpu_torch.core import lbs as tlbs
from guava_renderer_tpu_torch.core import mesh as tmesh
from guava_renderer_tpu_torch.core import rotations as trot
from guava_renderer_tpu_torch.testing import write_schema_assets

torch.set_num_threads(2)
ATOL = 1e-5
CPU = torch.device("cpu")


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _t(x):
    return torch.as_tensor(np.array(x))


# ---- rotations ----

def _rot_inputs(rng):
    aa = (rng.normal(size=(4, 5, 3)) * 1.2).astype(np.float32)
    aa[0, 0] = 0.0
    aa[0, 1] = 1e-7
    q = rng.normal(size=(4, 5, 4)).astype(np.float32)
    q[1, 0] = [-0.9, 0.1, 0.2, 0.1]                     # w < 0: the shortest arc
    R = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa)))
    return {"aa": aa, "q": q, "R": R, "v": rng.normal(size=(4, 5, 3)).astype(np.float32),
            "x6": rng.normal(size=(4, 5, 6)).astype(np.float32),
            "e": rng.uniform(-3, 3, (4, 5, 3)).astype(np.float32),
            "t": rng.normal(size=(4, 5, 3)).astype(np.float32),
            "pts": rng.normal(size=(4, 7, 3)).astype(np.float32),
            "M": rng.normal(size=(4, 4, 4)).astype(np.float32)}


ROT_CASES = {
    "axis_angle_to_quat": ("aa",),
    "matrix_to_axis_angle": ("R",),
    "quat_to_axis_angle": ("q",),
    "quat_conjugate": ("q",),
    "quat_to_matrix": ("q",),
    "rot6d_to_matrix": ("x6",),
    "matrix_to_rot6d": ("R",),
    "euler_to_matrix": ("e",),
}


@pytest.mark.parametrize("name", sorted(ROT_CASES))
def test_rotation_equals_jax(name):
    x = _rot_inputs(np.random.default_rng(1))
    args = [x[k] for k in ROT_CASES[name]]
    _close(getattr(trot, name)(*map(_t, args)), getattr(jrot, name)(*map(jnp.asarray, args)))


def test_quat_rotate_equals_jax():
    x = _rot_inputs(np.random.default_rng(2))
    q = np.asarray(jrot.quat_normalize(jnp.asarray(x["q"])))
    _close(trot.quat_rotate(_t(q), _t(x["v"])), jrot.quat_rotate(jnp.asarray(q), x["v"]))


def test_rigid_helpers_equal_jax():
    x = _rot_inputs(np.random.default_rng(3))
    _close(trot.rt_to_mat4(_t(x["R"]), _t(x["t"])), jrot.rt_to_mat4(x["R"], x["t"]))
    _close(trot.transform_points(_t(x["M"]), _t(x["pts"])),
           jrot.transform_points(x["M"], x["pts"]))


# ---- cameras ----

@pytest.mark.parametrize("eye,target,up", [((0.3, 0.2, -5.0), (0.0, 0.1, 0.0), (0.0, 1.0, 0.0)),
                                           ((2.0, -1.0, 3.0), (0.5, 0.5, 0.5), (0.0, 0.0, 1.0))])
def test_look_at_camera_and_layouts_equal_jax(eye, target, up):
    tc = tcam.look_at_camera(eye, target, up, tanfov=0.3, width=64, height=48, device="cpu")
    jc = jcam.look_at_camera(eye, target, up, tanfov=0.3, width=64, height=48)
    _close(tc.R, jc.R)
    _close(tc.t, jc.t)
    _close(tc.campos, jc.campos)
    assert (tc.width, tc.height) == (jc.width, jc.height)
    for a, b in zip(tc.gs_layout(), jc.gs_layout()):
        _close(a, b)
    back = tcam.Camera.from_gs_layout(tc.gs_layout()[0], 0.3, 0.25, 64, 48)
    jback = jcam.Camera.from_gs_layout(jc.gs_layout()[0], 0.3, 0.25, 64, 48)
    _close(back.R, jback.R)
    _close(back.t, jback.t)
    assert float(back.tanfovy) == pytest.approx(float(jback.tanfovy))
    _close(back.full_proj_matrix(), jback.full_proj_matrix())


def test_look_at_camera_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcam.look_at_camera((0, 0, -3), (0, 0, 0))


# ---- the schema rig ----

@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    root = tmp_path_factory.mktemp("schema")
    paths = write_schema_assets(str(root), seed=5)
    kw = dict(uv_size=32, flame_assets_dir=paths["flame_dir"])
    smplx, extras = tdata.load_smplx(paths["smplx_dir"], **kw)
    flame = tdata.load_flame(paths["flame_dir"])
    jsm, jex = jdata.load_smplx(paths["smplx_dir"], **kw)
    jfl = jdata.load_flame(paths["flame_dir"])
    return dict(paths=paths, root=root, smplx=smplx, extras=extras, flame=flame,
                jsmplx=jsm, jextras=jex, jflame=jfl)


def _body(rng, B=2, with_scales=True):
    d = {
        "shape": (rng.normal(size=(B, 10)) * 0.5).astype(np.float32),
        "body_pose": (rng.normal(size=(B, 21, 3)) * 0.2).astype(np.float32),
        "global_pose": (rng.normal(size=(B, 1, 3)) * 0.2).astype(np.float32),
        "left_hand_pose": (rng.normal(size=(B, 15, 3)) * 0.2).astype(np.float32),
        "right_hand_pose": (rng.normal(size=(B, 15, 3)) * 0.2).astype(np.float32),
        "exp": (rng.normal(size=(B, 50)) * 0.3).astype(np.float32),
        "joints_offset": (rng.normal(size=(B, 55, 3)) * 0.01).astype(np.float32),
    }
    if with_scales:
        d["head_scale"] = rng.uniform(0.9, 1.1, (B, 3)).astype(np.float32)
        d["hand_scale"] = rng.uniform(0.9, 1.1, (B, 3)).astype(np.float32)
    return (tehm.BodyParams(**{k: _t(v) for k, v in d.items()}),
            jehm.BodyParams(**{k: jnp.asarray(v) for k, v in d.items()}))


def _flame_params(rng, B=2):
    d = {"shape": (rng.normal(size=(B, 20)) * 0.5).astype(np.float32),
         "exp": (rng.normal(size=(B, 50)) * 0.5).astype(np.float32),
         "jaw": (rng.normal(size=(B, 3)) * 0.1).astype(np.float32),
         "eyes": (rng.normal(size=(B, 6)) * 0.1).astype(np.float32),
         "eyelids": rng.uniform(0, 1, (B, 2)).astype(np.float32)}
    return (tehm.FlameParams(**{k: _t(v) for k, v in d.items()}),
            jehm.FlameParams(**{k: jnp.asarray(v) for k, v in d.items()}))


def test_extras_to_torch(rig):
    got = tsmplx.extras_to_torch(rig["extras"], CPU)
    want = jsmplx.extras_to_jax(rig["jextras"])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
        assert got[k].dtype == (torch.int64 if "ind" in k else torch.float32)


@pytest.mark.parametrize("eyelids", [False, True])
def test_smplx_forward_equals_jax(rig, eyelids):
    tb, jb = _body(np.random.default_rng(7))
    lids = np.random.default_rng(8).uniform(0, 1, (2, 2)).astype(np.float32)
    got = tsmplx.smplx_forward(rig["smplx"].torch(CPU), tuple(rig["smplx"].parents),
                               tsmplx.extras_to_torch(rig["extras"], CPU), tb,
                               eyelid_params=_t(lids) if eyelids else None)
    want = jsmplx.smplx_forward(rig["jsmplx"].jax(), tuple(rig["jsmplx"].parents),
                                jsmplx.extras_to_jax(rig["jextras"]), jb,
                                eyelid_params=jnp.asarray(lids) if eyelids else None)
    for a, b, name in zip(got, want, got._fields):
        _close(a, b, atol=ATOL if name != "vertex_transforms" else 2 * ATOL)


@pytest.mark.parametrize("joint", ["head", "neck", "right_wrist", "left_wrist"])
def test_pose_rel2abs_equals_jax(joint):
    rng = np.random.default_rng(9)
    g = (rng.normal(size=(3, 1, 3)) * 0.5).astype(np.float32)
    b = (rng.normal(size=(3, 21, 3)) * 0.5).astype(np.float32)
    _close(tsmplx.pose_rel2abs(_t(g), _t(b), joint), jsmplx.pose_rel2abs(g, b, joint))


@pytest.mark.parametrize("neck_global", [False, True])
def test_flame_forward_equals_jax(rig, neck_global):
    rng = np.random.default_rng(10)
    tf, jf = _flame_params(rng)
    extra = {}
    if neck_global:
        extra = {k: (rng.normal(size=(2, 3)) * 0.2).astype(np.float32)
                 for k in ("neck_pose", "global_pose")}
    got = tsmplx.flame_forward(rig["flame"].torch(CPU), tuple(rig["flame"].parents), tf,
                               **{k: _t(v) for k, v in extra.items()})
    want = jsmplx.flame_forward(rig["jflame"].jax(), tuple(rig["jflame"].parents), jf,
                                **{k: jnp.asarray(v) for k, v in extra.items()})
    for a, b in zip(got, want):
        _close(a, b)


def test_vertices2landmarks_equals_jax(rig):
    rng = np.random.default_rng(11)
    verts = rng.normal(size=(2, rig["flame"].num_vertices, 3)).astype(np.float32)
    faces = rig["flame"].faces
    fidx = rng.integers(0, len(faces), (2, 30)).astype(np.int32)
    bary = rng.uniform(0, 1, (2, 30, 3)).astype(np.float32)
    _close(tlbs.vertices2landmarks(_t(verts), _t(faces), _t(fidx), _t(bary)),
           jlbs.vertices2landmarks(verts, faces, fidx, bary))
    _close(tlbs.vertices2landmarks(_t(verts), _t(faces), _t(fidx[0]), _t(bary[0])),
           jlbs.vertices2landmarks(verts, faces, fidx[0], bary[0]))


# ---- core/mesh.py ----

def test_mesh_helpers_equal_jax(rig):
    """On posed FLAME vertices (a forward's output, as the deformer sees them)."""
    rng = np.random.default_rng(12)
    faces = rig["flame"].faces
    _, jf = _flame_params(rng)
    verts = np.asarray(jsmplx.flame_forward(rig["jflame"].jax(), tuple(rig["jflame"].parents),
                                            jf)[0])
    R, s = tmesh.face_orientation(_t(verts), _t(faces))
    jR, js = jmesh.face_orientation(jnp.asarray(verts), jnp.asarray(faces))
    _close(R, jR)
    _close(s, js)
    assert tmesh.face_orientation(_t(verts), _t(faces), return_scale=False)[1] is None
    fid = rng.integers(0, len(faces), 40)
    bary = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    _close(tmesh.face_centers_bary(_t(verts), _t(faces), _t(fid), _t(bary)),
           jmesh.face_centers_bary(jnp.asarray(verts), jnp.asarray(faces), fid, bary))
    _close(tmesh.vertex_normals(_t(verts), _t(faces)),
           jmesh.vertex_normals(jnp.asarray(verts), jnp.asarray(faces)), atol=1e-4)
    _close(tmesh.vertex_normals(_t(verts[0]), _t(faces)),
           jmesh.vertex_normals(jnp.asarray(verts[0]), jnp.asarray(faces)), atol=1e-4)


# ---- landmarks ----

def _full_pose(yaws_deg, rng):
    B = len(yaws_deg)
    pose = (rng.normal(size=(B, 55, 3)) * 0.05).astype(np.float32)
    pose[:, 15] = 0.0
    pose[:, 15, 1] = np.radians(yaws_deg)
    return pose


def test_landmark_tables_and_68_equal_jax(rig):
    ss = np.load(os.path.join(rig["paths"]["smplx_dir"], "SMPLX_NEUTRAL_2020.npz"))
    tt = tlmk.landmark_tables_from_smplx_npz(ss, device="cpu")
    jt = jlmk.landmark_tables_from_smplx_npz(ss)
    for a, b in zip(tt[:4], jt[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.numpy().dtype == np.asarray(b).dtype
    assert tt.head_kin_chain == jt.head_kin_chain
    rng = np.random.default_rng(13)
    pose = _full_pose([0.0, 12.0, -20.0, 60.0, -60.0, 38.6], rng)
    np.testing.assert_array_equal(
        tlmk.head_yaw_bucket(_t(pose), tt.head_kin_chain).numpy(),
        np.asarray(jlmk.head_yaw_bucket(jnp.asarray(pose), jt.head_kin_chain)))
    for a, b in zip(tlmk.dynamic_landmark_tables(_t(pose), tt),
                    jlmk.dynamic_landmark_tables(jnp.asarray(pose), jt)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    faces = rig["smplx"].faces
    verts = rng.normal(size=(6, rig["smplx"].num_vertices, 3)).astype(np.float32)
    _close(tlmk.face_landmarks_68(_t(verts), _t(faces), tt, _t(pose)),
           jlmk.face_landmarks_68(jnp.asarray(verts), jnp.asarray(faces), jt,
                                  jnp.asarray(pose)))


def test_landmark_file_loaders_equal_jax(rig, tmp_path):
    rng = np.random.default_rng(14)
    F = len(rig["flame"].faces)
    tt, tfull = tlmk.landmark_tables_from_flame_npy(
        os.path.join(rig["paths"]["flame_dir"], "landmark_embedding.npy"), device="cpu")
    jt, jfull = jlmk.landmark_tables_from_flame_npy(
        os.path.join(rig["paths"]["flame_dir"], "landmark_embedding.npy"))
    for a, b in list(zip(tt[:4], jt[:4])) + list(zip(tfull, jfull)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tt.head_kin_chain == jt.head_kin_chain == (1, 0)
    common = {"lmk_face_idx": rng.integers(0, F, 105), "lmk_b_coords": rng.uniform(0, 1, (105, 3))}
    np.savez(tmp_path / "mp.npz", landmark_indices=np.arange(105) * 4, **common)
    np.savez(tmp_path / "l203.npz", landmark_left_indices=np.arange(50),
             landmark_front_indices=np.arange(50, 120), **common)
    te, ti = tlmk.load_mediapipe_embedding(str(tmp_path / "mp.npz"), device="cpu")
    je, ji = jlmk.load_mediapipe_embedding(str(tmp_path / "mp.npz"))
    np.testing.assert_array_equal(ti, ji)
    te2, ts = tlmk.load_203_embedding(str(tmp_path / "l203.npz"), device="cpu")
    je2, js = jlmk.load_203_embedding(str(tmp_path / "l203.npz"))
    assert sorted(ts) == sorted(js) == ["front", "left"]
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k])
    verts = rng.normal(size=(2, rig["flame"].num_vertices, 3)).astype(np.float32)
    faces = rig["flame"].faces
    for (a, b) in ((te, je), (te2, je2), (tfull, jfull)):
        np.testing.assert_array_equal(a.faces_idx.numpy(), np.asarray(b.faces_idx))
        _close(tlmk.embedded_landmarks(_t(verts), _t(faces), a),
               jlmk.embedded_landmarks(jnp.asarray(verts), jnp.asarray(faces), b))


def test_synthetic_landmark_tables_equal_jax():
    tt = tlmk.synthetic_landmark_tables(500, seed=4, device="cpu")
    jt = jlmk.synthetic_landmark_tables(500, seed=4)
    for a, b in zip(tt[:4], jt[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---- FLAME mask, texture space, head index, teeth ----

def test_flame_mask_equals_jax(rig, tmp_path):
    rng = np.random.default_rng(15)
    V = rig["flame"].num_vertices
    masks = {"face": rng.choice(V, 900, replace=False), "lips": rng.choice(V, 80, replace=False),
             "eye_region": rng.choice(V, 300, replace=False)}
    with open(tmp_path / "FLAME_masks.pkl", "wb") as f:
        pickle.dump(masks, f, protocol=2)
    tm = tmask.FlameMask(str(tmp_path / "FLAME_masks.pkl"), rig["flame"].faces)
    jm = jmask.FlameMask(str(tmp_path / "FLAME_masks.pkl"), rig["flame"].faces)
    assert tm.region_names() == jm.region_names()
    for regions in (["lips"], ["face", "lips"], ["lip_outside_ring_upper"],
                    ["lip_outside_ring_upper", "lip_outside_ring_lower"], []):
        for keep in (True, False):
            np.testing.assert_array_equal(tm.get_vid_by_region(regions, keep),
                                          jm.get_vid_by_region(regions, keep))
    for regions in (["face"], ["lips", "eye_region"]):
        for allv in (True, False):
            np.testing.assert_array_equal(tm.get_fid_by_region(regions, allv),
                                          jm.get_fid_by_region(regions, allv))
    with pytest.raises(ValueError, match="faces"):
        tmask.FlameMask().get_fid_by_region(["lips"])


def test_flame_texture_space_equals_jax(tmp_path):
    rng = np.random.default_rng(16)
    np.savez(tmp_path / "FLAME_texture.npz",
             mean=rng.uniform(0, 255, (16, 16, 3)), tex_dir=rng.normal(size=(16, 16, 3, 8)) * 20)
    ts = tflame.load_flame_texture(str(tmp_path / "FLAME_texture.npz"), n_pc=8)
    js = jflame.load_flame_texture(str(tmp_path / "FLAME_texture.npz"), n_pc=8)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(tflame.synthetic_flame_texture(8, 4, 2), jflame.synthetic_flame_texture(8, 4, 2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    p = (rng.normal(size=(3, 8)) * 2).astype(np.float32)
    _close(tflame.flame_texture(_t(p), ts), jflame.flame_texture(jnp.asarray(p), js))


def test_flame_head_index_and_teeth_equal_jax(rig, tmp_path):
    np.save(tmp_path / "lower.npy", np.arange(0, 5023, 7))
    for path in (None, str(tmp_path / "lower.npy")):
        np.testing.assert_array_equal(tflame.flame_head_index(5023, path),
                                      jflame.flame_head_index(5023, path))
    rng = np.random.default_rng(17)
    tex = rng.uniform(0, 1, (5400, 2)).astype(np.float32)
    fvt = rng.integers(0, 5400, rig["flame"].faces.shape).astype(np.int32)
    hidx = tflame.flame_head_index(5023, str(tmp_path / "lower.npy"))
    got, ginfo = tflame.add_teeth_flame(rig["flame"], tex, fvt, hidx)
    want, winfo = jflame.add_teeth_flame(rig["jflame"], tex, fvt, hidx)
    for name in ("v_template", "faces", "shapedirs", "posedirs", "J_regressor", "lbs_weights",
                 "l_eyelid", "r_eyelid"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert sorted(ginfo) == sorted(winfo)
    for k, v in winfo.items():
        if k == "row_ids":
            for r in v:
                np.testing.assert_array_equal(ginfo[k][r], v[r])
        else:
            np.testing.assert_array_equal(ginfo[k], v, err_msg=k)


# ---- EHM helpers ----

@pytest.fixture(scope="module")
def ehms(rig):
    """The EHM of the teeth-grafted assets: the FLAME rows of the teeth added
    as the synthetic rig adds them."""
    return (tehm.EhmModel.build(rig["smplx"], tflame.add_teeth_flame(rig["flame"])[0],
                                rig["extras"], device="cpu"),
            jehm.EhmModel.build(rig["jsmplx"], jflame.add_teeth_flame(rig["jflame"])[0],
                                rig["jextras"]))


def test_head_hand_subsets_equal_jax(ehms):
    tm, jm = ehms
    rng = np.random.default_rng(18)
    tb, jb = _body(rng)
    tf, jf = _flame_params(rng)
    got = tehm.head_hand_subsets(tm, tehm.ehm_forward(tm, tb, tf))
    want = jehm.head_hand_subsets(jm, jehm.ehm_forward(jm, jb, jf))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("jaw_eyes,mirror", [(False, False), (True, True)])
def test_ehm_transform_mats_equal_jax(ehms, jaw_eyes, mirror):
    tm, jm = ehms
    rng = np.random.default_rng(19)
    tb, jb = _body(rng, with_scales=False)
    extra = {}
    if jaw_eyes:
        extra = {"jaw": (rng.normal(size=(2, 3)) * 0.1).astype(np.float32),
                 "eyes": (rng.normal(size=(2, 6)) * 0.1).astype(np.float32)}
    got = tehm.ehm_transform_mats(tm, tb, mirror_left_hand=mirror,
                                  **{k: _t(v) for k, v in extra.items()})
    want = jehm.ehm_transform_mats(jm, jb, mirror_left_hand=mirror,
                                   **{k: jnp.asarray(v) for k, v in extra.items()})
    for a, b in zip(got, want):
        _close(a, b)
