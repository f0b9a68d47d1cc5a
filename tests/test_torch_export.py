"""The port's point-cloud export and PLY writers against acezero_tpu's.

The PLY bytes, PIL's bilinear colour resize and the host-side point
selection (given the JAX package's coordinate maps) are exact. End to end
each package predicts its own coordinates: bf16 encoder and head chains
summed in other orders flip single roundings, so the maps differ a little
(within COORD_TOL of the map's extent; measured 1.3e-4 here, 0.25 mm),
and a point whose reprojection error sits at the per-frame cut can change
sides. The clouds must hold the same number of points, and COMMON_SHARE
of the port's points must lie at the JAX package's cells (same frame, same
cell).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

import acezero_tpu.export.point_cloud as jpc
from acezero_tpu.data.augment import normalize_images as j_normalize
from acezero_tpu.data.scene import load_scene as j_load_scene
from acezero_tpu.io import ply as jply
from acezero_tpu.io.pose_files import PoseFileEntry as JEntry
from acezero_tpu.models import torch_io as jio
from acezero_tpu.models.encoder import encoder_apply as j_encoder_apply
from acezero_tpu.models.head import HeadConfig as JHeadConfig
from acezero_tpu.models.head import head_apply_image as j_head_apply_image
from acezero_tpu.models.head import init_head_params as j_init_head
import acezero_tpu_torch.export.point_cloud as tpc
from acezero_tpu_torch.data import images as ti
from acezero_tpu_torch.data.scene import load_scene
from acezero_tpu_torch.io import ply as tply
from acezero_tpu_torch.io.pose_files import PoseFileEntry
from acezero_tpu_torch.models import torch_io as tio
from acezero_tpu_torch.models.head import HeadConfig

ENCODER = Path(__file__).resolve().parents[1] / "weights" / "tpu_encoder_v6.pt"
COORD_TOL = 1e-3
COMMON_SHARE = 0.9
N = 4


# ------------------------------------------------------------------ PLY


@pytest.mark.parametrize("colors,binary", [(True, True), (False, True), (True, False), (False, False)])
def test_ply_points_bytes_equal_jax(colors, binary, tmp_path):
    rng = np.random.default_rng(30)
    xyz = rng.normal(size=(57, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (57, 3)).astype(np.uint8) if colors else None
    jply.write_ply_points(tmp_path / "j.ply", xyz, rgb, binary=binary)
    tply.write_ply_points(tmp_path / "t.ply", xyz, rgb, binary=binary)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    if binary:
        got_xyz, got_rgb = tply.read_ply_points(tmp_path / "t.ply")
        assert np.array_equal(got_xyz, xyz) and (got_rgb is None if rgb is None else np.array_equal(got_rgb, rgb))


@pytest.mark.parametrize("colors", [True, False])
def test_ply_mesh_bytes_equal_jax(colors, tmp_path):
    rng = np.random.default_rng(31)
    verts = rng.normal(size=(9, 3))
    faces = rng.integers(0, 9, (7, 3))
    vc = rng.integers(0, 300, (9, 3)) if colors else None  # out-of-range colours clip in both
    jply.write_ply_mesh(tmp_path / "j.ply", verts, faces, vc)
    tply.write_ply_mesh(tmp_path / "t.ply", verts, faces, vc)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


# ------------------------------------------------------ colour resize


@pytest.mark.parametrize("src,dst", [((75, 101), (56, 75)), ((480, 640), (360, 480)), ((40, 50), (81, 99)),
                                     ((97, 131), (96, 130)), ((11, 7), (3, 2)), ((10, 10), (10, 17)),
                                     ((33, 45), (33, 45))])
@pytest.mark.parametrize("channels", [1, 3])
def test_bilinear_resize_matches_pil(src, dst, channels):
    """Pillow's BILINEAR: shrinking (the triangle widened by the factor),
    enlarging, one axis only, and the same size (a copy); exact."""
    rng = np.random.default_rng(src[0] * 7 + channels)
    img = rng.integers(0, 256, src + ((3,) if channels == 3 else ()), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), Image.BILINEAR))
    assert np.array_equal(ti.pil_resize_bilinear(img, *dst), want)


# ------------------------------------------------------------- the cloud


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    """Four textured RGB frames of 75 x 101 pixels: at a 56-pixel short side
    the content is 56 x 75 on a 56 x 80 canvas, so the colour resize shrinks
    and the canvas has a padded margin."""
    out = tmp_path_factory.mktemp("pc")
    rng = np.random.default_rng(32)
    yy, xx = np.mgrid[:75, :101]
    for i in range(N):
        rgb = np.stack([(xx * (3 + i)) % 256, (yy * 5 + 40 * i) % 256, ((xx + yy) * 2) % 256], -1)
        rgb = np.clip(rgb + rng.integers(-25, 25, rgb.shape), 0, 255).astype(np.uint8)
        Image.fromarray(rgb).save(out / f"frame_{i}.png")
    return out


@pytest.fixture(scope="module")
def maps(scene_files):
    """Both packages' scenes, the JAX head, entries and JAX coordinate maps."""
    glob = str(scene_files / "*.png")
    jscene = j_load_scene(glob, external_focal_length=60.0, image_short_size=56)
    tscene = load_scene(glob, external_focal_length=60.0, image_short_size=56)
    assert tscene.canvas_hw == jscene.canvas_hw == (56, 80)
    enc_np = jio.load_encoder(ENCODER)
    enc_j = jax.tree.map(jnp.asarray, enc_np)
    head_j = j_init_head(jax.random.PRNGKey(3), JHeadConfig(), jnp.asarray([0.1, -0.2, 2.0]))
    rng = np.random.default_rng(33)
    entries = []
    for i, f in enumerate(tscene.rgb_files):
        w2c = np.eye(4)
        w2c[:3, 3] = rng.normal(size=3) * 0.1
        entries.append((f, w2c, 60.0 + i, 1000.0 + i))
    # the JAX export's own program: one jit with the weights closed over
    fwd = jax.jit(lambda img: j_head_apply_image(head_j, JHeadConfig(), j_encoder_apply(enc_j, j_normalize(img))))
    coords_j = np.stack([np.asarray(fwd(jnp.asarray(jscene.images.canvases[i][None])))[0] for i in range(N)])
    return {"jscene": jscene, "tscene": tscene, "enc_np": enc_np, "enc_j": enc_j, "head_j": head_j,
            "entries": entries, "coords_j": coords_j}


CASES = {
    "defaults": (dict(), {}),  # the relaxed branch: fewer valid points than PC_POINTS_MIN / frames
    "min_and_max": (dict(PC_POINTS_MIN=40, PC_POINTS_MAX=400), {}),
    "subsample": (dict(PC_POINTS_MIN=8, PC_POINTS_MAX=80, REPRO_THRESHOLD=1e9), {}),  # default_rng(0) choice
    "dense_opengl": (dict(), {"dense": True, "convention": "opengl"}),
    "near_depth": (dict(PC_POINTS_MIN=40), {"filter_depth": 2.0}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_selection_is_exact_given_jax_coordinates(case, maps, monkeypatch):
    """select_points on the JAX package's coordinate maps gives the JAX
    package's cloud: the same points in the same order, the same colours."""
    consts, kw = CASES[case]
    for mod in (jpc, tpc):
        for k, v in consts.items():
            monkeypatch.setattr(mod, k, v)
    j_entries = [JEntry(f, w2c, foc, conf) for f, w2c, foc, conf in maps["entries"]]
    want_xyz, want_rgb = jpc.point_cloud_from_network(maps["enc_j"], maps["head_j"], JHeadConfig(), maps["jscene"],
                                                      j_entries, **kw)
    frames = [(i, PoseFileEntry(f, w2c, foc, conf)) for i, (f, w2c, foc, conf) in enumerate(maps["entries"])]
    got_xyz, got_rgb = tpc.select_points(maps["coords_j"], frames, maps["tscene"], **kw)
    assert got_xyz.dtype == np.float32 and got_rgb.dtype == np.uint8
    assert len(got_xyz) > 0
    assert np.array_equal(got_xyz, want_xyz) and np.array_equal(got_rgb, want_rgb)


def test_end_to_end_cloud_within_tolerance(maps, tmp_path, monkeypatch):
    """The port's export from the same weights (params_from_jax) on its own
    scene: coordinate maps within COORD_TOL of the map's extent, the same
    point count, COMMON_SHARE of the points at the same cells, and the PLY
    as the JAX writer would write that cloud."""
    for mod in (jpc, tpc):
        monkeypatch.setattr(mod, "PC_POINTS_MIN", 100)
    enc_t, head_t = tio.params_from_jax(maps["enc_np"], jax.device_get(maps["head_j"]))
    coords_t = tpc.predict_coords(enc_t, head_t, HeadConfig(), maps["tscene"].images.canvases, chunk=3)
    extent = np.abs(maps["coords_j"]).max()
    assert np.abs(coords_t - maps["coords_j"]).max() <= COORD_TOL * extent
    entries = [PoseFileEntry(f, w2c, foc, conf) for f, w2c, foc, conf in maps["entries"]]
    tpc.export_point_cloud_from_network(tmp_path / "pc.ply", enc_t, head_t, HeadConfig(), maps["tscene"], entries)
    xyz_t, rgb_t = tply.read_ply_points(tmp_path / "pc.ply")
    j_entries = [JEntry(f, w2c, foc, conf) for f, w2c, foc, conf in maps["entries"]]
    xyz_j, rgb_j = jpc.point_cloud_from_network(maps["enc_j"], maps["head_j"], JHeadConfig(), maps["jscene"],
                                                j_entries)
    assert len(xyz_t) == len(xyz_j) == N * (100 // N)
    # cells of each cloud, by matching the points to their frame's map
    def cells(xyz, coords):
        flat = coords.reshape(len(coords), -1, 3)
        out = set()
        for p in xyz:
            d = np.linalg.norm(flat - p, axis=-1)
            f, c = np.unravel_index(np.argmin(d), d.shape)
            out.add((int(f), int(c)))
        return out
    common = cells(xyz_t, coords_t) & cells(xyz_j, maps["coords_j"])
    assert len(common) >= COMMON_SHARE * len(xyz_t)
    tply.write_ply_points(tmp_path / "again.ply", xyz_t, rgb_t)
    jply.write_ply_points(tmp_path / "j.ply", xyz_t, rgb_t)
    assert (tmp_path / "again.ply").read_bytes() == (tmp_path / "j.ply").read_bytes() \
        == (tmp_path / "pc.ply").read_bytes()


def test_unreadable_rgb_falls_back_to_the_gray_canvas(maps, monkeypatch):
    """A frame whose file cannot be read as a PNG takes its colours from the
    gray canvas at the cell centres, as the JAX package does."""
    def fail(path):
        raise ValueError("unreadable")

    monkeypatch.setattr(tpc, "read_rgb", fail)
    rgb = tpc._frame_colors(maps["tscene"], 1, 7, 10)
    gray = maps["tscene"].images.canvases[1][4::8, 4::8]
    assert rgb.shape == (70, 3) and np.array_equal(rgb, np.stack([gray.reshape(-1)] * 3, -1))
    sub = maps["tscene"].subset(np.asarray([1]), copy_canvases=False)
    assert np.array_equal(tpc._frame_colors(sub, 0, 7, 10), rgb)  # read through the root canvases
