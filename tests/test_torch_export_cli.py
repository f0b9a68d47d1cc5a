"""The port's camera and Nerfstudio exports, export CLI and final-sweep CLI
against acezero_tpu's.

Camera meshes, transforms.json, the --visualization_buffer PLY and the
runner's command lines are exact. The runner's downscale of a PNG wider
than 640 pixels gives PIL's pixels (the PNG bytes differ: io/png.py). The
--network route predicts its own coordinates, so its cloud is held to the
JAX CLI's at tests/test_torch_export.py's tolerance: the same point count,
and COMMON_SHARE of the points within COORD_TOL of the cloud's extent of a
JAX point. The pose readers of the two packages turn a quaternion into a
matrix with other roundings (io/pose_files.py), so the transform matrices
of transforms.json agree to MATRIX_TOL, every other field exactly. The
final-sweep CLI's frames match the root
render_final_sweep.py's with the text drawn by neither (the glyphs are the
port's own, tests/test_torch_viz.py).
"""

import json
import os
import pickle
import stat
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image, ImageDraw
from scipy.spatial.transform import Rotation

import acezero_tpu.cli.export_cli as jcli
import acezero_tpu.export.nerfstudio_runner as jrunner
from acezero_tpu.export.cameras import export_camera_meshes as j_cameras
from acezero_tpu.export.nerf import export_transforms_json as j_transforms
from acezero_tpu.io.pose_files import PoseFileEntry, write_pose_file
from acezero_tpu.io.ply import write_ply_points as j_write_ply
from acezero_tpu.models import torch_io as jio
from acezero_tpu.models.head import HeadConfig as JHeadConfig
from acezero_tpu.models.head import init_head_params as j_init_head
from acezero_tpu.viz import ReconstructionVisualizer as JVisualizer
from acezero_tpu.viz import VizConfig as JVizConfig
import acezero_tpu_torch.cli.export_cli as tcli
import acezero_tpu_torch.export.nerfstudio_runner as trunner
from acezero_tpu_torch.cli import render_final_sweep_cli
from acezero_tpu_torch.data.images import read_png
from acezero_tpu_torch.export.cameras import export_camera_meshes as t_cameras
from acezero_tpu_torch.export.nerf import export_transforms_json as t_transforms
from acezero_tpu_torch.io.ply import read_ply_points
from acezero_tpu_torch.viz import overlay as tov

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_nerfstudio_runner import NS_EVAL_STUB, NS_TRAIN_STUB  # noqa: E402

ENCODER = Path(__file__).resolve().parents[1] / "weights" / "tpu_encoder_v6.pt"
COORD_TOL = 1e-3  # tests/test_torch_export.py
COMMON_SHARE = 0.9  # tests/test_torch_export.py
MATRIX_TOL = 1e-12


def _entries(files, seed=0, conf=lambda i: 2000.0 if i % 3 else 10.0):
    rng = np.random.default_rng(seed)
    out = []
    for i, f in enumerate(files):
        pose = np.eye(4)
        pose[:3, :3] = Rotation.random(random_state=np.random.RandomState(seed + i)).as_matrix()
        pose[:3, 3] = rng.normal(size=3)
        out.append(PoseFileEntry(str(f), pose, 500.0 + i, conf(i)))
    return out


@pytest.fixture
def pose_scene(tmp_path):
    rng = np.random.default_rng(1)
    files = []
    for i in range(16):
        p = tmp_path / f"img_{i:03d}.png"
        Image.fromarray(rng.integers(0, 256, (48, 64)).astype(np.uint8)).save(p)
        files.append(p)
    entries = _entries(files[:14])  # two frames without a pose
    write_pose_file(tmp_path / "poses_final.txt", entries)
    return tmp_path, tmp_path / "poses_final.txt", entries


def _assert_transforms_equal(got: dict, want: dict) -> None:
    mats = [np.array([f.pop("transform_matrix") for f in d["frames"]]) for d in (got, want)]
    assert got == want
    np.testing.assert_allclose(mats[0], mats[1], rtol=0, atol=MATRIX_TOL)


def test_camera_meshes_byte_equal(tmp_path, pose_scene):
    _, _, entries = pose_scene
    for size, cmax in ((0.03, 2000.0), (0.2, 500.0)):
        j_cameras(tmp_path / "j.ply", entries, size, cmax)
        t_cameras(tmp_path / "t.ply", entries, size, cmax)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("case", ["default_split", "split_file", "point_cloud"])
def test_transforms_json_equal(case, pose_scene, tmp_path):
    scene, pose_file, entries = pose_scene
    split = None
    if case == "split_file":
        files = sorted(str(p) for p in scene.glob("img_*.png"))
        split = tmp_path / "split.json"
        split.write_text(json.dumps({"train_filenames": files[:12], "test_filenames": files[12:]}))
    if case == "point_cloud":
        j_write_ply(scene / "pc_final.ply", np.ones((5, 3), np.float32), np.ones((5, 3), np.uint8))
    out_j = j_transforms(pose_file, str(scene / "img_*.png"), tmp_path / "j", split_file=split)
    out_t = t_transforms(pose_file, str(scene / "img_*.png"), tmp_path / "t", split_file=split)
    got, want = json.loads(out_t.read_text()), json.loads(out_j.read_text())
    _assert_transforms_equal(got, want)
    assert len(got["frames"]) == 16
    assert ("ply_file_path" in got) == (case == "point_cloud")
    if case == "point_cloud":
        assert (tmp_path / "t" / "pc_final.ply").read_bytes() == (scene / "pc_final.ply").read_bytes()


@pytest.fixture
def stub_bin(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    for name, body in (("ns-train", NS_TRAIN_STUB), ("ns-eval", NS_EVAL_STUB)):
        script = bindir / name
        script.write_text(body.format(bindir=bindir))
        script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    return bindir


def _run_both(runner_args, stub_bin, tmp_path, **cfg):
    """Both runners on one scene; the stubs' argv with the output folder
    replaced by a marker, the results and transforms.json of each."""
    out = {}
    for name, mod in (("j", jrunner), ("t", trunner)):
        res = mod.run_benchmark(*runner_args, tmp_path / f"out_{name}", mod.NerfBenchmarkConfig(**cfg))
        argv = [(stub_bin / f"ns_{k}_argv.txt").read_text().replace(str(tmp_path / f"out_{name}"), "OUT")
                for k in ("train", "eval")]
        transforms = json.loads((tmp_path / f"out_{name}" / "transforms.json").read_text())
        out[name] = (res, argv, transforms)
    return out


@pytest.mark.parametrize("method,max_test", [("nerfacto", 1000), ("splatfacto", 1)])
def test_runner_argv_and_results_equal(method, max_test, stub_bin, pose_scene, tmp_path):
    scene, pose_file, _ = pose_scene
    out = _run_both((pose_file, str(scene / "img_*.png")), stub_bin, tmp_path, method=method,
                    max_test_images=max_test)
    assert out["t"][:2] == out["j"][:2]
    assert out["t"][0] == {"psnr": 24.5, "ssim": 0.81, "lpips": 0.21}
    _assert_transforms_equal(out["t"][2], out["j"][2])


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_runner_downscales_a_wide_png_to_pils_pixels(mode, stub_bin, tmp_path):
    scene = tmp_path / "wide"
    scene.mkdir()
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[:300, :900]
    files = []
    for i in range(3):
        rgb = np.stack([(xx + 7 * i) % 256, (yy * 3) % 256, (xx + yy) % 256], -1) + rng.integers(0, 9, (300, 900, 3))
        img = Image.fromarray(np.clip(rgb, 0, 255).astype(np.uint8)).convert(mode)
        files.append(scene / f"f{i}.png")
        img.save(files[-1])
    write_pose_file(scene / "poses.txt", _entries(files, conf=lambda i: 2000.0))
    out = _run_both((scene / "poses.txt", str(scene / "f*.png")), stub_bin, tmp_path)
    frames_t, frames_j = out["t"][2]["frames"], out["j"][2]["frames"]
    _assert_transforms_equal({"frames": [{k: v for k, v in f.items() if k != "file_path"} for f in frames_t]},
                             {"frames": [{k: v for k, v in f.items() if k != "file_path"} for f in frames_j]})
    assert frames_t[0]["w"] == 640 and frames_t[0]["h"] == 213
    for ft, fj in zip(frames_t, frames_j):
        assert np.array_equal(read_png(ft["file_path"]), np.asarray(Image.open(fj["file_path"])))


def test_runner_missing_cli_and_jpeg_downscale(pose_scene, tmp_path, monkeypatch):
    scene, pose_file, _ = pose_scene
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="ns-train"):
        trunner.run_benchmark(pose_file, str(scene / "img_*.png"), tmp_path / "o")
    big = tmp_path / "jpg"
    big.mkdir()
    Image.fromarray(np.zeros((20, 700, 3), np.uint8)).save(big / "a.jpg")
    write_pose_file(big / "poses.txt", _entries([big / "a.jpg"], conf=lambda i: 2000.0))
    with pytest.raises(ValueError, match="no JPEG codec"):
        trunner.run_benchmark(big / "poses.txt", str(big / "*.jpg"), tmp_path / "o2")


# ------------------------------------------------------------- export_cli


def _flags(parser):
    return {a.dest: (a.option_strings, a.default, getattr(a.type, "__name__", a.type), a.choices)
            for a in parser._actions if a.dest != "help"}


def _jax_parser(main, monkeypatch):
    """The parser a JAX CLI's main builds, caught at its parse_args."""
    import argparse

    seen = {}

    def catch(self, *a, **k):
        seen["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(SystemExit):
        main([])
    monkeypatch.undo()
    return seen["parser"]


def test_export_cli_flags_match_jax(monkeypatch):
    f_t = _flags(tcli.build_point_cloud_parser())
    assert f_t.pop("device") == (["--device"], "cuda", "str", None)
    assert f_t == _flags(_jax_parser(jcli.point_cloud_main, monkeypatch))
    assert _flags(tcli.build_cameras_parser()) == _flags(_jax_parser(jcli.cameras_main, monkeypatch))
    with pytest.raises(SystemExit):
        tcli.main(["nope"])


def test_visualization_buffer_ply_byte_equal(tmp_path):
    viz = JVisualizer(JVizConfig(target_path=tmp_path / "r", frame_h=8, frame_w=8))
    rng = np.random.default_rng(3)
    viz.update_point_cloud(rng.normal(size=(40, 3)).astype(np.float32), rng.integers(0, 256, (40, 3)).astype(np.uint8))
    viz.save_state(tmp_path / "state.pkl")
    for conv in ("opencv", "opengl"):
        args = ["--visualization_buffer", str(tmp_path / "state.pkl"), "--convention", conv]
        assert jcli.point_cloud_main([str(tmp_path / "j.ply"), *args]) == 0
        assert tcli.main(["point_cloud", str(tmp_path / "t.ply"), *args]) == 0
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    xyz, _ = read_ply_points(tmp_path / "t.ply")
    with open(tmp_path / "state.pkl", "rb") as f:
        want = pickle.load(f)["cloud_xyz"] * np.float32([1, -1, -1])
    assert np.array_equal(xyz, want)


def test_cameras_cli_byte_equal(pose_scene, tmp_path):
    _, pose_file, entries = pose_scene
    args = ["--marker_size", "0.1", "--confidence_max", "1500"]
    assert jcli.cameras_main([str(pose_file), str(tmp_path / "j.ply"), *args]) == 0
    assert tcli.main(["cameras", str(pose_file), str(tmp_path / "t.ply"), *args]) == 0
    data = (tmp_path / "t.ply").read_bytes()
    assert data == (tmp_path / "j.ply").read_bytes()
    assert f"element vertex {5 * len(entries)}".encode() in data and f"element face {6 * len(entries)}".encode() in data


def test_network_route_within_tolerance(tmp_path):
    """--network on the CPU: the JAX CLI's cloud, up to the coordinates'
    bf16 rounding."""
    rng = np.random.default_rng(32)
    yy, xx = np.mgrid[:75, :101]
    files = []
    for i in range(4):
        rgb = np.stack([(xx * (3 + i)) % 256, (yy * 5 + 40 * i) % 256, ((xx + yy) * 2) % 256], -1)
        files.append(tmp_path / f"frame_{i}.png")
        Image.fromarray(np.clip(rgb + rng.integers(-25, 25, rgb.shape), 0, 255).astype(np.uint8)).save(files[-1])
    entries = []
    for i, f in enumerate(files):
        w2c = np.eye(4)
        w2c[:3, 3] = rng.normal(size=3) * 0.1
        entries.append(PoseFileEntry(str(f), np.linalg.inv(w2c), 60.0 + i, 2000.0))
    write_pose_file(tmp_path / "poses.txt", entries)
    head = jax.device_get(j_init_head(jax.random.PRNGKey(3), JHeadConfig(), np.array([0.1, -0.2, 2.0])))
    jio.save_head(tmp_path / "head.pt", head, JHeadConfig())
    args = ["--network", str(tmp_path / "head.pt"), "--pose_file", str(tmp_path / "poses.txt"),
            "--encoder_path", str(ENCODER), "--image_resolution", "56"]
    assert jcli.point_cloud_main([str(tmp_path / "j.ply"), *args]) == 0
    assert tcli.main(["point_cloud", str(tmp_path / "t.ply"), *args, "--device", "cpu"]) == 0
    xyz_j, rgb_j = read_ply_points(tmp_path / "j.ply")
    xyz_t, rgb_t = read_ply_points(tmp_path / "t.ply")
    assert len(xyz_t) == len(xyz_j) > 0 and np.isfinite(xyz_t).all()
    extent = np.abs(xyz_j).max()
    near = np.linalg.norm(xyz_t[:, None] - xyz_j[None], axis=-1).min(axis=1) <= COORD_TOL * extent
    assert near.mean() >= COMMON_SHARE


# --------------------------------------------------------- final sweep


def test_final_sweep_cli_matches_root_script(tmp_path, monkeypatch):
    """tests/test_render_sweep_cli.py's fixture through both CLIs: the same
    frames, bit for bit with the text drawn by neither package."""
    rng = np.random.default_rng(4)
    folders = {}
    for name in ("j", "t"):
        out = tmp_path / name / "results"
        render_path = out / "renderings"
        render_path.mkdir(parents=True)
        entries = _entries([f"f{i:02d}.png" for i in range(6)], seed=1, conf=lambda i: 800.0 if i % 2 else 100.0)
        write_pose_file(out / "poses_iteration1.txt", entries[:4])
        write_pose_file(out / "poses_iteration2.txt", entries)
        viz = JVisualizer(JVizConfig(target_path=render_path, frame_h=90, frame_w=120))
        viz.update_point_cloud(np.random.default_rng(5).normal(size=(200, 3)).astype(np.float32),
                               np.full((200, 3), 128, np.uint8))
        viz.save_state(render_path / "iteration2_register.pkl")
        folders[name] = render_path
    monkeypatch.setattr(ImageDraw.ImageDraw, "text", lambda *a, **k: None)
    monkeypatch.setattr(tov, "_text", lambda *a, **k: None)
    from render_final_sweep import main as j_main

    assert j_main([str(folders["j"]), "--num_frames", "3"]) == 0
    assert render_final_sweep_cli.main([str(folders["t"]), "--num_frames", "3", "--device", "cpu"]) == 0
    names = sorted(p.name for p in folders["t"].glob("frame_*.png"))
    assert names == sorted(p.name for p in folders["j"].glob("frame_*.png")) and len(names) == 3
    for n in names:
        got, want = read_png(folders["t"] / n), np.asarray(Image.open(folders["j"] / n))
        assert got.shape == (720, 1280, 3) and np.array_equal(got, want)
