"""The port's mapping CLI against acezero_tpu's: the same flags and
defaults, a head checkpoint each package reads from the other, and the
preliminary pose file in the JAX writer's format."""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from acezero_tpu.cli import train_ace_cli as jcli
from acezero_tpu.io import pose_files as jpf
from acezero_tpu.models import torch_io as jio
from acezero_tpu_torch.cli import train_ace_cli as tcli
from acezero_tpu_torch.models import torch_io as tio
from acezero_tpu_torch.models.head import HeadConfig, init_head_params

SCENE = Path(__file__).resolve().parents[1] / "results" / "heldout" / "scenes" / "chesslike_a"


def _options(parser):
    out = {}
    for a in parser._actions:
        if a.dest == "help":
            continue
        out[a.dest] = (tuple(a.option_strings), a.default, a.type.__name__ if a.type else None,
                       tuple(a.choices) if a.choices else None, a.nargs)
    return out


def test_flags_match_jax_parser():
    j, t = _options(jcli.build_parser()), _options(tcli.build_parser())
    assert t.pop("device") == (("--device",), "cuda", "str", None, None)
    assert t == j
    args = tcli.build_parser().parse_args(["a/*.png", "out.pt"])
    assert args.device == "cuda" and args.iterations == 25000 and args.batch_size == 5120


def test_training_buffer_cpu_matches_device_buffer(tmp_path):
    """--training_buffer_cpu true trains from the host-spill buffer: the same
    rows drawn by the same generator calls, so the same head bits as the
    device buffer (here both on the CPU)."""
    heads = []
    for flag in ("false", "true"):
        out = tmp_path / f"map_{flag}.pt"
        result = tcli.main([
            f"{SCENE}/frame_000[0-1].png", str(out), "--pose_files", f"{SCENE}/frame_000[0-1]_pose.txt",
            "--use_external_focal_length", "520", "--encoder_path", "weights/tpu_encoder_v6.pt",
            "--image_resolution", "64", "--samples_per_image", "32", "--batch_size", "64", "--iterations", "6",
            "--num_head_blocks", "0", "--training_buffer_cpu", flag, "--device", "cpu"])
        assert result["iterations"] == 6
        heads.append(tio.load_state_dict(out))
    assert heads[0].keys() == heads[1].keys()
    assert all(torch.equal(heads[0][k], heads[1][k]) for k in heads[0])


def test_cpu_run_writes_head_and_poses(tmp_path):
    out = tmp_path / "map.pt"
    result = tcli.main([
        f"{SCENE}/frame_000[0-2].png", str(out), "--pose_files", f"{SCENE}/frame_000[0-2]_pose.txt",
        "--use_external_focal_length", "520", "--encoder_path", "weights/tpu_encoder_v6.pt",
        "--image_resolution", "96", "--samples_per_image", "64", "--batch_size", "128", "--iterations", "8",
        "--learning_rate_schedule", "1cyclepoly", "--learning_rate_warmup_iterations", "2",
        "--learning_rate_cooldown_iterations", "4", "--pose_refinement", "mlp", "--refine_calibration", "true",
        "--device", "cpu"])
    assert result["iterations"] == result["steps"] == 8
    # the JAX package reads the port's head to the same (fp16) values
    cfg_j, params_j = jio.load_head(out)
    cfg_t, params_t = tio.load_head(out)
    assert cfg_j.num_head_blocks == cfg_t.num_head_blocks == 1 and cfg_j.use_homogeneous
    trained = result["head_params"]
    np.testing.assert_array_equal(params_j["fc1"]["w"], params_t["fc1"]["w"].numpy())
    np.testing.assert_array_equal(params_j["blocks"][0]["c2"]["b"], params_t["blocks"][0]["c2"]["b"].numpy())
    np.testing.assert_array_equal(params_j["mean"], params_t["mean"].numpy())
    np.testing.assert_array_equal(params_t["fc3"]["w"].numpy(),
                                  trained["fc3"]["w"].detach().half().float().numpy())
    # the preliminary poses: the JAX writer's line for every entry
    lines = (tmp_path / "poses_map_preliminary.txt").read_text().splitlines()
    assert len(lines) == 3
    files = sorted(str(p) for p in SCENE.glob("frame_000[0-2].png"))
    for i, (line, entry) in enumerate(zip(lines, jpf.read_pose_file(tmp_path / "poses_map_preliminary.txt"))):
        assert len(line.split()) == 10 and math.isinf(entry.confidence) and entry.rgb_file == files[i]
        pose = np.vstack([result["poses_w2c"][i], [0, 0, 0, 1]])
        assert line + "\n" == jpf.format_pose_line(files[i], pose, result["focal_orig"], float("inf"))


@pytest.mark.parametrize("half", [True, False])
def test_head_files_cross_both_ways(tmp_path, half):
    cfg = HeadConfig(num_head_blocks=2)
    params = init_head_params(torch.Generator().manual_seed(1), cfg, [0.5, -1.0, 2.0])
    tio.save_head(tmp_path / "port.pt", params, cfg, half=half)
    sd_t = torch.load(tmp_path / "port.pt", weights_only=True)
    cfg_j, params_j = jio.load_head(tmp_path / "port.pt")
    assert cfg_j == jio.import_head_state_dict(jio.load_state_dict(tmp_path / "port.pt"))[0]
    assert cfg_j.num_head_blocks == 2
    cast = (lambda t: t.half().float()) if half else (lambda t: t)
    np.testing.assert_array_equal(params_j["blocks"][1]["c0"]["w"], cast(params["blocks"][1]["c0"]["w"]).numpy())
    # the JAX writer's file for the same parameters has the same keys, types and values
    jio.save_head(tmp_path / "jax.pt", params_j, cfg_j, half=half)
    sd_j = torch.load(tmp_path / "jax.pt", weights_only=True)
    assert sd_t.keys() == sd_j.keys()
    for k in sd_t:
        assert sd_t[k].dtype == sd_j[k].dtype and torch.equal(sd_t[k], sd_j[k]), k
    # and the port reads the JAX package's file
    cfg_t2, params_t2 = tio.load_head(tmp_path / "jax.pt")
    assert (cfg_t2.num_head_blocks, cfg_t2.use_homogeneous) == (2, True)
    assert cfg_t2.homogeneous_min_scale == pytest.approx(cfg.homogeneous_min_scale, rel=1e-3)
    np.testing.assert_array_equal(params_t2["fc2"]["b"].numpy(), cast(params["fc2"]["b"]).numpy())


def test_scene_branches_match_jax(tmp_path):
    """load_scene's ACE-pose-file and pose-seed branches, mean_camera_center
    and subset, against acezero_tpu/data/scene.py."""
    from acezero_tpu.data.scene import load_scene as j_load_scene
    from acezero_tpu_torch.data.scene import load_scene as t_load_scene

    rgb = f"{SCENE}/frame_000[0-5].png"
    files = sorted(str(p) for p in SCENE.glob("frame_000[0-5].png"))
    entries = [jpf.PoseFileEntry(f, np.linalg.inv(np.loadtxt(f[:-4] + "_pose.txt")), 500.0 + i, 800.0 + 100 * i)
               for i, f in enumerate(files)]
    jpf.write_pose_file(tmp_path / "poses.txt", entries)
    for kw in (dict(ace_pose_file=tmp_path / "poses.txt", ace_pose_file_conf_threshold=1000.0),
               dict(pose_files=f"{SCENE}/frame_000[0-5]_pose.txt", pose_seed=0.5, external_focal_length=520.0)):
        want = j_load_scene(rgb, image_short_size=120, num_workers=2, **kw)
        got = t_load_scene(rgb, image_short_size=120, num_workers=2, **kw)
        assert got.rgb_files == want.rgb_files
        for name in ("poses_c2w", "pose_valid", "focals_canvas", "focals_orig"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        np.testing.assert_array_equal(got.images.canvases, want.images.canvases)
        np.testing.assert_array_equal(got.mean_camera_center(), want.mean_camera_center())
        assert got.principal_point == want.principal_point
    full_t = t_load_scene(rgb, pose_files=f"{SCENE}/frame_000[0-5]_pose.txt", image_short_size=120,
                          external_focal_length=520.0, num_workers=2)
    full_j = j_load_scene(rgb, pose_files=f"{SCENE}/frame_000[0-5]_pose.txt", image_short_size=120,
                          external_focal_length=520.0, num_workers=2)
    full_t.depth_maps[4] = full_j.depth_maps[4] = np.ones((2, 2), np.float32)
    sub_t, sub_j = full_t.subset([4, 1]), full_j.subset(np.array([4, 1]))
    assert sub_t.rgb_files == sub_j.rgb_files and list(sub_t.depth_maps) == list(sub_j.depth_maps) == [0]
    np.testing.assert_array_equal(sub_t.images.canvases, sub_j.images.canvases)
    np.testing.assert_array_equal(sub_t.poses_c2w, sub_j.poses_c2w)
