"""The port's reconstruction loop (AceZeroPipeline) against acezero_tpu's.

(a) the config's fields and defaults; (b) control flow: both pipelines run
with MappingTrainer, register_frames and loop_close_entries replaced by
fakes that replay a script of registration rates and loop-closure
outcomes, and their call logs, artifact names and poses_final.txt must be
equal, with loop closure off and on (no drift, a drift-free probe and its
memo, drift drained by a cycle, drift not drained with the final graph
choice; learned seed depth, calibration files, point-cloud export and the
host-spill buffer); (c) the mini loop of tests/test_pipeline_e2e.py:32 (loop
closure off, as there) through the port's CLI on the CPU and through the
JAX pipeline on one device; (d, slow) that loop's spread over base seeds;
(e) the branch the port leaves out (rendering) raises at construction. The
parallel seed path (early seed selection, register_frames_multi) runs for
real at a tiny size.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import acezero_tpu.data.depth as jdepth
import acezero_tpu.export.point_cloud as jexport
import acezero_tpu.reconstruct.loopclose as jlc
import acezero_tpu.reconstruct.pipeline as jpipe
from acezero_tpu.evalpose import evaluate_poses as j_evaluate
from acezero_tpu.io.pose_files import load_pose_files_glob
from acezero_tpu.io.pose_files import read_pose_file as j_read
from acezero_tpu.reconstruct import AceZeroConfig as JConfig
from acezero_tpu.reconstruct import AceZeroPipeline as JPipeline
import acezero_tpu_torch.reconstruct.pipeline as tpipe
from acezero_tpu_torch.cli import ace_zero_cli
from acezero_tpu_torch.evalpose import evaluate_poses as t_evaluate
from acezero_tpu_torch.io.pose_files import read_pose_file
from acezero_tpu_torch.reconstruct import AceZeroConfig, AceZeroPipeline

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synthetic import render_room_scene  # noqa: E402

N = 10
# tests/test_pipeline_e2e.py:32, the mini reconstruction loop
MINI = dict(try_seeds=1, seed_iterations=20, iterations=30, iterations_max=2, learning_rate_schedule="constant",
            learning_rate_min=0.003, max_training_buffer_size=2048, samples_per_image=128, max_dataset_passes=2,
            batch_size=128, chunk_steps=10, num_head_blocks=0, ransac_iterations=8, registration_confidence=5,
            registration_frame_chunk=8, refinement_steps=2, final_refine=False, final_refit=False,
            loop_closure=False)
# the flags of MINI the CLI has; the rest go in as overrides
MINI_FLAGS = ["--try_seeds", "1", "--seed_iterations", "20", "--iterations", "30", "--iterations_max", "2",
              "--learning_rate_schedule", "constant", "--max_dataset_passes", "2", "--num_head_blocks", "0",
              "--ransac_iterations", "8", "--registration_confidence", "5", "--final_refine", "false",
              "--final_refit", "false", "--loop_closure", "false"]
MINI_OVERRIDES = dict(learning_rate_min=0.003, max_training_buffer_size=2048, samples_per_image=128,
                      batch_size=128, chunk_steps=10, registration_frame_chunk=8, refinement_steps=2)
# Registration rate (10 frames, confidence 5) of the mini loop's every round,
# over base seeds 2089-2094 on the CPU: JAX 0.3-0.6, the port 0.3-0.7
# (test_mini_loop_spread prints three seeds of each). A 20-step seed map and
# one 30-step round leave most frames near the bar, so both packages are
# held to [0.2, 0.8]: the same loop can land anywhere in it, and a broken
# round (no training, wrong poses or focals) registers nothing. The poses
# are too rough to align at this size (no valid alignment hypothesis in any
# seed of either package: accuracy 0).
RATE_BAND = (0.2, 0.8)
# the JAX pipeline on one device, its decoded-canvas cache off
JAX_ONLY = dict(num_devices=1, decode_cache_dir=None)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("scene")
    data = render_room_scene(N, h=96, w=128)
    for i in range(N):
        Image.fromarray(data["images_u8"][i]).save(out / f"frame_{i:03d}.png")
        np.save(out / f"frame_{i:03d}_depth.npy", data["depth"][i])
        np.savetxt(out / f"frame_{i:03d}_pose.txt", data["poses_c2w"][i])
    return out, data["focal"]


def _scene_kw(scene_dir, folder):
    path, focal = scene_dir
    return dict(rgb_files=str(path / "*.png"), results_folder=folder, depth_files=str(path / "*_depth.npy"),
                use_external_focal_length=float(focal))


# ------------------------------------------------------------- (a) config


def test_config_fields_and_defaults_match_jax():
    """Same names, order and defaults; the one exception is the decode
    cache's per-user default (ROADMAP.md section 3)."""
    fj = {f.name: f for f in dataclasses.fields(JConfig)}
    ft = {f.name: f for f in dataclasses.fields(AceZeroConfig)}
    assert list(ft) == list(fj)
    differ = [n for n in fj if (fj[n].default, fj[n].default_factory) != (ft[n].default, ft[n].default_factory)]
    assert differ == ["decode_cache_dir"]
    assert AceZeroConfig().decode_cache_dir != JConfig().decode_cache_dir


def test_cli_flags_match_jax():
    from acezero_tpu.cli import ace_zero_cli as jcli

    def flags(parser):
        return {a.dest: (a.option_strings, a.default) for a in parser._actions if a.dest != "help"}

    f_j, f_t = flags(jcli.build_parser()), flags(ace_zero_cli.build_parser())
    assert f_t.pop("device") == (["--device"], "cuda")
    assert f_t == f_j
    args = ace_zero_cli.build_parser().parse_args(["g", "o", "--loop_closure", "false", "--iterations", "7"])
    cfg_t, cfg_j = vars(ace_zero_cli.config_from_args(args)), vars(jcli.config_from_args(args))
    cfg_t.pop("decode_cache_dir"), cfg_j.pop("decode_cache_dir")
    assert cfg_t == cfg_j


# ------------------------------------------------------- (b) control flow


class _Script:
    """The fakes of one run: a trainer, a registration driver that replays
    `rates` (one per registration call) and a loop closure that replays
    `drift` (one outcome per call: True measures drift and moves every
    pose by a 1000-unit marker), logging every call."""

    def __init__(self, rates, drift=()):
        self.rates = list(rates)
        self.drift = list(drift)
        self.calls = []
        self.heads = 0

    def loop_close(self, encoder_params, head_params, head_cfg, scene, entries, conf_threshold,
                   focal_override_orig=None, cfg=None, max_frames=256, **_kw):
        self.calls.append({
            "call": "loop_close", "head": head_params["id"], "frames": len(entries), "confidence": conf_threshold,
            "focal_override": focal_override_orig, "ba": None if cfg is None else cfg.ba, "max_frames": max_frames,
        })
        if not self.drift.pop(0):
            return entries, {"edges": 12, "median_corr_t": 0.001, "median_corr_rot_deg": 0.01, "scene_diag": 1.0}
        moved = []
        for e in entries:
            pose = e.pose_w2c.copy()
            pose[0, 3] += 1000.0
            moved.append(dataclasses.replace(e, pose_w2c=pose))
        return moved, {"edges": 12, "median_corr_t": 1.0, "median_corr_rot_deg": 2.0, "scene_diag": 1.0}

    def trainer(self, scene, encoder_params, head_cfg, cfg, buffer_cfg, head_params=None, base_seed=0,
                **_kw):
        script = self
        self.calls.append({
            "call": "train", "frames": len(scene), "iterations": cfg.schedule.iterations,
            "schedule": cfg.schedule.schedule, "lr_max": cfg.schedule.learning_rate_max,
            "warmup": cfg.schedule.warmup_iterations, "loss": cfg.loss.loss_type,
            "loss_iterations": cfg.loss.total_iterations, "refinement": cfg.pose_refinement,
            "pose_wait": cfg.pose_refinement_wait, "refine_calibration": cfg.refine_calibration,
            "use_depth": cfg.use_depth, "initial_head": None if head_params is None else head_params["id"],
            "base_seed": base_seed, "batch": cfg.batch_size, "chunk": cfg.chunk_steps,
            "buffer": dataclasses.astuple(buffer_cfg)[:6], "host_spill": cfg.buffer_host_spill,
            "focals": [float(f) for f in scene.focals_orig],
        })

        class Trainer:
            def train(self):
                script.heads += 1
                n = len(scene)
                return {"head_params": {"id": script.heads}, "poses_w2c": np.tile(np.eye(3, 4), (n, 1, 1)),
                        "focal_orig": 100.0 + script.heads if cfg.refine_calibration else None}

        return Trainer()

    def depth(self, head_path, encoder_params=None, **_kw):
        """A learned estimator: logs its head, then each image it sees."""
        self.calls.append({"call": "depth_head", "head": Path(head_path).name})

        def estimate(rgb):
            self.calls.append({"call": "depth", "rgb": list(rgb.shape), "sum": int(rgb.astype(np.int64).sum())})
            return np.full(rgb.shape[:2], 2.0)

        return estimate

    def export(self, path, encoder_params, head_params, head_cfg, scene, entries, dense=False, **_kw):
        self.calls.append({"call": "export", "path": Path(path).name, "head": head_params["id"],
                           "frames": len(entries), "dense": dense})

    def register(self, encoder_params, head_params, head_cfg, scene, cfg, focal_override_orig=None, **_kw):
        self.calls.append({
            "call": "register", "head": head_params["id"], "focal_override": focal_override_orig,
            "max_estimates": cfg.max_estimates, "hypotheses": cfg.ransac.hypotheses,
            "refinement_steps": cfg.ransac.refinement_steps, "refit_tier1": cfg.refit_tier1,
            "confidence": cfg.confidence_threshold, "chunk": cfg.frame_chunk, "seed": cfg.base_seed,
        })
        k = int(round(self.rates.pop(0) * len(scene)))
        focal = focal_override_orig if focal_override_orig is not None else float(scene.focals_orig[0])
        return [tpipe.PoseFileEntry(f, np.eye(4), focal, 1000.0 if i < k else 0.0)
                for i, f in enumerate(scene.rgb_files)]


class _FakeIO:
    """torch_io with heads written as empty files named by the pipeline."""

    @staticmethod
    def save_head(path, params, cfg, *a, **kw):
        Path(path).write_text(str(params["id"]))

    @staticmethod
    def load_head(path, *a, **kw):
        return None, {"id": 0}


LC = {"loop_closure": True, "iterations_max": 10}
CASES = {
    # rates: seed fastcheck, seed map on all frames, then one per round;
    # with loop closure on, one outcome per loop_close_entries call
    "registration_threshold": ({"iterations_max": 10}, [0.3, 0.3, 0.995, 0.9]),
    "relative_threshold": ({"iterations_max": 10}, [0.3, 0.3, 0.5, 0.505, 0.6]),
    "iterations_max": ({"iterations_max": 4}, [0.1, 0.1, 0.3, 0.5, 0.7]),
    "no_final_refine": ({"iterations_max": 10, "final_refine": False}, [0.3, 0.3, 0.6, 0.995]),
    "no_final_refit": ({"iterations_max": 10, "final_refit": False}, [0.3, 0.3, 0.995, 0.9]),
    "refit_cycles": ({"iterations_max": 10, "final_refit_cycles": 2}, [0.3, 0.3, 0.995, 0.9, 0.95]),
    "seed_network": ({"iterations_max": 10, "seed_network": "seed.pt"}, [0.4, 0.995, 0.9]),
    # measured before the refit and after it: no drift either time
    "lc_no_drift": (LC, [0.3, 0.3, 0.995, 0.9], [False, False]),
    # a drift-free probe on 2 frames; the refit keeps registration, so the
    # probe memo skips the measurement after it
    "lc_probe_memo": ({**LC, "loop_closure_probe_frames": 2}, [0.3, 0.3, 0.995, 0.995], [False]),
    # drift before the refit (poses frozen), drift again (one adaptive cycle),
    # then none: converged, registration poses kept
    "lc_drift_drained": (LC, [0.3, 0.3, 0.995, 0.9, 0.95], [True, True, False]),
    # drift never drained: the cycle cap ends the cycles and the final
    # measurement's corrected graph becomes poses_final.txt
    "lc_final_graph": ({**LC, "adaptive_refit_max_cycles": 1, "loopclose_final_graph": True},
                       [0.3, 0.3, 0.995, 0.9, 0.95], [True, True, True]),
    # no depth files: the learned seed-depth head (v4) on each seed frame
    "learned_depth": ({"iterations_max": 10, "depth_files": None}, [0.3, 0.3, 0.995, 0.9]),
    # per-frame focal files instead of an external focal
    "calibration_files": ({"iterations_max": 10, "use_external_focal_length": -1, "calibration_files": "calib"},
                          [0.3, 0.3, 0.995, 0.9]),
    "export": ({"iterations_max": 10, "export_point_cloud": True, "dense_point_cloud": True},
               [0.3, 0.3, 0.995, 0.9]),
    "host_spill": ({"iterations_max": 10, "training_buffer_cpu": True}, [0.3, 0.3, 0.995, 0.9]),
}


def _flow(module, lc_module, pipeline_cls, config_cls, kw, rates, drift, monkeypatch, folder, **init):
    script = _Script(rates, drift)
    monkeypatch.setattr(module, "MappingTrainer", script.trainer)
    monkeypatch.setattr(module, "register_frames", script.register)
    monkeypatch.setattr(module, "torch_io", _FakeIO)
    monkeypatch.setattr(lc_module, "loop_close_entries", script.loop_close)
    # the JAX pipeline imports these where it calls them, the port at the top
    monkeypatch.setattr(jdepth if module is jpipe else module, "learned_depth_estimator", script.depth)
    monkeypatch.setattr(jexport if module is jpipe else module, "export_point_cloud_from_network", script.export)
    cfg = config_cls(**{**kw, "results_folder": folder})
    result = pipeline_cls(cfg, encoder_params={}, **init).run()
    assert not script.rates, "the script has rates left over"
    assert not script.drift, "the script has loop-closure outcomes left over"
    return script.calls, sorted(p.name for p in folder.iterdir()), result


@pytest.mark.parametrize("case", sorted(CASES))
def test_control_flow_matches_jax(case, scene_dir, tmp_path, monkeypatch):
    over, rates, *drift = CASES[case]
    drift = drift[0] if drift else []
    kw = {**_scene_kw(scene_dir, None), "try_seeds": 1, "loop_closure": False, "seed_iterations": 321,
          "iterations": 654, "refit_iterations": 987, "final_refit_posewait": 55, "cooldown_iterations": 40,
          "learning_rate_warmup_iterations": 30, **over}
    if "seed_network" in over:
        kw["seed_network"] = tmp_path / "seed.pt"
    if "calibration_files" in over:
        (tmp_path / "calib").mkdir()
        for i in range(N):
            (tmp_path / "calib" / f"c{i:03d}.txt").write_text(f"{90.0 + i}\n")
        kw["calibration_files"] = str(tmp_path / "calib" / "*.txt")
    calls_j, files_j, res_j = _flow(jpipe, jlc, JPipeline, JConfig, {**kw, **JAX_ONLY}, rates, drift, monkeypatch,
                                    tmp_path / "j")
    calls_t, files_t, res_t = _flow(tpipe, tpipe, AceZeroPipeline, AceZeroConfig, kw, rates, drift, monkeypatch,
                                    tmp_path / "t", device="cpu")
    assert calls_t == calls_j
    assert files_t == files_j
    assert "poses_final.txt" in files_t
    lc_calls = [c for c in calls_t if c["call"] == "loop_close"]
    assert len(lc_calls) == len(drift)
    refits = [c["pose_wait"] for c in calls_t if c["call"] == "train" and c["loss"] == "dyntanh"]
    final = (tmp_path / "t" / "poses_final.txt").read_text()
    if case == "lc_probe_memo":
        assert lc_calls[0]["ba"] == "off" and lc_calls[0]["max_frames"] == 2
    if case == "lc_drift_drained":
        assert refits == [987, 987] and res_t["iterations"] == 3  # both refits adopt the corrected poses
    if case == "learned_depth":
        heads = [c for c in calls_t if c["call"] in ("depth_head", "depth")]
        assert heads[0] == {"call": "depth_head", "head": "tpu_depth_v4.pt"} and len(heads) == 2
    if case == "calibration_files":
        seed_frame = int(np.random.RandomState(kw.get("random_seed", 1305)).uniform() * N)
        assert calls_t[0]["focals"] == [90.0 + seed_frame]  # the seed frame's own focal file
    if case == "export":
        assert calls_t[-1] == {"call": "export", "path": "pc_final.ply", "head": res_t["head_params"]["id"],
                               "frames": N, "dense": True}
    if case == "host_spill":
        assert all(c["host_spill"] for c in calls_t if c["call"] == "train")
    if case == "lc_final_graph":
        assert "poses_iteration3_loopclosed.txt" in files_t
        assert all(float(ln.split()[5]) == 1000.0 for ln in final.splitlines())
    else:
        assert not any(f.endswith("_loopclosed.txt") for f in files_t)
        assert all(float(ln.split()[5]) == 0.0 for ln in final.splitlines())
    for key in ("iterations", "registration_rates", "rate_history", "focal_estimate", "report"):
        if key == "report":
            assert res_t[key].split("\n")[1].split()[1:] == res_j[key].split("\n")[1].split()[1:]
        else:
            assert res_t[key] == res_j[key], key
    assert (tmp_path / "t" / "poses_final.txt").read_text() == (tmp_path / "j" / "poses_final.txt").read_text()


def test_mapping_scene_fallback_and_drift_gate(scene_dir, tmp_path):
    """_mapping_scene_from_entries keeps the confident frames at their
    registered poses and focals, falls back to the most confident tenth
    when none is confident, and shares the root canvases; _drift_detected
    is the JAX gate."""
    kw = _scene_kw(scene_dir, tmp_path / "t")
    pipe = AceZeroPipeline(AceZeroConfig(**kw), device="cpu", encoder_params={})
    files = pipe.scene.rgb_files
    poses = [np.diag([1.0, 1.0, 1.0, 1.0]) + np.eye(4, k=3) * i for i in range(N)]
    entries = [tpipe.PoseFileEntry(f, poses[i], 100.0 + i, 600.0 if i % 3 == 0 else 100.0)
               for i, f in enumerate(files)]
    sub = pipe._mapping_scene_from_entries(entries)
    assert sub.rgb_files == [files[i] for i in (0, 3, 6, 9)]
    np.testing.assert_allclose(sub.focals_orig, [100, 103, 106, 109])
    np.testing.assert_array_equal(sub.images.content(), pipe.scene.images.canvases[[0, 3, 6, 9]])
    assert not sub.images.canvases.any() and sub.images.canvases.strides[0] == 0
    low = [dataclasses.replace(e, confidence=float(i)) for i, e in enumerate(entries)]
    assert pipe._mapping_scene_from_entries(low).rgb_files == [files[9]]

    jpipe_ = JPipeline(JConfig(**kw, **JAX_ONLY), encoder_params={})
    for diag in ({"skipped": "x"}, {}, {"scene_diag": 10.0, "median_corr_t": 0.049},
                 {"scene_diag": 10.0, "median_corr_t": 0.051}, {"median_corr_t": 0.011},
                 {"median_corr_rot_deg": 0.51}, {"median_corr_rot_deg": 0.5}):
        assert pipe._drift_detected(diag) == jpipe_._drift_detected(diag), diag


# ----------------------------------------------------------- (c) mini loop


def _jax_mini(scene_dir, folder, base_seed=2089):
    cfg = JConfig(**_scene_kw(scene_dir, folder), **MINI, **JAX_ONLY, base_seed=base_seed)
    return JPipeline(cfg).run()


def _cli_mini(scene_dir, folder, *extra, **over):
    path, focal = scene_dir
    argv = [str(path / "*.png"), str(folder), "--depth_files", str(path / "*_depth.npy"),
            "--use_external_focal_length", str(focal), *MINI_FLAGS, "--device", "cpu", *extra]
    return ace_zero_cli.main(argv, **{**MINI_OVERRIDES, **over})


def test_mini_loop_matches_jax(scene_dir, tmp_path):
    """The same artifacts and iteration count, poses_final.txt with the same
    frames in the same order and format, and both packages' registration
    rates (every round) and aligned accuracy within the stated band."""
    res_t = _cli_mini(scene_dir, tmp_path / "t")
    res_j = _jax_mini(scene_dir, tmp_path / "j")
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert res_t["iterations"] == res_j["iterations"] == 1
    lines_t = (tmp_path / "t" / "poses_final.txt").read_text().splitlines()
    lines_j = (tmp_path / "j" / "poses_final.txt").read_text().splitlines()
    assert len(lines_t) == len(lines_j) == N
    assert [ln.split()[0] for ln in lines_t] == [ln.split()[0] for ln in lines_j]
    for lt, lj in zip(lines_t, lines_j):
        tt, tj = lt.split(), lj.split()
        assert len(tt) == len(tj) == 10
        assert all(np.isfinite(float(v)) for v in tt[1:]) and float(tt[9]).is_integer()
    # one refined focal per run, within 5% of the external one in both (the
    # refinement moves it by about 1% in 30 steps)
    for lines in (lines_t, lines_j):
        assert len({ln.split()[8] for ln in lines}) == 1
        assert abs(float(lines[0].split()[8]) / scene_dir[1] - 1) < 0.05
    for res in (res_t, res_j):
        assert all(RATE_BAND[0] <= r <= RATE_BAND[1] for r in res["rate_history"]), res["rate_history"]
    gt = load_pose_files_glob(str(scene_dir[0] / "*_pose.txt"))
    acc_t = t_evaluate(read_pose_file(tmp_path / "t" / "poses_final.txt"), gt, alignment_conf_threshold=-1)
    acc_j = j_evaluate(j_read(tmp_path / "j" / "poses_final.txt"), gt, alignment_conf_threshold=-1)
    assert acc_t.accuracy == acc_j.accuracy == 0.0


def test_parallel_seed_path(scene_dir, tmp_path, monkeypatch):
    """Three seed lanes with early selection: every lane's head and fastcheck
    file is written, the lanes are scored by register_frames_multi on the
    selection frames, and only the winner trains on to its full budget."""
    calls = {}
    real_multi, real_train = tpipe.register_frames_multi, tpipe.MappingTrainer.train_to_budget

    def multi(*a, **kw):
        calls["multi"] = (len(a[1]), a[4].max_estimates, a[4].ransac.refinement_steps, a[4].refit_tier1)
        return real_multi(*a, **kw)

    def to_budget(self, state, buffer, t0=None):
        out = real_train(self, state, buffer, t0)
        calls.setdefault("budget", []).append((int(state.iteration), out[1]))
        return out

    monkeypatch.setattr(tpipe, "register_frames_multi", multi)
    monkeypatch.setattr(tpipe.MappingTrainer, "train_to_budget", to_budget)
    res = _cli_mini(scene_dir, tmp_path / "t", "--try_seeds", "3", "--seed_selection_iterations", "10",
                    "--seed_selection_frames", "6", "--seed_selection_min_frames", "5")
    names = {p.name for p in (tmp_path / "t").iterdir()}
    assert {f"iteration0_seed{i}.pt" for i in range(3)} <= names
    assert {f"poses_iteration0_seed{i}_fastcheck.txt" for i in range(3)} <= names
    assert calls["multi"] == (3, 6, 12, 0)
    # the winner, from the selection budget to the seed budget; then round 1
    assert calls["budget"] == [(10, 20), (0, 30)]
    for i in range(3):
        assert len((tmp_path / "t" / f"poses_iteration0_seed{i}_fastcheck.txt").read_text().splitlines()) == 6
    assert res["iterations"] == 1 and len(res["entries"]) == N


@pytest.mark.slow
def test_mini_loop_spread(scene_dir, tmp_path):
    """(d) The band of the test above, measured: the JAX pipeline's rates
    over three base seeds, and the port's, all inside RATE_BAND, and the
    port's mean rate within the JAX seeds' range widened by one frame."""
    rates_j, rates_t = [], []
    for seed in (2089, 2090, 2091):
        rates_j += _jax_mini(scene_dir, tmp_path / f"j{seed}", base_seed=seed)["rate_history"]
        rates_t += _cli_mini(scene_dir, tmp_path / f"t{seed}", base_seed=seed)["rate_history"]
    print(json.dumps({"jax": rates_j, "port": rates_t}))
    assert all(RATE_BAND[0] <= r <= RATE_BAND[1] for r in rates_j + rates_t)
    assert min(rates_j) - 1 / N <= np.mean(rates_t) <= max(rates_j) + 1 / N


# ------------------------------------------------- (e) left-out branches


@pytest.mark.parametrize("over,what", [
    ({"render_visualization": True}, "render_visualization.*section 1, viz"),
])
def test_left_out_branches_raise_at_construction(over, what, scene_dir, tmp_path):
    kw = {**_scene_kw(scene_dir, tmp_path / "out"), **over}
    with pytest.raises(NotImplementedError, match=what):
        AceZeroPipeline(AceZeroConfig(**kw), device="cpu", encoder_params={})
    assert not (tmp_path / "out").exists()


def test_cli_without_cuda_raises(scene_dir, tmp_path, monkeypatch):
    """Without --device cpu the CLI asks for the card and raises where there
    is none; it never continues on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, focal = scene_dir
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ace_zero_cli.main([str(path / "*.png"), str(tmp_path / "out"), "--depth_files", str(path / "*_depth.npy"),
                           "--use_external_focal_length", str(focal)])
    assert not (tmp_path / "out").exists()


def test_stage_timers_report_and_trace(tmp_path, monkeypatch):
    """utils/profiling: the JAX package's report format, totals per stage,
    and a torch.profiler trace of a traced stage under ACEZERO_TRACE_DIR."""
    from acezero_tpu.utils import profiling as jprof
    from acezero_tpu_torch.utils import profiling as tprof

    monkeypatch.setenv("ACEZERO_TRACE_DIR", str(tmp_path))
    for prof in (tprof, jprof):
        prof.reset_stages()
        with prof.stage("mapping"):
            torch.ones(8).sum()
        with prof.stage("registration"):
            pass
        with prof.stage("mapping"):
            pass
    with tprof.stage("traced", trace=True):
        torch.ones(64, 64) @ torch.ones(64, 64)
    lines_t, lines_j = tprof.stage_report().splitlines(), jprof.stage_report().splitlines()
    assert lines_t[0] == lines_j[0]
    assert sorted(ln.split()[0] for ln in lines_t[1:]) == ["mapping", "registration", "traced"]
    totals = tprof.stage_totals()
    assert totals["mapping"][1] == 2 and totals["registration"][1] == 1 and totals["traced"][0] >= 0.0
    traces = list((tmp_path / "traced").glob("*.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]
    tprof.reset_stages()
    jprof.reset_stages()
    assert tprof.stage_report() == jprof.stage_report()
