"""chip_smoke.py's --phases argument: every phase by default, a subset in
the script's own order with `device` always first and `bare` whenever
`render` is asked for, an unknown name refused.
The script imports only the standard library at module level, so this runs
without a card."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def test_default_runs_every_phase():
    assert chip_smoke.parse_phases([]) == list(chip_smoke.PHASES)


@pytest.mark.parametrize("arg,want", [
    ("build,kernels", ["device", "build", "kernels"]),
    ("kernels,build", ["device", "build", "kernels"]),
    ("report, mapping", ["device", "mapping", "report"]),
    ("device", ["device"]),
    ("report,pipeline,profile", ["device", "profile", "pipeline", "report"]),
    ("pipeline,loopclose,mapping", ["device", "mapping", "loopclose", "pipeline"]),
    ("report,spill,bare,seeddepth,pipeline", ["device", "pipeline", "seeddepth", "bare", "spill", "report"]),
    ("spill", ["device", "spill"]),
    ("render", ["device", "bare", "render"]),
    ("report,render,build", ["device", "build", "bare", "render", "report"]),
    ("bare", ["device", "bare"]),
    ("pretrain", ["device", "pretrain"]),
    ("report,pretrain,spill,build", ["device", "build", "spill", "pretrain", "report"]),
    ("mesh,build", ["device", "build", "mesh"]),
    ("pretrain,mesh,spill", ["device", "spill", "mesh", "pretrain"]),
])
def test_subset_in_script_order(arg, want):
    assert chip_smoke.parse_phases(["--phases", arg]) == want


@pytest.mark.parametrize("arg", ["build,kernal", "nope", ",", ""])
def test_unknown_or_empty_phase_is_an_error(arg, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.parse_phases(["--phases", arg])
    assert exc.value.code == 2
    assert "phase" in capsys.readouterr().err


def test_main_refuses_unknown_phase_before_touching_cuda():
    with pytest.raises(SystemExit):
        chip_smoke.main(["--phases", "slice,bogus"])


def test_k2_cases_cover_the_tile_edges():
    cases = {name: (B, tags) for name, B, tags in chip_smoke.K2_CASES}
    assert {B for B, _ in cases.values()} >= {1, 64, 65, 5120, 5157}
    assert any(len(tags) == 1 for _, tags in cases.values())
    assert set(chip_smoke.K2_TIMED) <= set(cases)
    assert chip_smoke.K2_TOL == 2e-2 and chip_smoke.K2_GRAD_TOL == 2e-2


def test_k1_cases_cover_the_tile_edges():
    cases = {name: (B, tags) for name, B, tags in chip_smoke.K1_CASES}
    # the main paths' shapes and the cases the port had before the Hopper redesign
    assert {"registration", "ragged", "blocks0", "blocks2", "mapping"} <= set(cases)
    assert cases["registration"][0] == 307_200 and cases["mapping"][0] == 5120
    # the tile edges, one layer with and without the residual add, a full H100
    assert {B for B, _ in cases.values()} >= {1, 64, 65, 132 * 64}
    assert {tags for _, tags in cases.values()} >= {(0,), (1,)}
    # a persistent grid whose tile count is no multiple of the SMs, with a ragged tile
    tiles = {-(-B // 64) for B, _ in cases.values()}
    assert any(t > 2 * chip_smoke.H100_SMS and t % chip_smoke.H100_SMS for t in tiles)
    assert any(B > 2 * chip_smoke.H100_SMS * 64 and B % 64 for B, _ in cases.values())
    assert set(chip_smoke.K1_TIMED) == {"registration", "mapping", "B64", "fill132", "pretrain"}
    assert chip_smoke.K1_TOL == 1e-2


def test_pipeline_phase_after_profile_before_report():
    """Phase pipeline runs the reconstruction CLI after profile and before
    report, with the cut budgets the phase lists."""
    phases = list(chip_smoke.PHASES)
    assert phases.index("profile") + 1 == phases.index("pipeline") < phases.index("report")
    assert chip_smoke.parse_phases(["--phases", "pipeline"]) == ["device", "pipeline"]
    assert chip_smoke.PIPELINE_CUTS == {"try_seeds": 3, "seed_iterations": 1000, "iterations": 2000,
                                        "cooldown_iterations": 500, "refit_iterations": 2000,
                                        "final_refit_posewait": 500, "iterations_max": 4}
    assert chip_smoke.PIPELINE_OVERRIDES == {"learning_rate_warmup_iterations": 200}
    # the reference registers 30% at these budgets, so the floor sits under it
    assert chip_smoke.PIPELINE_SHARE == 0.25 < chip_smoke.RELOC_SHARE


def test_loopclose_phase_after_mapping_before_profile():
    """Phase loopclose runs after mapping (whose fixed-pose map it uses) and
    before profile, and holds the card against the CPU on 16 frames: on
    exact maps every pairwise fit and every frame within 1e-3 of the scene
    diagonal and 0.05 deg, scales within 1e-3; on learned maps the same
    edge count."""
    phases = list(chip_smoke.PHASES)
    assert phases.index("mapping") + 1 == phases.index("loopclose") == phases.index("profile") - 1
    assert chip_smoke.parse_phases(["--phases", "loopclose"]) == ["device", "loopclose"]
    assert chip_smoke.LOOPCLOSE_CPU_FRAMES == 16
    assert (chip_smoke.LOOPCLOSE_TOL_DIAG, chip_smoke.LOOPCLOSE_TOL_DEG, chip_smoke.LOOPCLOSE_TOL_SCALE) == (
        1e-3, 0.05, 1e-3)
    # the map trained when phase mapping did not run: the fixed-pose recipe, cut
    assert chip_smoke.LOOPCLOSE_MAP[: len(chip_smoke.MAPPING_SCHEDULE)] == chip_smoke.MAPPING_SCHEDULE
    assert "--pose_refinement" not in chip_smoke.LOOPCLOSE_MAP


def test_core_with_fits_reads_every_selected_pair():
    """Phase loopclose's comparison on the CPU alone: the fits read off
    loop_close_core's own calls cover every selected pair (each surviving
    edge among them), and a run against itself differs by nothing."""
    import numpy as np
    import torch

    from acezero_tpu_torch.reconstruct import loopclose as lc

    maps, feats, w2c, focals, hw = chip_smoke.drifted_chesslike(np, 8, 16)
    assert maps.shape == (8, 30, 40, 3) and feats.shape == (8, 30, 40, 96) and hw == (240, 320)
    args = (torch.from_numpy(maps), torch.from_numpy(feats), torch.ones(maps.shape[:3], dtype=torch.bool), w2c,
            np.full(8, 2000.0), focals, hw, 500.0)
    runs = [chip_smoke.core_with_fits(np, lc, *args) for _ in range(2)]
    s, R, t, diag, fits = runs[0]
    assert "skipped" not in diag and len(fits) >= diag["edges"] >= 8
    assert {(int(i), int(j)) for i, j in diag["ba_data"]["pairs"]} <= set(fits)
    assert all(R_e.shape == (3, 3) and t_e.shape == (3,) and n > 0 for R_e, t_e, n in fits.values())
    assert (lc.pairwise_sim3.__name__, lc.select_pairs.__name__) == ("pairwise_sim3", "select_pairs")  # restored
    d = chip_smoke.card_vs_cpu(np, *runs)
    assert d["pairs_equal"] and d["edges_card"] == d["edges_cpu"] == diag["edges"]
    assert d["edge_fits"]["trans"]["max"] == d["frame_corrections"]["trans"]["max"] == 0.0
    assert d["edge_fits"]["inliers_equal"] == 1.0 and d["frame_corrections"]["scale_max"] == 0.0


def test_new_phases_after_pipeline_in_order():
    """seeddepth, bare, render and spill run after pipeline (bare reads the
    decode cache pipeline filled, render reads bare's output) and before
    report; bare reuses pipeline's cut budgets, its floor sits three frames
    of 60 under the JAX package's rate, and seeddepth holds the JAX
    package's statistics within 0.01."""
    phases = list(chip_smoke.PHASES)
    assert phases[phases.index("pipeline"):] == ["pipeline", "seeddepth", "bare", "render", "spill", "mesh",
                                                 "pretrain", "report"]
    n = chip_smoke.N_FRAMES
    assert round(chip_smoke.BARE_SHARE * n) == round(chip_smoke.BARE_JAX_RATE * n) - 3 == 16
    assert chip_smoke.BARE_SHARE == 16 / n  # a frame count: 16 registered frames reach it exactly
    assert chip_smoke.SEEDDEPTH_TOL == 0.01 and set(chip_smoke.SEEDDEPTH_JAX) == {"raw_rel", "shape_rel", "scale_cv"}
    assert chip_smoke.SEEDDEPTH_STRIDE == 6 and chip_smoke.DEPTH_HEAD.name == "tpu_depth_v4.pt"
    assert chip_smoke.SPILL_STEPS == (200, 500)


def test_mesh_phase_constants():
    """Phase mesh: a logical mesh of two shards on the card (and every card
    when there are several), the held steps at the bounds of
    tests/test_torch_mesh.py, the timed steps as phase spill's, the gather
    at the mapping batch, and the registration bounds of
    tests/test_torch_registration.py:127-130 for nine in ten confident
    frames, with a looser ceiling for every one."""
    assert chip_smoke.MESH_SHARDS == 2 and chip_smoke.MESH_STEPS == (10, 500)
    assert chip_smoke.MESH_STEPS[1] == chip_smoke.SPILL_STEPS[1] and chip_smoke.MESH_GATHER_B == 5120
    assert (chip_smoke.MESH_LOSS0_RTOL, chip_smoke.MESH_GRAD_RTOL, chip_smoke.MESH_GRAD_FC3_RTOL) == (1e-6, 1e-5, 1e-2)
    # the update check must fail the no-update control, whose error is 1
    assert chip_smoke.MESH_LOSS_RTOL == 2e-2 and 0 < chip_smoke.MESH_UPDATE_RTOL < 1
    assert (chip_smoke.MESH_REG_M, chip_smoke.MESH_REG_DEG, chip_smoke.MESH_REG_CONF) == (1e-3, 0.05, 1000.0)
    assert chip_smoke.MESH_REG_SHARE == 0.9
    assert chip_smoke.MESH_REG_M_MAX > chip_smoke.MESH_REG_M and chip_smoke.MESH_REG_DEG_MAX > chip_smoke.MESH_REG_DEG


def test_named_leaves_follow_tree_leaves():
    """Phase mesh names each gradient leaf by its path, in the order of
    training.optim.tree_leaves (dicts by sorted key), so that fc3's weight
    gets its own bound."""
    import torch

    from acezero_tpu_torch.training.optim import tree_leaves

    tree = ({"fc3": {"w": torch.zeros(2), "b": torch.ones(1)}, "a": [torch.ones(3)]}, {}, torch.zeros(()))
    named = chip_smoke.named_leaves(tree)
    assert [p for p, _ in named] == ["/0/a/0", "/0/fc3/b", "/0/fc3/w", "/2"]
    assert all(x is y for (_, x), y in zip(named, tree_leaves(tree)))


def test_device_busy_measures_overlap():
    """Phase mesh's overlap from kernel spans: 1 when the devices ran at
    once, 0 when one after another, null with one device."""
    from types import SimpleNamespace

    def prof(spans):
        return SimpleNamespace(events=lambda: [
            SimpleNamespace(device_type="cuda", device_index=d, time_range=SimpleNamespace(start=a, end=b))
            for d, a, b in spans])

    types = SimpleNamespace(CUDA="cuda")
    at_once = chip_smoke.device_busy(types, prof([(0, 0, 1000), (1, 0, 1000), (0, 200, 500)]))
    assert at_once["busy_ms_by_device"] == {0: 1.0, 1: 1.0} and at_once["union_ms"] == 1.0 and at_once["overlap"] == 1.0
    serial = chip_smoke.device_busy(types, prof([(0, 0, 1000), (1, 1000, 2000)]))
    assert serial["union_ms"] == 2.0 and serial["overlap"] == 0.0
    assert chip_smoke.device_busy(types, prof([(0, 0, 1000)]))["overlap"] is None


def test_compare_entries_counts_what_phase_mesh_holds():
    """Phase mesh's registration comparison: bit-equal frames, validity,
    inlier gaps (held only at the confidence bar) and pose gaps of the
    confident frames, with a rotation measure that reads about 0 for one matrix
    against itself (to 1e-9 deg)."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    from acezero_tpu_torch.io.pose_files import PoseFileEntry

    rng = np.random.default_rng(0)

    def entry(i, conf, R, t):
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = R, t
        return PoseFileEntry(f"f{i}.png", np.linalg.inv(w2c), 500.0, conf)

    Rs = Rotation.random(4, random_state=1).as_matrix().astype(np.float32)
    ts = rng.normal(size=(4, 3))
    want = [entry(i, c, Rs[i], ts[i]) for i, c in enumerate((2000.0, 3000.0, 8.0, 0.0))]
    moved = Rotation.from_rotvec([0.0, 0.0, np.radians(0.2)]).as_matrix() @ Rs[1]
    got = [want[0], entry(1, 3010.0, moved, ts[1] + [0.005, 0, 0]), entry(2, 10.0, Rs[2], ts[2]), want[3]]
    d = chip_smoke.compare_entries(np, got, want)
    assert d["bit_equal"] == 2 and d["validity_differs"] == 0 and d["inliers_apart"] == 1
    assert d["inliers_apart_confident"] == [] and d["confident_frames"] == 2 and d["confident_bit_equal"] == 1
    assert d["confident_within"] == 1 and abs(d["max_trans_m"] - 0.005) < 1e-6
    assert abs(d["max_rot_deg"] - 0.2) < 1e-3
    same = chip_smoke.compare_entries(np, want, want)
    assert same["max_rot_deg"] < 1e-9 and same["confident_within"] == 2


def test_render_phase_constants():
    """Phase bare's video: 12 relocalization frames a registration and the
    150-frame sweep at 720 x 1280; phase render holds the card's frame to
    the CPU's at 0.1% of the pixels, as tests/test_torch_viz.py holds the
    CPU to the JAX package."""
    assert (chip_smoke.RELOC_FRAMES, chip_smoke.SWEEP_FRAMES, chip_smoke.FRAME_SHAPE) == (12, 150, (720, 1280, 3))
    assert chip_smoke.RENDER_PIXEL_SHARE == 1e-3 and chip_smoke.REGRESSOR_FRAMES == 8
    assert chip_smoke.EXPORT_CONF == 500


@pytest.mark.parametrize("iterations,chunk,every,want", [
    (2000, 100, 500, 4), (1800, 100, 500, 4), (30, 10, 10, 3), (654, 100, 500, 2), (499, 100, 500, 1)])
def test_mapping_frames_follow_the_trainer_cadence(iterations, chunk, every, want):
    assert chip_smoke.mapping_frames(iterations, chunk, every) == want


def test_ply_header_counts(tmp_path):
    import numpy as np

    from acezero_tpu_torch.io.ply import write_ply_mesh

    write_ply_mesh(tmp_path / "m.ply", np.zeros((10, 3)), np.zeros((12, 3), np.int64), np.zeros((10, 3)))
    assert chip_smoke.ply_header_counts(tmp_path / "m.ply") == {"vertex": 10, "face": 12}


def test_pretrain_phase_constants():
    """Phase pretrain: the encoder CLI at its default widths with the v6
    recipe's contrastive weight and 1,200 steps, the depth CLI on the v4
    corpus cut to 8 scenes and 500 steps, the short fit cut to 1,000
    iterations; K1 and K2 held at the pretraining shape (one 192 x 256 image,
    head_blocks 0) and timed there."""
    assert chip_smoke.PRETRAIN_ARGS == ["--contrastive_weight", "0.2", "--steps", "1200"]
    assert chip_smoke.DEPTH_PRETRAIN == {"corpus": "v4", "num_scenes": 8, "steps": 500}
    assert chip_smoke.SHORTFIT_ITERATIONS == 1000 and chip_smoke.MATCH_TOL_PP == 1.0
    assert 70.0 < chip_smoke.MATCH_JAX_V6 < 90.0 and chip_smoke.PRETRAIN_CPU_STEPS == 3
    assert chip_smoke.PRETRAIN_CPU_RTOL == 5e-3
    for cases, timed in ((chip_smoke.K1_CASES, chip_smoke.K1_TIMED), (chip_smoke.K2_CASES, chip_smoke.K2_TIMED)):
        assert ("pretrain", 768, (0, 0, 1, 0, 0)) in cases and "pretrain" in timed


def test_pretrain_draws_drive_a_chunk_on_the_cpu():
    """The card-against-CPU draws: contrastive pairs and augmentation in
    range, and a step on the CPU from them finite."""
    import torch

    from acezero_tpu_torch.models.head import HeadConfig
    from acezero_tpu_torch.pretrain import encoder_pretrain as tep
    from acezero_tpu_torch.training.optim import adamw_init

    cfg = tep.PretrainConfig(num_scenes=2, views_per_scene=8, image_h=48, image_w=64, batch_images=4,
                             contrastive_weight=0.2)
    draws = chip_smoke.pretrain_draws(torch, tep, cfg, 16, 2, seed=1305)
    assert len(draws) == 2 and all(d["batch_idx"].shape == (4,) for d in draws)
    for d in draws:
        pairs = d["batch_idx"].reshape(-1, 2)
        assert (pairs // 8)[:, 0].eq((pairs // 8)[:, 1]).all()
        assert d["aug"]["thetas"].abs().max() <= 15.0 * 3.1416 / 180 and d["aug"]["scales"].min() >= 2 / 3
    corpus = tep.build_corpus(cfg, workers=1)
    p = tep.init_params(cfg, corpus)
    _, _, st = tep.pretrain_chunk(p, (adamw_init(p["encoder"]), adamw_init(p["heads"])),
                                  tep.corpus_to_device(corpus, cfg, "cpu"), 0, cfg, HeadConfig(num_head_blocks=0),
                                  draws=draws)
    assert all(torch.isfinite(v).all() and v.shape == (2,) for v in st.values())
