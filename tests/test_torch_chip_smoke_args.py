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
    assert set(chip_smoke.K1_TIMED) == {"registration", "mapping", "B64", "fill132"}
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
    assert phases[phases.index("pipeline"):] == ["pipeline", "seeddepth", "bare", "render", "spill", "report"]
    n = chip_smoke.N_FRAMES
    assert round(chip_smoke.BARE_SHARE * n) == round(chip_smoke.BARE_JAX_RATE * n) - 3 == 16
    assert chip_smoke.BARE_SHARE == 16 / n  # a frame count: 16 registered frames reach it exactly
    assert chip_smoke.SEEDDEPTH_TOL == 0.01 and set(chip_smoke.SEEDDEPTH_JAX) == {"raw_rel", "shape_rel", "scale_cv"}
    assert chip_smoke.SEEDDEPTH_STRIDE == 6 and chip_smoke.DEPTH_HEAD.name == "tpu_depth_v4.pt"
    assert chip_smoke.SPILL_STEPS == (200, 500)


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
