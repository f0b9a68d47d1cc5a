"""chip_smoke.py's --phases argument: every phase by default, a subset in
the script's own order with `device` always first, an unknown name refused.
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
    assert phases.index("profile") + 1 == phases.index("pipeline") == phases.index("report") - 1
    assert chip_smoke.parse_phases(["--phases", "pipeline"]) == ["device", "pipeline"]
    assert chip_smoke.PIPELINE_CUTS == {"try_seeds": 3, "seed_iterations": 1000, "iterations": 2000,
                                        "cooldown_iterations": 500, "refit_iterations": 2000,
                                        "final_refit_posewait": 500, "iterations_max": 4}
    assert chip_smoke.PIPELINE_OVERRIDES == {"learning_rate_warmup_iterations": 200}
    # the reference registers 30% at these budgets, so the floor sits under it
    assert chip_smoke.PIPELINE_SHARE == 0.25 < chip_smoke.RELOC_SHARE
