"""The port's reconstruction loop with --render_visualization on the CPU.

The mini loop of tests/test_pipeline_e2e.py:32 through the port's CLI,
with the visualizer on and off: training, registration and every artifact
but the renderings are untouched by it (poses_final.txt byte for byte).
With it on, the renderings folder holds the frames of each kind (ten
relocalization frames per registration of the ten frames, one mapping
frame every `iterations_output` steps of the round, the 150-frame sweep)
and a state pickle per registration, and stage `render` is timed apart
from stage `mapping`. To keep the file quick the loop runs at the
scene's own size on one CPU thread and renders at VIZ_SIZE, not the
default 720 x 1280; the hooks and counts against the JAX pipeline are
tests/test_torch_pipeline.py's control-flow case.
"""

import sys
import time
from pathlib import Path

import pytest
import torch

import acezero_tpu_torch.reconstruct.pipeline as tpipe
from acezero_tpu_torch.cli import ace_zero_cli
from acezero_tpu_torch.data.images import read_png
from acezero_tpu_torch.utils import profiling

sys.path.insert(0, str(Path(__file__).resolve().parent))
# the mini loop's scene and budgets (scene_dir is a fixture)
from test_torch_pipeline import MINI_FLAGS, MINI_OVERRIDES, scene_dir  # noqa: E402,F401

ITERATIONS_OUTPUT = 10  # a mapping frame every chunk of the 30-step round
IMAGE_RESOLUTION = 96  # the scene's own size (the mini loop's 480 upsamples it)
VIZ_SIZE = dict(frame_h=72, frame_w=96)


@pytest.fixture
def one_thread():
    """The loops on one CPU thread: beside other test processes, torch's
    thread pool would mostly wait for cores (about 30 times slower in a
    run of the whole suite)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(scene_dir, folder, viz: bool):
    path, focal = scene_dir
    argv = [str(path / "*.png"), str(folder), "--depth_files", str(path / "*_depth.npy"),
            "--use_external_focal_length", str(focal), *MINI_FLAGS, "--image_resolution", str(IMAGE_RESOLUTION),
            "--device", "cpu", "--render_visualization", str(viz).lower()]
    profiling.reset_stages()
    result = ace_zero_cli.main(argv, **MINI_OVERRIDES, iterations_output=ITERATIONS_OUTPUT)
    return result, profiling.stage_totals()


def test_visualization_leaves_the_reconstruction_bit_for_bit(scene_dir, tmp_path, monkeypatch, one_thread):
    viz_cfg = tpipe.VizConfig
    monkeypatch.setattr(tpipe, "VizConfig", lambda **kw: viz_cfg(**kw, **VIZ_SIZE))
    visualizers = []
    real_init = tpipe.ReconstructionVisualizer.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        visualizers.append(self)

    monkeypatch.setattr(tpipe.ReconstructionVisualizer, "__init__", init)
    res_off, stages_off = _run(scene_dir, tmp_path / "off", False)
    res_on, stages_on = _run(scene_dir, tmp_path / "on", True)

    files_off = sorted(p.name for p in (tmp_path / "off").iterdir())
    assert sorted(p.name for p in (tmp_path / "on").iterdir()) == sorted(files_off + ["renderings"])
    for name in files_off:
        if name.endswith(".txt"):
            assert (tmp_path / "on" / name).read_bytes() == (tmp_path / "off" / name).read_bytes(), name
    assert res_on["rate_history"] == res_off["rate_history"]

    (viz,) = visualizers
    # two registrations (the seed map and round 1) of ten frames; round 1's
    # 30 steps give a mapping frame at 10, 20 and 30
    assert viz.frames_by_kind == {"mapping": 3, "reloc": 20, "sweep": 150}
    renders = tmp_path / "on" / "renderings"
    assert sorted(p.name for p in renders.glob("*.pkl")) == ["iteration0_seed0_register.pkl",
                                                             "iteration1_register.pkl"]
    frames = sorted(renders.glob("frame_*.png"))
    assert len(frames) == 173 and frames[-1].name == "frame_000172.png"
    for f in (frames[0], frames[25], frames[-1]):
        img = read_png(f)
        assert img.shape == (72, 96, 3) and (img != 255).any()
    assert all(len(v) == 173 for v in viz.frame_seconds.values())
    # two render rounds, three mapping frames, the sweep
    assert "render" not in stages_off and stages_on["render"][1] == 2 + 3 + 1


def test_carved_stage_leaves_the_enclosing_stage():
    """stage(carve=True) (the render hooks) is taken out of the stage it runs
    in (mapping); a plain nested stage counts in both, as before."""
    profiling.reset_stages()
    with profiling.stage("outer"):
        time.sleep(0.05)
        with profiling.stage("carved", carve=True):
            time.sleep(0.3)
        with profiling.stage("nested"):
            time.sleep(0.1)
    totals = profiling.stage_totals()
    assert totals["carved"][0] >= 0.3 and totals["nested"][0] >= 0.1
    assert 0.15 <= totals["outer"][0] < 0.3
    with pytest.raises(KeyError):
        with profiling.stage("failing", carve=True):
            raise KeyError("x")
    assert not profiling._OPEN
    profiling.reset_stages()
