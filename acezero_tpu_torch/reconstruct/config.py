"""Configuration of the reconstruction pipeline.

Counterpart of acezero_tpu/reconstruct/config.py, with every field name and
default of the JAX package (the reference CLI's flag surface, ace_zero.py:
33-158, plus the train_ace.py flags the reference orchestrator forwards).
Fields that change nothing in the port say so. One default differs on
purpose: `decode_cache_dir` is per user, not the shared /tmp directory.
The device is not a field: it is an argument of `AceZeroPipeline` and the
CLI's `--device`.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class AceZeroConfig:
    rgb_files: str = ""
    results_folder: Path = Path("results")
    depth_files: str | None = None
    # per-frame focal-length files (scalar or 3x3 K), in the frames' order
    calibration_files: str | None = None

    # --- main reconstruction loop (ace_zero.py:44-82) ---
    iterations_max: int = 100
    registration_threshold: float = 0.99
    relative_registration_threshold: float = 0.01
    final_refine: bool = True
    final_refit: bool = True
    final_refit_posewait: int = 5000
    # refit<->register cycles after the loop converges; 1 = the reference's
    # single final pass. With loop closure off, cycles beyond the first run
    # only when this asks for them.
    final_refit_cycles: int = 1
    refit_iterations: int = 25000
    registration_confidence: int = 500
    try_seeds: int = 5
    # seed maps through the parallel seed path: one MappingTrainer per lane,
    # trained one after another, scored together by register_frames_multi
    seed_parallel: bool = True
    seed_iterations: int = 10000
    # early seed selection: score all candidate seed maps after this many
    # iterations on `seed_selection_frames` frames and train only the winner
    # to the full budget; 0 restores the reference schedule
    seed_selection_iterations: int = 2000
    seed_selection_frames: int = 320
    # selection engages only on scenes of at least this many frames
    seed_selection_min_frames: int = 200
    seed_network: Path | None = None
    warmstart: bool = True
    # pc_final.ply from the final map (export/point_cloud.py)
    export_point_cloud: bool = False
    dense_point_cloud: bool = False

    # --- pose refinement (ace_zero.py:86-93) ---
    refinement: str = "mlp"  # mlp | none | naive
    refinement_ortho: str = "gram-schmidt"
    pose_refinement_wait: int = 0
    pose_refinement_lr: float = 0.001

    # --- calibration refinement (ace_zero.py:97-101) ---
    refine_calibration: bool = True
    use_external_focal_length: float = -1.0  # -1: heuristic 70% diagonal

    # --- ACE early stopping (ace_zero.py:105-113) ---
    learning_rate_schedule: str = "1cyclepoly"
    learning_rate_max: float = 0.003
    learning_rate_min: float = 0.0005
    learning_rate_warmup_iterations: int = 1000
    learning_rate_warmup_learning_rate: float = 0.0005
    cooldown_iterations: int = 5000
    cooldown_threshold: float = 0.7

    # --- general ACE parameters (ace_zero.py:117-136) ---
    image_resolution: int = 480
    num_head_blocks: int = 1
    max_dataset_passes: int = 10
    repro_loss_type: str = "tanh"
    repro_loss_hard_clamp: float = 1000.0
    repro_loss_soft_clamp: float = 50.0
    aug_rotation: float = 15.0
    aug_black_white: float = 0.1  # brightness/contrast jitter half-range
    # the training buffer in pinned host memory (training/trainer.py)
    training_buffer_cpu: bool = False
    iterations: int = 25000  # per-round cap (train_ace.py default)
    batch_size: int = 5120
    max_training_buffer_size: int = 8_000_000
    samples_per_image: int = 1024
    use_homogeneous: bool = True

    # --- registration (ace_zero.py:140-143) ---
    ransac_iterations: int = 32
    ransac_threshold: float = 10.0

    # --- visualization (ace_zero.py:147-155): the progress video, viz/ ---
    render_visualization: bool = False
    render_marker_size: float = 0.03
    render_camera_z_offset: float = 4.0

    # --- misc ---
    random_seed: int = 1305
    base_seed: int = 2089  # trainer seed (train_ace.py:30)
    iterations_output: int = 500
    encoder_path: Path | None = None  # torch .pt encoder weights
    # learned seed-depth head for a run without depth_files; None takes the
    # newest shipped head (weights/tpu_depth_v4.pt, v3, v1)
    depth_network: Path | None = None
    registration_frame_chunk: int = 64

    # --- loop closure (beyond the reference; reconstruct/loopclose.py) ---
    loop_closure: bool = True
    loop_closure_max_frames: int = 256
    loop_closure_probe_frames: int = 32
    adaptive_refit_max_cycles: int = 3
    loopclose_final_graph: bool = False
    loopclose_refit_freeze_poses: bool = True

    # internal knobs (not in the reference surface)
    # steps per host sync group of the trainer (TrainConfig.chunk_steps);
    # the trainer syncs every chunk_steps * sync_every_chunks steps
    chunk_steps: int = 500
    # data-mesh size (parallel/mesh.py; reconstruct/pipeline.py::pipeline_mesh):
    # N > 1 = the first N cards (clamped), 0 or 1 = one device (the JAX
    # package's 0 is every device)
    num_devices: int = 0
    num_decode_workers: int = 16
    # the decoded-canvas cache (data/images.py; None turns it off): a
    # per-user directory, not the JAX package's shared /tmp/acezero_canvas_cache
    decode_cache_dir: Path | None = Path(tempfile.gettempdir()) / f"acezero_canvas_cache-{os.getuid()}"
    refinement_steps: int = 100  # registrar refit cap (early-stops on no growth)
    # registrar two-tier refit: first-pass step cap before stragglers re-run
    # at the full cap (registration/driver.py); <= 0 disables
    refit_tier1: int = 16
    # name parity only: prewarming hides XLA compile latency, which the port
    # does not have
    prewarm: bool = True
    prewarm_min_frames: int = 200
    extras: dict = field(default_factory=dict)
