"""Reconstruction-progress visualizer: mapping / relocalization / sweep.

Counterpart of acezero_tpu/viz/visualizer.py: the same three phases
(mapping frames with the growing cloud and the refined cameras,
relocalization frames with confidence-coloured cameras and the histogram,
the final orbit with cameras coloured by their first registered round),
the same rolling state and the same pickles (`save_state`/`load_state`:
numpy arrays and Python scalars, readable by either package). The point
cloud is rendered on `device` (viz/renderer.py); the visualizer keeps a
device copy of the cloud and uploads it again only when the cloud changes.
The pan camera stays in numpy, as its smoothing state is what the pickles
carry. Frames are PNGs (io/png.py); `to_video` runs ffmpeg and warns when
it is absent.

Each frame's host and device parts are timed (`frame_seconds`: pan
camera, device render with the upload and download, overlays, PNG write)
and counted by kind (`frames_by_kind`); neither is pickled.
"""

from __future__ import annotations

import logging
import pickle
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from acezero_tpu_torch import resolve_device
from acezero_tpu_torch.io.png import write_png
from acezero_tpu_torch.viz.overlay import draw_caption, draw_conf_histogram, draw_loading_bar
from acezero_tpu_torch.viz.renderer import composite_frame, render_cameras

_logger = logging.getLogger(__name__)

FRAME_PARTS = ("pan_camera", "render", "overlays", "png")


@dataclass
class VizConfig:
    target_path: Path = Path("renderings")
    frame_h: int = 720
    frame_w: int = 1280
    focal: float = 800.0
    camera_z_offset: float = 4.0
    marker_size: float = 0.03
    point_budget: int = 600_000
    conf_threshold: float = 500.0
    conf_max: float = 2000.0
    smoothing: float = 0.9  # pan-camera rolling average (LazyCamera analogue)


def _conf_color(conf: np.ndarray, conf_max: float) -> np.ndarray:
    t = np.clip(conf / conf_max, 0.0, 1.0)[:, None]
    return np.concatenate([1.0 - t, t, np.full_like(t, 0.15)], axis=1)


class ReconstructionVisualizer:
    def __init__(self, cfg: VizConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cfg.target_path.mkdir(parents=True, exist_ok=True)
        self.frame_idx = 0
        self.cloud_xyz = np.zeros((0, 3), np.float32)
        self.cloud_rgb = np.zeros((0, 3), np.float32)
        self._smoothed_center: np.ndarray | None = None
        self._smoothed_radius: float | None = None
        self.registration_history: dict[str, int] = {}
        self._cloud_on_device: tuple[torch.Tensor, torch.Tensor] | None = None
        self.frame_seconds: dict[str, list[float]] = {k: [] for k in FRAME_PARTS}
        self.frames_by_kind = {"mapping": 0, "reloc": 0, "sweep": 0}

    # ------------------------------------------------------------- state

    def save_state(self, path: str | Path) -> None:
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "frame_idx": self.frame_idx,
                    "cloud_xyz": self.cloud_xyz,
                    "cloud_rgb": self.cloud_rgb,
                    "smoothed_center": self._smoothed_center,
                    "smoothed_radius": self._smoothed_radius,
                    "registration_history": self.registration_history,
                },
                f,
            )

    def load_state(self, path: str | Path) -> None:
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.frame_idx = state["frame_idx"]
        self.cloud_xyz = state["cloud_xyz"]
        self.cloud_rgb = state["cloud_rgb"]
        self._smoothed_center = state["smoothed_center"]
        self._smoothed_radius = state.get("smoothed_radius")
        self.registration_history = state.get("registration_history", {})
        self._cloud_on_device = None

    # ----------------------------------------------------------- updates

    def update_point_cloud(self, xyz: np.ndarray, rgb_u8: np.ndarray) -> None:
        """Append newly mapped points, respecting the rolling budget
        (PointCloudBuffer analogue, ace_vis_util.py:326-386)."""
        rgb = rgb_u8.astype(np.float32) / 255.0
        self.cloud_xyz = np.concatenate([self.cloud_xyz, xyz.astype(np.float32)])
        self.cloud_rgb = np.concatenate([self.cloud_rgb, rgb])
        if self.cloud_xyz.shape[0] > self.cfg.point_budget:
            keep = np.random.default_rng(0).choice(self.cloud_xyz.shape[0], self.cfg.point_budget, replace=False)
            self.cloud_xyz = self.cloud_xyz[keep]
            self.cloud_rgb = self.cloud_rgb[keep]
        self._cloud_on_device = None

    def record_registration(self, rgb_file: str, confidence: float, iteration: int) -> None:
        if confidence >= self.cfg.conf_threshold and rgb_file not in self.registration_history:
            self.registration_history[rgb_file] = iteration

    # ----------------------------------------------------------- cameras

    def _pan_camera(self, angle: float) -> np.ndarray:
        """Orbit view pose (w2c) around the smoothed scene center."""
        center = self.cloud_xyz.mean(axis=0) if self.cloud_xyz.size else np.zeros(3)
        if self._smoothed_center is None:
            self._smoothed_center = center
        else:
            a = self.cfg.smoothing
            self._smoothed_center = a * self._smoothed_center + (1 - a) * center
        c = self._smoothed_center

        # the orbit radius tracks the growing scene extent through the same
        # rolling average as the center (LazyCamera, reference
        # ace_vis_util.py:233-323)
        if self.cloud_xyz.shape[0] > 16:
            d = np.linalg.norm(self.cloud_xyz - c, axis=1)
            r_target = max(self.cfg.camera_z_offset, 1.4 * float(np.percentile(d, 90)))
        else:
            r_target = self.cfg.camera_z_offset
        if self._smoothed_radius is None:
            self._smoothed_radius = r_target
        else:
            a = self.cfg.smoothing
            self._smoothed_radius = a * self._smoothed_radius + (1 - a) * r_target
        radius = self._smoothed_radius
        eye = c + radius * np.array([np.cos(angle), -0.35, np.sin(angle)])
        z = c - eye
        z = z / np.linalg.norm(z)
        up = np.array([0.0, -1.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([x, y, z], axis=1)
        c2w[:3, 3] = eye
        return np.linalg.inv(c2w)

    # ----------------------------------------------------------- renders

    def _timed(self, part: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.frame_seconds[part].append(t1 - t0)
        return t1

    def _write(self, img: np.ndarray, kind: str, t0: float) -> Path:
        """Write the frame; `t0` is when its overlays began."""
        t1 = self._timed("overlays", t0)
        path = self.cfg.target_path / f"frame_{self.frame_idx:06d}.png"
        write_png(path, img)
        self._timed("png", t1)
        self.frame_idx += 1
        self.frames_by_kind[kind] += 1
        return path

    def _render(self, poses_c2w: np.ndarray, cam_colors: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        view = self._pan_camera(angle=0.02 * self.frame_idx)
        t0 = self._timed("pan_camera", t0)
        cam_xyz, cam_rgb = render_cameras(
            poses_c2w, cam_colors, view, self.cfg.focal,
            self.cfg.frame_h, self.cfg.frame_w, self.cfg.marker_size,
        )
        if self._cloud_on_device is None:
            self._cloud_on_device = (torch.as_tensor(self.cloud_xyz, dtype=torch.float32, device=self.device),
                                     torch.as_tensor(self.cloud_rgb, dtype=torch.float32, device=self.device))
        img = composite_frame(
            *self._cloud_on_device, cam_xyz, cam_rgb,
            view, self.cfg.focal, self.cfg.frame_h, self.cfg.frame_w, device=self.device,
        )
        self._timed("render", t0)
        return img

    def render_mapping_frame(
        self,
        poses_c2w: np.ndarray,
        caption: str | None = None,
        progress: float | None = None,
    ) -> Path:
        """One frame of the mapping phase: cloud + current refined cameras,
        with the phase caption and training loading bar (the reference
        renders one such frame every `iterations_output` steps,
        ace_trainer.py:675-679)."""
        colors = np.tile(np.array([[0.3, 0.5, 1.0]]), (len(poses_c2w), 1))
        img = self._render(poses_c2w, colors)
        t0 = time.perf_counter()
        if caption:
            img = draw_caption(img, "Neural Mapping", caption)
        if progress is not None:
            img = draw_loading_bar(img, progress, "training the scene map")
        return self._write(img, "mapping", t0)

    def render_reloc_frame(
        self,
        poses_c2w: np.ndarray,
        confidences: np.ndarray,
        caption: str | None = None,
    ) -> Path:
        """One frame of the relocalization phase: confidence-colored cameras
        plus the confidence histogram (reference ace_visualizer.py:917-1018)."""
        img = self._render(poses_c2w, _conf_color(confidences, self.cfg.conf_max))
        t0 = time.perf_counter()
        if caption:
            img = draw_caption(img, "Registration", caption)
        img = draw_conf_histogram(img, np.asarray(confidences, np.float64), self.cfg.conf_threshold)
        return self._write(img, "reloc", t0)

    def render_final_sweep(self, poses_c2w: np.ndarray, first_iterations: np.ndarray,
                           num_frames: int = 150) -> list[Path]:
        """Orbit the finished scene; cameras colored by first-registered
        iteration (render_final_sweep.py analogue)."""
        max_it = max(int(first_iterations.max()), 1) if first_iterations.size else 1
        t = (first_iterations / max_it)[:, None]
        colors = np.concatenate([t, 1.0 - 0.5 * t, 1.0 - t], axis=1)
        out = []
        for _ in range(num_frames):
            img = self._render(poses_c2w, colors)
            t0 = time.perf_counter()
            img = draw_caption(img, "Reconstruction", f"{len(poses_c2w)} cameras, colored by registration round")
            out.append(self._write(img, "sweep", t0))
        return out

    # ------------------------------------------------------------- video

    def to_video(self, output: str | Path, framerate: int = 30) -> None:
        ffmpeg = shutil.which("ffmpeg")
        if ffmpeg is None:
            _logger.warning("ffmpeg not found; leaving PNG frames in %s", self.cfg.target_path)
            return
        subprocess.run(
            [
                ffmpeg, "-y", "-framerate", str(framerate),
                "-pattern_type", "glob", "-i", f"{self.cfg.target_path}/*.png",
                "-c:v", "libx264", "-pix_fmt", "yuv420p", str(output),
            ],
            check=True,
        )
        _logger.info("Wrote video %s", output)
