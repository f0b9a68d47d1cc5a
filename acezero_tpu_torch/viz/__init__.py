from acezero_tpu_torch.viz.renderer import composite_frame, render_cameras, render_point_cloud
from acezero_tpu_torch.viz.visualizer import ReconstructionVisualizer, VizConfig

__all__ = ["render_point_cloud", "render_cameras", "composite_frame", "ReconstructionVisualizer", "VizConfig"]
