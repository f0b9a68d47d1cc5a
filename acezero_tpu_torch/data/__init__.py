from acezero_tpu_torch.data.augment import augment_batch, normalize_images
from acezero_tpu_torch.data.images import GRAY_MEAN, GRAY_STD, decode_to_canvas
from acezero_tpu_torch.data.scene import SceneData, load_scene

__all__ = ["SceneData", "load_scene", "decode_to_canvas", "GRAY_MEAN", "GRAY_STD", "augment_batch",
           "normalize_images"]
