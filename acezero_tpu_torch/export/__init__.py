from acezero_tpu_torch.export.point_cloud import (
    export_point_cloud_from_network,
    point_cloud_from_network,
    predict_coords,
    select_points,
)

__all__ = ["export_point_cloud_from_network", "point_cloud_from_network", "predict_coords", "select_points"]
