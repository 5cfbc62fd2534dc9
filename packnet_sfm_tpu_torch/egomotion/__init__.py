from packnet_sfm_tpu_torch.egomotion.alignment import refine_pose_photometric
from packnet_sfm_tpu_torch.egomotion.posegraph import (
    PoseGraphConfig,
    optimize_pose_graph,
    optimize_pose_graph_sharded,
)
from packnet_sfm_tpu_torch.egomotion.evaluation import (
    align_umeyama,
    absolute_trajectory_error,
    relative_pose_error,
    load_kitti_odometry_poses,
)
