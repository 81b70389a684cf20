from .models import (  # noqa: F401
    CameraModelType,
    NUM_PARAMS,
    MAX_INTRINSICS,
    FOCAL, ASPECT, SKEW, PP_X, PP_Y,
    distort,
    pixel_from_camera_point,
    pixel_to_normalized_ray,
    pixel_to_world_ray,
    project,
    undistort,
    world_to_camera,
)
