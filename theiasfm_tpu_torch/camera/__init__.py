from .models import (  # noqa: F401
    CameraModelType,
    NUM_PARAMS,
    MAX_INTRINSICS,
    FOCAL, ASPECT, SKEW, PP_X, PP_Y,
    distort,
    pixel_from_camera_point,
    project,
    world_to_camera,
)
