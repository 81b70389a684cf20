"""Core id types. ref: src/theia/sfm/types.h:47-56."""
from __future__ import annotations

ViewId = int
TrackId = int
CameraIntrinsicsGroupId = int

kInvalidViewId = 2 ** 32 - 1
kInvalidTrackId = 2 ** 32 - 1
kInvalidCameraIntrinsicsGroupId = 2 ** 32 - 1
