"""Reconstruction and feature file I/O (port of theiasfm_tpu/io)."""
from .theia_format import (  # noqa: F401
    read_theia_reconstruction, write_theia_reconstruction,
)
from .native_format import (  # noqa: F401
    read_reconstruction, write_reconstruction,
)
from .ply import write_ply  # noqa: F401
from .one_dsfm import read_1dsfm  # noqa: F401
from .bundler import read_bundler, write_bundler  # noqa: F401
from .nvm import read_nvm, write_nvm  # noqa: F401
from .colmap import write_colmap  # noqa: F401
from .strecha import read_strecha_dataset  # noqa: F401
from .calibration import read_calibration, write_calibration  # noqa: F401
from .sift_key import (  # noqa: F401
    read_sift_binary, read_sift_text, write_sift_binary, write_sift_text,
)
from .pmvs import export_pmvs  # noqa: F401
from .populate_image_sizes import populate_image_sizes  # noqa: F401
from .features_files import (  # noqa: F401
    read_keypoints_and_descriptors, write_keypoints_and_descriptors,
)
