from .brute_force import match_descriptors, match_descriptors_batch  # noqa: F401
from .cascade_hasher import CascadeHasher  # noqa: F401
from .database import (  # noqa: F401
    FeaturesAndMatchesDatabase, InMemoryFeaturesAndMatchesDatabase,
    DiskFeaturesAndMatchesDatabase, ImagePairMatch, KeypointsAndDescriptors,
)
from .feature_matcher import FeatureMatcher, FeatureMatcherOptions  # noqa: F401
