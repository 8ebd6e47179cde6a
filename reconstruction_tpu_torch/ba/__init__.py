from reconstruction_tpu_torch.ba.bundle_adjust import (  # noqa: F401
    BAProblem, bundle_adjust, ba_step)
from reconstruction_tpu_torch.ba.features import harris_corners, describe  # noqa: F401
from reconstruction_tpu_torch.ba.tracks import match_descriptors, build_tracks  # noqa: F401
from reconstruction_tpu_torch.ba.pose_graph import pose_graph_optimize  # noqa: F401
