"""Command-line tools of the port: the JAX package's tools (label generation,
init-pose conversion, the synthetic split, FPS keypoints, the training soak,
the sampler study, the run reports, the asset check, the checkpoint
converter), and the probes and profiles that need a CUDA card."""

from .alignment import pnp_pose, ransac_umeyama, umeyama_similarity

__all__ = ["pnp_pose", "ransac_umeyama", "umeyama_similarity"]
