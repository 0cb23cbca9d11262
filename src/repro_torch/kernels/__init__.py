"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), each beside its plain
PyTorch version, and the device dispatch (``ops``) the filters call."""
from repro_torch.kernels import glcm, meanshift, ops, pansharpen

#: the kernel launchers of the main path, each with its ``.launches`` count
LAUNCHERS = {
    "pansharpen": pansharpen.pansharpen_cuda,
    "glcm_features": glcm.glcm_features_cuda,
    "meanshift": meanshift.meanshift_cuda,
}

__all__ = ["glcm", "meanshift", "ops", "pansharpen", "LAUNCHERS"]
