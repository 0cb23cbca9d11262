"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), each beside its plain
PyTorch version, and the device dispatch (``ops``) the filters and the LM
call."""
from repro_torch.kernels import (
    flash_attention,
    glcm,
    meanshift,
    ops,
    pansharpen,
    prestage,
    ssd_scan,
)

#: the kernel launchers of the main path, each with its ``.launches`` count
LAUNCHERS = {
    "pansharpen": pansharpen.pansharpen_cuda,
    "glcm_features": glcm.glcm_features_cuda,
    "meanshift": meanshift.meanshift_cuda,
    "flash_attention": flash_attention.flash_attention_cuda,
    "ssd_intra_chunk": ssd_scan.ssd_intra_chunk_cuda,
}

__all__ = [
    "flash_attention", "glcm", "meanshift", "ops", "pansharpen", "prestage", "ssd_scan",
    "LAUNCHERS",
]
