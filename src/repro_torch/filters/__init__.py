"""The paper's filters ported so far: resampling (P7, the first stage of P3),
pansharpening (P3), Haralick textures (P2) and mean-shift (P5)."""
from repro_torch.filters.meanshift import MeanShift
from repro_torch.filters.pansharpen import PansharpenFuse
from repro_torch.filters.resample import Resample
from repro_torch.filters.texture import FEATURES, HaralickTextures

__all__ = ["FEATURES", "HaralickTextures", "MeanShift", "PansharpenFuse", "Resample"]
