"""The paper's filters: orthorectification (P1), Haralick textures (P2),
pansharpening (P3), random-forest classification (P4), mean-shift (P5),
conversion (P6), resampling (P7), band math and composites (P9), band
statistics (the persistent filter) and separable convolutions."""
from repro_torch.filters.classify import (
    Forest,
    RandomForestClassify,
    Tree,
    forest_predict,
    train_forest,
)
from repro_torch.filters.convolution import (
    SeparableConvolution,
    SobelGradient,
    gaussian_kernel,
    gaussian_smoothing,
)
from repro_torch.filters.meanshift import MeanShift
from repro_torch.filters.ortho import Orthorectify, SensorModel, bicubic_sample
from repro_torch.filters.pansharpen import PansharpenFuse
from repro_torch.filters.pointwise import BandMath, Composite, Concat, Convert, ndvi
from repro_torch.filters.resample import Resample
from repro_torch.filters.stats import BandStatistics
from repro_torch.filters.texture import FEATURES, HaralickTextures

__all__ = [
    "BandMath",
    "BandStatistics",
    "Composite",
    "Concat",
    "Convert",
    "FEATURES",
    "Forest",
    "HaralickTextures",
    "MeanShift",
    "Orthorectify",
    "PansharpenFuse",
    "RandomForestClassify",
    "Resample",
    "SensorModel",
    "SeparableConvolution",
    "SobelGradient",
    "Tree",
    "bicubic_sample",
    "forest_predict",
    "gaussian_kernel",
    "gaussian_smoothing",
    "ndvi",
    "train_forest",
]
