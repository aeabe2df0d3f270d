from .cvppp import CVPPPTest, CVPPPValidation, normalize_imagenet
from .ac3ac4 import AC3AC4ValidVolume, label_affinities, synthesize_volume
