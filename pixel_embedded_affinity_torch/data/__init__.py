from .cvppp import CVPPPTest, CVPPPValidation, normalize_imagenet
from .ac3ac4 import AC3AC4ValidVolume, label_affinities, synthesize_volume
from .bbbc import BBBCValidation, convert_mask_to_instances, synthesize_nuclei
