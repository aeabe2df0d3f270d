from .cvppp import CVPPPTest, CVPPPValidation, normalize_imagenet
