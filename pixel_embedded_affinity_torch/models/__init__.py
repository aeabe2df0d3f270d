from .resunet2d import ResidualUNet2DDeep
