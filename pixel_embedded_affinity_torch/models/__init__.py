from .resunet2d import ResidualUNet2DDeep
from .unet3d_pni import UNetPNIEmbeddingDeep
