from .resunet2d import ResidualUNet2DDeep
from .unet3d_pni import UNetPNIEmbeddingDeep
from .fast_forward import build_fast_resunet_forward, pack_image_s2d
