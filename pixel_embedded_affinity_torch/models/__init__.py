from .resunet2d import ResidualUNet2D, ResidualUNet2DDeep
from .resnet_embed import LocalAttentionBlock, ResNetEmbedding
from .unet3d_pni import UNetPNIEmbeddingDeep
from .unet3d_mala import UNet3DMALADeep
from .fast_forward import build_fast_resunet_forward, pack_image_s2d
from .fast_forward3d import build_fast_pni_forward

ARCHS_2D = ("resunet2d_deep", "resnet50_embedding", "resnet101_embedding")


def model_from_config(model_cfg, dtype="float32"):
    """The model of ``model_cfg.arch`` at its config's widths, computing in
    ``dtype``, its weights drawn by torch's initialisers."""
    m = model_cfg
    if m.arch == "resunet2d_deep":
        return ResidualUNet2DDeep(m.input_nc, m.output_nc, tuple(m.filters), m.emd, dtype=dtype)
    if m.arch in ("resnet50_embedding", "resnet101_embedding"):
        return ResNetEmbedding(50 if m.arch == "resnet50_embedding" else 101, m.emd,
                               m.output_nc, in_channels=m.input_nc, dtype=dtype)
    if m.arch == "unet_pni_deep":
        return UNetPNIEmbeddingDeep(m.input_nc, tuple(m.filters), m.emd, dtype=dtype)
    if m.arch == "unet3d_mala":
        return UNet3DMALADeep(m.emd, in_channels=m.input_nc, dtype=dtype)
    raise NotImplementedError(f"arch {m.arch!r} is not ported")
