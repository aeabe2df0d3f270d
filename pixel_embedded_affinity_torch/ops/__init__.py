from .offsets import SHIFTS_3D, gen_offsets, multi_offset, offsets_3d
from .affinity_np import relabel
from .emb2aff import (normalize_embedding, embedding_to_affinity_2d, cross_affinity_2d,
                      embedding_to_affinity_3d, cross_affinity_3d, offset_affinity_3d)
from .emb2aff_cuda import (fused_affinity_2d, affinity_2d_plain, fused_cross_affinity_2d,
                          cross_affinity_2d_plain)
from .emb2aff3d_cuda import (
    fused_affinity_3d, fused_cross_affinity_3d, affinity_3d_plain, cross_affinity_3d_plain,
    affinity_bwd, cross_affinity_fwd, cross_affinity_bwd, affinity_bwd_plain,
    cross_affinity_bwd_plain)
from .emb2aff_wmse_cuda import (
    fused_affinity_wmse_2d, fused_cross_affinity_wmse_2d,
    affinity_wmse_2d_plain, cross_affinity_wmse_2d_plain)
