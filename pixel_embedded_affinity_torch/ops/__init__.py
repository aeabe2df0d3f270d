from .offsets import gen_offsets, multi_offset
from .affinity_np import relabel
from .emb2aff import normalize_embedding, embedding_to_affinity_2d, cross_affinity_2d
from .emb2aff_cuda import fused_affinity_2d, affinity_2d_plain
from .emb2aff_wmse_cuda import (
    fused_affinity_wmse_2d, fused_cross_affinity_wmse_2d,
    affinity_wmse_2d_plain, cross_affinity_wmse_2d_plain)
