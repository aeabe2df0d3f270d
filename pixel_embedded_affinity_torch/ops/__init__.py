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
from .s2d import (space_to_depth, depth_to_space, s2d_conv_weights, s2d_conv2x2_weights,
                  s2d_conv2x2_weights_qx, s2d_conv2x2_slices)
from .conv3x3_cuda import (conv3x3_fused, conv3x3_blocked, conv3x3_blocked_flat,
                           conv3x3_blocked_chain, blocked_ingest, blocked_egress,
                           conv3x3_plain, conv3x3_canvas_plain)
from .s2d_block_cuda import fused_s2d_block, fused_s2d_block_plain
from .tile_copy_cuda import tile_copy, tile_copy_plain
