from .tiling import TiledInference3D, gaussian_blend_weight, regular_grid_dims, tile_grid
from .mesh import Mesh, Sharding, batch_sharding, get_mesh, replicated_sharding
from .multihost import global_batch, initialize, is_multiprocess, to_global
