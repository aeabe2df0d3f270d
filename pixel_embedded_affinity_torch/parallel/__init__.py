from .tiling import TiledInference3D, gaussian_blend_weight, regular_grid_dims, tile_grid
