from .inference2d import (build_model, fast_affinities, forward_affinities, run_cvppp_test,
                          run_inference_2d, serve_batch, write_cvppp_submission)
from .inference3d import build_tiled_predictor, decode, run_inference_3d
